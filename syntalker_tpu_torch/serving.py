"""Batched motion-generation service (PyTorch/CUDA).

Counterpart of ``MotionGenerationService`` in ``syntalker_tpu/serving.py``:
requests are queued and each flush groups them by prompt configuration
(which parts are prompted, the guidance scales, whether a style is given).
Each group is padded to a fixed bucket (``max_batch`` requests of
``max_seconds`` audio) and run together, with its own initial noise from
the service's generator.

- Unprompted requests take the kernel fast path: ``fused_loop=True`` runs
  each window's DDIM loop in K1, ``fused_loop=False`` one K2 block stack per
  step. Like JAX's lean and fused samplers, this path reads no prompt.
- Prompted or styled requests run ``generation.sample_windows`` (η=0 DDIM)
  with the per-body-part CFG: every step stacks the group's guidance
  branches into one K2 call at batch K·``max_batch``.

The decode snap runs K3. On the CPU the same code reaches the kernels'
plain versions through their wrappers. There is no ``use_fused`` switch: on
a CUDA device the service always takes the kernel path. The TPU tile knob
``tile_samples`` has no counterpart; the ``mesh=`` data-parallel form waits
for a later slice.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch.data import audio as A
from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.ops.mdm_cuda import make_fused_denoise, stack_block_weights


@dataclasses.dataclass
class MotionRequest:
    audio: np.ndarray  # (S,) 16 kHz waveform
    words: Optional[np.ndarray] = None  # (F,) frame word ids
    request_id: str = ""
    # the per-body-part text-prompt embeddings (TMR, prompt_dim), the
    # guidance scales (audio_scale, prompt_scale) and the MotionCLIP style
    prompts: Optional[Dict[str, np.ndarray]] = None  # part -> (prompt_dim,)
    guidance: Optional[dict] = None
    style: Optional[np.ndarray] = None  # (style_dim,)


@dataclasses.dataclass
class MotionResult:
    request_id: str
    axis_angle: np.ndarray  # (T, 165)
    trans: np.ndarray  # (T, 3)
    latency_s: float


class MotionGenerationService:
    """Fixed-bucket batching server. ``flush()`` runs up to ``max_batch``
    queued requests; ``start()`` runs a background thread that flushes when
    the bucket fills or the oldest request has waited ``max_wait_s``.

    ``mdm`` is a :class:`~syntalker_tpu_torch.models.denoiser.MDM` and
    ``rvq_modules`` maps each body part to ``(RVQVAE, RVQState)``; both are
    moved to ``device`` (CUDA unless ``device="cpu"``). ``seed`` seeds the
    generator that draws each group's initial noise.
    """

    def __init__(
        self,
        *,
        mdm,
        diffusion,
        rvq_modules: dict,
        stats,
        max_batch: int = 16,
        max_seconds: float = 16.0,
        pose_length: int = 128,
        pre_frames: int = 4,
        latent_scale: float = 5.0,
        sr: int = 16000,
        fps: int = 30,
        max_wait_s: float = 0.05,
        fused_loop: bool = True,
        device=None,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        self.mdm = mdm.to(self.device)
        self.diffusion = diffusion
        self.rvq_modules = {
            part: (module.to(self.device), dataclasses.replace(state, codebook=state.codebook.to(self.device)))
            for part, (module, state) in rvq_modules.items()
        }
        self.stats = stats
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.sr, self.fps = sr, fps
        self.latent_scale = latent_scale
        self.plan = G.plan_windows(int(max_seconds * fps), pose_length=pose_length, pre_frames=pre_frames)
        self.samples = sr // fps * self.plan.n_frames
        self.results: Dict[str, MotionResult] = {}
        self._queue: List[tuple] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # K2's weights, with its CUDA graphs: the prompted path's, and the fast path's without fused_loop
        weights = stack_block_weights(self.mdm)
        self._prompted_denoise = make_fused_denoise(self.mdm, weights)
        if fused_loop:
            self._sample = G.make_fused_loop_sampler(self.mdm, diffusion, self.plan)
        else:

            def sample(aw, ww, seed_lat, noise):
                return G.sample_windows_fused(self.mdm, diffusion, self.plan, aw, ww, seed_lat, noise, weights=weights)

            self._sample = sample

    @staticmethod
    def _bucket_key(req: MotionRequest):
        """None for the unprompted fast path; otherwise (prompted parts,
        audio_scale, prompt_scale, style given), the configuration that one
        group shares."""
        if req.prompts is None and req.style is None:
            return None
        g = req.guidance or {}
        parts = tuple(sorted(k for k, v in (req.prompts or {}).items() if v is not None))
        return parts, float(g.get("audio_scale", 1.0)), float(g.get("prompt_scale", 4.0)), req.style is not None

    def _prepare(self, req: MotionRequest):
        y = np.zeros(self.samples, np.float32)
        n = min(len(req.audio), self.samples)
        y[:n] = req.audio[:n]
        words = np.zeros(self.plan.n_frames, np.int64)
        if req.words is not None:
            m = min(len(req.words), self.plan.n_frames)
            words[:m] = req.words[:m]
        return A.onset_amplitude_features(y, self.sr), words

    def submit(self, req: MotionRequest) -> threading.Event:
        """Queue a request; returns an event set when its result is ready
        (read from ``results[request_id]``). A prompted request to a model
        without ``use_prompt`` raises ``ValueError``."""
        cfg = self.mdm.cfg
        key = self._bucket_key(req)
        if key is not None and key[0] and not cfg.use_prompt:
            raise ValueError("prompted requests need an MDM with use_prompt=True")
        for part in key[0] if key else ():
            if part not in J.LATENT_SLICES or np.shape(req.prompts[part]) != (cfg.prompt_dim,):
                raise ValueError(f"prompt {part!r}: a part of {tuple(J.LATENT_SLICES)} and ({cfg.prompt_dim},)")
        if req.style is not None and cfg.use_motionclip and np.shape(req.style) != (cfg.style_dim,):
            raise ValueError(f"style: ({cfg.style_dim},)")
        done = threading.Event()
        with self._lock:
            self._queue.append((req, done, time.perf_counter()))
        return done

    def flush(self) -> List[MotionResult]:
        """Run up to max_batch queued requests: one padded device batch per
        prompt configuration present, unprompted requests through the fast
        path, the others through the CFG sampler."""
        with self._lock:
            batch = self._queue[: self.max_batch]
            self._queue = self._queue[self.max_batch :]
        groups: Dict[Optional[tuple], list] = {}
        for item in batch:
            groups.setdefault(self._bucket_key(item[0]), []).append(item)
        out = []
        for key, items in groups.items():
            out.extend(self._run_group(key, items))
        return out

    def _stack_rows(self, rows) -> torch.Tensor:
        """Per-request vectors padded with zero rows to max_batch."""
        rows = [np.asarray(r, np.float32) for r in rows]
        rows += [np.zeros_like(rows[0])] * (self.max_batch - len(rows))
        return torch.as_tensor(np.stack(rows), device=self.device)

    def _run_group(self, key, batch) -> List[MotionResult]:
        feats, words = zip(*(self._prepare(r) for r, _, _ in batch))
        pad = self.max_batch - len(batch)
        audio = np.concatenate([np.stack(feats), np.zeros((pad, self.samples, 2), np.float32)])
        word = np.concatenate([np.stack(words), np.zeros((pad, self.plan.n_frames), np.int64)])

        dev = self.device
        aw = torch.as_tensor(G.window_audio(audio, self.plan, sr=self.sr, fps=self.fps), device=dev)
        ww = torch.as_tensor(G.window_words(word, self.plan), device=dev)
        seed = torch.zeros(self.max_batch, self.plan.pre_frames, J.LATENT_DIM, device=dev)
        noise = G.draw_noise(self.plan, self.max_batch, self._gen, dev)
        with torch.no_grad():
            if key is None:
                latents = self._sample(aw, ww, seed, noise)
            else:
                parts, audio_scale, prompt_scale, has_style = key
                prompts = {p: self._stack_rows([r.prompts[p] for r, _, _ in batch]) for p in parts}
                style = self._stack_rows([r.style for r, _, _ in batch]) if has_style else None
                latents = G.sample_windows(
                    self.mdm, self.diffusion, self.plan, aw, ww, seed, noise, sampler="ddim",
                    prompts=prompts or None, guidance={"audio_scale": audio_scale, "prompt_scale": prompt_scale},
                    style=style, denoise=self._prompted_denoise)
            dec = G.decode_latents(latents, rvq_modules=self.rvq_modules, stats=self.stats,
                                   latent_scale=self.latent_scale)
        aa = dec["axis_angle"].cpu().numpy()
        trans = dec["trans"].cpu().numpy()

        out = []
        now = time.perf_counter()
        for i, (req, done, t0) in enumerate(batch):
            res = MotionResult(req.request_id, aa[i], trans[i], now - t0)
            self.results[req.request_id] = res
            out.append(res)
            done.set()
        return out

    def start(self, max_wait_s: Optional[float] = None):
        """Background batching loop: flush when the bucket fills or the
        oldest request has waited ``max_wait_s`` (the constructor's value
        when None)."""
        wait = self.max_wait_s if max_wait_s is None else max_wait_s

        def loop():
            while not self._stop.is_set():
                with self._lock:
                    n = len(self._queue)
                    oldest = self._queue[0][2] if n else None
                if n >= self.max_batch or (n and time.perf_counter() - oldest > wait):
                    self.flush()
                else:
                    time.sleep(wait / 5)

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None
