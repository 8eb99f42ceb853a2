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
  branches into one K2 pass at batch K·``max_batch``, and on the card each
  window replays one CUDA graph of its steps (the guided window of
  :mod:`~syntalker_tpu_torch.ops.mdm_cuda`, kept with the replica's K2
  weights, one a group shape).

The decode snap runs K3. On the CPU the same code reaches the kernels'
plain versions through their wrappers. There is no ``use_fused`` switch: on
a CUDA device the service always takes the kernel path. The TPU tile knob
``tile_samples`` has no counterpart.

``mesh=`` is JAX's data-parallel form, in one process and with no
collectives: each data shard of a flush (``max_batch / data`` requests of
every group) runs on its device with that device's copy of the weights,
its own K1/K2 graphs and its own K3 calls; the results are gathered to the
host in data-axis order. Each group's initial noise is still drawn once at
the full bucket from the service's generator, then split, so a sharded
flush sees the noise of an unsharded one.

With the tracer of :mod:`~syntalker_tpu_torch.utils.tracking` on, a flush
records the spans ``serve.flush``, ``serve.queued`` (a request's wait from
``submit`` to its flush), ``serve.group``, ``serve.features`` (a request's
featurization), ``serve.stage`` (padding, windows, noise), ``serve.fetch``
(the copy to the host) and ``serve.deliver``, and counts the denoiser's
sample rows (``serve.sample_rows``, a group's ``max_batch`` times its
guidance branches) and decoded rows (``serve.decode_rows``), each beside
the share that belongs to requests (``..._real``).
"""

from __future__ import annotations

import dataclasses
import functools
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
from syntalker_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
from syntalker_tpu_torch.utils import tracking


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
    moved to ``device`` (CUDA unless ``device="cpu"``), or with ``mesh`` (a
    single-process :class:`~syntalker_tpu_torch.parallel.mesh.Mesh`) copied
    to each of its devices. ``seed`` seeds the generator that draws each
    group's initial noise, on the first data shard's device.
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
        mesh: Optional[Mesh] = None,
    ):
        if mesh is None:
            mesh = Mesh([[resolve_device(device)]], local=True)
        else:
            if "data" not in mesh.shape:
                raise ValueError(f"mesh needs a 'data' axis, got {mesh.shape}")
            if max_batch % mesh.shape["data"]:
                raise ValueError(f"max_batch {max_batch} not divisible by data axis {mesh.shape['data']}")
        self.mesh = mesh
        self.device = mesh.data_shards()[0][1]
        rvq_modules = {part: (module, dataclasses.replace(state, code_sum=None, code_count=None))
                       for part, (module, state) in rvq_modules.items()}
        replicas = replicate({"mdm": mdm, "rvq": rvq_modules}, mesh)
        self.mdm, self.rvq_modules = replicas[self.device]["mdm"], replicas[self.device]["rvq"]
        self.diffusion = diffusion
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
        # a device's weights, with its CUDA graphs: K2's (the prompted path's, and the fast path's without
        # fused_loop) and K1's
        self._replicas = {}
        for dev, r in replicas.items():
            weights = stack_block_weights(r["mdm"])
            if fused_loop:
                sample = G.make_fused_loop_sampler(r["mdm"], diffusion, self.plan)
            else:
                sample = functools.partial(self._sample_fused, r["mdm"], weights)
            self._replicas[dev] = {**r, "denoise": make_fused_denoise(r["mdm"], weights), "sample": sample}

    def _sample_fused(self, mdm, weights, aw, ww, seed_lat, noise):
        return G.sample_windows_fused(mdm, self.diffusion, self.plan, aw, ww, seed_lat, noise, weights=weights)

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
        with tracking.span("serve.features", request_id=req.request_id):
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
        with tracking.span("serve.flush", requests=len(batch), groups=len(groups)):
            for req, _, t0 in batch:
                tracking.record("serve.queued", int(t0 * 1e9), request_id=req.request_id)
            for key, items in groups.items():
                out.extend(self._run_group(key, items))
        return out

    def _stack_rows(self, rows) -> np.ndarray:
        """Per-request vectors padded with zero rows to max_batch."""
        rows = [np.asarray(r, np.float32) for r in rows]
        rows += [np.zeros_like(rows[0])] * (self.max_batch - len(rows))
        return np.stack(rows)

    def _run_group(self, key, batch) -> List[MotionResult]:
        branches = 2 + len(key[0]) if key and key[0] else 1  # the denoiser's guidance branches
        with tracking.span("serve.group", key=key, rows=self.max_batch, real=len(batch), branches=branches):
            tracking.count("serve.sample_rows", self.max_batch * branches)
            tracking.count("serve.sample_rows_real", len(batch) * branches)
            tracking.count("serve.decode_rows", self.max_batch)
            tracking.count("serve.decode_rows_real", len(batch))
            feats, words = zip(*(self._prepare(r) for r, _, _ in batch))
            with tracking.span("serve.stage"):
                pad = self.max_batch - len(batch)
                audio = np.concatenate([np.stack(feats), np.zeros((pad, self.samples, 2), np.float32)])
                word = np.concatenate([np.stack(words), np.zeros((pad, self.plan.n_frames), np.int64)])

                aw = G.window_audio(audio, self.plan, sr=self.sr, fps=self.fps)
                ww = G.window_words(word, self.plan)
                seed = np.zeros((self.max_batch, self.plan.pre_frames, J.LATENT_DIM), np.float32)
                noise = G.draw_noise(self.plan, self.max_batch, self._gen, self.device)
                rows = {"seed": seed}
                if key is not None:
                    parts, audio_scale, prompt_scale, has_style = key
                    rows["prompts"] = {p: self._stack_rows([r.prompts[p] for r, _, _ in batch]) for p in parts}
                    rows["style"] = self._stack_rows([r.style for r, _, _ in batch]) if has_style else None
            decoded = []
            with torch.no_grad():
                # every shard's sampling and decode is issued before any result is copied back
                for (_, dev), (aw_s, ww_s, noise_s), rows_s in zip(
                        self.mesh.data_shards(), shard_batch((aw, ww, noise), self.mesh, axis=1),
                        shard_batch(rows, self.mesh)):
                    r = self._replicas[dev]
                    if key is None:
                        latents = r["sample"](aw_s, ww_s, rows_s["seed"], noise_s)
                    else:
                        latents = G.sample_windows(
                            r["mdm"], self.diffusion, self.plan, aw_s, ww_s, rows_s["seed"], noise_s, sampler="ddim",
                            prompts=rows_s["prompts"] or None,
                            guidance={"audio_scale": audio_scale, "prompt_scale": prompt_scale},
                            style=rows_s["style"], denoise=r["denoise"])
                    decoded.append(G.decode_latents(latents, rvq_modules=r["rvq"], stats=self.stats,
                                                    latent_scale=self.latent_scale))
            with tracking.span("serve.fetch"):
                aa = np.concatenate([dec["axis_angle"].cpu().numpy() for dec in decoded])
                trans = np.concatenate([dec["trans"].cpu().numpy() for dec in decoded])

            out = []
            with tracking.span("serve.deliver"):
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
