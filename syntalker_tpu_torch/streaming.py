"""Streaming audio→motion generation: push audio chunks, receive motion.

Counterpart of ``syntalker_tpu/streaming.py``. Each 128-frame window
depends on the past only through the 4-latent-frame seed, so motion can be
emitted while audio is still arriving:

    sess = StreamingMotionSession(mdm=..., diffusion=..., rvq_modules=...,
                                  stats=...)
    for chunk in microphone():            # (S, 2) feature chunks, any size
        for seg in sess.push_audio(chunk):
            play(seg["axis_angle"], seg["trans"])
    tail = sess.finish()

- **Window cadence.** A window covers ``pose_length`` (128) frames of audio
  and yields ``round_l`` (112) fresh frames; window *w* runs once audio
  through frame ``w*112 + 128`` has arrived.
- **Decoder lookahead.** The RVQ ConvDecoder is non-causal, so emitted
  frames are held back ``lookahead`` latent frames until their right
  context exists, and each chunk is decoded with ``lookback`` latent frames
  of history. A steady window decodes ``lookback + lookahead + 28`` latent
  frames and emits the 28 in ``[lookback, lookback + 28)``.
- **Translation carry.** Offline decode integrates the lower-body
  translation velocity over the whole clip; the session carries the running
  x/z integral across windows (y is predicted, not integrated).

The samplers are the offline ones, one window at a time:
:func:`~syntalker_tpu_torch.generation.fused_window` (K1, one call a
window) for an unprompted session, which reads no prompt even on a
``use_prompt`` model, like JAX's lean window;
:func:`~syntalker_tpu_torch.generation.sample_window` (η=0 DDIM, one K2
call a step with every guidance branch stacked) for a session with
``prompts=`` or ``style=``. The decode snaps through K3.

The session keeps its state on the device between windows: the seed, the
``lookback + lookahead`` latent tail ring and the translation carry. A
window uploads its audio and words and makes one blocking device→host copy,
its segment. JAX's threefry chain has no PyTorch counterpart: the initial
noise of each window comes from ``generator``, or from ``noise`` (W, 1, T,
1536) where a caller hands each window's noise in.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.ops.mdm_cuda import FusedDDIMWindow, make_fused_denoise, stack_block_weights

_SEGMENT = (("rot6d", J.ROT6D_DIM), ("axis_angle", J.AXIS_ANGLE_DIM), ("trans", 3))


@dataclasses.dataclass
class StreamStats:
    windows_run: int = 0
    frames_emitted: int = 0


def _value_fingerprint(*objs) -> str:
    """16-byte blake2b digest over the contents of nested values: mappings,
    sequences, dataclasses, modules (their ``state_dict``), tensors of any
    dtype (their bytes, bf16 included), arrays and numbers."""
    h = hashlib.blake2b(digest_size=16)

    def upd(o):
        if o is None:
            h.update(b"\x00none")
        elif isinstance(o, torch.nn.Module):
            h.update(b"\x00module")
            upd(o.state_dict())
        elif isinstance(o, Mapping):
            h.update(b"\x00map")
            for k in sorted(o, key=str):
                h.update(str(k).encode())
                upd(o[k])
        elif isinstance(o, (list, tuple)):
            h.update(b"\x00seq")
            for v in o:
                upd(v)
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            h.update(b"\x00dc")
            for f in dataclasses.fields(o):
                h.update(f.name.encode())
                upd(getattr(o, f.name))
        elif isinstance(o, torch.Tensor):
            t = o.detach().contiguous().cpu()
            h.update(str((tuple(t.shape), str(t.dtype))).encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(o, (np.ndarray, np.number, float, int, bool)):
            arr = np.asarray(o)
            h.update(str((arr.shape, str(arr.dtype))).encode())
            h.update(arr.tobytes())
        else:
            h.update(repr(o).encode())

    for o in objs:
        upd(o)
    return h.hexdigest()


class StreamingMotionSession:
    """Incremental windowed generation with bounded, documented latency.

    Algorithmic latency = one window (``pose_length`` frames of audio must
    arrive before the window runs) + ``lookahead * squeeze`` frames of
    decoder hold-back: 128 + 32 frames, about 5.3 s of audio at the
    defaults.

    ``mdm`` is a :class:`~syntalker_tpu_torch.models.denoiser.MDM`,
    ``rvq_modules`` maps each body part to ``(RVQVAE, RVQState)``; both are
    moved to ``device`` (CUDA unless ``device="cpu"``). ``prompts`` maps
    parts to (1, prompt_dim), ``style`` is (1, style_dim), ``guidance``
    holds ``audio_scale`` and ``prompt_scale``. ``weights_dtype`` is the
    kernels' weight type (bf16; f32 only for the plain versions on the
    CPU). ``denoise(x_t, t_emb, cond) -> x0`` replaces the prompted path's
    K2 denoise, as in :func:`~syntalker_tpu_torch.generation.sample_windows`.
    """

    def __init__(
        self,
        *,
        mdm,
        diffusion,
        rvq_modules: dict,
        stats,
        latent_scale: float = 5.0,
        sr: int = 16000,
        fps: int = 30,
        pose_length: int = 128,
        pre_frames: int = 4,
        squeeze: int = 4,
        lookback: int = 16,
        lookahead: int = 8,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        prompts: Optional[Dict[str, torch.Tensor]] = None,
        guidance: Optional[dict] = None,
        style: Optional[torch.Tensor] = None,
        weights_dtype: torch.dtype = torch.bfloat16,
        denoise=None,
        device=None,
    ):
        self.device = dev = resolve_device(device)
        self.mdm = mdm.to(dev)
        self.diffusion = diffusion
        self.rvq_modules = {
            part: (module.to(dev), dataclasses.replace(state, codebook=state.codebook.to(dev)))
            for part, (module, state) in rvq_modules.items()
        }
        self.stats = stats
        self.latent_scale = latent_scale
        self.sr, self.fps = sr, fps
        self.spf = sr // fps
        self.pose_length = pose_length
        self.pre_frames = pre_frames
        self.squeeze = squeeze
        self.lw = pose_length // squeeze
        self.round_l = pose_length - pre_frames * squeeze
        self.fresh_lat = self.lw - pre_frames
        self.lookback = lookback
        self.lookahead = lookahead
        if lookback + lookahead > self.lw:
            raise ValueError("lookback+lookahead must fit in one window")
        self.prompts = None if prompts is None else {p: v.to(dev) for p, v in prompts.items()}
        self.guidance = guidance or {}
        self.style = None if style is None else style.to(dev)
        self.generator = generator if generator is not None else torch.Generator(dev).manual_seed(0)
        self.noise = noise
        # the lean K1 window covers the plain audio path; prompts or a style
        # take the general batched-branch window (one K2 pass a step; on the card one guided window graph)
        self._use_cfg = prompts is not None or style is not None
        if self._use_cfg:
            self._kernel_weights = None if denoise else stack_block_weights(self.mdm, weights_dtype)
            denoise = denoise or make_fused_denoise(self.mdm, self._kernel_weights)
            self._denoise_fn = G.make_denoise_fn(self.mdm, diffusion, denoise)
        else:
            self._fused = FusedDDIMWindow(self.mdm, diffusion, weights_dtype=weights_dtype)
            self._kernel_weights = self._fused.blocks

        self._audio = np.zeros((0, 2), np.float32)
        self._words = np.zeros((0,), np.int64)
        self._w = 0
        self._frame_start = 0
        self._state = self._initial_state()
        self.stream_stats = StreamStats()

    def _initial_state(self) -> dict:
        """The device-resident session state threaded through the window
        programs."""
        dev = self.device
        return {
            "seed": torch.zeros(1, self.pre_frames, J.LATENT_DIM, device=dev),
            "tail": torch.zeros(1, self.lookback + self.lookahead, J.LATENT_DIM, device=dev),
            "carry": torch.zeros(3, device=dev),  # x/z integral; y unused
        }

    # ------------------------------------------------------------------
    # window programs

    def _sample_window(self, audio, word, seed, noise):
        if self._use_cfg:
            return G.sample_window(self.mdm, self.diffusion, self._denoise_fn, audio, word, seed, noise,
                                   sampler="ddim", prompts=self.prompts, guidance=self.guidance, style=self.style)
        at = G.encode_windows(self.mdm, audio[None], word[None], self.pre_frames)[0]
        return G.fused_window(self.mdm, self._fused, at, seed, noise)

    def _decode(self, latents):
        return G.decode_latents(latents, rvq_modules=self.rvq_modules, stats=self.stats,
                                latent_scale=self.latent_scale)

    def _emit_from(self, dec, s_lat, e_lat, carry):
        """Frames [s_lat*4, e_lat*4) of a chunk decode, packed into one
        (frames, 330 + 165 + 3) tensor, with the translation cumsum rebased
        onto the global carry."""
        sq = self.squeeze
        s, e = s_lat * sq, e_lat * sq
        tr = dec["trans"][0]
        base = tr[s - 1] if s > 0 else torch.zeros_like(tr[0])
        xz = torch.tensor([1.0, 0.0, 1.0], device=tr.device)
        seg_tr = tr[s:e] + ((carry - base) * xz)[None, :]
        seg = torch.cat([dec["rot6d"][0, s:e], dec["axis_angle"][0, s:e], seg_tr], dim=-1)
        return seg, carry + (tr[e - 1] - base) * xz

    def _first(self, audio, word, state, noise):
        x = self._sample_window(audio, word, state["seed"], noise)
        emit = self.lw - self.lookahead
        seg, carry = self._emit_from(self._decode(x), 0, emit, state["carry"])
        return seg, {"seed": x[:, -self.pre_frames :], "tail": x[:, emit - self.lookback :], "carry": carry}

    def _steady(self, audio, word, state, noise):
        x = self._sample_window(audio, word, state["seed"], noise)
        buf = torch.cat([state["tail"], x[:, self.pre_frames :]], dim=1)
        # the tail spans [E-lookback, E+lookahead); emit [E, E+fresh)
        s = self.lookback
        seg, carry = self._emit_from(self._decode(buf), s, s + self.fresh_lat, state["carry"])
        return seg, {"seed": x[:, -self.pre_frames :], "tail": buf[:, self.fresh_lat :], "carry": carry}

    def _flush(self, state):
        s = self.lookback
        seg, carry = self._emit_from(self._decode(state["tail"]), s, s + self.lookahead, state["carry"])
        return seg, {**state, "carry": carry}

    # ------------------------------------------------------------------

    def push_audio(self, chunk: np.ndarray, words: Optional[np.ndarray] = None) -> List[Dict[str, np.ndarray]]:
        """Append a 16 kHz feature chunk ((S, 2) amplitude + onset channels,
        see data.audio.onset_amplitude_features) and its frame word ids, and
        run every window whose audio is now complete. Returns the newly
        emitted motion segments."""
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim != 2 or chunk.shape[1] != 2:
            raise ValueError(f"expected (S, 2) feature chunk, got {chunk.shape}")
        self._audio = np.concatenate([self._audio, chunk])
        if words is not None:
            self._words = np.concatenate([self._words, np.asarray(words, np.int64)])
        out = []
        while self._window_ready():
            out.append(self._run_window())
        return out

    def _window_ready(self) -> bool:
        need = (self._w * self.round_l + self.pose_length) * self.spf
        return self._audio.shape[0] >= need

    def _window_inputs(self):
        start_f = self._w * self.round_l
        s0 = start_f * self.spf
        a = self._audio[s0 : s0 + self.pose_length * self.spf]
        if a.shape[0] < self.pose_length * self.spf:
            a = np.pad(a, ((0, self.pose_length * self.spf - a.shape[0]), (0, 0)))
        w = self._words[start_f : start_f + self.pose_length]
        if w.shape[0] < self.pose_length:
            w = np.pad(w, (0, self.pose_length - w.shape[0]))
        dev = self.device
        return torch.as_tensor(a[None], device=dev), torch.as_tensor(w[None], device=dev)

    def _window_noise(self):
        if self.noise is not None:
            return self.noise[self._w].to(self.device)
        return torch.randn(1, self.lw, J.LATENT_DIM, generator=self.generator, device=self.device)

    def _segment(self, seg_dev) -> Dict[str, np.ndarray]:
        """The window's one device→host copy, split into its fields."""
        seg_np = seg_dev.cpu().numpy()
        out, lo = {}, 0
        for name, width in _SEGMENT:
            out[name] = seg_np[:, lo : lo + width]
            lo += width
        out["frame_start"] = self._frame_start
        self._frame_start += len(seg_np)
        self.stream_stats.frames_emitted += len(seg_np)
        return out

    @torch.no_grad()
    def _run_window(self) -> Dict[str, np.ndarray]:
        audio, word = self._window_inputs()
        program = self._first if self._w == 0 else self._steady
        seg_dev, self._state = program(audio, word, self._state, self._window_noise())
        self._w += 1
        self.stream_stats.windows_run += 1
        return self._segment(seg_dev)

    def finish(self, *, pad_final: bool = False) -> List[Dict[str, np.ndarray]]:
        """Flush the lookahead hold-back. By default trailing audio short of
        a full window is dropped, exactly the offline plan's
        ``(n - 16) // 112`` window count, so a streamed clip matches the
        offline sampler + decode of the same audio. ``pad_final=True``
        instead zero-pads one extra window to cover the tail (emits frames
        past the real audio; the caller trims)."""
        out = []
        if self._w == 0:
            return out
        remaining_f = self._audio.shape[0] // self.spf - self._w * self.round_l
        if pad_final and remaining_f > self.pre_frames * self.squeeze:
            out.append(self._run_window())
        with torch.no_grad():
            seg_dev, self._state = self._flush(self._state)
        out.append(self._segment(seg_dev))
        return out

    # ------------------------------------------------------------------
    # cold start: the signature of the window programs, and their capture

    def _aot_signature(self) -> dict:
        """Everything the window programs depend on: the shape and branch
        configuration, plus a content fingerprint of every value they read
        (the MDM's weights and the kernels' stacked copies, the RVQ-VAEs and
        their codebooks, stats, latent_scale, guidance, prompts, style)."""
        dev = self.device
        return {
            "weights_fp": _value_fingerprint(
                self.mdm,
                self._kernel_weights,
                {n: t for n, t in sorted(self.rvq_modules.items())},
                self.stats,
                self.latent_scale,
                self.guidance,
                self.prompts,
                self.style,
            ),
            "pose_length": self.pose_length,
            "pre_frames": self.pre_frames,
            "squeeze": self.squeeze,
            "lookback": self.lookback,
            "lookahead": self.lookahead,
            "sr": self.sr,
            "fps": self.fps,
            "use_cfg": self._use_cfg,
            "prompt_parts": sorted(self.prompts) if self.prompts else [],
            "num_steps": int(self.diffusion.num_steps),
            "latent_dim": int(self.mdm.cfg.latent_dim),
            "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        }

    def save_compiled(self, directory) -> None:
        """Write the signature of the window programs to
        ``directory/signature.json``. Nothing else is saved: a CUDA graph
        cannot be serialized, so :meth:`load_compiled` captures the graphs
        again."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        (d / "signature.json").write_text(json.dumps(self._aot_signature()))

    def load_compiled(self, directory) -> None:
        """Check the signature that :meth:`save_compiled` wrote against this
        session, then :meth:`warm_up`. Raises ``ValueError`` if the session
        configuration, the fingerprinted values or the device differ from
        the session that saved it."""
        saved = json.loads((Path(directory) / "signature.json").read_text())
        mine = self._aot_signature()
        if saved != mine:
            diff = {k: (saved.get(k), mine.get(k)) for k in set(saved) | set(mine) if saved.get(k) != mine.get(k)}
            raise ValueError(f"saved window programs don't match this session: {diff}")
        self.warm_up()

    @torch.no_grad()
    def warm_up(self) -> None:
        """Capture the window programs' graphs (K1's per-(B, T) plan or the
        guided window's) and warm the decode before the first window
        instead of at it: the first, steady and flush programs run once on
        zeros, on a scratch state. The session's own state, noise and
        counters stay untouched."""
        dev = self.device
        audio = torch.zeros(1, self.pose_length * self.spf, 2, device=dev)
        word = torch.zeros(1, self.pose_length, dtype=torch.long, device=dev)
        noise = torch.zeros(1, self.lw, J.LATENT_DIM, device=dev)
        _, state = self._first(audio, word, self._initial_state(), noise)
        _, state = self._steady(audio, word, state, noise)
        self._flush(state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
