"""The control: the reference put in the program's place, one precision
below what the configuration states (``precision`` in its file): the
denoiser's products in fp8 where the kernels run bf16, the snap's distances
and the decoder's convolutions in TF32 where the decode runs float32 with
TF32 off. A judge that passes the control cannot tell the program from a
lower-precision one; the limits are set between the program's readings and
the control's (PERF.md). Only the control test and the measurement of the
limits run it."""

from __future__ import annotations

import torch

from benchmark import judge
from benchmark.reference.precision import full_f32
from benchmark.reference.sampler import stream_window

LOWER = {"bfloat16": "fp8", "float32": "tf32"}


class Control:
    def __init__(self, models, cfg: dict):
        p = cfg["precision"]
        self.ref = models.reference(denoiser=LOWER[p["denoiser"]], decode=LOWER[p["decode"]])

    def _returned(self, latents, frames, carry=None):
        mats, trans = self.ref.motion(latents)
        s, e = frames
        base = trans[0, s - 1] if s > 0 else torch.zeros_like(trans[0, 0])
        c = torch.zeros_like(base) if carry is None else torch.as_tensor(carry, dtype=base.dtype, device=base.device)
        tr = trans[0, s:e] + (c - base) * judge.XZ.to(base.device)
        return {"mats": {p: m[0, s:e] for p, m in mats.items()}, "rot6d": None, "trans": tr}

    def stream_window(self, audio, word, seed, noise, prev, carry, lookback=16, lookahead=8):
        """One stream window in the control's precision, from the program's
        state: (decode input (1, T, 1536), what it returns)."""
        with torch.no_grad(), full_f32():
            x = stream_window(self.ref.sampler, audio, word, seed, noise)
            pre = seed.shape[1]
            if prev is None:
                return x, self._returned(x, (0, (x.shape[1] - lookahead) * 4))
            buf = torch.cat([prev[:, -(lookback + lookahead):], x[:, pre:]], 1)
            return buf, self._returned(buf, (lookback * 4, (lookback + x.shape[1] - pre) * 4), carry)

    def clip(self, audio, word, noise, prompts=None, guidance=None):
        """One served clip in the control's precision: (latents (1, T, 1536),
        what it returns)."""
        with torch.no_grad(), full_f32():
            lat = self.ref.sampler.clip(audio, word, noise, prompts=prompts, guidance=guidance)
            return lat, self._returned(lat, (0, lat.shape[1] * 4))
