"""The reference of one configuration: its weights, statistics and codebooks
(as the benchmark made them), the sampler and the decoder, at a precision."""

from __future__ import annotations

import torch

from benchmark.reference import decode as D
from benchmark.reference.precision import ROUNDERS, full_f32
from benchmark.reference.sampler import SLICES, Sampler


class Reference:
    """``mdm`` and ``rvq[part]`` are weight dicts, ``codebooks[part]`` (Q, K,
    D), ``stats`` the pose statistics' arrays. ``denoiser`` and ``decode``
    name the rounding of the denoiser's and the decode's products: float32
    for the reference itself, fp8 and tf32 for the control."""

    def __init__(self, cfg, mdm, rvq, codebooks, stats, *, denoiser="float32", decode="float32"):
        self.cfg, self.mdm, self.rvq, self.codebooks, self.stats = cfg, mdm, rvq, codebooks, stats
        self.rnd_decode = ROUNDERS[decode]
        with torch.no_grad(), full_f32():
            self.sampler = Sampler(mdm, cfg, ROUNDERS[denoiser])

    def decode_part(self, part, zq):
        with torch.no_grad(), full_f32():
            return D.decoder(self.rvq[part], "decoder.", self.cfg["rvq"], zq, self.rnd_decode)

    def snap(self, part, z):
        """The control's snap: the nearest code at the decode's rounding, no
        ties enumerated. (T, D) -> (T, D)."""
        rnd, out, r = self.rnd_decode, torch.zeros_like(z), z.clone()
        for cb in self.codebooks[part]:
            dist = (r * r).sum(-1, keepdim=True) - 2.0 * (rnd(r) @ rnd(cb).t()) + (cb * cb).sum(-1)[None]
            code = cb[dist.argmin(-1)]
            r, out = r - code, out + code
        return out

    def motion(self, latents):
        """The control's motion of (B, T, 1536) latents: per part (B, 4T, J,
        3, 3) matrices, and the translation."""
        z = latents.float() * self.cfg["latent_scale"]
        mats, trans = {}, None
        with torch.no_grad(), full_f32():
            for part, (lo, hi) in SLICES.items():
                zq = torch.stack([self.snap(part, zb) for zb in z[..., lo:hi]])
                mats[part], tr = D.part_motion(part, self.decode_part(part, zq), self.stats)
                trans = tr if tr is not None else trans
        return mats, trans
