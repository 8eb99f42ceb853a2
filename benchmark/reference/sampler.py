"""eta=0 DDIM over 128-frame windows, with the seed carried between windows.

A clip of F frames (trimmed to a multiple of 8) is cut into windows of 128
frames that advance by 112; each samples 32 latent frames and is seeded
with the last 4 latent frames of the window before (zeros for the first).
The latents are stitched: the first window whole, then each later one
without its 4 seed frames.

Unprompted windows condition on the audio alone and read no prompt.
Prompted windows run the per-body-part guidance: branches [null audio and
null prompt, audio with the null prompt, and for each prompted part null
audio with that part's prompt]; a prompted part takes
``out_u + s_p*(out_part - out_u)`` (the upper body adds the audio direction
``s_a*(out_a - out_u)``), an unprompted part ``out_u + s_a*(out_a - out_u)``,
each written into its 512-wide latent slice.
"""

from __future__ import annotations

import torch

from benchmark.reference import mdm as M
from benchmark.reference.precision import exact
from benchmark.reference.schedule import ddim_plan

PARTS = ("upper", "hands", "lower")
SLICES = {"upper": (0, 512), "hands": (512, 1024), "lower": (1024, 1536)}


def window_starts(n_frames: int, pose_length: int = 128, pre: int = 4, squeeze: int = 4):
    n = n_frames - n_frames % (2 * squeeze)
    step = pose_length - pre * squeeze
    return [w * step for w in range((n - pre * squeeze) // step)]


class Sampler:
    """The sampling half of the reference for one configuration."""

    def __init__(self, W, cfg: dict, rnd=exact):
        self.W, self.cfg, self.mdm, self.rnd = W, cfg, cfg["mdm"], rnd
        d = cfg["diffusion"]
        tmap, a, b = ddim_plan(d["steps"], d["respacing"])
        dev = W["input_process.weight"].device
        self.coef = list(zip(a.tolist(), b.tolist()))
        self.t_emb = M.timestep_embedding(W, self.mdm, torch.as_tensor(tmap, device=dev))

    def window(self, at_branches, prompts, seed, noise, mix=None):
        """One window: ``at_branches`` (K, B, T, A) and ``prompts`` (K rows of
        (B, P) or None) of the K branches, seed (B, 4, C), initial noise
        (B, T, C); ``mix(outs) -> x0`` combines the branches' predictions."""
        k, b = at_branches.shape[:2]
        seed_emb = M.seed_embedding(self.W, seed).repeat(k, 1)
        prompt = None if prompts[0] is None else torch.cat(prompts)
        cond = M.Cond(at=at_branches.reshape((k * b,) + at_branches.shape[2:]), seed_emb=seed_emb, prompt=prompt)
        x = noise
        for it, (ca, cb) in enumerate(self.coef):
            t_emb = self.t_emb[it][None].expand(k * b, -1)
            out = M.denoise(self.W, self.mdm, x.repeat(k, 1, 1), t_emb, cond, self.rnd)
            x0 = out if mix is None else mix(out.chunk(k))
            x = ca * x + cb * x0
        return x

    def clip(self, audio, word, noise, *, prompts=None, guidance=None):
        """A whole clip. audio (B, S, 2) per-sample features, word (B, F),
        noise (W, B, 32, C) -> stitched latents (B, T_out, C). ``prompts``
        maps prompted parts to (B, prompt_dim); None runs unprompted."""
        c = self.cfg
        spf = c["sr"] // c["fps"]
        pl, pre = c["pose_length"], c["pre_frames"]
        b = audio.shape[0]
        seed = torch.zeros(b, pre, noise.shape[-1], device=noise.device)
        outs = []
        for w, f0 in enumerate(window_starts(word.shape[1], pl, pre)):
            aw = _padded(audio[:, f0 * spf : (f0 + pl) * spf], pl * spf)
            ww = _padded(word[:, f0 : f0 + pl], pl)
            if prompts is None:
                x = self.window(M.encode(self.W, self.mdm, aw, ww)[None], [None], seed, noise[w])
            else:
                x = self._guided(aw, ww, seed, noise[w], prompts, guidance)
            outs.append(x if w == 0 else x[:, pre:])
            seed = x[:, -pre:]
        return torch.cat(outs, 1)

    def _guided(self, aw, ww, seed, noise, prompts, guidance):
        b = aw.shape[0]
        at_a = M.encode(self.W, self.mdm, aw, ww)
        at_null = M.encode(self.W, self.mdm, aw, ww, null_audio=True)
        null = self.W["uncond_prompt_embedding"].expand(b, -1)
        parts = [p for p in PARTS if p in prompts]
        ats = torch.stack([at_null, at_a] + [at_null] * len(parts))
        rows = [null, null] + [prompts[p] for p in parts]
        s_a, s_p = guidance["audio_scale"], guidance["prompt_scale"]

        def mix(outs):
            out_u, out_a = outs[0], outs[1]
            res = torch.empty_like(out_u)
            for p in PARTS:
                lo, hi = SLICES[p]
                if p in parts:
                    part = out_u + s_p * (outs[2 + parts.index(p)] - out_u)
                    if p == "upper":
                        part = part + s_a * (out_a - out_u)
                else:
                    part = out_u + s_a * (out_a - out_u)
                res[..., lo:hi] = part[..., lo:hi]
            return res

        return self.window(ats, rows, seed, noise, mix)


def _padded(x, n):
    if x.shape[1] >= n:
        return x
    pad = torch.zeros((x.shape[0], n - x.shape[1]) + x.shape[2:], dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], 1)


def stream_window(sampler: Sampler, audio, word, seed, noise):
    """One unprompted window of a stream: audio (1, 128*533, 2), word
    (1, 128), the seed the stream carried in, the window's noise."""
    at = M.encode(sampler.W, sampler.mdm, audio, word)
    return sampler.window(at[None], [None], seed, noise)

