"""Classifier-free guidance combinators with the branches stacked on the batch.

Counterpart of ``syntalker_tpu/diffusion/cfg.py``: the K guidance branches
of a step (unconditional, audio, one per prompted part) are concatenated
along the batch and run as ONE denoiser call, so on the card each step is
one block-stack (K2) call at batch K·B; the combination weights are applied
to the split outputs.

- :func:`make_cfg_model_fn`: out = u + s·(c − u);
- :func:`make_two_cfg_model_fn`: separate audio and prompt directions;
- :func:`make_bodypart_cfg_model_fn`: per-body-part guidance, each part
  written into its latent slice.

All return ``model_fn(x_t, t) -> pred_x0`` for :mod:`.core`'s samplers.
:func:`bodypart_branches` and :func:`bodypart_branch_weights` give the
body-part guidance as its branches and a (K, C) weight tensor, the form the
guided window of :mod:`~syntalker_tpu_torch.ops.mdm_cuda` replays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from syntalker_tpu_torch.data.joints import LATENT_SLICES
from syntalker_tpu_torch.models.denoiser import Conditioning

# denoise_fn(x_t, t, cond) -> pred_x0, with cond's batch equal to x_t's
DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Conditioning], torch.Tensor]


def stack_conditionings(conds: Sequence[Conditioning]) -> Conditioning:
    """Concatenate K conditionings along the batch, field by field (a field
    that is None in the first is None in the result)."""
    return Conditioning(**{
        f.name: None if getattr(conds[0], f.name) is None else torch.cat([getattr(c, f.name) for c in conds])
        for f in dataclasses.fields(Conditioning)
    })


def _run_branches(denoise_fn: DenoiseFn, x, t, conds: Sequence[Conditioning]) -> list:
    """One forward over K stacked guidance branches; returns the K splits."""
    k = len(conds)
    out = denoise_fn(torch.cat([x] * k), torch.cat([t] * k), stack_conditionings(conds))
    return list(out.chunk(k))


def make_cfg_model_fn(denoise_fn: DenoiseFn, cond: Conditioning, uncond: Conditioning, scale: float):
    """out = uncond + scale · (cond − uncond)."""

    def model_fn(x, t):
        out_c, out_u = _run_branches(denoise_fn, x, t, [cond, uncond])
        return out_u + scale * (out_c - out_u)

    return model_fn


def make_two_cfg_model_fn(denoise_fn: DenoiseFn, cond_audio: Conditioning, cond_prompt: Conditioning,
                          uncond: Conditioning, scale_audio: float, scale_prompt: float):
    """out = uncond + s_a·(audio − uncond) + s_p·(prompt − uncond)."""

    def model_fn(x, t):
        out_a, out_p, out_u = _run_branches(denoise_fn, x, t, [cond_audio, cond_prompt, uncond])
        return out_u + scale_audio * (out_a - out_u) + scale_prompt * (out_p - out_u)

    return model_fn


def bodypart_branches(cond_audio: Conditioning, uncond: Conditioning,
                      part_prompt_conds: Dict[str, Optional[Conditioning]],
                      latent_slices: Dict[str, tuple] = LATENT_SLICES):
    """The body-part guidance's branches [uncond, cond_audio, prompted parts
    in slice order], and each prompted part's index among them."""
    branches = [uncond, cond_audio]
    branch_idx: Dict[str, int] = {}
    for name in latent_slices:
        c = part_prompt_conds.get(name)
        if c is not None:
            branch_idx[name] = len(branches)
            branches.append(c)
    return branches, branch_idx


def make_bodypart_cfg_model_fn(denoise_fn: DenoiseFn, cond_audio: Conditioning, uncond: Conditioning,
                               part_prompt_conds: Dict[str, Optional[Conditioning]], *, audio_scale: float = 1.0,
                               prompt_scale: float = 4.0, latent_slices: Dict[str, tuple] = LATENT_SLICES):
    """Per-body-part CFG. ``part_prompt_conds`` maps each part to the
    conditioning that carries its prompt (audio off), or None for a part
    driven by audio alone. An unprompted part takes s_a = ``audio_scale``
    and no prompt direction; a prompted part takes s_a = 0 and s_p =
    ``prompt_scale``, except 'upper', which keeps s_a = ``audio_scale``.
    The branches are [uncond, cond_audio, prompted parts in slice order]."""
    parts = list(latent_slices)
    branches, branch_idx = bodypart_branches(cond_audio, uncond, part_prompt_conds, latent_slices)

    def model_fn(x, t):
        outs = _run_branches(denoise_fn, x, t, branches)
        out_u, out_a = outs[0], outs[1]
        audio_dir = out_a - out_u
        result = torch.zeros_like(x)
        for name in parts:
            lo, hi = latent_slices[name]
            if name in branch_idx:
                s_a = audio_scale if name == "upper" else 0.0
                part_out = out_u + s_a * audio_dir + prompt_scale * (outs[branch_idx[name]] - out_u)
            else:
                part_out = out_u + audio_scale * audio_dir
            result[..., lo:hi] = part_out[..., lo:hi]
        return result

    return model_fn


def bodypart_branch_weights(branch_idx: Dict[str, int], channels: int, *, audio_scale: float = 1.0,
                            prompt_scale: float = 4.0, latent_slices: Dict[str, tuple] = LATENT_SLICES,
                            device=None) -> torch.Tensor:
    """:func:`make_bodypart_cfg_model_fn`'s mix as (K, ``channels``) f32
    weights W over the branches of :func:`bodypart_branches` (``branch_idx``
    its second value): its prediction is Σ_k W[k] ⊙ out_k. Over a part's
    slice the unconditional branch weighs 1 − s_a − s_p, the audio branch
    s_a and the part's prompt branch s_p, by that function's rules; columns
    outside every slice weigh 0. Made on ``device`` with fills alone (no
    copy from the host)."""
    w = torch.zeros(2 + len(branch_idx), channels, device=device)
    for name, (lo, hi) in latent_slices.items():
        s_a = audio_scale if name not in branch_idx or name == "upper" else 0.0
        s_p = prompt_scale if name in branch_idx else 0.0
        w[0, lo:hi] = 1.0 - s_a - s_p
        w[1, lo:hi] = s_a
        if name in branch_idx:
            w[branch_idx[name], lo:hi] = s_p
    return w
