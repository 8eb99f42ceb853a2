"""End-to-end audio→motion generation: windowed autoregressive outpainting.

Counterpart of ``syntalker_tpu/generation.py``. A clip is cut into
128-frame windows; each is seeded with the previous window's last 4 latent
frames and sampled; the windows are stitched (first whole, later ones minus
the seed overlap), scaled, snapped and decoded per body part, denormalized,
the lower-body translation velocity integrated, and everything scattered
back to 165-dof axis-angle; on the text-control (h3d623) representation,
:func:`decode_latents_h3d` scatters the parts into 623-d features and
recovers the joints.

Samplers:

- :func:`sample_windows` — the general sampler: DDPM or DDIM, the per-body-
  part prompt CFG with its guidance branches stacked into one denoise a
  step (K2 at batch K·B on the card), a MotionCLIP style; one window of it
  is :func:`sample_window`. On the card, an η=0 DDIM window on the default
  K2 denoiser replays one CUDA graph of its whole loop
  (:class:`~syntalker_tpu_torch.ops.mdm_cuda.GuidedDDIMWindow`, one a
  (device, K, B, T)); the CPU, DDPM and a caller's own ``denoise`` take
  :mod:`.diffusion.core`'s step loop;
- :func:`sample_windows_lean` — the plain reference of the unprompted η=0
  DDIM path (PyTorch f32, the algebraic folds of the JAX lean sampler);
- :func:`make_fused_loop_sampler` — unprompted, one K1 call per window;
  one window of it is :func:`fused_window`, and
  :func:`sample_windows_fused_loop` its one-shot wrapper; with ``mesh=``
  each data shard on its device (:func:`shard_sampler`);
- :func:`sample_windows_fused` — unprompted, a host loop over steps, one K2
  call per step.

The three unprompted samplers read no prompt or style, as in JAX: on a
``use_prompt`` model they skip ``input_process3``, where
``sample_windows(prompts=None)`` applies it with the null prompt.

JAX's threefry key chain has no PyTorch counterpart, so every sampler takes
the per-window initial noise explicitly, ``(W, B, T, 1536)`` (see
:func:`draw_noise` for drawing it from a ``torch.Generator``), and DDPM its
per-step noise.

With the tracer of :mod:`~syntalker_tpu_torch.utils.tracking` on, each
window is a ``sample.window`` span (``path`` ``k1``, ``k2``, ``guided`` or
``plain``, and ``guided_graph`` or ``plain_graph`` where the window replays
its graph), each conditioning encode a ``sample.encode`` (``branches``: the
encodes it holds), each denoising step of a step loop a ``sample.step``
(none in a graphed window: its steps are one replay) and each decode a
``decode`` (``rows``); the guided window counts ``sample.graph_windows``
and ``sample.graph_captures``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.data.h3d import H3D_DIM, part_mask_623, recover_from_ric
from syntalker_tpu_torch.diffusion.cfg import (bodypart_branch_weights, bodypart_branches, make_bodypart_cfg_model_fn,
                                                stack_conditionings)
from syntalker_tpu_torch.diffusion.core import sample
from syntalker_tpu_torch.models.denoiser import MDM, Conditioning, apply_rope, rope_angles
from syntalker_tpu_torch.ops import rotations as rot
from syntalker_tpu_torch.ops.mdm_cuda import FusedDDIMWindow, guided_ddim_window, make_fused_denoise, stack_block_weights
from syntalker_tpu_torch.parallel.mesh import replicate, shard_batch
from syntalker_tpu_torch.utils import tracking


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Static description of the window decomposition."""

    n_frames: int  # usable motion frames (trimmed)
    pose_length: int  # frames per window (128)
    pre_frames: int  # latent seed frames (4)
    squeeze: int  # temporal downscale (4)
    num_windows: int
    round_l: int  # fresh frames per window = pose_length - pre*squeeze

    @property
    def latent_window(self) -> int:
        return self.pose_length // self.squeeze  # 32

    @property
    def out_latent_frames(self) -> int:
        lw = self.latent_window
        return lw + (self.num_windows - 1) * (lw - self.pre_frames)


def plan_windows(n_frames: int, *, pose_length: int = 128, pre_frames: int = 4, squeeze: int = 4) -> WindowPlan:
    n = n_frames - n_frames % (2 * squeeze)  # trim to a multiple of 8
    seed_span = pre_frames * squeeze  # 16 frames
    round_l = pose_length - seed_span  # 112
    num = (n - seed_span) // round_l
    if num < 1:
        raise ValueError(f"clip too short: {n_frames} frames < {pose_length}")
    return WindowPlan(n, pose_length, pre_frames, squeeze, num, round_l)


def window_audio(audio: np.ndarray, plan: WindowPlan, sr: int = 16000, fps: int = 30) -> np.ndarray:
    """Per-window raw-audio slices: (B, S, C) -> (W, B, S_w, C)."""
    spf = sr // fps  # 533
    wlen = spf * plan.pose_length
    out = []
    for i in range(plan.num_windows):
        start = i * spf * plan.round_l
        sl = audio[:, start : start + wlen]
        if sl.shape[1] < wlen:  # zero-pad the tail window
            sl = np.pad(sl, ((0, 0), (0, wlen - sl.shape[1])) + ((0, 0),) * (audio.ndim - 2))
        out.append(sl)
    return np.stack(out)


def window_words(word: np.ndarray, plan: WindowPlan) -> np.ndarray:
    """(B, F) -> (W, B, pose_length) word-id windows."""
    out = []
    for i in range(plan.num_windows):
        start = i * plan.round_l
        sl = word[:, start : start + plan.pose_length]
        if sl.shape[1] < plan.pose_length:
            sl = np.pad(sl, ((0, 0), (0, plan.pose_length - sl.shape[1])))
        out.append(sl)
    return np.stack(out)


def draw_noise(plan: WindowPlan, batch: int, generator: torch.Generator, device) -> torch.Tensor:
    """Per-window initial DDIM noise (W, B, T_latent, 1536)."""
    shape = (plan.num_windows, batch, plan.latent_window, J.LATENT_DIM)
    return torch.randn(shape, generator=generator, device=device)


def _stitch(windows, pre: int) -> torch.Tensor:
    """First window whole, later windows minus the seed overlap."""
    return torch.cat([windows[0]] + [w[:, pre:] for w in windows[1:]], dim=1)


def encode_windows(mdm: MDM, audio_windows, word_windows, pre: int) -> torch.Tensor:
    """at_feat of every window in ONE (W·B)-batched encode: it does not
    depend on the seed. Returns (W, B, T_latent, A)."""
    n_w, b = audio_windows.shape[:2]
    aw = audio_windows.reshape((n_w * b,) + audio_windows.shape[2:])
    ww = word_windows.reshape((n_w * b,) + word_windows.shape[2:])
    zseed = torch.zeros(n_w * b, pre, J.LATENT_DIM, device=aw.device)
    with tracking.span("sample.encode", branches=1):
        at = mdm.encode_cond(aw, ww, zseed).at_feat
    return at.reshape((n_w, b) + at.shape[1:])


def make_denoise_fn(mdm: MDM, diffusion, denoise=None):
    """``denoise_fn(x_t, t, cond) -> x0`` for :mod:`.diffusion.core`'s
    samplers, t the original timesteps: the timestep embeddings of the
    schedule computed once and looked up. ``denoise(x_t, t_emb, cond)``
    defaults to the block stack through K2 with bf16 weights."""
    if denoise is None:
        denoise = make_fused_denoise(mdm, stack_block_weights(mdm))
    tmap = torch.as_tensor(np.asarray(diffusion.timestep_map), dtype=torch.long,
                           device=mdm.input_process.weight.device)
    t_emb_all = mdm.embed_timesteps(tmap)

    def denoise_fn(x, t, cond):
        return denoise(x, t_emb_all[torch.searchsorted(tmap, t)], cond)

    denoise_fn.denoise = denoise  # read by guided_window_for
    return denoise_fn


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def guided_window_for(mdm: MDM, diffusion, denoise_fn, noise, sampler: str):
    """The :class:`~syntalker_tpu_torch.ops.mdm_cuda.GuidedDDIMWindow` that
    runs a window of :func:`sample_window` as one graph replay, or None for
    :mod:`.diffusion.core`'s step loop. The window is taken where the input
    allows it: ``noise`` on the card, η=0 DDIM, and ``denoise_fn`` made by
    :func:`make_denoise_fn` on ``mdm``'s own ``make_fused_denoise`` (its
    K2 weights keep the window). DDPM's per-step noise, the CPU and a
    caller's own ``denoise`` keep the step loop."""
    denoise = getattr(denoise_fn, "denoise", None)
    if not _on_card(noise) or sampler != "ddim" or getattr(denoise, "mdm", None) is not mdm:
        return None
    return guided_ddim_window(mdm, diffusion, denoise.weights)


@torch.no_grad()
def sample_window(mdm: MDM, diffusion, denoise_fn, audio, word, seed, noise, *, sampler: str = "ddpm",
                  step_noise=None, prompts=None, guidance=None, uncond_audio=False, style=None) -> torch.Tensor:
    """One window of :func:`sample_windows`: audio (B, S, 2), word (B, F),
    seed (B, pre, 1536), initial noise (B, T, 1536) -> latents (B, T, 1536).
    Without ``prompts``, one conditioning (``uncond_audio`` applied) and the
    plain conditioned sampler. With ``prompts`` (part -> (B, prompt_dim)),
    the audio branch (null prompt), the unconditional branch (null audio and
    prompt) and one branch per prompted part (null audio, that part's
    prompt), mixed by
    :func:`~syntalker_tpu_torch.diffusion.cfg.make_bodypart_cfg_model_fn`
    with ``guidance`` (``audio_scale``, ``prompt_scale``), so every step's
    branches are one denoise call. ``style`` (B, style_dim) enters every
    encode. DDPM reads ``step_noise`` (S, B, T, 1536) or ``(it) -> noise``.
    Where :func:`guided_window_for` finds a guided window, the branches'
    conditionings are stacked once and the window's whole loop is one
    graph replay; otherwise :mod:`.diffusion.core` runs the steps."""
    guidance = guidance or {}
    window = guided_window_for(mdm, diffusion, denoise_fn, noise, sampler)

    def encode(**kw):
        return mdm.encode_cond(audio, word, seed, style=style, **kw)

    if prompts is None:
        with tracking.span("sample.encode", branches=1):
            cond = encode(uncond_audio=uncond_audio)
        if window is not None:
            return window(noise, cond, torch.ones(1, noise.shape[-1], device=noise.device))

        def model_fn(x, t):
            return denoise_fn(x, t, cond)
    else:
        scales = {"audio_scale": guidance.get("audio_scale", 1.0), "prompt_scale": guidance.get("prompt_scale", 4.0)}
        branches = 2 + sum(prompts.get(name) is not None for name in J.LATENT_SLICES)
        with tracking.span("sample.encode", branches=branches):
            part_conds = {name: None if prompts.get(name) is None
                          else encode(uncond_audio=True, prompt=prompts[name]) for name in J.LATENT_SLICES}
            cond_audio, uncond = encode(uncond_prompt=True), encode(uncond_audio=True, uncond_prompt=True)
        if window is not None:
            conds, index = bodypart_branches(cond_audio, uncond, part_conds)
            return window(noise, stack_conditionings(conds),
                          bodypart_branch_weights(index, noise.shape[-1], device=noise.device, **scales))
        model_fn = make_bodypart_cfg_model_fn(denoise_fn, cond_audio, uncond, part_conds, **scales)
    return sample(diffusion, model_fn, noise, method=sampler, step_noise=step_noise)


@torch.no_grad()
def sample_windows(mdm: MDM, diffusion, plan: WindowPlan, audio_windows, word_windows, init_seed, noise, *,
                   sampler: str = "ddpm", step_noise=None, prompts=None, guidance=None, uncond_audio=False,
                   style=None, denoise=None):
    """Windowed sampling with the seed carried; returns stitched latents
    (B, out_latent_frames, 1536). Each window is :func:`sample_window`;
    ``noise`` is the initial noise of each window (W, B, T, 1536), DDPM's
    ``step_noise`` a tensor (W, S, B, T, 1536) or a callable
    ``(w, it) -> (B, T, 1536)``. ``denoise(x_t, t_emb, cond) -> x0``
    defaults to the block stack through K2 with bf16 weights."""
    denoise_fn = make_denoise_fn(mdm, diffusion, denoise)
    path = "plain" if prompts is None else "guided"
    if guided_window_for(mdm, diffusion, denoise_fn, noise, sampler) is not None:
        path += "_graph"
    seed, outs = init_seed, []
    for w in range(plan.num_windows):
        noise_w = step_noise
        if step_noise is not None:
            noise_w = functools.partial(step_noise, w) if callable(step_noise) else step_noise[w]
        with tracking.span("sample.window", path=path):
            x = sample_window(mdm, diffusion, denoise_fn, audio_windows[w], word_windows[w], seed, noise[w],
                              sampler=sampler, step_noise=noise_w, prompts=prompts, guidance=guidance,
                              uncond_audio=uncond_audio, style=style)
        outs.append(x)
        seed = x[:, -plan.pre_frames :]
    return _stitch(outs, plan.pre_frames)


@torch.no_grad()
def sample_windows_lean(mdm: MDM, diffusion, plan: WindowPlan, audio_windows, word_windows, init_seed, noise):
    """Plain reference sampler: windowed η=0 DDIM in f32 with the exact
    algebraic folds of the JAX lean sampler (``input_process`` ∘ the x slab
    of ``input_process2`` as one matmul, per-window audio slab, per-step
    style rows, the two-coefficient update). Returns stitched latents
    (B, out_latent_frames, 1536)."""
    cfg = mdm.cfg
    b = audio_windows.shape[1]
    lw, d = plan.latent_window, cfg.latent_dim
    dev = init_seed.device
    tmap = torch.as_tensor(np.asarray(diffusion.timestep_map), dtype=torch.long, device=dev)
    t_emb_all = mdm.embed_timesteps(tmap)

    w_in, b_in = mdm.input_process.weight.t(), mdm.input_process.bias
    w2, b2 = mdm.input_process2.weight.t(), mdm.input_process2.bias
    w2_style, w2_mid, w2_at = w2[:d], w2[d : 2 * d], w2[2 * d :]
    w_x = w_in @ w2_mid
    bias_c = b_in @ w2_mid + b2
    w_out, b_out = mdm.output_process.weight.t(), mdm.output_process.bias
    coef_a, coef_b = diffusion.ddim_coefficients()
    t_rows = (t_emb_all @ w2_style).flip(0)  # iteration order
    hd = d // cfg.rope_heads
    angles = rope_angles(lw, hd).to(dev)[:, None, :]

    at_all = encode_windows(mdm, audio_windows, word_windows, plan.pre_frames)[:, :, :lw]
    at_c_all = at_all @ w2_at + bias_c  # (W, B, T, D)
    w_seed = mdm.embed_seed.weight.t() @ w2_style
    b_seed = mdm.embed_seed.bias @ w2_style

    seed, windows = init_seed, []
    for w in range(plan.num_windows):
        seed_row = seed.reshape(b, -1) @ w_seed + b_seed
        x = noise[w]
        for it in range(diffusion.num_steps):
            h = x @ w_x + at_c_all[w] + (seed_row + t_rows[it])[:, None, :]
            h = apply_rope(h.reshape(b, lw, cfg.rope_heads, hd), angles).reshape(b, lw, d)
            x0 = mdm.run_blocks(h) @ w_out + b_out
            x = float(coef_a[it]) * x + float(coef_b[it]) * x0
        windows.append(x)
        seed = x[:, -plan.pre_frames :]
    return _stitch(windows, plan.pre_frames)


@torch.no_grad()
def fused_window(mdm: MDM, fused: FusedDDIMWindow, at_feat, seed, noise) -> torch.Tensor:
    """One unprompted η=0 DDIM window through K1: the audio/word features
    ``at_feat`` (B, T, A), the seed (B, pre, 1536) embedded, initial noise
    (B, T, 1536) -> latents (B, T, 1536). Reads no prompt or style."""
    seed_emb = mdm.embed_seed(seed.reshape(seed.shape[0], -1))
    return fused(noise, Conditioning(at_feat=at_feat, seed_emb=seed_emb))


def make_fused_loop_sampler(mdm: MDM, diffusion, plan: WindowPlan, *, weights_dtype=torch.bfloat16, mesh=None):
    """Windowed sampler with each window's whole DDIM loop in K1. Returns
    ``sample(audio_windows, word_windows, init_seed, noise) -> latents``.

    ``mesh``: the data-parallel form of a single-process
    :class:`~syntalker_tpu_torch.parallel.mesh.Mesh`. Each distinct device
    gets its copy of the model and its own K1 (its weights and graphs); the
    batch axis of the inputs is split into the data shards, and each shard
    is encoded, sampled window by window with its seed carried, and stitched
    on its device, with nothing gathered between windows (JAX's ``mesh=``
    form, whose programs need no collectives). ``sample`` then returns one
    latents tensor a data shard, in data-axis order, each on its device."""
    if mesh is not None:
        samplers = {device: make_fused_loop_sampler(m, diffusion, plan, weights_dtype=weights_dtype)
                    for device, m in replicate(mdm, mesh).items()}
        return shard_sampler(mesh, samplers)
    fused = FusedDDIMWindow(mdm, diffusion, weights_dtype=weights_dtype)
    pre = plan.pre_frames

    @torch.no_grad()
    def sample(audio_windows, word_windows, init_seed, noise):
        at_all = encode_windows(mdm, audio_windows, word_windows, pre)
        seed, outs = init_seed, []
        for w in range(plan.num_windows):
            with tracking.span("sample.window", path="k1"):
                x = fused_window(mdm, fused, at_all[w], seed, noise[w])
            outs.append(x)
            seed = x[:, -pre:]
        return _stitch(outs, pre)

    return sample


def shard_sampler(mesh, samplers: dict):
    """``sample(audio_windows, word_windows, init_seed, noise) -> [latents]``
    over a mesh's data shards: the window stacks (W, B, ...) split on their
    batch axis, the seed (B, ...) on its first, each shard run by
    ``samplers[device]`` on its device (asynchronously: nothing waits for a
    shard before the next is issued)."""

    @torch.no_grad()
    def sample(audio_windows, word_windows, init_seed, noise):
        windows = shard_batch((audio_windows, word_windows, noise), mesh, axis=1)
        seeds = shard_batch(init_seed, mesh)
        return [samplers[device](aw, ww, seed, nz)
                for (_, device), (aw, ww, nz), seed in zip(mesh.data_shards(), windows, seeds)]

    return sample


def sample_windows_fused_loop(mdm: MDM, diffusion, plan: WindowPlan, audio_windows, word_windows, init_seed, noise, *,
                              weights_dtype=torch.bfloat16, fused=None) -> torch.Tensor:
    """One-shot wrapper over :func:`make_fused_loop_sampler`; ``fused`` is
    a sampler it returned. Callers sampling repeatedly should build the
    sampler once and pass it: each build stacks the weights again."""
    if fused is None:
        fused = make_fused_loop_sampler(mdm, diffusion, plan, weights_dtype=weights_dtype)
    return fused(audio_windows, word_windows, init_seed, noise)


@torch.no_grad()
def sample_windows_fused(mdm: MDM, diffusion, plan: WindowPlan, audio_windows, word_windows, init_seed, noise, *, weights=None):
    """Windowed η=0 DDIM with one K2 block-stack call per step; the input
    and output projections run in PyTorch around it. ``weights`` is a
    prebuilt :func:`stack_block_weights` (a service caches it)."""
    if weights is None:
        weights = stack_block_weights(mdm)
    denoise = make_fused_denoise(mdm, weights)  # JAX's fused denoise reads no prompt or style
    b = audio_windows.shape[1]
    dev = init_seed.device
    tmap = torch.as_tensor(np.asarray(diffusion.timestep_map), dtype=torch.long, device=dev)
    t_emb_all = mdm.embed_timesteps(tmap)
    coef_a, coef_b = diffusion.ddim_coefficients()
    n = diffusion.num_steps
    seed, outs = init_seed, []
    for w in range(plan.num_windows):
        with tracking.span("sample.window", path="k2"):
            with tracking.span("sample.encode", branches=1):
                cond = mdm.encode_cond(audio_windows[w], word_windows[w], seed)
            cond = Conditioning(at_feat=cond.at_feat, seed_emb=cond.seed_emb)
            x = noise[w]
            for it in range(n):
                with tracking.span("sample.step"):
                    te = t_emb_all[n - 1 - it][None].expand(b, -1)
                    x = float(coef_a[it]) * x + float(coef_b[it]) * denoise(x, te, cond)
        outs.append(x)
        seed = x[:, -plan.pre_frames :]
    return _stitch(outs, plan.pre_frames)


@torch.no_grad()
def decode_latents(latents, *, rvq_modules: dict, stats, latent_scale: float = 5.0, use_trans: bool = True):
    """Latents (B, T_lat, 1536) in model space -> per-part snap + decode
    (``rvq_modules``: part -> (RVQVAE, RVQState)) -> :func:`decode_parts`."""
    with tracking.span("decode", rows=latents.shape[0]):
        z = latents * latent_scale
        parts = {}
        for name, (lo, hi) in J.LATENT_SLICES.items():
            module, state = rvq_modules[name]
            parts[name] = module.latent2origin(z[..., lo:hi].contiguous(), state)
        return decode_parts(parts, stats=stats, use_trans=use_trans)


@torch.no_grad()
def decode_latents_h3d(latents, *, rvq_modules: dict, h3d_stats, latent_scale: float = 5.0):
    """Latents (B, T_lat, 1536) in model space -> 623-d HumanML3D features
    and global joints (the text-control test path,
    h3d_diffusion_new_trainer.py:561-607): each part snapped and decoded
    (``RVQVAE.latent2origin``: K3 on the card), scattered through its
    ``part_mask_623``, denormalized by ``h3d_stats``, then
    ``recover_from_ric``. Returns ``{"features": (B, T, 623), "joints":
    (B, T, 52, 3)}``."""
    z = latents * latent_scale
    feats = None
    for name, (lo, hi) in J.LATENT_SLICES.items():
        module, state = rvq_modules[name]
        part = module.latent2origin(z[..., lo:hi].contiguous(), state)
        if feats is None:
            feats = part.new_zeros(z.shape[0], part.shape[1], H3D_DIM)
        feats[..., torch.as_tensor(part_mask_623(name), device=part.device).long()] = part
    feats = h3d_stats.denormalize(feats)
    return {"features": feats, "joints": recover_from_ric(feats)}


def decode_parts(parts: Dict[str, torch.Tensor], *, stats, use_trans: bool = True):
    """Normalized per-part features -> full-body rot6d / axis-angle /
    translation. With ``use_trans`` the lower part's last 3 channels are the
    root velocity, integrated into ``trans``; without, the lower part is the
    rotations alone and ``trans`` is None. Jaw and eyes stay zero for the
    caller to fill."""
    rec_upper = stats.denormalize_part(parts["upper"], "upper")
    rec_hands = stats.denormalize_part(parts["hands"], "hands")
    lower = parts["lower"]
    rec_trans = None
    if use_trans:
        trans_v = stats.denormalize_trans(lower[..., -3:])
        rec_trans = torch.cumsum(trans_v, dim=-2)
        rec_trans[..., 1] = trans_v[..., 1]  # height is predicted directly, not integrated
        lower = lower[..., :-3]
    rec_lower = stats.denormalize_part(lower, "lower")

    b, t = rec_upper.shape[:2]
    rot6d_full = rec_upper.new_zeros(b, t, J.ROT6D_DIM)
    for idx, rec in ((J.UPPER_6D_IDX, rec_upper), (J.HANDS_6D_IDX, rec_hands), (J.LOWER_6D_IDX, rec_lower)):
        rot6d_full[..., torch.as_tensor(idx, device=rec.device)] = rec

    m = rot.rotation_6d_to_matrix(rot6d_full.reshape(b, t, J.NUM_JOINTS, 6))
    return {
        "rot6d": rot.matrix_to_rotation_6d(m).reshape(b, t, J.ROT6D_DIM),
        "axis_angle": rot.matrix_to_axis_angle(m).reshape(b, t, J.AXIS_ANGLE_DIM),
        "trans": rec_trans,
        "parts": {"upper": rec_upper, "hands": rec_hands, "lower": rec_lower},
    }
