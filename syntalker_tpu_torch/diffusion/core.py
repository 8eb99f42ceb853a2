"""DDPM/DDIM core: the q-process, the training loss and the samplers (PyTorch).

Counterpart of ``syntalker_tpu/diffusion/core.py``: the model
callback is ``model_fn(x_t, t) -> pred_x0`` with t the ORIGINAL timestep
indices (B,); the prediction target is x0 and the DDPM variance is
FIXED_SMALL (the posterior variance). The samplers run a host loop over the
respaced steps in iteration order (iteration it is step i = S-1-it).

JAX's threefry key chain has no PyTorch counterpart, so the samplers take
their noise from the caller: the initial noise as a tensor, and for DDPM and
η > 0 DDIM the per-step noise ``step_noise``, either a tensor indexed by the
iteration (S, B, T, C) or a callable ``(it) -> (B, T, C)``; the training
loss takes its timesteps and noise as tensors.

Each iteration of a sampler is a ``sample.step`` span of
:mod:`~syntalker_tpu_torch.utils.tracking` (recorded only while the tracer
is on).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from syntalker_tpu_torch.diffusion.schedule import DiffusionParams
from syntalker_tpu_torch.utils import tracking

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x_t, t_orig) -> x0_pred
StepNoise = Union[torch.Tensor, Callable[[int], torch.Tensor]]


def q_sample(params: DiffusionParams, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """A draw of q(x_t | x_0) at sampled-index timesteps t (B,)."""
    return (params.gather("sqrt_alphas_cumprod", t) * x_start
            + params.gather("sqrt_one_minus_alphas_cumprod", t) * noise)


def q_posterior_mean(params: DiffusionParams, x_start, x_t, t) -> torch.Tensor:
    return params.gather("posterior_mean_coef1", t) * x_start + params.gather("posterior_mean_coef2", t) * x_t


def predict_eps_from_xstart(params: DiffusionParams, x_t, t, x0) -> torch.Tensor:
    return (params.gather("sqrt_recip_alphas_cumprod", t) * x_t - x0) / params.gather("sqrt_recipm1_alphas_cumprod", t)


def smooth_l1(a: torch.Tensor, b: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber / SmoothL1 (torch semantics, beta 1)."""
    d = torch.abs(a - b)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def training_loss(params: DiffusionParams, model_fn: ModelFn, x_start: torch.Tensor, t: torch.Tensor,
                  noise: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample x0-prediction SmoothL1 loss (B,) at sampled-index
    timesteps t; with a (B, T) validity mask, normalized by (#valid frames
    × C)."""
    x_t = q_sample(params, x_start, t, noise)
    t_orig = torch.as_tensor(params.timestep_map, dtype=torch.long, device=t.device)[t]
    loss = smooth_l1(model_fn(x_t, t_orig), x_start)
    if mask is None:
        return loss.mean((1, 2))
    m = mask.to(loss.dtype)
    valid = torch.clamp(m.sum(1), min=1.0)
    return (loss * m[..., None]).sum((1, 2)) / (valid * x_start.shape[-1])


def _noise_at(step_noise: Optional[StepNoise], it: int) -> torch.Tensor:
    if step_noise is None:
        raise ValueError("this sampler draws noise every step: pass step_noise")
    return step_noise(it) if callable(step_noise) else step_noise[it]


def _step_inputs(params: DiffusionParams, x: torch.Tensor, it: int):
    """(sampled index i, t (B,), original timesteps (B,)) of iteration it."""
    i = params.num_steps - 1 - it
    t = torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)
    t_orig = torch.as_tensor(params.timestep_map, dtype=torch.long, device=x.device)[t]
    return i, t, t_orig


@torch.no_grad()
def ddpm_sample(params: DiffusionParams, model_fn: ModelFn, init_noise: torch.Tensor, step_noise: StepNoise, *,
                clip_denoised: bool = False) -> torch.Tensor:
    """Ancestral sampling with FIXED_SMALL variance from ``init_noise``
    (B, T, C); the last step adds no noise."""
    x = init_noise
    for it in range(params.num_steps):
        with tracking.span("sample.step"):
            i, t, t_orig = _step_inputs(params, x, it)
            pred_x0 = model_fn(x, t_orig)
            if clip_denoised:
                pred_x0 = pred_x0.clamp(-1.0, 1.0)
            mean = q_posterior_mean(params, pred_x0, x, t)
            x = mean
            if i > 0:
                x = x + torch.exp(0.5 * params.gather("posterior_log_variance_clipped", t)) * _noise_at(step_noise, it)
    return x


@torch.no_grad()
def ddim_sample(params: DiffusionParams, model_fn: ModelFn, init_noise: torch.Tensor, *, eta: float = 0.0,
                step_noise: Optional[StepNoise] = None, clip_denoised: bool = False) -> torch.Tensor:
    """DDIM over the respaced steps in ``params`` from ``init_noise``;
    η = 0 (the default) is deterministic and reads no ``step_noise``."""
    x = init_noise
    for it in range(params.num_steps):
        with tracking.span("sample.step"):
            i, t, t_orig = _step_inputs(params, x, it)
            pred_x0 = model_fn(x, t_orig)
            if clip_denoised:
                pred_x0 = pred_x0.clamp(-1.0, 1.0)
            eps = predict_eps_from_xstart(params, x, t, pred_x0)
            abar = params.gather("alphas_cumprod", t)
            abar_prev = params.gather("alphas_cumprod_prev", t)
            sigma = eta * torch.sqrt((1 - abar_prev) / (1 - abar)) * torch.sqrt(1 - abar / abar_prev)
            x = torch.sqrt(abar_prev) * pred_x0 + torch.sqrt(torch.clamp(1 - abar_prev - sigma**2, min=0.0)) * eps
            if eta and i > 0:
                x = x + sigma * _noise_at(step_noise, it)
    return x


def sample(params: DiffusionParams, model_fn: ModelFn, init_noise: torch.Tensor, *, method: str = "ddpm",
           **kw) -> torch.Tensor:
    if method == "ddpm":
        return ddpm_sample(params, model_fn, init_noise, **kw)
    if method == "ddim":
        return ddim_sample(params, model_fn, init_noise, **kw)
    raise ValueError(f"unknown sampler: {method}")
