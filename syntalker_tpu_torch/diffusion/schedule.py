"""Diffusion noise schedule and timestep respacing as numpy arrays.

Counterpart of ``make_diffusion`` / ``DiffusionParams`` in
``syntalker_tpu/diffusion/schedule.py`` for what the samplers read: the
cosine betas of the shipped configuration, respaced once at construction
('ddimN'), the q-process and posterior terms of DDPM and DDIM, as numpy
arrays; :meth:`DiffusionParams.gather` reads them at tensor timesteps.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def cosine_betas(num_steps: int, max_beta: float = 0.999) -> np.ndarray:
    """betas_for_alpha_bar with the squared-cosine schedule."""

    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    return np.array(
        [
            min(1 - alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps), max_beta)
            for i in range(num_steps)
        ],
        dtype=np.float64,
    )


def space_timesteps(num_timesteps: int, respacing: str) -> list[int]:
    """The original timesteps kept by a 'ddimN' respacing: N evenly strided
    steps from 0."""
    if not respacing.startswith("ddim"):
        raise ValueError(f"unsupported respacing {respacing!r}: only 'ddimN' is ported")
    desired = int(respacing[len("ddim") :])
    for stride in range(1, num_timesteps):
        if len(range(0, num_timesteps, stride)) == desired:
            return list(range(0, num_timesteps, stride))
    raise ValueError(f"cannot create exactly {desired} steps with an integer stride")


@dataclasses.dataclass(frozen=True)
class DiffusionParams:
    """Schedule arrays over the S sampling steps (already respaced)."""

    num_steps: int
    timestep_map: np.ndarray  # (S,) int32 sampled index -> original t
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The f32 values of schedule array ``name`` at sampled-index
        timesteps t (B,), shaped (B, 1, 1) on t's device."""
        arr = torch.as_tensor(getattr(self, name), dtype=torch.float32, device=t.device)
        return arr[t][:, None, None]

    def ddim_coefficients(self) -> tuple[np.ndarray, np.ndarray]:
        """η=0 DDIM update x' = a·x + b·x0 in ITERATION order (iteration it
        is step index i = S-1-it):
        eps = (r[i]·x - x0) / rm1[i],  x' = sqrt(abar_prev)·x0 + sqrt(1-abar_prev)·eps
        so a = sqrt(1-abar_prev)·r/rm1 and b = sqrt(abar_prev) - sqrt(1-abar_prev)/rm1.
        Returns float32 (a, b), each (S,)."""
        idx = np.arange(self.num_steps - 1, -1, -1)
        abar_prev = np.asarray(self.alphas_cumprod_prev, np.float64)[idx]
        r = np.asarray(self.sqrt_recip_alphas_cumprod, np.float64)[idx]
        rm1 = np.asarray(self.sqrt_recipm1_alphas_cumprod, np.float64)[idx]
        s1m = np.sqrt(np.maximum(1.0 - abar_prev, 0.0))
        a = (s1m * r / rm1).astype(np.float32)
        b = (np.sqrt(abar_prev) - s1m / rm1).astype(np.float32)
        return a, b


def make_diffusion(*, steps: int = 1000, timestep_respacing: str | None = None) -> DiffusionParams:
    """Cosine schedule over ``steps`` original timesteps, respaced to
    ``timestep_respacing`` ('ddimN') when given."""
    betas = cosine_betas(steps)
    alphas_cumprod = np.cumprod(1.0 - betas)

    if timestep_respacing:
        use = space_timesteps(steps, timestep_respacing)
        last = 1.0
        new_betas = []
        for i in use:
            new_betas.append(1 - alphas_cumprod[i] / last)
            last = alphas_cumprod[i]
        betas = np.array(new_betas, dtype=np.float64)
        timestep_map = np.array(use, dtype=np.int32)
    else:
        timestep_map = np.arange(steps, dtype=np.int32)

    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
    # the first step's variance is 0; its log takes the second step's value
    post_logvar = np.log(np.append(posterior_variance[1], posterior_variance[1:]))
    return DiffusionParams(
        num_steps=len(betas),
        timestep_map=timestep_map,
        betas=betas.astype(np.float32),
        alphas_cumprod=acp.astype(np.float32),
        alphas_cumprod_prev=acp_prev.astype(np.float32),
        sqrt_alphas_cumprod=np.sqrt(acp).astype(np.float32),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - acp).astype(np.float32),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp).astype(np.float32),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1.0).astype(np.float32),
        posterior_variance=posterior_variance.astype(np.float32),
        posterior_log_variance_clipped=post_logvar.astype(np.float32),
        posterior_mean_coef1=(betas * np.sqrt(acp_prev) / (1.0 - acp)).astype(np.float32),
        posterior_mean_coef2=((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)).astype(np.float32),
    )
