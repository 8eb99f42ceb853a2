"""The cosine noise schedule (Nichol & Dhariwal) respaced for eta=0 DDIM."""

from __future__ import annotations

import math

import numpy as np


def cosine_alphas_cumprod(steps: int) -> np.ndarray:
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.array([min(1 - alpha_bar((i + 1) / steps) / alpha_bar(i / steps), 0.999) for i in range(steps)])
    return np.cumprod(1.0 - betas)


def respaced(steps: int, respacing: str) -> np.ndarray:
    """'ddimN': the N timesteps 0, s, 2s, ... of the smallest stride s that
    gives exactly N."""
    want = int(respacing[len("ddim"):])
    for stride in range(1, steps):
        if len(range(0, steps, stride)) == want:
            return np.arange(0, steps, stride)
    raise ValueError(respacing)


def ddim_plan(steps: int, respacing: str):
    """Per iteration (noisiest first): the original timestep fed to the
    model and the update x' = a*x + b*x0 of eta=0 DDIM, in float64."""
    acp = cosine_alphas_cumprod(steps)
    use = respaced(steps, respacing)
    abar = acp[use]
    abar_prev = np.concatenate([[1.0], abar[:-1]])
    order = np.arange(len(use))[::-1]
    r, rm1 = np.sqrt(1.0 / abar), np.sqrt(1.0 / abar - 1.0)
    a = np.sqrt(1.0 - abar_prev) * r / rm1
    b = np.sqrt(abar_prev) - np.sqrt(1.0 - abar_prev) / rm1
    return use[order], a[order], b[order]
