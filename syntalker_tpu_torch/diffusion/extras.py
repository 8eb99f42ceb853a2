"""Secondary diffusion machinery (PyTorch).

Counterpart of ``syntalker_tpu/diffusion/extras.py``: the PLMS sampler, the
inpainting overwrite of the x0 prediction, the variational-bound terms
(normal KL, the discretized Gaussian log-likelihood, bits per dim), the
timestep samplers (uniform, and importance sampling by the second moment
of recent losses, whose history is host numpy state) and the parameter EMA.
JAX's threefry draws have no PyTorch counterpart: PLMS takes its initial
noise, and the samplers draw from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from syntalker_tpu_torch.diffusion.core import ModelFn, predict_eps_from_xstart, q_posterior_mean
from syntalker_tpu_torch.diffusion.schedule import DiffusionParams


@torch.no_grad()
def plms_sample(params: DiffusionParams, model_fn: ModelFn, init_noise: torch.Tensor, *,
                clip_denoised: bool = False) -> torch.Tensor:
    """PLMS from ``init_noise``: the 4-step Adams-Bashforth combination of
    the eps history, lower-order multistep combinations while it fills."""
    x = init_noise
    b = x.shape[0]
    tmap = torch.as_tensor(params.timestep_map, dtype=torch.long, device=x.device)
    hist = []  # newest first
    for it in range(params.num_steps):
        t = torch.full((b,), params.num_steps - 1 - it, dtype=torch.long, device=x.device)
        pred_x0 = model_fn(x, tmap[t])
        if clip_denoised:
            pred_x0 = pred_x0.clamp(-1.0, 1.0)
        eps = predict_eps_from_xstart(params, x, t, pred_x0)
        if len(hist) == 0:
            eps_prime = eps
        elif len(hist) == 1:
            eps_prime = (3 * eps - hist[0]) / 2
        elif len(hist) == 2:
            eps_prime = (23 * eps - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            eps_prime = (55 * eps - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24
        abar = params.gather("alphas_cumprod", t)
        abar_prev = params.gather("alphas_cumprod_prev", t)
        x0 = (x - torch.sqrt(1 - abar) * eps_prime) / torch.sqrt(abar)
        x = torch.sqrt(abar_prev) * x0 + torch.sqrt(1 - abar_prev) * eps_prime
        hist = [eps] + hist[:2]
    return x


def inpainting_model_fn(params: DiffusionParams, model_fn: ModelFn, inpainted_motion: torch.Tensor,
                        inpainting_mask: torch.Tensor) -> ModelFn:
    """Overwrite the known region of the x0 prediction at every step."""

    def fn(x_t, t_orig):
        return torch.where(inpainting_mask, inpainted_motion, model_fn(x_t, t_orig))

    return fn


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2), elementwise."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2) + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """Log-likelihood of an 8-bit-discretized Gaussian."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_delta))


def vb_terms_bpd(params: DiffusionParams, model_fn: ModelFn, x_start: torch.Tensor, x_t: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """Per-sample variational-bound term at sampled-index t, in bits per
    dim, for the FIXED_SMALL x0-prediction model: the decoder NLL at t = 0,
    the KL of the posteriors elsewhere."""
    true_mean = q_posterior_mean(params, x_start, x_t, t)
    true_logvar = params.gather("posterior_log_variance_clipped", t)
    t_orig = torch.as_tensor(params.timestep_map, dtype=torch.long, device=t.device)[t]
    model_mean = q_posterior_mean(params, model_fn(x_t, t_orig), x_t, t)
    kl = normal_kl(true_mean, true_logvar, model_mean, true_logvar)
    kl = kl.reshape(kl.shape[0], -1).mean(1) / math.log(2.0)
    nll = -discretized_gaussian_log_likelihood(x_start, model_mean, 0.5 * true_logvar)
    nll = nll.reshape(nll.shape[0], -1).mean(1) / math.log(2.0)
    return torch.where(t == 0, nll, kl)


class UniformSampler:
    def __init__(self, num_steps: int):
        self.num_steps = num_steps

    def sample(self, generator: torch.Generator, batch: int, device=None):
        """(timesteps (B,), importance weights (B,) of ones)."""
        t = torch.randint(0, self.num_steps, (batch,), generator=generator, device=device)
        return t, torch.ones(batch, device=device)


class LossSecondMomentResampler:
    """Timesteps importance-sampled by the second moment of recent losses;
    the history is host numpy state that gates the next batch's draws."""

    def __init__(self, num_steps: int, history_per_term: int = 10, uniform_prob: float = 0.001):
        self.num_steps = num_steps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._history = np.zeros((num_steps, history_per_term), np.float64)
        self._counts = np.zeros(num_steps, np.int64)

    def weights(self) -> np.ndarray:
        if not (self._counts == self.history_per_term).all():
            return np.ones(self.num_steps)
        w = np.sqrt(np.mean(self._history**2, axis=-1))
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / self.num_steps

    def sample(self, generator: torch.Generator, batch: int, device=None):
        """(timesteps (B,), importance weights 1 / (S·p_t) (B,))."""
        w = self.weights()
        p = torch.as_tensor(w / w.sum(), dtype=torch.float32)
        idx = torch.multinomial(p, batch, replacement=True, generator=generator)
        return idx.to(device), (1.0 / (self.num_steps * p[idx])).to(device)

    def update(self, ts, losses):
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            if self._counts[t] == self.history_per_term:
                self._history[t, :-1] = self._history[t, 1:]
                self._history[t, -1] = loss
            else:
                self._history[t, self._counts[t]] = loss
                self._counts[t] += 1


@torch.no_grad()
def update_ema(ema_params: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               rate: float = 0.9999) -> Dict[str, torch.Tensor]:
    """ema <- ema·rate + p·(1 - rate), leaf by leaf, as a new dict."""
    return {k: e * rate + params[k] * (1 - rate) for k, e in ema_params.items()}
