"""RVQ-VAE train step: SmoothL1 reconstruction + commit loss, with the EMA
codebook update threaded through the train state.

Counterpart of ``syntalker_tpu/train/rvq_trainer.py``: ``RVQLossConfig``,
``rvq_loss`` (with the optional velocity and acceleration terms) and
``make_rvq_train_step``. The forward runs in full f32 (the module's own
:func:`~syntalker_tpu_torch.device.full_f32`), so that the code assignment,
the EMA and the loss are exact; the backward runs at PyTorch's precision
settings, which on the card let cuDNN compute f32 convolution gradients in
TF32. That is the GPU's counterpart of JAX's convolutions at the TPU's
default precision (only the code distances are at ``HIGHEST`` there);
without TF32, cuDNN takes FFT algorithms for these gradients that need ~10×
the time and a 33 GB workspace at the shipped batch (``PERF.md``). The step
updates the state in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from syntalker_tpu_torch.diffusion.core import smooth_l1
from syntalker_tpu_torch.models.rvqvae import RVQVAE, RVQVAEDraws, draw_rvqvae
from syntalker_tpu_torch.train.optim import apply_updates
from syntalker_tpu_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class RVQLossConfig:
    commit_weight: float = 0.02
    # velocity / acceleration terms (off in the shipped run)
    vel_weight: float = 0.0
    acc_weight: float = 0.0


def rvq_loss(rec: torch.Tensor, gt: torch.Tensor, commit: torch.Tensor,
             cfg: RVQLossConfig) -> Tuple[torch.Tensor, dict]:
    recon = smooth_l1(rec, gt).mean()
    loss = recon + cfg.commit_weight * commit
    metrics = {"recon": recon, "commit": commit}
    if cfg.vel_weight > 0:
        vel = smooth_l1(rec[:, 1:] - rec[:, :-1], gt[:, 1:] - gt[:, :-1]).mean()
        loss = loss + cfg.vel_weight * vel
        metrics["vel"] = vel
    if cfg.acc_weight > 0:
        rec_a = rec[:, 2:] - 2 * rec[:, 1:-1] + rec[:, :-2]
        gt_a = gt[:, 2:] - 2 * gt[:, 1:-1] + gt[:, :-2]
        acc = smooth_l1(rec_a, gt_a).mean()
        loss = loss + cfg.acc_weight * acc
        metrics["acc"] = acc
    return loss, metrics


def make_rvq_train_step(module: RVQVAE, optimizer, loss_cfg: RVQLossConfig = RVQLossConfig()):
    """A ``(state, batch, draws=None) -> (state, metrics)`` step on a
    (B, T, input_dim) batch of normalized pose features. ``draws`` default
    to :func:`draw_rvqvae` from ``state.generator``; the metrics (recon,
    commit, perplexity, loss, ...) are detached 0-d tensors."""

    def step(state: TrainState, batch: torch.Tensor, draws: Optional[RVQVAEDraws] = None):
        if draws is None:
            draws = draw_rvqvae(module.cfg, batch.shape, state.generator, batch.device)
        params = state.params
        rec, out = module(batch, state.quantizer_state, train=True, draws=draws)
        loss, metrics = rvq_loss(rec, batch, out.commit_loss, loss_cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        updates, state.opt_state = optimizer.update(dict(zip(params, grads)), state.opt_state, params)
        apply_updates(params, updates)
        state.step += 1
        state.quantizer_state = out.state
        metrics.update(perplexity=out.perplexity, loss=loss)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step
