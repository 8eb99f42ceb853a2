"""Diffusion (denoiser) train step and the frozen RVQ latent encoder.

Counterpart of ``syntalker_tpu/train/diffusion_trainer.py``: uniform
timestep sampling, the x0-prediction SmoothL1 loss on the 1536-d latent
sequence, the optimizer step, and the BatchNorm running statistics of a
``audio_norm='batch'`` wav encoder moved by the batch (the module's
buffers, which are the state's ``model_state``). The batch carries latents
already made by the frozen body-part RVQ-VAE encoders
(:func:`make_latent_encoder`: per-part normalization, ``map2latent``,
concat, ÷ ``latent_scale``).

JAX's step draws its timesteps, noise and train-time masks from threefry
keys; here they are one :class:`DiffusionDraws`, made by
:func:`draw_diffusion` from the state's generator unless the caller gives
them. The forward runs as the model's inference does (the wav encoder
under :func:`~syntalker_tpu_torch.device.full_f32` in ``audio_dtype``, the
blocks in ``dtype``); the backward at PyTorch's precision settings (f32
convolution gradients in TF32 on the card, as in
:mod:`~syntalker_tpu_torch.train.rvq_trainer`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.diffusion.core import training_loss
from syntalker_tpu_torch.diffusion.schedule import DiffusionParams
from syntalker_tpu_torch.models.denoiser import MDM, TrainDraws, draw_train
from syntalker_tpu_torch.train.optim import apply_updates
from syntalker_tpu_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class DiffusionTrainConfig:
    pre_frames: int = 4
    latent_scale: float = 5.0


@dataclasses.dataclass
class DiffusionDraws:
    """The draws of one step: sampled-index timesteps (B,), the noise of
    x0's shape and the model's train-time masks."""

    t: torch.Tensor
    noise: torch.Tensor
    masks: TrainDraws

    def to(self, device) -> "DiffusionDraws":
        return DiffusionDraws(self.t.to(device), self.noise.to(device), self.masks.to(device))


def draw_diffusion(mdm: MDM, diffusion: DiffusionParams, x0_shape, generator: torch.Generator,
                   device=None) -> DiffusionDraws:
    b = x0_shape[0]
    t = torch.randint(0, diffusion.num_steps, (b,), generator=generator, device=device)
    noise = torch.randn(tuple(x0_shape), generator=generator, device=device)
    return DiffusionDraws(t, noise, draw_train(mdm.cfg, b, generator, device))


def make_diffusion_train_step(mdm: MDM, diffusion: DiffusionParams, optimizer,
                              cfg: DiffusionTrainConfig = DiffusionTrainConfig()):
    """A ``(state, batch, draws=None) -> (state, metrics)`` step.

    batch: ``latent_in`` (B, T_lat, 1536) scaled latents (x0), ``audio``
    (B, S, 2) onset+amplitude channels, ``word`` (B, F) ids, and optionally
    ``prompt`` (B, prompt_dim) and ``style`` (B, style_dim). The module is
    put in training mode; ``metrics["predict_x0_loss"]`` is the batch mean
    loss (detached)."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor], draws: Optional[DiffusionDraws] = None):
        x0 = batch["latent_in"]
        if draws is None:
            draws = draw_diffusion(mdm, diffusion, x0.shape, state.generator, x0.device)
        mdm.train()
        params = state.params
        cond = mdm.encode_cond(batch["audio"], batch["word"], x0[:, : cfg.pre_frames], prompt=batch.get("prompt"),
                               style=batch.get("style"), draws=draws.masks)

        def model_fn(x_t, t_orig):
            return mdm.denoise(x_t, t_orig, cond, draws=draws.masks)

        loss = training_loss(diffusion, model_fn, x0, draws.t, draws.noise).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        updates, state.opt_state = optimizer.update(dict(zip(params, grads)), state.opt_state, params)
        apply_updates(params, updates)
        state.step += 1
        return state, {"predict_x0_loss": loss.detach()}

    return step


def make_latent_encoder_fn(modules: dict, stats, *, latent_scale: float = 5.0):
    """Pose features -> the diffusion latent: per-part rot6d normalization,
    each part's frozen RVQ-VAE ``map2latent``, concat, ÷ ``latent_scale``.

    ``modules`` maps part name -> RVQVAE. JAX's form takes the param trees
    at call time so that jit does not bake them in as constants; a PyTorch
    module holds its weights, so ``encode(upper, hands, lower, trans_v)``
    takes the features alone."""

    @torch.no_grad()
    def encode(upper, hands, lower, trans_v):
        feats = {"upper": stats.normalize_part(upper, "upper"), "hands": stats.normalize_part(hands, "hands"),
                 "lower": torch.cat([stats.normalize_part(lower, "lower"), stats.normalize_trans(trans_v)], -1)}
        return torch.cat([modules[name].map2latent(feats[name]) for name in J.LATENT_SLICES], -1) / latent_scale

    return encode


def make_latent_encoder(rvq_modules: dict, stats, *, latent_scale: float = 5.0):
    """:func:`make_latent_encoder_fn` over an RVQ stack (part ->
    (RVQVAE, RVQState)). Input: per-part rot6d features (B, T, dim),
    unnormalized, and trans_v (B, T, 3). Output: (B, T/4, 1536)."""
    return make_latent_encoder_fn({n: m for n, (m, _q) in rvq_modules.items()}, stats, latent_scale=latent_scale)


def calibrate_latent_scale(rvq_modules: dict, stats, parts: Dict[str, torch.Tensor], trans_v: torch.Tensor, *,
                           target_std: float = 1.0) -> float:
    """The divisor that brings the concatenated RVQ latents of a sample
    batch to ``target_std`` (the population std): freshly trained encoders
    have their own scale, which the diffusion x0 must not carry."""
    lat = make_latent_encoder(rvq_modules, stats, latent_scale=1.0)(parts["upper"], parts["hands"], parts["lower"],
                                                                      trans_v)
    return float(lat.std(correction=0)) / target_std
