"""Train steps of the auxiliary autoencoders.

Counterpart of ``syntalker_tpu/train/ae_trainer.py``: the FGD featurizer
(``VAESKConv``, MSE reconstruction of 330-d rot6d windows) and the face
VQ-VAE (``VQVAEConvZero``, reconstruction plus the β-commit embedding
loss). Neither step draws anything: the models have no dropout, and the
face quantizer is a plain argmin. A step updates ``state.params`` in place
through the port's :mod:`~syntalker_tpu_torch.train.optim` (optax's rules)
and returns detached 0-d metrics.
"""

from __future__ import annotations

import torch

from syntalker_tpu_torch.train.optim import apply_updates
from syntalker_tpu_torch.train.state import TrainState


def _apply(state: TrainState, optimizer, loss: torch.Tensor) -> None:
    params = state.params
    grads = torch.autograd.grad(loss, list(params.values()))
    updates, state.opt_state = optimizer.update(dict(zip(params, grads)), state.opt_state, params)
    apply_updates(params, updates)
    state.step += 1


def make_eval_vae_train_step(module, optimizer):
    """``(state, batch (B, T, 330)) -> (state, metrics)``: MSE reconstruction."""

    def step(state: TrainState, batch: torch.Tensor):
        loss = ((module(batch)["rec_pose"] - batch) ** 2).mean()
        _apply(state, optimizer, loss)
        return state, {"recon": loss.detach(), "loss": loss.detach()}

    return step


def make_face_vqvae_train_step(module, optimizer, embedding_weight: float = 1.0):
    """``(state, batch (B, T, 106)) -> (state, metrics)``: reconstruction
    plus ``embedding_weight`` times the VQ loss."""

    def step(state: TrainState, batch: torch.Tensor):
        out = module(batch)
        recon = ((out["rec_pose"] - batch) ** 2).mean()
        loss = recon + embedding_weight * out["embedding_loss"]
        _apply(state, optimizer, loss)
        return state, {"recon": recon.detach(), "embedding": out["embedding_loss"].detach(),
                       "perplexity": out["perplexity"].detach(), "loss": loss.detach()}

    return step
