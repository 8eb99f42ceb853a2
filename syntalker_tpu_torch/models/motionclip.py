"""MotionCLIP at inference: body motion <-> a CLIP-aligned 512-d space.

Counterpart of ``MotionCLIPConfig``, ``MotionCLIP`` and
``MotionCLIPDecoder`` in ``syntalker_tpu/models/motionclip.py``. The
encoder is a TMR :class:`~syntalker_tpu_torch.models.tmr.ActorAgnosticEncoder`
over 22-joint rot6d frames plus a projection to ``clip_dim``; its output is
the style input of a ``use_motionclip`` MDM. The decoder maps a CLIP-space
latent back to ``num_frames`` rot6d frames: learned time queries attend to
the single latent token through pre-LN blocks (flax LayerNorm eps 1e-6,
tanh GELU). Parameter names follow the flax tree. Training:
:func:`clip_alignment_loss` and :func:`make_motionclip_train_step`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from syntalker_tpu_torch.models.tmr import LN_EPS, ActorAgnosticEncoder, Attention, TMRConfig
from syntalker_tpu_torch.train.optim import apply_updates


@dataclasses.dataclass(frozen=True)
class MotionCLIPConfig:
    clip_dim: int = 512
    latent_dim: int = 256
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    input_feats: int = 22 * 6  # body joints, rot6d


class MotionCLIP(nn.Module):
    """(B, T, input_feats) rot6d body motion (+ (B, T) mask) -> (B, clip_dim):
    the encoder's mu, projected."""

    def __init__(self, cfg: MotionCLIPConfig = MotionCLIPConfig()):
        super().__init__()
        self.cfg = cfg
        tcfg = TMRConfig(latent_dim=cfg.latent_dim, ff_size=cfg.ff_size, num_layers=cfg.num_layers,
                         num_heads=cfg.num_heads)
        self.encoder = ActorAgnosticEncoder(tcfg, cfg.input_feats)
        self.proj = nn.Linear(cfg.latent_dim, cfg.clip_dim)

    def forward(self, motion: torch.Tensor, mask=None) -> torch.Tensor:
        mu, _ = self.encoder(motion, mask)
        return self.proj(mu)


class MotionCLIPDecoder(nn.Module):
    """(B, clip_dim) -> (B, num_frames, input_feats): ``num_layers // 2``
    cross-attention blocks from the time queries to the latent token."""

    def __init__(self, cfg: MotionCLIPConfig = MotionCLIPConfig(), num_frames: int = 60):
        super().__init__()
        c = self.cfg = cfg
        self.num_frames = num_frames
        self.time_queries = nn.Parameter(torch.zeros(num_frames, c.latent_dim))
        self.latent_in = nn.Linear(c.clip_dim, c.latent_dim)
        n = c.num_layers // 2
        self.ln_q = nn.ModuleList(nn.LayerNorm(c.latent_dim, eps=LN_EPS) for _ in range(n))
        self.cross = nn.ModuleList(Attention(c.latent_dim, c.num_heads) for _ in range(n))
        self.ln_f = nn.ModuleList(nn.LayerNorm(c.latent_dim, eps=LN_EPS) for _ in range(n))
        self.fc1 = nn.ModuleList(nn.Linear(c.latent_dim, c.ff_size) for _ in range(n))
        self.fc2 = nn.ModuleList(nn.Linear(c.ff_size, c.latent_dim) for _ in range(n))
        self.out = nn.Linear(c.latent_dim, c.input_feats)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.time_queries[None].expand(z.shape[0], -1, -1)
        zt = self.latent_in(z)[:, None, :]  # (B, 1, D)
        for ln_q, cross, ln_f, fc1, fc2 in zip(self.ln_q, self.cross, self.ln_f, self.fc1, self.fc2):
            h = h + cross(ln_q(h), zt)
            h = h + fc2(F.gelu(fc1(ln_f(h)), approximate="tanh"))
        return self.out(h)


def clip_alignment_loss(motion_emb: torch.Tensor, clip_emb: torch.Tensor) -> torch.Tensor:
    """1 − cosine similarity against frozen CLIP features, batch mean."""
    m = motion_emb / torch.linalg.vector_norm(motion_emb, dim=-1, keepdim=True)
    c = clip_emb / torch.linalg.vector_norm(clip_emb, dim=-1, keepdim=True)
    return (1.0 - (m * c).sum(-1)).mean()


def make_motionclip_train_step(encoder: MotionCLIP, decoder: MotionCLIPDecoder, optimizer, lambdas=None):
    """Joint encode/decode ``(params, opt_state, batch) -> (params,
    opt_state, metrics)`` step: rot6d reconstruction + velocity + cosine
    alignment to frozen CLIP text features, weighted by ``lambdas``.
    ``params`` is ``tmr.train_params({"enc": encoder, "dec": decoder})``
    (updated in place); batch: ``motion`` (B, num_frames, input_feats) and
    ``clip_emb`` (B, clip_dim)."""
    lambdas = lambdas or {"rc": 1.0, "vel": 1.0, "clip": 1.0}

    def step(params, opt_state, batch):
        motion = batch["motion"]
        emb = encoder(motion)
        rec = decoder(emb)
        rc = ((rec - motion) ** 2).mean()
        vel = ((torch.diff(rec, dim=1) - torch.diff(motion, dim=1)) ** 2).mean()
        clip_l = clip_alignment_loss(emb, batch["clip_emb"])
        loss = lambdas["rc"] * rc + lambdas["vel"] * vel + lambdas["clip"] * clip_l
        grads = torch.autograd.grad(loss, list(params.values()))
        updates, opt_state = optimizer.update(dict(zip(params, grads)), opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, {"rc": rc.detach(), "vel": vel.detach(), "clip": clip_l.detach(),
                                   "loss": loss.detach()}

    return step
