"""Evaluation and auxiliary autoencoders: the FGD featurizer and the face VQ-VAE.

Counterpart of ``syntalker_tpu/models/eval_vae.py``:

- :class:`VAESKConv`, the skeleton-conv VAE whose ``map2latent`` embedding
  defines FGD (``LocalEncoder`` over the SMPL-X edge graph, then
  ``VQDecoderV3``; 330-dim rot6d, 4 layers, growth (1, 1, 2, 1), latent
  240);
- :class:`VQVAEConvZero`, the stride-1 face VQ-VAE (jaw rot6d +
  expressions, 106-dim, 2 layers, 256 codes);
- their conv pieces (``ResBlock``, ``VQEncoderV3/V5``, ``VQDecoderV3/V5``)
  and the β-commit quantizer :func:`legacy_vq`.

Public layout (B, T, C); the convolutions run NCW inside. ``map2latent``,
``decode`` and the face model's index paths run in full f32
(:func:`~syntalker_tpu_torch.device.full_f32`): cuDNN's TF32 would move
FGD. The decoders' input width is a constructor argument where flax reads
it from the input (``proj`` exists only when it differs from
``channels``). Parameter names follow flax's, so ``bridge.FlaxLayout``
maps a flax tree onto them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from syntalker_tpu_torch.device import full_f32, resolve_device
from syntalker_tpu_torch.models.skeleton import (SkeletonResidual, build_edge_topology, find_neighbor,
                                                 pooling_matrix, skeleton_pooling_plan)
from syntalker_tpu_torch.ops.smplx import PARENTS


@dataclasses.dataclass(frozen=True)
class EvalVAEConfig:
    input_dim: int = 330  # vae_test_dim
    latent_dim: int = 240  # vae_length
    num_layers: int = 4  # vae_layer
    growth: Tuple[int, ...] = (1, 1, 2, 1)  # vae_grow
    channel_base: int = 6
    kernel_size: int = 4
    skeleton_dist: int = 2
    window: int = 32  # vae_test_len


def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.transpose(1, 2)).transpose(1, 2)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class ResBlock(nn.Module):
    """Conv-LeakyReLU-Conv residual, k=3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv1d(channels, channels, 3, padding=1)
        self.conv2 = nn.Conv1d(channels, channels, 3, padding=1)

    def forward(self, x):
        return x + _conv(self.conv2, _leaky(_conv(self.conv1, x)))


class VQEncoderV3(nn.Module):
    """Strided conv encoder, T -> T / 2**layers (k=4, stride 2, padding 1)."""

    def __init__(self, in_dim: int, channels: int, num_layers: int):
        super().__init__()
        self.down = nn.ModuleList(nn.Conv1d(in_dim if i == 0 else channels, channels, 4, stride=2, padding=1)
                                  for i in range(num_layers))
        self.res = nn.ModuleList(ResBlock(channels) for _ in range(num_layers))

    def forward(self, x):
        for down, res in zip(self.down, self.res):
            x = res(_leaky(_conv(down, x)))
        return x


class VQEncoderV5(nn.Module):
    """Stride-1 encoder (the face VQ-VAE's)."""

    def __init__(self, in_dim: int, channels: int, num_layers: int):
        super().__init__()
        self.conv = nn.ModuleList(nn.Conv1d(in_dim if i == 0 else channels, channels, 3, padding=1)
                                  for i in range(num_layers))
        self.res = nn.ModuleList(ResBlock(channels) for _ in range(num_layers))

    def forward(self, x):
        for conv, res in zip(self.conv, self.res):
            x = res(_leaky(_conv(conv, x)))
        return x


class _Decoder(nn.Module):
    """``proj`` (when ``in_dim`` != ``channels``), two ResBlocks, one k=3
    conv + LeakyReLU a layer (the last to ``out_dim``), a k=3 head."""

    stage: str
    upsample: bool

    def __init__(self, out_dim: int, channels: int, num_layers: int, in_dim: Optional[int] = None):
        super().__init__()
        in_dim = channels if in_dim is None else in_dim
        if in_dim != channels:
            self.proj = nn.Conv1d(in_dim, channels, 3, padding=1)
        self.res = nn.ModuleList(ResBlock(channels) for _ in range(2))
        stages = nn.ModuleList(nn.Conv1d(channels, out_dim if i == num_layers - 1 else channels, 3, padding=1)
                               for i in range(num_layers))
        setattr(self, self.stage, stages)
        self.head = nn.Conv1d(out_dim, out_dim, 3, padding=1)

    def forward(self, z):
        if hasattr(self, "proj"):
            z = _conv(self.proj, z)
        for res in self.res:
            z = res(z)
        for conv in getattr(self, self.stage):
            if self.upsample:
                z = torch.repeat_interleave(z, 2, dim=-2)  # nearest x2
            z = _leaky(_conv(conv, z))
        return _conv(self.head, z)


class VQDecoderV3(_Decoder):
    """Upsampling decoder, T -> T * 2**layers (nearest x2 before each ``up_i``)."""

    stage, upsample = "up", True


class VQDecoderV5(_Decoder):
    """Stride-1 decoder (``conv_i``)."""

    stage, upsample = "conv", False


class LocalEncoder(nn.Module):
    """Skeleton-conv encoder over the SMPL-X edge graph: T -> T / 2**layers,
    330 -> 240 channels; ``layer_i`` pools the edge chains pairwise, the
    last collapses each chain."""

    def __init__(self, cfg: EvalVAEConfig):
        super().__init__()
        c = cfg
        channel_base = [c.channel_base]
        for g in c.growth:
            channel_base.append(channel_base[-1] * g)
        topo = build_edge_topology(PARENTS.tolist())
        layers = []
        for i in range(c.num_layers):
            plan = skeleton_pooling_plan(topo, last_pool=i == c.num_layers - 1)
            layers.append(SkeletonResidual(find_neighbor(topo, c.skeleton_dist), channel_base[i], channel_base[i + 1],
                                           c.kernel_size, pooling_matrix(plan, channel_base[i + 1], len(topo))))
            topo = plan.new_edges
        self.layer = nn.ModuleList(layers)
        self.out_dim = len(plan.pooling_list) * channel_base[-1]  # one edge per pooled group

    def forward(self, x):
        for layer in self.layer:
            x = layer(x)
        return x


def legacy_vq(z: torch.Tensor, codebook: torch.Tensor, beta: float = 0.25):
    """Plain argmin VQ with the β-commit loss -> (loss, straight-through z_q,
    indices, perplexity). An exact tie goes to the lower index."""
    flat = z.reshape(-1, z.shape[-1])
    dist = (flat**2).sum(1, keepdim=True) + (codebook**2).sum(1) - 2.0 * flat @ codebook.T
    idx = dist.argmin(1)
    z_q = codebook[idx].reshape(z.shape)
    loss = ((z_q - z.detach()) ** 2).mean() + beta * ((z_q.detach() - z) ** 2).mean()
    z_st = z + (z_q - z).detach()
    e_mean = F.one_hot(idx, codebook.shape[0]).float().mean(0)
    perplexity = torch.exp(-(e_mean * torch.log(e_mean + 1e-10)).sum())
    return loss, z_st, idx.reshape(z.shape[:-1]), perplexity


class VAESKConv(nn.Module):
    """The FGD eval model: skeleton encoder + conv decoder. ``map2latent``
    is the FGD embedding."""

    def __init__(self, cfg: EvalVAEConfig = EvalVAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = LocalEncoder(cfg)
        self.decoder = VQDecoderV3(cfg.input_dim, cfg.latent_dim, cfg.num_layers, in_dim=self.encoder.out_dim)

    def forward(self, x):
        z = self.encoder(x)
        return {"poses_feat": z, "rec_pose": self.decoder(z)}

    def map2latent(self, x):
        with full_f32():
            return self.encoder(x)

    def decode(self, z):
        with full_f32():
            return self.decoder(z)


class VQVAEConvZero(nn.Module):
    """The face VQ-VAE: stride-1 convs and a 256-code argmin VQ over jaw
    rot6d + expressions."""

    def __init__(self, input_dim: int = 106, latent_dim: int = 256, num_layers: int = 2, codebook_size: int = 256,
                 beta: float = 0.25):
        super().__init__()
        self.beta = beta
        self.encoder = VQEncoderV5(input_dim, latent_dim, num_layers)
        self.decoder = VQDecoderV5(input_dim, latent_dim, num_layers)
        # flax's uniform(scale=2 / codebook_size): [0, scale)
        self.codebook = nn.Parameter(torch.rand(codebook_size, latent_dim) * (2.0 / codebook_size))

    def forward(self, x):
        z = self.encoder(x)
        loss, z_q, _idx, perp = legacy_vq(z, self.codebook, self.beta)
        return {"rec_pose": self.decoder(z_q), "embedding_loss": loss, "perplexity": perp, "poses_feat": z_q}

    def map2index(self, x):
        with full_f32():
            return legacy_vq(self.encoder(x), self.codebook, self.beta)[2]

    def map2latent(self, x):
        return self.codebook[self.map2index(x)]

    def decode_indices(self, idx):
        with full_f32():
            return self.decoder(self.codebook[idx])


def build_eval_vae(cfg: EvalVAEConfig = EvalVAEConfig(), *, seed: int = 1, device=None) -> VAESKConv:
    """A ``VAESKConv`` initialized from ``seed``, in eval mode on ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = VAESKConv(cfg)
    return model.to(resolve_device(device)).eval().requires_grad_(False)


def build_face_vqvae(*, seed: int = 0, device=None) -> VQVAEConvZero:
    """A ``VQVAEConvZero`` initialized from ``seed``, in eval mode on ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = VQVAEConvZero()
    return model.to(resolve_device(device)).eval().requires_grad_(False)
