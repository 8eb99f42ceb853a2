"""Body-part RVQ-VAE at inference (PyTorch).

Counterpart of ``ResConv1DBlock``, ``Resnet1D``, ``ConvEncoder``,
``ConvDecoder`` and the eval entry points of ``RVQVAE`` in
``syntalker_tpu/models/rvqvae.py``: ``map2latent`` (pose features ->
continuous latent), ``encode`` (-> residual code indices),
``decode_indices`` (indices -> pose features) and ``latent2origin`` (latent
-> snapped -> pose features). The snap and the encode go through the
hand-written RVQ kernel
(:func:`syntalker_tpu_torch.ops.quantize_cuda.rvq_encode_fused`), which the
JAX package leaves unwired. Public layout ``(B, T, C)``; the convolutions
run NCW inside, in full f32. The train-time forward (straight-through
quantizer, dropout) waits for the training slice.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from syntalker_tpu_torch.device import full_f32, resolve_device
from syntalker_tpu_torch.ops.quantize import RVQConfig, RVQState, rvq_dequantize
from syntalker_tpu_torch.ops.quantize_cuda import rvq_quantize_eval_fused


@dataclasses.dataclass(frozen=True)
class RVQVAEConfig:
    input_dim: int  # 78 upper / 180 hands / 57 lower+trans
    width: int = 512
    output_emb_width: int = 512
    down_t: int = 2
    stride_t: int = 2
    depth: int = 3
    dilation_growth_rate: int = 3
    dropout_rate: float = 0.2  # train-time
    quantizer: RVQConfig = dataclasses.field(default_factory=RVQConfig)


class ResConv1DBlock(nn.Module):
    """relu → dilated k=3 conv → relu → k=1 conv, plus the input."""

    def __init__(self, channels: int, dilation: int):
        super().__init__()
        self.conv_dilated = nn.Conv1d(channels, channels, 3, dilation=dilation, padding=dilation)
        self.conv_proj = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        return x + self.conv_proj(F.relu(self.conv_dilated(F.relu(x))))


class Resnet1D(nn.Module):
    """Stack of dilated residual blocks; encoder and decoder both reverse the
    dilations ([9, 3, 1] at depth 3)."""

    def __init__(self, channels: int, depth: int, growth: int, reverse_dilation: bool = True):
        super().__init__()
        dilations = [growth**d for d in range(depth)]
        if reverse_dilation:
            dilations = dilations[::-1]
        self.blocks = nn.ModuleList(ResConv1DBlock(channels, d) for d in dilations)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class ConvEncoder(nn.Module):
    """Pose features -> latent, T -> T / stride_t**down_t: a "SAME" k=3
    stem, then per level a strided conv (k = 2·stride, padding stride/2)
    and a residual stack, then a k=3 head."""

    def __init__(self, cfg: RVQVAEConfig):
        super().__init__()
        c = cfg
        self.stem = nn.Conv1d(c.input_dim, c.width, 3, padding=1)
        self.down = nn.ModuleList(
            nn.Conv1d(c.width, c.width, 2 * c.stride_t, stride=c.stride_t, padding=c.stride_t // 2)
            for _ in range(c.down_t)
        )
        self.res = nn.ModuleList(
            Resnet1D(c.width, c.depth, c.dilation_growth_rate) for _ in range(c.down_t)
        )
        self.head = nn.Conv1d(c.width, c.output_emb_width, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.stem(x.transpose(1, 2)))
        for down, res in zip(self.down, self.res):
            h = res(down(h))
        return self.head(h).transpose(1, 2)


class ConvDecoder(nn.Module):
    """Latent -> pose features with nearest ×2 upsampling; "SAME" k=3
    convolutions are padding 1."""

    def __init__(self, cfg: RVQVAEConfig):
        super().__init__()
        c = self.cfg = cfg
        self.stem = nn.Conv1d(c.output_emb_width, c.width, 3, padding=1)
        self.res = nn.ModuleList(
            Resnet1D(c.width, c.depth, c.dilation_growth_rate) for _ in range(c.down_t)
        )
        self.up = nn.ModuleList(nn.Conv1d(c.width, c.width, 3, padding=1) for _ in range(c.down_t))
        self.mid = nn.Conv1d(c.width, c.width, 3, padding=1)
        self.head = nn.Conv1d(c.width, c.input_dim, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.stem(z.transpose(1, 2)))
        for res, up in zip(self.res, self.up):
            h = up(res(h).repeat_interleave(self.cfg.stride_t, dim=-1))
        h = self.head(F.relu(self.mid(h)))
        return h.transpose(1, 2)


class RVQVAE(nn.Module):
    def __init__(self, cfg: RVQVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConvEncoder(cfg)
        self.decoder = ConvDecoder(cfg)

    def map2latent(self, x: torch.Tensor) -> torch.Tensor:
        """Pose features (B, T, input_dim) -> continuous latent (B, T/4, 512)."""
        with full_f32():
            return self.encoder(x)

    def encode(self, x: torch.Tensor, state: RVQState) -> torch.Tensor:
        """Pose features (B, T, input_dim) -> code indices (B, T/4, Q) int32."""
        _, idx = rvq_quantize_eval_fused(self.map2latent(x), state, self.cfg.quantizer)
        return idx

    def decode_indices(self, indices: torch.Tensor, state: RVQState) -> torch.Tensor:
        """Code indices (B, T, Q) -> summed codes -> decoded (B, 4T, input_dim)."""
        z = rvq_dequantize(indices.long(), state, self.cfg.quantizer)
        with full_f32():
            return self.decoder(z)

    def latent2origin(self, z: torch.Tensor, state: RVQState) -> torch.Tensor:
        """Continuous latent (B, T, 512) -> snapped -> decoded (B, 4T, input_dim)."""
        zq, _ = rvq_quantize_eval_fused(z, state, self.cfg.quantizer)
        with full_f32():
            return self.decoder(zq)


def build_rvqvae(cfg: RVQVAEConfig, *, seed: int, device=None):
    """(module, state): default-init encoder and decoder and ``randn``
    codebooks drawn from ``seed``."""
    device = resolve_device(device)
    q = cfg.quantizer
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = RVQVAE(cfg)
        codebook = torch.randn(1 if q.shared_codebook else q.num_quantizers, q.nb_code, q.code_dim)
    module = module.to(device).eval().requires_grad_(False)
    return module, RVQState(codebook=codebook.to(device))
