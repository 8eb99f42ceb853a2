"""Body-part RVQ-VAE (PyTorch).

Counterpart of ``ResConv1DBlock``, ``Resnet1D``, ``ConvEncoder``,
``ConvDecoder`` and ``RVQVAE`` in ``syntalker_tpu/models/rvqvae.py``: the
train forward (``forward(x, state, train=True, draws=...)``: encoder,
straight-through residual quantizer with its EMA state update, decoder,
dropout after each residual block's ``conv_proj``) and the eval entry
points ``map2latent`` (pose features -> continuous latent), ``encode``
(-> residual code indices), ``decode_indices`` (indices -> pose features)
and ``latent2origin`` (latent -> snapped -> pose features). The eval snap
and encode go through the hand-written RVQ kernel
(:func:`syntalker_tpu_torch.ops.quantize_cuda.rvq_encode_fused`), which the
JAX package leaves unwired; the train forward assigns codes by the Gumbel
argmax of :func:`~syntalker_tpu_torch.ops.quantize.rvq_forward`, as JAX's
does. Public layout ``(B, T, C)``; the convolutions run NCW inside, in full
f32. The forward's draws (dropout keep masks, the quantizer's draws) come
as one :class:`RVQVAEDraws` (:func:`draw_rvqvae`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from syntalker_tpu_torch.device import full_f32, resolve_device
from syntalker_tpu_torch.ops.quantize import (
    RVQConfig,
    RVQDraws,
    RVQOutput,
    RVQState,
    draw_rvq,
    rvq_dequantize,
    rvq_forward,
)
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
    dropout_rate: float = 0.2  # after each residual block, in training
    quantizer: RVQConfig = dataclasses.field(default_factory=RVQConfig)

    @property
    def temporal_scale(self) -> int:
        return self.stride_t**self.down_t  # 4 with the shipped config


@dataclasses.dataclass
class RVQVAEDraws:
    """The draws of one train forward: the keep masks of the residual
    blocks' dropout in call order (encoder, then decoder; each (B, width, L)
    bool, or None when ``dropout_rate`` is 0) and the quantizer's."""

    dropout: List[Optional[torch.Tensor]]
    quantizer: RVQDraws

    def to(self, device) -> "RVQVAEDraws":
        return RVQVAEDraws([None if m is None else m.to(device) for m in self.dropout], self.quantizer.to(device))


def dropout(h: torch.Tensor, rate: float, keep_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """flax ``nn.Dropout``: kept elements scaled by 1/(1 - rate), the others
    zero; no mask is the identity."""
    if keep_mask is None or rate <= 0.0:
        return h
    return torch.where(keep_mask, h / (1.0 - rate), 0.0)


class ResConv1DBlock(nn.Module):
    """relu → dilated k=3 conv → relu → k=1 conv → dropout, plus the input."""

    def __init__(self, channels: int, dilation: int, dropout_rate: float = 0.2):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv_dilated = nn.Conv1d(channels, channels, 3, dilation=dilation, padding=dilation)
        self.conv_proj = nn.Conv1d(channels, channels, 1)

    def forward(self, x, keep_mask: Optional[torch.Tensor] = None):
        h = self.conv_proj(F.relu(self.conv_dilated(F.relu(x))))
        return x + dropout(h, self.dropout_rate, keep_mask)


class Resnet1D(nn.Module):
    """Stack of dilated residual blocks; encoder and decoder both reverse the
    dilations ([9, 3, 1] at depth 3)."""

    def __init__(self, channels: int, depth: int, growth: int, reverse_dilation: bool = True,
                 dropout_rate: float = 0.2):
        super().__init__()
        dilations = [growth**d for d in range(depth)]
        if reverse_dilation:
            dilations = dilations[::-1]
        self.blocks = nn.ModuleList(ResConv1DBlock(channels, d, dropout_rate) for d in dilations)

    def forward(self, x, masks: Optional[Iterator] = None):
        """``masks`` yields each block's dropout keep mask (training)."""
        for blk in self.blocks:
            x = blk(x, None if masks is None else next(masks))
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
            Resnet1D(c.width, c.depth, c.dilation_growth_rate, dropout_rate=c.dropout_rate) for _ in range(c.down_t)
        )
        self.head = nn.Conv1d(c.width, c.output_emb_width, 3, padding=1)

    def forward(self, x: torch.Tensor, masks: Optional[Iterator] = None) -> torch.Tensor:
        h = F.relu(self.stem(x.transpose(1, 2)))
        for down, res in zip(self.down, self.res):
            h = res(down(h), masks)
        return self.head(h).transpose(1, 2)


class ConvDecoder(nn.Module):
    """Latent -> pose features with nearest ×2 upsampling; "SAME" k=3
    convolutions are padding 1."""

    def __init__(self, cfg: RVQVAEConfig):
        super().__init__()
        c = self.cfg = cfg
        self.stem = nn.Conv1d(c.output_emb_width, c.width, 3, padding=1)
        self.res = nn.ModuleList(
            Resnet1D(c.width, c.depth, c.dilation_growth_rate, dropout_rate=c.dropout_rate) for _ in range(c.down_t)
        )
        self.up = nn.ModuleList(nn.Conv1d(c.width, c.width, 3, padding=1) for _ in range(c.down_t))
        self.mid = nn.Conv1d(c.width, c.width, 3, padding=1)
        self.head = nn.Conv1d(c.width, c.input_dim, 3, padding=1)

    def forward(self, z: torch.Tensor, masks: Optional[Iterator] = None) -> torch.Tensor:
        h = F.relu(self.stem(z.transpose(1, 2)))
        for res, up in zip(self.res, self.up):
            h = up(res(h, masks).repeat_interleave(self.cfg.stride_t, dim=-1))
        h = self.head(F.relu(self.mid(h)))
        return h.transpose(1, 2)


class RVQVAE(nn.Module):
    def __init__(self, cfg: RVQVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConvEncoder(cfg)
        self.decoder = ConvDecoder(cfg)

    def forward(self, x: torch.Tensor, state: RVQState, *, train: bool = False,
                draws: Optional[RVQVAEDraws] = None, force_dropout_index: int = -1):
        """Pose features (B, T, input_dim) -> (reconstruction, RVQOutput):
        encoder, straight-through residual quantizer, decoder. With
        ``train`` the blocks' dropout and the quantizer's Gumbel
        assignment, lazy init and EMA update take ``draws``
        (:func:`draw_rvqvae`); the output's ``state`` is the next
        quantizer state."""
        if train and draws is None:
            raise ValueError("a train forward needs its draws: see draw_rvqvae")
        masks = iter(draws.dropout) if train else None
        with full_f32():
            z = self.encoder(x, masks)
            out: RVQOutput = rvq_forward(z, state, self.cfg.quantizer, train=train,
                                         draws=draws.quantizer if train else None,
                                         force_dropout_index=force_dropout_index)
            rec = self.decoder(out.quantized, masks)
        return rec, out

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


def dropout_mask_shapes(cfg: RVQVAEConfig, batch: int, frames: int) -> list:
    """(B, width, L) of each residual block's dropout, in call order."""
    enc = [frames // cfg.stride_t ** (i + 1) for i in range(cfg.down_t)]
    lat = frames // cfg.temporal_scale
    dec = [lat * cfg.stride_t**i for i in range(cfg.down_t)]
    return [(batch, cfg.width, n) for n in enc + dec for _ in range(cfg.depth)]


def draw_rvqvae(cfg: RVQVAEConfig, x_shape, generator: torch.Generator, device=None) -> RVQVAEDraws:
    """The draws of one train forward on a (B, T, input_dim) batch from
    ``generator``: the dropout keep masks, then the quantizer's."""
    b, t = x_shape[0], x_shape[1]
    keep = 1.0 - cfg.dropout_rate
    masks = [torch.rand(s, generator=generator, device=device) < keep if cfg.dropout_rate > 0 else None
             for s in dropout_mask_shapes(cfg, b, t)]
    return RVQVAEDraws(masks, draw_rvq(cfg.quantizer, b * (t // cfg.temporal_scale), generator, device))


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
