"""Residual vector quantization, eval half (PyTorch).

Counterpart of ``RVQConfig``, ``code_distances``, ``rvq_encode``,
``rvq_dequantize`` and ``rvq_quantize_eval`` in
``syntalker_tpu/ops/quantize.py``. The state is the codebooks alone: the
EMA sums and counts, lazy init, quantizer dropout and Gumbel sampling are
training-time and wait for the training slice, so ``mu``,
``quantize_dropout_*`` and ``gumbel_temperature`` are accepted and unused
here. With ``shared_codebook`` the state holds one codebook (1, K, D) that
every layer reads. Layout ``(B, T, D)``.
"""

from __future__ import annotations

import dataclasses

import torch

from syntalker_tpu_torch.device import full_f32


@dataclasses.dataclass(frozen=True)
class RVQConfig:
    num_quantizers: int = 6
    nb_code: int = 512
    code_dim: int = 512
    mu: float = 0.99  # EMA decay; train-time
    quantize_dropout_prob: float = 0.2  # train-time
    quantize_dropout_cutoff: int = 0  # train-time
    gumbel_temperature: float = 0.5  # train-time
    shared_codebook: bool = False  # one codebook for every layer


@dataclasses.dataclass
class RVQState:
    codebook: torch.Tensor  # (Q, K, D) float32; (1, K, D) with shared_codebook


def layer_codebooks(state: RVQState, cfg: RVQConfig) -> torch.Tensor:
    """The (Q, K, D) codebooks layer by layer: a shared codebook is
    repeated for every layer."""
    if cfg.shared_codebook:
        return state.codebook[:1].expand(cfg.num_quantizers, -1, -1)
    return state.codebook[: cfg.num_quantizers]


def code_distances(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (N, K) = ‖x‖² − 2·x·Cᵀ + ‖c‖², in full f32."""
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (codebook * codebook).sum(-1)
    with full_f32():
        cross = x @ codebook.T
    return x2 - 2.0 * cross + c2[None, :]


def rvq_encode(x: torch.Tensor, state: RVQState, cfg: RVQConfig) -> torch.Tensor:
    """(B, T, D) -> token indices (B, T, Q): residual argmin per layer
    (torch.argmin returns the first, i.e. lowest, index on ties)."""
    b, t, d = x.shape
    residual = x.reshape(b * t, d)
    codebooks = layer_codebooks(state, cfg)
    out = []
    for q in range(cfg.num_quantizers):
        codebook = codebooks[q]
        idx = code_distances(residual, codebook).argmin(-1)
        residual = residual - codebook[idx]
        out.append(idx)
    return torch.stack(out, -1).reshape(b, t, cfg.num_quantizers)


def rvq_dequantize(indices: torch.Tensor, state: RVQState, cfg: RVQConfig) -> torch.Tensor:
    """Indices (B, T, Q) -> summed codes (B, T, D); -1 indices contribute 0."""
    out = torch.zeros(indices.shape[:2] + (cfg.code_dim,), device=indices.device)
    codebooks = layer_codebooks(state, cfg)
    for q in range(indices.shape[-1]):
        idx = indices[..., q]
        code = codebooks[q][idx.clamp_min(0)]
        out = out + torch.where((idx >= 0)[..., None], code, 0.0)
    return out


def rvq_quantize_eval(x: torch.Tensor, state: RVQState, cfg: RVQConfig):
    """(B, T, D) -> (quantized (B, T, D), indices (B, T, Q))."""
    idx = rvq_encode(x, state, cfg)
    return rvq_dequantize(idx, state, cfg), idx
