"""K3: the fused residual-VQ snap (hand-written CUDA kernels + plain version).

Counterpart of ``rvq_encode_fused`` / ``rvq_quantize_eval_fused`` in
``syntalker_tpu/ops/quantize_pallas.py``; the kernels are
``csrc/rvq_encode.cu`` (its header says what bounds them and how they are
laid out). The wrapper takes the plain version for CPU tensors and launches
the kernels for CUDA tensors: one C call launches all
:func:`rvq_kernel_launches` kernels of the call, and ``launches`` counts the
calls. The TPU kernel's ``tile_n`` has no counterpart: every distance
launch takes 32 rows x 32 codes a block, and :func:`rvq_plan` gives its
grid.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from syntalker_tpu_torch.device import full_f32
from syntalker_tpu_torch.ops import _build
from syntalker_tpu_torch.ops.quantize import RVQConfig, RVQState, layer_codebooks

launches = {"rvq_encode": 0}

TILE = (32, 32)  # rows and codes a distance block takes, as BM and BN in csrc/rvq_encode.cu
SLICE = 32  # the depth of one D slice in the kernel's ring
SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_ROW_TILES = 65535  # the grid's y limit


def rvq_encode_plain(x: torch.Tensor, codebooks: torch.Tensor):
    """(N, D) rows, (Q, K, D) codebooks -> (quantized (N, D), indices (N, Q)
    int32): the reference math in PyTorch, full f32."""
    residual = x.float()
    out = torch.zeros_like(residual)
    idx = []
    with full_f32():
        for cb in codebooks.float():
            r2 = (residual * residual).sum(-1, keepdim=True)
            dist = r2 - 2.0 * (residual @ cb.T) + (cb * cb).sum(-1)[None, :]
            i = dist.argmin(-1)
            code = cb[i]
            out = out + code
            residual = residual - code
            idx.append(i)
    return out, torch.stack(idx, -1).to(torch.int32)


@dataclass(frozen=True)
class RVQPlan:
    """The distance launch of one layer: a tile of rows x codes a block, and
    its grid of (code tiles, row tiles)."""

    rows: int
    codes: int
    grid: tuple[int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def rvq_plan(n: int, q: int, k: int, d: int) -> RVQPlan:
    """The distance launch for N rows against Q codebooks of K codes of width
    D. Raises ValueError on a shape the kernels do not take."""
    bm, bn = TILE
    if n < 1 or q < 1 or d < SLICE or d % SLICE:
        raise ValueError(f"rvq_plan: rows {n}, layers {q}, width {d}: needs N, Q >= 1 and D a multiple of {SLICE}")
    if k < bn or k % bn or -(-n // bm) > MAX_ROW_TILES:
        raise ValueError(f"rvq_plan: {k} codes x {n} rows do not fit {bm}x{bn} tiles in the grid")
    return RVQPlan(bm, bn, (k // bn, -(-n // bm)))


def rvq_kernel_launches(q: int) -> int:
    """Kernels one call launches: the norms, then a distance and an apply
    launch a layer."""
    return 1 + 2 * q


def check_rvq(x: torch.Tensor, codebooks: torch.Tensor) -> RVQPlan:
    """Raise ValueError unless the kernels take these operands; return the
    plan."""
    if x.dim() != 2 or codebooks.dim() != 3 or codebooks.shape[-1] != x.shape[-1]:
        raise ValueError(f"rvq_encode: rows {tuple(x.shape)} vs codebooks {tuple(codebooks.shape)}")
    if x.device != codebooks.device:
        raise ValueError(f"rvq_encode: rows on {x.device}, codebooks on {codebooks.device}")
    for name, t in (("rows", x), ("codebooks", codebooks)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"rvq_encode: {name} must be contiguous 16-byte-aligned f32, got {t.dtype}")
    q, k, d = codebooks.shape
    return rvq_plan(x.shape[0], q, k, d)


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: f32, contiguous, 16-byte aligned."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def rvq_encode_fused(x: torch.Tensor, codebooks: torch.Tensor):
    """(N, D) rows, (Q, K, D) codebooks of any float dtype and layout ->
    (quantized (N, D) f32, indices (N, Q) int32). Both are taken to f32 on
    every device; then CPU tensors take the plain version and CUDA tensors
    launch the kernels."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rvq_encode_fused: unsupported device {x.device}")
    x, codebooks = _operand(x), _operand(codebooks)
    if x.device.type == "cpu":
        return rvq_encode_plain(x, codebooks)
    if x.shape[0] == 0:
        return torch.empty_like(x), torch.empty((0, codebooks.shape[0]), dtype=torch.int32, device=x.device)
    check_rvq(x, codebooks)
    n, d = x.shape
    q, k, _ = codebooks.shape
    out = torch.empty_like(x)
    idx = torch.empty((n, q), dtype=torch.int32, device=x.device)
    res = torch.empty_like(x)
    r2 = torch.empty(n, device=x.device)
    c2 = torch.empty(q, k, device=x.device)
    keys = torch.empty(n, dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library("rvq_encode").rvq_encode(
        x.data_ptr(), codebooks.data_ptr(), out.data_ptr(), idx.data_ptr(), res.data_ptr(), r2.data_ptr(),
        c2.data_ptr(), keys.data_ptr(), n, q, k, d, stream)
    _build.check(err, "rvq_encode")
    launches["rvq_encode"] += 1
    return out, idx


def rvq_quantize_eval_fused(z: torch.Tensor, state: RVQState, cfg: RVQConfig):
    """(B, T, D) -> (quantized, indices (B, T, Q)) through K3; the drop-in
    replacement of :func:`syntalker_tpu_torch.ops.quantize.rvq_quantize_eval`."""
    b, t, d = z.shape
    quant, idx = rvq_encode_fused(z.reshape(b * t, d), layer_codebooks(state, cfg))
    return quant.reshape(b, t, d), idx.reshape(b, t, cfg.num_quantizers)
