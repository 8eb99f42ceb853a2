"""The collectives of the port's process-group forms (data-parallel and
tensor-parallel training).

JAX's sharded programs get their reductions from the collectives XLA
inserts; here they are explicit, over one axis of a
:class:`~syntalker_tpu_torch.parallel.mesh.Mesh` as this rank sees it
(:class:`Axis`). Only all-reduce and broadcast are used: a gather is an
all-reduce of a zero-padded buffer. Both run on NCCL and on gloo with CPU
or CUDA tensors (gloo's ``all_gather`` takes CPU tensors only). Every
function is the identity on an axis of one rank or on ``None``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist

# integer views of the float widths: summing zeros into an integer copies
# the bits exactly (a float sum would turn -0.0 into 0.0)
_BITS = {4: torch.int32, 8: torch.int64, 1: torch.uint8}


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis from this rank: its process ``group`` (None in a
    single process), its ``size`` and this rank's ``index`` along it."""

    group: Optional[object] = None
    size: int = 1
    index: int = 0


def active(axis: Optional[Axis]) -> bool:
    return axis is not None and axis.size > 1


def rows_of(x: Optional[torch.Tensor], axis: Optional[Axis], dim: int = 0) -> Optional[torch.Tensor]:
    """This rank's contiguous block of ``x`` along ``dim`` (the global
    batch's rows that the rank's data shard holds); None stays None."""
    if x is None or not active(axis):
        return x
    if x.shape[dim] % axis.size:
        raise ValueError(f"{x.shape[dim]} rows do not divide over {axis.size} ranks")
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the axis; the backward sums the gradients over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of ``x`` over the axis's ranks, on every rank; gradients
    flow back to every rank's ``x``."""
    if not active(axis):
        return x
    return _AllReduceSum.apply(x, axis.group)


def all_reduce_mean(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The mean of ``x`` over the axis's ranks (differentiable)."""
    if not active(axis):
        return x
    return all_reduce_sum(x, axis) / axis.size


def all_reduce_mean_(tensors: List[torch.Tensor], axis: Optional[Axis]) -> List[torch.Tensor]:
    """The mean over the axis of every tensor in the list, in one
    all-reduce of their flattened concatenation (no gradient)."""
    if not active(axis) or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=axis.group)
    flat /= axis.size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at : at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def gather_rows(x: torch.Tensor, axis: Optional[Axis], rows: Optional[int] = None) -> torch.Tensor:
    """The rows of every rank, concatenated in axis order, on every rank:
    each rank's block of ``x.shape[0]`` rows is written into a zero buffer
    at its place and the buffers summed. With ``rows`` only the first
    ``rows`` global rows are gathered (the ranks whose block lies past them
    send zeros). Bit for bit the ranks' values: floats are summed as
    integers of their width."""
    n = x.shape[0]
    total = n * (axis.size if active(axis) else 1)
    rows = total if rows is None else min(rows, total)
    if not active(axis):
        return x[:rows]
    buf = x.new_zeros((rows,) + tuple(x.shape[1:]))
    lo = axis.index * n
    take = max(0, min(n, rows - lo))
    if take:
        buf[lo : lo + take] = x[:take]
    return exact_sum(buf, axis)


def exact_sum(buf: torch.Tensor, axis: Axis) -> torch.Tensor:
    """All-reduce of buffers in which at most one rank holds each nonzero
    element: the result is that element bit for bit."""
    if buf.is_floating_point() and buf.element_size() in _BITS:
        bits = buf.contiguous().view(_BITS[buf.element_size()])
        dist.all_reduce(bits, group=axis.group)
        return bits.view(buf.dtype)
    if buf.dtype == torch.bool:
        bits = buf.to(torch.uint8)
        dist.all_reduce(bits, group=axis.group)
        return bits.bool()
    buf = buf.contiguous()
    dist.all_reduce(buf, group=axis.group)
    return buf


def broadcast_(tensors, src: int = 0) -> None:
    """Every tensor of the iterable takes the values of global rank
    ``src``, in place; nothing without a process group."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    for t in tensors:
        dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=src)
