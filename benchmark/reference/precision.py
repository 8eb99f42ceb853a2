"""Roundings that a control computes in, simulated in float32.

A control is the reference put in the program's place, one precision below
what the configuration states: fp8 (e4m3, one scale per tensor) below the
bf16 kernels, TF32 (10 mantissa bits) below float32 with TF32 off, bf16
below float32 that lets TF32 in. Each is simulated by rounding the
operands of every product, so they run alike on any device.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the whole tensor."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to nearest (ties to even) at 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32).to(x.dtype)


ROUNDERS = {"float32": exact, "fp8": fp8, "bf16": bf16, "tf32": tf32}


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuBLAS and cuDNN inside: the reference is float32."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
