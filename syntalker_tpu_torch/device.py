"""Device selection and float32 precision for the port's entry points.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
machine without a GPU, omitting ``device`` raises instead of falling back
to the CPU. ``full_f32`` pins float32 convolutions and matmuls to full
precision: cuDNN runs f32 convolutions in TF32 by default, which keeps
about three decimal digits and moves the RVQ argmin.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# short dtype names of the configs (``dtype: bf16``)
DTYPE_ALIASES = {"bf16": "bfloat16", "f32": "float32", "fp32": "float32", "f16": "float16", "fp16": "float16"}


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype, a name (``"bf16"``, ``"float32"``)
    or anything ``np.dtype`` reads (a numpy or ml_dtypes type)."""
    if isinstance(d, torch.dtype):
        return d
    name = DTYPE_ALIASES.get(d, d) if isinstance(d, str) else np.dtype(d).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {d!r}")
    return out


@contextlib.contextmanager
def full_f32():
    """Disable TF32 for cuDNN convolutions and cuBLAS matmuls inside."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
