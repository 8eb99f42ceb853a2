"""The host featurization ops in C++ (``audio_ops.cpp``), bound with ctypes.

Counterpart of ``syntalker_tpu/native``: the O(n) rolling max of |x| and
the librosa-style peak picker, the same C++ in the port's own copy (JAX's
window gather has no caller in either package and is not copied). The
source compiles with ``g++ -O3 -shared -fPIC`` at first use into
``build/native/`` at the repository root, named by the hash of the source,
so a changed source rebuilds and an unchanged one is reused. A failed
build raises: nothing falls back to numpy here. The plain numpy versions
live beside their callers in :mod:`syntalker_tpu_torch.data.audio` for the
tests.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "audio_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_F, _I = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
I64 = ctypes.c_int64
# (restype, argtypes) of every C entry point
SIGNATURES = {
    # x, n, window, out
    "rolling_max_abs_f32": (None, (_F, I64, I64, _F)),
    # env, n, pre_max, post_max, pre_avg, post_avg, delta, wait, out_idx
    "peak_pick_f32": (I64, (_F, I64, I64, I64, I64, I64, ctypes.c_float, I64, _I)),
}


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libaudio_ops-{digest}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if ``g++`` is
    missing or fails."""
    out = _target()
    if not out.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the host featurization ops build with it")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for fn, (restype, argtypes) in SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F)


def rolling_max_abs(x: np.ndarray, window: int = 1024) -> np.ndarray:
    """Rolling max of |x| over ``window`` samples, stride 1, end-padded with
    the last full window's value (O(n) monotonic deque)."""
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 1 or window < 1:
        raise ValueError(f"rolling_max_abs: 1-D samples and a window of at least 1, got {x.shape}, {window}")
    out = np.empty_like(x)
    library().rolling_max_abs_f32(_fptr(x), len(x), window, _fptr(out))
    return out


def peak_pick(env: np.ndarray, *, pre_max: int, post_max: int, pre_avg: int, post_avg: int, delta: float,
              wait: int) -> np.ndarray:
    """librosa.util.peak_pick on a 1-D envelope; the window means come from
    double-precision prefix sums."""
    env = np.ascontiguousarray(env, np.float32)
    out = np.empty(len(env), np.int64)
    n = library().peak_pick_f32(_fptr(env), len(env), pre_max, post_max, pre_avg, post_avg,
                                ctypes.c_float(delta), wait, out.ctypes.data_as(_I))
    return out[:n].copy()

