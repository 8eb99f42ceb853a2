"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ctypes: every pointer
and the stream pass as ``c_void_p``, and every entry point returns
``cudaGetLastError()``, which :func:`check` raises on. Libraries go under
``build/kernels/`` at the repository root, named by the hash of their
source, so a changed source rebuilds and an unchanged one is reused. The
build happens at first use, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("mdm_block", "rvq_encode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point, by library
SIGNATURES = {
    "mdm_block": {
        # device
        "mdm_init": (I,),
        # x, scale, bias, out(bf16), rows, D, eps, stream
        "mdm_layernorm_bf16": (P, P, P, P, I, I, F, P),
        # A(bf16), B(bf16), M, N, K, epilogue, bias, out_f32, out_bf16, ca, cb, stream
        "mdm_gemm": (P, P, I, I, I, I, P, P, P, F, F, P),
        # qkv(f32), out(bf16), B, T, D, H, scale, stream
        "mdm_attention": (P, P, I, I, I, I, F, P),
        # style_p, xe_p, at_p, bias, cos, sin, act, ln_scale, ln_shift, act_ln(bf16), eps, B, T, D,
        # rope_heads, stream
        "mdm_prologue": (P, P, P, P, P, P, P, P, P, P, F, I, I, I, I, P),
    },
    "rvq_encode": {
        # x, codebooks, out, idx, res, r2, c2, keys, N, Q, K, D, stream
        "rvq_encode": (P, P, P, P, P, P, P, P, I, I, I, I, P),
    },
}


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every stale source, one nvcc process each, all started
    together. Returns {name: seconds} (0.0 for a library already built);
    raises with nvcc's output on failure. nvcc's ``-Xptxas -v`` report
    (registers, shared memory, spills) is kept beside each library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, took = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        took[name] = 0.0
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode:
            errors.append(f"nvcc failed on {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    build_all((name,))
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
