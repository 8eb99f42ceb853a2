"""The port stands alone: importing ``syntalker_tpu_torch`` (every
submodule, the train steps and optimizers included) and ``chip_smoke.py``
pulls in neither JAX, flax, optax, orbax nor the JAX package, entry points
refuse to fall back to the CPU silently, and the ctypes signatures agree
with the C entry points of the CUDA sources."""

import ast
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from syntalker_tpu_torch.cli import generate as GEN
from syntalker_tpu_torch.config import load_config
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import MDMConfig, build_mdm
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
from syntalker_tpu_torch.models.tmr import TextPipeline, TMRConfig
from syntalker_tpu_torch.ops import _build
from syntalker_tpu_torch.serving import MotionGenerationService
from syntalker_tpu_torch.streaming import StreamingMotionSession
from syntalker_tpu_torch.bridge import rvq_state_from_flax
from syntalker_tpu_torch.train import diffusion_trainer, optim, rvq_trainer
from syntalker_tpu_torch.train.loop import load_rvq_stack

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "syntalker_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "syntalker_tpu")

_PROBE = """
import importlib, json, pkgutil, sys
import syntalker_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in {forbidden})))
"""


def test_train_modules_are_walked():
    """The probe below imports every submodule; the train slice's are among
    them, and optax and orbax are on the forbidden list."""
    names = {p.stem for p in (PKG / "train").glob("*.py")}
    assert {"optim", "rvq_trainer", "diffusion_trainer", "state"} <= names
    assert (PKG / "diffusion" / "extras.py").exists()
    assert {"optax", "orbax"} <= set(FORBIDDEN)
    assert callable(optim.make_optimizer) and callable(rvq_trainer.make_rvq_train_step)
    assert callable(diffusion_trainer.make_diffusion_train_step)


def test_import_pulls_in_no_jax():
    code = _PROBE.format(forbidden=set(FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"], ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_entry_points_need_a_device_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mdm(MDMConfig(num_layers=1, vocab_size=8), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_rvqvae(RVQVAEConfig(input_dim=78, width=8, depth=1), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MotionGenerationService(mdm=None, diffusion=make_diffusion(steps=4), rvq_modules={}, stats=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingMotionSession(mdm=None, diffusion=make_diffusion(steps=4), rvq_modules={}, stats=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TextPipeline(TMRConfig(num_layers=1))
    tiny = load_config(None, ["mdm.num_layers=1", "mdm.vocab_size=8", "rvq_width=8", "rvq_depth=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_rvq_stack(tiny, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GEN.generate_clip(tiny, "missing.wav")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rvq_state_from_flax({"codebook": [[[0.0]]]})


def test_ctypes_signatures_match_the_sources():
    """Each C entry point has exactly the argument count its ctypes
    signature declares (a wrong count silently corrupts the call)."""
    assert set(_build.SIGNATURES) == set(_build.SOURCES) == {p.stem for p in (PKG / "csrc").glob("*.cu")}
    for name, sigs in _build.SIGNATURES.items():
        src = (PKG / "csrc" / f"{name}.cu").read_text()
        c_api = src[src.index('extern "C"'):]
        found = {m.group(1): m.group(2) for m in re.finditer(r"\bint (\w+)\(([^)]*)\)", c_api)}
        assert set(found) == set(sigs), name
        for fn, argtypes in sigs.items():
            assert len(found[fn].split(",")) == len(argtypes), fn


def test_host_ctypes_signatures_match_the_source():
    """The host C++ of ``native/audio_ops.cpp``: each ``extern "C"`` entry
    point has the argument count and return type its ctypes signature
    declares."""
    from syntalker_tpu_torch import native

    src = native.SRC.read_text()
    c_api = src[src.index('extern "C"'):]
    found = {m.group(2): (m.group(1), m.group(3)) for m in re.finditer(r"\b(void|int64_t) (\w+)\(([^)]*)\)", c_api)}
    assert set(found) == set(native.SIGNATURES)
    for fn, (restype, argtypes) in native.SIGNATURES.items():
        ret, args = found[fn]
        assert len(args.split(",")) == len(argtypes), fn
        assert restype is ({"void": None, "int64_t": ctypes.c_int64}[ret]), fn
