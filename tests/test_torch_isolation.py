"""The port stands alone: importing ``syntalker_tpu_torch`` (every
submodule, the train steps, optimizers, trainers, data path, registries,
the evaluation and text-control slices, the train and evaluation CLIs, the
checkpoint converters, the renderer, the demo and the mesh layer included) and
``chip_smoke.py`` pulls in neither JAX, flax, optax, orbax nor the JAX
package, nor does running those CLIs' ``--help``; the renderer's worker
processes import no torch; entry points refuse to fall back to the CPU silently, and the
ctypes signatures agree with the C entry points of the CUDA sources."""

import ast
import ctypes
import json
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
from syntalker_tpu_torch.eval.harness_h3d import H3DEvaluator
from syntalker_tpu_torch.eval.t2m import T2MEvalConfig, T2MEvaluator
from syntalker_tpu_torch.models.tmr import TextPipeline, TMRConfig, load_tmr_motion
from syntalker_tpu_torch.ops import _build
from syntalker_tpu_torch.render import render_npz
from syntalker_tpu_torch.serving import MotionGenerationService
from syntalker_tpu_torch.streaming import StreamingMotionSession
from syntalker_tpu_torch.bridge import rvq_state_from_flax
from syntalker_tpu_torch.train import diffusion_trainer, optim, rvq_trainer
from syntalker_tpu_torch.data.cache import BeatCache, DeviceDataset
from syntalker_tpu_torch.train.loop import DiffusionTrainer, RVQTrainer, load_rvq_stack
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

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
print(json.dumps(sorted(sys.modules)))
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


def test_data_and_loop_modules_are_walked():
    """The training data path, the loops, the registries and the train CLIs
    are among the modules the probe imports."""
    for rel in ("data/synthetic.py", "data/cache.py", "data/beat_builder.py", "data/features.py", "train/loop.py",
                "registry.py", "components.py", "cli/train.py", "cli/train_rvq.py", "utils/tracking.py"):
        assert (PKG / rel).exists(), rel


def test_evaluation_modules_are_walked():
    """The evaluation slice's modules are among those the probe imports."""
    for rel in ("ops/smplx.py", "data/h3d.py", "models/skeleton.py", "models/eval_vae.py", "eval/metrics.py",
                "eval/harness.py", "train/ae_trainer.py", "cli/test.py", "cli/train_aux.py"):
        assert (PKG / rel).exists(), rel


def test_multi_gpu_modules_are_walked():
    """The mesh layer's modules are among those the probe imports, and the
    package exports JAX's names."""
    for rel in ("parallel/__init__.py", "parallel/mesh.py", "parallel/multihost.py", "parallel/collectives.py"):
        assert (PKG / rel).exists(), rel
    import syntalker_tpu_torch.parallel as par
    for name in ("make_mesh", "shard_batch", "replicate", "param_specs", "MDM_TP_LAYOUT", "shard_params",
                 "init_multihost", "is_primary", "data_sharding", "replicated_sharding"):
        assert hasattr(par, name), name


def test_text_control_modules_are_walked():
    """The text-control (h3d) slice's modules are among those the probe imports."""
    for rel in ("eval/t2m.py", "eval/harness_h3d.py", "cli/test_h3d.py", "data/amass.py", "data/word_bert.py",
                "data/bvh.py"):
        assert (PKG / rel).exists(), rel


@pytest.mark.parametrize("cli", ("train", "train_rvq", "test", "train_aux", "test_h3d", "demo"))
def test_train_cli_help_pulls_in_no_jax(cli):
    code = ("import json, runpy, sys\n"
            f"sys.argv = ['{cli}', '--help']\n"
            "try:\n"
            f"    runpy.run_module('syntalker_tpu_torch.cli.{cli}', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {set(FORBIDDEN)})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_import_pulls_in_no_jax():
    code = _PROBE.format(forbidden=set(FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    forbidden, imported = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    walked = set(json.loads(imported))
    for name in ("ops.smplx", "data.h3d", "models.skeleton", "models.eval_vae", "eval.metrics", "eval.harness",
                 "train.ae_trainer", "cli.test", "cli.train_aux", "eval.t2m", "eval.harness_h3d", "cli.test_h3d",
                 "data.amass", "data.word_bert", "data.bvh", "convert", "render", "cli.demo", "parallel.mesh",
                 "parallel.multihost", "parallel.collectives"):
        assert f"syntalker_tpu_torch.{name}" in walked, name


def test_render_workers_import_no_torch():
    """What a spawned render worker imports to unpickle its job."""
    code = "import json, sys\nimport syntalker_tpu_torch.render\nprint(json.dumps('torch' in sys.modules))\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "false"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
    ROOT / "tests" / name for name in ("torch_parallel_worker.py", "test_torch_parallel_cuda.py")], ids=lambda p: p.name)
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
    for trainer in (RVQTrainer, DiffusionTrainer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer(tiny, BeatCache("unused"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceDataset(BeatCache("unused"), ("pose",), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_npz("missing.npz", "missing")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T2MEvaluator(T2MEvalConfig(hidden=4, dim_movement=4, dim_coemb=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T2MEvaluator.from_artifact()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H3DEvaluator(mdm=None, diffusion=make_diffusion(steps=4), rvq_modules={}, h3d_stats=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_tmr_motion(ROOT / "weights" / "t2m_oracle" / "tmr.npz")


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
