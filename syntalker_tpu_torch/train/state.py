"""Train states and npz checkpoints.

Counterpart of ``syntalker_tpu/train/state.py`` (its optimizers and
schedules are in :mod:`syntalker_tpu_torch.train.optim`). JAX's trainers
write orbax directories, which cannot be read without JAX and tensorstore;
the port writes and reads one npz per checkpoint, ``step_<N>.npz``, whose
keys are the "/"-joined flax paths of JAX's ``TrainState`` in float32:

- ``step``;
- ``params/...``: the flax param tree (scan-stacked MDM blocks, as
  ``cfg.scan_blocks`` says);
- ``opt_state/<i>/<field>/...``: optax's state, chain entries by position
  and NamedTuple fields by name, each moment a flax param tree;
- ``rng``: the ``torch.Generator``'s state bytes (JAX keeps a PRNG key
  there; neither reads the other's);
- ``quantizer_state/{codebook,code_sum,code_count,initialized}`` (RVQ);
- ``model_state/batch_stats/...`` (a BatchNorm wav encoder).

:func:`load_model_variables` (and through it ``generate``) reads the
``params`` and ``model_state`` of such a file, a variables tree or a bare
param tree; ``train.loop.load_rvq_stack`` reads ``params`` and
``quantizer_state``. ``README.md`` gives the few lines that convert an
orbax checkpoint in the JAX environment.
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.eval.t2m import flatten_params, unflatten_params
from syntalker_tpu_torch.ops.quantize import RVQState

# the fields of JAX's TrainState; every other top-level entry is a flax collection
_TRAIN_STATE_KEYS = {"step", "params", "opt_state", "rng", "quantizer_state", "model_state"}
TRAIN_ONLY_KEYS = frozenset({"opt_state", "rng"})  # what inference never reads
_CKPT_NAME = re.compile(r"step_(\d+)\.npz")


@dataclasses.dataclass
class TrainState:
    """One model's training state. ``params`` are the module's own
    parameters by torch name (a step updates them in place), ``opt_state``
    the optimizer's (:mod:`~syntalker_tpu_torch.train.optim`),
    ``generator`` the source of every draw of a step, ``quantizer_state``
    the RVQ codebooks and their EMA statistics (RVQ training), and
    ``model_state`` the BatchNorm running statistics (the module's
    buffers, by torch name), or None. ``layout`` and ``stats_layout`` give
    their flax paths for checkpoints."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    generator: torch.Generator
    layout: bridge.FlaxLayout
    quantizer_state: Optional[RVQState] = None
    model_state: Optional[Dict[str, torch.Tensor]] = None
    stats_layout: Optional[bridge.FlaxLayout] = None


def create_train_state(module: torch.nn.Module, optimizer, generator: torch.Generator, *,
                       quantizer_state: Optional[RVQState] = None) -> TrainState:
    """A fresh state at step 0: the module's parameters made trainable, the
    optimizer's initial state, and the module's BatchNorm statistics as
    ``model_state``."""
    module.requires_grad_(True)
    layout, stats_layout = bridge.flax_layouts(module)
    params = dict(module.named_parameters())
    buffers = dict(module.named_buffers())
    model_state = {n: buffers[n] for n in stats_layout.names()} or None
    return TrainState(step=0, params=params, opt_state=optimizer.init(params), generator=generator, layout=layout,
                      quantizer_state=quantizer_state, model_state=model_state,
                      stats_layout=stats_layout if model_state else None)


def state_to_flax(state: TrainState) -> dict:
    """The state as JAX's ``TrainState`` tree of f32 numpy (``rng``: the
    generator's state bytes)."""
    tree = {"step": np.asarray(state.step, np.float32),
            "params": state.layout.to_flax(state.params),
            "opt_state": bridge.optax_state_to_flax(state.opt_state, state.layout),
            "rng": state.generator.get_state().numpy()}
    if state.quantizer_state is not None:
        tree["quantizer_state"] = bridge.rvq_state_to_flax(state.quantizer_state)
    if state.model_state:
        tree["model_state"] = {"batch_stats": state.stats_layout.to_flax(state.model_state)}
    return tree


def save_checkpoint(ckpt_dir: str | Path, state: TrainState, step: Optional[int] = None) -> Path:
    """Write ``<ckpt_dir>/step_<N>.npz``: under a temporary name first, then
    renamed, so that a reader never sees half a file."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    step = state.step if step is None else step
    path = d / f"step_{step}.npz"
    tmp = d / f"step_{step}.npz.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **flatten_params(state_to_flax(state)))
    os.replace(tmp, path)
    return path


@torch.no_grad()
def load_checkpoint(ckpt_path: str | Path, target: TrainState) -> TrainState:
    """Resume ``target`` from a checkpoint in place: step, parameters,
    optimizer state, generator, codebooks and BatchNorm statistics."""
    raw = load_checkpoint_npz(ckpt_path)
    for name, v in target.layout.from_flax(raw["params"]).items():
        target.params[name].copy_(v)
    target.opt_state = bridge.optax_state_from_flax(raw.get("opt_state", {}), target.opt_state, target.layout)
    target.generator.set_state(torch.as_tensor(raw["rng"].astype(np.uint8)))
    if target.quantizer_state is not None:
        target.quantizer_state = bridge.rvq_state_from_flax(raw["quantizer_state"],
                                                            device=target.quantizer_state.codebook.device)
    if target.model_state:
        for name, v in target.stats_layout.from_flax(raw["model_state"]["batch_stats"]).items():
            target.model_state[name].copy_(v)
    target.step = int(raw["step"])
    return target


def latest_checkpoint(ckpt_dir: str | Path) -> Optional[Path]:
    """The newest complete ``step_<N>.npz``, or None. In-flight temporary
    files and names whose step does not parse are skipped."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return None
    steps = sorted((int(m.group(1)), p) for p in d.iterdir() if p.is_file() and (m := _CKPT_NAME.fullmatch(p.name)))
    return steps[-1][1] if steps else None


def load_checkpoint_npz(ckpt_path: str | Path, skip=frozenset()) -> dict:
    """A checkpoint npz -> nested dict of float32 arrays, without the
    top-level entries in ``skip`` (npz members are read one by one, so an
    inference load need not read a train state's optimizer moments). An
    orbax directory is refused with the conversion to run."""
    p = Path(ckpt_path)
    if p.is_dir():
        raise ValueError(
            f"{p} is an orbax checkpoint directory, which the port cannot read. Convert it in the JAX "
            "environment to one npz of '/'-joined flax paths in float32 (README.md, 'Checkpoints for the "
            "port'): load it with syntalker_tpu.train.state.load_model_variables (an RVQ checkpoint with "
            "load_checkpoint_raw), flatten with jax.tree_util.tree_flatten_with_path, np.savez")
    with np.load(p) as data:
        return unflatten_params({k: np.asarray(data[k], np.float32) for k in data.files
                                 if k.split("/")[0] not in skip})


def load_model_variables(ckpt_path: str | Path) -> dict:
    """A checkpoint as a flax variables dict for inference: ``{"params":
    ..., **collections}``. Reads a variables tree (``params`` and e.g. the
    WavEncoder's ``batch_stats``), a train state (``params`` and
    ``model_state``) or a bare param tree (converted reference checkpoints)."""
    raw = load_checkpoint_npz(ckpt_path, skip=TRAIN_ONLY_KEYS)
    if "params" not in raw:
        return {"params": raw}
    extra = {k: v for k, v in raw.items() if k not in _TRAIN_STATE_KEYS}
    return {"params": raw["params"], **(raw.get("model_state") or {}), **extra}
