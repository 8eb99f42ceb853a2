"""Model checkpoints for inference.

Counterpart of ``load_model_variables`` in ``syntalker_tpu/train/state.py``.
JAX's trainers write orbax directories, which cannot be read without JAX
and tensorstore. The port reads the same trees written as one npz of
"/"-joined flax paths in float32 (the layout of
:mod:`syntalker_tpu_torch.eval.t2m`); ``README.md`` gives the few lines
that convert an orbax checkpoint in the JAX environment. Optimizer state,
schedules and checkpoint writing wait for the training slice.
"""

from __future__ import annotations

from pathlib import Path

from syntalker_tpu_torch.eval.t2m import load_oracle_params

# the fields of JAX's TrainState; every other top-level entry is a flax collection
_TRAIN_STATE_KEYS = {"step", "params", "opt_state", "rng", "quantizer_state", "model_state"}


def load_checkpoint_npz(ckpt_path: str | Path) -> dict:
    """A checkpoint npz -> nested dict of float32 arrays. An orbax
    directory is refused with the conversion to run."""
    p = Path(ckpt_path)
    if p.is_dir():
        raise ValueError(
            f"{p} is an orbax checkpoint directory, which the port cannot read. Convert it in the JAX "
            "environment to one npz of '/'-joined flax paths in float32 (README.md, 'Checkpoints for the "
            "port'): load it with syntalker_tpu.train.state.load_model_variables (an RVQ checkpoint with "
            "load_checkpoint_raw), flatten with jax.tree_util.tree_flatten_with_path, np.savez")
    return load_oracle_params(p)


def load_model_variables(ckpt_path: str | Path) -> dict:
    """A checkpoint as a flax variables dict for inference: ``{"params":
    ..., **collections}``. Reads a variables tree (``params`` and e.g. the
    WavEncoder's ``batch_stats``), a train state (``params`` and
    ``model_state``) or a bare param tree (converted reference checkpoints)."""
    raw = load_checkpoint_npz(ckpt_path)
    if "params" not in raw:
        return {"params": raw}
    extra = {k: v for k, v in raw.items() if k not in _TRAIN_STATE_KEYS}
    return {"params": raw["params"], **(raw.get("model_state") or {}), **extra}
