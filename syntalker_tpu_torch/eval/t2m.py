"""Flat-npz parameter trees: the I/O of the committed t2m artifacts.

Counterpart of ``save_oracle_params`` / ``load_oracle_params`` in
``syntalker_tpu/eval/t2m.py``. A parameter tree is a nested dict of arrays
(the flax layout); on disk it is one npz whose keys are the "/"-joined
paths. The committed artifacts (``weights/t2m_oracle/*.npz``) are fp16;
loading casts every leaf to float32. The text-to-motion evaluators wait for
the evaluation slice.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def flatten_params(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> dict:
    """{"a/b/c": array} -> nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_oracle_params(path, params: dict, meta: Optional[Dict] = None) -> Path:
    """The tree as one compressed fp16 npz (small enough to commit), plus a
    JSON sidecar when ``meta`` is given. fp16 is for the small t2m
    artifacts; a denoiser or RVQ checkpoint is written in f32."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(p, **{k: v.astype(np.float16) for k, v in flatten_params(params).items()})
    if meta is not None:
        p.with_suffix(".json").write_text(json.dumps(meta, indent=1))
    return p


def load_oracle_params(path, template: Optional[dict] = None) -> dict:
    """npz -> nested dict of float32 arrays. With a ``template`` tree (of
    arrays or anything with ``.shape``), every template path must be in the
    file with the template's shape, and only those paths are returned."""
    with np.load(path) as data:
        flat = {k: np.asarray(data[k], np.float32) for k in data.files}
    if template is not None:
        want = flatten_params(template)
        for key, v in want.items():
            if key not in flat:
                raise KeyError(f"{key}: missing from {path}")
            if flat[key].shape != np.shape(v):
                raise ValueError(f"{key}: artifact {flat[key].shape} != model {np.shape(v)}")
        flat = {k: flat[k] for k in want}
    return unflatten_params(flat)
