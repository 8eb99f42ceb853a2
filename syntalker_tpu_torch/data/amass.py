"""AMASS motion loading and the BEAT2/AMASS mixture sampler.

Counterpart of ``syntalker_tpu/data/amass.py`` (the reference's
``dataloaders/mix_sep.py:149-171`` and the ``train_h3d.py:46-87``
WeightedRandomSampler mixture, amass:beat ≈ 0.5): an AMASS SMPL-X npz is
turned Z-up to Y-up (the global rotation through the port's
:mod:`~syntalker_tpu_torch.ops.rotations`, in float32 on the CPU), its
poses padded or cut to 165 values, its betas padded to 300, and given zero
expressions.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator

import numpy as np
import torch

from syntalker_tpu_torch.ops import rotations as rot

# Blender Z-up -> Y-up basis changes (mix_sep.py:157-163)
_ROT_YUP = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]], np.float32)
_TRANS_YUP = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]], np.float32)


def load_amass_npz(path: str | Path) -> Dict[str, np.ndarray]:
    """AMASS SMPL-X npz -> a BEAT-compatible dict: ``poses`` (T, 165),
    ``trans`` (T, 3), ``betas`` (300,), ``expressions`` (T, 100)."""
    data = np.load(path, allow_pickle=True)
    poses = np.asarray(data["poses"], np.float32)
    if poses.shape[1] > 165:
        poses = poses[:, :165]
    elif poses.shape[1] < 165:
        poses = np.pad(poses, ((0, 0), (0, 165 - poses.shape[1])))
    n = poses.shape[0]

    # the global rotation re-oriented Z-up -> Y-up
    root_m = rot.axis_angle_to_matrix(torch.from_numpy(poses[:, :3].copy())).numpy()
    root_m = np.einsum("ij,kjl->kil", _ROT_YUP, root_m)
    poses[:, :3] = rot.matrix_to_axis_angle(torch.from_numpy(root_m)).numpy()

    trans = np.einsum("bi,ij->bj", np.asarray(data["trans"], np.float32), _TRANS_YUP)

    betas = np.zeros(300, np.float32)
    src_betas = np.asarray(data["betas"], np.float32).reshape(-1)
    betas[: min(16, len(src_betas))] = src_betas[:16]
    return {"poses": poses, "trans": trans.astype(np.float32), "betas": betas,
            "expressions": np.zeros((n, 100), np.float32)}


class WeightedMixtureLoader:
    """Batches drawn from several loaders with per-source weights, in a
    sequence fixed by ``seed`` and the epoch (the reference's
    WeightedRandomSampler, train_h3d.py:46-87). Each loader has
    ``epoch(e)``; a source that runs out restarts at its next epoch."""

    def __init__(self, loaders: Dict[str, object], weights: Dict[str, float], seed: int = 0):
        assert set(loaders) == set(weights)
        self.loaders = loaders
        self.names = sorted(loaders)
        w = np.asarray([weights[n] for n in self.names], np.float64)
        self.p = w / w.sum()
        self.seed = seed

    def epoch(self, epoch: int, steps: int) -> Iterator:
        """``steps`` (source name, batch) pairs."""
        rng = np.random.default_rng(self.seed + epoch)
        iters = {n: iter(self.loaders[n].epoch(epoch)) for n in self.names}
        for _ in range(steps):
            name = self.names[rng.choice(len(self.names), p=self.p)]
            try:
                yield name, next(iters[name])
            except StopIteration:
                iters[name] = iter(self.loaders[name].epoch(epoch + 1))
                yield name, next(iters[name])
