"""Normalization statistics of the BEAT2 pose features.

Counterpart of ``syntalker_tpu/data/stats.py``: ``PoseStats``, the 330-dim
rot6d mean/std, sliced per body part, plus the 3-dim translation-velocity
stats; ``H3DStats`` of the 623-dim representation; loaders for the shipped
``mean_std`` files, identity stats, and the dataset statistics that produce
such files (``compute_pose_stats``, ``compute_h3d_stats``). The arrays stay
numpy; the normalizers and denormalizers accept torch tensors and move the
stats to their device (``H3DStats`` also numpy arrays). The per-joint mean
velocity of BeatAlign needs SMPL-X forward kinematics and waits for the
evaluation slice.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from syntalker_tpu_torch.data import joints as J

_PART_IDX = {"upper": J.UPPER_6D_IDX, "hands": J.HANDS_6D_IDX, "lower": J.LOWER_6D_IDX}


def _like(a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class PoseStats:
    mean_full: np.ndarray  # (330,)
    std_full: np.ndarray  # (330,)
    trans_mean: np.ndarray  # (3,)
    trans_std: np.ndarray  # (3,)

    def normalize_part(self, x: torch.Tensor, part: str) -> torch.Tensor:
        idx = _PART_IDX[part]
        return (x - _like(self.mean_full[idx], x)) / _like(self.std_full[idx], x)

    def normalize_trans(self, v: torch.Tensor) -> torch.Tensor:
        return (v - _like(self.trans_mean, v)) / _like(self.trans_std, v)

    def denormalize_part(self, x: torch.Tensor, part: str) -> torch.Tensor:
        idx = _PART_IDX[part]
        return x * _like(self.std_full[idx], x) + _like(self.mean_full[idx], x)

    def denormalize_trans(self, v: torch.Tensor) -> torch.Tensor:
        return v * _like(self.trans_std, v) + _like(self.trans_mean, v)


def identity_pose_stats() -> PoseStats:
    """Unit stats for tests / unnormalized runs."""
    return PoseStats(
        mean_full=np.zeros(J.ROT6D_DIM, np.float32),
        std_full=np.ones(J.ROT6D_DIM, np.float32),
        trans_mean=np.zeros(3, np.float32),
        trans_std=np.ones(3, np.float32),
    )


def load_pose_stats(mean_std_dir: str | Path) -> PoseStats:
    """The shipped beatx_2_330 / beatx_2_trans statistics from a directory."""
    d = Path(mean_std_dir)
    return PoseStats(
        mean_full=np.load(d / "beatx_2_330_mean.npy").astype(np.float32),
        std_full=np.load(d / "beatx_2_330_std.npy").astype(np.float32),
        trans_mean=np.load(d / "beatx_2_trans_mean.npy").astype(np.float32),
        trans_std=np.load(d / "beatx_2_trans_std.npy").astype(np.float32),
    )


@dataclasses.dataclass(frozen=True)
class H3DStats:
    """Normalization stats of the 623-dim representation (shipped as
    ``mean_std/beatx_1-30_amass_h3d_{mean,std}.npy``)."""

    mean: np.ndarray  # (623,)
    std: np.ndarray  # (623,)

    def _stats(self, x):
        if isinstance(x, torch.Tensor):
            return _like(self.mean, x), _like(self.std, x)
        return self.mean, self.std

    def normalize(self, x):
        mean, std = self._stats(x)
        return (x - mean) / std

    def denormalize(self, x):
        mean, std = self._stats(x)
        return x * std + mean


def load_h3d_stats(mean_std_dir: str | Path) -> H3DStats:
    d = Path(mean_std_dir)
    return H3DStats(
        mean=np.load(d / "beatx_1-30_amass_h3d_mean.npy").astype(np.float32),
        std=np.maximum(np.load(d / "beatx_1-30_amass_h3d_std.npy").astype(np.float32), 1e-6),
    )


def identity_h3d_stats() -> H3DStats:
    return H3DStats(mean=np.zeros(623, np.float32), std=np.ones(623, np.float32))


def compute_pose_stats(pose_rot6d: np.ndarray, trans_v: np.ndarray) -> PoseStats:
    """Dataset mean/std of the 330-d rot6d and the translation velocity: the
    artifacts of the shipped ``mean_std/beatx_2_330_*.npy``, std floored at
    1e-6."""
    return PoseStats(
        mean_full=pose_rot6d.reshape(-1, J.ROT6D_DIM).mean(0).astype(np.float32),
        std_full=np.maximum(pose_rot6d.reshape(-1, J.ROT6D_DIM).std(0), 1e-6).astype(np.float32),
        trans_mean=trans_v.reshape(-1, 3).mean(0).astype(np.float32),
        trans_std=np.maximum(trans_v.reshape(-1, 3).std(0), 1e-6).astype(np.float32),
    )


def compute_h3d_stats(h3d_feats: np.ndarray) -> H3DStats:
    """Dataset mean/std of the 623-d representation, std floored at 1e-6."""
    flat = h3d_feats.reshape(-1, 623)
    return H3DStats(mean=flat.mean(0).astype(np.float32), std=np.maximum(flat.std(0), 1e-6).astype(np.float32))
