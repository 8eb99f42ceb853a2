"""Normalization statistics of the BEAT2 pose features.

Counterpart of ``PoseStats`` / ``identity_pose_stats`` in
``syntalker_tpu/data/stats.py``: the 330-dim rot6d mean/std, sliced per body
part, plus the 3-dim translation-velocity stats, and ``load_pose_stats``
for the shipped ``mean_std`` files. The arrays stay numpy; the
normalizers and denormalizers accept torch tensors and move the stats to
their device.
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
