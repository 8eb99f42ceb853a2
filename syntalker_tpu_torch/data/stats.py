"""Normalization statistics of the BEAT2 pose features.

Counterpart of ``syntalker_tpu/data/stats.py``: ``PoseStats``, the 330-dim
rot6d mean/std, sliced per body part, plus the 3-dim translation-velocity
stats; ``H3DStats`` of the 623-dim representation; loaders for the shipped
``mean_std`` files, identity stats, and the dataset statistics that produce
such files (``compute_pose_stats``, ``compute_h3d_stats``). The arrays stay
numpy; the normalizers and denormalizers accept torch tensors and move the
stats to their device (``H3DStats`` also numpy arrays). The per-joint mean
speed that normalizes BeatAlign (``compute_mean_joint_velocity``) comes
from joints that the port's SMPL-X forward kinematics computes over cached
clips (``compute_mean_velocity_from_clips``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.device import full_f32
from syntalker_tpu_torch.ops.smplx import forward_joints

_PART_IDX = {"upper": J.UPPER_6D_IDX, "hands": J.HANDS_6D_IDX, "lower": J.LOWER_6D_IDX}


def _like(a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class PoseStats:
    mean_full: np.ndarray  # (330,)
    std_full: np.ndarray  # (330,)
    trans_mean: np.ndarray  # (3,)
    trans_std: np.ndarray  # (3,)

    @property
    def mean_upper(self) -> np.ndarray:
        return self.mean_full[J.UPPER_6D_IDX]

    @property
    def std_upper(self) -> np.ndarray:
        return self.std_full[J.UPPER_6D_IDX]

    @property
    def mean_hands(self) -> np.ndarray:
        return self.mean_full[J.HANDS_6D_IDX]

    @property
    def std_hands(self) -> np.ndarray:
        return self.std_full[J.HANDS_6D_IDX]

    @property
    def mean_lower(self) -> np.ndarray:
        return self.mean_full[J.LOWER_6D_IDX]

    @property
    def std_lower(self) -> np.ndarray:
        return self.std_full[J.LOWER_6D_IDX]

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


def compute_mean_joint_velocity(joints_per_clip: list[np.ndarray], fps: int = 30) -> np.ndarray:
    """Per-joint mean speed (55,) over a dataset, the reference's
    ``weights/mean_vel_smplxflame_30.npy``: forward difference at the first
    frame, central differences inside, backward at the last, so that every
    frame gives one speed sample."""
    sums = np.zeros(55)
    count = 0
    for joints in joints_per_clip:  # (T, 55, 3)
        dt = 1.0 / fps
        init = (joints[1:2] - joints[0:1]) / dt
        mid = (joints[2:] - joints[:-2]) / (2 * dt)
        fin = (joints[-1:] - joints[-2:-1]) / dt
        speed = np.linalg.norm(np.concatenate([init, mid, fin], axis=0), axis=2)
        sums += speed.sum(0)
        count += speed.shape[0]
    return (sums / max(count, 1)).astype(np.float32)


@torch.no_grad()
def compute_mean_velocity_from_clips(clips: list[dict], smplx_model, fps: int = 30, chunk: int = 512) -> np.ndarray:
    """The (55,) mean joint speed of cached clips (their poses, betas,
    translations and, when 100-wide, expressions) through the SMPL-X joint
    FK on the model's device in full f32, ``chunk`` frames at a time."""
    dev = smplx_model.device
    joints_per_clip = []
    for c in clips:
        poses = torch.as_tensor(np.asarray(c["poses"], np.float32), device=dev)
        n = poses.shape[0]
        betas = torch.as_tensor(np.asarray(c["betas"], np.float32).reshape(1, -1), device=dev).expand(n, -1)
        trans = torch.as_tensor(np.asarray(c["trans"], np.float32), device=dev)
        exps = c.get("facial")
        exps = (torch.as_tensor(np.asarray(exps, np.float32)[:, :100], device=dev)
                if exps is not None and exps.shape[1] >= 100 else None)
        with full_f32():
            joints = [forward_joints(smplx_model, poses[s : s + chunk], betas[s : s + chunk], trans[s : s + chunk],
                                     None if exps is None else exps[s : s + chunk]) for s in range(0, n, chunk)]
        joints_per_clip.append(torch.cat(joints).cpu().numpy())
    return compute_mean_joint_velocity(joints_per_clip, fps=fps)
