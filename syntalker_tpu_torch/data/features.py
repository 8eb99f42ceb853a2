"""Pose featurization of the training data path: axis-angle -> per-part rot6d.

Counterpart of ``syntalker_tpu/data/features.py``: the 165-dof axis-angle
pose sliced into body parts, each part converted to 6D rotations, on the
tensor's device (the trainers run it inside the step, on the gathered
batch).
"""

from __future__ import annotations

from typing import Dict

import torch

from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.ops import rotations as rot


def _part_rot6d(pose_aa: torch.Tensor, idx, n_joints: int) -> torch.Tensor:
    b, t, _ = pose_aa.shape
    part = pose_aa[..., torch.as_tensor(idx, device=pose_aa.device)].reshape(b, t, n_joints, 3)
    return rot.axis_angle_to_rotation_6d(part).reshape(b, t, n_joints * 6)


def pose_to_part_rot6d(pose_aa: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B, T, 165) axis-angle -> per-part rot6d features: upper 78, hands
    180, lower 54, jaw 6 and full 330."""
    return {
        "upper": _part_rot6d(pose_aa, J.UPPER_AA_IDX, J.UPPER_JOINT_COUNT),
        "hands": _part_rot6d(pose_aa, J.HANDS_AA_IDX, J.HANDS_JOINT_COUNT),
        "lower": _part_rot6d(pose_aa, J.LOWER_AA_IDX, J.LOWER_JOINT_COUNT),
        "jaw": _part_rot6d(pose_aa, J.FACE_AA_IDX, 1),
        "full": rot.axis_angle_to_rotation_6d(
            pose_aa.reshape(*pose_aa.shape[:-1], J.NUM_JOINTS, 3)
        ).reshape(*pose_aa.shape[:-1], J.ROT6D_DIM),
    }
