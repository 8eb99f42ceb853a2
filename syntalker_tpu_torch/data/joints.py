"""SMPL-X joint tables and body-part feature indices.

A copy of the tables in ``syntalker_tpu/data/joints.py`` (the port keeps its
own so that it never imports the JAX package). 55 pose joints, 165
axis-angle dof, 330 rot6d dims, the SMPL-X kinematic tree ``PARENTS``
(here, with numpy alone, so that the renderer's worker processes import no
torch; ``ops/smplx.py`` re-exports it); three generated body parts (upper, hands,
lower + root translation velocity) whose 512-d latents concatenate to the
1536-d diffusion latent; the per-part gather indices in rot6d and in
axis-angle space, their boolean masks, and ``scatter_part``, the inverse
of a part's gather.
"""

from __future__ import annotations

import numpy as np

NUM_JOINTS = 55
AXIS_ANGLE_DIM = NUM_JOINTS * 3  # 165

JOINT_NAMES = (
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot", "right_foot",
    "neck", "left_collar", "right_collar", "head", "left_shoulder",
    "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist",
    "jaw", "left_eye_smplhf", "right_eye_smplhf",
    "left_index1", "left_index2", "left_index3",
    "left_middle1", "left_middle2", "left_middle3",
    "left_pinky1", "left_pinky2", "left_pinky3",
    "left_ring1", "left_ring2", "left_ring3",
    "left_thumb1", "left_thumb2", "left_thumb3",
    "right_index1", "right_index2", "right_index3",
    "right_middle1", "right_middle2", "right_middle3",
    "right_pinky1", "right_pinky2", "right_pinky3",
    "right_ring1", "right_ring2", "right_ring3",
    "right_thumb1", "right_thumb2", "right_thumb3",
)
assert len(JOINT_NAMES) == NUM_JOINTS
ROT6D_DIM = NUM_JOINTS * 6  # 330

# SMPL-X kinematic tree: parent index per joint (pelvis = -1), the
# kintree_table of SMPLX_NEUTRAL_2020.npz
PARENTS = np.array(
    [
        -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
        18, 19, 15, 15, 15,
        20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
        21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
    ],
    dtype=np.int32,
)

UPPER_JOINTS = (3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21)
HANDS_JOINTS = tuple(range(25, 55))
LOWER_JOINTS = (0, 1, 2, 4, 5, 7, 8, 10, 11)
FACE_JOINTS = (22,)  # jaw; eyes (23, 24) are never modeled
BEAT_ALIGN_UPPER_JOINTS = UPPER_JOINTS  # the joints BeatAlign scores

UPPER_JOINT_COUNT = len(UPPER_JOINTS)  # 13
HANDS_JOINT_COUNT = len(HANDS_JOINTS)  # 30
LOWER_JOINT_COUNT = len(LOWER_JOINTS)  # 9

UPPER_DIM = UPPER_JOINT_COUNT * 6  # 78
HANDS_DIM = HANDS_JOINT_COUNT * 6  # 180
LOWER_DIM = LOWER_JOINT_COUNT * 6  # 54
LOWER_TRANS_DIM = LOWER_DIM + 3  # 57 (with translation velocity)

LATENT_DIM_PER_PART = 512
NUM_PARTS = 3
LATENT_DIM = LATENT_DIM_PER_PART * NUM_PARTS  # 1536
LATENT_SLICES = {
    "upper": (0, 512),
    "hands": (512, 1024),
    "lower": (1024, 1536),
}
PART_DIMS = {"upper": UPPER_DIM, "hands": HANDS_DIM, "lower": LOWER_TRANS_DIM}


def _feature_indices(joint_ids, per_joint: int) -> np.ndarray:
    """Flat feature indices covering `per_joint` consecutive dims per joint."""
    idx = []
    for j in joint_ids:
        idx.extend(range(j * per_joint, (j + 1) * per_joint))
    return np.asarray(idx, dtype=np.int64)


# rot6d-space (330-dim) gather indices per part
UPPER_6D_IDX = _feature_indices(UPPER_JOINTS, 6)
HANDS_6D_IDX = _feature_indices(HANDS_JOINTS, 6)
LOWER_6D_IDX = _feature_indices(LOWER_JOINTS, 6)

# axis-angle-space (165-dim) gather indices per part
UPPER_AA_IDX = _feature_indices(UPPER_JOINTS, 3)
HANDS_AA_IDX = _feature_indices(HANDS_JOINTS, 3)
LOWER_AA_IDX = _feature_indices(LOWER_JOINTS, 3)
FACE_AA_IDX = _feature_indices(FACE_JOINTS, 3)  # jaw = dims 66:69


def boolean_mask(indices: np.ndarray, dim: int) -> np.ndarray:
    m = np.zeros(dim, dtype=bool)
    m[indices] = True
    return m


# boolean masks of the reference's joint_mask_* arrays
JOINT_MASK_UPPER = boolean_mask(UPPER_AA_IDX, AXIS_ANGLE_DIM)
JOINT_MASK_HANDS = boolean_mask(HANDS_AA_IDX, AXIS_ANGLE_DIM)
JOINT_MASK_LOWER = boolean_mask(LOWER_AA_IDX, AXIS_ANGLE_DIM)
JOINT_MASK_FACE = boolean_mask(FACE_AA_IDX, AXIS_ANGLE_DIM)


def scatter_part(part_features, indices: np.ndarray, dim: int):
    """A part's features (..., len(indices)) scattered into zeros of
    (..., dim): the inverse of the part's gather. Takes a numpy array or a
    torch tensor and returns the same kind."""
    out_shape = part_features.shape[:-1] + (dim,)
    if isinstance(part_features, np.ndarray):
        out = np.zeros(out_shape, dtype=part_features.dtype)
        out[..., indices] = part_features
        return out
    import torch

    out = part_features.new_zeros(out_shape)
    out[..., torch.as_tensor(indices, device=part_features.device)] = part_features
    return out
