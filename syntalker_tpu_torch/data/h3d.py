"""HumanML3D-style 623-dim motion representation for SMPL-X (52 joints).

Counterpart of ``syntalker_tpu/data/h3d.py``: the 623-dim layout and its
body-part feature indices (``part_mask_623``), the recovery of global
joint positions from the features (``recover_root_rot_pos``,
``recover_from_ric``), and the features built from an SMPL-X pose through
the port's forward kinematics (``h3d_features_from_pose``,
``build_h3d_features``), on torch tensors.

Layout (dims):
  [0]        root rotation velocity (y half-angle per frame)
  [1:3]      root xz linear velocity (root frame)
  [3]        root height
  [4:157]    51 non-root local joint positions (xyz, root frame)
  [157:463]  51 non-root local joint rotations (6d)
  [463:619]  52 joint velocities (xyz, root frame)
  [619:623]  foot contacts
"""

from __future__ import annotations

import numpy as np
import torch

from syntalker_tpu_torch.ops import rotations as R
from syntalker_tpu_torch.ops import smplx as S

H3D_DIM = 623
NUM_H3D_JOINTS = 52  # 55 minus jaw + eyes
# 52-joint selection out of the SMPL-X 55 (drop jaw 22, eyes 23/24)
H3D_JOINT_SELECTION = tuple(range(22)) + tuple(range(25, 55))

ROOT_SLICE = (0, 4)
POS_SLICE = (4, 4 + 51 * 3)  # 157
ROT_SLICE = (157, 157 + 51 * 6)  # 463
VEL_SLICE = (463, 463 + 52 * 3)  # 619
CONTACT_SLICE = (619, 623)

UPPER_JOINTS_52 = (3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21)
HANDS_JOINTS_52 = tuple(range(22, 52))
LOWER_JOINTS_52 = (0, 1, 2, 4, 5, 7, 8, 10, 11)

H3D_PART_DIMS = {"upper": 156, "hands": 360, "lower": 107}


def _joint_feature_dims(i: int) -> list[int]:
    dims = []
    if i > 0:
        dims += list(range(4 + (i - 1) * 3, 4 + (i - 1) * 3 + 3))
        dims += list(range(4 + 51 * 3 + (i - 1) * 6, 4 + 51 * 3 + (i - 1) * 6 + 6))
    dims += list(range(4 + 51 * 9 + i * 3, 4 + 51 * 9 + i * 3 + 3))
    return dims


def part_mask_623(part: str) -> np.ndarray:
    """Feature indices of one body part in the 623-dim vector: its joints'
    positions, rotations and velocities; the lower part adds the root
    channels and the contacts, sorted."""
    if part == "upper":
        joints, extra = UPPER_JOINTS_52, []
    elif part == "hands":
        joints, extra = HANDS_JOINTS_52, []
    elif part in ("lower", "lower_trans"):
        joints, extra = LOWER_JOINTS_52, list(range(0, 4)) + list(range(619, 623))
    else:
        raise ValueError(part)
    dims = list(extra)
    for i in joints:
        dims.extend(_joint_feature_dims(i))
    return np.asarray(sorted(set(dims)) if part.startswith("lower") else dims, np.int32)


# ---------------------------------------------------------------------------
# recovery


def _qinv(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def _qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4) (w, x, y, z)."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2 * (q[..., :1] * uv + uuv)


def recover_root_rot_pos(data: torch.Tensor):
    """Integrate the root yaw and velocity channels -> (quaternion (..., T,
    4), position (..., T, 3))."""
    rot_vel = data[..., 0]
    r_rot_ang = torch.cumsum(torch.cat([torch.zeros_like(rot_vel[..., :1]), rot_vel[..., :-1]], dim=-1), dim=-1)
    zeros = torch.zeros_like(r_rot_ang)
    r_rot_quat = torch.stack([torch.cos(r_rot_ang), zeros, torch.sin(r_rot_ang), zeros], dim=-1)
    vel_xz = torch.cat([torch.zeros_like(data[..., :1, 1:3]), data[..., :-1, 1:3]], dim=-2)
    r_pos = torch.stack([vel_xz[..., 0], torch.zeros_like(vel_xz[..., 0]), vel_xz[..., 1]], dim=-1)
    r_pos = torch.cumsum(_qrot(_qinv(r_rot_quat), r_pos), dim=-2)
    r_pos = torch.cat([r_pos[..., :1], data[..., 3:4], r_pos[..., 2:]], dim=-1)
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int = NUM_H3D_JOINTS) -> torch.Tensor:
    """623-dim features (..., T, 623) -> global joint positions (..., T, J, 3)."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4 : (joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    q = _qinv(r_rot_quat)[..., None, :].expand(positions.shape[:-1] + (4,))
    positions = _qrot(q, positions)
    positions = positions + torch.stack([r_pos[..., 0], torch.zeros_like(r_pos[..., 0]), r_pos[..., 2]],
                                        dim=-1)[..., None, :]
    return torch.cat([r_pos[..., None, :], positions], dim=-2)


# ---------------------------------------------------------------------------
# construction


def h3d_features_from_pose(pose_aa: torch.Tensor, betas: torch.Tensor, trans: torch.Tensor, smplx_model,
                           contacts: torch.Tensor) -> torch.Tensor:
    """SMPL-X pose (T, 165), betas (300,), translation (T, 3) and contacts
    (T, 4) -> (T, 623) features, the joints from the port's FK."""
    t = pose_aa.shape[0]
    sel = torch.as_tensor(H3D_JOINT_SELECTION, device=pose_aa.device)
    joints = S.forward_joints(smplx_model, pose_aa, betas[None].expand(t, -1), trans)[:, sel]
    rot6d = R.axis_angle_to_rotation_6d(pose_aa.reshape(t, 55, 3)[:, sel[1:]])  # (T, 51, 6)
    return build_h3d_features(joints, rot6d, contacts)


def build_h3d_features(joints: torch.Tensor, rotations_6d: torch.Tensor, contacts: torch.Tensor) -> torch.Tensor:
    """The 623-dim representation from global joint positions (T, 52, 3,
    y up), local non-root rotations (T, 51, 6) and contacts (T, 4): the
    inverse of :func:`recover_from_ric` up to the yaw decomposition. The
    root yaw is the heading of the hip axis on the ground plane; channel 0
    holds its half-angle increments, unwrapped."""
    t = joints.shape[0]
    root = joints[:, 0]

    across = joints[:, 2] - joints[:, 1]  # right_hip - left_hip
    heading = torch.atan2(across[:, 0], across[:, 2])
    d = heading[1:] - heading[:-1]
    d = torch.atan2(torch.sin(d), torch.cos(d))  # wrapped increments
    phi = 0.5 * torch.cat([d.new_zeros(1), torch.cumsum(d, dim=0)])
    zeros = torch.zeros_like(phi)
    r_quat = torch.stack([torch.cos(phi), zeros, torch.sin(phi), zeros], dim=-1)
    rot_vel = torch.cat([phi[1:] - phi[:-1], phi.new_zeros(1)])

    xz = root.new_tensor([1.0, 0.0, 1.0])
    root = root - root[0] * xz  # the xz path starts at the origin

    # v_t maps root_t -> root_{t+1}, in frame t+1 (recover applies qinv(quat_{t+1}))
    vel_local = _qrot(r_quat[1:], root[1:] - root[:-1])
    vel_local = torch.cat([vel_local, vel_local.new_zeros(1, 3)])
    root_feats = torch.stack([rot_vel, vel_local[:, 0], vel_local[:, 2], root[:, 1]], dim=-1)

    # local positions: root xz removed, absolute height kept
    local = joints[:, 1:] - joints[:, :1] * xz
    local = _qrot(r_quat[:, None, :].expand(local.shape[:-1] + (4,)), local)
    jvel = torch.cat([joints[1:] - joints[:-1], joints.new_zeros(1, joints.shape[1], 3)])
    jvel = _qrot(r_quat[:, None, :].expand(jvel.shape[:-1] + (4,)), jvel)
    return torch.cat([root_feats, local.reshape(t, -1), rotations_6d.reshape(t, -1), jvel.reshape(t, -1), contacts],
                     dim=-1)
