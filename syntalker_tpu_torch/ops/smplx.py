"""SMPL-X body model: forward kinematics and linear blend skinning.

Counterpart of ``syntalker_tpu/ops/smplx.py``: the joints-only FK path
(foot contacts, BeatAlign, L1Div and SRGR need no vertices) and the full
LBS path (the face-vertex metrics). ``SMPLXModel`` holds the model's arrays
as tensors on one device; they come in as numpy, from the released
``SMPLX_*.npz`` (:func:`load_smplx_npz`) or from
:func:`synthetic_smplx_model`, the same seeded stand-in skeleton as JAX's.
Everything is batched and runs on the model's device. The FK chain is a
loop over the 55 joints (two small products each). The callers run these
functions under :func:`~syntalker_tpu_torch.device.full_f32`: TF32 rounds the
operands of a product to 10 mantissa bits, which moves joints enough to
flip a foot contact at its 0.01 threshold.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from syntalker_tpu_torch.data.joints import PARENTS
from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.ops import rotations as rot

NUM_JOINTS = 55

FOOT_JOINTS = (7, 8, 10, 11)  # ankles and feet, the contact labels' joints


@dataclasses.dataclass(frozen=True)
class SMPLXModel:
    """The model's arrays as float32 tensors on one device."""

    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, n_shape + n_expr)
    posedirs: torch.Tensor  # (P, V*3) pose blendshape basis
    j_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    parents: np.ndarray = dataclasses.field(default_factory=lambda: PARENTS)
    num_betas: int = 300
    num_expr: int = 100

    @classmethod
    def from_numpy(cls, *, v_template, shapedirs, posedirs, j_regressor, lbs_weights, parents=PARENTS,
                   num_betas: int = 300, num_expr: int = 100, device=None) -> "SMPLXModel":
        device = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(t(v_template), t(shapedirs), t(posedirs), t(j_regressor), t(lbs_weights),
                   np.asarray(parents, np.int32), num_betas, num_expr)

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> "SMPLXModel":
        move = {f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **move)


def load_smplx_npz(path: str | Path, num_betas: int = 300, num_expr: int = 100, *, device=None) -> SMPLXModel:
    """The released SMPL-X npz (e.g. SMPLX_NEUTRAL_2020.npz): its 400
    shape+expression directions sliced to ``num_betas`` + ``num_expr``, the
    (V, 3, P) pose directions flattened to (P, V*3), the first 55 joints."""
    d = np.load(path, allow_pickle=True)
    shapedirs = np.asarray(d["shapedirs"], np.float32)
    if shapedirs.shape[-1] > 300:
        sd = np.concatenate([shapedirs[..., :num_betas], shapedirs[..., 300 : 300 + num_expr]], axis=-1)
    else:
        sd = shapedirs[..., : min(num_betas, shapedirs.shape[-1])]
    posedirs = np.asarray(d["posedirs"], np.float32)
    if posedirs.ndim == 3:  # (V, 3, P) -> (P, V*3)
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
    parents = np.asarray(d["kintree_table"], np.int64)[0, :NUM_JOINTS].astype(np.int32)
    parents[0] = -1
    return SMPLXModel.from_numpy(
        v_template=d["v_template"], shapedirs=sd, posedirs=posedirs,
        j_regressor=np.asarray(d["J_regressor"], np.float32)[:NUM_JOINTS],
        lbs_weights=np.asarray(d["weights"], np.float32)[:, :NUM_JOINTS], parents=parents,
        num_betas=num_betas, num_expr=num_expr, device=device)


def synthetic_smplx_model(verts_per_joint: int = 4, seed: int = 0, num_betas: int = 300, num_expr: int = 100, *,
                          device=None) -> SMPLXModel:
    """The stand-in model of JAX's package, array for array (same numpy
    draws): ``verts_per_joint`` vertices rigidly attached around each joint
    of a randomized rest skeleton, zero pose directions."""
    rng = np.random.default_rng(seed)
    rest = np.zeros((NUM_JOINTS, 3), np.float32)
    for j in range(1, NUM_JOINTS):
        rest[j] = rest[PARENTS[j]] + rng.normal(0, 0.08, 3).astype(np.float32)
    v = NUM_JOINTS * verts_per_joint
    v_template = np.repeat(rest, verts_per_joint, axis=0) + rng.normal(0, 0.02, (v, 3)).astype(np.float32)
    jreg = np.zeros((NUM_JOINTS, v), np.float32)
    weights = np.zeros((v, NUM_JOINTS), np.float32)
    for j in range(NUM_JOINTS):
        sl = slice(j * verts_per_joint, (j + 1) * verts_per_joint)
        jreg[j, sl] = 1.0 / verts_per_joint
        weights[sl, j] = 1.0
    return SMPLXModel.from_numpy(
        v_template=v_template, shapedirs=rng.normal(0, 1e-4, (v, 3, num_betas + num_expr)).astype(np.float32),
        posedirs=np.zeros(((NUM_JOINTS - 1) * 9, v * 3), np.float32), j_regressor=jreg, lbs_weights=weights,
        num_betas=num_betas, num_expr=num_expr, device=device)


def rest_joints(model: SMPLXModel, betas: torch.Tensor, expressions: Optional[torch.Tensor] = None):
    """Shaped rest-pose joints (B, J, 3) and vertices (B, V, 3)."""
    coeffs = betas if expressions is None else torch.cat([betas, expressions], dim=-1)
    v_shaped = model.v_template + torch.einsum("vcs,bs->bvc", model.shapedirs[..., : coeffs.shape[-1]], coeffs)
    return torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped), v_shaped


def forward_kinematics(rest: torch.Tensor, pose_aa: torch.Tensor, trans: Optional[torch.Tensor] = None,
                       parents: np.ndarray = PARENTS):
    """Rigid FK down the kinematic tree: rest joints (B, J, 3), axis-angle
    (B, J, 3), translation (B, 3) -> (joints (B, J, 3), global rotations
    (B, J, 3, 3))."""
    R = rot.axis_angle_to_matrix(pose_aa)
    rots, pos = [R[:, 0]], [rest[:, 0]]
    for i in range(1, rest.shape[1]):
        p = int(parents[i])
        rots.append(rots[p] @ R[:, i])
        pos.append(pos[p] + (rots[p] @ (rest[:, i] - rest[:, p])[..., None])[..., 0])
    joints = torch.stack(pos, dim=1)
    if trans is not None:
        joints = joints + trans[:, None, :]
    return joints, torch.stack(rots, dim=1)


def relative_transforms(rest: torch.Tensor, joints: torch.Tensor, rot_global: torch.Tensor) -> torch.Tensor:
    """(B, J, 4, 4) skinning transforms: G_posed · G_rest⁻¹."""
    b, j, _ = rest.shape
    A = rest.new_zeros(b, j, 4, 4)
    A[..., :3, :3] = rot_global
    A[..., :3, 3] = joints - (rot_global @ rest[..., None])[..., 0]
    A[..., 3, 3] = 1.0
    return A


def _joint_pose(pose_aa: torch.Tensor) -> torch.Tensor:
    return pose_aa.reshape(pose_aa.shape[0], -1, 3) if pose_aa.ndim == 2 else pose_aa


def forward_joints(model: SMPLXModel, pose_aa: torch.Tensor, betas: torch.Tensor,
                   trans: Optional[torch.Tensor] = None, expressions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Joints-only FK: pose (B, 165) or (B, 55, 3), betas (B, num_betas) ->
    (B, 55, 3), smplx's ``joints[:, :55]`` without the vertices."""
    rest, _ = rest_joints(model, betas, expressions)
    return forward_kinematics(rest, _joint_pose(pose_aa), trans, model.parents)[0]


def lbs(model: SMPLXModel, pose_aa: torch.Tensor, betas: torch.Tensor, trans: Optional[torch.Tensor] = None,
        expressions: Optional[torch.Tensor] = None) -> dict:
    """Full linear blend skinning -> {"vertices": (B, V, 3), "joints": (B,
    55, 3)}: shape blendshapes, pose-corrective blendshapes of the non-root
    rotations, FK, skinning. Holds (B, V, 4, 4) transforms at once."""
    pose_aa = _joint_pose(pose_aa)
    b = pose_aa.shape[0]
    rest, v_shaped = rest_joints(model, betas, expressions)
    joints, rot_global = forward_kinematics(rest, pose_aa, None, model.parents)
    R = rot.axis_angle_to_matrix(pose_aa)
    pose_feature = (R[:, 1:] - torch.eye(3, device=R.device)).reshape(b, -1)  # (B, (J-1)*9)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(b, -1, 3)
    T = torch.einsum("vj,bjik->bvik", model.lbs_weights, relative_transforms(rest, joints, rot_global))
    verts = (T[..., :3, :3] @ v_posed[..., None])[..., 0] + T[..., :3, 3]
    if trans is not None:
        verts = verts + trans[:, None, :]
        joints = joints + trans[:, None, :]
    return {"vertices": verts, "joints": joints}


def foot_contacts(model: SMPLXModel, pose_aa: torch.Tensor, betas: torch.Tensor, trans: torch.Tensor,
                  expressions: Optional[torch.Tensor] = None, threshold: float = 0.01) -> torch.Tensor:
    """Per-frame foot-contact labels (T, 4) of joints (7, 8, 10, 11): the
    inter-frame displacement below ``threshold``; the last frame counts as
    still."""
    feet = forward_joints(model, pose_aa, betas, trans, expressions)[:, FOOT_JOINTS, :]
    v = torch.linalg.norm(feet[1:] - feet[:-1], dim=-1)
    v = torch.cat([v, v.new_zeros(1, len(FOOT_JOINTS))], dim=0)
    return (v < threshold).float()
