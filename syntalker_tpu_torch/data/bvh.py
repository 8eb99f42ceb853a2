"""Minimal BVH mocap interchange (read/write).

Capability parity with the vendored ``dataloaders/pymo`` package's role in
the reference (BVH parsing for legacy data paths and FIDCalculator.load,
data_tools.py; pymo/parsers.py + writers.py): hierarchy parsing, motion
frames, and export of our SMPL-X joint animations to BVH for DCC tools.
Euler conventions follow BVH's per-channel ordering.

Counterpart of ``syntalker_tpu/data/bvh.py``, the same numpy/scipy code
(the port keeps its own copy); :func:`smplx_to_bvh` converts axis-angle
through the port's :mod:`~syntalker_tpu_torch.ops.rotations` on the CPU.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class BVHJoint:
    name: str
    parent: int  # -1 for root
    offset: np.ndarray  # (3,)
    channels: List[str]


@dataclasses.dataclass
class BVHData:
    joints: List[BVHJoint]
    frames: np.ndarray  # (T, total_channels)
    frame_time: float

    @property
    def fps(self) -> float:
        return 1.0 / self.frame_time


def parse_bvh(path: str | Path) -> BVHData:
    text = Path(path).read_text().split()
    i = 0
    joints: List[BVHJoint] = []
    stack: List[int] = []

    def expect(tok):
        nonlocal i
        assert text[i].upper() == tok, (text[i], tok)
        i += 1

    expect("HIERARCHY")
    while i < len(text):
        tok = text[i].upper()
        if tok in ("ROOT", "JOINT"):
            i += 1
            name = text[i]
            i += 1
            expect("{")
            assert text[i].upper() == "OFFSET"
            i += 1
            offset = np.array([float(text[i + k]) for k in range(3)])
            i += 3
            assert text[i].upper() == "CHANNELS"
            i += 1
            nch = int(text[i])
            i += 1
            channels = [text[i + k] for k in range(nch)]
            i += nch
            parent = stack[-1] if stack else -1
            joints.append(BVHJoint(name, parent, offset, channels))
            stack.append(len(joints) - 1)
        elif tok == "END":  # End Site
            i += 2  # 'End' 'Site'
            expect("{")
            assert text[i].upper() == "OFFSET"
            i += 4  # OFFSET x y z
            expect("}")
        elif tok == "}":
            i += 1
            stack.pop()
        elif tok == "MOTION":
            i += 1
            break
        else:
            raise ValueError(f"unexpected token {text[i]}")

    assert text[i].upper() == "FRAMES:"
    i += 1
    n_frames = int(text[i])
    i += 1
    assert text[i].upper() == "FRAME" and text[i + 1].upper() == "TIME:"
    i += 2
    frame_time = float(text[i])
    i += 1
    total_ch = sum(len(j.channels) for j in joints)
    vals = np.array([float(v) for v in text[i : i + n_frames * total_ch]])
    return BVHData(joints, vals.reshape(n_frames, total_ch), frame_time)


def write_bvh(
    path: str | Path,
    parents: np.ndarray,
    names: List[str],
    offsets: np.ndarray,  # (J, 3) rest offsets from parent
    rotations_deg: np.ndarray,  # (T, J, 3) euler ZXY degrees
    root_positions: np.ndarray,  # (T, 3)
    fps: float = 30.0,
):
    """Write a skeleton animation as BVH (root: pos+rot, others: rot)."""
    j = len(names)
    children: Dict[int, List[int]] = {i: [] for i in range(-1, j)}
    for c in range(j):
        children[int(parents[c])].append(c)

    lines: List[str] = ["HIERARCHY"]

    def emit(idx: int, depth: int):
        ind = "  " * depth
        kind = "ROOT" if parents[idx] < 0 else "JOINT"
        lines.append(f"{ind}{kind} {names[idx]}")
        lines.append(f"{ind}{{")
        o = offsets[idx]
        lines.append(f"{ind}  OFFSET {o[0]:.6f} {o[1]:.6f} {o[2]:.6f}")
        if parents[idx] < 0:
            lines.append(
                f"{ind}  CHANNELS 6 Xposition Yposition Zposition "
                "Zrotation Xrotation Yrotation"
            )
        else:
            lines.append(f"{ind}  CHANNELS 3 Zrotation Xrotation Yrotation")
        kids = children[idx]
        if not kids:
            lines.append(f"{ind}  End Site")
            lines.append(f"{ind}  {{")
            lines.append(f"{ind}    OFFSET 0.0 0.0 0.0")
            lines.append(f"{ind}  }}")
        for k in kids:
            emit(k, depth + 1)
        lines.append(f"{ind}}}")

    roots = children[-1]
    for r in roots:
        emit(r, 0)

    t = rotations_deg.shape[0]
    lines.append("MOTION")
    lines.append(f"Frames: {t}")
    lines.append(f"Frame Time: {1.0 / fps:.8f}")
    # channel order follows the hierarchy emission order (DFS)
    order: List[int] = []

    def dfs(idx):
        order.append(idx)
        for k in children[idx]:
            dfs(k)

    for r in roots:
        dfs(r)

    for f in range(t):
        vals: List[str] = []
        for idx in order:
            rz, rx, ry = rotations_deg[f, idx]
            if parents[idx] < 0:
                p = root_positions[f]
                vals += [f"{p[0]:.6f}", f"{p[1]:.6f}", f"{p[2]:.6f}"]
            vals += [f"{rz:.6f}", f"{rx:.6f}", f"{ry:.6f}"]
        lines.append(" ".join(vals))

    Path(path).write_text("\n".join(lines) + "\n")
    return Path(path)


def bvh_to_positions(data: BVHData) -> np.ndarray:
    """BVH channels -> world joint positions, (T, J, 3).

    The ``MocapParameterizer('position')`` surface of the vendored pymo
    (dataloaders/pymo/preprocessing.py; used by FIDCalculator.load,
    data_tools.py:1579-1586): forward kinematics through the hierarchy with
    each joint's own channel rotation order applied intrinsically, position
    channels honored wherever they appear (root, usually).
    """
    from scipy.spatial.transform import Rotation

    t = data.frames.shape[0]
    j = len(data.joints)
    pos = np.zeros((t, j, 3))
    rot = np.tile(np.eye(3), (t, j, 1, 1))

    # channel slices per joint in frame order
    starts = np.cumsum([0] + [len(jt.channels) for jt in data.joints])
    for idx, joint in enumerate(data.joints):
        ch = data.frames[:, starts[idx] : starts[idx + 1]]
        order = ""
        angles = []
        offset_pos = np.zeros((t, 3))
        for k, name in enumerate(joint.channels):
            axis = name[0].upper()
            if name.lower().endswith("rotation"):
                order += axis
                angles.append(ch[:, k])
            else:  # Xposition etc.
                offset_pos[:, "XYZ".index(axis)] = ch[:, k]
        local = (
            Rotation.from_euler(order, np.stack(angles, -1), degrees=True).as_matrix()
            if order
            else np.tile(np.eye(3), (t, 1, 1))
        )
        if joint.parent < 0:
            rot[:, idx] = local
            pos[:, idx] = joint.offset[None] + offset_pos
        else:
            p = joint.parent
            rot[:, idx] = rot[:, p] @ local
            pos[:, idx] = pos[:, p] + np.einsum(
                "tab,b->ta", rot[:, p], joint.offset
            ) + np.einsum("tab,tb->ta", rot[:, p], offset_pos)
    return pos


def matrix_to_euler_zxy_deg(m: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotation matrices -> ZXY intrinsic euler degrees,
    matching the channel order written by :func:`write_bvh`."""
    from scipy.spatial.transform import Rotation

    flat = m.reshape(-1, 3, 3)
    eul = Rotation.from_matrix(flat).as_euler("ZXY", degrees=True)
    return eul.reshape(m.shape[:-2] + (3,))


def smplx_to_bvh(
    pose_aa: np.ndarray,  # (T, 165)
    trans: np.ndarray,  # (T, 3)
    rest_offsets: np.ndarray,  # (55, 3)
    out_path: str | Path,
    fps: float = 30.0,
):
    """Export an SMPL-X axis-angle animation to BVH."""
    import torch

    from syntalker_tpu_torch.data.joints import JOINT_NAMES
    from syntalker_tpu_torch.ops import rotations as R
    from syntalker_tpu_torch.ops.smplx import PARENTS

    t = pose_aa.shape[0]
    aa = torch.as_tensor(np.asarray(pose_aa, np.float32).reshape(t, 55, 3))
    m = R.axis_angle_to_matrix(aa).numpy()
    eul = matrix_to_euler_zxy_deg(m)
    return write_bvh(
        out_path, PARENTS, list(JOINT_NAMES), rest_offsets, eul, trans, fps
    )
