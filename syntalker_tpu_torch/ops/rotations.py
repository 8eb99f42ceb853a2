"""Rotation conversions on torch tensors: axis-angle ↔ quaternion ↔
matrix ↔ 6D (Zhou et al.).

Counterpart of ``syntalker_tpu/ops/rotations.py`` for the decode path and
the training data path (``axis_angle_to_rotation_6d``): quaternions are (w,
x, y, z) with non-negative w; ``matrix_to_rotation_6d`` takes the first two
rows; ``rotation_6d_to_matrix`` Gram-Schmidt orthonormalizes rows; both
axis-angle ↔ quaternion maps keep the small-angle series of sin(θ/2)/θ;
``geodesic_distance`` is the angle between two rotation matrices.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors -> (..., 4) unit quaternions (w, x, y, z),
    with the series 0.5 - θ²/48 of sin(θ/2)/θ below θ = 1e-6."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angle * 0.5
    small = angle < 1e-6
    sin_half_over_angle = torch.where(
        small,
        0.5 - (angle * angle) / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angle), angle),
    )
    return torch.cat([torch.cos(half), axis_angle * sin_half_over_angle], dim=-1)


def quaternion_to_axis_angle(quaternion: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (w, x, y, z) -> (..., 3) rotation vectors."""
    norms = torch.linalg.norm(quaternion[..., 1:], dim=-1, keepdim=True)
    half_angle = torch.atan2(norms, quaternion[..., :1])
    angle = 2.0 * half_angle
    small = angle.abs() < 1e-6
    sin_half_over_angle = torch.where(
        small,
        0.5 - (angle * angle) / 48.0,
        torch.sin(half_angle) / torch.where(small, torch.ones_like(angle), angle),
    )
    return quaternion[..., 1:] / sin_half_over_angle.clamp_min(_EPS)


def quaternion_to_matrix(quaternion: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (w, x, y, z) -> (..., 3, 3) rotation matrices."""
    w, x, y, z = torch.unbind(quaternion, -1)
    two_s = 2.0 / (quaternion * quaternion).sum(-1)
    m = torch.stack(
        [
            1 - two_s * (y * y + z * z),
            two_s * (x * y - z * w),
            two_s * (x * z + y * w),
            two_s * (x * y + z * w),
            1 - two_s * (x * x + z * z),
            two_s * (y * z - x * w),
            two_s * (x * z - y * w),
            two_s * (y * z + x * w),
            1 - two_s * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(quaternion.shape[:-1] + (3, 3))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 4) quaternions (w, x, y, z),
    branch-free: all four candidates, the best-conditioned one selected."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs2 = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(q_abs2.clamp_min(0.0))
    cand = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    cand = cand / (2.0 * q_abs[..., None].clamp_min(0.1))
    best = q_abs2.argmax(dim=-1)
    index = best[..., None, None].expand(best.shape + (1, 4))
    quat = torch.gather(cand, -2, index)[..., 0, :]
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    return torch.where(quat[..., :1] < 0, -quat, quat)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors -> (..., 3, 3) matrices (via quaternion)."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) matrices -> (..., 3) rotation vectors (via quaternion)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): first two rows, flattened."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) via Gram-Schmidt on the two encoded rows."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(_EPS)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def axis_angle_to_rotation_6d(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 6), the training data path's features."""
    return matrix_to_rotation_6d(axis_angle_to_matrix(axis_angle))


def rotation_6d_to_axis_angle(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3), the decode path's rotations."""
    return matrix_to_axis_angle(rotation_6d_to_matrix(d6))


def geodesic_distance(m1: torch.Tensor, m2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle between rotation matrices (..., 3, 3) -> (...), the
    cosine clipped to [-1 + eps, 1 - eps] (the reference's GeodesicLoss)."""
    m = m1 @ m2.transpose(-1, -2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) * 0.5
    return torch.arccos(cos.clamp(-1.0 + eps, 1.0 - eps))
