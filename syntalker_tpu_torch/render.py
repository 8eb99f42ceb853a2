"""Stick-figure video of generated motion.

Counterpart of ``syntalker_tpu/render.py``: the SMPL-X joints of a motion
npz (forward kinematics on the device, ``ops/smplx.py``) drawn frame by
frame with matplotlib, serially or in a pool of spawned worker processes,
and encoded with imageio: mp4 through its ffmpeg plugin where that is
installed, else a GIF. The frames equal JAX's pixel for pixel on the same
joints. torch, matplotlib and imageio are imported inside the functions
that use them, so that the workers import neither torch nor the device
code.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np

from syntalker_tpu_torch.data.joints import PARENTS

log = logging.getLogger("syntalker")


def _frame_box(joints: np.ndarray):
    """The center and half-width of a cube that holds every frame."""
    center = joints.mean(axis=(0, 1))
    return center, float(np.abs(joints - center).max()) * 1.2 + 1e-6


def _render_chunk(args):
    """Worker: (joints (T, J, 3), parents, center, radius, figsize, title,
    index of the first frame) -> the frames as RGB arrays."""
    joints_chunk, parents, center, radius, figsize, title, offset = args
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = []
    fig = plt.figure(figsize=(figsize, figsize))
    ax = fig.add_subplot(111, projection="3d")
    for t in range(joints_chunk.shape[0]):
        ax.cla()
        ax.set_xlim(center[0] - radius, center[0] + radius)
        ax.set_ylim(center[2] - radius, center[2] + radius)
        ax.set_zlim(center[1] - radius, center[1] + radius)
        ax.set_axis_off()
        if title:
            ax.set_title(f"{title} f{offset + t}")
        j = joints_chunk[t]
        for c in range(1, len(parents)):
            p = parents[c]
            ax.plot([j[p, 0], j[c, 0]], [j[p, 2], j[c, 2]], [j[p, 1], j[c, 1]], "b-", lw=1.2)
        fig.canvas.draw()
        out.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
    plt.close(fig)
    return out


def render_stick_figure(joints: np.ndarray, out_path: str | Path, *, fps: int = 30, parents: np.ndarray = PARENTS,
                        figsize: int = 4, max_frames: Optional[int] = None, title: str = "") -> Path:
    """Joints (T, 55, 3) -> a 3D skeleton video (mp4, or GIF without ffmpeg)."""
    joints = np.asarray(joints)
    if max_frames:
        joints = joints[:max_frames]
    center, radius = _frame_box(joints)
    return write_video(_render_chunk((joints, parents, center, radius, figsize, title, 0)), out_path, fps=fps)


def render_stick_figure_parallel(joints: np.ndarray, out_path: str | Path, *, fps: int = 30,
                                 parents: np.ndarray = PARENTS, workers: int = 4, figsize: int = 4,
                                 title: str = "") -> Path:
    """:func:`render_stick_figure` with the frames drawn in ``workers``
    spawned processes, in contiguous chunks, then encoded here."""
    import multiprocessing as mp

    joints = np.asarray(joints)
    center, radius = _frame_box(joints)
    jobs = [(joints[c], parents, center, radius, figsize, title, int(c[0]))
            for c in np.array_split(np.arange(joints.shape[0]), workers) if len(c)]
    with mp.get_context("spawn").Pool(len(jobs)) as pool:
        chunks = pool.map(_render_chunk, jobs)
    return write_video([f for chunk in chunks for f in chunk], out_path, fps=fps)


def write_video(frames, out_path: str | Path, *, fps: int = 30) -> Path:
    """Encode frames to ``out_path``.mp4 when imageio has ffmpeg, else to
    ``out_path``.gif; returns the file written."""
    import imageio

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    try:
        imageio.mimwrite(out_path.with_suffix(".mp4"), frames, fps=fps)
        return out_path.with_suffix(".mp4")
    except (ValueError, RuntimeError, ImportError, OSError) as e:  # no ffmpeg backend, or no binary for it
        log.warning(f"mp4 encode unavailable ({e}); writing GIF")
        imageio.mimwrite(out_path.with_suffix(".gif"), frames, duration=1000.0 / min(fps, 25))
        return out_path.with_suffix(".gif")


def _npz_joints(npz_path: str | Path, *, smplx_model=None, max_frames: Optional[int] = None,
                device=None) -> np.ndarray:
    """The (T, 55, 3) SMPL-X joints of a motion npz (``poses``, ``trans``,
    ``betas``): forward kinematics in full f32 on ``device`` (CUDA unless
    ``"cpu"``), with ``smplx_model`` or the synthetic stand-in model."""
    import torch

    from syntalker_tpu_torch.device import full_f32, resolve_device
    from syntalker_tpu_torch.ops import smplx as S

    device = resolve_device(device)
    if smplx_model is None:
        smplx_model = S.synthetic_smplx_model(device=device)
    with np.load(npz_path, allow_pickle=True) as d:
        poses = np.asarray(d["poses"], np.float32)[:max_frames or None]
        n = poses.shape[0]
        betas = np.tile(np.asarray(d["betas"], np.float32).reshape(1, -1)[:, :300], (n, 1))
        trans = np.asarray(d["trans"], np.float32)[:n]
    with torch.no_grad(), full_f32():
        joints = S.forward_joints(smplx_model, *(torch.from_numpy(a).to(device) for a in (poses, betas, trans)))
    return joints.cpu().numpy()


def render_npz(npz_path: str | Path, out_path: str | Path, *, smplx_model=None, max_frames: Optional[int] = None,
               device=None) -> Path:
    """Motion npz (poses/trans/betas) -> skeleton video: the joints by
    :func:`_npz_joints` on the device, the drawing on the host."""
    joints = _npz_joints(npz_path, smplx_model=smplx_model, max_frames=max_frames, device=device)
    return render_stick_figure(joints, out_path, title=Path(npz_path).stem)
