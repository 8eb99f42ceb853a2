"""The port's stick-figure renderer against the JAX package's, on the CPU.

Six frames of a random skeleton drawn serially and by two spawned workers:
six frames each, and every decoded frame equal to the one JAX's
``render_stick_figure`` draws from the same joints (a GIF where imageio
has no ffmpeg plugin). ``render_npz(device="cpu")``: the joints it draws
within 1e-5 relative of JAX's forward kinematics on the same npz (the
synthetic SMPL-X model in both; f32, sums in another order). The
``generate --render`` CLI path is in ``test_torch_generate_cli.py``
(``test_render_is_refused``), the demo in ``test_torch_demo.py``."""

import imageio
import jax.numpy as jnp
import numpy as np
import pytest

from syntalker_tpu import render as JR
from syntalker_tpu.ops import smplx as JS
from syntalker_tpu_torch import render as R
from syntalker_tpu_torch.data.joints import PARENTS
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

FK_REL = 1e-5


@pytest.fixture(scope="module")
def joints():
    """The JAX renderer test's skeleton: random bones, drifting along x."""
    rng = np.random.default_rng(0)
    rest = np.zeros((55, 3), np.float32)
    for j in range(1, 55):
        rest[j] = rest[PARENTS[j]] + rng.normal(0, 0.1, 3)
    out = np.tile(rest, (6, 1, 1))
    out[:, :, 0] += np.linspace(0, 0.5, 6)[:, None]
    return out


def test_serial_and_parallel_frames_are_jaxs(joints, tmp_path):
    ref = imageio.mimread(JR.render_stick_figure(joints, tmp_path / "jax", fps=10))
    serial = R.render_stick_figure(joints, tmp_path / "serial", fps=10)
    parallel = R.render_stick_figure_parallel(joints, tmp_path / "parallel", fps=10, workers=2)
    assert serial.suffix in (".mp4", ".gif") and parallel.suffix == serial.suffix
    for path in (serial, parallel):
        frames = imageio.mimread(path)
        assert len(frames) == len(ref) == 6
        assert all(np.array_equal(a, b) for a, b in zip(frames, ref)), path


def test_render_npz_draws_jaxs_joints(tmp_path, monkeypatch):
    g = np.random.default_rng(1)
    n = 4
    poses = g.normal(0, 0.3, (n, 165)).astype(np.float32)
    trans = g.normal(0, 0.1, (n, 3)).astype(np.float32)
    betas = g.normal(0, 0.5, 300).astype(np.float32)
    np.savez(tmp_path / "clip.npz", poses=poses, trans=trans, betas=betas)
    drawn = []

    def capture(j, out_path, **kw):
        drawn.append((j, kw))
        return render(j, out_path, **kw)

    render = R.render_stick_figure
    monkeypatch.setattr(R, "render_stick_figure", capture)
    video = R.render_npz(tmp_path / "clip.npz", tmp_path / "clip", device="cpu")
    assert video.exists() and len(imageio.mimread(video)) == n
    ref = np.asarray(JS.forward_joints(JS.synthetic_smplx_model(), jnp.asarray(poses),
                                       jnp.asarray(np.tile(betas[None], (n, 1))), jnp.asarray(trans)))
    (got, kw), = drawn
    assert got.shape == (n, 55, 3) and kw["title"] == "clip"
    assert np.abs(got - ref).max() / np.abs(ref).max() < FK_REL
