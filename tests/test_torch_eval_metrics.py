"""The port's evaluation metrics and ``geodesic_distance`` against the JAX package, on the CPU.

``L1Div``, ``BeatAligner`` (its audio beats, its order-7 local minima
found with exact ``==``, GAHR and the score), ``SRGR`` and
``frechet_distance`` are the same numpy/scipy code in both packages: on
the same seeded arrays they are equal. ``geodesic_distance`` (torch
against jnp) holds to 1e-6 away from the clipped ends."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu.eval import metrics as JM
from syntalker_tpu.ops import rotations as JR
from syntalker_tpu_torch.eval import metrics as PM
from syntalker_tpu_torch.ops import rotations as PR
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)


def test_l1div_and_srgr_are_jaxs():
    g = np.random.default_rng(0)
    pl, jl = PM.L1Div(), JM.L1Div()
    ps, js = PM.SRGR(joints=55), JM.SRGR(joints=55)
    for n in (30, 47):
        joints, target = g.normal(size=(n, 165)), g.normal(size=(n, 165)) * 0.05
        sem = np.where(g.random(n) < 0.5, 0.0, g.random(n))
        pl.update(joints)
        jl.update(joints)
        assert ps.update(joints * 0.05, target, sem) == js.update(joints * 0.05, target, sem)
    assert pl.result() == jl.result() and ps.result() == js.result() and ps.result() > 0
    pl.reset()
    assert pl.result() == 0.0


def test_beat_aligner_is_jaxs():
    g = np.random.default_rng(1)
    mean_vel = g.uniform(0.02, 0.1, 55).astype(np.float32)
    p, j = PM.BeatAligner(mean_velocity=mean_vel), JM.BeatAligner(mean_velocity=mean_vel)
    t = np.arange(300) / 30.0
    # oscillating joints with plateaus: repeated speeds exercise the exact == of the minima
    joints = (np.sin(2 * np.pi * 1.3 * t)[:, None] * g.uniform(0.01, 0.2, 165)[None]).astype(np.float32)
    joints[100:110] = joints[100]
    beats_p, beats_j = p.motion_beats(joints, 60, 240), j.motion_beats(joints, 60, 240)
    assert len(beats_p) == 55 and sum(len(b) for b in beats_p) > 0
    for a, b in zip(beats_p, beats_j):
        np.testing.assert_array_equal(a, b)
    y = (g.normal(size=16000 * 4) * np.repeat(g.random(40) > 0.7, 1600)).astype(np.float32)
    onsets_p, onsets_j = p.audio_beats(y), j.audio_beats(y)
    np.testing.assert_array_equal(onsets_p, onsets_j)
    assert p.score(onsets_p, beats_p) == j.score(onsets_j, beats_j)
    assert PM.BeatAligner.gahr(np.array([0.1, 1.0]), np.array([0.2]), 0.3) == \
        JM.BeatAligner.gahr(np.array([0.1, 1.0]), np.array([0.2]), 0.3)
    assert p.score(np.zeros(0), beats_p) == 0.0


@pytest.mark.parametrize("n", (1, 40))
def test_frechet_distance_is_jaxs(n):
    g = np.random.default_rng(2)
    x, y = g.normal(size=(n, 24)), g.normal(0.3, 1.2, size=(n + 5, 24))
    assert PM.frechet_distance(x, y) == JM.frechet_distance(x, y)
    assert abs(PM.frechet_distance(x, x)) < 1e-6 * max(1.0, np.abs(x).max())


def test_geodesic_distance_matches_jax():
    g = np.random.default_rng(3)
    a, b = g.normal(0, 1.0, (64, 3)).astype(np.float32), g.normal(0, 1.0, (64, 3)).astype(np.float32)
    b[:4] = a[:4]  # identical rotations: the cosine clipped at 1 - eps
    ma, mb = PR.axis_angle_to_matrix(torch.as_tensor(a)), PR.axis_angle_to_matrix(torch.as_tensor(b))
    got = PR.geodesic_distance(ma, mb).numpy()
    ref = np.asarray(JR.geodesic_distance(jnp.asarray(ma.numpy()), jnp.asarray(mb.numpy())))
    np.testing.assert_allclose(got[4:], ref[4:], atol=1e-6)
    np.testing.assert_array_equal(got[:4] < 1e-3, ref[:4] < 1e-3)
