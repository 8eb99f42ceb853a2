"""The port's SMPL-X kinematics, h3d features and FK statistics against the JAX package, on the CPU.

The same seeded numpy inputs go through both packages:
``synthetic_smplx_model()`` (the same numpy draws on both sides) and a
model written in the release layout (400 shape+expression directions,
(V, 3, P) pose directions with non-zero values, ``kintree_table``), read by
each package's ``load_smplx_npz``. FK joints, rest joints and LBS
vertices hold to atol 1e-5; foot contacts are equal except at frames whose
displacement lies within 1e-6 of the 0.01 threshold; the mean joint
velocities hold to rel 1e-6; ``part_mask_623`` is equal and the h3d
features and their recovery hold to atol 1e-4; ``preprocess_clip`` with
the synthetic model on a ``make_corpus`` clip gives JAX's contacts and
h3d (atol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu.data import cache as JC
from syntalker_tpu.data import h3d as JH
from syntalker_tpu.data import stats as JST
from syntalker_tpu.ops import smplx as JS
from syntalker_tpu_torch.data import cache as PC
from syntalker_tpu_torch.data import h3d as PH
from syntalker_tpu_torch.data import stats as PST
from syntalker_tpu_torch.data.synthetic import make_corpus
from syntalker_tpu_torch.ops import smplx as PS
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

ATOL = 1e-5
H3D_ATOL = 1e-4
VPJ = 2  # vertices per joint of the release-layout model


def t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def release_npz(path, seed=3):
    """An SMPL-X npz in the release layout with random, small blendshapes."""
    base = JS.synthetic_smplx_model(verts_per_joint=VPJ, seed=seed)
    g = np.random.default_rng(seed)
    v = base.v_template.shape[0]
    np.savez(path, v_template=base.v_template, shapedirs=g.normal(0, 1e-3, (v, 3, 400)).astype(np.float32),
             posedirs=g.normal(0, 1e-3, (v, 3, 54 * 9)).astype(np.float32), J_regressor=base.j_regressor,
             weights=g.dirichlet(np.ones(55), v).astype(np.float32),
             kintree_table=np.stack([np.r_[np.int64(2**32 - 1), JS.PARENTS[1:].astype(np.int64)], np.arange(55)]))
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = release_npz(tmp_path_factory.mktemp("smplx") / "SMPLX_TEST.npz")
    return {"synthetic": (JS.synthetic_smplx_model(), PS.synthetic_smplx_model(device="cpu")),
            "release": (JS.load_smplx_npz(path), PS.load_smplx_npz(path, device="cpu"))}


def pose_inputs(b, seed=0, scale=0.4):
    g = np.random.default_rng(seed)
    return (g.normal(0, scale, (b, 165)).astype(np.float32), g.normal(0, 1.0, (b, 300)).astype(np.float32),
            g.normal(0, 0.5, (b, 3)).astype(np.float32), g.normal(0, 1.0, (b, 100)).astype(np.float32))


def test_release_layout_loads_as_jaxs(models):
    jm, pm = models["release"]
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(pm, name).numpy(), getattr(jm, name), err_msg=name)
    np.testing.assert_array_equal(pm.parents, jm.parents)
    assert pm.shapedirs.shape[-1] == 400 and pm.posedirs.shape == (54 * 9, 55 * VPJ * 3)
    assert (pm.num_betas, pm.num_expr) == (jm.num_betas, jm.num_expr)


@pytest.mark.parametrize("which", ("synthetic", "release"))
def test_fk_rest_joints_and_lbs_match_jax(models, which):
    jm, pm = models[which]
    pose, betas, trans, exps = pose_inputs(6)
    j_rest, j_vs = JS.rest_joints(jm, jnp.asarray(betas), jnp.asarray(exps))
    p_rest, p_vs = PS.rest_joints(pm, t(betas), t(exps))
    np.testing.assert_allclose(p_rest.numpy(), np.asarray(j_rest), atol=ATOL)
    np.testing.assert_allclose(p_vs.numpy(), np.asarray(j_vs), atol=ATOL)
    np.testing.assert_allclose(PS.forward_joints(pm, t(pose), t(betas), t(trans), t(exps)).numpy(),
                               np.asarray(JS.forward_joints(jm, jnp.asarray(pose), jnp.asarray(betas),
                                                            jnp.asarray(trans), jnp.asarray(exps))), atol=ATOL)
    ref = JS.lbs(jm, jnp.asarray(pose), jnp.asarray(betas), jnp.asarray(trans), jnp.asarray(exps))
    got = PS.lbs(pm, t(pose), t(betas), t(trans), t(exps))
    for k in ("vertices", "joints"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=ATOL, err_msg=k)
    jt = JS.relative_transforms(j_rest, *JS.forward_kinematics(j_rest, jnp.asarray(pose.reshape(6, 55, 3))))
    pt = PS.relative_transforms(p_rest, *PS.forward_kinematics(p_rest, t(pose.reshape(6, 55, 3))))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=ATOL)


def test_foot_contacts_match_jax_off_the_threshold(models):
    jm, pm = models["synthetic"]
    g = np.random.default_rng(4)
    n = 120
    # slow motion: per-frame foot displacements around the 0.01 threshold
    pose = np.cumsum(g.normal(0, 0.01, (n, 165)), axis=0).astype(np.float32)
    trans = np.cumsum(g.normal(0, 0.004, (n, 3)), axis=0).astype(np.float32)
    betas = np.tile(g.normal(0, 1, (1, 300)), (n, 1)).astype(np.float32)
    ref = np.asarray(JS.foot_contacts(jm, jnp.asarray(pose), jnp.asarray(betas), jnp.asarray(trans)))
    got = PS.foot_contacts(pm, t(pose), t(betas), t(trans)).numpy()
    feet = np.asarray(JS.forward_joints(jm, jnp.asarray(pose), jnp.asarray(betas), jnp.asarray(trans)))[:, (7, 8, 10, 11)]
    v = np.concatenate([np.linalg.norm(feet[1:] - feet[:-1], axis=-1), np.zeros((1, 4))])
    near = np.abs(v - 0.01) < 1e-6
    assert 0.1 < ref.mean() < 0.9  # both labels occur
    np.testing.assert_array_equal(got[~near], ref[~near])


def test_mean_joint_velocity_matches_jax(models):
    jm, pm = models["synthetic"]
    g = np.random.default_rng(5)
    clips = []
    for n in (40, 70):
        clips.append({"poses": np.cumsum(g.normal(0, 0.03, (n, 165)), axis=0).astype(np.float32),
                      "betas": g.normal(0, 1, 300).astype(np.float32),
                      "trans": np.cumsum(g.normal(0, 0.01, (n, 3)), axis=0).astype(np.float32),
                      "facial": g.normal(0, 1, (n, 100)).astype(np.float32)})
    ref = JST.compute_mean_velocity_from_clips(clips, jm, chunk=32)
    got = PST.compute_mean_velocity_from_clips(clips, pm, chunk=32)
    assert got.shape == (55,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    joints = [g.normal(size=(n, 55, 3)) for n in (3, 9)]
    np.testing.assert_array_equal(PST.compute_mean_joint_velocity(joints), JST.compute_mean_joint_velocity(joints))


def test_h3d_layout_features_and_recovery_match_jax(models):
    for part in ("upper", "hands", "lower", "lower_trans"):
        np.testing.assert_array_equal(PH.part_mask_623(part), JH.part_mask_623(part))
    assert {p: len(PH.part_mask_623(p)) for p in ("upper", "hands", "lower")} == PH.H3D_PART_DIMS
    jm, pm = models["synthetic"]
    n = 48
    g = np.random.default_rng(6)
    pose = np.cumsum(g.normal(0, 0.05, (n, 165)), axis=0).astype(np.float32)
    pose[:, 1] += np.linspace(0, 9.0, n, dtype=np.float32)  # the root yaw turns past ±π: the arctan2 wrap
    betas = g.normal(0, 1, 300).astype(np.float32)
    trans = np.cumsum(g.normal(0, 0.02, (n, 3)), axis=0).astype(np.float32)
    contacts = (g.random((n, 4)) < 0.5).astype(np.float32)
    ref = np.asarray(JH.h3d_features_from_pose(jnp.asarray(pose), jnp.asarray(betas), jnp.asarray(trans), jm,
                                               jnp.asarray(contacts)))
    got = PH.h3d_features_from_pose(t(pose), t(betas), t(trans), pm, t(contacts)).numpy()
    assert got.shape == (n, 623)
    np.testing.assert_allclose(got, ref, atol=H3D_ATOL)
    feats = np.stack([ref, ref[::-1].copy()])  # a batch of two
    np.testing.assert_allclose(PH.recover_from_ric(t(feats)).numpy(), np.asarray(JH.recover_from_ric(jnp.asarray(feats))),
                               atol=H3D_ATOL)
    q_p, r_p = PH.recover_root_rot_pos(t(feats))
    q_j, r_j = JH.recover_root_rot_pos(jnp.asarray(feats))
    np.testing.assert_allclose(q_p.numpy(), np.asarray(q_j), atol=H3D_ATOL)
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), atol=H3D_ATOL)


def test_preprocess_clip_with_a_model_matches_jax(models, tmp_path):
    ids = make_corpus(tmp_path, speakers=(2,), clips_per_speaker=1, seconds_range=(6.0, 6.0), seed=4)
    pose = tmp_path / "smplxflame_30" / f"{ids[0]}.npz"
    jm, pm = models["synthetic"]
    ref = JC.preprocess_clip(pose, None, None, None, smplx_model=jm)
    got = PC.preprocess_clip(pose, None, None, None, smplx_model=pm)
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["contacts"], ref["contacts"])
    assert got["contacts"].any()
    np.testing.assert_allclose(got["h3d"], ref["h3d"], atol=H3D_ATOL)
    for k in ("poses", "trans", "trans_v", "betas", "facial", "word", "emo", "sem"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
