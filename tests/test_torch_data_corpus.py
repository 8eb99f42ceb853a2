"""The port's synthetic corpus and framework-free data helpers against the
JAX package, on the CPU.

The corpus must be the same bytes: ``synth_clip`` and ``perturbed_clip``
arrays equal, and a corpus written by either package (``make_corpus``,
with and without a base clip) equal file for file: wav, TextGrid, sem and
``train_test_split.csv`` byte for byte, the npz files array for array (an
npz member carries its write time). The base clip of the perturbed
variants is written here with ``synth_clip``. Alongside: the captioner,
the mel features, the pose and h3d statistics, ``boolean_mask`` and
``scatter_part`` (all numpy in both packages: exactly equal), the
axis-angle rotations and ``pose_to_part_rot6d`` (f32 in both, 1e-6
absolute on unit-scale outputs), and the linear and section-count
schedules (float64 numpy in both: exactly equal)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu.data import audio as JA
from syntalker_tpu.data import captions as JCAP
from syntalker_tpu.data import joints as JJ
from syntalker_tpu.data import stats as JST
from syntalker_tpu.data import synthetic as JSY
from syntalker_tpu.data.features import pose_to_part_rot6d as jax_pose_to_part_rot6d
from syntalker_tpu.diffusion import schedule as JSCH
from syntalker_tpu.ops import rotations as JR
from syntalker_tpu_torch.data import audio as PA
from syntalker_tpu_torch.data import captions as PCAP
from syntalker_tpu_torch.data import joints as PJ
from syntalker_tpu_torch.data import stats as PST
from syntalker_tpu_torch.data import synthetic as PSY
from syntalker_tpu_torch.data.features import pose_to_part_rot6d
from syntalker_tpu_torch.diffusion import schedule as PSCH
from syntalker_tpu_torch.ops import rotations as PR
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

ROT_ATOL = 1e-6


def assert_clips_equal(p, j):
    assert p.clip_id == j.clip_id
    for name in ("poses", "trans", "betas", "expressions", "audio", "beat_times"):
        a, b = getattr(p, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert p.words == j.words and p.sem_spans == j.sem_spans


def assert_trees_equal(root_p: Path, root_j: Path):
    """Every file of two corpus directories: npz array for array, the rest
    byte for byte."""
    files_p = sorted(f.relative_to(root_p) for f in root_p.rglob("*") if f.is_file())
    files_j = sorted(f.relative_to(root_j) for f in root_j.rglob("*") if f.is_file())
    assert files_p == files_j and files_p
    for rel in files_p:
        if rel.suffix == ".npz":
            with np.load(root_p / rel) as a, np.load(root_j / rel) as b:
                assert sorted(a.files) == sorted(b.files), rel
                for k in a.files:
                    assert a[k].dtype == b[k].dtype, (rel, k)
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{rel}:{k}")
        else:
            assert (root_p / rel).read_bytes() == (root_j / rel).read_bytes(), rel


@pytest.mark.parametrize("speaker,index,seconds,seed", [(2, 0, 8.0, 0), (6, 3, 11.5, 7)])
def test_synth_clip_is_jaxs(speaker, index, seconds, seed):
    assert_clips_equal(PSY.synth_clip(speaker, index, seconds, seed=seed),
                       JSY.synth_clip(speaker, index, seconds, seed=seed))
    base = np.random.default_rng(0).normal(size=(40, 165)).astype(np.float32)
    assert_clips_equal(PSY.synth_clip(speaker, index, seconds, seed=seed, base_poses=base),
                       JSY.synth_clip(speaker, index, seconds, seed=seed, base_poses=base))
    assert PSY.speaker_tempo_bpm(speaker) == JSY.speaker_tempo_bpm(speaker)


def test_write_clip_and_perturbed_clip_are_jaxs(tmp_path):
    base = PSY.synth_clip(3, 0, 12.0, seed=5)
    PSY.write_clip(tmp_path / "p", base)
    JSY.write_clip(tmp_path / "j", base)
    assert_trees_equal(tmp_path / "p", tmp_path / "j")
    npz = tmp_path / "p" / "smplxflame_30" / f"{base.clip_id}.npz"
    wav = tmp_path / "p" / "wave16k" / f"{base.clip_id}.wav"
    audio, sr = PA.load_wav_mono(wav, PSY.SR)
    np.testing.assert_array_equal(audio, JA.load_wav_mono(wav, JSY.SR)[0])
    for speaker, index in ((2, 1), (8, 4)):
        assert_clips_equal(PSY.perturbed_clip(npz, audio, speaker, index, seconds=6.0, seed=1),
                           JSY.perturbed_clip(npz, audio, speaker, index, seconds=6.0, seed=1))


@pytest.mark.parametrize("with_base", (False, True))
def test_make_corpus_is_jaxs(tmp_path, with_base):
    kw = dict(speakers=(2, 4), clips_per_speaker=3, seconds_range=(8.0, 10.0), seed=3)
    if with_base:
        base = PSY.synth_clip(9, 0, 14.0, seed=2)
        PSY.write_clip(tmp_path / "base", base)
        kw.update(base_npz=tmp_path / "base" / "smplxflame_30" / f"{base.clip_id}.npz",
                  base_wav=tmp_path / "base" / "wave16k" / f"{base.clip_id}.wav")
    ids_p = PSY.make_corpus(tmp_path / "p", **kw)
    ids_j = JSY.make_corpus(tmp_path / "j", **kw)
    assert ids_p == ids_j and len(ids_p) == 6
    assert any("scottvar" in i for i in ids_p) == with_base
    assert_trees_equal(tmp_path / "p", tmp_path / "j")


# ---------------------------------------------------------------------------
# captions, audio features, statistics
# ---------------------------------------------------------------------------


def joints_track(seed: int, t: int = 40) -> np.ndarray:
    g = np.random.default_rng(seed)
    rest = g.normal(size=(22, 3)).astype(np.float32)
    drift = np.cumsum(g.normal(0, 0.05 * (1 + seed), size=(t, 22, 3)), axis=0).astype(np.float32)
    return rest[None] + drift


def test_captions_are_jaxs():
    caps = []
    for seed in range(6):
        j = joints_track(seed)
        p, r = PCAP.caption_motion(j), JCAP.caption_motion(j)
        assert (p.text, p.tokens, p.pos) == (r.text, r.tokens, r.pos)
        caps.append(p.text)
        for a, b in zip(PCAP.caption_to_t2m_inputs(p, dim_word=16, max_len=8),
                        JCAP.caption_to_t2m_inputs(r, dim_word=16, max_len=8)):
            np.testing.assert_array_equal(a, b)
    assert len(set(caps)) > 1  # the tracks reach different clauses
    batch = np.stack([joints_track(s) for s in range(3)])
    got, ref = PCAP.caption_batch(batch, dim_word=16), JCAP.caption_batch(batch, dim_word=16)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert [c.text for c in got[3]] == [c.text for c in ref[3]]


def test_melspectrogram_features_are_jaxs():
    y = PSY.synth_clip(4, 1, 3.0, seed=0).audio
    got = PA.melspectrogram_features(y)
    assert got.shape == (1 + len(y) // (16000 // 30), 128)
    np.testing.assert_array_equal(got, JA.melspectrogram_features(y))
    np.testing.assert_array_equal(PA.melspectrogram_features(y, fps=15, n_mels=40),
                                  JA.melspectrogram_features(y, fps=15, n_mels=40))


def test_wav2vec2_features_need_a_snapshot():
    with pytest.raises(ValueError, match="local pretrained snapshot"):
        PA.wav2vec2_features(np.zeros(1600, np.float32))


def test_statistics_are_jaxs(tmp_path):
    g = np.random.default_rng(4)
    rot6d = g.normal(size=(3, 20, 330)).astype(np.float32)
    rot6d[..., 7] = 0.5  # a constant channel: std floored at 1e-6
    trans_v = g.normal(size=(3, 20, 3)).astype(np.float32)
    got, ref = PST.compute_pose_stats(rot6d, trans_v), JST.compute_pose_stats(rot6d, trans_v)
    for name in ("mean_full", "std_full", "trans_mean", "trans_std"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    assert got.std_full[7] == np.float32(1e-6)
    h3d = g.normal(size=(2, 15, 623)).astype(np.float32)
    got, ref = PST.compute_h3d_stats(h3d), JST.compute_h3d_stats(h3d)
    np.testing.assert_array_equal(got.mean, ref.mean)
    np.testing.assert_array_equal(got.std, ref.std)
    np.save(tmp_path / "beatx_1-30_amass_h3d_mean.npy", got.mean)
    np.save(tmp_path / "beatx_1-30_amass_h3d_std.npy", np.where(np.arange(623) == 5, 0.0, got.std))
    loaded, jloaded = PST.load_h3d_stats(tmp_path), JST.load_h3d_stats(tmp_path)
    np.testing.assert_array_equal(loaded.std, jloaded.std)
    assert loaded.std[5] == np.float32(1e-6)
    x = h3d[0]
    np.testing.assert_array_equal(loaded.normalize(x), jloaded.normalize(x))
    np.testing.assert_allclose(loaded.normalize(torch.as_tensor(x)).numpy(), loaded.normalize(x), rtol=0, atol=0)
    np.testing.assert_allclose(loaded.denormalize(loaded.normalize(x)), x, rtol=1e-5, atol=1e-5)
    ident = PST.identity_h3d_stats()
    np.testing.assert_array_equal(ident.normalize(x), x)
    assert ident.mean.shape == JST.identity_h3d_stats().mean.shape == (623,)


def test_boolean_mask_and_scatter_part_are_jaxs():
    for name in ("UPPER_AA_IDX", "HANDS_AA_IDX", "LOWER_AA_IDX", "FACE_AA_IDX"):
        np.testing.assert_array_equal(getattr(PJ, name), getattr(JJ, name))
    for name in ("JOINT_MASK_UPPER", "JOINT_MASK_HANDS", "JOINT_MASK_LOWER", "JOINT_MASK_FACE"):
        np.testing.assert_array_equal(getattr(PJ, name), getattr(JJ, name))
    np.testing.assert_array_equal(PJ.boolean_mask(np.array([1, 4]), 6), JJ.boolean_mask(np.array([1, 4]), 6))
    part = np.random.default_rng(5).normal(size=(2, 3, len(PJ.HANDS_6D_IDX))).astype(np.float32)
    ref = JJ.scatter_part(part, JJ.HANDS_6D_IDX, 330)
    np.testing.assert_array_equal(PJ.scatter_part(part, PJ.HANDS_6D_IDX, 330), ref)
    np.testing.assert_array_equal(PJ.scatter_part(torch.as_tensor(part), PJ.HANDS_6D_IDX, 330).numpy(), ref)


def test_axis_angle_rotations_are_jaxs():
    g = np.random.default_rng(6)
    aa = g.normal(size=(5, 7, 3)).astype(np.float32)
    aa[0, 0] = 0.0  # the identity: the small-angle series
    aa[0, 1] = [3e-7, -2e-7, 1e-7]
    aa[0, 2] = [np.pi - 1e-3, 0, 0]
    t = torch.as_tensor(aa)
    for pfn, jfn in ((PR.axis_angle_to_quaternion, JR.axis_angle_to_quaternion),
                     (PR.axis_angle_to_matrix, JR.axis_angle_to_matrix),
                     (PR.axis_angle_to_rotation_6d, JR.axis_angle_to_rotation_6d)):
        np.testing.assert_allclose(pfn(t).numpy(), np.asarray(jfn(jnp.asarray(aa))), rtol=0, atol=ROT_ATOL)
    q = g.normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_allclose(PR.quaternion_to_matrix(torch.as_tensor(q)).numpy(),
                               np.asarray(JR.quaternion_to_matrix(jnp.asarray(q))), rtol=0, atol=ROT_ATOL)
    # the round trip through the matrix returns the rotation
    np.testing.assert_allclose(PR.matrix_to_axis_angle(PR.axis_angle_to_matrix(t[1:])).numpy(), aa[1:], atol=1e-5)


def test_pose_to_part_rot6d_is_jaxs():
    pose = (np.random.default_rng(7).normal(size=(2, 9, 165)) * 0.7).astype(np.float32)
    got = pose_to_part_rot6d(torch.as_tensor(pose))
    ref = jax_pose_to_part_rot6d(jnp.asarray(pose))
    dims = {"upper": 78, "hands": 180, "lower": 54, "jaw": 6, "full": 330}
    assert set(got) == set(ref) == set(dims)
    for name, dim in dims.items():
        assert got[name].shape == (2, 9, dim)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=0, atol=ROT_ATOL, err_msg=name)
    # each part is the full vector's gather
    np.testing.assert_allclose(got["hands"].numpy(), got["full"].numpy()[..., PJ.HANDS_6D_IDX], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps,scale", [(1000, 1.0), (100, 0.5)])
def test_linear_betas_are_jaxs(steps, scale):
    np.testing.assert_array_equal(PSCH.linear_betas(steps, scale), JSCH.linear_betas(steps, scale))
    np.testing.assert_array_equal(PSCH.get_named_beta_schedule("linear", steps, scale),
                                  JSCH.get_named_beta_schedule("linear", steps, scale))
    np.testing.assert_array_equal(PSCH.get_named_beta_schedule("cosine", steps),
                                  JSCH.get_named_beta_schedule("cosine", steps))
    with pytest.raises(ValueError, match="unknown beta schedule"):
        PSCH.get_named_beta_schedule("sigmoid", steps)


@pytest.mark.parametrize("counts", ["ddim50", "10,20,5", [4, 4, 4, 4], [1, 7], "25"])
def test_section_count_respacing_is_jaxs(counts):
    assert PSCH.space_timesteps(1000, counts) == JSCH.space_timesteps(1000, counts)


def test_section_count_respacing_refuses_too_many():
    with pytest.raises(ValueError, match="cannot divide"):
        PSCH.space_timesteps(10, [3, 9])
    with pytest.raises(ValueError, match="cannot divide"):
        JSCH.space_timesteps(10, [3, 9])


@pytest.mark.parametrize("schedule,respacing,scale", [("linear", None, 1.0), ("linear", "10,5", 1.0),
                                                      ("linear", [3, 3], 2.0), ("cosine", "ddim10", 1.0)])
def test_make_diffusion_arrays_are_jaxs(schedule, respacing, scale):
    got = PSCH.make_diffusion(schedule=schedule, steps=100, timestep_respacing=respacing, scale_beta=scale)
    ref = JSCH.make_diffusion(schedule=schedule, steps=100, timestep_respacing=respacing, scale_beta=scale)
    assert got.num_steps == ref.num_steps
    for name in ("timestep_map", "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                 "posterior_variance", "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
