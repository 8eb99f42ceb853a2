"""The port's AMASS loading, mixture sampler, BERT word features and BVH I/O against the JAX package's.

- ``load_amass_npz`` on seeded fake AMASS npz files (156-d SMPL-H-width
  poses, padded; 170-d poses, cut): poses within 1e-5 absolute (the Z-up
  -> Y-up turn of the global rotation goes through two frameworks' f32
  quaternion conversions), translation, betas and expressions exact;
- ``WeightedMixtureLoader``: the same (source, batch) sequence, a source
  restarting at its next epoch when it runs out;
- ``word_bert``: the hash encoder's vectors and token maps and
  ``bert_frame_features`` exactly JAX's (the same numpy code);
  ``make_encoder`` with a snapshot raises without ``transformers``;
- ``bvh``: the file ``write_bvh`` writes is JAX's byte for byte, parse and
  ``bvh_to_positions`` give JAX's arrays, and ``smplx_to_bvh`` of a seeded
  axis-angle animation parses back to the same Euler angles as JAX's
  within 1e-3 degrees (f32 rotations, printed to 6 decimals)."""

import sys

import numpy as np
import pytest

from syntalker_tpu.data import amass as JA
from syntalker_tpu.data import bvh as JB
from syntalker_tpu.data import word_bert as JW
from syntalker_tpu.data.textgrid import Interval as JaxInterval
from syntalker_tpu_torch.components import DATASETS
from syntalker_tpu_torch.data import amass as PA
from syntalker_tpu_torch.data import bvh as PB
from syntalker_tpu_torch.data import word_bert as PW
from syntalker_tpu_torch.data.joints import JOINT_NAMES
from syntalker_tpu_torch.data.textgrid import Interval
from syntalker_tpu_torch.ops.smplx import PARENTS
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)


@pytest.mark.parametrize("width", (156, 170))
def test_load_amass_npz_matches_jax(tmp_path, width):
    g = np.random.default_rng(width)
    n = 12
    poses = g.normal(0, 0.6, (n, width)).astype(np.float32)
    poses[0, :3] = [np.pi / 2, 0, 0]  # lying flat in Z-up
    path = tmp_path / "amass.npz"
    np.savez(path, poses=poses, trans=g.normal(size=(n, 3)), betas=g.normal(size=16))
    got, ref = PA.load_amass_npz(path), JA.load_amass_npz(path)
    assert set(got) == set(ref) and got["poses"].shape == (n, 165) and got["betas"].shape == (300,)
    for k in ("trans", "betas", "expressions"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype
    np.testing.assert_array_equal(got["poses"][:, 3:], ref["poses"][:, 3:])
    np.testing.assert_allclose(got["poses"][:, :3], ref["poses"][:, :3], atol=1e-5)
    assert DATASETS.get("amass_npz") is PA.load_amass_npz


class FakeLoader:
    def __init__(self, tag, n):
        self.tag, self.n = tag, n

    def epoch(self, e):
        for i in range(self.n):
            yield {"tag": self.tag, "i": i, "e": e}


def test_weighted_mixture_loader_matches_jax():
    def run(mod, seed, epoch):
        mix = mod.WeightedMixtureLoader({"amass": FakeLoader("amass", 3), "beat": FakeLoader("beat", 5)},
                                        {"amass": 0.5, "beat": 1.0}, seed=seed)
        return [(name, b["i"], b["e"]) for name, b in mix.epoch(epoch, 25)]

    for seed, epoch in ((0, 0), (3, 2)):
        got = run(PA, seed, epoch)
        assert got == run(JA, seed, epoch)
    assert {n for n, _, _ in got} == {"amass", "beat"}
    assert any(e == epoch + 1 for _, _, e in got)  # a source ran out and restarted at its next epoch


def test_hash_encoder_matches_jax():
    words = ["hello", "internationalization", "a", "Wave"]
    h, m = PW.HashProjectionEncoder().encode_words(words)
    jh, jm = JW.HashProjectionEncoder().encode_words(words)
    np.testing.assert_array_equal(h, jh)
    assert m == jm and len(m[1]) > 1
    np.testing.assert_allclose(np.linalg.norm(h, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("offset", (0.0, 0.4))
def test_bert_frame_features_match_jax(offset):
    spans = [(0.1, 1.0, "hello"), (1.2, 1.25, ""), (2.0, 3.0, "goodbyes internationally")]
    got = PW.bert_frame_features([Interval(*s) for s in spans], 100, fps=30, time_offset=offset)
    ref = JW.bert_frame_features([JaxInterval(*s) for s in spans], 100, fps=30, time_offset=offset)
    assert got.shape == (100, PW.HIDDEN_DIM)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(PW.bert_frame_features([], 7), np.zeros((7, 768), np.float32))


def test_make_encoder_needs_transformers_for_a_snapshot(tmp_path, monkeypatch):
    """Without a snapshot the hash encoder; with one, the BERT encoder, which
    raises where ``transformers`` is not installed."""
    assert isinstance(PW.make_encoder(None), PW.HashProjectionEncoder)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        PW.make_encoder(str(tmp_path))


def test_write_and_parse_bvh_match_jax(tmp_path):
    g = np.random.default_rng(0)
    t = 5
    offsets, rots, root = g.normal(0, 0.1, (55, 3)), g.uniform(-40, 40, (t, 55, 3)), g.normal(0, 1, (t, 3))
    p = PB.write_bvh(tmp_path / "port.bvh", PARENTS, list(JOINT_NAMES), offsets, rots, root)
    q = JB.write_bvh(tmp_path / "jax.bvh", PARENTS, list(JOINT_NAMES), offsets, rots, root)
    assert p.read_bytes() == q.read_bytes()
    got, ref = PB.parse_bvh(p), JB.parse_bvh(q)
    assert [(j.name, j.parent, j.channels) for j in got.joints] == [(j.name, j.parent, j.channels) for j in ref.joints]
    np.testing.assert_array_equal(got.frames, ref.frames)
    assert got.fps == pytest.approx(30.0, rel=1e-4)
    np.testing.assert_array_equal(PB.bvh_to_positions(got), JB.bvh_to_positions(ref))


def test_smplx_to_bvh_matches_jax(tmp_path):
    g = np.random.default_rng(1)
    poses, trans = g.normal(0, 0.4, (4, 165)).astype(np.float32), g.normal(size=(4, 3))
    rest = g.normal(0, 0.1, (55, 3))
    got = PB.parse_bvh(PB.smplx_to_bvh(poses, trans, rest, tmp_path / "port.bvh"))
    ref = JB.parse_bvh(JB.smplx_to_bvh(poses, trans, rest, tmp_path / "jax.bvh"))
    assert got.frames.shape == ref.frames.shape == (4, 55 * 3 + 3)
    np.testing.assert_allclose(got.frames, ref.frames, atol=1e-3)
    np.testing.assert_allclose(PB.bvh_to_positions(got), JB.bvh_to_positions(ref), atol=1e-4)
