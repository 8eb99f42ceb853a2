"""The port's window cache and loaders against the JAX package, on the CPU.

On a small synthetic corpus (two speakers, three clips each, 8-9 s,
written by the port's ``make_corpus``, which ``test_torch_data_corpus.py``
holds to JAX's bytes): ``preprocess_clip`` and its helpers, the window
plans, ``BeatCache`` written by one package and read by the other,
``read_split``, ``build_beat_cache`` with its vocab, and the batches of
``BatchLoader`` and ``DeviceDataset`` for two epochs. Everything here is
numpy on both sides, or a gather of the same rows: equal, with no
tolerance."""

import numpy as np
import pytest
import torch

from syntalker_tpu.data import beat_builder as JB
from syntalker_tpu.data import cache as JC
from syntalker_tpu.data.vocab import Vocab as JaxVocab
from syntalker_tpu_torch.cli.common import load_smplx_if_available
from syntalker_tpu_torch.config import load_config
from syntalker_tpu_torch.data import beat_builder as PB
from syntalker_tpu_torch.data import cache as PC
from syntalker_tpu_torch.data.synthetic import make_corpus
from syntalker_tpu_torch.data.vocab import Vocab
from syntalker_tpu_torch.ops.smplx import SMPLXModel, synthetic_smplx_model
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

SPEAKERS = (2, 4)
KEYS = ("pose", "trans_v", "audio", "word")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    ids = make_corpus(root, speakers=SPEAKERS, clips_per_speaker=3, seconds_range=(8.0, 9.0), seed=1)
    return root, ids


@pytest.fixture(scope="module")
def caches(corpus, tmp_path_factory):
    """The train split's 32-frame-window caches built by each package."""
    root, _ = corpus
    out = tmp_path_factory.mktemp("caches")
    cfg_p, cfg_j = PC.ClipConfig(pose_length=32, stride=20), JC.ClipConfig(pose_length=32, stride=20)
    pc, pv = PB.build_beat_cache(root, out / "port", speakers=SPEAKERS, cfg=cfg_p)
    jc, jv = JB.build_beat_cache(root, out / "jax", speakers=SPEAKERS, cfg=cfg_j)
    return (pc, pv), (jc, jv), out, root


def assert_samples_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_clip_helpers_are_jaxs(tmp_path):
    for clip in ("2_scott_0_65_65", "4_x_0_100_100", "1_a_0_5_5", "bad", "2_b_0_x_1"):
        assert PC.emotion_label(clip) == JC.emotion_label(clip)
    trans = np.cumsum(np.random.default_rng(0).normal(size=(50, 3)), axis=0).astype(np.float32)
    for a, b in zip(PC.trans_velocity(trans), JC.trans_velocity(trans)):
        np.testing.assert_array_equal(a, b)
    sem = tmp_path / "s.txt"
    sem.write_text("c\t0.10\t0.50\t0.40\t0.7\tbeat\nc\t0.40\t1.00\t0.60\t0.3\tx\nshort\nc\tx\t1\t1\t1\tbad\n")
    np.testing.assert_array_equal(PC.parse_sem_scores(sem, 40), JC.parse_sem_scores(sem, 40))
    assert PC.parse_sem_scores(sem, 40).max() == np.float32(0.7)


@pytest.mark.parametrize("n_frames,n_audio,cfg_kw,is_test", [
    (600, 320000, {}, False), (600, 16000 * 13, {}, False), (600, 0, {"stride": 7}, False),
    (600, 320000, {"clean_first_seconds": 2, "clean_final_seconds": 1}, False), (600, 320000, {}, True),
    (100, 320000, {}, False)])
def test_window_plans_are_jaxs(n_frames, n_audio, cfg_kw, is_test):
    got = PC.plan_clip_windows(n_frames, n_audio, "c", PC.ClipConfig(**cfg_kw), is_test=is_test)
    ref = JC.plan_clip_windows(n_frames, n_audio, "c", JC.ClipConfig(**cfg_kw), is_test=is_test)
    assert [tuple(vars(w).values()) for w in got] == [tuple(vars(w).values()) for w in ref]


def test_preprocess_clip_is_jaxs(corpus):
    root, ids = corpus
    grids = sorted((root / "textgrid").glob("*.TextGrid"))
    pv, jv = PB.build_vocab(grids), JB.build_vocab(grids)
    assert pv.word2index == jv.word2index
    clip = ids[0]
    paths = (root / "smplxflame_30" / f"{clip}.npz", root / "wave16k" / f"{clip}.wav",
             root / "textgrid" / f"{clip}.TextGrid")
    got = PC.preprocess_clip(*paths, pv, sem_path=root / "sem" / f"{clip}.txt")
    ref = JC.preprocess_clip(*paths, jv, sem_path=root / "sem" / f"{clip}.txt")
    assert_samples_equal(got, ref)
    assert "h3d" not in got and not got["contacts"].any() and got["sem"].any() and (got["word"] > 3).any()
    # without wav, textgrid or vocab: no audio, zero words
    assert_samples_equal(PC.preprocess_clip(paths[0], None, None, None), JC.preprocess_clip(paths[0], None, None, None))
    # with an SMPL-X model: FK contacts and the 623-d h3d array (held to JAX in test_torch_smplx.py)
    with_model = PC.preprocess_clip(*paths, pv, smplx_model=synthetic_smplx_model(device="cpu"),
                                    sem_path=root / "sem" / f"{clip}.txt")
    assert with_model["h3d"].shape == (got["poses"].shape[0], 623) and with_model["contacts"].shape[1] == 4
    assert_samples_equal({k: v for k, v in with_model.items() if k not in ("contacts", "h3d")},
                         {k: v for k, v in got.items() if k != "contacts"})


def test_read_split_is_jaxs(corpus):
    root, ids = corpus
    for split in ("train", "test"):
        for speakers in ((2,), (2, 4), (4, 9)):
            assert PB.read_split(root, split, speakers) == JB.read_split(root, split, speakers)
    assert len(PB.read_split(root, "train", SPEAKERS)) == 4 and len(PB.read_split(root, "test", SPEAKERS)) == 2


def test_build_beat_cache_is_jaxs(caches):
    (pc, pv), (jc, jv), out, root = caches
    assert pv.word2index == jv.word2index and pv.n_words == jv.n_words
    assert (out / "port" / "vocab.json").read_text() == (out / "jax" / "vocab.json").read_text()
    assert len(pc) == len(jc) > 0
    assert [vars(w) for w in pc.windows] == [vars(w) for w in jc.windows]
    assert (out / "port" / "train" / "index.json").read_text() == (out / "jax" / "train" / "index.json").read_text()
    for clip in pc.clips:
        assert_samples_equal(pc.clips[clip], jc.clips[clip])
    # a second build is a cache hit that opens the same windows and vocab
    again, v2 = PB.build_beat_cache(root, out / "port", speakers=SPEAKERS,
                                    cfg=PC.ClipConfig(pose_length=32, stride=20))
    assert len(again) == len(pc) and v2.word2index == pv.word2index


def test_beat_cache_reads_across_packages(caches):
    (pc, _), (jc, _), out, _ = caches
    p_of_j, j_of_p = PC.BeatCache.open(out / "jax" / "train"), JC.BeatCache.open(out / "port" / "train")
    for i in range(len(pc)):
        ref = jc.get(i)
        assert_samples_equal(pc.get(i), ref)
        assert_samples_equal(p_of_j.get(i), ref)
        assert_samples_equal(j_of_p.get(i), ref)
    s = pc.get(0)
    assert s["pose"].shape == (32, 169) and s["audio"].shape == (int(32 / 30 * 16000), 2)


def test_batch_loader_is_jaxs(caches):
    (pc, _), (jc, _), _, _ = caches
    for kw in ({"seed": 3}, {"seed": 3, "shuffle": False}, {"seed": 0, "drop_last": False}):
        p, j = PC.BatchLoader(pc, 7, **kw), JC.BatchLoader(jc, 7, **kw)
        assert len(p) == len(j)
        for epoch in (0, 1):
            got, ref = list(p.epoch(epoch)), list(j.epoch(epoch))
            assert len(got) == len(ref) == len(p)
            for a, b in zip(got, ref):
                assert_samples_equal(a, b)
    prefetch = PC.PrefetchLoader(PC.BatchLoader(pc, 7, seed=3))
    assert len(prefetch) == len(PC.BatchLoader(pc, 7))
    for a, b in zip(prefetch.epoch(1), JC.BatchLoader(jc, 7, seed=3).epoch(1)):
        assert_samples_equal(a, b)


def test_device_dataset_batches_are_jaxs(caches):
    """The index vectors of two epochs are JAX's, and the batches gathered
    on the device are the host loader's (and JAX's device dataset's)."""
    (pc, _), (jc, _), _, _ = caches
    ds = PC.DeviceDataset(pc, KEYS + ("h3d",), 7, seed=5, device="cpu")
    jds = JC.DeviceDataset(jc, KEYS, 7, seed=5)
    assert ds.placement == jds.placement == "replicated" and ds.nbytes == jds.nbytes
    assert sorted(ds.arrays) == sorted(KEYS)  # keys a sample lacks are dropped
    assert all(v.device.type == "cpu" for v in ds.arrays.values())
    assert len(ds) == len(jds) == len(pc) // 7
    loader = JC.BatchLoader(jc, 7, seed=5)
    for epoch in (0, 1):
        idx, jidx = list(ds.epoch_indices(epoch)), list(jds.epoch_indices(epoch))
        assert len(idx) == len(jidx)
        for a, b, host in zip(idx, jidx, loader.epoch(epoch)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
            batch = ds.batch(a)
            for k in KEYS:
                np.testing.assert_array_equal(batch[k].numpy(), host[k], err_msg=k)
                np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jds.arrays[k][b]), err_msg=k)


def test_device_dataset_refuses_above_its_budget(caches):
    (pc, _), _, _, _ = caches
    with pytest.raises(PC.DatasetTooLargeError, match="budget"):
        PC.DeviceDataset(pc, KEYS, 7, device="cpu", memory_budget_bytes=1000)
    assert PC.default_memory_budget(torch.device("cpu")) == 6 * 2**30
    empty = PC.BeatCache("unused")
    with pytest.raises(ValueError, match="no windows"):
        PC.DeviceDataset(empty, KEYS, 7, device="cpu")


def test_vocab_embedding_round_trip(tmp_path):
    v = Vocab("w")
    for w in ("a", "b", "a"):
        v.index_word(w)
    v.build_embedding(dim=4)
    v.save(tmp_path / "vocab.json")
    j = JaxVocab.load(tmp_path / "vocab.json")
    np.testing.assert_array_equal(j.word_embedding_weights, v.word_embedding_weights)
    assert j.word2index == Vocab.load(tmp_path / "vocab.json").word2index


def test_load_smplx_if_available(tmp_path):
    assert load_smplx_if_available(load_config(None, ["data.smplx_model_path="])) is None
    assert load_smplx_if_available(load_config(None, [f"data.smplx_model_path={tmp_path / 'none.npz'}"])) is None
    synthetic = load_smplx_if_available(load_config(None, ["data.smplx_model_path=synthetic"]), "cpu")
    assert isinstance(synthetic, SMPLXModel) and synthetic.v_template.shape == (55 * 4, 3)
    m = synthetic_smplx_model(device="cpu")
    v = m.v_template.shape[0]
    np.savez(tmp_path / "m.npz", v_template=m.v_template.numpy(), shapedirs=m.shapedirs.numpy(),
             posedirs=m.posedirs.numpy().T.reshape(v, 3, -1), J_regressor=m.j_regressor.numpy(),
             weights=m.lbs_weights.numpy(), kintree_table=np.stack([m.parents, np.arange(55)]))
    loaded = load_smplx_if_available(load_config(None, [f"data.smplx_model_path={tmp_path / 'm.npz'}"]), "cpu")
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights"):
        assert torch.equal(getattr(loaded, name), getattr(m, name)), name
    np.testing.assert_array_equal(loaded.parents, m.parents)
