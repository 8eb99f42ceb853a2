"""The text and word path of the port against the JAX package on the CPU:
TextGrid parsing, the vocabulary (JSON and the reference pickle), per-frame
word ids, WAV loading (each sample type, stereo, 44.1 kHz), the energy word
alignment, the hash word vectors, the flat-npz parameter I/O, the TMR text
and motion encoders (the committed ``weights/t2m_oracle/tmr.npz`` and
bridged random heads, with padding masks), the text pipeline and
MotionCLIP's encoder and decoder."""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from syntalker_tpu.data import audio as JA
from syntalker_tpu.data import captions as JCAP
from syntalker_tpu.data import textgrid as JTG
from syntalker_tpu.data import vocab as JV
from syntalker_tpu.eval import t2m as JT2M
from syntalker_tpu.models import motionclip as JMC
from syntalker_tpu.models import tmr as JTMR
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.data import audio as PA
from syntalker_tpu_torch.data import captions as PCAP
from syntalker_tpu_torch.data import textgrid as PTG
from syntalker_tpu_torch.data import vocab as PV
from syntalker_tpu_torch.eval import t2m as PT2M
from syntalker_tpu_torch.models import motionclip as PMC
from syntalker_tpu_torch.models import tmr as PTMR

ROOT = Path(__file__).resolve().parent.parent
TMR_NPZ = ROOT / "weights" / "t2m_oracle" / "tmr.npz"
ABS = 1e-5

LONG_TG = '''File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 3.2
tiers? <exists>
size = 1
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 3.2
        intervals: size = 5
        intervals [1]:
            xmin = 0
            xmax = 0.41
            text = ""
        intervals [2]:
            xmin = 0.41
            xmax = 0.9
            text = "hello"
        intervals [3]:
            xmin = 0.9
            xmax = 1.7
            text = "world"
        intervals [4]:
            xmin = 1.7
            xmax = 2.5e0
            text = "again"
        intervals [5]:
            xmin = 2.5
            xmax = 3.2
            text = ""
'''

SHORT_TG = '''File type = "ooTextFile short"
"TextGrid"
0
2
<exists>
1
"IntervalTier"
"words"
0
2
2
0
1.25
"big"
1.25
2
"arms"
'''


@pytest.fixture(scope="module")
def textgrids(tmp_path_factory):
    d = tmp_path_factory.mktemp("tg")
    (d / "long.TextGrid").write_text(LONG_TG)
    (d / "short.TextGrid").write_text(SHORT_TG)
    return d


@pytest.mark.parametrize("name", ["long", "short"])
def test_textgrid_matches_jax(textgrids, name):
    path = textgrids / f"{name}.TextGrid"
    ref, out = JTG.parse_textgrid(path), PTG.parse_textgrid(path)
    assert [(t.name, [(i.min_time, i.max_time, i.mark) for i in t.intervals]) for t in out] == \
        [(t.name, [(i.min_time, i.max_time, i.mark) for i in t.intervals]) for t in ref]
    assert len(PTG.words_tier(path)) == {"long": 5, "short": 2}[name]


class Vocab:
    """Stands in for the reference's pickled ``Vocab`` class."""

    def __init__(self):
        self.name = "beat"
        self.word2index = {"hello": 4, "world": 5, "again": 6, "big": 7}
        self.word2count = {w: 1 for w in self.word2index}
        self.index2word = {0: "<PAD>", 1: "<SOS>", 2: "<EOS>", 3: "<UNK>", **{i: w for w, i in self.word2index.items()}}
        self.n_words = 8
        self.word_embedding_weights = np.arange(16, dtype=np.float32).reshape(8, 2)


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory, textgrids):
    d = tmp_path_factory.mktemp("vocab")
    v = JV.build_vocab([textgrids / "long.TextGrid", textgrids / "short.TextGrid"])
    v.build_embedding(dim=4)
    v.save(d / "vocab.json")
    with open(d / "vocab.pkl", "wb") as f:
        pickle.dump(Vocab(), f)
    return d


@pytest.mark.parametrize("form", ["vocab.json", "vocab.pkl"])
def test_vocab_and_frame_ids_match_jax(vocab_files, textgrids, form):
    ref, out = JV.Vocab.load(vocab_files / form), PV.Vocab.load(vocab_files / form)
    for attr in ("name", "word2index", "word2count", "index2word", "n_words"):
        assert getattr(out, attr) == getattr(ref, attr), attr
    np.testing.assert_array_equal(out.word_embedding_weights, ref.word_embedding_weights)
    for w in ("hello", "arms", "nope"):
        assert out.get_word_index(w) == ref.get_word_index(w)
    for tg in ("long", "short"):
        iv_ref = JTG.words_tier(textgrids / f"{tg}.TextGrid")
        iv_out = PTG.words_tier(textgrids / f"{tg}.TextGrid")
        np.testing.assert_array_equal(PV.words_to_frame_ids(iv_out, 100, out), JV.words_to_frame_ids(iv_ref, 100, ref))


WAVS = {  # name -> (sample rate, channels, dtype)
    "int16-stereo-44k": (44100, 2, np.int16),
    "int32-mono-22k": (22050, 1, np.int32),
    "uint8-mono-16k": (16000, 1, np.uint8),
    "float32-stereo-48k": (48000, 2, np.float32),
}


def write_wav(path, sr, channels, dtype, seconds=1.3, seed=0):
    g = np.random.default_rng(seed)
    y = g.normal(0, 0.2, (int(sr * seconds), channels)).clip(-1, 1)
    y = y[:, 0] if channels == 1 else y
    if dtype == np.uint8:
        y = (y * 127 + 128).astype(np.uint8)
    elif dtype != np.float32:
        y = (y * np.iinfo(dtype).max).astype(dtype)
    else:
        y = y.astype(np.float32)
    wavfile.write(str(path), sr, y)
    return path


@pytest.mark.parametrize("name", list(WAVS))
def test_load_wav_mono_matches_jax(tmp_path, name):
    path = write_wav(tmp_path / "x.wav", *WAVS[name])
    (ref, rsr), (out, osr) = JA.load_wav_mono(path), PA.load_wav_mono(path)
    assert osr == rsr == 16000 and out.dtype == np.float32 and out.ndim == 1
    np.testing.assert_array_equal(out, ref)


def _speech_like(seed=3, seconds=4.0, sr=16000):
    """Bursts of noise between silences: voiced runs and pauses."""
    g = np.random.default_rng(seed)
    y = np.zeros(int(sr * seconds), np.float32)
    t = 0.2
    while t < seconds - 0.5:
        dur = g.uniform(0.15, 0.6)
        s = int(t * sr)
        y[s : s + int(dur * sr)] = g.normal(0, 0.3, int(dur * sr))
        t += dur + g.uniform(0.05, 0.4)
    return y


@pytest.mark.parametrize("words", ["hello world again big arms", "", "one"])
def test_align_words_by_energy_matches_jax(vocab_files, words):
    y = _speech_like()
    ref = JA.align_words_by_energy(words.split(), y, 16000)
    out = PA.align_words_by_energy(words.split(), y, 16000)
    assert [(i.min_time, i.max_time, i.mark) for i in out] == [(i.min_time, i.max_time, i.mark) for i in ref]
    v = PV.Vocab.load(vocab_files / "vocab.json")
    np.testing.assert_array_equal(PV.words_to_frame_ids(out, 120, v),
                                  JV.words_to_frame_ids(ref, 120, JV.Vocab.load(vocab_files / "vocab.json")))


def test_align_silence():
    out = PA.align_words_by_energy(["a"], np.zeros(16000, np.float32), 16000)
    assert [(i.min_time, i.max_time, i.mark) for i in out] == [(0.0, 1.0, "")]


@pytest.mark.parametrize("word", ["hello", "Hello", "<empty>", "naïve", ""])
def test_hash_word_vector_bit_for_bit(word):
    for dim in (300, 768):
        ref, out = JCAP.hash_word_vector(word, dim), PCAP.hash_word_vector(word, dim)
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# flat-npz params

def test_oracle_params_io_matches_jax(tmp_path):
    cfg, ref = JTMR.load_tmr_artifact(TMR_NPZ)
    out = PT2M.load_oracle_params(TMR_NPZ)
    flat_ref = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
                for kp, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat_out = PT2M.flatten_params(out)
    assert set(flat_out) == set(flat_ref)
    for k, v in flat_ref.items():
        assert flat_out[k].dtype == np.float32
        np.testing.assert_array_equal(flat_out[k], v)
    # the port writes what JAX reads
    PT2M.save_oracle_params(tmp_path / "again.npz", out, meta={"config": {"latent_dim": cfg.latent_dim}})
    back = JT2M.load_oracle_params(tmp_path / "again.npz", ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a template checks paths and shapes
    PT2M.load_oracle_params(tmp_path / "again.npz", template=out)
    bad = {"text": {"projection": {"kernel": np.zeros((3, 3))}}}
    with pytest.raises(ValueError):
        PT2M.load_oracle_params(tmp_path / "again.npz", template=bad)


# ---------------------------------------------------------------------------
# TMR encoders

def perturbed(params, seed):
    """Every leaf moved by seeded noise: the initial ones/zeros prove nothing."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(np.asarray(a) + g.normal(0, 0.05, np.shape(a)).astype(np.float32)) for a in leaves])


def _seq(b, t, d, seed):
    g = np.random.default_rng(seed)
    x = g.normal(size=(b, t, d)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[0, t // 2 :] = 0  # a padded sample
    mask[-1, 1:] = 0
    return x, mask


@pytest.fixture(scope="module")
def artifact():
    return JTMR.load_tmr_artifact(TMR_NPZ), PTMR.load_tmr_artifact(TMR_NPZ)


def test_tmr_artifact_text_encoder(artifact):
    (jcfg, jp), (pcfg, pp) = artifact
    assert pcfg == PTMR.TMRConfig(**{k: getattr(jcfg, k) for k in ("latent_dim", "ff_size", "num_layers",
                                                                      "num_heads", "motion_feats", "text_feats")})
    x, mask = _seq(3, 12, jcfg.text_feats, 0)
    ref = JTMR.DistilbertTextEncoder(jcfg).apply({"params": jp["text"]}, jnp.asarray(x), jnp.asarray(mask))
    head = bridge.load_tmr_text(PTMR.DistilbertTextEncoder(pcfg), pp["text"]).eval()
    with torch.no_grad():
        out = head(torch.as_tensor(x), torch.as_tensor(mask))
    for o, r in zip(out, ref):
        assert np.abs(o.numpy() - np.asarray(r)).max() < ABS


def test_tmr_artifact_motion_encoder(artifact):
    (jcfg, jp), (pcfg, pp) = artifact
    x, mask = _seq(3, 40, jcfg.motion_feats, 1)
    enc = JTMR.ActorAgnosticEncoder(jcfg, input_dim=jcfg.motion_feats)
    penc = bridge.load_actor_encoder(PTMR.ActorAgnosticEncoder(pcfg, pcfg.motion_feats), pp["motion"]).eval()
    for m in (mask, None):
        ref = enc.apply({"params": jp["motion"]}, jnp.asarray(x), None if m is None else jnp.asarray(m))
        with torch.no_grad():
            out = penc(torch.as_tensor(x), None if m is None else torch.as_tensor(m))
        for o, r in zip(out, ref):
            assert np.abs(o.numpy() - np.asarray(r)).max() < ABS


SMALL_TMR = dict(latent_dim=32, ff_size=48, num_layers=2, num_heads=4, motion_feats=20, text_feats=24)


def test_random_text_head_bridges_and_masks():
    jcfg = JTMR.TMRConfig(**SMALL_TMR)
    x, mask = _seq(4, 9, jcfg.text_feats, 2)
    head = JTMR.DistilbertTextEncoder(jcfg)
    params = perturbed(head.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask))["params"], 4)
    ref = head.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    phead = bridge.load_tmr_text(PTMR.DistilbertTextEncoder(PTMR.TMRConfig(**SMALL_TMR)),
                                 jax.tree.map(np.asarray, params)).eval()
    with torch.no_grad():
        out = phead(torch.as_tensor(x), torch.as_tensor(mask))
        # what lies under the mask does not matter
        x2 = x.copy()
        x2[mask == 0] = 100.0
        out2 = phead(torch.as_tensor(x2), torch.as_tensor(mask))
    for o, o2, r in zip(out, out2, ref):
        assert np.abs(o.numpy() - np.asarray(r)).max() < ABS
        assert torch.equal(o, o2)
    assert sum(t.numel() for t in phead.parameters()) == sum(np.size(a) for a in jax.tree.leaves(params))


def test_text_pipeline_matches_jax():
    """Hidden states padded to 16, the embedding padded to the batch's
    longest text, through a bridged random head."""
    jcfg = JTMR.TMRConfig(**SMALL_TMR)
    jpipe = JTMR.TextPipeline(jcfg, rng=jax.random.PRNGKey(5))
    params = perturbed(jpipe.head_params, 6)
    jpipe = JTMR.TextPipeline(jcfg, head_params=params)
    ppipe = PTMR.TextPipeline(PTMR.TMRConfig(**SMALL_TMR), head_params=jax.tree.map(np.asarray, params), device="cpu")
    texts = ["raise both arms", "", "Walk slowly forward then turn left and wave with the right hand high up in the air"]
    (jh, jm), (ph, pm) = jpipe.hidden_states(texts), ppipe.hidden_states(texts)
    assert ph.shape == (3, 16, 24)
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pm, jm)
    out = ppipe.embed(texts)
    assert out.shape == (3, 32)
    assert np.abs(out.numpy() - np.asarray(jpipe.embed(texts))).max() < ABS
    jemb = JTMR.embed_prompts(None, {"upper": "wave", "hands": None, "lower": ""}, jpipe)
    pemb = PTMR.embed_prompts(None, {"upper": "wave", "hands": None, "lower": ""}, ppipe)
    assert pemb["hands"] is None and pemb["lower"] is None
    assert np.abs(pemb["upper"].numpy() - np.asarray(jemb["upper"])).max() < ABS


def test_text_pipeline_from_the_committed_artifact():
    jpipe, ppipe = JTMR.load_text_pipeline(TMR_NPZ), PTMR.load_text_pipeline(TMR_NPZ, device="cpu")
    texts = ["a person raises both arms", "kick"]
    assert np.abs(ppipe.embed(texts).numpy() - np.asarray(jpipe.embed(texts))).max() < ABS


def test_default_head_is_seeded_and_backbone_raises():
    a = PTMR.TextPipeline(PTMR.TMRConfig(**SMALL_TMR), device="cpu").embed(["wave"])
    b = PTMR.TextPipeline(PTMR.TMRConfig(**SMALL_TMR), device="cpu").embed(["wave"])
    c = PTMR.TextPipeline(PTMR.TMRConfig(**SMALL_TMR), generator=torch.Generator().manual_seed(1),
                          device="cpu").embed(["wave"])
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
    with pytest.raises(NotImplementedError, match="DistilBERT"):
        PTMR.TextPipeline(backbone_path="some/snapshot", device="cpu")


# ---------------------------------------------------------------------------
# MotionCLIP

SMALL_MC = dict(clip_dim=24, latent_dim=32, ff_size=48, num_layers=4, num_heads=4, input_feats=18)


def test_motionclip_encoder_matches_jax():
    x, mask = _seq(3, 15, SMALL_MC["input_feats"], 7)
    model = JMC.MotionCLIP(JMC.MotionCLIPConfig(**SMALL_MC))
    params = perturbed(model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 8)
    pm = bridge.load_motionclip(PMC.MotionCLIP(PMC.MotionCLIPConfig(**SMALL_MC)), jax.tree.map(np.asarray, params))
    for m in (None, mask):
        ref = model.apply({"params": params}, jnp.asarray(x), None if m is None else jnp.asarray(m))
        with torch.no_grad():
            out = pm.eval()(torch.as_tensor(x), None if m is None else torch.as_tensor(m))
        assert out.shape == (3, 24)
        assert np.abs(out.numpy() - np.asarray(ref)).max() < ABS


def test_motionclip_decoder_matches_jax():
    z = np.random.default_rng(9).normal(size=(2, SMALL_MC["clip_dim"])).astype(np.float32)
    dec = JMC.MotionCLIPDecoder(JMC.MotionCLIPConfig(**SMALL_MC), num_frames=12)
    params = perturbed(dec.init(jax.random.PRNGKey(1), jnp.asarray(z))["params"], 10)
    pdec = bridge.load_motionclip_decoder(PMC.MotionCLIPDecoder(PMC.MotionCLIPConfig(**SMALL_MC), num_frames=12),
                                          jax.tree.map(np.asarray, params)).eval()
    ref = dec.apply({"params": params}, jnp.asarray(z))
    with torch.no_grad():
        out = pdec(torch.as_tensor(z))
    assert out.shape == (2, 12, 18)
    assert np.abs(out.numpy() - np.asarray(ref)).max() < ABS
    assert sum(t.numel() for t in pdec.parameters()) == sum(np.size(a) for a in jax.tree.leaves(params))
