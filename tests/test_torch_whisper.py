"""The port's Whisper (``models/whisper.py``) on the CPU at a tiny width,
against the plain float32 reference ``tests/whisper_reference.py``, and its
place in the service and the demo.

Weights are seeded random, every LayerNorm's scale and shift moved off 1
and 0. Tolerances: the program and the reference both run float32, the
program batched and the reference one request at a time, so they differ
by the order of the sums, about 1e-6 of the largest value; the limits
below are 1e-4 of it. Weights rounded to bf16 (8 bits of mantissa) move
the logits by ~1e-3 of the largest, so the limits tell the precision the
test states (float32) from the one below it. Decoding is compared by its
logits at every step against the reference's full forward teacher-forced
on the program's own tokens, never by tokens alone."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import whisper_reference as R
from syntalker_tpu_torch.cli import demo
from syntalker_tpu_torch.data.audio import align_words_by_energy
from syntalker_tpu_torch.data.stats import identity_pose_stats
from syntalker_tpu_torch.data.vocab import Vocab, words_to_frame_ids
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models import whisper as W
from syntalker_tpu_torch.models.denoiser import MDMConfig, build_mdm
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
from syntalker_tpu_torch.ops.quantize import RVQConfig
from syntalker_tpu_torch.serving import MotionGenerationService, MotionRequest
from syntalker_tpu_torch.utils import tracking
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

CFG = W.WhisperConfig.tiny()
C = dataclasses.asdict(CFG)
ENC_TOL = 1e-4  # largest encoder error over its largest value
LOGIT_TOL = 1e-4  # largest logit error over the largest logit, every decoded position
SR = 16000
ROOT = Path(__file__).resolve().parents[1]


def seeded(seed: int = 0) -> W.Whisper:
    model = W.Whisper(CFG)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "model.encoder.embed_positions.weight":
                continue  # the fixed sinusoids
            scale = p[0].numel() ** -0.5 if p.ndim >= 2 else 0.1
            p.copy_(torch.randn(p.shape, generator=g) * scale + (1.0 if "norm.weight" in name else 0.0))
    return model


def speech(seconds: float, seed: int) -> np.ndarray:
    """A gated two-tone signal: voiced runs and pauses for the alignment."""
    g = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    gate = (np.sin(2 * np.pi * g.uniform(1.0, 2.5) * t) > -0.2).astype(np.float32)
    y = 0.3 * gate * np.sin(2 * np.pi * g.uniform(120, 220) * t) + 0.002 * g.standard_normal(len(t))
    return y.astype(np.float32)


@pytest.fixture(scope="module")
def asr():
    return W.WhisperASR(seeded())


@pytest.fixture(scope="module")
def weights(asr):
    return {k: v.clone() for k, v in asr.model.state_dict().items()}


def rel(got, want) -> float:
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


def logits_of_run(asr, audios, caps, rows=None):
    """(tokens, each row's logits at every generated position) of one
    transcription, read from the prefill and the steps."""
    seen, before = [], dict(vars(asr))
    prefill, step = asr.prefill, asr.step
    asr.prefill = lambda *a: seen.append(prefill(*a)) or seen[-1]
    asr.step = lambda *a: seen.append(step(*a)) or seen[-1]
    try:
        tokens = asr.transcribe(audios, caps, rows=rows)
    finally:
        vars(asr).clear()
        vars(asr).update(before)
    per_step = torch.stack(seen, 1)  # (rows, positions, V)
    return tokens, [per_step[i, : max(1, len(t))] for i, t in enumerate(tokens)]


def reference_logits(weights, audio, tokens):
    enc = R.encode(weights, C, R.log_mel(audio, CFG.num_mel_bins))
    return R.decode_logits(weights, C, R.prompt(C) + list(tokens[:-1]), enc)[len(R.prompt(C)) - 1:]


def test_log_mel_matches_the_reference(asr):
    audios = [speech(2.5, 1), speech(31.0, 2), np.zeros(0, np.float32)]  # short, past 30 s, empty
    mel = asr.mel(audios, rows=4)
    assert mel.shape == (4, CFG.num_mel_bins, 3000)
    for i, a in enumerate(audios):
        assert rel(mel[i], R.log_mel(a, CFG.num_mel_bins)) < 1e-6
    assert torch.equal(mel[3], mel[2])  # a padding row is silence


def test_encoder_matches_the_reference(asr, weights):
    audios = [speech(3.0, 3), speech(7.5, 4)]
    enc = asr.encode(asr.mel(audios, rows=2))
    assert enc.shape == (2, CFG.max_source_positions, CFG.d_model)
    for i, a in enumerate(audios):
        assert rel(enc[i], R.encode(weights, C, R.log_mel(a, CFG.num_mel_bins))) < ENC_TOL
    assert torch.equal(asr.model.model.encoder.embed_positions.weight, R.sinusoids(1500, CFG.d_model))


def test_cached_decoding_matches_the_teacher_forced_reference(asr, weights):
    audios = [speech(2.0, 5), speech(4.0, 6), speech(9.0, 7)]
    caps = [3, 9, 14]
    tokens, logits = logits_of_run(asr, audios, caps, rows=4)
    assert [len(t) for t in tokens] == caps  # random weights: no <|endoftext|> in 14 tokens of 96
    for a, t, got in zip(audios, tokens, logits):
        want = reference_logits(weights, a, t)
        assert got.shape == want.shape
        assert rel(got, want) < LOGIT_TOL
        assert got.argmax(-1).tolist() == list(t)
    enc = R.encode(weights, C, R.log_mel(audios[2], CFG.num_mel_bins))
    assert R.greedy(weights, C, enc, caps[2]) == tokens[2]


def test_a_row_stops_at_endoftext_and_at_its_cap(asr):
    eot = CFG.eos_token_id
    step, calls = asr.step, []

    def step_with_eot(tokens, state):  # row 0 says <|endoftext|> at its fourth token
        out = step(tokens, state)
        calls.append(tokens.clone())
        if len(calls) == 3:
            out[0, eot] = 1e9
        return out

    asr.step = step_with_eot
    tracking.enable()
    try:
        tokens = asr.transcribe([speech(3.0, 8), speech(3.0, 9)], [10, 6], rows=3)
    finally:
        tracking.disable()
        del asr.step
    got = tracking.drain()
    assert [len(t) for t in tokens] == [3, 6]
    assert eot not in tokens[0]
    assert len(calls) == 5  # until row 1's cap: the prefill gives its first token, 5 steps the rest
    assert all(int(c[0]) == eot for c in calls[3:])  # a finished row feeds <|endoftext|>
    assert got["counts"] == {"asr.rows": 3, "asr.rows_real": 2, "asr.decode_steps": 5, "asr.tokens": 18,
                             "asr.tokens_real": 9}
    decode = [s for s in got["spans"] if s.name == "asr.decode"]
    assert [s.attrs for s in decode] == [{"rows": 3, "real": 2, "path": "eager", "steps": 5, "tokens_real": 9}]
    assert [s.name for s in got["spans"]] == ["asr.mel", "asr.encode", "asr.cross_kv", "asr.prefill", "asr.decode"]


def test_the_cache_length_is_rounded_up_to_its_bucket():
    assert W.context_bucket(4 + 56, 448) == 64
    assert W.context_bucket(4 + 444, 448) == 448
    assert W.context_bucket(4 + 1, 448) == 64
    assert W.context_bucket(64, 448) == 64 and W.context_bucket(65, 448) == 128
    assert all(W.context_bucket(n, limit) <= limit for limit in (64, 100, 448) for n in range(1, limit + 1))
    assert all(W.context_bucket(n, limit) >= n for limit in (64, 100, 448) for n in range(1, limit + 1))


def test_a_bucketed_cache_gives_the_exact_caches_tokens_and_logits(asr, monkeypatch):
    audios = [speech(3.0, 15), speech(8.0, 16)]
    caps = [7, 13]  # 4 + 13 = 17 slots, 64 in the bucket
    sizes = []
    new_state = asr.new_state

    def sized(rows, n_ctx, cross):
        sizes.append(n_ctx)
        return new_state(rows, n_ctx, cross)

    monkeypatch.setattr(asr, "new_state", sized)
    tokens, logits = logits_of_run(asr, audios, caps, rows=3)
    monkeypatch.setattr(W, "context_bucket", lambda n, limit: n)  # the cache as long as the call needs
    exact_tokens, exact_logits = logits_of_run(asr, audios, caps, rows=3)
    assert sizes == [64, 17]
    assert tokens == exact_tokens
    for got, want in zip(logits, exact_logits):
        assert got.shape == want.shape
        assert rel(got, want) < 1e-5


def test_the_cpu_decodes_eagerly_and_says_so(asr):
    tracking.disable()
    tracking.drain()
    tracking.enable()
    try:
        tokens = asr.transcribe([speech(2.5, 17), speech(5.0, 18)], [6, 9], rows=4)
    finally:
        tracking.disable()
    got = tracking.drain()
    decode = [s for s in got["spans"] if s.name == "asr.decode"]
    steps = max(len(t) for t in tokens) - 1
    assert [s.attrs for s in decode] == [{"rows": 4, "real": 2, "path": "eager", "steps": steps,
                                          "tokens_real": sum(len(t) for t in tokens)}]
    assert got["counts"]["asr.decode_steps"] == steps
    assert "asr.graph_steps" not in got["counts"] and "asr.graph_captures" not in got["counts"]
    assert not asr._plans and not asr._cross


def test_padding_rows_leave_the_real_rows_unchanged(asr):
    a, b = speech(4.0, 10), speech(6.0, 11)
    tok1, log1 = logits_of_run(asr, [a, b], [8, 5], rows=2)
    tok2, log2 = logits_of_run(asr, [a, b], [8, 5], rows=6)
    assert tok1 == tok2
    for x, y in zip(log1, log2):
        assert rel(x, y) < 1e-5  # the CPU's GEMMs pick kernels by row count


def test_a_cache_position_off_by_one_fails(asr, weights):
    a = speech(5.0, 12)
    step = asr.step

    def shifted(tokens, state):
        state.pos.add_(1)
        out = step(tokens, state)
        state.pos.sub_(1)
        return out

    asr.step = shifted
    try:
        tokens, logits = logits_of_run(asr, [a], [10])
    finally:
        del asr.step
    assert rel(logits[0], reference_logits(weights, a, tokens[0])) > 10 * LOGIT_TOL


def test_bf16_weights_fail_the_f32_tolerances(weights):
    rounded = seeded()
    with torch.no_grad():
        for p in rounded.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    bf = W.WhisperASR(rounded)
    a = speech(5.0, 13)
    assert rel(bf.encode(bf.mel([a], 1))[0], R.encode(weights, C, R.log_mel(a, CFG.num_mel_bins))) > ENC_TOL
    tokens, logits = logits_of_run(bf, [a], [10])
    assert rel(logits[0], reference_logits(weights, a, tokens[0])) > LOGIT_TOL


def test_names_and_numbers_are_hugging_faces(asr, monkeypatch):
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_JAX", "0")
    transformers = pytest.importorskip("transformers")
    hc = transformers.WhisperConfig(**{k: v for k, v in C.items() if not k.endswith("_token_id") or k in (
        "eos_token_id", "decoder_start_token_id")}, pad_token_id=CFG.eos_token_id, bos_token_id=CFG.eos_token_id)
    hf = transformers.WhisperForConditionalGeneration(hc).eval()
    sd = hf.state_dict()
    assert set(sd) - set(asr.model.state_dict()) == {"proj_out.weight"}
    model = W.Whisper(CFG)
    model.load_hf_state_dict(sd)
    mine = W.WhisperASR(model)
    a = speech(4.0, 14)
    features = transformers.WhisperFeatureExtractor(feature_size=CFG.num_mel_bins)(
        a, sampling_rate=SR, return_tensors="pt").input_features
    mel = mine.mel([a], 1)
    assert rel(mel, features) < 1e-5
    tokens, logits = logits_of_run(mine, [a], [6])
    ids = torch.tensor([list(CFG.prompt) + tokens[0][:-1]])
    with torch.no_grad():
        want = hf(input_features=mel, decoder_input_ids=ids).logits[0, len(CFG.prompt) - 1:]
    assert rel(logits[0], want) < LOGIT_TOL


def test_byte_level_decoding():
    sym = W._bytes_to_unicode()
    vocab = {"Ġhello": 0, "Ġw": 1, "orld": 2, "".join(sym[b] for b in "é".encode()): 3, "<|endoftext|>": 4}
    dec = W.ByteLevelDecoder(vocab, eot=4)
    assert dec.decode([0, 1, 2, 4, 3]) == " hello worldé"  # a special id is dropped


# ---------------------------------------------------------------------------
# the service

MDM = MDMConfig(latent_total_dim=1536, latent_dim=32, ff_size=64, num_layers=1, num_heads=2, rope_heads=4,
                audio_feat_dim=16, word_feat_dim=16, word_embed_dim=8, vocab_size=50)


@pytest.fixture(scope="module")
def motion():
    q = RVQConfig(num_quantizers=2, nb_code=16, code_dim=512)
    rvq = {part: build_rvqvae(RVQVAEConfig(input_dim=dim, width=32, depth=1, quantizer=q), seed=i, device="cpu")
           for i, (part, dim) in enumerate((("upper", 78), ("hands", 180), ("lower", 57)))}
    return build_mdm(MDM, seed=0, device="cpu"), rvq


def word_vocab() -> Vocab:
    """Token ids as words: three in four ids of the tiny vocabulary are known."""
    v = Vocab()
    for t in (t for t in range(CFG.vocab_size) if t % 4):
        v.index_word(str(t))
    return v


def service(motion, asr=None):
    mdm, rvq = motion
    return MotionGenerationService(mdm=mdm, diffusion=make_diffusion(steps=4), rvq_modules=rvq,
                                   stats=identity_pose_stats(), max_batch=4, max_seconds=128 / 30, device="cpu",
                                   seed=3, asr=asr, vocab=None if asr is None else word_vocab())


def test_an_audio_only_request_gets_the_references_words_and_motion(motion, asr, weights):
    a = speech(3.5, 20)
    svc = service(motion, asr)
    kept = []
    wrap = words_to_frame_ids

    def keep(*args, **kw):
        kept.append(wrap(*args, **kw))
        return kept[-1]

    import syntalker_tpu_torch.serving as S

    orig = S.V.words_to_frame_ids
    S.V.words_to_frame_ids = keep
    try:
        svc.submit(MotionRequest(audio=a, request_id="asr", max_new_tokens=12))
        got = svc.flush()[0]
    finally:
        S.V.words_to_frame_ids = orig
    tokens = R.greedy(weights, C, R.encode(weights, C, R.log_mel(a, CFG.num_mel_bins)), 12)
    words = words_to_frame_ids(align_words_by_energy([str(t) for t in tokens], a, SR), len(a) * 30 // SR,
                               word_vocab(), 30)
    assert len(kept) == 1 and np.array_equal(kept[0], words)
    assert {0} < set(words.tolist()) and 3 not in words  # pauses and known words
    plain = service(motion)
    plain.submit(MotionRequest(audio=a, words=words, request_id="words"))
    want = plain.flush()[0]
    assert np.array_equal(got.axis_angle, want.axis_angle) and np.array_equal(got.trans, want.trans)


def test_a_request_with_words_runs_no_asr_and_counters_count_what_ran(motion, asr):
    svc = service(motion, asr)
    tracking.disable()
    tracking.drain()
    tracking.enable()
    try:
        svc.submit(MotionRequest(audio=speech(2.0, 21), words=np.ones(60, np.int64), request_id="w"))
        svc.flush()
        first = tracking.drain()
        svc.submit(MotionRequest(audio=speech(2.0, 22), request_id="a", max_new_tokens=5))
        svc.submit(MotionRequest(audio=speech(4.0, 23), request_id="b", max_new_tokens=7))
        svc.submit(MotionRequest(audio=speech(3.0, 24), words=np.ones(60, np.int64), request_id="c"))
        svc.flush()
        second = tracking.drain()
    finally:
        tracking.disable()
    assert not [s for s in first["spans"] if s.name.startswith("asr.")]
    assert not [c for c in first["counts"] if c.startswith("asr.")]
    names = [s.name for s in second["spans"] if s.name.startswith("asr.")]
    assert names == ["asr.mel", "asr.encode", "asr.cross_kv", "asr.prefill", "asr.decode", "asr.align", "asr.align"]
    flush = next(s for s in second["spans"] if s.name == "serve.flush")
    assert all(s.parent == flush.id for s in second["spans"] if s.name.startswith("asr."))
    c = second["counts"]
    assert (c["asr.rows"], c["asr.rows_real"], c["asr.decode_steps"]) == (4, 2, 6)
    assert (c["asr.tokens"], c["asr.tokens_real"]) == (4 * 7, 5 + 7)


def test_a_service_without_asr_does_not_import_whisper():
    code = ("import sys, numpy as np\n"
            "from syntalker_tpu_torch.data.stats import identity_pose_stats\n"
            "from syntalker_tpu_torch.diffusion.schedule import make_diffusion\n"
            "from syntalker_tpu_torch.models.denoiser import MDMConfig, build_mdm\n"
            "from syntalker_tpu_torch.serving import MotionGenerationService, MotionRequest\n"
            "m = build_mdm(MDMConfig(latent_dim=32, ff_size=64, num_layers=1, num_heads=2, rope_heads=4, "
            "audio_feat_dim=16, word_feat_dim=16, word_embed_dim=8, vocab_size=50), seed=0, device='cpu')\n"
            "s = MotionGenerationService(mdm=m, diffusion=make_diffusion(steps=2), rvq_modules={}, "
            "stats=identity_pose_stats(), max_batch=2, max_seconds=128 / 30, device='cpu')\n"
            "print('syntalker_tpu_torch.models.whisper' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False"


def test_a_service_with_asr_needs_a_vocab(motion, asr):
    mdm, rvq = motion
    with pytest.raises(ValueError, match="vocab"):
        MotionGenerationService(mdm=mdm, diffusion=make_diffusion(steps=4), rvq_modules=rvq,
                                stats=identity_pose_stats(), max_batch=4, device="cpu", asr=asr)


# ---------------------------------------------------------------------------
# the demo


def test_the_demo_transcribes_from_a_local_snapshot(tmp_path, asr, weights):
    from safetensors.torch import save_file
    from scipy.io import wavfile

    snap = tmp_path / "whisper"
    snap.mkdir()
    cfg = {k: v for k, v in C.items() if k not in ("en_token_id", "transcribe_token_id", "no_timestamps_token_id")}
    (snap / "config.json").write_text(json.dumps(dict(cfg, model_type="whisper")))
    (snap / "generation_config.json").write_text(json.dumps({
        "lang_to_id": {"<|en|>": CFG.en_token_id}, "task_to_id": {"transcribe": CFG.transcribe_token_id},
        "no_timestamps_token_id": CFG.no_timestamps_token_id}))
    sd = dict(weights, **{"proj_out.weight": weights["model.decoder.embed_tokens.weight"].clone()})
    save_file({k: v.contiguous() for k, v in sd.items()}, str(snap / "model.safetensors"))
    sym = W._bytes_to_unicode()
    vocab = {("Ġ" if t % 3 == 0 else "") + sym[ord("a") + t % 26]: t for t in range(CFG.eos_token_id)}
    (snap / "vocab.json").write_text(json.dumps(vocab))
    a = speech(4.0, 30)
    wavfile.write(str(tmp_path / "clip.wav"), SR, a)
    text = demo.transcribe_if_available(str(tmp_path / "clip.wav"), str(snap), device="cpu")
    tokens = R.greedy(weights, C, R.encode(weights, C, R.log_mel(a, CFG.num_mel_bins)), asr.max_new_tokens)
    assert text == " ".join(W.ByteLevelDecoder(vocab, CFG.eos_token_id).decode(tokens).split())
    assert text.strip()
    assert demo.transcribe_if_available(str(tmp_path / "clip.wav"), "") == ""
