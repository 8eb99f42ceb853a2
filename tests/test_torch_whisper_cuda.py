"""Whisper's greedy step as one CUDA graph (``models/whisper.py``:
``_DecodePlan``) on the card, against the same step run eagerly and against
the plain float32 reference ``tests/whisper_reference.py``.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_whisper_cuda.py

Two sizes: ``WhisperConfig.tiny()``, and large-v3's widths and vocabulary
with 2 encoder and 2 decoder layers. Against the eager step the weights
are seeded bf16 and the logits agree to 1e-3 of the largest, not
necessarily bit for bit. Against the reference the weights are float32
with TF32 off, and the limit is 1e-4 of the largest logit, which the
reference's own forward with bf16 operands fails."""

import dataclasses
import gc
import threading
import weakref

import numpy as np
import pytest
import torch

import whisper_reference as R
from syntalker_tpu_torch.device import full_f32
from syntalker_tpu_torch.models import whisper as W
from syntalker_tpu_torch.utils import tracking
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

pytestmark = pytest.mark.cuda

SIZES = {"tiny": W.WhisperConfig.tiny(), "large-v3-2-layers": W.WhisperConfig(encoder_layers=2, decoder_layers=2)}
REL = 1e-3
LOGIT_TOL = 1e-4  # float32 against the reference: largest logit error over the largest logit
STEPS = 20


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode graph runs only on the card")
    return torch.device("cuda")


def build(cfg: W.WhisperConfig, dev) -> W.WhisperASR:
    torch.manual_seed(0)
    return W.WhisperASR(W.Whisper(cfg, device=dev, dtype=torch.bfloat16))


def audios(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(int(16000 * s))).astype(np.float32) for s in np.linspace(3.0, 12.0, n)]


def rel(got, want) -> float:
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


def decode(asr: W.WhisperASR, enc, n_ctx: int, graph: bool):
    """(tokens (rows, STEPS), logits (rows, STEPS, V)) of STEPS greedy steps
    after the prefill, every row fed its own argmax."""
    rows = enc.shape[0]
    state = asr.new_state(rows, n_ctx, asr.cross_kv(enc))
    assert state.plan is not None
    if not graph:
        state = dataclasses.replace(state, plan=None)  # the plan's buffers, stepped eagerly
    prompt = torch.tensor(asr.cfg.prompt, device=enc.device).expand(rows, -1)
    tok = asr.prefill(prompt, state).argmax(-1)
    tokens, logits = [], []
    for _ in range(STEPS):
        out = asr.step(tok, state).clone()  # the graph's logits are overwritten by its next step
        tok = out.argmax(-1)
        tokens.append(tok)
        logits.append(out)
    return torch.stack(tokens, 1), torch.stack(logits, 1)


@pytest.mark.parametrize("size", SIZES)
def test_the_graphed_step_is_the_eager_step(dev, size):
    asr = build(SIZES[size], dev)
    with torch.no_grad():
        enc = asr.encode(asr.mel(audios(3, 1), rows=4))
        n_ctx = W.context_bucket(4 + STEPS + 1, asr.cfg.max_target_positions)
        eager_tokens, eager_logits = decode(asr, enc, n_ctx, graph=False)
        graph = asr._plans[(4, n_ctx)].plan.graph
        graph_tokens, graph_logits = decode(asr, enc, n_ctx, graph=True)
    assert asr._plans[(4, n_ctx)].plan.graph is graph and len(asr._plans) == 1
    assert torch.equal(graph_tokens, eager_tokens)
    for i in range(STEPS):
        assert rel(graph_logits[:, i], eager_logits[:, i]) < REL, i
    assert torch.isfinite(graph_logits).all()


def counted(fn):
    tracking.disable()
    tracking.drain()
    tracking.enable()
    try:
        out = fn()
    finally:
        tracking.disable()
    return out, tracking.drain()


def test_caps_that_round_to_one_bucket_capture_once(dev):
    asr = build(SIZES["large-v3-2-layers"], dev)
    a = audios(3, 2)

    def both():
        return asr.transcribe(a, [12, 20, 9], rows=4), asr.transcribe(a, [30, 50, 40], rows=4)  # 24 and 54 slots

    (short, long), got = counted(both)
    c = got["counts"]
    assert c["asr.graph_captures"] == 1
    assert c["asr.graph_steps"] == c["asr.decode_steps"] > 0
    assert list(asr._plans) == [(4, 64)]
    assert [s.attrs["path"] for s in got["spans"] if s.name == "asr.decode"] == ["graph", "graph"]
    for s, t in zip(short, long):  # one greedy path: the shorter cap keeps a prefix of the longer one's tokens
        assert t[: len(s)] == s


def test_a_second_thread_replays_the_same_graph(dev):
    asr = build(SIZES["tiny"], dev)
    a, caps = audios(2, 3), [20, 30]
    first, _ = counted(lambda: asr.transcribe(a, caps, rows=2))
    graph = next(iter(asr._plans.values())).plan.graph
    box = {}

    def other():
        box["tokens"], box["got"] = counted(lambda: asr.transcribe(a, caps, rows=2))

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    c = box["got"]["counts"]
    assert "asr.graph_captures" not in c
    assert c["asr.graph_steps"] == c["asr.decode_steps"] > 0
    assert next(iter(asr._plans.values())).plan.graph is graph and len(asr._plans) == 1
    assert box["tokens"] == first


def test_the_plans_go_with_the_asr(dev):
    gc.disable()  # freed by reference counts alone: no cycle keeps a graph or its cache alive
    try:
        asr = build(SIZES["tiny"], dev)
        asr.transcribe(audios(2, 4), [10, 12], rows=2)
        state = next(iter(asr._plans.values()))
        plan, cache = weakref.ref(state.plan), weakref.ref(state.k)
        del asr, state
        assert plan() is None and cache() is None
    finally:
        gc.enable()


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def test_two_batches_on_one_plan_match_the_reference(dev):
    """Two different batches, one after the other, replay one graph; every
    decoded position's logits of both hold against the reference's forward
    teacher-forced on the program's tokens. The second call reads only what
    it wrote itself: a cross K/V or cache left from the first would fail."""
    cfg = SIZES["large-v3-2-layers"]
    c = dataclasses.asdict(cfg)
    prompt = list(cfg.prompt)
    torch.manual_seed(0)
    model = W.Whisper(cfg, device=dev, dtype=torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:  # LayerNorms off 1 and 0
                p.add_(0.1 * torch.randn_like(p))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    asr = W.WhisperASR(model)
    seen = []
    step, prefill = asr.step, asr.prefill
    asr.step = lambda *a: seen.append(step(*a).clone()) or seen[-1]
    asr.prefill = lambda *a: seen.append(prefill(*a).clone()) or seen[-1]
    batches = [(audios(3, 5), [12, 20, 9]), (audios(3, 6)[::-1], [16, 8, 18])]
    with full_f32(), torch.no_grad():
        runs = []
        for a, caps in batches:
            seen.clear()
            runs.append(counted(lambda: asr.transcribe(a, caps, rows=4)))
            tokens, _ = runs[-1]
            per_step = torch.stack(seen, 1)  # (rows, positions, V)
            assert [len(t) for t in tokens] == caps  # random weights: no <|endoftext|> in 20 tokens
            for i, (audio, t) in enumerate(zip(a, tokens)):
                enc = R.encode(weights, c, R.log_mel(audio, cfg.num_mel_bins, device=dev))
                want = R.decode_logits(weights, c, prompt + t[:-1], enc)[len(prompt) - 1:]
                got = per_step[i, : len(t)]
                assert rel(got, want) < LOGIT_TOL, (len(runs), i)
                assert got.argmax(-1).tolist() == t
            if len(runs) == 1:  # the limit tells float32 from bf16 operands, and the two batches apart
                control = R.decode_logits(weights, c, prompt + t[:-1], enc, rnd=bf16)[len(prompt) - 1:]
                assert rel(control, want) > LOGIT_TOL
                first = per_step
        assert rel(per_step[:3, 0], first[:3, 0]) > 10 * LOGIT_TOL  # what a stale cross K/V would leave
    counts = [got["counts"] for _, got in runs]
    assert counts[0]["asr.graph_captures"] == 1 and "asr.graph_captures" not in counts[1]
    assert all(n["asr.graph_steps"] == n["asr.decode_steps"] > 0 for n in counts)
    assert list(asr._plans) == [(4, 64)]


def test_new_state_takes_only_cross_kvs_buffers(dev):
    asr = build(SIZES["tiny"], dev)
    with torch.no_grad():
        enc = asr.encode(asr.mel(audios(2, 7), rows=2))
        own = [asr.model.model.decoder.layers[i].encoder_attn.kv(enc) for i in range(asr.cfg.decoder_layers)]
        with pytest.raises(ValueError, match="cross_kv"):
            asr.new_state(2, 64, own)
        asr.new_state(2, 64, asr.cross_kv(enc))
        with pytest.raises(ValueError, match="cross_kv"):
            asr.new_state(2, 64, own)
