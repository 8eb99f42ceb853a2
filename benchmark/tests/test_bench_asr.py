"""The ``h3d-serve-asr`` cell at tiny widths on the CPU: its driver end to
end (the MDM and RVQ-VAEs at ``tiny``'s widths, Whisper at
``WhisperConfig.tiny()``), judged with the cell's own limits; its control
and every fault it can have come out not correct; the readers of its
per-layer metrics on synthetic spans; the transcription's operation and
byte counts against hand counts at large-v3's widths.

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_asr.py
"""

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import faults, faults_asr, harness, traffic
from benchmark import roofline_asr as RA
from benchmark.drivers import serve_asr
from benchmark.reference import align as ref_align
from benchmark.tests import tiny
from syntalker_tpu_torch.data.audio import align_words_by_energy
from syntalker_tpu_torch.data.vocab import Vocab, words_to_frame_ids
from syntalker_tpu_torch.models.whisper import WhisperConfig

NAME = "h3d-serve-asr"
ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
LARGE = json.loads((ROOT / "benchmark" / "configs" / "h3d-whisper-large-v3.json").read_text())["asr"]


def ctx(seed: int = 3, trace: bool = False) -> harness.Ctx:
    c = harness.context(NAME, seed, 1.0, trace, torch.device("cpu"), time.perf_counter())
    c.config = copy.deepcopy(c.config)
    c.config["mdm"].update(tiny.MDM)
    c.config["rvq"].update(tiny.RVQ)
    c.config["diffusion"]["respacing"] = "ddim4"
    c.config["asr"].update(dataclasses.asdict(WhisperConfig.tiny()))
    c.traffic = dict(c.traffic, pool_buckets=2, warm_buckets=1, judged_buckets=2)
    return c


def line(c, out):
    return harness.result(c, out, MANIFEST, {"platform": "cpu"})


def test_a_sound_run_is_correct_and_the_control_is_not():
    c = ctx(seed=11)
    out = harness.drive(c, with_control=True)
    res = line(c, out)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e, _ = harness.cell_metrics(MANIFEST, NAME)
    assert set(res["metrics"]) == {m["name"] for m in e2e} == {"motion_s_per_s", "setup_s"}
    assert list(res["checks"]) == ["asr_enc_rel", "asr_logit_rel", "word_err", "latent_rel", "pose_err", "trans_rel"]
    limits = c.cell["limits"]
    assert out.control["asr_enc_rel"] > limits["asr_enc_rel"], out.control
    assert out.control["asr_logit_rel"] > limits["asr_logit_rel"], out.control


CASES = [(faults_asr.FAULTS, f) for f in faults_asr.FAULTS] + [
    (faults.FAULTS, f) for f in ("unchanged_state", "half_batch", "altered_answer")]


@pytest.mark.parametrize("table,fault", CASES, ids=[f for _, f in CASES])
def test_a_fault_in_the_timed_path_is_not_correct(table, fault, monkeypatch):
    table[fault](monkeypatch.setattr)
    c = ctx(seed=12)
    res = line(c, harness.drive(c))
    assert not res["correct"], res["checks"]


def test_a_run_loads_no_jax_and_the_reference_none_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "from benchmark.tests import test_bench_asr as T\n"
            "from benchmark import harness\n"
            "harness.drive(T.ctx())\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=900,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "syntalker_tpu_torch.models.whisper" in mods and "benchmark.drivers.serve_asr" in mods
    assert not {m for m in mods if m.split(".")[0] in harness.FORBIDDEN}
    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import benchmark.reference.whisper, benchmark.reference.align\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not {m for m in mods if m.split(".")[0] in harness.FORBIDDEN + ("syntalker_tpu_torch",)}


def test_the_benchmarks_reference_is_the_tests():
    assert (ROOT / "benchmark" / "reference" / "whisper.py").read_text() == (
        ROOT / "tests" / "whisper_reference.py").read_text()


def test_the_reference_alignment_gives_the_services_frame_ids():
    """Speech-like clips and 17–54 words: seed 318 puts a word's end on a
    frame's time exactly, where the interval's end must be computed as
    the service computes it."""
    vocab = Vocab()
    for w in map(str, range(0, 60, 2)):
        vocab.index_word(w)
    for seed in range(300, 330):
        rng = np.random.default_rng(seed)
        secs = 4 + 12 * rng.random()
        y = traffic.speech(rng, secs)
        words = [str(int(t)) for t in rng.integers(0, 60, math.ceil(3.5 * secs))]
        frames = len(y) * 30 // 16000
        want = ref_align.frame_ids(ref_align.align(words, y), frames, vocab.word2index, 30)
        assert np.array_equal(words_to_frame_ids(align_words_by_energy(words, y, 16000), frames, vocab, 30), want)


def test_large_v3_counts_by_hand():
    # the encoder over one 30 s window: 1.89 TFLOP in the linear layers, 0.37 in attention, 17.7 G in the convs
    d, t = 1280, 1500
    linear = 32 * 2 * t * (4 * d * d + 2 * d * 5120)
    attention = 32 * 4 * t * t * d
    convs = 2 * (3000 * 128 * 3 * d + t * d * 3 * d)
    assert (linear, attention, convs) == (1_887_436_800_000, 368_640_000_000, 17_694_720_000)
    assert RA.encoder_flops(LARGE, 8) == 8 * (linear + attention + convs)
    # a decode step at 8 rows reads 734 M block weights and the 66 M head in bf16, and 8 rows' cross K/V
    assert RA.step_params(LARGE) == 32 * (6 * d * d + 2 * d * 5120) + 51866 * d == 800_391_680
    cross = 8 * 32 * 2 * 1500 * d * 2
    assert RA.step_bytes(LARGE, 8, 0) == 2 * 800_391_680 + cross
    assert RA.step_bound_s(LARGE, 8, 30) == pytest.approx((1_600_783_360 + 8 * 32 * 2 * 1530 * d * 2) / 3.35e12)
    assert RA.encoder_bound_s(LARGE, 8) == pytest.approx(8 * (linear + attention + convs) / 989e12)


def records(flushes: int = 6) -> list:
    """The tracer's records of six flushes, each with a transcription: the
    decode at 8 rows, 3 real, 5 steps, 12 tokens kept."""
    out, i = [], 0
    for f in range(flushes):
        base = f * 1_000_000
        i += 1
        flush = i
        out.append({"id": flush, "parent": 0, "name": "serve.flush", "thread": 2, "start_ns": base,
                    "end_ns": base + 1000, "attrs": {}})
        for name, s, e, attrs in (("asr.encode", 0, 100, {}), ("asr.decode", 100, 400,
                                  {"rows": 8, "real": 3, "steps": 5, "tokens_real": 12}),
                                  ("asr.align", 400, 450, {}), ("serve.group", 450, 1000, {})):
            i += 1
            out.append({"id": i, "parent": flush, "name": name, "thread": 2, "start_ns": base + s,
                        "end_ns": base + e, "attrs": attrs})
    return out


def test_the_stage_numbers_and_their_readers():
    c = ctx()
    program = {"spans": {"asr.encode": {"calls": 2, "device_s": 0.5}, "asr.decode": {"calls": 2, "device_s": 0.25}}}
    a = serve_asr.asr_numbers(c, program, {"spans": records()})
    cfg, ctx_len = c.config["asr"], 4 + 6 / 2
    assert a["encode_bound_s"] == pytest.approx(2 * RA.encoder_bound_s(cfg, 8))
    assert a["decode_bound_s"] == pytest.approx(2 * 5 * RA.step_bound_s(cfg, 8, ctx_len))
    assert a["model_flop"] == pytest.approx(2 * RA.transcription_flops(cfg, 3, 12))
    assert (a["free_steps"], a["free_decode_s"], a["free_asr_s"], a["free_flush_s"]) == pytest.approx(
        (20, 4 * 300e-9, 4 * 450e-9, 4 * 1000e-9))
    s = {"asr": a, "busy_s": 0.25, "window_s": 1.0, "model_flop": 989e9}
    got = {m["name"]: harness.read_metric(m["name"], s) for m in MANIFEST["per_layer"] if NAME in m["workloads"]}
    assert got == pytest.approx({
        "asr_encode_roofline.asr": 100 * a["encode_bound_s"] / 0.5,
        "asr_step_ms.asr": 1e3 * 4 * 300e-9 / 20, "asr_step_roofline.asr": 100 * a["decode_bound_s"] / 0.25,
        "asr_share.asr": 45.0, "device_idle.asr": 75.0, "mfu.asr": 0.1})
    for name in got:
        assert harness.read_metric(name, {}) is None
