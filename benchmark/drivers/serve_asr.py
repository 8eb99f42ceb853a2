"""Driver of the service with its transcription stage: ``MotionGenerationService``
holding Whisper (``asr=``, a ``WhisperASR`` at the configuration's ``asr``
widths in bf16) and a word ``Vocab``, with ``start()``, a closed backlog of
buckets of audio-only requests (no ``words``, no prompts).

Traffic parameters (``benchmark/traffic/<name>.json``): ``max_batch`` and
``max_seconds`` of the service's bucket; ``seconds``, the [lo, hi) range of
request lengths (each bucket holds the same ``max_batch`` lengths spread
evenly over it, in a seeded order); ``tokens_per_second``: a request's cap
of new tokens is ceil(that x its seconds); ``pool_buckets``,
``warm_buckets`` and ``queued_buckets`` as in ``drivers/serve.py``;
``judged_buckets``, the window's first buckets, whose encoder outputs and
logits are kept for the judge; ``judged_requests``.

Set-up makes the MDM and RVQ-VAEs as ``drivers/serve.py`` does, Whisper's
weights on the device from the seed (one float32 draw scaled by
``benchmark.models``' rules, the encoder's position table the fixed
sinusoids, held in bf16), the word vocab (:func:`word_ids`), the pool and
the service, and flushes the warm buckets. The window and
``motion_s_per_s`` are ``drivers/serve.py``'s.

The judge, over a seeded sample of the judged buckets' requests, in three
stages:

1. Whisper: the encoder output the timed path produced against the
   reference's from the request's audio (``asr_enc_rel``), and its logits at
   every decoded position against the reference's full forward
   teacher-forced on the program's own tokens (``asr_logit_rel``), each the
   largest error over the largest reference value;
2. the words: the program's tokens through the reference's alignment and
   the vocab, against the frame ids the service used (``word_err``, the
   frames that differ);
3. the motion on those words, as ``drivers/serve.py`` judges it
   (``latent_rel``, ``pose_err``, ``trans_rel``).

A traced run records the program's spans and counters
(``utils/tracking.py``) over window flushes [0, 6), of which [2, 4) run
under the profiler; :func:`asr_numbers` reads them for the ``.asr``
metrics.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import judge, program_trace, tracing, traffic
from benchmark import roofline_asr as RA
from benchmark.control import LOWER, Control
from benchmark.drivers.serve import Baton, layer_work, wait
from benchmark.harness import Ctx, Outcome
from benchmark.models import _scale, build, sub_seed
from benchmark.reference import align as ref_align
from benchmark.reference import audio as ref_audio
from benchmark.reference import whisper as ref_whisper
from benchmark.reference.precision import ROUNDERS, full_f32
from syntalker_tpu_torch.models import whisper as W  # a program without Whisper fails here, at once

TRACED_FLUSHES = (2, 4)  # [first, last) flush of the window under the profiler
TRACER_FLUSHES = (0, 6)  # [first, last) flush of the window the program's tracer records
POSITIONS = "model.encoder.embed_positions.weight"  # fixed sinusoids, not drawn


def whisper_weights(model: torch.nn.Module, seed: int, device) -> dict:
    """name -> float32 tensor of every parameter but the encoder's position
    table, from one normal draw on ``device``."""
    shapes = {n: p.shape for n, p in model.state_dict().items() if n != POSITIONS}
    names = sorted(shapes)
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "whisper"))
    flat = torch.randn(sum(math.prod(shapes[n]) for n in names), generator=gen, device=device)
    out, pos = {}, 0
    for n in names:
        size = math.prod(shapes[n])
        t = flat[pos : pos + size].view(shapes[n])
        mul, add = _scale(n, t)
        out[n] = t * mul + add
        pos += size
    return out


def build_asr(cfg: dict, seed: int, device) -> W.WhisperASR:
    model = W.Whisper(W.WhisperConfig(**{k: cfg[k] for k in W.WhisperConfig.__dataclass_fields__}),
                      device=device, dtype=torch.bfloat16)
    with torch.no_grad():
        for n, t in whisper_weights(model, seed, device).items():
            model.get_parameter(n).copy_(t)
    return W.WhisperASR(model)


def word_ids(cfg: dict, seed: int) -> dict:
    """The MDM's word vocabulary over token ids: ``vocab_size - 4`` ids drawn
    from the seed, each as its decimal string, are the words 4, 5, ..."""
    rng = np.random.default_rng(sub_seed(seed, "vocab"))
    known = rng.permutation(cfg["asr"]["vocab_size"])[: cfg["mdm"]["vocab_size"] - 4]
    return {str(int(t)): 4 + i for i, t in enumerate(known)}


def pool(ctx: Ctx) -> list:
    """``pool_buckets`` buckets of request dicts (audio, seconds, cap)."""
    c, tr = ctx.config, ctx.traffic
    rng = np.random.default_rng(sub_seed(ctx.seed, "requests"))
    return [[{"seconds": float(s), "audio": traffic.speech(rng, s, c["sr"]),
              "cap": math.ceil(tr["tokens_per_second"] * s)}
             for s in traffic.lengths(rng, *tr["seconds"], tr["max_batch"])] for _ in range(tr["pool_buckets"])]


class TracedASRWindow(tracing.TracedWindow):
    """The traced window, the trace's JSON kept for the program's spans."""

    def summary(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = json.load(f)
        finally:
            os.remove(path)
        out = tracing.analyze(self.trace["traceEvents"])
        out["span_shapes"] = dict(self.hooks.calls)
        out["wall_s"] = self.wall_s
        return out


def run(ctx: Ctx, with_control: bool = False) -> Outcome:
    from syntalker_tpu_torch.data import vocab as V
    from syntalker_tpu_torch import generation as G
    from syntalker_tpu_torch.serving import MotionGenerationService, MotionRequest
    from syntalker_tpu_torch.utils import tracking

    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    m = build(c, ctx.seed, dev, ctx.mark)
    asr = build_asr(c["asr"], ctx.seed, dev)
    vocab = V.Vocab()
    vocab.word2index = word_ids(c, ctx.seed)
    ctx.mark("weights")
    buckets = pool(ctx)
    ctx.mark("inputs")
    svc = MotionGenerationService(mdm=m.mdm, diffusion=m.diffusion, rvq_modules=m.rvq, stats=m.stats,
                                  max_batch=tr["max_batch"], max_seconds=tr["max_seconds"],
                                  pose_length=c["pose_length"], pre_frames=c["pre_frames"],
                                  latent_scale=c["latent_scale"], sr=c["sr"], fps=c["fps"], fused_loop=True,
                                  device=dev, seed=sub_seed(ctx.seed, "service"), asr=asr, vocab=vocab)

    def submit(k: int) -> list:
        return [svc.submit(MotionRequest(audio=r["audio"], request_id=f"{k}.{j}", max_new_tokens=r["cap"]))
                for j, r in enumerate(buckets[k % len(buckets)])]

    ctx.mark("service")
    for k in range(tr["warm_buckets"]):
        submit(-1 - k)
        svc.flush()
    ctx.mark("warm-up")

    # what the judge reads, kept for the window's first judged_buckets flushes: one transcription and one decode
    # a flush, since every request of a bucket is audio-only and unprompted
    kept, calls = {}, {"asr": 0, "decode": 0}

    def slot(counter: str, back: int = 0):
        k = calls[counter] - back
        return kept.setdefault(k, {"logits": [], "words": []}) if k < tr["judged_buckets"] else None

    def keep_logits(out, *a, **kw):
        if slot("asr") is not None:
            slot("asr")["logits"].append(out.clone())

    def keep_words(out, *a, **kw):  # after the transcription they follow
        if slot("asr", back=1) is not None:
            slot("asr", back=1)["words"].append(out)

    def keep_once(counter: str, key: str):
        def keep(out, *a, **kw):
            if slot(counter) is not None:
                slot(counter)[key] = out
        return keep

    def keep_latents(out, latents, **kw):
        if slot("decode") is not None:
            slot("decode")["latents"] = latents
        calls["decode"] += 1

    def keep_tokens(out, *a, **kw):
        keep_once("asr", "tokens")(out)
        calls["asr"] += 1

    hooks = tracing.Hooks()
    hooks.wrap(asr, "encode", keep=keep_once("asr", "enc"))
    hooks.wrap(asr, "prefill", keep=keep_logits)
    hooks.wrap(asr, "step", keep=keep_logits)
    hooks.wrap(asr, "transcribe", keep=keep_tokens)
    hooks.wrap(V, "words_to_frame_ids", keep=keep_words)
    hooks.wrap(G, "decode_latents", keep=keep_latents)
    traced = TracedASRWindow(hooks) if ctx.trace else None
    baton = Baton(traced) if traced else None
    flushes = [0]
    if traced:
        tracing.warm_profiler()
        tracking.disable()
        tracking.drain()
        ctx.mark("profiler")
        orig_flush = svc.flush

        def flush():  # in the service's thread
            if flushes[0] == TRACER_FLUSHES[0]:
                tracking.enable()
            if flushes[0] == TRACED_FLUSHES[0]:
                baton.request("start")
            with torch.profiler.record_function("bench.flush"):
                out = orig_flush()
            flushes[0] += 1
            if flushes[0] == TRACED_FLUSHES[1]:
                baton.request("stop")
            if flushes[0] == TRACER_FLUSHES[1]:
                tracking.disable()
            return out

        svc.flush = flush

    queued = [submit(k) for k in range(tr["queued_buckets"])]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    svc.start()
    done, ends, k = [], [t0], 0
    try:
        while True:
            for ev in queued.pop(0):
                wait(ev, baton, k)
            t = time.perf_counter()
            done.append(k)
            ends.append(t)
            if t - t0 >= ctx.seconds and not (traced and (traced.state != "done"
                                                          or flushes[0] < TRACER_FLUSHES[1])):
                break
            queued.append(submit(k + tr["queued_buckets"]))
            k += 1
    finally:
        svc.stop()
        hooks.restore()
    window_s = t - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    motion_s = sum(sum(r["seconds"] for r in buckets[b % len(buckets)]) for b in done)
    e2e = {"motion_s_per_s": motion_s / window_s, "setup_s": setup_s}
    summary = traced.summary() if traced and traced.state == "done" else None
    if summary:
        drained = tracking.drain()
        summary["program"] = program_trace.read(traced.trace, drained)
        summary["asr"] = asr_numbers(ctx, summary["program"], drained)
        unprompted = SimpleNamespace(config=c, traffic=dict(tr, pattern=[[]] * tr["max_batch"]))
        flushes_traced = TRACED_FLUSHES[1] - TRACED_FLUSHES[0]
        summary["model_flop"] = (layer_work(unprompted, summary, flushes_traced)["model_flop"]
                                 + summary["asr"]["model_flop"])
    checks, control = judged(ctx, m, asr, buckets, done, kept, dict(svc.results), with_control)
    gaps = np.diff(ends)
    notes = {"bucket_s": {"median": float(np.median(gaps)), "min": float(gaps.min()), "max": float(gaps.max()),
                          "first": float(gaps[0]), "last": float(gaps[-1])}}
    return Outcome(attempted=len(done) * tr["max_batch"], failed=0, e2e=e2e, checks=checks, memory_peak_bytes=peak,
                   summary=summary, breakdown=tracing.breakdown(summary) if summary else None, control=control,
                   notes=notes)


def asr_numbers(ctx: Ctx, program: dict, drained: dict) -> dict:
    """The transcription stage's numbers from the program's spans: the
    encoder's and the decode steps' device time and bounds in the profiled
    flushes; the decode's host time and steps, the stage's host time and
    the flushes' wall time in the profiler-free ones; the model FLOPs of the
    profiled flushes' real rows."""
    a, rows = ctx.config["asr"], ctx.traffic["max_batch"]
    recs = {s["id"]: s for s in (program_trace._as_dict(s) for s in drained.get("spans", []))}
    flush_ids = [r["id"] for r in sorted(recs.values(), key=lambda r: r["start_ns"]) if r["name"] == "serve.flush"]
    profiled = set(flush_ids[TRACED_FLUSHES[0] - TRACER_FLUSHES[0] : TRACED_FLUSHES[1] - TRACER_FLUSHES[0]])
    spans = program.get("spans", {})
    out = {"encode_device_s": spans.get("asr.encode", {}).get("device_s", 0.0),
           "encode_bound_s": spans.get("asr.encode", {}).get("calls", 0) * RA.encoder_bound_s(a, rows),
           "decode_device_s": spans.get("asr.decode", {}).get("device_s", 0.0),
           "decode_bound_s": 0.0, "free_decode_s": 0.0, "free_steps": 0, "free_asr_s": 0.0, "free_flush_s": 0.0,
           "model_flop": 0.0}
    for r in recs.values():
        parent = recs.get(r["parent"])
        flush = r["id"] if r["name"] == "serve.flush" else (parent["id"] if parent and
                                                              parent["name"] == "serve.flush" else None)
        if flush is None or flush not in flush_ids:
            continue
        host = (r["end_ns"] - r["start_ns"]) * 1e-9
        if flush in profiled:
            if r["name"] == "asr.decode":
                at = r["attrs"]
                ctx_len = 4 + (at["steps"] + 1) / 2
                out["decode_bound_s"] += at["steps"] * RA.step_bound_s(a, at["rows"], ctx_len)
                out["model_flop"] += RA.transcription_flops(a, at["real"], at["tokens_real"])
        elif r["name"] == "serve.flush":
            out["free_flush_s"] += host
        elif r["name"].startswith("asr."):
            out["free_asr_s"] += host
            if r["name"] == "asr.decode":
                out["free_decode_s"] += host
                out["free_steps"] += r["attrs"]["steps"]
    return out


def judged(ctx: Ctx, m, asr, buckets, done, kept, results, with_control: bool = False):
    """The judge's numbers over a seeded sample of the judged buckets'
    requests (one at each position of the bucket, and the longest request
    of one more bucket) as (name, value, limit); and the control's on the
    same requests, or None."""
    c, tr = ctx.config, ctx.traffic
    a = c["asr"]
    pool_ = [k for k in done if k in kept]
    rng = np.random.default_rng(sub_seed(ctx.seed, "judge"))
    picks = [(int(rng.choice(pool_)), j) for j in range(tr["max_batch"])]
    extra = int(rng.choice(pool_))
    picks.append((extra, int(np.argmax([r["seconds"] for r in buckets[extra % len(buckets)]]))))
    picks = sorted(set(picks))[: tr["judged_requests"]]
    ref = m.reference()
    ctl = Control(m, c) if with_control else None
    low = ROUNDERS[LOWER[c["precision"]["asr"]]]
    weights = whisper_weights(asr.model, ctx.seed, ctx.device)
    ids = word_ids(c, ctx.seed)
    prompt = ref_whisper.prompt(a)
    plan_frames = int(tr["max_seconds"] * c["fps"])
    samples = c["sr"] // c["fps"] * plan_frames
    windows = (plan_frames - plan_frames % 8 - 16) // 112
    gen = torch.Generator(ctx.device).manual_seed(sub_seed(ctx.seed, "service"))
    draws = {}
    rows, ctl_rows = [], []
    with torch.no_grad(), full_f32():
        for k, j in picks:
            req, got = buckets[k % len(buckets)][j], kept[k]
            tokens = got["tokens"][j]
            n = max(1, len(tokens))
            logits = torch.stack([s[j] for s in got["logits"][:n]])
            mel = ref_whisper.log_mel(req["audio"], a["num_mel_bins"], ctx.device)
            seq = prompt + list(tokens[: n - 1])
            enc = ref_whisper.encode(weights, a, mel)
            want = ref_whisper.decode_logits(weights, a, seq, enc)[len(prompt) - 1 :]
            row = {"asr_enc_rel": judge.rel(got["enc"][j], enc), "asr_logit_rel": judge.rel(logits, want)}
            frames = min(len(req["audio"]) * c["fps"] // c["sr"], plan_frames)
            words = ref_align.frame_ids(ref_align.align([str(t) for t in tokens], req["audio"], c["sr"]), frames,
                                        ids, c["fps"])
            used = np.asarray(got["words"][j])
            row["word_err"] = float(len(words) != len(used) or (words != used).sum())
            # the motion, from the reference's words
            while len(draws) <= tr["warm_buckets"] + k:
                draws[len(draws)] = torch.randn(windows, tr["max_batch"], c["pose_length"] // 4, 1536,
                                                generator=gen, device=ctx.device)
            noise = draws[tr["warm_buckets"] + k][:, j : j + 1]
            y = np.zeros(samples, np.float32)
            y[: min(len(req["audio"]), samples)] = req["audio"][:samples]
            audio = torch.as_tensor(ref_audio.features(y, c["sr"])[None], device=ctx.device)
            w = np.zeros(plan_frames, np.int64)
            w[: len(words)] = words
            word = torch.as_tensor(w[None], device=ctx.device)
            lat_ref = ref.sampler.clip(audio, word, noise)
            res = results[f"{k}.{j}"]
            lat = got["latents"][j : j + 1]
            row.update(judge.decode_errors(ref, lat[0], (0, lat.shape[1] * 4),
                                           judge.returned(res.axis_angle, res.trans, None, ctx.device)))
            row["latent_rel"] = judge.rel(lat, lat_ref)
            rows.append(row)
            if ctl:
                enc_c = ref_whisper.encode(weights, a, mel, low)
                crow = {"asr_enc_rel": judge.rel(enc_c, enc),
                        "asr_logit_rel": judge.rel(ref_whisper.decode_logits(weights, a, seq, enc_c, low)[
                            len(prompt) - 1 :], want)}
                lat_c, ret_c = ctl.clip(audio, word, noise)
                crow.update(judge.decode_errors(ref, lat_c[0], (0, lat_c.shape[1] * 4), ret_c))
                crow["latent_rel"] = judge.rel(lat_c, lat_ref)
                ctl_rows.append(crow)
    return judge.checks(rows, ctx.cell["limits"]), judge.fold(ctl_rows) if ctl else None
