"""Driver of the live stream: ``StreamingMotionSession`` at B=1 through K1.

Traffic parameters (``benchmark/traffic/<name>.json``): ``utterance_s``,
the synthetic speech that set-up featurizes and the stream tiles for as
long as the window lasts; ``chunk_samples``, the feature rows of one push;
``judged_windows``, the windows the judge compares.

One session streams the whole run. Its pushes come back to back, ahead of
real time, so the next window's audio is always waiting; the session's
audio buffer grows through the run as a live session's does.
``window_p95_ms`` is the 95th percentile, over every window completed in
the timed window, of the time from the call to ``push_audio`` that
completed it to its return with the segment on the host.

The judge follows a sampled window from the program's own state: the seed
the session carried in (the last 4 latent frames of the window before,
read at the decode's input) and the translation it carried (the last one
it emitted). The start (the session's first window, from zeros) is judged
from nothing of the program's, and the carried latent ring is checked on
its own: each window's decode input must begin with the previous one's
last 24 latent frames, exactly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import judge, roofline, tracing, traffic
from benchmark.control import Control
from benchmark.harness import Ctx, Outcome
from benchmark.models import build, sub_seed
from benchmark.reference import audio as ref_audio
from benchmark.reference.precision import full_f32
from benchmark.reference.sampler import stream_window

LOOKBACK, LOOKAHEAD = 16, 8  # the session's defaults: latent frames of decode context and hold-back
TRACED_WINDOWS = 24


def inputs(ctx: Ctx):
    """One utterance's features (S, 2) and frame word ids (F,), rotated by
    a seeded offset; the stream reads them tiled (:func:`tile`)."""
    c, tr = ctx.config, ctx.traffic
    spf = c["sr"] // c["fps"]
    rng = np.random.default_rng(sub_seed(ctx.seed, "utterance"))
    y = traffic.speech(rng, tr["utterance_s"], c["sr"])
    frames = len(y) // spf
    feats = ref_audio.features(y[: frames * spf], c["sr"])
    words = traffic.words(rng, frames, c["mdm"]["vocab_size"])
    k = int(rng.integers(0, frames))
    return np.roll(feats, -k * spf, axis=0), np.roll(words, -k)


def tile(a: np.ndarray, start: int, stop: int) -> np.ndarray:
    """Rows [start, stop) of ``a`` repeated end to end."""
    return np.take(a, np.arange(start, stop), axis=0, mode="wrap")


def window_noise(ctx: Ctx, device):
    return torch.Generator(device).manual_seed(sub_seed(ctx.seed, "noise"))


def run(ctx: Ctx, with_control: bool = False) -> Outcome:
    from syntalker_tpu_torch import generation as G
    from syntalker_tpu_torch.models import rvqvae
    from syntalker_tpu_torch.streaming import StreamingMotionSession

    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    spf = c["sr"] // c["fps"]
    m = build(c, ctx.seed, dev, ctx.mark)
    ctx.mark("weights")
    feats, words = inputs(ctx)
    ctx.mark("inputs")
    sess = StreamingMotionSession(mdm=m.mdm, diffusion=m.diffusion, rvq_modules=m.rvq, stats=m.stats,
                                  latent_scale=c["latent_scale"], sr=c["sr"], fps=c["fps"],
                                  pose_length=c["pose_length"], pre_frames=c["pre_frames"],
                                  lookback=LOOKBACK, lookahead=LOOKAHEAD,
                                  generator=window_noise(ctx, dev), device=dev)
    sess.warm_up()
    ctx.mark("warm-up")

    hooks = tracing.Hooks()
    decoded = []  # the decode inputs of the session, in order
    hooks.wrap(G, "decode_latents", "decode", keep=lambda out, latents, **kw: decoded.append(latents))
    if ctx.trace:
        hooks.wrap(StreamingMotionSession, "push_audio", "push")
        hooks.wrap(G, "fused_window", "sample", shape=lambda mdm, fused, at, seed, noise: tuple(noise.shape))
        hooks.wrap(G, "encode_windows", "encode")
        hooks.wrap(rvqvae, "rvq_quantize_eval_fused", "snap", shape=lambda z, state, cfg: z.shape[0] * z.shape[1])
    traced = tracing.TracedWindow(hooks) if ctx.trace else None
    if traced:
        tracing.warm_profiler()
        ctx.mark("profiler")

    chunk = tr["chunk_samples"]
    latency, segments, at = [], [], []
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    pos = 0
    try:
        while True:
            if traced and traced.state == "ready" and len(latency) >= TRACED_WINDOWS:
                traced.start()
            a, w = tile(feats, pos, pos + chunk), tile(words, pos // spf, (pos + chunk) // spf)
            t = time.perf_counter()
            out = sess.push_audio(a, w)
            done = time.perf_counter()
            pos += chunk
            segments += out
            latency += [done - t] * len(out)
            at += [done - t0] * len(out)
            if traced and traced.state == "on" and len(latency) >= 2 * TRACED_WINDOWS:
                traced.stop()
            if done - t0 >= ctx.seconds and not (traced and traced.state != "done"):
                break
    finally:
        if traced and traced.state == "on":
            traced.stop()
        hooks.restore()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    records = decoded[: len(segments)]
    del sess, decoded

    summary = traced.summary() if traced and traced.state == "done" else None
    if summary:
        summary.update(layer_work(c, summary))
    e2e = {"window_p95_ms": 1e3 * float(np.percentile(latency, 95)), "setup_s": setup_s}
    checks, control = judged(ctx, m, (feats, words), records, segments, with_control)
    ms = 1e3 * np.asarray(latency)
    notes = {f"p{q}_ms": float(np.percentile(ms, q)) for q in (50, 90, 95, 99)}
    notes["audio_s"] = pos / c["sr"]
    quarter = max(1, len(ms) // 4)
    notes["first_last_quarter_p50_ms"] = [float(np.median(ms[:quarter])), float(np.median(ms[-quarter:]))]
    notes["slowest_ms_at_s"] = [[float(ms[i]), at[i]] for i in np.argsort(ms)[-8:]]
    return Outcome(attempted=len(latency), failed=0, e2e=e2e, checks=checks, memory_peak_bytes=peak,
                   summary=summary, breakdown=tracing.breakdown(summary) if summary else None, control=control,
                   notes=notes)


def layer_work(c: dict, s: dict) -> dict:
    """The bounds and model FLOPs of the traced windows, from their shapes."""
    m, r = c["mdm"], c["rvq"]
    steps = int(c["diffusion"]["respacing"][len("ddim"):])
    spf = c["sr"] // c["fps"]
    sample = s["span_shapes"].get("sample", [])
    snaps = s["span_shapes"].get("snap", [])
    flop = sum(sum(roofline.window_flops(m, b, t, steps)) + roofline.encode_flops(m, b, c["pose_length"] * spf,
                                                                                   c["pose_length"])
               for b, t, _ in sample)
    flop += sum(roofline.decode_flops(r, {0: dim}, 1, rows) for rows, dim in zip(snaps, _cycle(r["parts"])))
    return {"bound_s": {"k1": sum(roofline.k1_bound_s(m, b, t, steps) for b, t, _ in sample),
                        "k3": sum(roofline.k3_bound_s(n, r["num_quantizers"], r["nb_code"], r["code_dim"])
                                  for n in snaps)},
            "model_flop": flop, "windows": len(sample)}


def _cycle(parts: dict):
    while True:
        yield from parts.values()


def judged(ctx: Ctx, m, feed, records, segments, with_control: bool = False):
    """The judge's numbers over a seeded sample of the completed windows
    (the stream's first window and its last among them), as (name, value,
    limit); and the control's on the same windows, or None."""
    c, tr = ctx.config, ctx.traffic
    feats, words = feed
    spf, pl, pre = c["sr"] // c["fps"], c["pose_length"], c["pre_frames"]
    step = pl - pre * 4
    n = len(segments)
    rng = np.random.default_rng(sub_seed(ctx.seed, "judge"))
    k = min(max(0, tr["judged_windows"] - 2), max(0, n - 2))
    pick = sorted({0, n - 1} | {1 + int(j) for j in rng.choice(max(0, n - 2), k, replace=False)})
    ref = m.reference()
    ctl = Control(m, c) if with_control else None
    rows, ctl_rows = [], []
    g = window_noise(ctx, ctx.device)
    noise = {}
    for w in range(pick[-1] + 1):  # the session's noise, drawn in its order
        z = torch.randn(1, pl // 4, 1536, generator=g, device=ctx.device)
        if w in pick:
            noise[w] = z
    with torch.no_grad(), full_f32():
        for w in pick:
            f0 = w * step
            audio = torch.as_tensor(tile(feats, f0 * spf, (f0 + pl) * spf)[None], device=ctx.device)
            word = torch.as_tensor(tile(words, f0, f0 + pl)[None], device=ctx.device)
            prev = records[w - 1] if w else None
            seed = torch.zeros(1, pre, 1536, device=ctx.device) if prev is None else prev[:, -pre:]
            x_ref = stream_window(ref.sampler, audio, word, seed, noise[w])
            carry = None if w == 0 else segments[w - 1]["trans"][-1]
            frames = (0, (pl // 4 - LOOKAHEAD) * 4) if w == 0 else (LOOKBACK * 4, (LOOKBACK + pl // 4 - pre) * 4)
            seg = segments[w]
            made = [(rows, records[w], judge.returned(seg["axis_angle"], seg["trans"], seg["rot6d"], ctx.device))]
            if ctl:
                made.append((ctl_rows,) + ctl.stream_window(audio, word, seed, noise[w], prev, carry))
            for into, lat, got in made:
                row = judge.decode_errors(ref, lat[0], frames, got, carry=carry)
                if w == 0:
                    row["latent_rel"] = judge.rel(lat, x_ref)
                else:
                    ring = LOOKBACK + LOOKAHEAD
                    row["latent_rel"] = judge.rel(lat[:, ring:], x_ref[:, pre:])
                    row["ring_err"] = (lat[:, :ring] - prev[:, -ring:]).abs().max().item()
                into.append(row)
    return judge.checks(rows, ctx.cell["limits"]), judge.fold(ctl_rows) if ctl else None
