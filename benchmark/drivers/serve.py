"""Driver of the batching service: ``MotionGenerationService`` with
``start()``, a closed backlog of buckets.

Traffic parameters (``benchmark/traffic/<name>.json``): ``max_batch`` and
``max_seconds`` of the service's bucket; ``pattern``, the prompted parts of
each of a bucket's requests in submission order (an empty list is an
unprompted request), so every flush holds the same groups; ``seconds``,
the [lo, hi) range of request lengths: each bucket holds the same
``max_batch`` lengths spread evenly over it, in a seeded order;
``pool_buckets``, the distinct buckets made at set-up and cycled;
``warm_buckets``, the buckets flushed at set-up; ``queued_buckets``, how
many buckets the driver keeps submitted ahead of the one being served;
``judged_requests``, the requests the judge compares.

Set-up makes the pool with the general generator (speech-like audio at
16 kHz, word ids, one unit prompt vector of 256 a prompted part), builds
the service and flushes the warm buckets, which captures every graph the
window replays. The window opens at ``start()`` with the queue full and
closes when the first bucket completes at or after ``--seconds``: it holds
whole buckets only, all their work and all their time.
``motion_s_per_s`` is the requested seconds of the requests whose results
reached the host in it, over its length (padding to ``max_seconds`` is not
motion).

The judge replays the service's generator (one draw a group, groups in the
order of their first request) for each judged request's noise, and reads
each group's latents at the decode's input.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark import judge, roofline, tracing, traffic
from benchmark.control import Control
from benchmark.harness import Ctx, Outcome
from benchmark.models import build, sub_seed
from benchmark.reference import audio as ref_audio
from benchmark.reference.precision import full_f32

WAIT_S = 120.0  # a bucket that has not come back by then has failed
TRACED_FLUSHES = (2, 4)  # [first, last) flush of the window under the profiler


def pool(ctx: Ctx) -> list:
    """``pool_buckets`` buckets of request dicts (audio, words, prompts,
    seconds)."""
    c, tr = ctx.config, ctx.traffic
    rng = np.random.default_rng(sub_seed(ctx.seed, "requests"))
    out = []
    for _ in range(tr["pool_buckets"]):
        bucket = []
        for secs, parts in zip(traffic.lengths(rng, *tr["seconds"], len(tr["pattern"])), tr["pattern"]):
            bucket.append({"seconds": float(secs), "audio": traffic.speech(rng, secs, c["sr"]),
                           "words": traffic.words(rng, int(secs * c["fps"]), c["mdm"]["vocab_size"]),
                           "prompts": {p: traffic.unit_vector(rng, c["mdm"]["prompt_dim"]) for p in parts} or None})
        out.append(bucket)
    return out


def groups(pattern: list) -> list:
    """Each request's (group, row): groups in the order of their first
    request, rows in submission order."""
    keys, out = [], []
    for parts in pattern:
        key = tuple(sorted(parts))
        if key not in keys:
            keys.append(key)
        out.append((keys.index(key), sum(tuple(sorted(p)) == key for p in pattern[: len(out)])))
    return out


def run(ctx: Ctx, with_control: bool = False) -> Outcome:
    from syntalker_tpu_torch import generation as G
    from syntalker_tpu_torch.data import audio as A
    from syntalker_tpu_torch.models import rvqvae
    from syntalker_tpu_torch.serving import MotionGenerationService, MotionRequest

    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    guidance = c["guidance"]
    m = build(c, ctx.seed, dev, ctx.mark)
    ctx.mark("weights")
    buckets = pool(ctx)
    ctx.mark("inputs")
    svc = MotionGenerationService(mdm=m.mdm, diffusion=m.diffusion, rvq_modules=m.rvq, stats=m.stats,
                                  max_batch=tr["max_batch"], max_seconds=tr["max_seconds"],
                                  pose_length=c["pose_length"], pre_frames=c["pre_frames"],
                                  latent_scale=c["latent_scale"], sr=c["sr"], fps=c["fps"], fused_loop=True,
                                  device=dev, seed=sub_seed(ctx.seed, "service"))

    def submit(k: int) -> list:
        return [svc.submit(MotionRequest(audio=r["audio"], words=r["words"], request_id=f"{k}.{j}",
                                         prompts=r["prompts"], guidance=dict(guidance) if r["prompts"] else None))
                for j, r in enumerate(buckets[k % len(buckets)])]

    ctx.mark("service")
    for k in range(tr["warm_buckets"]):
        submit(-1 - k)
        svc.flush()
    ctx.mark("warm-up")

    hooks = tracing.Hooks()
    decoded = []  # every group's decode input, in flush and group order
    hooks.wrap(G, "decode_latents", "decode", keep=lambda out, latents, **kw: decoded.append(latents))
    traced = tracing.TracedWindow(hooks) if ctx.trace else None
    baton = Baton(traced) if traced else None
    if traced:
        tracing.warm_profiler()
        ctx.mark("profiler")
        hooks.wrap(A, "onset_amplitude_features", "features")
        hooks.wrap(G, "sample_windows", "sample_guided",
                   shape=lambda mdm, diffusion, plan, aw, *a, prompts=None, **kw: (aw.shape[0], aw.shape[1],
                                                                                 2 + len(prompts or {})))
        hooks.wrap(G, "fused_window", "sample_k1")
        hooks.wrap(G, "encode_windows", "encode")
        hooks.wrap(rvqvae, "rvq_quantize_eval_fused", "snap")
        flushes = [0]
        orig_flush = svc.flush

        def flush():  # in the service's thread
            if flushes[0] == TRACED_FLUSHES[0]:
                baton.request("start")
            with torch.profiler.record_function("bench.flush"):
                out = orig_flush()
            flushes[0] += 1
            if flushes[0] == TRACED_FLUSHES[1]:
                baton.request("stop")
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
            if t - t0 >= ctx.seconds and not (traced and traced.state != "done"):
                break
            queued.append(submit(k + tr["queued_buckets"]))
            k += 1
    finally:
        svc.stop()
        hooks.restore()
    window_s = t - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    per = [r["seconds"] for r in buckets[0]]
    motion_s = sum(sum(r["seconds"] for r in buckets[b % len(buckets)]) for b in done)
    e2e = {"motion_s_per_s": motion_s / window_s, "setup_s": setup_s}
    summary = traced.summary() if traced and traced.state == "done" else None
    if summary:
        summary.update(layer_work(ctx, summary, TRACED_FLUSHES[1] - TRACED_FLUSHES[0]))
    results = dict(svc.results)
    checks, control = judged(ctx, m, buckets, done, decoded, results, with_control)
    gaps = np.diff(ends)
    notes = {"bucket_s": {"median": float(np.median(gaps)), "min": float(gaps.min()), "max": float(gaps.max()),
                          "first": float(gaps[0]), "last": float(gaps[-1])}}
    return Outcome(attempted=len(done) * len(per), failed=0, e2e=e2e, checks=checks, memory_peak_bytes=peak,
                   summary=summary, breakdown=tracing.breakdown(summary) if summary else None, control=control,
                   notes=notes)


class Baton:
    """The traced flushes' edges, handed from the service's thread to the
    run's, which owns the profiler: the service waits at each edge until
    the profiler has started or stopped."""

    def __init__(self, traced: tracing.TracedWindow):
        self.traced, self.ask, self.done = traced, None, threading.Event()

    def request(self, what: str) -> None:
        self.done.clear()
        self.ask = what
        self.done.wait(WAIT_S)

    def serve(self) -> None:
        what, self.ask = self.ask, None
        if what:
            getattr(self.traced, what)()
            self.done.set()


def wait(ev: threading.Event, baton, k: int) -> None:
    deadline = time.perf_counter() + WAIT_S
    while not ev.wait(0.002 if baton else WAIT_S):
        if baton:
            baton.serve()
        if time.perf_counter() > deadline:
            raise RuntimeError(f"bucket {k} not served within {WAIT_S} s")


def layer_work(ctx: Ctx, s: dict, flushes: int) -> dict:
    """Bounds and model FLOPs of the traced flushes, real rows only for the
    FLOPs (padding is not model work)."""
    c, tr = ctx.config, ctx.traffic
    m, r = c["mdm"], c["rvq"]
    steps = int(c["diffusion"]["respacing"][len("ddim"):])
    spf, pl = c["sr"] // c["fps"], c["pose_length"]
    windows = (int(tr["max_seconds"] * c["fps"]) - 16) // 112
    t_lat = 32 + (windows - 1) * 28
    flop = 0.0
    for key in {tuple(sorted(p)) for p in tr["pattern"]}:
        b = sum(tuple(sorted(p)) == key for p in tr["pattern"])
        k = 1 if not key else 2 + len(key)
        enc = roofline.encode_flops(m, b, pl * spf, pl) * k
        if key:
            den = steps * roofline.denoise_flops(m, k * b, pl // 4, prompt=True)
        else:
            den = sum(roofline.window_flops(m, b, pl // 4, steps))
        flop += windows * (enc + den) + roofline.decode_flops(r, r["parts"], b, t_lat)
    guided = s["span_shapes"].get("sample_guided", [])
    return {"bound_s": {"k2": sum(w * steps * roofline.k2_bound_s(m, k * b, pl // 4) for w, b, k in guided)},
            "guided_steps": sum(w * steps for w, _, _ in guided), "model_flop": flop * flushes}


def judged(ctx: Ctx, m, buckets, done, decoded, results, with_control: bool = False):
    """The judge's numbers over a seeded sample of the completed requests
    (one at each position of the bucket, so every row of every group, and
    the longest request of one more bucket) as (name, value, limit); and
    the control's on the same requests, or None."""
    c, tr = ctx.config, ctx.traffic
    pattern = tr["pattern"]
    where = groups(pattern)
    n_groups = max(g for g, _ in where) + 1
    rng = np.random.default_rng(sub_seed(ctx.seed, "judge"))
    picks = [(int(rng.choice(done)), j) for j in range(len(pattern))]
    extra = int(rng.choice(done))
    picks.append((extra, int(np.argmax([r["seconds"] for r in buckets[extra % len(buckets)]]))))
    picks = sorted(set(picks))[: max(tr["judged_requests"], len(pattern))]
    ref = m.reference()
    ctl = Control(m, c) if with_control else None
    plan_frames = int(tr["max_seconds"] * c["fps"])
    samples = c["sr"] // c["fps"] * plan_frames
    windows = (plan_frames - plan_frames % 8 - 16) // 112
    gen = torch.Generator(ctx.device).manual_seed(sub_seed(ctx.seed, "service"))
    draws = {}
    rows, ctl_rows = [], []
    with torch.no_grad(), full_f32():
        for k, j in picks:
            g, row = where[j]
            draw = (tr["warm_buckets"] + k) * n_groups + g
            while len(draws) <= draw:
                draws[len(draws)] = torch.randn(windows, tr["max_batch"], c["pose_length"] // 4, 1536,
                                                generator=gen, device=ctx.device)
            req = buckets[k % len(buckets)][j]
            y = np.zeros(samples, np.float32)
            y[: min(len(req["audio"]), samples)] = req["audio"][:samples]
            audio = torch.as_tensor(ref_audio.features(y, c["sr"])[None], device=ctx.device)
            w = np.zeros(plan_frames, np.int64)
            w[: min(len(req["words"]), plan_frames)] = req["words"][:plan_frames]
            word = torch.as_tensor(w[None], device=ctx.device)
            noise = draws[draw][:, row : row + 1]
            prompts = None if not req["prompts"] else {
                p: torch.as_tensor(v[None], device=ctx.device) for p, v in req["prompts"].items()}
            lat_ref = ref.sampler.clip(audio, word, noise, prompts=prompts, guidance=c["guidance"])
            res = results[f"{k}.{j}"]
            made = [(rows, decoded[k * n_groups + g][row : row + 1],
                     judge.returned(res.axis_angle, res.trans, None, ctx.device))]
            if ctl:
                made.append((ctl_rows,) + ctl.clip(audio, word, noise, prompts, c["guidance"]))
            for into, lat, got in made:
                out = judge.decode_errors(ref, lat[0], (0, lat.shape[1] * 4), got)
                out["latent_rel"] = judge.rel(lat, lat_ref)
                into.append(out)
    return judge.checks(rows, ctx.cell["limits"]), judge.fold(ctl_rows) if ctl else None
