"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels (K1 whole-window DDIM loop, K2 block stack,
K3 residual-VQ snap) from ``syntalker_tpu_torch/csrc`` with nvcc, holds each
against its plain PyTorch version on the card at full width, then drives
``MotionGenerationService`` at the full ``MDMConfig()`` width with seeded
random weights: once through K1 (``fused_loop=True``) and once through K2,
both decoding through K3. Before that it times the GEMM of K1 and K2 alone at
the six shapes of the path, at 256 and 8,192 rows, beside its bound and
``torch.matmul`` (a yardstick; the port never calls it), K2 beside one
``torch.nn.TransformerEncoder``, and K3 at the serve flush's rows and at
the batch-256 knee. Last, the prompted body-part CFG path at the width of
``configs/diffusion_h3d.yaml``'s MDM: the prompted sampler through K2 against
the same sampler on the plain f32 ``MDM.denoise``, then a service flush that
mixes unprompted requests (K1) with two prompt configurations (one K2 call a
step each, the guidance branches stacked), all decoding through K3. Takes
about a minute and a half on an H100, the ~10 s build included.
Prints one JSON line per phase, then the ``kernels`` line, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch.data.audio import onset_amplitude_features
from syntalker_tpu_torch.data.stats import identity_pose_stats
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import Conditioning, MDMConfig, build_mdm
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
from syntalker_tpu_torch.ops import _build, mdm_cuda, quantize_cuda
from syntalker_tpu_torch.serving import MotionGenerationService, MotionRequest

H3D_CONFIG = "configs/diffusion_h3d.yaml"  # the mdm and guidance sections, copied by hand below

# H100 SXM data sheet, dense peaks at the 700 W limit
PEAK_BF16 = 989e12  # FLOP/s, tensor cores
PEAK_FP32 = 67e12  # FLOP/s, CUDA cores
PEAK_BYTES = 3.35e12  # bytes/s, HBM3

K2_REL, K1_REL = 1e-2, 1e-2  # bf16 rounding points shared; f32 sums in another order
K3_ATOL, K3_TIE = 1e-4, 1e-5  # quantized atol; top-2 gap below TIE*|r|^2 is a near tie
SAMPLER_REL = 5e-2  # bf16 weights and matmul inputs against f32, through 4 windows x 50 steps
SERVE_BATCH, SERVE_SECONDS = 8, 16.0  # 4 windows, 116 latent frames, 464 output frames
SERVE_LENGTHS_S = (16.0, 12.5, 9.0, 15.2, 6.3)  # five requests of different lengths
GUIDANCE = {"audio_scale": 1.0, "prompt_scale": 4.0}  # H3D_CONFIG's guidance

DEV = torch.device("cuda")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_launches() -> None:
    for counts in (mdm_cuda.launches, quantize_cuda.launches):
        for key in counts:
            counts[key] = 0


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(launch, reps: int = 20, iters: int = 5) -> float:
    """Mean device time of one ``launch()`` inside a CUDA graph of ``reps``
    of them, which is how the main path runs its kernels: launch gaps of a
    graph and a warm L2, no host time."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    return cuda_ms(graph.replay, iters) / reps


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out - ref).abs().max() / ref.abs().max().clamp_min(1e-12)).item()


def bound_ms(bytes_moved: float, bf16_flop: float = 0.0, fp32_flop: float = 0.0):
    """Least time for the work: bytes over HBM bandwidth against operations
    over the peak of their type. Returns (ms, 'bytes' | 'operations')."""
    t_bytes = bytes_moved / PEAK_BYTES
    t_ops = bf16_flop / PEAK_BF16 + fp32_flop / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# work counts from the shapes


def block_flops(cfg: MDMConfig, b: int, t: int):
    """(bf16 matmul FLOP, f32 attention FLOP) of one pass of the block stack."""
    d, f = cfg.latent_dim, cfg.ff_size
    rows = b * t
    mm = 2 * rows * (d * 3 * d + d * d + 2 * d * f) * cfg.num_layers
    attn = 2 * 2 * b * t * t * d * cfg.num_layers  # scores and probs @ v, all heads
    return mm, attn


def window_flops(cfg: MDMConfig, b: int, t: int, steps: int):
    """(bf16, f32) FLOP of K1's window: per step input_process, the x slab
    and style row of input_process2, the blocks and output_process; once per
    window the audio/word slab."""
    d, c, a = cfg.latent_dim, cfg.latent_total_dim, cfg.audio_feat_dim
    rows = b * t
    mm, attn = block_flops(cfg, b, t)
    per_step = mm + 2 * rows * (c * d + d * d + d * c) + 2 * b * d * d
    return steps * per_step + 2 * rows * a * d, steps * attn


def stack_design_bytes(cfg: MDMConfig, b: int, t: int, weight_bytes: int) -> int:
    """Bytes one pass of the stack moves as designed: the weights once, and
    per layer the f32 stream read by the two LayerNorms and read and written
    by proj and fc2, the bf16 LayerNorm output written and read twice, the
    f32 qkv buffer written and read, and the bf16 attention output and
    hidden layer written and read."""
    d, f, rows = cfg.latent_dim, cfg.ff_size, b * t
    per_layer = rows * (4 * d * 6 + 2 * d * 4 + 4 * 3 * d * 2 + 2 * d * 2 + 2 * f * 2)
    return weight_bytes + cfg.num_layers * per_layer


def rvq_design_bytes(n: int, q: int, k: int, d: int) -> int:
    """Device-memory bytes one K3 call moves as designed. The norms read the
    codebooks and the rows and write |c|^2, |x|^2 and the emptied keys; from
    then on the 6 MB of codebooks stay in L2, and so do the chosen codes.
    Per layer the distance launch reads the residual and |r|^2 once (a row
    tile's code tiles run side by side) and leaves one key a row; the apply
    launch reads and empties the key and writes the index, below the last
    layer reads and writes the residual and writes |r|^2, and at the last
    layer writes the output."""
    once = 4 * (q * k * d + n * d) + 4 * q * k + 4 * n + 8 * n
    distance = 4 * n * d + 4 * n + 8 * n
    apply = 2 * 8 * n + 4 * n
    return once + q * (distance + apply) + (q - 1) * (2 * 4 * n * d + 4 * n) + 4 * n * d


def window_design_bytes(cfg: MDMConfig, b: int, t: int, steps: int, weight_bytes: int, stack_weight_bytes: int) -> int:
    """Bytes one K1 window moves as designed. Once: the bf16 audio/word
    features and style rows read, their f32 slabs written. Per step: every
    weight (an upper count: the 50 MB L2 may keep part of the 38 MB from one
    step to the next); the stack as in ``stack_design_bytes``, less the first
    LayerNorm's read of the stream, which the prologue holds in registers;
    input_process (bf16 state read, bf16 x_emb written), the x slab (x_emb
    read, f32 written), the prologue (two f32 slabs and the style rows
    read, the f32 activation written), the last layer's bf16 copy written
    and read, and the update (f32 state read and written, bf16 copy
    written)."""
    d, c, a, rows = cfg.latent_dim, cfg.latent_total_dim, cfg.audio_feat_dim, b * t
    once = rows * (2 * a + 4 * d) + steps * b * d * (2 + 4)
    stack = stack_design_bytes(cfg, b, t, stack_weight_bytes) - stack_weight_bytes - rows * 4 * d
    around = rows * (2 * c + 2 * d + 2 * d + 4 * d + 2 * 4 * d + 4 * d + 2 * 2 * d + 2 * 4 * c + 2 * c) + b * 4 * d
    return once + steps * (weight_bytes + stack + around)


# ---------------------------------------------------------------------------
# phases


def phase_build() -> None:
    t0 = time.perf_counter()
    took = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": took})


def phase_gemm(cfg: MDMConfig) -> None:
    """The GEMM alone at the six (N, K) of the path, at the service's 256
    rows and at 8,192, each with the epilogue the path gives it. The two
    that read a LayerNorm are also timed with that launch in front."""
    d, f, c = cfg.latent_dim, cfg.ff_size, cfg.latent_total_dim
    E = mdm_cuda
    shapes = [  # name, N, K, reads a LayerNorm, epilogue
        ("qkv", 3 * d, d, True, E.EPI_STORE),
        ("proj", d, d, False, E.EPI_BIAS_RESIDUAL),
        ("fc1", f, d, True, E.EPI_BIAS_GELU_BF16),
        ("fc2", d, f, False, E.EPI_BIAS_RESIDUAL),
        ("input_process", d, c, False, E.EPI_BIAS_BF16),
        ("output", c, d, False, E.EPI_DDIM),
    ]
    g = torch.Generator(device=DEV).manual_seed(11)
    for m in (256, 8192):
        for name, n, k, ln, epi in shapes:
            x = torch.randn(m, k, device=DEV, generator=g)
            a = x.to(torch.bfloat16)
            w = (torch.randn(k, n, device=DEV, generator=g) / k**0.5).to(torch.bfloat16)
            bias = torch.randn(n, device=DEV, generator=g)
            scale, shift = torch.rand(k, device=DEV, generator=g) + 0.5, torch.randn(k, device=DEV, generator=g)
            to_h = epi in (E.EPI_BIAS_BF16, E.EPI_BIAS_GELU_BF16)
            out_f = None if to_h else torch.zeros(m, n, device=DEV)
            out_h = torch.zeros(m, n, dtype=torch.bfloat16, device=DEV) if to_h else None
            out = out_h if to_h else out_f

            def launch():
                E._Launcher("block_stack", DEV, count=False).gemm(
                    a, w, epi, bias=bias, out_f=out_f, out_h=out_h, ca=0.0, cb=1.0)

            launch()  # the residual and DDIM epilogues start from zeros
            ref = a.float() @ w.float() + bias
            err = rel_err(out.float(), torch.nn.functional.gelu(ref) if epi == E.EPI_BIAS_GELU_BF16 else ref)
            assert err <= K2_REL, (name, m, err)
            moved = nbytes(a, w, bias) + nbytes(out) * (2 if epi in (E.EPI_BIAS_RESIDUAL, E.EPI_DDIM) else 1)
            bms, by = bound_ms(moved, 2.0 * m * n * k)
            entry = {"phase": "gemm", "shape": name, "M": m, "N": n, "K": k, "rel_err": err, "ms": graph_ms(launch),
                     "bound_ms": bms, "bound_by": by, "library_ms": graph_ms(lambda: torch.matmul(a, w))}
            if ln:
                def layernorm():
                    E._Launcher("block_stack", DEV, count=False).layernorm(x, scale, shift, a)

                def separate():
                    layernorm()
                    launch()

                entry.update(layernorm_ms=graph_ms(layernorm), layernorm_then_gemm_ms=graph_ms(separate))
            emit(entry)


def phase_block_stack(mdm, cfg: MDMConfig) -> dict:
    """K2 against its plain version and timed: at the service's 8 samples,
    at the 24, 32 and 40 of the prompted path's 3, 4 and 5 stacked guidance
    branches (768 to 1,280 rows, where the GEMM takes other tiles), and at
    the batch-256 knee."""
    w = mdm_cuda.stack_block_weights(mdm)
    g = torch.Generator(device=DEV).manual_seed(2)
    res = {}
    # yardstick only: PyTorch's fused encoder at the same width, all in bf16
    layer = torch.nn.TransformerEncoderLayer(cfg.latent_dim, cfg.num_heads, cfg.ff_size, dropout=0.0,
                                             activation="gelu", batch_first=True, norm_first=True)
    encoder = torch.nn.TransformerEncoder(layer, cfg.num_layers, enable_nested_tensor=False)
    encoder = encoder.to(DEV, torch.bfloat16).eval().requires_grad_(False)
    for b in (SERVE_BATCH, 3 * SERVE_BATCH, 4 * SERVE_BATCH, 5 * SERVE_BATCH, 256):
        x = torch.randn(b, 32, cfg.latent_dim, device=DEV, generator=g)
        out = mdm_cuda.block_stack(x, w, num_heads=cfg.num_heads)
        ref = mdm_cuda.block_stack_plain(x, w, num_heads=cfg.num_heads)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        assert torch.isfinite(out).all() and err <= K2_REL, (b, err)
        ms = cuda_ms(lambda: mdm_cuda.block_stack(x, w, num_heads=cfg.num_heads), 10)
        plain_ms = cuda_ms(lambda: mdm_cuda.block_stack_plain(x, w, num_heads=cfg.num_heads), 10)
        xh = x.to(torch.bfloat16)
        library_ms = cuda_ms(lambda: encoder(xh), 10)
        mm, attn = block_flops(cfg, b, 32)
        bms, by = bound_ms(nbytes(*w.values()) + 2 * nbytes(x), mm, attn)
        res[b] = dict(rel_err=err, max_abs_err=(out - ref).abs().max().item(), ms=ms, plain_ms=plain_ms,
                      bound_ms=bms, bound_by=by, library_ms=library_ms,
                      design_bytes=stack_design_bytes(cfg, b, 32, nbytes(*w.values())),
                      launches_per_call=mdm_cuda.block_launches(cfg.num_layers))
        emit({"phase": "parity", "kernel": "block_stack", "batch": b, "tol": K2_REL,
              "library": "nn.TransformerEncoder bf16, residual stream in bf16", **res[b]})
    return res


def phase_ddim_window(mdm, cfg: MDMConfig, diffusion) -> dict:
    fused = mdm_cuda.FusedDDIMWindow(mdm, diffusion)
    g = torch.Generator(device=DEV).manual_seed(3)
    res = {}
    for b in (1, SERVE_BATCH, 32):
        x_init = torch.randn(b, 32, cfg.latent_total_dim, device=DEV, generator=g)
        cond = Conditioning(
            at_feat=torch.randn(b, 32, cfg.audio_feat_dim, device=DEV, generator=g),
            seed_emb=torch.randn(b, cfg.latent_dim, device=DEV, generator=g),
        )
        out = fused(x_init, cond)
        ref = fused.plain(x_init, cond)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        assert torch.isfinite(out).all() and err <= K1_REL, (b, err)
        entry = dict(rel_err=err, max_abs_err=(out - ref).abs().max().item())
        if b == SERVE_BATCH:  # the service's shape: time it there
            weights = [*fused.blocks.values(), fused.w_in, fused.w2_style, fused.w2_x, fused.w2_at, fused.w_out]
            bf, f32 = window_flops(cfg, b, 32, diffusion.num_steps)
            bms, by = bound_ms(nbytes(*weights, x_init, cond.at_feat, cond.seed_emb) + nbytes(x_init), bf, f32)
            entry.update(ms=cuda_ms(lambda: fused(x_init, cond), 10),
                         plain_ms=cuda_ms(lambda: fused.plain(x_init, cond), 3), bound_ms=bms, bound_by=by,
                         design_bytes=window_design_bytes(cfg, b, 32, diffusion.num_steps, nbytes(*weights),
                                                          nbytes(*fused.blocks.values())))
            # a second call with other inputs must see its own inputs, not the graph's stale buffers
            x2 = torch.randn(b, 32, cfg.latent_total_dim, device=DEV, generator=g)
            cond2 = Conditioning(at_feat=torch.randn(b, 32, cfg.audio_feat_dim, device=DEV, generator=g),
                                 seed_emb=torch.randn(b, cfg.latent_dim, device=DEV, generator=g))
            before = mdm_cuda.launches["ddim_window"]
            err2 = rel_err(fused(x2, cond2), fused.plain(x2, cond2))
            per_replay = mdm_cuda.launches["ddim_window"] - before
            assert err2 <= K1_REL, err2
            assert per_replay == mdm_cuda.window_launches(cfg.num_layers, diffusion.num_steps), per_replay
            entry.update(second_call_rel_err=err2, launches_per_replay=per_replay)
        res[b] = entry
        emit({"phase": "parity", "kernel": "ddim_window", "batch": b, "tol": K1_REL, **entry})
    return res


def near_tie_rows(x: torch.Tensor, codebooks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows whose top-2 code distances, along the plain version's residual
    chain, come within K3_TIE·|r|^2 of each other at some layer."""
    r = x.clone()
    tie = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for q, cb in enumerate(codebooks):
        r2 = (r * r).sum(-1, keepdim=True)
        dist = r2 - 2.0 * (r @ cb.T) + (cb * cb).sum(-1)[None]
        top2 = dist.topk(2, dim=-1, largest=False).values
        tie |= (top2[:, 1] - top2[:, 0]) <= K3_TIE * r2[:, 0]
        r = r - cb[idx[:, q].long()]
    return tie


def rvq_check(x: torch.Tensor, codebooks: torch.Tensor, out, idx) -> dict:
    """K3's result against its plain version: equal indices on every row
    without a near tie, and the output within K3_ATOL where they agree."""
    ref, ref_idx = quantize_cuda.rvq_encode_plain(x, codebooks)
    tie = near_tie_rows(x, codebooks, ref_idx)
    agree = (idx == ref_idx).all(-1)
    assert bool(agree[~tie].all()), f"K3 indices differ on {int((~agree & ~tie).sum())} rows without a near tie"
    err = (out - ref)[agree].abs().max().item()
    assert err <= K3_ATOL, err
    return dict(near_tie_rows=int(tie.sum()), rows_differing=int((~agree).sum()), max_abs_err=err)


def rvq_kernel_us(x: torch.Tensor, codebooks: torch.Tensor) -> dict:
    """Device µs a launch of each of K3's kernels (norms, distance, apply) in
    one call, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        quantize_cuda.rvq_encode_fused(x, codebooks)
        torch.cuda.synchronize()
    return {e.key.split("rvq_")[1].split("_kernel")[0]: e.self_device_time_total / e.count
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "rvq_" in e.key}


def phase_rvq(codebooks: torch.Tensor) -> dict:
    g = torch.Generator(device=DEV).manual_seed(4)
    res = {}
    torch.backends.cuda.matmul.allow_tf32 = False  # near_tie_rows' distances in full f32
    q, k, d = codebooks.shape
    for n in (SERVE_BATCH * 116, 256 * 116):
        x = torch.randn(n, d, device=DEV, generator=g)
        out, idx = quantize_cuda.rvq_encode_fused(x, codebooks)
        entry = rvq_check(x, codebooks, out, idx)
        out2, idx2 = quantize_cuda.rvq_encode_fused(x, codebooks)
        assert torch.equal(out, out2) and torch.equal(idx, idx2), "K3 differs between two calls"
        plan = quantize_cuda.rvq_plan(n, q, k, d)
        flop = 2 * n * q * k * d
        bms, by = bound_ms(nbytes(x, codebooks, out, idx), fp32_flop=flop)
        ms = cuda_ms(lambda: quantize_cuda.rvq_encode_fused(x, codebooks), 10)
        design = rvq_design_bytes(n, q, k, d)
        entry.update(rows=n, tile=f"{plan.rows}x{plan.codes}", blocks=plan.blocks, deterministic=True, ms=ms,
                     plain_ms=cuda_ms(lambda: quantize_cuda.rvq_encode_plain(x, codebooks), 10),
                     bound_ms=bms, bound_by=by, fp32_tflops=flop / ms / 1e9, design_bytes=design,
                     design_ms=1e3 * design / PEAK_BYTES, kernels_per_call=quantize_cuda.rvq_kernel_launches(q),
                     kernel_us=rvq_kernel_us(x, codebooks))
        res[n] = entry
        emit({"phase": "parity", "kernel": "rvq_encode", "tol": K3_ATOL, **entry})
    # every code twice: each row's distances tie exactly, and the lower index must win at every layer
    n = SERVE_BATCH * 116
    dup = codebooks.clone()
    dup[:, 1::2] = dup[:, 0::2]
    x = torch.randn(n, d, device=DEV, generator=g)
    out, idx = quantize_cuda.rvq_encode_fused(x, dup)
    assert bool((idx % 2 == 0).all()), "K3 took the higher of two equal codes"
    entry = rvq_check(x, dup[:, 0::2].contiguous(), out, idx // 2)
    emit({"phase": "parity", "kernel": "rvq_encode", "case": "every code twice", "rows": n, **entry})
    return res


def phase_samplers(mdm, cfg: MDMConfig, diffusion) -> None:
    """The K1 and K2 samplers (bf16) against the plain f32 reference sampler
    on the same windows and noise: 4 windows, 2 clips, seed carried."""
    plan = G.plan_windows(int(SERVE_SECONDS * 30))
    g = torch.Generator(device=DEV).manual_seed(9)
    b = 2
    aw = torch.rand(plan.num_windows, b, 533 * plan.pose_length, 2, device=DEV, generator=g)
    ww = torch.randint(0, cfg.vocab_size, (plan.num_windows, b, plan.pose_length), device=DEV, generator=g)
    seed = torch.zeros(b, plan.pre_frames, cfg.latent_total_dim, device=DEV)
    noise = G.draw_noise(plan, b, g, DEV)
    ref = G.sample_windows_lean(mdm, diffusion, plan, aw, ww, seed, noise)
    errs = {
        "ddim_window": rel_err(G.make_fused_loop_sampler(mdm, diffusion, plan)(aw, ww, seed, noise), ref),
        "block_stack": rel_err(G.sample_windows_fused(mdm, diffusion, plan, aw, ww, seed, noise), ref),
    }
    emit({"phase": "samplers", "reference": "sample_windows_lean f32", "windows": plan.num_windows, "batch": b,
          "tol": SAMPLER_REL, "rel_err": errs})
    assert all(e <= SAMPLER_REL for e in errs.values()), errs


def requests(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i, secs in enumerate(SERVE_LENGTHS_S):
        n = int(secs * 16000)
        t = np.arange(n) / 16000.0
        wave = 0.3 * np.sin(2 * np.pi * (110 + 40 * i) * t) * (1 + np.sin(2 * np.pi * 2.5 * t))
        wave = (wave + 0.05 * rng.standard_normal(n)).astype(np.float32)
        out.append(MotionRequest(audio=wave, words=rng.integers(1, 11195, int(secs * 30)), request_id=f"r{i}"))
    return out


def h3d_config() -> MDMConfig:
    """H3D_CONFIG's MDM (the port has no YAML loader yet): the default widths
    (latent 512, 8 blocks, 4 heads, ff 1024, vocab 11195) with the TMR
    prompt of 256 and the BatchNorm wav encoder."""
    return MDMConfig(use_prompt=True, prompt_dim=256, audio_norm="batch")


def prompted_requests(seed: int):
    """The five requests of ``requests(seed)``: two unprompted, one with an
    upper-body prompt, two with hands and lower-body prompts (three groups)."""
    reqs = requests(seed)
    rng = np.random.default_rng(seed + 100)
    for req, parts in zip(reqs[2:], (("upper",), ("hands", "lower"), ("hands", "lower"))):
        req.prompts = {p: rng.standard_normal(256).astype(np.float32) for p in parts}
        req.guidance = dict(GUIDANCE)
    return reqs


def timed_flush(svc, reqs):
    """Submit ``reqs``, flush, and return (results, ms by CUDA events, s by
    the host clock)."""
    for req in reqs:
        svc.submit(req)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    results = svc.flush()
    end.record()
    torch.cuda.synchronize()
    return results, start.elapsed_time(end), time.perf_counter() - t0


def device_profile(svc, reqs, rvq_kernels: int) -> dict:
    """One more flush under torch.profiler: device time by kernel and the
    device's busy share of the flush. Now and then the profiler drops the
    records of kernels that ran (seen in the card tests: none of a K3
    call's kernels in a call whose result was right, and a spin kernel
    launched beside the call); a profile that does not see the
    ``rvq_kernels`` K3 kernels the flush launches is taken once more, and
    ``attempts`` says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, ms, _ = timed_flush(svc, reqs)
        seen = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "rvq_" in e.key)
        if seen == rvq_kernels:
            break
    # device-side kernel rows only: an aten op's row repeats its kernels' time
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    gemms = [k for k in kernels if "gemm_kernel" in k[0]]
    rvq = [k for k in kernels if "rvq_" in k[0]]
    return {"attempts": attempt, "flush_ms": ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / ms,
            "gemm_ms": sum(k[1] for k in gemms), "gemm_calls": sum(k[2] for k in gemms),
            "gemm_mean_us": 1e3 * sum(k[1] for k in gemms) / max(1, sum(k[2] for k in gemms)),
            "rvq_ms": sum(k[1] for k in rvq), "rvq_kernels": sum(k[2] for k in rvq),
            "top": [{"kernel": k[:80], "ms": t, "calls": c} for k, t, c in kernels[:8]]}


def phase_serve(mdm, diffusion, rvq, fused_loop: bool) -> dict:
    svc = MotionGenerationService(mdm=mdm, diffusion=diffusion, rvq_modules=rvq, stats=identity_pose_stats(),
                                  max_batch=SERVE_BATCH, max_seconds=SERVE_SECONDS, fused_loop=fused_loop,
                                  device=DEV, seed=5)
    frames = svc.plan.out_latent_frames * svc.plan.squeeze
    _, cold_ms, _ = timed_flush(svc, requests(6))  # first use: cuDNN plans, allocator growth
    reset_launches()
    results, warm_ms, wall_s = timed_flush(svc, requests(7))
    counts = {**mdm_cuda.launches, **quantize_cuda.launches}
    assert len(results) == len(SERVE_LENGTHS_S)
    for r in results:
        assert r.axis_angle.shape == (frames, 165) and r.trans.shape == (frames, 3), r.axis_angle.shape
        assert np.isfinite(r.axis_angle).all() and np.isfinite(r.trans).all()
    path = "ddim_window" if fused_loop else "block_stack"
    layers, steps = mdm.cfg.num_layers, diffusion.num_steps
    per_window = mdm_cuda.window_launches(layers, steps) if fused_loop else steps * mdm_cuda.block_launches(layers)
    assert counts[path] == svc.plan.num_windows * per_window, (counts, per_window)
    assert counts["rvq_encode"] == len(rvq), counts  # one K3 call a body part
    # the service pads every request to the bucket length before featurizing it
    t0 = time.perf_counter()
    onset_amplitude_features(np.resize(requests(7)[0].audio, svc.samples), svc.sr)
    features_ms = 1e3 * (time.perf_counter() - t0)
    # K3's wrapper counts C calls; each call launches rvq_kernel_launches(Q) kernels
    rvq_kernels = sum(quantize_cuda.rvq_kernel_launches(module.cfg.quantizer.num_quantizers)
                      for module, _ in rvq.values())
    profile = device_profile(svc, requests(8), rvq_kernels)
    assert profile["rvq_kernels"] == rvq_kernels, (profile["rvq_kernels"], rvq_kernels)
    out = {"phase": "serve", "fused_loop": fused_loop, "requests": len(results), "batch": SERVE_BATCH,
           "windows": svc.plan.num_windows, "frames": frames, "first_flush_ms": cold_ms, "flush_ms": warm_ms,
           "flush_s_host": wall_s, "host_features_ms_per_request": features_ms, "launches": counts,
           "rvq_kernels": rvq_kernels, "profile": profile}
    emit(out)
    return out


def phase_prompted_samplers(mdm, diffusion) -> dict:
    """The prompted sampler (K2, bf16 weights) against the same sampler on
    the plain f32 ``MDM.denoise``: 4 windows, 2 clips, prompts on upper and
    hands, guidance 1/4. Also unguided (no prompts, the styled-only route),
    which gives the branch error that the guidance then weighs: each part's
    output is u + s_a·(a − u) + s_p·(p − u), so an error in the branches can
    grow by up to 1 + 2·prompt_scale = 9 times."""
    cfg = mdm.cfg
    plan = G.plan_windows(int(SERVE_SECONDS * 30))
    g = torch.Generator(device=DEV).manual_seed(12)
    b = 2
    aw = torch.rand(plan.num_windows, b, 533 * plan.pose_length, 2, device=DEV, generator=g)
    ww = torch.randint(0, cfg.vocab_size, (plan.num_windows, b, plan.pose_length), device=DEV, generator=g)
    seed = torch.zeros(b, plan.pre_frames, cfg.latent_total_dim, device=DEV)
    noise = G.draw_noise(plan, b, g, DEV)
    prompts = {p: torch.randn(b, cfg.prompt_dim, device=DEV, generator=g) for p in ("upper", "hands")}
    kernel = mdm_cuda.make_fused_denoise(mdm, mdm_cuda.stack_block_weights(mdm))

    def plain(x_t, t_emb, cond):
        return mdm.denoise(x_t, None, cond, t_emb=t_emb)

    def run(denoise, p):
        return G.sample_windows(mdm, diffusion, plan, aw, ww, seed, noise, sampler="ddim", prompts=p,
                                guidance=GUIDANCE, denoise=denoise)

    before = mdm_cuda.launches["block_stack"]
    guided = run(kernel, prompts)
    k2 = mdm_cuda.launches["block_stack"] - before
    errs = {"guided": rel_err(guided, run(plain, prompts)), "unguided": rel_err(run(kernel, None), run(plain, None))}
    amplification = errs["guided"] / errs["unguided"]
    out = {"phase": "prompted_samplers", "config": H3D_CONFIG, "reference": "sample_windows on MDM.denoise f32",
           "windows": plan.num_windows, "batch": b, "parts": sorted(prompts), "guidance": GUIDANCE,
           "branches": 2 + len(prompts), "tol": SAMPLER_REL, "rel_err": errs,
           "guided_over_unguided": amplification, "amplification_bound": 1 + 2 * GUIDANCE["prompt_scale"],
           "block_stack_launches": k2}
    emit(out)
    # at least one K2 replay a step: the guided run went through the kernel
    assert k2 >= plan.num_windows * diffusion.num_steps * mdm_cuda.block_launches(cfg.num_layers), k2
    assert errs["guided"] <= SAMPLER_REL and errs["unguided"] <= SAMPLER_REL, errs
    return out


def phase_serve_prompted(mdm, diffusion, rvq) -> dict:
    """One service flush of the five ``prompted_requests``: the unprompted
    group through K1, the upper group (3 branches, 24 samples) and the
    hands+lower group (4 branches, 32 samples) through one K2 call a step,
    nine K3 calls. Exact launch counts on the warm flush; each group alone
    after it, timed by CUDA events, with K2 at its shape held against the
    plain version; the device's busy share under the profiler."""
    svc = MotionGenerationService(mdm=mdm, diffusion=diffusion, rvq_modules=rvq, stats=identity_pose_stats(),
                                  max_batch=SERVE_BATCH, max_seconds=SERVE_SECONDS, fused_loop=True, device=DEV,
                                  seed=6)
    frames = svc.plan.out_latent_frames * svc.plan.squeeze
    _, cold_ms, _ = timed_flush(svc, prompted_requests(6))  # captures K1's graph and K2's at 24 and 32 samples
    reset_launches()
    results, warm_ms, wall_s = timed_flush(svc, prompted_requests(7))
    counts = {**mdm_cuda.launches, **quantize_cuda.launches}
    assert [r.request_id for r in results] == [f"r{i}" for i in range(len(SERVE_LENGTHS_S))]
    for r in results:
        assert r.axis_angle.shape == (frames, 165) and r.trans.shape == (frames, 3), r.axis_angle.shape
        assert np.isfinite(r.axis_angle).all() and np.isfinite(r.trans).all()
    layers, steps, windows = mdm.cfg.num_layers, diffusion.num_steps, svc.plan.num_windows
    want = {"ddim_window": windows * mdm_cuda.window_launches(layers, steps),
            "block_stack": 2 * windows * steps * mdm_cuda.block_launches(layers), "rvq_encode": 3 * len(rvq)}
    assert counts == want, (counts, want)

    groups = []
    reqs = prompted_requests(9)
    w = mdm_cuda.stack_block_weights(mdm)
    for name, members in (("unprompted", reqs[:2]), ("upper", reqs[2:3]), ("hands+lower", reqs[3:])):
        branches = 0 if name == "unprompted" else 2 + len(members[0].prompts)
        _, ms, _ = timed_flush(svc, members)
        entry = {"group": name, "requests": len(members), "flush_ms": ms, "branches": branches}
        if branches:  # K2 at the group's shape on the h3d weights, against its plain version
            x = torch.randn(branches * SERVE_BATCH, svc.plan.latent_window, mdm.cfg.latent_dim, device=DEV)
            err = rel_err(mdm_cuda.block_stack(x, w, num_heads=mdm.cfg.num_heads),
                          mdm_cuda.block_stack_plain(x, w, num_heads=mdm.cfg.num_heads))
            assert err <= K2_REL, (name, err)
            entry.update(k2_samples=x.shape[0], k2_rows=x.shape[0] * x.shape[1], k2_rel_err=err, k2_tol=K2_REL,
                         k2_ms=cuda_ms(lambda: mdm_cuda.block_stack(x, w, num_heads=mdm.cfg.num_heads), 10))
        groups.append(entry)
    t0 = time.perf_counter()
    onset_amplitude_features(np.resize(reqs[0].audio, svc.samples), svc.sr)
    features_ms = 1e3 * (time.perf_counter() - t0)
    rvq_kernels = 3 * sum(quantize_cuda.rvq_kernel_launches(module.cfg.quantizer.num_quantizers)
                          for module, _ in rvq.values())
    profile = device_profile(svc, prompted_requests(8), rvq_kernels)
    assert profile["rvq_kernels"] == rvq_kernels, (profile["rvq_kernels"], rvq_kernels)
    out = {"phase": "serve_prompted", "config": H3D_CONFIG, "requests": len(results), "batch": SERVE_BATCH,
           "windows": windows, "frames": frames, "first_flush_ms": cold_ms, "flush_ms": warm_ms,
           "flush_s_host": wall_s, "host_features_ms_per_request": features_ms, "launches": counts,
           "rvq_kernels": rvq_kernels, "groups": groups, "profile": profile}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.manual_seed(0)
    phase_build()

    cfg = MDMConfig()
    diffusion = make_diffusion(steps=1000, timestep_respacing="ddim50")
    mdm = build_mdm(cfg, seed=0, device=DEV)
    rvq = {part: build_rvqvae(RVQVAEConfig(input_dim=dim), seed=10 + i, device=DEV)
           for i, (part, dim) in enumerate((("upper", 78), ("hands", 180), ("lower", 57)))}

    phase_gemm(cfg)
    k2 = phase_block_stack(mdm, cfg)
    k1 = phase_ddim_window(mdm, cfg, diffusion)
    k3 = phase_rvq(rvq["upper"][1].codebook)
    phase_samplers(mdm, cfg, diffusion)
    serve_k1 = phase_serve(mdm, diffusion, rvq, fused_loop=True)
    serve_k2 = phase_serve(mdm, diffusion, rvq, fused_loop=False)
    del mdm
    h3d = build_mdm(h3d_config(), seed=1, device=DEV)
    phase_prompted_samplers(h3d, diffusion)
    serve_p = phase_serve_prompted(h3d, diffusion, rvq)

    src = "syntalker_tpu_torch/csrc/"
    k3_row = k3[SERVE_BATCH * 116]
    rows = [  # (name, source, TPU kernel, timings, kernels launched on the main path and on the prompted
        #         flush, (error, tolerance))
        ("ddim_window", src + "mdm_block.cu", "syntalker_tpu/ops/mdm_pallas.py:312", k1[SERVE_BATCH],
         serve_k1["launches"]["ddim_window"], serve_p["launches"]["ddim_window"],
         {"rel_err": k1[SERVE_BATCH]["rel_err"], "tol": K1_REL}),
        ("block_stack", src + "mdm_block.cu", "syntalker_tpu/ops/mdm_pallas.py:157", k2[SERVE_BATCH],
         serve_k2["launches"]["block_stack"], serve_p["launches"]["block_stack"],
         {"rel_err": k2[SERVE_BATCH]["rel_err"], "tol": K2_REL}),
        ("rvq_encode", src + "rvq_encode.cu", "syntalker_tpu/ops/quantize_pallas.py:33", k3_row,
         serve_k1["rvq_kernels"], serve_p["rvq_kernels"], {"abs_err": k3_row["max_abs_err"], "tol": K3_ATOL}),
    ]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r.get("library_ms"), "prompted_flush_launches": prompted,
         "error_vs_tol": err}
        for name, source, replaces, r, launches, prompted, err in rows
    ]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
