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
step each, the guidance branches stacked), all decoding through K3. Around
these: ``features`` times the host featurization of a request in its parts
(the C++ rolling max and peak picking beside their numpy versions, the
STFT and mel projection); ``stream`` drives ``StreamingMotionSession`` at
full width through K1 and K3 against the offline K1 sampler + decode, each
of its K3 calls held against the plain version on its own rows;
``rvq_encode_path`` runs ``RVQVAE.encode`` through K3; ``stream_prompted``
streams with an upper-body prompt and a style through K2. ``generate``
runs the port's ``generate`` CLI on a synthetic 44.1 kHz stereo wav with a
TextGrid: ``configs/diffusion_h3d.yaml`` with upper and lower text prompts
(TMR text pipeline, four guidance branches in one K2 call a step) and
``configs/diffusion_beat2.yaml`` unprompted in its bf16, each against the
same clip on the plain f32 ``MDM.denoise``, with exact K2 and K3 counts and
every K3 call held against the plain version. ``k3_1001`` repeats the K3
card test's 1,001-row cases, framed by spin kernels. ``train`` (last)
runs the train steps at full width with seeded random weights and
batches: the RVQ-VAE of ``configs/rvq_beat2.yaml`` (its upper part: the
lazy-init step held against the same step on the CPU, then 20 steps;
hands and lower a lazy-init step each), the denoiser of
``configs/diffusion_beat2.yaml`` on latents of those three encoders (step
1 in f32 against the CPU, then 20 steps in the yaml's bf16, one step
profiled) and the prompted denoiser of ``configs/diffusion_h3d.yaml`` (10
steps); each state is saved, loaded into a fresh model and stepped again,
bit for bit the uninterrupted step; then ``generate`` runs on the
checkpoints the phase wrote. Takes about five minutes on an H100, the
~10 s build included.
Prints one JSON line per phase, then the ``kernels`` line, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits non-zero before printing anything.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
from scipy.io import wavfile

from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch import native
from syntalker_tpu_torch.cli import generate as GEN
from syntalker_tpu_torch.config import load_config
from syntalker_tpu_torch.data import audio as A
from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.data.audio import onset_amplitude_features
from syntalker_tpu_torch.data.stats import identity_pose_stats
from syntalker_tpu_torch.device import full_f32
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import Conditioning, MDMConfig, build_mdm
from syntalker_tpu_torch.models.tmr import TextPipeline, embed_prompts
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae, draw_rvqvae
from syntalker_tpu_torch.ops import _build, mdm_cuda, quantize_cuda
from syntalker_tpu_torch.ops.quantize import _tile_to_codebook, code_distances, init_rvq_state
from syntalker_tpu_torch.serving import MotionGenerationService, MotionRequest
from syntalker_tpu_torch.streaming import StreamingMotionSession
from syntalker_tpu_torch.train import optim
from syntalker_tpu_torch.train.diffusion_trainer import (DiffusionTrainConfig, draw_diffusion, make_diffusion_train_step,
                                                         make_latent_encoder)
from syntalker_tpu_torch.train.loop import rvq_config
from syntalker_tpu_torch.train.rvq_trainer import RVQLossConfig, make_rvq_train_step, rvq_loss
from syntalker_tpu_torch.train.state import TrainState, create_train_state, load_checkpoint, save_checkpoint

H3D_CONFIG = "configs/diffusion_h3d.yaml"  # read through the port's load_config
BEAT2_CONFIG = "configs/diffusion_beat2.yaml"

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
STREAM_SECONDS = 16.0  # 4 windows, as one service request
STREAM_CHUNKS = (5000, 12345, 40000, 33333, 71000, 100003)  # ragged pushes, then the rest in one
STREAM_K3_ROWS = (24, 32, 52)  # a stream's decode buffers a part: flush, first window, steady window
# tests/test_streaming.py's margins of a stream against the whole-clip decode; reported, not held: at full width
# the decoder reaches past the 16/8-latent margins, in the JAX package alike (tests/test_torch_decode_reach.py)
DECODE_MARGIN, TRANS_REL = 5e-2, 1e-3
STREAM_ATOL = 1e-5  # the stream against the same chunks decoded from the offline latents: the same operations
ENCODE_REL = 1e-4  # the same codes, summed by K3 and by rvq_dequantize in another order, then decoded
# the generate phase's clip: 20 s (600 frames, 5 windows, 576 output frames); 16 s would give 4 windows, 464 frames
GENERATE_SECONDS, GENERATE_SR = 20.0, 44100
GENERATE_MIN_FRAMES = 480
GENERATE_PROMPTS = {"upper": "raise both arms above the head", "lower": "step to the left"}
RVQ_CONFIG = "configs/rvq_beat2.yaml"  # the RVQ-VAE train phase's part, batch, window and optimizer
TRAIN_STEPS = {"rvq": 20, "diffusion": 20, "prompted": 10}  # after the first step
TRAIN_SEED = 31
TRAIN_REL = 1e-4  # the card's f32 step 1 against the CPU's: TF32 off on both, sums in another order
TRAIN_TIE = 1e-5  # a Gumbel argmax whose top-2 perturbed logits lie within TRAIN_TIE·max|logit| is a near tie
# step 1's gradients, card against CPU, over the largest gradient: the card's backward runs its convolutions in TF32
# (operands rounded to 2^-11), the CPU's in f32: a few times 2 * 2^-11 apart; a wrong gradient (a missing term, a
# sign) would be of the gradient's own order
TRAIN_GRAD_REL = 3e-3
K3_CARD_ROWS, K3_CARD_REPEATS = 1001, 5  # the K3 card test's row count whose two failures were never diagnosed

DEV = torch.device("cuda")


def card_name_and_power_limit() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


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
    """K2 against its plain version and timed: at the prompted stream's 3
    samples, at the service's 8, at the 24, 32 and 40 of the prompted path's
    3, 4 and 5 stacked guidance branches (768 to 1,280 rows, where the GEMM
    takes other tiles), and at the batch-256 knee."""
    w = mdm_cuda.stack_block_weights(mdm)
    g = torch.Generator(device=DEV).manual_seed(2)
    res = {}
    # yardstick only: PyTorch's fused encoder at the same width, all in bf16
    layer = torch.nn.TransformerEncoderLayer(cfg.latent_dim, cfg.num_heads, cfg.ff_size, dropout=0.0,
                                             activation="gelu", batch_first=True, norm_first=True)
    encoder = torch.nn.TransformerEncoder(layer, cfg.num_layers, enable_nested_tensor=False)
    encoder = encoder.to(DEV, torch.bfloat16).eval().requires_grad_(False)
    for b in (3, SERVE_BATCH, 3 * SERVE_BATCH, 4 * SERVE_BATCH, 5 * SERVE_BATCH, 256):
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
    for n in STREAM_K3_ROWS:
        x = torch.randn(n, d, device=DEV, generator=g)
        out, idx = quantize_cuda.rvq_encode_fused(x, codebooks)
        entry = rvq_check(x, codebooks, out, idx)
        entry.update(rows=n, blocks=quantize_cuda.rvq_plan(n, q, k, d).blocks,
                     ms=cuda_ms(lambda: quantize_cuda.rvq_encode_fused(x, codebooks), 10))  # noqa: B023
        emit({"phase": "parity", "kernel": "rvq_encode", "case": "stream rows", "tol": K3_ATOL, **entry})
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
    """H3D_CONFIG's MDM: latent 512, 8 blocks, 4 heads, ff 1024, vocab
    11195, the TMR prompt of 256 and the BatchNorm wav encoder."""
    return load_config(H3D_CONFIG).mdm


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


# ---------------------------------------------------------------------------
# host featurization, the streaming session and the RVQ encode path


def host_ms(fn, reps: int = 3) -> float:
    """Mean host ms of ``fn()`` over ``reps`` calls after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def features_plain(y: np.ndarray) -> np.ndarray:
    """``onset_amplitude_features`` with the numpy rolling max and peak
    picking in place of the C++ ones."""
    env = A.onset_strength(y)
    rng = env.max() - env.min()
    if rng > 0:
        env = (env - env.min()) / rng
    onset = np.zeros(len(y), np.float32)
    samples = A.peak_pick_plain(env, **A.peak_pick_args()) * 512
    onset[samples[samples < len(y)]] = 1.0
    return np.stack([A.amplitude_envelope_plain(y), onset], axis=1)


def phase_features() -> list:
    """A request's host featurization in its parts, host ms: the rolling max
    (C++ and numpy), the STFT and mel projection (``onset_strength``, numpy
    in both), the peak picking (C++ and numpy) and the whole features with
    each. For the service's 16 s bucket, to which it pads every request, and
    for the five requests at their own lengths. C++ must equal numpy."""
    reqs = requests(7)
    clips = [("bucket", np.resize(reqs[0].audio, int(SERVE_SECONDS * 16000)))]
    clips += [(f"request_{secs}s", r.audio) for secs, r in zip(SERVE_LENGTHS_S, reqs)]
    args = A.peak_pick_args()
    out = []
    for name, y in clips:
        env = A.onset_strength(y)
        env = (env - env.min()) / (env.max() - env.min())
        assert np.array_equal(A.amplitude_envelope(y), A.amplitude_envelope_plain(y)), name
        assert np.array_equal(native.peak_pick(env, **args), A.peak_pick_plain(env, **args)), name
        assert np.array_equal(onset_amplitude_features(y), features_plain(y)), name
        entry = {"clip": name, "seconds": len(y) / 16000, "cpp_equals_numpy": True,
                 "rolling_max_ms": host_ms(lambda: A.amplitude_envelope(y)),  # noqa: B023 - called at once
                 "rolling_max_numpy_ms": host_ms(lambda: A.amplitude_envelope_plain(y)),  # noqa: B023
                 "stft_mel_ms": host_ms(lambda: A.onset_strength(y)),  # noqa: B023
                 "peak_pick_ms": host_ms(lambda: native.peak_pick(env, **args)),  # noqa: B023
                 "peak_pick_numpy_ms": host_ms(lambda: A.peak_pick_plain(env, **args)),  # noqa: B023
                 "features_ms": host_ms(lambda: onset_amplitude_features(y)),  # noqa: B023
                 "features_numpy_ms": host_ms(lambda: features_plain(y))}  # noqa: B023
        emit({"phase": "features", **entry})
        out.append(entry)
    return out


def stream_session(mdm, diffusion, rvq, **kw) -> StreamingMotionSession:
    return StreamingMotionSession(mdm=mdm, diffusion=diffusion, rvq_modules=rvq, stats=identity_pose_stats(),
                                  device=DEV, **kw)


def warm_session(make):
    """A session whose window programs are captured before its first window
    (``warm_up``). Returns (session, seconds ``warm_up`` took)."""
    sess = make()
    t0 = time.perf_counter()
    sess.warm_up()
    return sess, time.perf_counter() - t0


@contextlib.contextmanager
def recorded_k3():
    """Every K3 call made inside, kept as copies of (rows, codebooks, out,
    indices) for ``k3_calls_check`` after the run. The launches and their
    count are the wrapper's own."""
    calls, fused = [], quantize_cuda.rvq_encode_fused

    def record(x, codebooks):
        out, idx = fused(x, codebooks)
        calls.append((x.clone(), codebooks, out.clone(), idx.clone()))
        return out, idx

    quantize_cuda.rvq_encode_fused = record
    try:
        yield calls
    finally:
        quantize_cuda.rvq_encode_fused = fused


def k3_calls_check(calls) -> dict:
    """Each recorded K3 call held against the plain version on its own rows
    (``rvq_check``: indices equal off near ties, output within K3_ATOL)."""
    checks = [rvq_check(x, cb, out, idx) for x, cb, out, idx in calls]
    return {"calls": len(calls), "rows": sorted({x.shape[0] for x, *_ in calls}),
            "near_tie_rows": sum(c["near_tie_rows"] for c in checks),
            "rows_differing": sum(c["rows_differing"] for c in checks),
            "max_abs_err": max(c["max_abs_err"] for c in checks), "tol": K3_ATOL}


def stream_clip(seed: int):
    """The features of a 16 s request and its frame word ids."""
    req = requests(seed)[0]
    return onset_amplitude_features(req.audio[: int(STREAM_SECONDS * 16000)]), np.asarray(req.words)


def push_ragged(sess, feats, words) -> list:
    """The clip in STREAM_CHUNKS, then the rest, then ``finish``."""
    segs, pos = [], 0
    for size in STREAM_CHUNKS + (len(feats),):
        segs += sess.push_audio(feats[pos : pos + size], words[pos // sess.spf : (pos + size) // sess.spf])
        pos = min(pos + size, len(feats))
    return segs + sess.finish()


def window_ends(sess, n_windows: int) -> list:
    return [(w * sess.round_l + sess.pose_length) * sess.spf for w in range(n_windows)]


def timed_windows(sess, feats, words, n_windows: int) -> list:
    """Push the clip one window at a time: host ms of each window and of the
    flush, each ending in its segment's copy to the host."""
    ms, pos = [], 0
    for end in window_ends(sess, n_windows):
        t0 = time.perf_counter()
        assert len(sess.push_audio(feats[pos:end], words[pos // sess.spf : end // sess.spf])) == 1
        ms.append(1e3 * (time.perf_counter() - t0))
        pos = end
    sess.push_audio(feats[pos:], words[pos // sess.spf :])
    t0 = time.perf_counter()
    sess.finish()
    return ms + [1e3 * (time.perf_counter() - t0)]


def cuda_rows(prof) -> list:
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def profile_steady_window(sess, feats, words, n_windows: int, rvq_kernels: int) -> dict:
    """One steady window under torch.profiler: its device-busy share of the
    window's host time and its device->host copies. The first window runs
    unprofiled; a profile that misses some of the window's ``rvq_kernels``
    K3 kernels (the profiler drops records now and then) is taken again on
    the next window."""
    from torch.profiler import ProfilerActivity, profile

    ends = window_ends(sess, n_windows)
    sess.push_audio(feats[: ends[0]], words[: ends[0] // sess.spf])
    for w in range(1, n_windows):
        s0, s1 = ends[w - 1], ends[w]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.push_audio(feats[s0:s1], words[s0 // sess.spf : s1 // sess.spf])
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        rows = cuda_rows(prof)
        if sum(e.count for e in rows if "rvq_" in e.key) == rvq_kernels:
            break
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return {"window": w, "window_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_to_host_copies": sum(e.count for e in rows if "DtoH" in e.key),
            "host_to_device_copies": sum(e.count for e in rows if "HtoD" in e.key),
            "rvq_kernels": sum(e.count for e in rows if "rvq_" in e.key),
            "gemm_kernels": sum(e.count for e in rows if "gemm_kernel" in e.key)}


def chunked_decode(lat, rvq, sess):
    """The stream's motion by its definition, from the whole clip's latents
    (1, T, 1536): each window's decode buffer cut out (the first window's
    latents; ``lookback`` before a steady window's fresh latents to
    ``lookahead`` after them; the flush's tail), decoded alone by
    ``decode_latents``, its emitted frames kept, and the x/z translation
    velocity integrated over the emitted frames. Returns (axis-angle,
    translation) as numpy."""
    lw, la, lb, fresh = sess.lw, sess.lookahead, sess.lookback, sess.fresh_lat
    n, sq = lat.shape[1], sess.squeeze
    spans = [(0, lw, 0, lw - la)]  # (buffer start, buffer end, first emitted, end of emitted), latent frames
    for s in range(lw - la, n - la, fresh):
        spans.append((s - lb, s + fresh + la, s, s + fresh))
    spans.append((n - la - lb, n, n - la, n))
    aa, vel, height = [], [], []
    for b0, b1, e0, e1 in spans:
        dec = G.decode_latents(lat[:, b0:b1], rvq_modules=rvq, stats=identity_pose_stats())
        tr = dec["trans"][0].cpu().numpy()
        step = np.diff(tr, axis=0, prepend=np.zeros((1, 3), tr.dtype))  # the velocities the decode integrated
        keep = slice((e0 - b0) * sq, (e1 - b0) * sq)
        aa.append(dec["axis_angle"][0, keep].cpu().numpy())
        vel.append(step[keep])
        height.append(tr[keep, 1])
    trans = np.cumsum(np.concatenate(vel), axis=0)
    trans[:, 1] = np.concatenate(height)
    return np.concatenate(aa), trans


def phase_stream(mdm, diffusion, rvq) -> dict:
    """The streaming session at full width: a 16 s clip's features pushed in
    ragged chunks through K1 (one call a window) and K3 (three calls a
    window's decode and three at the flush). Each of the stream's K3 calls
    is held against the plain version on its own rows (K1 at B=1 is held in
    the parity phase). The session's bookkeeping is held against the offline
    K1 sampler on the same audio and noise with each window's decode buffer
    decoded alone (``chunked_decode``). Beside it, how far the stream lies
    from the whole clip decoded at once: reported, not held, since the
    full-width decoder reaches past the 16/8-latent margins. Exact counts
    from the wrappers and, for K3's kernels and the device->host copies,
    from a torch.profiler session of a second stream; the cold first window
    (K1's graph captured at it), the warm windows (captured before, by
    ``warm_up``) and a steady window's device-busy share."""
    cfg = mdm.cfg
    plan = G.plan_windows(int(STREAM_SECONDS * 30))
    g = torch.Generator(device=DEV).manual_seed(13)
    feats, words = stream_clip(13)
    noise = G.draw_noise(plan, 1, g, DEV)

    def make():
        return stream_session(mdm, diffusion, rvq, noise=noise)

    sess, warm_s = warm_session(make)
    reset_launches()
    with recorded_k3() as k3_calls:
        segs = push_ragged(sess, feats, words)
    torch.cuda.synchronize()
    counts = {**mdm_cuda.launches, **quantize_cuda.launches}
    k3 = k3_calls_check(k3_calls)
    windows = sess.stream_stats.windows_run
    per_window = mdm_cuda.window_launches(cfg.num_layers, diffusion.num_steps)
    rvq_kernels = quantize_cuda.rvq_kernel_launches(6)
    want = {"ddim_window": windows * per_window, "block_stack": 0, "rvq_encode": 3 * (windows + 1)}
    assert windows == plan.num_windows and counts == want, (windows, counts, want)

    aa = np.concatenate([s["axis_angle"] for s in segs])
    tr = np.concatenate([s["trans"] for s in segs])
    aw = torch.as_tensor(G.window_audio(feats[None], plan), device=DEV)
    ww = torch.as_tensor(G.window_words(words[None, : plan.n_frames], plan), device=DEV)
    seed = torch.zeros(1, plan.pre_frames, J.LATENT_DIM, device=DEV)
    batched = G.make_fused_loop_sampler(mdm, diffusion, plan)(aw, ww, seed, noise)
    # the offline sampler one window at a time, as the stream runs it: the same shapes, so the same latents; the
    # sampler over the whole clip encodes all windows in one batch, whose f32 sums reach K1's bf16 inputs
    # rounded differently, and the discontinuous snap can then take other codes
    sampler = G.make_fused_loop_sampler(mdm, diffusion, G.plan_windows(plan.pose_length))
    wins = []
    for w in range(plan.num_windows):
        wins.append(sampler(aw[w : w + 1], ww[w : w + 1], seed, noise[w : w + 1]))
        seed = wins[-1][:, -plan.pre_frames :]
    lat = torch.cat([wins[0]] + [x[:, plan.pre_frames :] for x in wins[1:]], dim=1)
    ref_aa, ref_tr = chunked_decode(lat, rvq, sess)
    assert aa.shape == ref_aa.shape == (plan.out_latent_frames * plan.squeeze, 165), (aa.shape, ref_aa.shape)
    assert np.isfinite(aa).all() and np.isfinite(tr).all()
    starts = [s["frame_start"] for s in segs]
    assert starts == list(np.cumsum([0] + [len(s["axis_angle"]) for s in segs[:-1]]))
    aa_err = float(np.abs(aa - ref_aa).max())
    tr_err = float(np.abs(tr - ref_tr).max() / max(1.0, np.abs(ref_tr).max()))
    # the whole clip decoded at once: equal to the stream as far as the decoder's reach ends inside the margins
    off = G.decode_latents(lat, rvq_modules=rvq, stats=identity_pose_stats())
    off_r6, off_tr = off["rot6d"][0].cpu().numpy(), off["trans"][0].cpu().numpy()
    r6_frame_err = np.abs(np.concatenate([s["rot6d"] for s in segs]) - off_r6).max(-1)
    whole = {"axis_angle_max_abs_err": float(np.abs(aa - off["axis_angle"][0].cpu().numpy()).max()),
             "rot6d_max_abs_err": float(r6_frame_err.max()),
             "frames_rot6d_err_over_margin": np.flatnonzero(r6_frame_err > DECODE_MARGIN).tolist(),
             "trans_rel_err": float(np.abs(tr - off_tr).max() / max(1.0, np.abs(off_tr).max())),
             "margins": {"axis_angle": DECODE_MARGIN, "trans_rel": TRANS_REL}}
    seed_err = rel_err(sess._state["seed"], lat[:, -plan.pre_frames :])
    batched_err = rel_err(lat, batched)

    # the same stream again under the profiler: K3's kernels and the copies to the host
    from torch.profiler import ProfilerActivity, profile

    for attempt in (1, 2):
        again, _ = warm_session(make)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            push_ragged(again, feats, words)
            torch.cuda.synchronize()
        rows = cuda_rows(prof)
        seen = sum(e.count for e in rows if "rvq_" in e.key)
        if seen == 3 * (windows + 1) * rvq_kernels:
            break
    d2h = sum(e.count for e in rows if "DtoH" in e.key)
    assert seen == 3 * (windows + 1) * rvq_kernels, seen
    assert d2h == windows + 1, d2h  # one segment a window and one at the flush

    cold = timed_windows(make(), feats, words, windows)
    warm = timed_windows(warm_session(make)[0], feats, words, windows)
    steady = profile_steady_window(warm_session(make)[0], feats, words, windows, 3 * rvq_kernels)
    assert steady["device_to_host_copies"] == 1, steady
    out = {"phase": "stream", "windows": windows, "frames": len(aa), "chunks": list(STREAM_CHUNKS),
           "axis_angle_max_abs_err": aa_err, "axis_angle_tol": STREAM_ATOL, "trans_rel_err": tr_err,
           "trans_tol": TRANS_REL, "seed_rel_err_vs_offline": seed_err,
           "reference": "make_fused_loop_sampler a window at a time, each window's decode buffer decoded alone",
           "whole_clip_decode": whole,
           "latent_rel_err_batched_vs_windowed_offline": batched_err, "batched_tol": SAMPLER_REL,
           "launches": counts, "rvq_kernels": seen, "profile_attempts": attempt,
           "device_to_host_copies": d2h, "warm_up_s": warm_s, "k3_vs_plain": k3,
           "cold_window_ms": cold[:-1], "cold_flush_ms": cold[-1], "cold_first_window_ms": cold[0],
           "warm_window_ms": warm[:-1], "warm_flush_ms": warm[-1],
           "warm_steady_window_ms": float(np.mean(warm[1:-1])), "steady_window_profile": steady}
    emit(out)
    assert aa_err <= STREAM_ATOL and tr_err <= TRANS_REL and batched_err <= SAMPLER_REL, (aa_err, tr_err)
    return out


def phase_stream_prompted(mdm, diffusion, rvq) -> dict:
    """The streaming session on the prompted path: the h3d MDM with the
    MotionCLIP style input, an upper-body prompt and a style, every DDIM
    step's three guidance branches in one K2 call, against the same stream
    on the plain f32 ``MDM.denoise``: the latents of every window (the
    seed and the tail ring) within SAMPLER_REL; each of the stream's K3
    calls against the plain version on its own rows. Exact counts."""
    cfg = mdm.cfg
    plan = G.plan_windows(int(STREAM_SECONDS * 30))
    g = torch.Generator(device=DEV).manual_seed(14)
    feats, words = stream_clip(14)
    kw = dict(noise=G.draw_noise(plan, 1, g, DEV), guidance=GUIDANCE,
              style=torch.randn(1, cfg.style_dim, device=DEV, generator=g),
              prompts={"upper": torch.randn(1, cfg.prompt_dim, device=DEV, generator=g)})
    sess, warm_s = warm_session(lambda: stream_session(mdm, diffusion, rvq, **kw))
    reset_launches()
    ends = window_ends(sess, plan.num_windows)
    states, ms, pos = [], [], 0
    with recorded_k3() as k3_calls:
        for end in ends:
            t0 = time.perf_counter()
            assert len(sess.push_audio(feats[pos:end], words[pos // sess.spf : end // sess.spf])) == 1
            ms.append(1e3 * (time.perf_counter() - t0))
            states.append({k: v.clone() for k, v in sess._state.items()})
            pos = end
        sess.finish()
    torch.cuda.synchronize()
    counts = {**mdm_cuda.launches, **quantize_cuda.launches}
    windows = len(ends)
    want = {"ddim_window": 0, "block_stack": windows * diffusion.num_steps * mdm_cuda.block_launches(cfg.num_layers),
            "rvq_encode": 3 * (windows + 1)}
    assert counts == want, (counts, want)
    k3 = k3_calls_check(k3_calls)

    def plain(x_t, t_emb, cond):
        return mdm.denoise(x_t, None, cond, t_emb=t_emb)

    ref = stream_session(mdm, diffusion, rvq, denoise=plain, **kw)
    errs, pos = [], 0
    for end, state in zip(ends, states):
        ref.push_audio(feats[pos:end], words[pos // ref.spf : end // ref.spf])
        errs.append(max(rel_err(state[k], ref._state[k]) for k in ("seed", "tail")))
        pos = end
    out = {"phase": "stream_prompted", "config": H3D_CONFIG + " with the MotionCLIP style input",
           "parts": ["upper"], "style": True, "branches": 3, "k2_samples": 3, "windows": windows,
           "reference": "the same stream on MDM.denoise f32", "latent_rel_err": errs, "tol": SAMPLER_REL,
           "launches": counts, "k3_vs_plain": k3, "warm_up_s": warm_s, "window_ms": ms}
    emit(out)
    assert max(errs) <= SAMPLER_REL, errs
    return out


def phase_rvq_encode_path(rvq) -> dict:
    """``RVQVAE.encode`` on (8, 464, dim) poses of each part through K3, one
    call each, its indices against the plain version on the same latent off
    near ties, and ``decode_indices(encode(x))`` against
    ``latent2origin(map2latent(x))``."""
    g = torch.Generator(device=DEV).manual_seed(15)
    out = {}
    for part, (module, state) in rvq.items():
        q = module.cfg.quantizer.num_quantizers
        x = torch.randn(8, 464, module.cfg.input_dim, device=DEV, generator=g)
        with torch.no_grad():
            before = quantize_cuda.launches["rvq_encode"]
            idx = module.encode(x, state)
            calls = quantize_cuda.launches["rvq_encode"] - before
            z = module.map2latent(x)
            decoded = module.decode_indices(idx, state)
            snapped = module.latent2origin(z, state)
        rows = z.reshape(-1, z.shape[-1])
        _, ref_idx = quantize_cuda.rvq_encode_plain(rows, state.codebook)
        tie = near_tie_rows(rows, state.codebook, ref_idx)
        agree = (idx.reshape(-1, q) == ref_idx).all(-1)
        assert calls == 1 and idx.shape == (8, 116, q), (calls, idx.shape)
        assert bool(agree[~tie].all()), f"{part}: encode differs from the plain version off near ties"
        err = rel_err(decoded, snapped)
        entry = {"part": part, "rows": rows.shape[0], "k3_calls": calls, "near_tie_rows": int(tie.sum()),
                 "rows_differing_from_plain": int((~agree).sum()), "decode_of_encode_rel_err": err,
                 "tol": ENCODE_REL, "encode_ms": cuda_ms(lambda: module.encode(x, state), 10)}  # noqa: B023
        emit({"phase": "rvq_encode_path", **entry})
        assert err <= ENCODE_REL, (part, err)
        out[part] = entry
    return out


def phase_k3_card_rows() -> dict:
    """K3 at K3_CARD_ROWS rows: every case of the card test
    ``test_rvq_encode_kernel_matches_plain``, run by its own check,
    K3_CARD_REPEATS times with another seed each time. A failing run keeps
    its traceback and the call's shapes, strides and dtypes. A wrong result
    fails the phase after the report; a run where only the profiler's
    kernel count is off (it drops records now and then) is reported."""
    import importlib.util

    # by path: a site-packages `tests` package would shadow the repo's namespace package
    spec = importlib.util.spec_from_file_location("card_tests", Path(__file__).parent / "tests" /
                                                  "test_torch_kernels_cuda.py")
    card_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card_tests)
    check_rvq_case, rvq_inputs = card_tests.check_rvq_case, card_tests.rvq_inputs

    cases = ("random", "duplicated_codes", "rows_on_codes", "bf16_rows", "strided_rows")
    runs, failures = 0, []
    for rep in range(K3_CARD_REPEATS):
        for qkd in ((6, 512, 512), (4, 64, 128)):
            for case in cases:
                runs += 1
                try:
                    check_rvq_case(DEV, K3_CARD_ROWS, qkd, case, seed=3 + rep)
                except Exception as e:  # noqa: BLE001 - kept with its traceback, judged below
                    last = traceback.extract_tb(e.__traceback__)[-1]
                    x, cb = rvq_inputs(case, K3_CARD_ROWS, *qkd, DEV, 3 + rep)
                    failures.append({"repeat": rep, "case": case, "qkd": list(qkd),
                                     "profiler_count_only": "rvq_kernels_in_one_call" in f"{last.name} {last.line}",
                                     "x": {"shape": list(x.shape), "stride": list(x.stride()), "dtype": str(x.dtype)},
                                     "codebooks": {"shape": list(cb.shape), "stride": list(cb.stride())},
                                     "traceback": traceback.format_exc()})
    out = {"phase": "k3_1001", "rows": K3_CARD_ROWS, "runs": runs, "failed": len(failures), "failures": failures}
    emit(out)
    wrong = [f for f in failures if not f["profiler_count_only"]]
    assert not wrong, wrong
    return out


def write_generate_inputs(d: Path, vocab_size: int, seconds: float = GENERATE_SECONDS) -> dict:
    """A synthetic int16 stereo wav at GENERATE_SR (speech-like bursts and
    pauses, so the resampling, the mono mix and the onsets run), a TextGrid
    of its words and a vocab JSON whose ids lie under ``vocab_size``."""
    g = np.random.default_rng(21)
    n = int(seconds * GENERATE_SR)
    t = np.arange(n) / GENERATE_SR
    env = (np.sin(2 * np.pi * 1.7 * t) > -0.2).astype(np.float64)
    y = 0.3 * env[:, None] * np.stack([np.sin(2 * np.pi * 150 * t), np.sin(2 * np.pi * 210 * t)], axis=1)
    y += 0.05 * g.standard_normal((n, 2))
    wav = d / "speech.wav"
    wavfile.write(str(wav), GENERATE_SR, (np.clip(y, -1, 1) * 32767).astype(np.int16))
    words = "so we raise our hands and then we step to the side and wave again".split()
    assert 4 + len(set(words)) <= vocab_size
    ids = {w: 4 + i for i, w in enumerate(dict.fromkeys(words))}
    (d / "vocab.json").write_text(json.dumps({"name": "words", "word2index": ids, "word2count": {w: 1 for w in ids}}))
    marks = [""] + words + [""]
    edges = np.linspace(0.0, seconds, len(marks) + 1)
    body = "".join(f'        intervals [{i + 1}]:\n            xmin = {a}\n            xmax = {b}\n'
                   f'            text = "{m}"\n' for i, (a, b, m) in enumerate(zip(edges[:-1], edges[1:], marks)))
    tg = d / "speech.TextGrid"
    tg.write_text(f'File type = "ooTextFile"\nObject class = "TextGrid"\n\nxmin = 0\nxmax = {seconds}\n'
                  f'tiers? <exists>\nsize = 1\nitem []:\n    item [1]:\n        class = "IntervalTier"\n'
                  f'        name = "words"\n        xmin = 0\n        xmax = {seconds}\n'
                  f'        intervals: size = {len(marks)}\n' + body)
    return {"wav": wav, "textgrid": tg, "vocab": d / "vocab.json"}


def phase_generate(name: str, yaml: str, overrides: list, prompts: dict) -> dict:
    """The port's ``generate`` CLI at full width on the card. First
    ``main()`` as a user runs it (cold: models built, K2's graph captured,
    the npz written and checked); then ``generate_clip`` on models and K2
    weights built once: a warm-up clip, a counted clip (exact K2 and K3
    counts, every K3 call held against the plain version), a profiled clip
    (K3's kernels, the device's busy share) and the same clip on the plain
    f32 ``MDM.denoise``, whose latents must lie within SAMPLER_REL."""
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        cfg0 = load_config(yaml, overrides)
        files = write_generate_inputs(d, cfg0.mdm.vocab_size)
        ov = overrides + [f"data.vocab_path={files['vocab']}"]
        argv = ["-c", yaml, "--wav", str(files["wav"]), "--textgrid", str(files["textgrid"]),
                "--out", str(d / "out.npz"), "--run-dir", str(d / "run"), *ov]
        for part, text in prompts.items():
            argv += [f"--{part}-prompt", text]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = GEN.main(argv)
        torch.cuda.synchronize()
        cold_ms = 1e3 * (time.perf_counter() - t0)
        with np.load(d / "out.npz") as f:
            npz = {k: f[k] for k in f.files}
        cfg = load_config(yaml, ov)
        mdm, rvq, diffusion, stats = models = GEN.load_models(cfg, DEV)
        frames = npz["poses"].shape[0]
        assert sorted(npz) == sorted(["poses", "trans", "betas", "expressions", "model", "gender",
                                      "mocap_frame_rate"]), sorted(npz)
        assert frames >= GENERATE_MIN_FRAMES and npz["poses"].shape == (frames, 165), npz["poses"].shape
        assert npz["trans"].shape == (frames, 3) and npz["expressions"].shape == (frames, 100)
        assert np.isfinite(npz["poses"]).all() and np.isfinite(npz["trans"]).all()

        pipeline = TextPipeline(device=DEV) if prompts else None
        weights = mdm_cuda.stack_block_weights(mdm)
        kernel = mdm_cuda.make_fused_denoise(mdm, weights)

        def clip(denoise, **kw):
            return GEN.generate_clip(cfg, files["wav"], textgrid=str(files["textgrid"]), prompts=prompts,
                                     generator=torch.Generator(DEV).manual_seed(cfg.train.seed), denoise=denoise,
                                     pipeline=pipeline, models=models, device=DEV, **kw)

        clip(kernel)  # captures K2's graph at this clip's K·B
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_k3() as k3_calls:
            res = clip(kernel)
            torch.cuda.synchronize()
        warm_ms = 1e3 * (time.perf_counter() - t0)
        counts = {**mdm_cuda.launches, **quantize_cuda.launches}
        k3 = k3_calls_check(k3_calls)
        plan = G.plan_windows(int(GENERATE_SECONDS * cfg.data.pose_fps), pose_length=cfg.data.pose_length,
                              pre_frames=cfg.pre_frames)
        branches = 2 + len(prompts) if prompts else 1
        want = {"ddim_window": 0, "rvq_encode": 3,
                "block_stack": plan.num_windows * diffusion.num_steps * mdm_cuda.block_launches(cfg.mdm.num_layers)}
        assert counts == want, (counts, want)
        rvq_kernels = 3 * quantize_cuda.rvq_kernel_launches(6)

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for attempt in (1, 2):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                start.record()
                clip(kernel)
                end.record()
                torch.cuda.synchronize()
            rows = cuda_rows(prof)
            seen = sum(e.count for e in rows if "rvq_" in e.key)
            if seen == rvq_kernels:
                break
        assert seen == rvq_kernels, (seen, rvq_kernels)
        busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
        clip_ms = start.elapsed_time(end)

        def plain(x_t, t_emb, cond):
            return mdm.denoise(x_t, None, cond, t_emb=t_emb, dtype=torch.float32)

        ref = clip(plain)
        err = rel_err(res["latents"], ref["latents"])
        # K2 at this clip's shape (all branches of a step in one call) against its plain version
        x = torch.randn(branches, plan.latent_window, cfg.mdm.latent_dim, device=DEV,
                        generator=torch.Generator(DEV).manual_seed(23))
        k2_err = rel_err(mdm_cuda.block_stack(x, weights, num_heads=cfg.mdm.num_heads),
                         mdm_cuda.block_stack_plain(x, weights, num_heads=cfg.mdm.num_heads))
        embed_ms = None
        if prompts:
            def embed():
                out = embed_prompts(cfg, prompts, pipeline)
                torch.cuda.synchronize()
                return out

            embed_ms = host_ms(embed)
    out = {"phase": "generate", "card": card_name_and_power_limit(), "config": yaml, "name": name,
           "overrides": overrides, "prompts": prompts,
           "dtype": str(cfg.mdm.dtype), "audio_dtype": str(cfg.mdm.audio_dtype), "seconds": GENERATE_SECONDS,
           "wav": f"int16 stereo {GENERATE_SR} Hz", "frames": frames, "windows": plan.num_windows,
           "steps": diffusion.num_steps, "branches": branches, "cold_main_ms": cold_ms, "warm_clip_ms": warm_ms,
           "profiled_clip_device_ms": clip_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / clip_ms,
           "profile_attempts": attempt, "tmr_embed_ms": embed_ms, "launches": counts, "rvq_kernels": seen,
           "k3_vs_plain": k3, "reference": "generate_clip on MDM.denoise f32", "latent_rel_err": err,
           "tol": SAMPLER_REL, "k2_rel_err_at_clip_shape": k2_err, "k2_tol": K2_REL,
           "main_latents_rel_err_vs_warm": rel_err(first["latents"], res["latents"])}
    emit(out)
    assert err <= SAMPLER_REL and k2_err <= K2_REL, (err, k2_err)
    return out


# ---------------------------------------------------------------------------
# train phase: the train steps at full width, checkpoints, generate on them
# ---------------------------------------------------------------------------


def timed_steps(step, state: TrainState, batches) -> tuple:
    """Run ``step`` over ``batches``; (state, last metrics, device ms of each
    step by CUDA events around it)."""
    marks = []
    for batch in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return state, metrics, [a.elapsed_time(b) for a, b in marks]


def warm_ms(ms: list) -> float:
    """Mean of the steps after the first two (allocator and cuDNN warm-up)."""
    return float(np.mean(ms[2:]))


def adam_moments(opt_state):
    """The ScaleByAdamState inside an optimizer chain."""
    if isinstance(opt_state, optim.ScaleByAdamState):
        return opt_state
    for s in opt_state if isinstance(opt_state, tuple) else ():
        found = adam_moments(s)
        if found is not None:
            return found
    return None


def leaf_errors(got: dict, ref: dict) -> dict:
    """Per-leaf max |got - ref| / max |ref|: the worst leaf and its value."""
    errs = {k: float((got[k].detach().cpu().double() - ref[k].detach().cpu().double()).abs().max())
            / max(float(ref[k].detach().abs().max()), 1e-30) for k in ref}
    worst = max(errs, key=errs.get)
    return {"worst_leaf": worst, "rel_err": errs[worst]}


def step_vs_cpu(card: TrainState, cpu: TrainState, lr: float, ref_mu: dict = None) -> dict:
    """Step 1 on the card against the same step on the CPU. Adam's first
    moment is 0.1 times the (clipped) gradient: the card's (convolution
    gradients in TF32) may differ from the CPU's (f32) by TRAIN_GRAD_REL of
    the largest gradient of the model. A bound per leaf would not hold: at
    random init, leaves whose gradients are 1e-3 of the largest are sums
    that cancel over the batch, and carry f32 rounding of 1e-3 of their own
    size even on the CPU (both are reported against ``ref_mu``, an f64
    gradient, where given). The forward's precision is held by the loss,
    the indices and the state at TRAIN_REL. Adam's first step moves a param by lr·g / (|g| + eps), which
    differs between two gradients g and g + d by at most
    lr·(eps/|g|)·(|d|/|g|): where the CPU's gradient exceeds 1000 times
    both eps and its distance to the card's, that is under 1e-6·lr, and
    the params must agree to TRAIN_REL of each leaf's largest; elsewhere
    (gradients within f32 noise of zero, such as a bias ahead of a norm)
    within Adam's bound of 2·lr."""
    mc, mp = adam_moments(card.opt_state).mu, adam_moments(cpu.opt_state).mu
    top = max(float(v.abs().max()) for v in mp.values())
    mu_err = max(float((mc[k].cpu() - v).abs().max()) for k, v in mp.items()) / top
    p_err, p_bound, determined, total = 0.0, 0.0, 0, 0
    for k, v in cpu.params.items():
        v = v.detach()
        d = (card.params[k].detach().cpu() - v).abs()
        g = mp[k].abs()
        sure = (g > 1000 * 1e-8 * 0.1) & (g > 1000 * (mc[k].cpu() - mp[k]).abs())
        determined += int(sure.sum())
        total += sure.numel()
        if bool(sure.any()):
            p_err = max(p_err, float(d[sure].max()) / max(float(v.abs().max()), 1e-30))
        p_bound = max(p_bound, float(d.max()))
    out = {"adam_mu_err_over_largest": mu_err, "grad_tol": TRAIN_GRAD_REL,
           "adam_mu_worst_leaf_card_vs_cpu": leaf_errors(mc, mp), "param_rel_err": p_err,
           "param_max_abs_diff": p_bound, "determined_share": determined / total, "tol": TRAIN_REL}
    if ref_mu is not None:
        top64 = max(float(v.abs().max()) for v in ref_mu.values())
        out["adam_mu_vs_f64"] = {
            side: {"err_over_largest": max(float((m[k].detach().cpu().double() - v.cpu()).abs().max())
                                           for k, v in ref_mu.items()) / top64, "worst_leaf": leaf_errors(m, ref_mu)}
            for side, m in (("card", mc), ("cpu", mp))}
    assert mu_err <= TRAIN_GRAD_REL and p_err <= TRAIN_REL and p_bound <= 2 * lr * (1 + 1e-5), out
    return out


def gumbel_tie_rows(z: torch.Tensor, qcfg, draws, idx: torch.Tensor) -> torch.Tensor:
    """Rows (of the lazy-init step) whose Gumbel-perturbed top-2 logits come
    within TRAIN_TIE·max|logit| at some layer, along the CPU's residual
    chain: the codebook of each layer is its lazy init from that chain."""
    r = z
    tie = torch.zeros(z.shape[0], dtype=torch.bool)
    for q in range(qcfg.num_quantizers):
        cb = _tile_to_codebook(r, qcfg.nb_code, draws.init_noise[q])
        logits = -code_distances(r, cb) / qcfg.gumbel_temperature - torch.log(-torch.log(draws.gumbel[q]))
        top2 = logits.topk(2, dim=-1).values
        tie |= (top2[:, 0] - top2[:, 1]) <= TRAIN_TIE * logits.abs().max(-1).values
        active = idx[:, q] >= 0
        r = r - active[:, None] * cb[idx[:, q].clamp_min(0)]
    return tie


def rvq_step_vs_cpu(module, step_card, state, batch, rcfg, tx, loss_cfg) -> tuple:
    """The lazy-init step on the card and on the CPU from the same params and
    draws: indices equal off near ties, loss and next quantizer state, and
    the step's Adam moments and params (``step_vs_cpu``; the warmup's first
    rate is 0, so the params must stay equal)."""
    cpu_module = copy.deepcopy(module).cpu()
    cpu_state = create_train_state(cpu_module, tx, torch.Generator(), quantizer_state=init_rvq_state(rcfg.quantizer))
    draws = draw_rvqvae(rcfg, batch.shape, state.generator, DEV)
    cdraws, cbatch = draws.to("cpu"), batch.cpu()
    with torch.no_grad():
        _, out = module(batch, state.quantizer_state, train=True, draws=draws)
        _, ref = cpu_module(cbatch, cpu_state.quantizer_state, train=True, draws=cdraws)
        z = cpu_module.encoder(cbatch)
    idx, ref_idx = out.indices.reshape(-1, rcfg.quantizer.num_quantizers).cpu(), ref.indices.reshape(
        -1, rcfg.quantizer.num_quantizers)
    tie = gumbel_tie_rows(z.reshape(-1, z.shape[-1]), rcfg.quantizer, cdraws.quantizer, ref_idx)
    agree = (idx == ref_idx).all(-1)
    assert bool(agree[~tie].all()), f"train indices differ on {int((~agree & ~tie).sum())} rows without a near tie"
    # the f64 gradient on the card, the yardstick of both f32 ones
    m64 = copy.deepcopy(module).double()
    d64 = copy.deepcopy(draws)
    d64.quantizer.gumbel = [u.double() for u in d64.quantizer.gumbel]
    q64 = init_rvq_state(rcfg.quantizer, DEV)
    q64 = dataclasses.replace(q64, codebook=q64.codebook.double(), code_sum=q64.code_sum.double(),
                              code_count=q64.code_count.double())
    rec64, out64 = m64(batch.double(), q64, train=True, draws=d64)
    loss64, _ = rvq_loss(rec64, batch.double(), out64.commit_loss, loss_cfg)
    grads64 = torch.autograd.grad(loss64, list(m64.parameters()))
    ref_mu = {n: 0.1 * g for (n, _), g in zip(m64.named_parameters(), grads64)}
    del m64, rec64, out64, loss64
    state, metrics = step_card(state, batch, draws=draws)
    cpu_state, cpu_metrics = make_rvq_train_step(cpu_module, tx, loss_cfg)(cpu_state, cbatch, draws=cdraws)
    # codes that a differing row chose on either side take other EMA updates
    touched = torch.zeros(rcfg.quantizer.num_quantizers, rcfg.quantizer.nb_code, dtype=torch.bool)
    for q in range(rcfg.quantizer.num_quantizers):
        for i in (idx, ref_idx):
            rows = i[~agree, q]
            touched[q, rows[rows >= 0]] = True
    qs, qc = state.quantizer_state, cpu_state.quantizer_state
    state_err = max(rel_err(getattr(qs, n).cpu()[~touched], getattr(qc, n)[~touched])
                    for n in ("codebook", "code_sum", "code_count"))
    loss_err = abs(float(metrics["loss"]) - float(cpu_metrics["loss"])) / abs(float(cpu_metrics["loss"]))
    # a differing row moves its frames' reconstruction: ~1e-3 of the loss at most
    loss_tol = TRAIN_REL if bool(agree.all()) else 1e-3
    out = {"near_tie_rows": int(tie.sum()), "rows_differing": int((~agree).sum()), "quantizer_state_rel_err": state_err,
           "loss_rel_err": loss_err, "loss_tol": loss_tol}
    assert state_err <= TRAIN_REL and loss_err <= loss_tol, out
    out.update(step_vs_cpu(state, cpu_state, lr=0.0, ref_mu=ref_mu))
    return state, metrics, out


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode
    (warnings recorded, not raised) for the round trip's two steps."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark, torch.are_deterministic_algorithms_enabled()
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        cudnn.deterministic, cudnn.benchmark = prev[:2]
        torch.use_deterministic_algorithms(prev[2])


def states_equal(a: TrainState, b: TrainState) -> bool:
    from syntalker_tpu_torch.bridge import optax_state_to_flax

    same = all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    fa, fb = optax_state_to_flax(a.opt_state, a.layout), optax_state_to_flax(b.opt_state, b.layout)

    def eq(x, y):
        return all(eq(x[k], y[k]) for k in x) if isinstance(x, dict) else bool(np.array_equal(x, y))

    same &= eq(fa, fb) and a.step == b.step
    same &= all(torch.equal(a.model_state[k], b.model_state[k]) for k in a.model_state or {})
    if a.quantizer_state is not None:
        same &= all(torch.equal(getattr(a.quantizer_state, n), getattr(b.quantizer_state, n))
                    for n in ("codebook", "code_sum", "code_count"))
    return bool(same)


def round_trip(make, state: TrainState, step, batch, ckpt_dir: Path) -> dict:
    """Save ``state``, take one more step; load the file into a fresh model
    and state (``make(seed)`` -> (state, step, module), other initial
    values) and take the same step: both must agree bit for bit."""
    path = save_checkpoint(ckpt_dir, state)
    with deterministic() as caught:
        state, _ = step(state, batch)
        fresh, fresh_step, _ = make(TRAIN_SEED + 100)
        load_checkpoint(path, fresh)
        fresh, _ = fresh_step(fresh, batch)
        torch.cuda.synchronize()
    equal = states_equal(state, fresh)
    assert equal, "the resumed step differs from the uninterrupted one"
    return {"checkpoint": path.name, "mb": path.stat().st_size / 2**20, "resumed_step_bit_for_bit": equal,
            "nondeterminism_warnings": sorted({str(w.message).split(".")[0] for w in caught})}, state


def busy_share(step, state: TrainState, batch) -> dict:
    """One step under torch.profiler: its kernels' device time over the
    step's time (CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        state, _ = step(state, batch)
        end.record()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in cuda_rows(prof)) / 1e3
    step_ms = start.elapsed_time(end)
    return {"profiled_step_ms": step_ms, "device_busy_ms": busy, "device_busy_share": busy / step_ms,
            "kernels": sum(e.count for e in cuda_rows(prof))}


def train_rvq(part: str, steps: int, d: Path, overrides=(), batch=None) -> tuple:
    """An RVQ-VAE of ``configs/rvq_beat2.yaml`` for one body part: the
    lazy-init step (held against the CPU for the yaml's part), then
    ``steps`` steps, then the round trip. Returns (phase dict, checkpoint,
    (module, quantizer state))."""
    cfg = load_config(RVQ_CONFIG, list(overrides))
    rt = cfg.rvq_train
    rcfg = rvq_config(cfg, part)
    tx = optim.make_rvq_optimizer(rt.lr, rt.warmup_iters, rt.milestones, rt.gamma)
    loss_cfg = RVQLossConfig(commit_weight=rt.commit_weight)

    def make(seed):
        module = build_rvqvae(rcfg, seed=seed, device=DEV)[0]
        state = create_train_state(module, tx, torch.Generator(DEV).manual_seed(seed),
                                   quantizer_state=init_rvq_state(rcfg.quantizer, DEV))
        return state, make_rvq_train_step(module, tx, loss_cfg), module

    state, step, module = make(TRAIN_SEED)
    g = torch.Generator(DEV).manual_seed(TRAIN_SEED + 1)
    b = batch or rt.batch_size

    def batch_of():
        return torch.randn(b, rt.window, rcfg.input_dim, generator=g, device=DEV)

    out = {"part": part, "input_dim": rcfg.input_dim, "width": rcfg.width, "depth": rcfg.depth,
           "codebooks": [rcfg.quantizer.num_quantizers, rcfg.quantizer.nb_code, rcfg.quantizer.code_dim],
           "batch": b, "window": rt.window}
    torch.cuda.reset_peak_memory_stats()
    first = batch_of()
    if part == rt.body_part:
        state, _, out["step1_vs_cpu"] = rvq_step_vs_cpu(module, step, state, first, rcfg, tx, loss_cfg)
    else:
        state, _ = step(state, first)
    if steps:
        state, metrics, ms = timed_steps(step, state, [batch_of() for _ in range(steps)])
        out.update(steps=steps, warm_step_ms=warm_ms(ms), step_ms=ms,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
                   **{k: float(v) for k, v in metrics.items()})
        # the yardstick of the backward's precision: the same step with its gradients in full f32, where cuDNN
        # picks FFT algorithms with a large workspace (the train step leaves the backward at PyTorch's TF32 default)
        torch.cuda.reset_peak_memory_stats()
        with full_f32():
            state, _, f32_ms = timed_steps(step, state, [batch_of() for _ in range(2)])
        out["full_f32_backward"] = {"step_ms": f32_ms[-1], "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}
        rt_out, state = round_trip(make, state, step, batch_of(), d / f"rvq_{part}_rt")
        out["round_trip"] = rt_out
    else:
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2**30
    emit({"phase": "train", "card": card_name_and_power_limit(), "model": f"rvq_{part}", **out})
    assert all(np.isfinite(v) for v in out.values() if isinstance(v, float))
    path = save_checkpoint(d / f"rvq_{part}", state)
    return out, path, (module, state.quantizer_state)


def train_mdm(yaml: str, overrides: list, steps: int, d: Path, latent_fn=None, check_cpu: bool = False,
              batch=None, name: str = "") -> tuple:
    """A denoiser of ``yaml`` (+ overrides): optionally step 1 in f32
    against the CPU, then ``steps`` timed steps of the config as it
    stands, a profiled step, the round trip. Returns (phase dict,
    checkpoint path)."""
    cfg = load_config(yaml, overrides)
    b = batch or cfg.train.batch_size
    frames = cfg.data.pose_length
    diffusion = make_diffusion(steps=cfg.diffusion.steps)
    tx = optim.make_diffusion_optimizer(cfg.train.lr, cfg.train.grad_clip)
    tcfg = DiffusionTrainConfig(cfg.pre_frames, cfg.latent_scale)
    g = torch.Generator(DEV).manual_seed(TRAIN_SEED + 2)

    def batch_of(mcfg):
        x = {"audio": torch.randn(b, round(16000 / 30 * frames), 2, generator=g, device=DEV) * 0.1,
             "word": torch.randint(0, mcfg.vocab_size, (b, frames), generator=g, device=DEV)}
        x["latent_in"] = (latent_fn(b, frames) if latent_fn is not None else
                          torch.randn(b, frames // mcfg.squeeze_scale, mcfg.latent_total_dim, generator=g, device=DEV))
        if mcfg.use_prompt:
            x["prompt"] = torch.randn(b, mcfg.prompt_dim, generator=g, device=DEV)
        return x

    def make_for(mcfg):
        def make(seed):
            mdm = build_mdm(mcfg, seed=seed, device=DEV)
            state = create_train_state(mdm, tx, torch.Generator(DEV).manual_seed(seed))
            return state, make_diffusion_train_step(mdm, diffusion, tx, tcfg), mdm

        return make

    out = {"config": yaml, "name": name, "overrides": overrides, "dtype": str(cfg.mdm.dtype),
           "audio_dtype": str(cfg.mdm.audio_dtype), "audio_norm": cfg.mdm.audio_norm, "use_prompt": cfg.mdm.use_prompt,
           "batch": b, "frames": frames, "diffusion_steps": diffusion.num_steps}
    if check_cpu:
        f32 = load_config(yaml, overrides + ["mdm.dtype=f32", "mdm.audio_dtype=f32"]).mdm
        state, step, mdm = make_for(f32)(TRAIN_SEED)
        cpu_mdm = copy.deepcopy(mdm).cpu()
        cpu_state = create_train_state(cpu_mdm, tx, torch.Generator())
        batch = batch_of(f32)
        draws = draw_diffusion(mdm, diffusion, batch["latent_in"].shape, state.generator, DEV)
        state, m = step(state, batch, draws=draws)
        cpu_state, cm = make_diffusion_train_step(cpu_mdm, diffusion, tx, tcfg)(
            cpu_state, {k: v.cpu() for k, v in batch.items()}, draws=draws.to("cpu"))
        loss_err = abs(float(m["predict_x0_loss"]) - float(cm["predict_x0_loss"])) / abs(float(cm["predict_x0_loss"]))
        stats_err = max((rel_err(v.cpu(), cpu_state.model_state[k]) for k, v in (state.model_state or {}).items()),
                        default=0.0)
        assert loss_err <= TRAIN_REL and stats_err <= TRAIN_REL, {"loss_rel_err": loss_err, "stats_rel_err": stats_err}
        out["step1_f32_vs_cpu"] = {"loss_rel_err": loss_err, "batch_stats_rel_err": stats_err,
                                   **step_vs_cpu(state, cpu_state, lr=cfg.train.lr)}
        del state, step, mdm, cpu_state, cpu_mdm
    make = make_for(cfg.mdm)
    state, step, _ = make(TRAIN_SEED)
    stats0 = {k: v.clone() for k, v in (state.model_state or {}).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics, ms = timed_steps(step, state, [batch_of(cfg.mdm) for _ in range(steps + 1)])
    out.update(steps=steps + 1, warm_step_ms=warm_ms(ms), step_ms=ms, loss=float(metrics["predict_x0_loss"]),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30)
    assert np.isfinite(out["loss"])
    if stats0:
        moved = max(float((state.model_state[k] - v).abs().max()) for k, v in stats0.items())
        assert moved > 0, "the running statistics did not move"
        out["running_stats_max_move"] = moved
    out["profile"] = busy_share(step, state, batch_of(cfg.mdm))
    rt_out, state = round_trip(make, state, step, batch_of(cfg.mdm), d / f"{name}_rt")
    out["round_trip"] = rt_out
    path = save_checkpoint(d / name, state)
    emit({"phase": "train", "card": card_name_and_power_limit(), "model": name, **out})
    return out, path


def phase_train(generate: bool = True, rvq_overrides=(), mdm_overrides=(), batches=None) -> dict:
    """The train steps at full width: the RVQ-VAE of ``configs/rvq_beat2.yaml``
    (its upper part: lazy init held against the CPU, 20 steps; hands and
    lower a lazy-init step each, so that ``generate`` has three trained
    encoders), the denoiser of ``configs/diffusion_beat2.yaml`` (step 1 in
    f32 against the CPU, 20 steps as configured, in bf16, on latents of the
    three encoders through ``make_latent_encoder``), the prompted denoiser
    of ``configs/diffusion_h3d.yaml`` (10 steps, the BatchNorm statistics
    move), each saved and resumed bit for bit; then the ``generate`` phase
    on the checkpoints it wrote (K2 and K3 on weights the port trained)."""
    batches = batches or {}
    out = {"phase": "train", "card": card_name_and_power_limit()}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        rvq_paths, stack = [], {}
        for part in ("upper", "hands", "lower"):
            steps = TRAIN_STEPS["rvq"] if part == load_config(RVQ_CONFIG).rvq_train.body_part else 0
            res, path, stack[part] = train_rvq(part, steps, d, rvq_overrides, batches.get("rvq"))
            out[f"rvq_{part}"] = res
            rvq_paths.append(str(path))
        encode = make_latent_encoder(stack, identity_pose_stats(), latent_scale=load_config(BEAT2_CONFIG).latent_scale)
        g = torch.Generator(DEV).manual_seed(TRAIN_SEED + 3)

        def latents(b, frames):
            feats = [torch.randn(b, frames, n, generator=g, device=DEV) for n in (78, 180, 54, 3)]
            return encode(*feats)

        out["diffusion"], mdm_path = train_mdm(BEAT2_CONFIG, list(mdm_overrides), TRAIN_STEPS["diffusion"], d,
                                               latent_fn=latents, check_cpu=True, batch=batches.get("mdm"),
                                               name="beat2")
        out["prompted"], _ = train_mdm(H3D_CONFIG, list(mdm_overrides), TRAIN_STEPS["prompted"], d,
                                       batch=batches.get("mdm"), name="h3d")
        if generate:
            ov = ["diffusion.timestep_respacing=ddim50", f"rvq_ckpts=[{','.join(rvq_paths)}]", f"test_ckpt={mdm_path}",
                  *mdm_overrides]
            out["generate"] = phase_generate("trained", BEAT2_CONFIG, ov, {})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.manual_seed(0)
    phase_build()
    phase_features()

    cfg = MDMConfig()
    diffusion = make_diffusion(steps=1000, timestep_respacing="ddim50")
    mdm = build_mdm(cfg, seed=0, device=DEV)
    rvq = {part: build_rvqvae(RVQVAEConfig(input_dim=dim), seed=10 + i, device=DEV)
           for i, (part, dim) in enumerate((("upper", 78), ("hands", 180), ("lower", 57)))}

    phase_gemm(cfg)
    k2 = phase_block_stack(mdm, cfg)
    k1 = phase_ddim_window(mdm, cfg, diffusion)
    k3 = phase_rvq(rvq["upper"][1].codebook)
    phase_k3_card_rows()
    phase_samplers(mdm, cfg, diffusion)
    serve_k1 = phase_serve(mdm, diffusion, rvq, fused_loop=True)
    serve_k2 = phase_serve(mdm, diffusion, rvq, fused_loop=False)
    stream = phase_stream(mdm, diffusion, rvq)
    encode = phase_rvq_encode_path(rvq)
    del mdm
    h3d = build_mdm(h3d_config(), seed=1, device=DEV)
    phase_prompted_samplers(h3d, diffusion)
    serve_p = phase_serve_prompted(h3d, diffusion, rvq)
    del h3d
    styled = build_mdm(dataclasses.replace(h3d_config(), use_motionclip=True), seed=2, device=DEV)
    stream_p = phase_stream_prompted(styled, diffusion, rvq)
    del styled
    gen = {"h3d": phase_generate("h3d", H3D_CONFIG, [], GENERATE_PROMPTS),
           "beat2": phase_generate("beat2", BEAT2_CONFIG, ["diffusion.timestep_respacing=ddim50", "rvq_ckpts=[]"], {})}
    gen["trained"] = phase_train()["generate"]

    src = "syntalker_tpu_torch/csrc/"
    k3_row = k3[SERVE_BATCH * 116]
    rvq_kernels = quantize_cuda.rvq_kernel_launches(6)
    rows = [  # (name, source, TPU kernel, timings, kernels launched on the main path, on the prompted flush,
        #         on the stream (the prompted stream for K2) and on the encode path, (error, tolerance))
        ("ddim_window", src + "mdm_block.cu", "syntalker_tpu/ops/mdm_pallas.py:312", k1[SERVE_BATCH],
         serve_k1["launches"]["ddim_window"], serve_p["launches"]["ddim_window"],
         stream["launches"]["ddim_window"], 0, {"rel_err": k1[SERVE_BATCH]["rel_err"], "tol": K1_REL}),
        ("block_stack", src + "mdm_block.cu", "syntalker_tpu/ops/mdm_pallas.py:157", k2[SERVE_BATCH],
         serve_k2["launches"]["block_stack"], serve_p["launches"]["block_stack"],
         stream_p["launches"]["block_stack"], 0, {"rel_err": k2[SERVE_BATCH]["rel_err"], "tol": K2_REL}),
        ("rvq_encode", src + "rvq_encode.cu", "syntalker_tpu/ops/quantize_pallas.py:33", k3_row,
         serve_k1["rvq_kernels"], serve_p["rvq_kernels"], stream["rvq_kernels"],
         sum(e["k3_calls"] for e in encode.values()) * rvq_kernels,
         {"abs_err": k3_row["max_abs_err"], "tol": K3_ATOL}),
    ]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r.get("library_ms"), "prompted_flush_launches": prompted,
         "stream_launches": streamed, "encode_path_launches": encoded,
         "generate_launches": {k: (v["launches"][name] if name != "rvq_encode" else v["rvq_kernels"])
                               for k, v in gen.items()}, "error_vs_tol": err}
        for name, source, replaces, r, launches, prompted, streamed, encoded, err in rows
    ]})
    print(card_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
