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
checkpoints the phase wrote. ``train_loop`` (last) trains through the
port's train CLIs: a synthetic BEAT2 corpus (``make_corpus``: 4 speakers ×
8 clips of 8-24 s) and its window caches, ``cli.train_rvq.main()`` on
``configs/rvq_beat2.yaml`` for the three parts (1,000 iterations each from
a device-resident dataset on the card; ``recon`` must fall) and
``cli.train.main()`` on ``configs/diffusion_beat2.yaml`` for two epochs on
those RVQ-VAEs; ``generate`` on the checkpoints (exact counts, every K3
call against the plain version); then, on the trained decoders, the
decoder's reach, the K1 stream against the whole clip decoded at once
(reported beside the stream's margins) and two f32 decodes of the same
codes, on the card and on the CPU; last, ``evaluate`` in the same
directory: the FGD eval VAE trained by ``cli.train_aux.main()``, then
``cli.test.main()`` over the corpus's 8 test clips (DDIM-50, 4 clips a
batch, the synthetic SMPL-X model; exact K2 and K3 counts, every K3 call
against the plain version, the metrics' ranges and the time split), the
mean joint velocity against the CPU's, one bucket on the plain f32
sampler, one clip under the yaml's DDPM-1000, FGD's embedding on the card
against the CPU, and face LBS at 10,450 vertices. ``h3d`` (last) runs
the text-control stack: a synthetic corpus whose caches carry the 623-d
``h3d`` arrays (the synthetic SMPL-X model on the card), the three h3d623
RVQ-VAEs through ``cli.train_rvq.main()`` (300 iterations each at batch
256), the ``configs/diffusion_h3d.yaml`` denoiser through
``DiffusionTrainer`` with the frozen TMR motion encoder of
``weights/t2m_oracle/tmr.npz`` as its prompt channel (2 epochs), then
``cli.test_h3d.main()`` on the test split (the committed BiGRU oracle and
TMR text head, DDIM-50, 3 replications, 2 steering clips): exact K2 and
K3 counts against the window plans, K2 at the guided step's three
branches and every K3 call against their plain versions, the oracle on
the card against the CPU, finite metrics. ``convert_demo`` (last) takes a
user's path from the reference's torch checkpoints to a video: seeded
modules at the widths of ``configs/diffusion_beat2.yaml`` saved in the
reference's layouts and file shapes (the denoiser's WavEncoder with
BatchNorm statistics, the three RVQ-VAEs, the eval VAE, the face VQ-VAE),
the port's converters, the denoiser and RVQ stack written as the npz
checkpoints ``generate`` reads, then ``cli.demo`` one-shot on an 8 s wav
(``generate --render``: K2 a DDIM-50 step, K3 a part, forward kinematics
on the card, the stick figure drawn on the host; exact counts, every K3
call and K2 at the clip's shape against their plain versions, the warm
clip), K1 (``sample_windows_fused_loop``) on the converted denoiser
against the plain f32 sampler, the clip's joints and the converted eval
models on the card against the CPU. ``mesh_serve`` (first, after the build and ``features``) runs
the service on a ``data=2`` mesh of ``[cuda:0, cuda:0]`` (and over every
card when there are several) at the serve phase's bucket: a flush through
K1, one through K2 and a prompted group, each against the unsharded flush
of the same requests and noise (latents within 1e-6, exact K1/K2/K3
counts on the warm flush), and K1, K2 and K3 at a shard's shapes against
their plain versions. ``mesh_train`` runs the beat2 denoiser (batch 40)
and the upper RVQ-VAE (batch 256) 3 steps each on one device, in an NCCL
group of one rank a card and in a gloo group of two ranks on the one card
(``torch.multiprocessing.spawn``, ``file://`` rendezvous): rank 0 against
the one device (loss, parameters), the EMA codebooks the same bit for bit
on every rank, and in the gloo group the tensor-parallel forward of
``MDMConfig()`` at model=2 against the replicated one. Takes about eight minutes on an H100,
the ~10 s build included (``train_loop`` with ``evaluate`` about three
and a half, ``h3d`` about one and a half, ``convert_demo`` about one).
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
from types import SimpleNamespace

import numpy as np
import torch
from scipy.io import wavfile

from syntalker_tpu_torch import bridge
from syntalker_tpu_torch import convert as CV
from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch import native
from syntalker_tpu_torch import render as R
from syntalker_tpu_torch.cli import demo as DEMO
from syntalker_tpu_torch.cli import generate as GEN
from syntalker_tpu_torch.cli import test as TEST
from syntalker_tpu_torch.cli import test_h3d as TEST_H3D
from syntalker_tpu_torch.cli import train as TRAIN
from syntalker_tpu_torch.cli import train_aux as TRAIN_AUX
from syntalker_tpu_torch.cli import train_rvq as TRAIN_RVQ
from syntalker_tpu_torch.cli.common import load_smplx_if_available
from syntalker_tpu_torch.config import load_config
from syntalker_tpu_torch.data import audio as A
from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.data.audio import onset_amplitude_features
from syntalker_tpu_torch.data.beat_builder import build_beat_cache
from syntalker_tpu_torch.data.cache import BeatCache, ClipConfig
from syntalker_tpu_torch.data.features import pose_to_part_rot6d
from syntalker_tpu_torch.data.stats import compute_mean_velocity_from_clips, identity_pose_stats
from syntalker_tpu_torch.device import full_f32
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.eval.metrics import frechet_distance
from syntalker_tpu_torch.eval.t2m import flatten_params
from syntalker_tpu_torch.models.eval_vae import build_eval_vae, build_face_vqvae
from syntalker_tpu_torch.models.denoiser import Conditioning, MDMConfig, build_mdm
from syntalker_tpu_torch.models.tmr import TextPipeline, embed_prompts, load_tmr_motion
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae, draw_rvqvae
from syntalker_tpu_torch.ops import _build, mdm_cuda, quantize_cuda
from syntalker_tpu_torch.ops import smplx as SMPLX
from syntalker_tpu_torch.ops.quantize import _tile_to_codebook, code_distances, init_rvq_state
from syntalker_tpu_torch.serving import MotionGenerationService, MotionRequest
from syntalker_tpu_torch.streaming import StreamingMotionSession
from syntalker_tpu_torch.parallel.collectives import rows_of
from syntalker_tpu_torch.parallel.mesh import make_mesh, shard_params
from syntalker_tpu_torch.parallel.multihost import init_multihost
from syntalker_tpu_torch.train import diffusion_trainer, optim, rvq_trainer
from syntalker_tpu_torch.train.diffusion_trainer import (DiffusionTrainConfig, draw_diffusion, make_diffusion_train_step,
                                                         make_latent_encoder)
from syntalker_tpu_torch.train.loop import DiffusionTrainer, rvq_config
from syntalker_tpu_torch.train.rvq_trainer import RVQLossConfig, make_rvq_train_step, rvq_loss
from syntalker_tpu_torch.data.synthetic import make_corpus
from syntalker_tpu_torch.train.state import (TrainState, create_train_state, latest_checkpoint, load_checkpoint,
                                             save_checkpoint)

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


def windowed_latents(mdm, diffusion, plan, aw, ww, seed, noise):
    """The offline K1 sampler one window at a time, as the stream runs it:
    the same shapes, so the same latents. The sampler over the whole clip
    encodes all windows in one batch, whose f32 sums reach K1's bf16 inputs
    rounded differently, and the discontinuous snap can then take other
    codes."""
    sampler = G.make_fused_loop_sampler(mdm, diffusion, G.plan_windows(plan.pose_length))
    wins = []
    for w in range(plan.num_windows):
        wins.append(sampler(aw[w : w + 1], ww[w : w + 1], seed, noise[w : w + 1]))
        seed = wins[-1][:, -plan.pre_frames :]
    return torch.cat([wins[0]] + [x[:, plan.pre_frames :] for x in wins[1:]], dim=1)


def stream_against_offline(mdm, diffusion, rvq) -> SimpleNamespace:
    """A 16 s clip's features pushed in ragged chunks through a warmed
    session: K1 one call a window, K3 three calls a window's decode and
    three at the flush, every K3 call held against the plain version on its
    own rows, exact counts. Then the offline K1 sampler on the same audio
    and noise a window at a time (``windowed_latents``): the stream's
    distance to each window's decode buffer decoded alone
    (``chunked_decode``; ``aa_err``, ``tr_err``, for the caller to hold at
    STREAM_ATOL and TRANS_REL) and to the whole clip decoded at once
    (``whole``, reported beside DECODE_MARGIN and TRANS_REL)."""
    plan = G.plan_windows(int(STREAM_SECONDS * 30))
    feats, words = stream_clip(13)
    words = words % mdm.cfg.vocab_size  # a denoiser trained on a corpus has that corpus's vocabulary
    noise = G.draw_noise(plan, 1, torch.Generator(device=DEV).manual_seed(13), DEV)

    def make():
        return stream_session(mdm, diffusion, rvq, noise=noise)

    sess, warm_s = warm_session(make)
    reset_launches()
    with recorded_k3() as k3_calls:
        segs = push_ragged(sess, feats, words)
    torch.cuda.synchronize()
    counts = {**mdm_cuda.launches, **quantize_cuda.launches}
    windows = sess.stream_stats.windows_run
    want = {"ddim_window": windows * mdm_cuda.window_launches(mdm.cfg.num_layers, diffusion.num_steps),
            "block_stack": 0, "rvq_encode": 3 * (windows + 1)}
    assert windows == plan.num_windows and counts == want, (windows, counts, want)

    aa = np.concatenate([s["axis_angle"] for s in segs])
    tr = np.concatenate([s["trans"] for s in segs])
    aw = torch.as_tensor(G.window_audio(feats[None], plan), device=DEV)
    ww = torch.as_tensor(G.window_words(words[None, : plan.n_frames], plan), device=DEV)
    seed = torch.zeros(1, plan.pre_frames, J.LATENT_DIM, device=DEV)
    lat = windowed_latents(mdm, diffusion, plan, aw, ww, seed, noise)
    ref_aa, ref_tr = chunked_decode(lat, rvq, sess)
    assert aa.shape == ref_aa.shape == (plan.out_latent_frames * plan.squeeze, 165), (aa.shape, ref_aa.shape)
    assert np.isfinite(aa).all() and np.isfinite(tr).all()
    starts = [s["frame_start"] for s in segs]
    assert starts == list(np.cumsum([0] + [len(s["axis_angle"]) for s in segs[:-1]]))
    # the whole clip decoded at once: equal to the stream as far as the decoder's reach ends inside the margins
    off = G.decode_latents(lat, rvq_modules=rvq, stats=identity_pose_stats())
    off_r6, off_tr = off["rot6d"][0].cpu().numpy(), off["trans"][0].cpu().numpy()
    r6_frame_err = np.abs(np.concatenate([s["rot6d"] for s in segs]) - off_r6).max(-1)
    whole = {"axis_angle_max_abs_err": float(np.abs(aa - off["axis_angle"][0].cpu().numpy()).max()),
             "rot6d_max_abs_err": float(r6_frame_err.max()),
             "frames_rot6d_err_over_margin": int((r6_frame_err > DECODE_MARGIN).sum()), "frames": len(r6_frame_err),
             "trans_rel_err": float(np.abs(tr - off_tr).max() / max(1.0, np.abs(off_tr).max())),
             "margins": {"axis_angle": DECODE_MARGIN, "trans_rel": TRANS_REL}}
    whole["axis_angle_met"] = whole["axis_angle_max_abs_err"] <= DECODE_MARGIN
    whole["trans_met"] = whole["trans_rel_err"] <= TRANS_REL
    return SimpleNamespace(plan=plan, feats=feats, words=words, noise=noise, make=make, sess=sess, warm_s=warm_s,
                           windows=windows, launches=counts, k3=k3_calls_check(k3_calls), frames=len(aa), aw=aw,
                           ww=ww, seed=seed, lat=lat, aa_err=float(np.abs(aa - ref_aa).max()),
                           tr_err=float(np.abs(tr - ref_tr).max() / max(1.0, np.abs(ref_tr).max())), whole=whole)


def phase_stream(mdm, diffusion, rvq) -> dict:
    """The streaming session at full width (``stream_against_offline``; K1
    at B=1 is held in the parity phase): the session's bookkeeping held
    against the offline K1 sampler with each window's decode buffer decoded
    alone. Beside it, how far the stream lies from the whole clip decoded
    at once: reported, not held, since the full-width decoder reaches past
    the 16/8-latent margins. Exact counts from the wrappers and, for K3's
    kernels and the device->host copies, from a torch.profiler session of a
    second stream; the cold first window (K1's graph captured at it), the
    warm windows (captured before, by ``warm_up``) and a steady window's
    device-busy share."""
    run = stream_against_offline(mdm, diffusion, rvq)
    plan, feats, words, make, windows = run.plan, run.feats, run.words, run.make, run.windows
    rvq_kernels = quantize_cuda.rvq_kernel_launches(6)
    batched = G.make_fused_loop_sampler(mdm, diffusion, plan)(run.aw, run.ww, run.seed, run.noise)
    aa_err, tr_err = run.aa_err, run.tr_err
    seed_err = rel_err(run.sess._state["seed"], run.lat[:, -plan.pre_frames :])
    batched_err = rel_err(run.lat, batched)

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
    out = {"phase": "stream", "windows": windows, "frames": run.frames, "chunks": list(STREAM_CHUNKS),
           "axis_angle_max_abs_err": aa_err, "axis_angle_tol": STREAM_ATOL, "trans_rel_err": tr_err,
           "trans_tol": TRANS_REL, "seed_rel_err_vs_offline": seed_err,
           "reference": "make_fused_loop_sampler a window at a time, each window's decode buffer decoded alone",
           "whole_clip_decode": run.whole,
           "latent_rel_err_batched_vs_windowed_offline": batched_err, "batched_tol": SAMPLER_REL,
           "launches": run.launches, "rvq_kernels": seen, "profile_attempts": attempt,
           "device_to_host_copies": d2h, "warm_up_s": run.warm_s, "k3_vs_plain": run.k3,
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


# ---------------------------------------------------------------------------
# train_loop phase: the synthetic corpus, the window caches, the trainers' loops through the train CLIs, generate
# and the stream on what they trained
# ---------------------------------------------------------------------------

LOOP_SPEAKERS, LOOP_CLIPS, LOOP_SECONDS = (2, 4, 6, 8), 8, (8.0, 24.0)  # make_corpus's defaults but 8 clips a speaker
LOOP_RVQ_ITERS, LOOP_LOG_PERIOD = 1000, 100  # a part's iterations: ~30 ms each at batch 256 (the train phase)
LOOP_MDM_EPOCHS = 2
REACH = (8, 16, 23)  # latent frames, as tests/test_torch_decode_reach.py reads the decoder's reach
FRAMEWORK_ABS = 1e-4  # tests/test_torch_streaming.py's POSE_ABS: two f32 decodes of the same latents


def cache_bytes(root: Path) -> int:
    return sum(f.stat().st_size for f in root.rglob("*.npz"))


def build_loop_caches(d: Path) -> dict:
    """The corpus and the train caches the CLIs will find (a cache hit):
    64-frame windows for the RVQ-VAEs, 128 frames stride 20 for the
    denoiser."""
    t0 = time.perf_counter()
    ids = make_corpus(d / "corpus", speakers=LOOP_SPEAKERS, clips_per_speaker=LOOP_CLIPS, seconds_range=LOOP_SECONDS,
                      seed=0)
    corpus_s = time.perf_counter() - t0
    out = {"clips": len(ids), "speakers": list(LOOP_SPEAKERS), "seconds_range": list(LOOP_SECONDS),
           "corpus_s": corpus_s}
    for name, cache_dir, length in (("rvq", d / "cache_rvq", load_config(RVQ_CONFIG).rvq_train.window),
                                    ("mdm", d / "cache", load_config(BEAT2_CONFIG).data.pose_length)):
        t0 = time.perf_counter()
        cache, vocab = build_beat_cache(d / "corpus", cache_dir, speakers=LOOP_SPEAKERS,
                                        cfg=ClipConfig(pose_length=length, stride=20))
        out[name] = {"window": length, "stride": 20, "train_clips": len(cache.clips), "windows": len(cache),
                     "cache_mb": cache_bytes(cache_dir) / 2**20, "build_s": time.perf_counter() - t0,
                     "vocab_words": vocab.n_words}
    return out


def no_stats(d: Path) -> str:
    """Points ``data.mean_std_dir`` at a directory that does not exist, so
    that the trainers and ``generate`` take identity pose stats, as the
    decodes of this phase do."""
    return f"data.mean_std_dir={d / 'no_mean_std'}"


def loop_overrides(d: Path) -> list:
    return [no_stats(d), f"data.data_path={d / 'corpus'}", f"data.cache_path={d / 'cache'}",
            f"train.ckpt_dir={d / 'ckpt'}",
            f"data.training_speakers=[{','.join(map(str, LOOP_SPEAKERS))}]", "train.device_data=true",
            f"data.vocab_path={d / 'cache' / 'vocab.json'}"]


def trainer_timing(trainer, steps: int = 10) -> dict:
    """The loop's own step time (host clock between its logs, synchronised
    by the logged loss) beside CUDA events around ``steps`` more steps on
    batches the device-resident dataset gathers, and one profiled step."""
    ds = trainer.device_dataset()
    batches = []
    for epoch in range(10_000, 10_000 + steps):
        batches += [ds.batch(idx) for idx in ds.epoch_indices(epoch)]
        if len(batches) >= steps:
            break
    trainer.state, _, ms = timed_steps(trainer.step, trainer.state, batches[:steps])
    loop_ms = [h["ms_per_step"] for h in trainer.history[1:]]
    return {"loop_ms_per_step": float(np.mean(loop_ms)) if loop_ms else None, "cuda_event_warm_step_ms": warm_ms(ms),
            "profile": busy_share(trainer.step, trainer.state, batches[0])}


def loop_rvq(part: str, d: Path, iters: int, overrides: list) -> tuple:
    """``cli.train_rvq.main()`` for one part; (phase dict, checkpoint)."""
    argv = ["-c", RVQ_CONFIG, "--run-dir", str(d / "run"), f"rvq_train.body_part={part}",
            f"rvq_train.total_iters={iters}", f"rvq_train.save_every={iters}", f"train.log_period={LOOP_LOG_PERIOD}",
            *loop_overrides(d), *overrides]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = TRAIN_RVQ.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ds = trainer.device_dataset()
    assert all(v.device.type == DEV.type for v in ds.arrays.values()), [str(v.device) for v in ds.arrays.values()]
    path = d / "ckpt" / f"rvq_{part}" / f"step_{iters}.npz"
    assert path.exists(), path
    first, last = trainer.history[0], trainer.history[-1]
    out = {"part": part, "iters": iters, "batch": trainer.loader.batch_size, "windows": ds.n, "dataset_gb": ds.nbytes / 1e9,
           "placement": ds.placement, "dataset_device": str(next(iter(ds.arrays.values())).device),
           "wall_s_to_trained": wall_s, "first_log": first, "last_log": last,
           "recon_fell": last["recon"] < first["recon"], **trainer_timing(trainer)}
    assert out["recon_fell"] and np.isfinite(last["loss"]), (first, last)
    return out, path


def loop_mdm(d: Path, rvq_paths: list, overrides: list) -> tuple:
    """``cli.train.main()`` on the beat2 denoiser; (phase dict, checkpoint)."""
    argv = ["-c", BEAT2_CONFIG, "--run-dir", str(d / "run"), f"rvq_ckpts=[{','.join(map(str, rvq_paths))}]",
            f"train.epochs={LOOP_MDM_EPOCHS}", "train.log_period=1", *loop_overrides(d), *overrides]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = TRAIN.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ds = trainer.device_dataset()
    assert all(v.device.type == DEV.type for v in ds.arrays.values()), [str(v.device) for v in ds.arrays.values()]
    path = latest_checkpoint(d / "ckpt")
    steps = LOOP_MDM_EPOCHS * len(ds)
    assert path is not None and path.name == f"step_{steps}.npz", (path, steps)
    losses = [h["loss"] for h in trainer.history]
    assert np.isfinite(losses).all()
    out = {"epochs": LOOP_MDM_EPOCHS, "steps": steps, "batch": trainer.loader.batch_size, "windows": ds.n,
           "dataset_gb": ds.nbytes / 1e9, "placement": ds.placement, "wall_s": wall_s, "loss_first": losses[0],
           "loss_last": losses[-1], "dtype": str(trainer.mdm.cfg.dtype), "audio_norm": trainer.mdm.cfg.audio_norm,
           **trainer_timing(trainer)}
    return out, path


def clip_latents(rvq, d: Path, n_lat: int = 116) -> tuple:
    """The trained encoders' latents (1, n_lat, 1536) ÷ latent_scale of the
    two longest train clips' first 4·n_lat frames."""
    cache = BeatCache.open(d / "cache_rvq" / "train")
    clips = sorted(cache.clips, key=lambda c: -cache.clips[c]["poses"].shape[0])[:2]
    encode = make_latent_encoder(rvq, identity_pose_stats(), latent_scale=load_config(BEAT2_CONFIG).latent_scale)
    out = []
    for clip in clips:
        c = cache.clips[clip]
        assert c["poses"].shape[0] >= 4 * n_lat, (clip, c["poses"].shape)
        pose = torch.as_tensor(c["poses"][None, : 4 * n_lat], device=DEV)
        parts = pose_to_part_rot6d(pose)
        trans_v = torch.as_tensor(c["trans_v"][None, : 4 * n_lat], device=DEV)
        out.append(encode(parts["upper"], parts["hands"], parts["lower"], trans_v))
    return out[0], out[1]


def decoder_reach(rvq, lat, other) -> dict:
    """tests/test_torch_decode_reach.py's reading on these decoders: the
    largest rot6d change of the centre latent frame's 4 output frames when
    every latent frame farther than d from it is replaced (here by another
    clip's latents)."""
    def rot6d(x):
        return G.decode_latents(x, rvq_modules=rvq, stats=identity_pose_stats())["rot6d"][0]

    centre = lat.shape[1] // 2
    base = rot6d(lat)[centre * 4 : (centre + 1) * 4]
    far = (torch.arange(lat.shape[1], device=DEV) - centre).abs()
    return {d: float((rot6d(torch.where((far > d)[None, :, None], other, lat))[centre * 4 : (centre + 1) * 4]
                      - base).abs().max()) for d in REACH}


def framework_gap(rvq, lat) -> dict:
    """Fault 2's reading on these decoders: the same snapped codes decoded in
    f32 on the card and on the CPU (two f32 convolution orders), the
    decoders' part features and then the rotations."""
    outs = []
    for dev in (DEV, torch.device("cpu")):
        parts = {}
        for name, (lo, hi) in J.LATENT_SLICES.items():
            module, state = rvq[name]
            z = (lat[..., lo:hi] * load_config(BEAT2_CONFIG).latent_scale).reshape(-1, hi - lo).cpu()
            _, idx = quantize_cuda.rvq_encode_plain(z, state.codebook.cpu())
            m = copy.deepcopy(module).to(dev)
            st = dataclasses.replace(state, codebook=state.codebook.to(dev))
            parts[name] = m.decode_indices(idx.reshape(1, lat.shape[1], -1).to(dev), st)
        outs.append((parts, G.decode_parts(parts, stats=identity_pose_stats())))
    (pc, dc), (pp, dp) = outs
    parts_gap = max(float((pc[n].cpu() - pp[n]).abs().max()) for n in pc)
    gap = {k: float((dc[k].cpu() - dp[k]).abs().max()) for k in ("rot6d", "axis_angle", "trans")}
    return {"parts_max_abs_gap": parts_gap, **{f"{k}_max_abs_gap": v for k, v in gap.items()},
            "rot6d_amplification": gap["rot6d"] / max(parts_gap, 1e-30), "bound": FRAMEWORK_ABS,
            "rotations_met": max(gap["rot6d"], gap["axis_angle"]) <= FRAMEWORK_ABS,
            "trans_met": gap["trans"] <= FRAMEWORK_ABS}


def trained_stream(mdm, diffusion, rvq) -> dict:
    """Fault 1's reading on the trained models (``stream_against_offline``):
    the stream held to each window's decode buffer decoded alone at
    STREAM_ATOL as in the stream phase, and its distance to the whole clip
    decoded at once reported beside the stream's margins."""
    run = stream_against_offline(mdm, diffusion, rvq)
    assert run.aa_err <= STREAM_ATOL and run.tr_err <= TRANS_REL, (run.aa_err, run.tr_err)
    return {"windows": run.windows, "launches": run.launches,
            "rvq_kernels": 3 * (run.windows + 1) * quantize_cuda.rvq_kernel_launches(6), "k3_vs_plain": run.k3,
            "axis_angle_err_vs_chunked": run.aa_err, "trans_rel_err_vs_chunked": run.tr_err,
            "chunked_tol": STREAM_ATOL, "whole_clip_decode": run.whole}


# ---------------------------------------------------------------------------
# evaluate phase: BEAT2 evaluation on the checkpoints train_loop trained
# ---------------------------------------------------------------------------

EVAL_VAE_ITERS, EVAL_VAE_LOG = 300, 50  # the FGD eval VAE's iterations on the corpus's 32-frame windows
EVAL_BATCH_CLIPS = 4
EVAL_RESPACING = ["diffusion.timestep_respacing=ddim50", "diffusion.sampler=ddim"]  # a cut: the yaml's is DDPM-1000
FACE_VPJ, FACE_FRAMES = 190, 480  # 55 x 190 = 10,450 vertices (the release has 10,475); a 16 s clip
MEAN_VEL_REL = 1e-4  # f32 FK on the card and on the CPU, sums in another order; a speed is a difference of positions
LBS_ABS = 1e-4  # vertices (metres) from f32 skinning on the card and on the CPU


def eval_overrides(d: Path, rvq_paths, mdm_path) -> list:
    ckpts = [f"rvq_ckpts=[{','.join(map(str, rvq_paths))}]"] + ([f"test_ckpt={mdm_path}"] if mdm_path else [])
    return [*loop_overrides(d), "data.smplx_model_path=synthetic", *ckpts]


def expected_k2(ev, groups: list, samples: dict, steps: int, num_layers: int) -> int:
    """Kernels of K2 over ``groups``: one pass a step a window, plus one
    pass the first time each batch size runs (before its graph is captured)."""
    windows = sum(ev.plan(samples[g[0]]).num_windows for g in groups)
    return (windows * steps + len({len(g) for g in groups})) * mdm_cuda.block_launches(num_layers)


def eval_vae_train(d: Path, iters: int) -> tuple:
    """``cli.train_aux --model eval_vae`` on the corpus; (phase dict, checkpoint)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aux = TRAIN_AUX.main(["-c", RVQ_CONFIG, "--model", "eval_vae", "--iters", str(iters), "--run-dir", str(d / "run"),
                          f"train.log_period={EVAL_VAE_LOG}", *loop_overrides(d)])
    wall_s = time.perf_counter() - t0
    first, last = aux["history"][0], aux["history"][-1]
    out = {"iters": iters, "batch": load_config(RVQ_CONFIG).train.batch_size, "window": 32, "wall_s": wall_s,
           "first_log": first, "last_log": last, "ms_per_step_last_log": last["ms_per_step"],
           "recon_fell": last["recon"] < first["recon"]}
    assert out["recon_fell"] and np.isfinite(last["loss"]), (first, last)
    return out, aux["path"]


def fgd_card_vs_cpu(ev, results: Path, n_clips: int) -> dict:
    """The split's res_/gt_ axis-angle as rot6d on the CPU, embedded by the
    eval VAE on the card and by its copy on the CPU: the embeddings' largest
    gap and the FGD of each."""
    cpu_vae = copy.deepcopy(ev.eval_vae).cpu()
    lat = {"card": ([], []), "cpu": ([], [])}
    for i in range(n_clips):
        for k, prefix in enumerate(("res", "gt")):
            with np.load(results / f"{prefix}_{i:03d}.npz") as f:
                rot6d = pose_to_part_rot6d(torch.as_tensor(f["poses"][None]))["full"]
            n = rot6d.shape[1] - rot6d.shape[1] % ev.vae_test_len
            with torch.no_grad():
                lat["card"][k].append(ev.eval_vae.map2latent(rot6d[:, :n].to(DEV)).reshape(-1, 240).cpu().numpy())
                lat["cpu"][k].append(cpu_vae.map2latent(rot6d[:, :n]).reshape(-1, 240).numpy())
    gap = max(float(np.abs(a - b).max()) for k in (0, 1) for a, b in zip(lat["card"][k], lat["cpu"][k]))
    fid = {dev: frechet_distance(np.concatenate(lat[dev][0]), np.concatenate(lat[dev][1])) for dev in lat}
    return {"embedding_max_abs_gap": gap, "fid_card": fid["card"], "fid_cpu": fid["cpu"],
            "fid_rel_gap": abs(fid["card"] - fid["cpu"]) / abs(fid["cpu"])}


def face_lbs_at_release_size(clip: dict) -> dict:
    """``lbs`` of a face-only pose on ``synthetic_smplx_model(verts_per_joint=190)``
    over FACE_FRAMES frames (a (T, V, 4, 4) transform stack), on the card
    (ms, peak memory) and on the CPU (the vertices' gap), and the joints-only
    FK on the same frames."""
    model = SMPLX.synthetic_smplx_model(verts_per_joint=FACE_VPJ, device=DEV)
    reps = -(-FACE_FRAMES // clip["poses"].shape[0])
    poses = np.concatenate([clip["poses"]] * reps)[:FACE_FRAMES]
    face = np.zeros_like(poses)
    face[:, 66:75] = poses[:, 66:75]
    facial = np.concatenate([clip["facial"]] * reps)[:FACE_FRAMES]
    args = [torch.as_tensor(a) for a in (face, np.tile(clip["betas"], (FACE_FRAMES, 1)), facial)]
    card = [a.to(DEV) for a in args]
    with torch.no_grad(), full_f32():
        torch.cuda.reset_peak_memory_stats()
        lbs_ms = cuda_ms(lambda: SMPLX.lbs(model, card[0], card[1], expressions=card[2]), 5)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        verts = SMPLX.lbs(model, card[0], card[1], expressions=card[2])["vertices"].cpu()
        fk_ms = cuda_ms(lambda: SMPLX.forward_joints(model, card[0], card[1]), 5)
        t0 = time.perf_counter()
        ref = SMPLX.lbs(model.to("cpu"), *args[:2], expressions=args[2])["vertices"]
        cpu_ms = 1e3 * (time.perf_counter() - t0)
    out = {"vertices": model.v_template.shape[0], "frames": FACE_FRAMES, "lbs_ms": lbs_ms, "lbs_peak_gb": peak_gb,
           "fk_joints_ms": fk_ms, "cpu_lbs_ms": cpu_ms, "vertices_max_abs_gap": float((verts - ref).abs().max()),
           "tol": LBS_ABS}
    assert out["vertices_max_abs_gap"] <= LBS_ABS, out
    return out


def phase_evaluate(d: Path, rvq_paths: list, mdm_path, mdm_overrides=(), eval_vae_iters: int = EVAL_VAE_ITERS) -> dict:
    """BEAT2 evaluation on the card, in ``train_loop``'s directory on its
    checkpoints: the FGD eval VAE trained by ``cli.train_aux``; the test
    split through ``cli.test`` on ``configs/diffusion_beat2.yaml`` (DDIM-50,
    ``--batch-clips`` 4, the synthetic SMPL-X model): exact K2 and K3
    counts, every K3 call against the plain version, the metrics' ranges,
    the time split, the mean joint velocity the CLI computed held against
    the CPU's, one bucket on the plain f32 sampler; then one clip under the
    yaml's own DDPM-1000; FGD's embedding card against CPU; and face LBS at
    the release's vertex count."""
    out = {"phase": "evaluate", "card": card_name_and_power_limit()}
    t_phase = time.perf_counter()
    out["eval_vae"], vae_path = eval_vae_train(d, eval_vae_iters)

    ov = [*eval_overrides(d, rvq_paths, mdm_path), *mdm_overrides]
    argv = ["-c", BEAT2_CONFIG, "--run-dir", str(d / "run_eval"), "--eval-vae-ckpt", str(vae_path),
            "--batch-clips", str(EVAL_BATCH_CLIPS), *EVAL_RESPACING, *ov]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_k3() as k3_calls:
        result = TEST.main(argv)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = {**mdm_cuda.launches, **quantize_cuda.launches}
    cfg = load_config(BEAT2_CONFIG, [*EVAL_RESPACING, *ov])
    smplx = load_smplx_if_available(cfg, DEV)
    cache = BeatCache.open(d / "cache" / "test")
    mean_vel = np.load(d / "cache" / TEST.MEAN_VEL_FILE)
    ev = TEST.build_evaluator(cfg, smplx, str(vae_path), mean_vel, device=DEV)
    samples = {i: cache.get(i) for i in range(len(cache))}
    groups = ev.groups(samples, EVAL_BATCH_CLIPS)
    want = {"ddim_window": 0, "rvq_encode": 3 * len(groups),
            "block_stack": expected_k2(ev, groups, samples, ev.diffusion.num_steps, cfg.mdm.num_layers)}
    assert counts == want, (counts, want)
    k3 = k3_calls_check(k3_calls)
    metrics = result.as_dict()
    assert result.clips == len(cache) and np.isfinite([result.fid, result.l1div, result.srgr]).all(), metrics
    assert 0.0 <= result.bc <= 1.0, metrics

    # the CLI's mean joint velocity (FK on the card) against the same on the CPU
    t0 = time.perf_counter()
    mv_card = compute_mean_velocity_from_clips(list(cache.clips.values()), smplx)
    mv_card_s = time.perf_counter() - t0
    mv_cpu = compute_mean_velocity_from_clips(list(cache.clips.values()), smplx.to("cpu"))
    mean_velocity = {"card_s": mv_card_s, "rel_err_vs_cpu": rel_err(torch.as_tensor(mean_vel), torch.as_tensor(mv_cpu)),
                     "cli_equals_recomputed": bool(np.array_equal(mean_vel, mv_card)), "tol": MEAN_VEL_REL}
    assert mean_velocity["rel_err_vs_cpu"] <= MEAN_VEL_REL, mean_velocity

    # one bucket of the split on the plain f32 sampler against K2 (same draws)
    group = max(groups, key=len)
    plan = min((ev.plan(samples[i]) for i in group), key=lambda p: p.n_frames)

    def bucket(denoise=None):
        noises = [ev.clip_noise(999, i, plan) for i in group]
        return ev.sample_latents([samples[i] for i in group], noises, denoise=denoise)[0]

    mdm = ev.mdm
    sampler_err = rel_err(bucket(), bucket(lambda x_t, t_emb, cond: mdm.denoise(x_t, None, cond, t_emb=t_emb,
                                                                                  dtype=torch.float32)))
    assert sampler_err <= SAMPLER_REL, sampler_err

    # the paper's protocol on one clip: the yaml's DDPM over 1,000 steps
    cfg_ddpm = load_config(BEAT2_CONFIG, ov)
    ev_ddpm = TEST.build_evaluator(cfg_ddpm, smplx, str(vae_path), mean_vel, device=DEV)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ddpm = ev_ddpm.evaluate(cache, 999, max_clips=1)
    torch.cuda.synchronize()
    ddpm_s = time.perf_counter() - t0
    ddpm_counts = {**mdm_cuda.launches, **quantize_cuda.launches}
    ddpm_want = {"ddim_window": 0, "rvq_encode": 3,
                 "block_stack": expected_k2(ev_ddpm, [[0]], samples, ev_ddpm.diffusion.num_steps, cfg.mdm.num_layers)}
    assert ddpm_counts == ddpm_want and np.isfinite(ddpm.fid), (ddpm_counts, ddpm_want, ddpm)

    out.update({
        "config": BEAT2_CONFIG, "cuts": ["DDIM-50 in place of the yaml's DDPM-1000 for the split",
                                         f"synthetic corpus (speakers {list(LOOP_SPEAKERS)}, {len(cache)} test clips "
                                         f"of {LOOP_SECONDS[0]:g}-{LOOP_SECONDS[1]:g} s)",
                                         "synthetic SMPL-X model", "identity pose statistics",
                                         f"eval VAE trained {eval_vae_iters} iterations"],
        "dtype": str(cfg.mdm.dtype), "clips": result.clips, "batch_clips": EVAL_BATCH_CLIPS, "batches": len(groups),
        "windows": [ev.plan(samples[g[0]]).num_windows for g in groups], "steps": ev.diffusion.num_steps,
        "metrics": {k: metrics[k] for k in ("fid", "bc", "l1div", "srgr")}, "wall_s": wall_s,
        "motion_seconds": result.motion_seconds, "motion_s_per_s": result.motion_seconds / wall_s,
        "evaluate_wall_s": result.wall_seconds, "stage_seconds": result.stage_seconds, "launches": counts,
        "rvq_kernels": counts["rvq_encode"] * quantize_cuda.rvq_kernel_launches(6), "k3_vs_plain": k3,
        "mean_velocity": mean_velocity,
        "sampler_vs_plain_f32": {"clips": len(group), "windows": plan.num_windows, "latent_rel_err": sampler_err,
                                 "tol": SAMPLER_REL},
        "ddpm1000_clip": {"windows": ev_ddpm.plan(samples[0]).num_windows, "frames": ddpm.motion_seconds * 30,
                          "steps": ev_ddpm.diffusion.num_steps, "wall_s": ddpm_s,
                          "stage_seconds": ddpm.stage_seconds, "launches": ddpm_counts,
                          "metrics": {k: getattr(ddpm, k) for k in ("fid", "bc", "l1div", "srgr")}},
        "fgd_card_vs_cpu": fgd_card_vs_cpu(ev, d / "run_eval" / "results", result.clips),
        "face_lbs": face_lbs_at_release_size(max(cache.clips.values(), key=lambda c: c["poses"].shape[0])),
    })
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def phase_train_loop(rvq_iters: int = LOOP_RVQ_ITERS, rvq_overrides=(), mdm_overrides=()) -> dict:
    """Training part B on the card: a synthetic BEAT2 corpus and its window
    caches; ``cli.train_rvq.main()`` on ``configs/rvq_beat2.yaml`` for the
    three parts (``rvq_iters`` each, from a device-resident dataset) and
    ``cli.train.main()`` on ``configs/diffusion_beat2.yaml`` for two epochs
    on the RVQ-VAEs just written; ``generate`` on those checkpoints (exact
    K2 and K3 counts, every K3 call against the plain version, the plain
    f32 sampler within SAMPLER_REL); then the re-read of the stream's
    faults on the trained decoders: the decoder's reach, the K1 stream
    against the whole-clip decode, and two f32 decodes of the same codes
    (card and CPU)."""
    out = {"phase": "train_loop", "card": card_name_and_power_limit()}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        out["data"] = build_loop_caches(d)
        emit({"phase": "train_loop", "card": out["card"], "data": out["data"]})
        paths = []
        for part in ("upper", "hands", "lower"):
            out[f"rvq_{part}"], path = loop_rvq(part, d, rvq_iters, list(rvq_overrides))
            emit({"phase": "train_loop", "card": out["card"], "model": f"rvq_{part}", **out[f"rvq_{part}"]})
            paths.append(path)
        out["diffusion"], mdm_path = loop_mdm(d, paths, list(mdm_overrides))
        emit({"phase": "train_loop", "card": out["card"], "model": "beat2", **out["diffusion"]})
        ov = ["diffusion.timestep_respacing=ddim50", f"rvq_ckpts=[{','.join(map(str, paths))}]", f"test_ckpt={mdm_path}",
              no_stats(d), *mdm_overrides]
        out["generate"] = phase_generate("trained_loop", BEAT2_CONFIG, ov, {})
        mdm, rvq, diffusion, _ = GEN.load_models(load_config(BEAT2_CONFIG, ov), DEV)
        lat, other = clip_latents(rvq, d)
        out["faults"] = {"reach_rot6d_change_beyond": decoder_reach(rvq, lat, other),
                         "random_latents_reach": decoder_reach(rvq, *(
                             torch.randn(2, 1, lat.shape[1], lat.shape[2], device=DEV,
                                         generator=torch.Generator(DEV).manual_seed(0)) / 5.0)),
                         "framework_gap": framework_gap(rvq, lat),
                         "stream": trained_stream(mdm, diffusion, rvq)}
        emit({"phase": "train_loop", "card": out["card"], "faults": out["faults"]})
        out["evaluate"] = phase_evaluate(d, paths, mdm_path, mdm_overrides)
    return out


# ---------------------------------------------------------------------------
# h3d phase: the text-control stack (h3d623 trainers, the TMR prompt channel, test_h3d with the BiGRU oracle)
# ---------------------------------------------------------------------------

H3D_CLIPS, H3D_SECONDS = 4, (12.0, 24.0)  # clips a speaker of LOOP_SPEAKERS: 16 clips, a quarter of them the test split
H3D_RVQ_ITERS = 300  # a part's iterations at batch 256 (configs/rvq_beat2.yaml: 300,000)
H3D_MDM_EPOCHS = 2
H3D_REPLICATIONS, H3D_STEERING_CLIPS = 3, 2  # cli.test_h3d's defaults: 20 replications, 4 steering clips
ORACLE_REL = 1e-5  # the BiGRU oracle in full f32 on the card and on the CPU, sums in another order
TMR_NPZ = Path(__file__).resolve().parent / "weights" / "t2m_oracle" / "tmr.npz"


def h3d_overrides(d: Path) -> list:
    return [*loop_overrides(d), "representation=h3d623", "data.smplx_model_path=synthetic"]


def build_h3d_caches(d: Path) -> dict:
    """The corpus and the train caches of the h3d trainers, built with the
    synthetic SMPL-X model on the card so that every window carries its
    623-d ``h3d`` array (the CLIs then find them: a cache hit)."""
    t0 = time.perf_counter()
    ids = make_corpus(d / "corpus", speakers=LOOP_SPEAKERS, clips_per_speaker=H3D_CLIPS, seconds_range=H3D_SECONDS,
                      seed=1)
    out = {"clips": len(ids), "speakers": list(LOOP_SPEAKERS), "seconds_range": list(H3D_SECONDS),
           "corpus_s": time.perf_counter() - t0}
    smplx = SMPLX.synthetic_smplx_model(device=DEV)
    for name, cache_dir, length in (("rvq", d / "cache_rvq", load_config(RVQ_CONFIG).rvq_train.window),
                                    ("mdm", d / "cache", load_config(H3D_CONFIG).data.pose_length)):
        t0 = time.perf_counter()
        cache, vocab = build_beat_cache(d / "corpus", cache_dir, speakers=LOOP_SPEAKERS, smplx_model=smplx,
                                        cfg=ClipConfig(pose_length=length, stride=20))
        assert cache.get(0)["h3d"].shape == (length, 623)
        out[name] = {"window": length, "stride": 20, "windows": len(cache), "cache_mb": cache_bytes(cache_dir) / 2**20,
                     "build_s": time.perf_counter() - t0, "vocab_words": vocab.n_words}
    return out


def h3d_mdm(d: Path, rvq_paths: list, overrides=()) -> tuple:
    """The ``configs/diffusion_h3d.yaml`` denoiser through ``DiffusionTrainer``
    with the frozen TMR motion encoder of ``weights/t2m_oracle/tmr.npz`` as
    its prompt channel, for H3D_MDM_EPOCHS epochs; (phase dict, checkpoint)."""
    cfg = load_config(H3D_CONFIG, [*h3d_overrides(d), f"rvq_ckpts=[{','.join(map(str, rvq_paths))}]",
                                   f"train.epochs={H3D_MDM_EPOCHS}", "train.log_period=1", "train.device_data=true",
                                   *overrides])
    cache = BeatCache.open(d / "cache" / "train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = DiffusionTrainer(cfg, cache, tmr_motion=load_tmr_motion(TMR_NPZ, device=DEV), device=DEV)
    for epoch in range(H3D_MDM_EPOCHS):
        trainer.train_epoch(epoch)
    path = trainer.save()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ds = trainer.device_dataset()
    assert set(ds.arrays) == {"h3d", "audio", "word"} and ds.arrays["h3d"].device.type == DEV.type, list(ds.arrays)
    steps = H3D_MDM_EPOCHS * len(ds)
    assert path.name == f"step_{steps}.npz", (path, steps)
    batch = ds.batch(next(iter(ds.epoch_indices(0))))
    prompt = trainer.featurize(batch)["prompt"]
    assert prompt.shape == (batch["h3d"].shape[0], cfg.mdm.prompt_dim) and torch.isfinite(prompt).all()
    losses = [h["loss"] for h in trainer.history]
    assert np.isfinite(losses).all()
    out = {"config": H3D_CONFIG, "epochs": H3D_MDM_EPOCHS, "steps": steps, "batch": trainer.loader.batch_size,
           "windows": ds.n, "dataset_gb": ds.nbytes / 1e9, "prompt_channel": "TMR motion mu (weights/t2m_oracle/tmr.npz)",
           "wall_s": wall_s, "loss_first": losses[0], "loss_last": losses[-1], **trainer_timing(trainer)}
    return out, path


@contextlib.contextmanager
def recorded_k2(batch: int):
    """The input of the first K2 call at ``batch`` samples made inside, kept
    with its weights for a comparison with the plain version after the run."""
    seen, fused = [], mdm_cuda.block_stack

    def record(x, w, *, num_heads):
        if not seen and x.shape[0] == batch:
            seen.append((x.clone(), w, num_heads))
        return fused(x, w, num_heads=num_heads)

    mdm_cuda.block_stack = record
    try:
        yield seen
    finally:
        mdm_cuda.block_stack = fused


def oracle_card_vs_cpu(cache, n_clips: int) -> dict:
    """The committed oracle's motion and text embeddings of the test clips'
    ground truth on the card against the same on the CPU."""
    card, cpu = TEST_H3D.t2m.T2MEvaluator.from_artifact(device=DEV), TEST_H3D.t2m.T2MEvaluator.from_artifact(
        device="cpu")
    feats = [cache.get(i)["h3d"] for i in range(n_clips)]
    n = min(f.shape[0] for f in feats)
    motion, lens = np.stack([f[:n] for f in feats]), np.asarray([n - 3 * i for i in range(n_clips)])
    text, _ = TEST_H3D.caption_features(cache, n_clips)
    we, po, ln = (np.concatenate([t[k] for t in text]) for k in ("word_embs", "pos_ohot", "cap_lens"))
    t0 = time.perf_counter()
    m_card = card.get_motion_embeddings(motion, lens)
    card_ms = 1e3 * (time.perf_counter() - t0)
    t_card = card.text_embeddings(we, po, ln).cpu().numpy()
    m_cpu, t_cpu = cpu.get_motion_embeddings(motion, lens), cpu.text_embeddings(we, po, ln).numpy()
    out = {"clips": n_clips, "frames": n, "motion_rel_err": rel_err(torch.as_tensor(m_card), torch.as_tensor(m_cpu)),
           "text_rel_err": rel_err(torch.as_tensor(t_card), torch.as_tensor(t_cpu)), "card_motion_ms": card_ms,
           "tol": ORACLE_REL}
    assert out["motion_rel_err"] <= ORACLE_REL and out["text_rel_err"] <= ORACLE_REL, out
    return out


def phase_h3d(rvq_iters: int = H3D_RVQ_ITERS, rvq_overrides=(), mdm_overrides=()) -> dict:
    """The text-control stack on the card at the shipped widths, cut in data
    and iterations: a synthetic corpus with its h3d arrays; the three h3d623
    RVQ-VAEs through ``cli.train_rvq`` (``configs/rvq_beat2.yaml``'s widths,
    batch 256, ``rvq_iters`` each); the ``configs/diffusion_h3d.yaml``
    denoiser through ``DiffusionTrainer`` with the TMR prompt channel;
    then ``cli.test_h3d`` on the test split (the committed BiGRU oracle and
    TMR text head, DDIM-50, H3D_REPLICATIONS replications, H3D_STEERING_CLIPS
    steering clips): exact K2 and K3 counts against the window plans, K2
    (recorded at the guided step's three branches) and every K3 call against
    their plain versions, the oracle on the card against the CPU, and finite
    metrics."""
    out = {"phase": "h3d", "card": card_name_and_power_limit()}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        out["data"] = build_h3d_caches(d)
        paths = []
        for part in ("upper", "hands", "lower"):
            res, path = loop_rvq(part, d, rvq_iters, ["representation=h3d623", "data.smplx_model_path=synthetic",
                                                      *rvq_overrides])
            out[f"rvq_{part}"] = {k: res[k] for k in ("iters", "batch", "windows", "wall_s_to_trained", "first_log",
                                                      "last_log", "loop_ms_per_step", "cuda_event_warm_step_ms",
                                                      "profile")}
            paths.append(path)
        emit({"phase": "h3d", "card": out["card"], "data": out["data"],
              **{f"rvq_{p}": out[f"rvq_{p}"] for p in ("upper", "hands", "lower")}})
        out["diffusion"], mdm_path = h3d_mdm(d, paths, mdm_overrides)
        emit({"phase": "h3d", "card": out["card"], "model": "h3d denoiser", **out["diffusion"]})

        argv = ["-c", H3D_CONFIG, "--run-dir", str(d / "run_h3d"), *h3d_overrides(d),
                f"rvq_ckpts=[{','.join(map(str, paths))}]", f"test_ckpt={mdm_path}", f"train.ckpt_dir={d / 'h3d_eval'}",
                *mdm_overrides, "--replications", str(H3D_REPLICATIONS), "--steering-clips", str(H3D_STEERING_CLIPS)]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_k3() as k3_calls, recorded_k2(3) as k2_calls:
            metrics = TEST_H3D.main(argv)
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {**mdm_cuda.launches, **quantize_cuda.launches}

        cfg = load_config(H3D_CONFIG, [*h3d_overrides(d), *mdm_overrides])
        cache = BeatCache.open(d / "cache" / "test")
        windows = [G.plan_windows(cache.get(i)["pose"].shape[0], pose_length=cfg.data.pose_length,
                                  pre_frames=cfg.pre_frames).num_windows for i in range(len(cache))]
        steer = min(H3D_STEERING_CLIPS, len(cache))
        steps = make_diffusion(schedule=cfg.diffusion.schedule, steps=cfg.diffusion.steps,
                               timestep_respacing=cfg.diffusion.timestep_respacing or None).num_steps
        generations = H3D_REPLICATIONS * len(cache) + 2 * steer
        passes = steps * (H3D_REPLICATIONS * sum(windows) + 2 * sum(windows[:steer]))
        # one more pass the first time each batch size runs (1 unprompted, 3 guided branches), before its graph
        want = {"ddim_window": 0, "rvq_encode": 3 * generations,
                "block_stack": (passes + 2) * mdm_cuda.block_launches(cfg.mdm.num_layers)}
        assert counts == want, (counts, want)
        k3 = k3_calls_check(k3_calls)
        (x, w, heads), = k2_calls
        k2_err = rel_err(mdm_cuda.block_stack(x, w, num_heads=heads), mdm_cuda.block_stack_plain(x, w, num_heads=heads))
        assert k2_err <= K2_REL, k2_err

        keys = ["fid", "diversity", "matching"] + [f"r_precision_top{k}" for k in range(1, min(3, len(cache)) + 1)]
        assert set(keys) <= set(metrics), sorted(metrics)
        scores = {k: metrics[k] for k in keys}
        steering = {k: metrics[k] for k in ("steering_prompt_gain", "steering_prompted_part_rel_change",
                                            "steering_offpart_leakage", "steering_clips", "steering_part")}
        assert np.isfinite([v["mean"] for v in scores.values()]).all(), scores
        assert np.isfinite([steering[k] for k in list(steering)[:3]]).all(), steering
        out.update({
            "cuts": [f"synthetic corpus (speakers {list(LOOP_SPEAKERS)}, {out['data']['clips']} clips of "
                     f"{H3D_SECONDS[0]:g}-{H3D_SECONDS[1]:g} s)", "synthetic SMPL-X model", "identity h3d statistics",
                     f"RVQ-VAEs {rvq_iters} iterations a part", f"denoiser {H3D_MDM_EPOCHS} epochs",
                     f"{H3D_REPLICATIONS} replications (20)", f"{H3D_STEERING_CLIPS} steering clips (4)"],
            "test_h3d": {"clips": len(cache), "windows": windows, "steps": steps, "generations": generations,
                         "wall_s": wall_s, "ms_per_generation": 1e3 * wall_s / generations, "metrics": scores,
                         "steering": steering, "launches": counts,
                         "rvq_kernels": counts["rvq_encode"] * quantize_cuda.rvq_kernel_launches(6), "k3_vs_plain": k3,
                         "k2_vs_plain": {"samples": x.shape[0], "rows": x.shape[0] * x.shape[1], "rel_err": k2_err,
                                         "tol": K2_REL}},
            "oracle_card_vs_cpu": oracle_card_vs_cpu(cache, len(cache)),
        })
    out["phase_s"] = time.perf_counter() - t_phase
    emit({k: v for k, v in out.items() if k not in ("data",) and not k.startswith("rvq_") and k != "diffusion"})
    return out


# ---------------------------------------------------------------------------
# convert_demo phase: the reference's checkpoints converted, then the demo
# ---------------------------------------------------------------------------

DEMO_SECONDS = 8.0  # 240 frames: 2 windows, 60 latent frames, 240 output frames
DEMO_SEED = 41
FK_REL = 1e-5  # f32 forward kinematics on the card and on the CPU, sums in another order
EVAL_REL = 1e-4  # the eval VAE and the face VQ-VAE in full f32 on the card and on the CPU, convolutions in another order


def reference_layouts():
    """``tests/torch_reference_checkpoints.py`` (no JAX), loaded by path as
    ``phase_k3_card_rows`` loads the card tests."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("reference_layouts", Path(__file__).parent / "tests" /
                                                  "torch_reference_checkpoints.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_reference_checkpoints(d: Path, cfg) -> dict:
    """Seeded modules at the config's widths on the CPU, saved as the
    reference's checkpoint files: the denoiser with a BatchNorm WavEncoder
    (random positive running variances) as a bare state dict
    (``last_500.bin``), each body part's RVQ-VAE as ``{'net': ...}`` with
    DataParallel's ``module.`` prefix, the eval VAE and the face VQ-VAE as
    ``{'model_state': ...}``."""
    ref = reference_layouts()
    source = ref.perturb_wav_norms(bridge.mdm_to_flax(build_mdm(dataclasses.replace(cfg.mdm, audio_norm="batch"),
                                                                seed=DEMO_SEED, device="cpu")), seed=DEMO_SEED)
    paths = {"mdm": d / "last_500.bin"}
    torch.save(ref.mdm_state_dict(source), paths["mdm"])
    for i, part in enumerate(("upper", "hands", "lower")):
        module, state = build_rvqvae(rvq_config(cfg, part), seed=DEMO_SEED + 1 + i, device="cpu")
        sd = ref.rvqvae_state_dict(ref.flax_tree(module), state.codebook.numpy(), depth=cfg.rvq_depth)
        paths[part] = d / f"rvq_{part}" / "net_300000.pth"
        paths[part].parent.mkdir()
        torch.save({"net": ref.module_prefixed(sd)}, paths[part])
    paths["eval_vae"], paths["face_vqvae"] = d / "AESKConv_240_100.bin", d / "face_vqvae.bin"
    torch.save({"model_state": ref.eval_vae_state_dict(ref.flax_tree(build_eval_vae(seed=DEMO_SEED, device="cpu")))},
               paths["eval_vae"])
    torch.save({"model_state": ref.face_vqvae_state_dict(ref.flax_tree(build_face_vqvae(seed=DEMO_SEED,
                                                                                      device="cpu")))},
               paths["face_vqvae"])
    return paths


def convert_checkpoints(d: Path, cfg, paths: dict) -> dict:
    """The reference files through the port's converters: the denoiser and
    the RVQ stack written as the npz checkpoints ``generate`` reads
    (``test_ckpt``, ``rvq_ckpts``), the eval models' flax trees kept."""
    mdm_npz = d / "mdm.npz"
    np.savez(mdm_npz, **flatten_params(CV.convert_mdm(torch.load(paths["mdm"], map_location="cpu"),
                                                      num_layers=cfg.mdm.num_layers, num_heads=cfg.mdm.num_heads)))
    rvq_npz = []
    for part in ("upper", "hands", "lower"):
        rcfg = rvq_config(cfg, part)
        params, qstate = CV.load_torch_rvqvae(str(paths[part]), depth=rcfg.depth,
                                              num_quantizers=rcfg.quantizer.num_quantizers)
        rvq_npz.append(d / f"rvq_{part}.npz")
        np.savez(rvq_npz[-1], **flatten_params({**params, "quantizer_state": bridge.rvq_state_to_flax(qstate)}))
    return {"test_ckpt": mdm_npz, "rvq_ckpts": rvq_npz,
            "eval_vae": CV.convert_eval_vae(CV.load_torch_eval_checkpoint(str(paths["eval_vae"]))),
            "face_vqvae": CV.convert_face_vqvae(CV.load_torch_eval_checkpoint(str(paths["face_vqvae"])))}


def face_near_ties(model, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows whose top-2 code distances lie within K3_TIE·|z|² (CPU, f64)."""
    z = model.encoder(x).reshape(-1, model.codebook.shape[1]).double()
    dist = torch.cdist(z, model.codebook.double()) ** 2
    top2 = dist.topk(2, dim=-1, largest=False).values
    return (top2[:, 1] - top2[:, 0]) <= K3_TIE * (z * z).sum(-1)


def eval_models_card_vs_cpu(trees: dict) -> dict:
    """The converted eval VAE's ``map2latent`` and the face VQ-VAE's encode
    and decode, on the card against the CPU, on seeded inputs."""
    g = torch.Generator().manual_seed(DEMO_SEED)
    out = {}
    rot6d = torch.randn(2, 64, 330, generator=g) * 0.5
    vae = {dev: bridge.eval_vae_from_flax(trees["eval_vae"], device=dev) for dev in ("cpu", DEV)}
    with torch.no_grad():
        lat = {dev: vae[dev].map2latent(rot6d.to(dev)).cpu() for dev in vae}
    out["eval_vae_map2latent"] = {"shape": list(lat["cpu"].shape), "rel_err": rel_err(lat[DEV], lat["cpu"]),
                                  "tol": EVAL_REL}
    face_in = torch.randn(2, 64, 106, generator=g) * 0.5
    face = {dev: bridge.face_vqvae_from_flax(trees["face_vqvae"], device=dev) for dev in ("cpu", DEV)}
    with torch.no_grad():
        idx = {dev: face[dev].map2index(face_in.to(dev)).cpu() for dev in face}
        tie = face_near_ties(face["cpu"], face_in, idx["cpu"])
        dec = {dev: face[dev].decode_indices(idx["cpu"].to(dev)).cpu() for dev in face}
    differ = (idx[DEV] != idx["cpu"]).reshape(-1)
    out["face_vqvae"] = {"rows": differ.numel(), "codes_used": int(idx["cpu"].unique().numel()),
                         "rows_differing": int(differ.sum()), "near_tie_rows": int(tie.sum()),
                         "rows_differing_off_ties": int((differ & ~tie).sum()),
                         "decode_rel_err": rel_err(dec[DEV], dec["cpu"]), "tol": EVAL_REL}
    assert out["eval_vae_map2latent"]["rel_err"] <= EVAL_REL, out
    assert out["face_vqvae"]["rows_differing_off_ties"] == 0 and out["face_vqvae"]["decode_rel_err"] <= EVAL_REL, out
    return out


def phase_convert_demo(seconds: float = DEMO_SECONDS, overrides=()) -> dict:
    """A user's path from the reference's torch checkpoints to a video, at
    the widths of ``configs/diffusion_beat2.yaml`` (seeded random weights):
    reference-layout state dicts saved in the reference's file shapes; the
    port's converters; the denoiser (its BatchNorm folded, ``audio_norm=none``)
    and the RVQ stack written as npz checkpoints; ``cli.demo`` one-shot on a
    synthetic wav (``generate --render``: K2 at every DDIM-50 step, K3 once a
    part, forward kinematics on the card, the drawing on the host), with
    exact K2/K3 counts, every K3 call and K2 at the clip's shape held
    against their plain versions, and the warm ms of the same clip; K1
    (``sample_windows_fused_loop``) on the converted denoiser for the same
    windows against the plain f32 sampler; the clip's joints on the card
    against the CPU; the converted eval VAE and face VQ-VAE on the card
    against the CPU. Where matplotlib or imageio is missing, the demo runs
    all the same, forward kinematics on the card included, but the drawing
    is skipped and a line says so."""
    import importlib.util

    out = {"phase": "convert_demo", "card": card_name_and_power_limit()}
    t_phase = time.perf_counter()
    missing = [m for m in ("matplotlib", "imageio") if importlib.util.find_spec(m) is None]
    if missing:
        print(f"convert_demo: drawing not run: {', '.join(missing)} not installed", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        base = load_config(BEAT2_CONFIG, list(overrides))
        t0 = time.perf_counter()
        paths = write_reference_checkpoints(d, base)
        out["state_dicts_s"] = time.perf_counter() - t0
        out["reference_files_mb"] = {k: p.stat().st_size / 2**20 for k, p in paths.items()}
        t0 = time.perf_counter()
        conv = convert_checkpoints(d, base, paths)
        out["convert_s"] = time.perf_counter() - t0

        files = write_generate_inputs(d, base.mdm.vocab_size, seconds)
        ov = [*overrides, f"test_ckpt={conv['test_ckpt']}",
              f"rvq_ckpts=[{','.join(map(str, conv['rvq_ckpts']))}]", "mdm.audio_norm=none",
              f"data.mean_std_dir={d / 'no_stats'}"]
        run_dir = d / "demo"
        drawn = []  # (joints, wall s) of each drawing; without matplotlib or imageio the joints alone
        draw = R.render_stick_figure

        def render_stick_figure(joints, out_path, **kw):
            t0 = time.perf_counter()
            path = Path(out_path).with_suffix(".gif") if missing else draw(joints, out_path, **kw)
            drawn.append((joints, time.perf_counter() - t0))
            return path

        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        R.render_stick_figure = render_stick_figure
        try:
            with recorded_k3() as k3_calls:
                video = Path(DEMO.main(["-c", BEAT2_CONFIG, "--wav", str(files["wav"]), "--run-dir", str(run_dir),
                                        *ov]))
                torch.cuda.synchronize()
        finally:
            R.render_stick_figure = draw
        out["demo_main_s"] = time.perf_counter() - t0
        counts = {**mdm_cuda.launches, **quantize_cuda.launches}
        cfg = load_config(BEAT2_CONFIG, ov)
        npz_path = run_dir / "demo_out.npz"
        with np.load(npz_path) as f:
            poses, trans = f["poses"], f["trans"]
        plan = G.plan_windows(int(seconds * cfg.data.pose_fps), pose_length=cfg.data.pose_length,
                              pre_frames=cfg.pre_frames)
        diffusion = make_diffusion(schedule=cfg.diffusion.schedule, steps=cfg.diffusion.steps,
                                   timestep_respacing=cfg.diffusion.timestep_respacing or "ddim50")
        # one K2 pass a step a window, and one more at the first step, before its graph is captured
        want = {"ddim_window": 0, "rvq_encode": 3,
                "block_stack": (plan.num_windows * diffusion.num_steps + 1) * mdm_cuda.block_launches(
                    cfg.mdm.num_layers)}
        assert counts == want, (counts, want)
        assert poses.shape == (4 * plan.out_latent_frames, 165) and trans.shape == (poses.shape[0], 3), poses.shape
        assert np.isfinite(poses).all() and np.isfinite(trans).all()
        k3 = k3_calls_check(k3_calls)
        (card_joints, draw_s), = drawn
        out["video"] = {"file": video.name, "drawn": not missing, "draw_and_encode_s": None if missing else draw_s}
        if not missing:
            import imageio

            assert video.exists() and video.parent == run_dir and video.stem == "demo_out", video
            out["video"].update(bytes=video.stat().st_size, frames=len(imageio.mimread(video, memtest=False)))
            assert out["video"]["frames"] == poses.shape[0], out["video"]

        # the same clip warm, on models built once; K2 at the clip's shape against its plain version
        models = GEN.load_models(cfg, DEV)
        mdm = models[0]
        weights = mdm_cuda.stack_block_weights(mdm)
        kernel = mdm_cuda.make_fused_denoise(mdm, weights)

        def clip():
            return GEN.generate_clip(cfg, files["wav"], generator=torch.Generator(DEV).manual_seed(cfg.train.seed),
                                     denoise=kernel, models=models, device=DEV)

        clip()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = clip()
        torch.cuda.synchronize()
        out["warm_clip_ms"] = 1e3 * (time.perf_counter() - t0)
        assert np.array_equal(warm["npz"]["poses"], poses), "the warm clip is the demo's"
        x = torch.randn(1, plan.latent_window, cfg.mdm.latent_dim, device=DEV,
                        generator=torch.Generator(DEV).manual_seed(DEMO_SEED))
        k2_err = rel_err(mdm_cuda.block_stack(x, weights, num_heads=cfg.mdm.num_heads),
                         mdm_cuda.block_stack_plain(x, weights, num_heads=cfg.mdm.num_heads))
        assert k2_err <= K2_REL, k2_err

        # K1 on the converted denoiser for the same windows, B=1
        y, sr = A.load_wav_mono(files["wav"], cfg.data.audio_sr)
        feats = A.onset_amplitude_features(y, sr)[None]
        aw = torch.as_tensor(G.window_audio(feats, plan, sr=sr, fps=cfg.data.pose_fps), device=DEV)
        ww = torch.zeros(plan.num_windows, 1, plan.pose_length, dtype=torch.long, device=DEV)
        seed = torch.zeros(1, plan.pre_frames, cfg.mdm.latent_total_dim, device=DEV)
        noise = G.draw_noise(plan, 1, torch.Generator(DEV).manual_seed(DEMO_SEED), DEV)
        sampler = G.make_fused_loop_sampler(mdm, diffusion, plan)
        G.sample_windows_fused_loop(mdm, diffusion, plan, aw, ww, seed, noise, fused=sampler)  # captures K1's graph
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k1_lat = G.sample_windows_fused_loop(mdm, diffusion, plan, aw, ww, seed, noise, fused=sampler)
        torch.cuda.synchronize()
        k1_ms = 1e3 * (time.perf_counter() - t0)
        k1_counts = {**mdm_cuda.launches, **quantize_cuda.launches}
        want_k1 = {"ddim_window": plan.num_windows * mdm_cuda.window_launches(cfg.mdm.num_layers,
                                                                               diffusion.num_steps),
                   "block_stack": 0, "rvq_encode": 0}
        assert k1_counts == want_k1, (k1_counts, want_k1)
        f32 = dataclasses.replace(cfg.mdm, dtype=torch.float32, audio_dtype=torch.float32)
        ref_mdm = bridge.mdm_from_flax(f32, bridge.mdm_to_flax(mdm), device=DEV)
        k1_err = rel_err(k1_lat, G.sample_windows_lean(ref_mdm, diffusion, plan, aw, ww, seed, noise))
        assert k1_err <= SAMPLER_REL, k1_err

        # the joints the demo's render_npz computed on the card against the CPU's
        cpu_joints = R._npz_joints(npz_path, device="cpu")
        fk_err = float(np.abs(card_joints - cpu_joints).max() / np.abs(cpu_joints).max())
        assert card_joints.shape == (poses.shape[0], 55, 3) and fk_err <= FK_REL, fk_err
        out.update({
            "config": BEAT2_CONFIG, "overrides": list(overrides), "seconds": seconds, "frames": poses.shape[0],
            "windows": plan.num_windows, "steps": diffusion.num_steps,
            "launches": counts, "rvq_kernels": counts["rvq_encode"] * quantize_cuda.rvq_kernel_launches(6),
            "k3_vs_plain": k3, "k2_vs_plain": {"samples": 1, "rows": plan.latent_window, "rel_err": k2_err,
                                               "tol": K2_REL},
            "k1": {"launches": k1_counts, "ms": k1_ms, "reference": "sample_windows_lean f32",
                   "rel_err": k1_err, "tol": SAMPLER_REL},
            "fk_card_vs_cpu": {"joints": list(cpu_joints.shape), "rel_err": fk_err, "tol": FK_REL},
            "eval_models_card_vs_cpu": eval_models_card_vs_cpu(conv),
        })
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ---------------------------------------------------------------------------
# mesh: the sharded service (one process, a copy of the weights and graphs a device) and data- and
# tensor-parallel training over torch.distributed (one process a rank)

# a shard against the unsharded service at the shard's batch on the same requests and noise: the same operations
# at the same shapes, so the same bits. Against the whole bucket in one batch the path is not batch-free: cuBLAS's
# f32 GEMMs (the seed embedding, the projections around K2) sum in another order at another row count (7.2e-7 on
# the seed embedding at 8 rows against 4; measured on one H100), which the bf16 rounding of K1's and K2's inputs
# magnifies over 4 windows x 50 steps, as bf16 against f32 does: held to SAMPLER_REL
MESH_ABS = 1e-6
MESH_BATCH = {"diffusion": 40, "rvq": 256}  # the train yamls' global batches
MESH_STEPS = 3
MESH_LOSS_RTOL, MESH_PARAM_REL = 2e-4, 1e-5
TP_ATOL, TP_RTOL = 5e-5, 1e-5  # JAX's tests/test_parallel.py, model=2 against replicated
MESH_SPAWN_S = 300  # a group that has not finished by then has hung
# the groups of mesh_train: (backend, ranks (None: one a card), whether it also runs the model=2 forward)
MESH_GROUPS = (("nccl", None, False), ("gloo", 2, True))
# the beat2 yaml's denoiser with its blocks and wav encoder in f32: in bf16 a GEMM's rounding at one batch and at a
# shard's (cuBLAS picks its kernel by the row count) would part the one-device step from the group's by more
# than the reduction does
MESH_OVERRIDES = {"diffusion": ["mdm.dtype=float32", "mdm.audio_dtype=float32"], "rvq": ["rvq_train.body_part=upper"]}
TP_CONFIG = MDMConfig()


@contextlib.contextmanager
def recorded_latents():
    """The latents every ``generation.decode_latents`` call is given (a
    sharded flush decodes shard by shard, in data order)."""
    seen, decode = [], G.decode_latents
    G.decode_latents = lambda lat, **kw: seen.append(lat.clone()) or decode(lat, **kw)
    try:
        yield seen
    finally:
        G.decode_latents = decode


def mesh_requests(seed: int, prompted: bool):
    """``requests(seed)``; with ``prompted`` each carries an upper-body
    prompt and the H3D guidance (one group)."""
    reqs = requests(seed)
    rng = np.random.default_rng(seed + 100)
    for req in reqs if prompted else ():
        req.prompts, req.guidance = {"upper": rng.standard_normal(256).astype(np.float32)}, dict(GUIDANCE)
    return reqs


@contextlib.contextmanager
def fed_noise():
    """``generation.draw_noise`` that returns the tensors put in the queue,
    in order, and draws from the service's generator when it is empty."""
    queue, draw = [], G.draw_noise
    G.draw_noise = lambda plan, batch, gen, device: queue.pop(0) if queue else draw(plan, batch, gen, device)
    try:
        yield queue
    finally:
        G.draw_noise = draw


def mesh_flush(mdm, diffusion, rvq, fused_loop: bool, prompted: bool, mesh, noise, max_batch: int = SERVE_BATCH):
    """A cold flush (graph captures, the service's own noise), then the warm
    requests in flushes of ``max_batch``, each on its slice of ``noise``
    (W, SERVE_BATCH, T, C); returns the real requests' latents, the
    launches and ms of the warm flushes."""
    svc = MotionGenerationService(mdm=mdm, diffusion=diffusion, rvq_modules=rvq, stats=identity_pose_stats(),
                                  max_batch=max_batch, max_seconds=SERVE_SECONDS, fused_loop=fused_loop,
                                  device=DEV, seed=5, mesh=mesh)
    timed_flush(svc, mesh_requests(20, prompted)[:max_batch])
    reqs, latents, ms = mesh_requests(21, prompted), [], 0.0
    reset_launches()
    for lo in range(0, len(reqs), max_batch):
        with recorded_latents() as seen, fed_noise() as queue:
            queue.append(noise[:, lo : lo + max_batch].contiguous())
            results, flush_ms, _ = timed_flush(svc, reqs[lo : lo + max_batch])
        latents.append(torch.cat([t.to(DEV) for t in seen])[: len(results)])  # shards come from every card
        ms += flush_ms
        for r in results:
            assert np.isfinite(r.axis_angle).all() and np.isfinite(r.trans).all()
    counts = {**mdm_cuda.launches, **quantize_cuda.launches}
    return {"latents": torch.cat(latents), "launches": counts, "ms": ms, "plan": svc.plan}


def mesh_kernels_vs_plain(mdm, diffusion, rvq, b: int) -> dict:
    """K1, K2 and K3 at a shard's shapes (b samples; K2 also at the prompted
    group's 3·b) against their plain versions."""
    g = torch.Generator(DEV).manual_seed(9)
    cfg, t = mdm.cfg, 32  # a window's latent frames
    w = mdm_cuda.stack_block_weights(mdm)
    out = {}
    for rows in (b, 3 * b):
        x = torch.randn(rows, t, cfg.latent_dim, generator=g, device=DEV)
        out[f"k2_b{rows}_rel_err"] = rel_err(mdm_cuda.block_stack(x, w, num_heads=cfg.num_heads),
                                             mdm_cuda.block_stack_plain(x, w, num_heads=cfg.num_heads))
        assert out[f"k2_b{rows}_rel_err"] < K2_REL, out
    fused = mdm_cuda.FusedDDIMWindow(mdm, diffusion)
    cond = Conditioning(at_feat=torch.randn(b, t, cfg.audio_feat_dim, generator=g, device=DEV),
                        seed_emb=torch.randn(b, cfg.latent_dim, generator=g, device=DEV))
    x = torch.randn(b, t, J.LATENT_DIM, generator=g, device=DEV)
    out[f"k1_b{b}_rel_err"] = rel_err(fused(x, cond), fused.plain(x, cond))
    assert out[f"k1_b{b}_rel_err"] < K1_REL, out
    codebooks = rvq["upper"][1].codebook
    rows = torch.randn(b * 116, codebooks.shape[-1], generator=g, device=DEV)
    out[f"k3_rows{b * 116}"] = rvq_check(rows, codebooks, *quantize_cuda.rvq_encode_fused(rows, codebooks))
    return out


def phase_mesh_serve(mdm, diffusion, rvq) -> dict:
    """The service on a data=2 mesh of [cuda:0, cuda:0] (and over every
    card when there are several): one flush each through K1, K2 and a
    prompted group, on fixed noise; each against the unsharded service at
    a shard's batch flushing the shards' requests and noise in turn (the
    same bits) and against the whole bucket in one batch (SAMPLER_REL);
    exact counts on the warm sharded flush."""
    layers, steps = mdm.cfg.num_layers, diffusion.num_steps
    meshes = {"one_card": make_mesh(2, 1, devices=[DEV, DEV])}
    if torch.cuda.device_count() > 1:
        meshes["cards"] = make_mesh(devices=[torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    out = {"phase": "mesh_serve", "card": card_name_and_power_limit(), "batch": SERVE_BATCH, "routes": {},
           "kernels_vs_plain": mesh_kernels_vs_plain(mdm, diffusion, rvq, SERVE_BATCH // 2)}
    rvq_kernels = quantize_cuda.rvq_kernel_launches(6)
    plan = G.plan_windows(int(SERVE_SECONDS * 30))
    noise = torch.randn(plan.num_windows, SERVE_BATCH, plan.latent_window, J.LATENT_DIM,
                        generator=torch.Generator(DEV).manual_seed(22), device=DEV)
    for route, fused_loop, prompted in (("k1", True, False), ("k2", False, False), ("prompted", True, True)):
        plain = mesh_flush(mdm, diffusion, rvq, fused_loop, prompted, None, noise)
        res = {"unsharded_ms": plain["ms"]}
        for name, mesh in meshes.items():
            n = mesh.shape["data"]
            got = mesh_flush(mdm, diffusion, rvq, fused_loop, prompted, mesh, noise)
            shard = mesh_flush(mdm, diffusion, rvq, fused_loop, prompted, None, noise, max_batch=SERVE_BATCH // n)
            err = (got["latents"] - shard["latents"]).abs().max().item()
            want = {"ddim_window": n * plan.num_windows * mdm_cuda.window_launches(layers, steps)
                    if route == "k1" else 0,
                    "block_stack": 0 if route == "k1" else n * plan.num_windows * steps * mdm_cuda.block_launches(layers),
                    "rvq_encode": 3 * n}
            res[name] = {"data": n, "ms": got["ms"], "shard_batch_service_ms": shard["ms"],
                         "latents_max_abs_err_vs_shard_batch": err,
                         "latents_rel_err_vs_whole_batch": rel_err(got["latents"], plain["latents"]),
                         "launches": got["launches"], "rvq_kernels": got["launches"]["rvq_encode"] * rvq_kernels}
            assert got["latents"].shape == plain["latents"].shape, (got["latents"].shape, plain["latents"].shape)
            assert err <= MESH_ABS, (route, name, err)
            assert res[name]["latents_rel_err_vs_whole_batch"] <= SAMPLER_REL, (route, name, res[name])
            assert got["launches"] == want, (route, name, got["launches"], want)
        out["routes"][route] = res
    emit(out)
    return out


def mesh_diffusion(mesh=None, device=None, steps: int = MESH_STEPS) -> dict:
    """Three steps of the beat2 denoiser (its yaml with MESH_OVERRIDES: Adam
    behind the clip) at the global batch of 40, this rank's rows of each
    under ``mesh`` (its data axis); seeded weights and draws, batches from
    seeded numpy."""
    cfg, device = load_config(BEAT2_CONFIG, MESH_OVERRIDES["diffusion"]), device or DEV
    mdm = build_mdm(cfg.mdm, seed=TRAIN_SEED, device=device)
    tx, grads = first_grads(optim.make_diffusion_optimizer(cfg.train.lr, cfg.train.grad_clip))
    state = create_train_state(mdm, tx, torch.Generator(device).manual_seed(TRAIN_SEED))
    step = make_diffusion_train_step(mdm, make_diffusion(steps=cfg.diffusion.steps), tx,
                                     DiffusionTrainConfig(cfg.pre_frames, cfg.latent_scale), mesh=mesh)
    b, frames, m = MESH_BATCH["diffusion"], cfg.data.pose_length, cfg.mdm

    def batch(i):
        g = np.random.default_rng(TRAIN_SEED + i)
        return {"latent_in": g.standard_normal((b, frames // 4, m.latent_total_dim), np.float32),
                "audio": (0.1 * g.standard_normal((b, round(16000 / 30 * frames), 2))).astype(np.float32),
                "word": g.integers(0, m.vocab_size, (b, frames))}

    return {**mesh_steps(step, state, [batch(i) for i in range(steps)], mesh, device, diffusion_trainer),
            "grads": grads}



def mesh_rvq(mesh=None, device=None) -> dict:
    """Three steps of the upper RVQ-VAE of ``configs/rvq_beat2.yaml`` at the
    global batch of 256 (the lazy init first), as :func:`mesh_diffusion`."""
    cfg, device = load_config(RVQ_CONFIG, MESH_OVERRIDES["rvq"]), device or DEV
    rt, rcfg = cfg.rvq_train, rvq_config(cfg, "upper")
    tx, grads = first_grads(optim.make_rvq_optimizer(rt.lr, rt.warmup_iters, rt.milestones, rt.gamma))
    module = build_rvqvae(rcfg, seed=TRAIN_SEED, device=device)[0]
    state = create_train_state(module, tx, torch.Generator(device).manual_seed(TRAIN_SEED),
                               quantizer_state=init_rvq_state(rcfg.quantizer, device))
    step = make_rvq_train_step(module, tx, RVQLossConfig(commit_weight=rt.commit_weight), mesh=mesh)
    batches = [np.random.default_rng(TRAIN_SEED + 10 + i).standard_normal(
        (MESH_BATCH["rvq"], rt.window, rcfg.input_dim), np.float32) for i in range(MESH_STEPS)]
    out = mesh_steps(step, state, batches, mesh, device, rvq_trainer)
    out["codebook"] = state.quantizer_state.codebook.cpu()
    out["grads"] = grads
    return out


def first_grads(tx):
    """``tx`` that also keeps (on the host) the gradients it is given first,
    after the data axis's all-reduce, by parameter name."""
    first = {}

    def update(grads, opt_state, params=None):
        if not first:
            first.update({k: g.detach().float().cpu() for k, g in grads.items()})
        return tx.update(grads, opt_state, params)

    return optim.GradientTransformation(tx.init, update), first


def mesh_steps(step, state, batches, mesh, device, trainer_module) -> dict:
    """Run the steps on this rank's shards, backward included in full f32
    (TF32 convolution gradients differ by ~1e-4 between cuDNN's algorithms
    at one batch and at a shard's: 1.62e-4 on the denoiser's first gradient,
    measured on one H100; Adam turns that into parameters 2.5e-5 apart):
    losses, the final parameters, step ms (host clock around a
    synchronized step), the gradient all-reduce's ms (synchronized around
    it) and the peak memory."""
    reduce, reduce_ms = trainer_module.all_reduce_mean_, []

    def timed_reduce(tensors, axis):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(tensors, axis)
        torch.cuda.synchronize()
        reduce_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    trainer_module.all_reduce_mean_ = timed_reduce
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats(device)
    try:
        for batch in batches:
            local = rank_rows(batch, None if mesh is None else mesh.data, device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with full_f32():
                state, metrics = step(state, local)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(metrics["predict_x0_loss" if "predict_x0_loss" in metrics else "loss"]))
    finally:
        trainer_module.all_reduce_mean_ = reduce
    return {"loss": losses, "params": {k: v.detach().cpu() for k, v in state.params.items()}, "step_ms": step_ms,
            "allreduce_ms": reduce_ms, "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 2**30}


def rank_rows(batch, axis, device):
    """The rows of a global batch (a dict or one array) that the rank at
    ``axis`` trains on, on ``device``; all of them without an axis."""
    if isinstance(batch, dict):
        return {k: rows_of(torch.as_tensor(v), axis).to(device) for k, v in batch.items()}
    return rows_of(torch.as_tensor(batch), axis).to(device)


@torch.no_grad()
def tp_forward(world: int, device) -> dict:
    """The TP_CONFIG (full MDMConfig()) denoise replicated, then under
    shard_params at model=world (whole heads of q, k, v a rank; one
    all-reduce after proj and after fc2)."""
    mdm = build_mdm(TP_CONFIG, seed=0, device=device)
    g = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    x_t, seed = t(g.standard_normal((2, 32, 1536))), t(g.standard_normal((2, 4, 1536)))
    audio = t(0.1 * g.standard_normal((2, 533 * 128, 2)))
    word = torch.as_tensor(g.integers(0, TP_CONFIG.vocab_size, (2, 128)), device=device)
    steps = torch.tensor([7, 431], device=device)
    ref = mdm.denoise(x_t, steps, mdm.encode_cond(audio, word, seed))
    shard_params(mdm, make_mesh(1, world, devices=[device] * world))
    out = mdm.denoise(x_t, steps, mdm.encode_cond(audio, word, seed))
    ok = bool(torch.allclose(out, ref, atol=TP_ATOL, rtol=TP_RTOL))
    return {"max_abs_err": (out - ref).abs().max().item(), "allclose": ok, "heads_a_rank": mdm.blocks[0].num_heads}


def rank_devices(world: int) -> list:
    """Rank r's card: r modulo the cards (two gloo ranks share the one)."""
    return [torch.device("cuda", r % torch.cuda.device_count()) for r in range(world)]


def mesh_train_worker(rank: int, world: int, backend: str, tp: bool, rendezvous: str, out_dir: str) -> None:
    """One rank of a group: the two models' steps on its shards, and with
    ``tp`` the tensor-parallel forward; saves ``<out_dir>/rank<r>.pt``."""
    if world > 1:
        init_multihost(f"file://{rendezvous}", world, rank, backend=backend)
    else:  # init_multihost starts no group for one process, as JAX's; a group of one still proves the backend
        torch.distributed.init_process_group(backend, init_method=f"file://{rendezvous}", world_size=1, rank=0)
    mesh = make_mesh(world, 1, devices=rank_devices(world))
    out = {"backend": torch.distributed.get_backend(), "device": str(mesh.device),
           "diffusion": mesh_diffusion(mesh, mesh.device), "rvq": mesh_rvq(mesh, mesh.device)}
    if tp:
        out["tp"] = tp_forward(world, mesh.device)
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


def run_group(world: int, backend: str, tp: bool, d: Path) -> list:
    d.mkdir(parents=True, exist_ok=True)
    ctx = torch.multiprocessing.spawn(mesh_train_worker, args=(world, backend, tp, str(d / "rendezvous"), str(d)),
                                      nprocs=world, join=False)
    deadline = time.monotonic() + MESH_SPAWN_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise RuntimeError(f"the {backend} group of {world} did not finish in {MESH_SPAWN_S} s")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]


# a group's first gradient against one device's on the whole batch: f32 sums in another order
MESH_GRAD_REL = 1e-5
# the denoiser's wav encoder (its convolutions and BatchNorms): its f32 weight gradients sum over batch x 68,224
# samples, and cuDNN sums them in another order at 20 rows than at 40 (2e-3 apart on one convolution's, 1.5e-4
# over the whole gradient; one device against itself 7.7e-8; measured on one H100). Held on every other tensor,
# reported on these
SEQUENCE_SUMS = "wav_encoder."
# Adam steps an element by about its whole rate in the direction of its gradient's sign, so an element whose first
# gradient is within f32 noise of zero (a convolution's bias in front of a norm; an embedding row no word used; a
# gradient a reorder of the sums can flip) moves apart in one device and in a group; parameters are held where the
# one-device first gradient is above this fraction of its tensor's largest, the rest counted (as the repo's train
# tests compare Adam's parameters only where the gradient is far above its noise)
NOISE_GRAD = 1e-3


def tree_rel(got: dict, ref: dict, masks=None, names=None) -> float:
    """|got - ref| / |ref| over the named tensors (all by default)
    together, over the masked elements when ``masks`` are given."""
    num = den = 0.0
    for k in ref if names is None else names:
        d, r = got[k].float() - ref[k].float(), ref[k].float()
        if masks is not None:
            d, r = d[masks[k]], r[masks[k]]
        num, den = num + float(d.pow(2).sum()), den + float(r.pow(2).sum())
    return (num / den) ** 0.5


def phase_mesh_train() -> dict:
    """The beat2 denoiser (batch 40) and the upper RVQ-VAE (batch 256), 3
    steps each from the same seeded state and global batches: on one
    device, in an NCCL group of one rank a card, and in a gloo group of two
    ranks on the one card (CUDA tensors). Held: every rank the same bit for
    bit (parameters, EMA codebooks); rank 0's loss, first gradient and
    parameters against the one device (outside the wav encoder, see
    ``SEQUENCE_SUMS``, which is reported); the tensor-parallel forward at
    model=2 in the gloo group."""
    one = {"diffusion": mesh_diffusion(), "rvq": mesh_rvq()}
    torch.cuda.empty_cache()  # the ranks share the card: hand its cached blocks back
    out = {"phase": "mesh_train", "card": card_name_and_power_limit(),
           "parent_allocated_gb_at_spawn": torch.cuda.memory_allocated() / 2**30,
           "one_device_ms": {k: v["step_ms"] for k, v in one.items()},
           "one_device_peak_memory_gb": {k: v["peak_memory_gb"] for k, v in one.items()}, "groups": {}}
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        for backend, world, tp in MESH_GROUPS:
            world = world or torch.cuda.device_count()
            ranks = run_group(world, backend, tp, Path(tmp) / backend)
            res = {"world": world, "backend": ranks[0]["backend"], "devices": [r["device"] for r in ranks]}
            for model in ("diffusion", "rvq"):
                got, ref = ranks[0][model], one[model]
                masks = {k: g.abs() > NOISE_GRAD * g.abs().max() for k, g in ref["grads"].items()}
                held_names = [k for k in ref["grads"] if not k.startswith(SEQUENCE_SUMS)]
                summed = [k for k in ref["grads"] if k.startswith(SEQUENCE_SUMS)]
                step_ms, reduce_ms = np.mean(got["step_ms"][1:]), np.mean(got["allreduce_ms"][1:] or [0.0])
                res[model] = {"loss": got["loss"],
                              "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])),
                              "grads_rel_err": tree_rel(got["grads"], ref["grads"], names=held_names),
                              "params_rel_err": tree_rel(got["params"], ref["params"], masks, held_names),
                              "params_rel_err_all": tree_rel(got["params"], ref["params"]),
                              "params_held": sum(int(masks[k].sum()) for k in held_names),
                              "params_noise_gradient": sum(int((~masks[k]).sum()) for k in held_names),
                              "step_ms": got["step_ms"], "allreduce_ms": got["allreduce_ms"],
                              "peak_memory_gb": [r[model]["peak_memory_gb"] for r in ranks],
                              "allreduce_share": float(reduce_ms / step_ms),
                              "ranks_equal": all(torch.equal(r[model]["params"][k], v) for r in ranks[1:]
                                                 for k, v in got["params"].items())}
                r = res[model]
                if summed:
                    r["sequence_sums"] = {"grads_rel_err": tree_rel(got["grads"], ref["grads"], names=summed),
                                          "params_rel_err": tree_rel(got["params"], ref["params"], names=summed)}
                held = {"loss": r["loss_rel_err"] <= MESH_LOSS_RTOL, "ranks_equal": r["ranks_equal"],
                        "grads": r["grads_rel_err"] <= MESH_GRAD_REL, "params": r["params_rel_err"] <= MESH_PARAM_REL}
                failures += [f"{backend}{world} {model} {k}" for k, ok in held.items() if not ok]
            cb = [r["rvq"]["codebook"] for r in ranks]
            if not all(torch.equal(c, cb[0]) for c in cb[1:]):
                failures.append(f"{backend}{world} EMA codebooks differ across ranks")
            res["rvq"]["codebook_vs_one_device_max_abs"] = (cb[0] - one["rvq"]["codebook"]).abs().max().item()
            if tp:
                res["tp"] = [r["tp"] for r in ranks]
                if not all(t["allclose"] and t["heads_a_rank"] == 2 for t in res["tp"]):
                    failures.append(f"{backend}{world} tensor-parallel forward")
            out["groups"][f"{backend}{world}"] = res
    out["failures"] = failures
    emit(out)
    assert not failures, failures
    return out


def phase_mesh(diffusion=None, rvq=None) -> dict:
    """``mesh_serve`` on ``MDMConfig(use_prompt=True)`` (the unprompted
    routes read no prompt, as ``MDMConfig()``'s), then ``mesh_train``;
    returns ``mesh_serve``'s result. Alone:
    ``python -c "import chip_smoke as C; C.phase_build(); C.phase_mesh()"``."""
    if diffusion is None:
        diffusion = make_diffusion(steps=1000, timestep_respacing="ddim50")
    if rvq is None:
        rvq = {part: build_rvqvae(RVQVAEConfig(input_dim=dim), seed=10 + i, device=DEV)
               for i, (part, dim) in enumerate((("upper", 78), ("hands", 180), ("lower", 57)))}
    out = phase_mesh_serve(build_mdm(MDMConfig(use_prompt=True), seed=0, device=DEV), diffusion, rvq)
    phase_mesh_train()
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

    # first, while the card holds little else: mesh_train's two ranks of the RVQ-VAE take ~33 GB each
    mesh = phase_mesh(diffusion, rvq)
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
    loop = phase_train_loop()
    h3d_launches = phase_h3d()["test_h3d"]
    h3d_launches = {**h3d_launches["launches"], "rvq_encode": h3d_launches["rvq_kernels"]}
    demo = phase_convert_demo()
    demo_launches = {"ddim_window": demo["k1"]["launches"]["ddim_window"],
                     "block_stack": demo["launches"]["block_stack"], "rvq_encode": demo["rvq_kernels"]}
    gen["trained_loop"] = loop["generate"]
    trained_stream_launches = loop["faults"]["stream"]["launches"]
    trained_stream_launches["rvq_kernels"] = loop["faults"]["stream"]["rvq_kernels"]
    evaluate_launches = {**loop["evaluate"]["launches"], "rvq_encode": loop["evaluate"]["rvq_kernels"]}

    src = "syntalker_tpu_torch/csrc/"
    k3_row = k3[SERVE_BATCH * 116]
    rvq_kernels = quantize_cuda.rvq_kernel_launches(6)
    mesh_launches = {name: sum(route["one_card"]["launches"][name] if name != "rvq_encode" else
                               route["one_card"]["rvq_kernels"] for route in mesh["routes"].values())
                     for name in ("ddim_window", "block_stack", "rvq_encode")}
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
                               for k, v in gen.items()},
         "trained_stream_launches": trained_stream_launches[name if name != "rvq_encode" else "rvq_kernels"],
         "evaluate_launches": evaluate_launches[name], "h3d_eval_launches": h3d_launches[name],
         "convert_demo_launches": demo_launches[name], "mesh_launches": mesh_launches[name],
         "error_vs_tol": err}
        for name, source, replaces, r, launches, prompted, streamed, encoded, err in rows
    ]})
    print(card_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
