"""Operations and bytes of the path's work, from shapes, and the H100's peaks.

The bound of a piece of work is the larger of its operations over the peak
of their type (bf16 products on the tensor cores, float32 elsewhere) and
its bytes over HBM bandwidth, counting each input read once and each output
written once. The kernel-level counts follow ``chip_smoke.py``
(``block_flops``, ``window_flops``, ``bound_ms``); the model FLOPs of a
window add the conditioning encode and the decode.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BF16 = 989e12  # FLOP/s, tensor cores
PEAK_FP32 = 67e12  # FLOP/s, CUDA cores
PEAK_TF32 = 495e12  # FLOP/s, tensor cores
PEAK_BYTES = 3.35e12  # bytes/s, HBM3
WAV_PLAN = ((4, 5, 1700, True), (4, 6, 0, True), (4, 1, 7, False), (2, 6, 0, True), (2, 1, 7, False),
            (1, 3, 0, True))  # channels as a share of the output, stride, padding, a shortcut conv


def bound_s(bytes_moved: float, bf16_flop: float = 0.0, fp32_flop: float = 0.0) -> float:
    return max(bytes_moved / PEAK_BYTES, bf16_flop / PEAK_BF16 + fp32_flop / PEAK_FP32)


def block_flops(m: dict, b: int, t: int):
    """(bf16 product FLOP, f32 attention FLOP) of one pass of the block stack."""
    d, f, rows = m["latent_dim"], m["ff_size"], b * t
    mm = 2 * rows * (d * 3 * d + d * d + 2 * d * f) * m["num_layers"]
    attn = 2 * 2 * b * t * t * d * m["num_layers"]
    return mm, attn


def block_weight_bytes(m: dict, weight_bytes: int = 2) -> int:
    """The stack's product weights at ``weight_bytes`` each, and its f32
    LayerNorm parameters and biases."""
    d, f, n = m["latent_dim"], m["ff_size"], m["num_layers"]
    return n * (weight_bytes * (4 * d * d + 2 * d * f) + 4 * (4 * d + d + f + d))


def k2_bound_s(m: dict, b: int, t: int) -> float:
    """One pass of the block stack at (B, T): the f32 activations read and
    written, the weights read."""
    mm, attn = block_flops(m, b, t)
    return bound_s(2 * 4 * b * t * m["latent_dim"] + block_weight_bytes(m), mm, attn)


def window_flops(m: dict, b: int, t: int, steps: int):
    """(bf16, f32) FLOP of K1's window: per step input_process, the x slab
    and style row of input_process2, the blocks and output_process; once
    per window the audio/word slab."""
    d, c, a = m["latent_dim"], m["latent_total_dim"], m["audio_feat_dim"]
    rows = b * t
    mm, attn = block_flops(m, b, t)
    per_step = mm + 2 * rows * (c * d + d * d + d * c) + 2 * b * d * d
    return steps * per_step + 2 * rows * a * d, steps * attn


def k1_bound_s(m: dict, b: int, t: int, steps: int) -> float:
    """K1's window: the noise, features and seed rows read, the latents
    written, every weight read once."""
    d, c, a = m["latent_dim"], m["latent_total_dim"], m["audio_feat_dim"]
    weights = block_weight_bytes(m) + 2 * (c * d + 2 * d * d + a * d + d * c) + 4 * (2 * d + c)
    io = 4 * b * t * (2 * c + a) + 4 * (b + steps) * d
    bf, f32 = window_flops(m, b, t, steps)
    return bound_s(weights + io, bf, f32)


def k3_bound_s(rows: int, q: int, k: int, d: int) -> float:
    """The residual snap of ``rows`` rows through Q codebooks of K x D in
    float32 FMAs: the rows and codebooks read, the snapped rows and the
    indices written."""
    return bound_s(4 * (2 * rows * d + q * k * d) + 4 * rows * q, 0.0, 2.0 * rows * q * k * d)


def conv_flops(cin: int, cout: int, k: int, lout: int, b: int = 1) -> float:
    return 2.0 * b * cout * cin * k * lout


def encode_flops(m: dict, b: int, samples: int, frames: int) -> float:
    """The conditioning encode of ``b`` clips: the wav encoder's convolutions
    over ``samples``, the word path and the mix over ``frames``."""
    d, total, cin, length = m["audio_feat_dim"], 0.0, 2, samples
    for share, stride, pad, down in WAV_PLAN:
        c = d // share
        lout = (length + 2 * pad - 15) // stride + 1
        total += conv_flops(cin, c, 15, lout, b) * (2 if down else 1) + conv_flops(c, c, 15, lout, b)
        cin, length = c, lout
    w = m["word_feat_dim"]
    return total + 2.0 * b * frames * (m["word_embed_dim"] * w + (d + w) * d)


def rvq_encoder_flops(r: dict, dim: int, b: int, t: int) -> float:
    """An RVQ-VAE encoder's convolutions over ``b`` windows of ``t`` frames:
    the stem, per level the strided conv and the residual stack, the head."""
    w, length = r["width"], t
    total = conv_flops(dim, w, 3, length, b)
    for _ in range(r["down_t"]):
        length //= r["stride_t"]
        total += conv_flops(w, w, 2 * r["stride_t"], length, b)
        total += r["depth"] * (conv_flops(w, w, 3, length, b) + conv_flops(w, w, 1, length, b))
    return total + conv_flops(w, r["code_dim"], 3, length, b)


def decode_flops(r: dict, parts: dict, b: int, t_lat: int) -> float:
    """The snap and the decoder of every part for ``b`` clips of ``t_lat``
    latent frames."""
    w, total = r["width"], 0.0
    for dim in parts.values():
        total += 2.0 * b * t_lat * r["num_quantizers"] * r["nb_code"] * r["code_dim"]
        length = t_lat
        total += conv_flops(r["code_dim"], w, 3, length, b)
        for _ in range(r["down_t"]):
            total += r["depth"] * (conv_flops(w, w, 3, length, b) + conv_flops(w, w, 1, length, b))
            length *= r["stride_t"]
            total += conv_flops(w, w, 3, length, b)
        total += conv_flops(w, w, 3, length, b) + conv_flops(w, dim, 3, length, b)
    return total


def denoise_flops(m: dict, b: int, t: int, prompt: bool) -> float:
    """One denoiser pass outside K1 (the projections and the stack)."""
    d, c, a, p = m["latent_dim"], m["latent_total_dim"], m["audio_feat_dim"], m["prompt_dim"]
    mm, attn = block_flops(m, b, t)
    proj = 2 * b * t * (c * d + (2 * d + a) * d + d * c + ((d + p) * d if prompt else 0))
    return mm + attn + proj
