"""Operations and bytes of the transcription stage (Whisper), from shapes:
the bounds of the encoder and of a decode step, and the model FLOPs of a
transcription. ``a`` is a configuration file's ``asr`` section (Hugging
Face's ``config.json`` names). Products count 2 FLOP a multiply-add, all
on the tensor cores in bf16 (the attention's too: the program runs it in
bf16); bytes count each input read once and each output written once, the
weights at the model's bf16. Peaks and ``bound_s`` are
:mod:`benchmark.roofline`'s.
"""

from __future__ import annotations

from benchmark.roofline import bound_s

BF16 = 2  # bytes
MEL_FRAMES = 3000


def encoder_params(a: dict) -> int:
    """The encoder's product weights: the two convolutions and each block's
    q, k, v, out and MLP (norms, biases and the position table left out)."""
    d, f = a["d_model"], a["encoder_ffn_dim"]
    return a["num_mel_bins"] * d * 3 + d * d * 3 + a["encoder_layers"] * (4 * d * d + 2 * d * f)


def step_params(a: dict) -> int:
    """The decoder's product weights one token reads: per block the
    self-attention's q, k, v, out, the cross-attention's q and out (its keys
    and values are computed once a call), the MLP; and the tied head."""
    d, f = a["d_model"], a["decoder_ffn_dim"]
    return a["decoder_layers"] * (6 * d * d + 2 * d * f) + a["vocab_size"] * d


def encoder_flops(a: dict, rows: int) -> float:
    """The encoder over ``rows`` 30 s windows (1,500 positions each)."""
    d, f, t = a["d_model"], a["encoder_ffn_dim"], a["max_source_positions"]
    conv = 2.0 * (MEL_FRAMES * a["num_mel_bins"] * 3 * d + t * d * 3 * d)
    block = 2.0 * t * (4 * d * d + 2 * d * f) + 4.0 * t * t * d
    return rows * (conv + a["encoder_layers"] * block)


def cross_kv_flops(a: dict, rows: int) -> float:
    d = a["d_model"]
    return rows * 2.0 * a["max_source_positions"] * 2 * d * d * a["decoder_layers"]


def token_flops(a: dict, ctx: int) -> float:
    """One token through the decoder at self-attention context ``ctx``: the
    products with :func:`step_params`, and attention over ``ctx`` own and
    1,500 encoder positions in every block."""
    d = a["d_model"]
    return 2.0 * step_params(a) + 4.0 * d * (ctx + a["max_source_positions"]) * a["decoder_layers"]


def encoder_bound_s(a: dict, rows: int) -> float:
    """The encoder at ``rows`` windows: the weights and the f32 log-mel read,
    the bf16 output written, against its FLOPs."""
    io = rows * (4 * a["num_mel_bins"] * MEL_FRAMES + BF16 * a["max_source_positions"] * a["d_model"])
    return bound_s(BF16 * encoder_params(a) + io, encoder_flops(a, rows))


def step_bytes(a: dict, rows: int, ctx: int) -> float:
    """One decode step of ``rows`` rows: the weights it reads once, every
    layer's cross-attention keys and values, and the self-attention cache
    up to ``ctx``."""
    kv = 2 * a["decoder_layers"] * a["d_model"] * BF16
    return BF16 * step_params(a) + rows * kv * (a["max_source_positions"] + ctx)


def step_bound_s(a: dict, rows: int, ctx: int) -> float:
    return bound_s(step_bytes(a, rows, ctx), rows * token_flops(a, ctx))


def transcription_flops(a: dict, rows: int, tokens: int, prompt: int = 4) -> float:
    """Model FLOPs of transcribing ``rows`` requests that keep ``tokens``
    tokens in all: the encoder, the cross-attention keys and values, the
    prompt and every kept token (at the mean context)."""
    ctx = prompt + tokens / max(rows, 1) / 2
    return (encoder_flops(a, rows) + cross_kv_flops(a, rows) + rows * prompt * token_flops(a, prompt)
            + tokens * token_flops(a, ctx))
