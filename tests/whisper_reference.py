"""Whisper's forward pass in plain float32 PyTorch, the reference that the
port's ``models/whisper.py`` is held against (arXiv:2212.04356; openai/whisper
``model.py`` and ``audio.py``). It imports nothing of the program.

One request at a time, no cache and no batching, over a dict of weights
under Hugging Face's names (``model.encoder.layers.0.self_attn.q_proj.weight``,
...) and a configuration dict under ``config.json``'s names (``d_model``,
``encoder_layers``, ``decoder_attention_heads``, ``eos_token_id``, ...;
``en_token_id``, ``transcribe_token_id`` and ``no_timestamps_token_id`` for
the prompt):

- :func:`log_mel`: pad or trim to 30 s, a periodic Hann STFT (n_fft 400, hop
  160, centred, reflect padding), |.|² without the last frame, Slaney mel
  filters (:func:`mel_filters`), log10 clamped at 1e-10, floored 8 below the
  maximum, ``(x + 4) / 4``;
- :func:`encode`: two GELU convolutions (the second at stride 2), the
  ``[sin | cos]`` position table, pre-LN blocks, a final LayerNorm;
- :func:`decode_logits`: the decoder teacher-forced on a whole token
  sequence (causal self-attention, cross-attention over the encoder output,
  the MLP), logits against the tied token embedding;
- :func:`greedy`: greedy decoding by a full forward pass at every step.

``rnd`` rounds the operands of the linear layers and convolutions (a
control one precision below the program); the attention's score and value
products stay float32. Callers turn TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32`` False).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SR, N_FFT, HOP, N_SAMPLES = 16000, 400, 160, 480000
EPS = 1e-5


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def mel_filters(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-scale, Slaney-normalized triangles (n_mels, 1 + n_fft // 2)."""

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / np.log(6.4) * 27.0,
                        f / 66.6666666666667)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0), m * 66.6666666666667)

    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    ramps = pts[:, None] - freqs[None, :]
    fdiff = np.diff(pts)
    lower = -ramps[:n_mels] / fdiff[:n_mels, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (pts[2:] - pts[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(audio, n_mels: int, device=None) -> torch.Tensor:
    """One 16 kHz waveform -> (n_mels, 3000)."""
    y = np.zeros(N_SAMPLES, np.float32)
    a = np.asarray(audio, np.float32)[:N_SAMPLES]
    y[: len(a)] = a
    x = torch.as_tensor(y, device=device)
    stft = torch.stft(x, N_FFT, HOP, window=torch.hann_window(N_FFT, device=device), center=True,
                      pad_mode="reflect", return_complex=True)
    power = stft[:, :-1].abs() ** 2
    filters = torch.as_tensor(mel_filters(SR, N_FFT, n_mels), device=device)
    mel = torch.clamp(filters @ power, min=1e-10).log10()
    mel = torch.maximum(mel, mel.max() - 8.0)
    return (mel + 4.0) / 4.0


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000.0) / (channels // 2 - 1)
    t = torch.arange(length, dtype=torch.float32)[:, None] * torch.exp(
        -inc * torch.arange(channels // 2, dtype=torch.float32))[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def linear(x, w, b=None, rnd=exact):
    y = rnd(x) @ rnd(w).t()
    return y if b is None else y + b


def layer_norm(W, name, x):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"], W[name + ".bias"], EPS)


def attention(W, name, x, kv, heads: int, causal: bool, rnd=exact):
    """Multi-head attention of x (T, D) over kv (S, D)."""
    q = linear(x, W[name + ".q_proj.weight"], W[name + ".q_proj.bias"], rnd)
    k = linear(kv, W[name + ".k_proj.weight"], None, rnd)
    v = linear(kv, W[name + ".v_proj.weight"], W[name + ".v_proj.bias"], rnd)
    t, s, dh = x.shape[0], kv.shape[0], q.shape[1] // heads
    q, k, v = (z.view(-1, heads, dh).transpose(0, 1) for z in (q, k, v))
    scores = (q @ k.transpose(1, 2)) * dh ** -0.5
    if causal:
        scores = scores.masked_fill(torch.ones(t, s, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
    o = torch.softmax(scores, -1) @ v
    return linear(o.transpose(0, 1).reshape(t, -1), W[name + ".out_proj.weight"], W[name + ".out_proj.bias"], rnd)


def mlp(W, name, x, rnd=exact):
    h = F.gelu(linear(x, W[name + ".fc1.weight"], W[name + ".fc1.bias"], rnd))
    return linear(h, W[name + ".fc2.weight"], W[name + ".fc2.bias"], rnd)


def conv(W, name, x, stride, rnd=exact):
    return F.conv1d(rnd(x), rnd(W[name + ".weight"]), W[name + ".bias"], stride=stride, padding=1)


def encode(W, cfg: dict, mel: torch.Tensor, rnd=exact) -> torch.Tensor:
    """(n_mels, 3000) -> (1500, D)."""
    p = "model.encoder."
    x = F.gelu(conv(W, p + "conv1", mel[None], 1, rnd))
    x = F.gelu(conv(W, p + "conv2", x, 2, rnd))[0].t()
    x = x + sinusoids(x.shape[0], x.shape[1]).to(x.device)
    for i in range(cfg["encoder_layers"]):
        q = f"{p}layers.{i}."
        h = layer_norm(W, q + "self_attn_layer_norm", x)
        x = x + attention(W, q + "self_attn", h, h, cfg["encoder_attention_heads"], False, rnd)
        x = x + mlp(W, q[:-1], layer_norm(W, q + "final_layer_norm", x), rnd)
    return layer_norm(W, p + "layer_norm", x)


def prompt(cfg: dict) -> list:
    return [cfg["decoder_start_token_id"], cfg["en_token_id"], cfg["transcribe_token_id"],
            cfg["no_timestamps_token_id"]]


def decode_logits(W, cfg: dict, tokens, enc: torch.Tensor, rnd=exact) -> torch.Tensor:
    """Token ids (T,) teacher-forced over the encoder output (S, D) -> logits
    (T, V) of the token after each."""
    p = "model.decoder."
    ids = torch.as_tensor(list(tokens), dtype=torch.long, device=enc.device)
    x = W[p + "embed_tokens.weight"][ids] + W[p + "embed_positions.weight"][: len(ids)]
    heads = cfg["decoder_attention_heads"]
    for i in range(cfg["decoder_layers"]):
        q = f"{p}layers.{i}."
        h = layer_norm(W, q + "self_attn_layer_norm", x)
        x = x + attention(W, q + "self_attn", h, h, heads, True, rnd)
        x = x + attention(W, q + "encoder_attn", layer_norm(W, q + "encoder_attn_layer_norm", x), enc, heads, False,
                          rnd)
        x = x + mlp(W, q[:-1], layer_norm(W, q + "final_layer_norm", x), rnd)
    return linear(layer_norm(W, p + "layer_norm", x), W[p + "embed_tokens.weight"], None, rnd)


def greedy(W, cfg: dict, enc: torch.Tensor, cap: int) -> list:
    """Greedy token ids after the prompt, ``<|endoftext|>`` not kept, at most ``cap``."""
    seq = prompt(cfg)
    out = []
    while len(out) < cap:
        t = int(decode_logits(W, cfg, seq, enc)[-1].argmax())
        if t == cfg["eos_token_id"]:
            break
        out.append(t)
        seq.append(t)
    return out
