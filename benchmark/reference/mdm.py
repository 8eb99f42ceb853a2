"""The MDM denoiser over a weight dict, plain PyTorch.

Weights are named as the benchmark makes them (``wav_encoder.blocks.0.conv1
.weight``, ``blocks.3.qkv.weight``, ...), each (out, in[, k]). ``cfg`` is the
configuration file's ``mdm`` section. ``rnd`` rounds the operands of the
denoiser's products (a control); the wav encoder, the word path and the
attention's score and value products stay float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from benchmark.reference.precision import exact

# the wav encoder's stride plan: (channels as a share of the output, stride, padding, a shortcut conv)
WAV_PLAN = ((4, 5, 1700, True), (4, 6, 0, True), (4, 1, 7, False), (2, 6, 0, True), (2, 1, 7, False),
            (1, 3, 0, True))


def linear(x, w, b=None, rnd=exact):
    y = rnd(x) @ rnd(w).t()
    return y if b is None else y + b


def _groups(c: int) -> int:
    g = min(32, c)
    while c % g:
        g //= 2
    return g


def _norm(W, name, x, kind):
    if kind == "group":
        return F.group_norm(x, _groups(x.shape[1]), W[name + ".weight"], W[name + ".bias"], 1e-6)
    if kind == "batch":  # running statistics: the model is served in eval mode
        inv = torch.rsqrt(W[name + ".running_var"] + 1e-5) * W[name + ".weight"]
        return (x - W[name + ".running_mean"][:, None]) * inv[:, None] + W[name + ".bias"][:, None]
    return x


def _conv(W, name, x, stride, pad):
    return F.conv1d(x, W[name + ".weight"], W[name + ".bias"], stride=stride, padding=pad)


def wav_encoder(W, cfg, audio):
    """(B, S, 2) raw 16 kHz channels -> (B, F, audio_feat_dim) at 30 fps."""
    h, kind, d = audio.transpose(1, 2), cfg["audio_norm"], cfg["audio_feat_dim"]
    for i, (share, stride, pad, down) in enumerate(WAV_PLAN):
        p = f"wav_encoder.blocks.{i}."
        y = F.leaky_relu(_norm(W, p + "norm1", _conv(W, p + "conv1", h, stride, pad), kind), 0.01)
        y = _norm(W, p + "norm2", _conv(W, p + "conv2", y, 1, 7), kind)
        sc = _norm(W, p + "down_norm", _conv(W, p + "down_conv", h, stride, pad), kind) if down else h
        h = F.leaky_relu(y + sc, 0.01)
    assert h.shape[1] == d
    return h.transpose(1, 2)


@dataclasses.dataclass
class Cond:
    at: torch.Tensor  # (B, T_latent, A) audio+word features
    seed_emb: torch.Tensor  # (B, D)
    prompt: Optional[torch.Tensor] = None  # (B, prompt_dim) where the prompt concat runs


def encode(W, cfg, audio, word, *, null_audio: bool = False) -> torch.Tensor:
    """Audio (B, S, 2) and frame word ids (B, F) -> (B, F/4, A): the wav
    features beside the embedded words, mixed, mean-pooled 4:1. The null
    audio condition zeroes both feature streams before the mix."""
    af = wav_encoder(W, cfg, audio)
    tf = linear(W["word_embedding"][word], W["text_encoder.weight"], W["text_encoder.bias"])
    if null_audio:
        af, tf = torch.zeros_like(af), torch.zeros_like(tf)
    f = min(af.shape[1], tf.shape[1])
    at = linear(torch.cat([af[:, :f], tf[:, :f]], -1), W["mix_audio_text.weight"], W["mix_audio_text.bias"])
    n = f // 4
    return at[:, : n * 4].reshape(at.shape[0], n, 4, -1).mean(2)


def seed_embedding(W, seed):
    return linear(seed.reshape(seed.shape[0], -1), W["embed_seed.weight"], W["embed_seed.bias"])


def timestep_embedding(W, cfg, t: torch.Tensor) -> torch.Tensor:
    """(N,) original timesteps -> (N, D): sinusoidal (sin on even columns),
    then a SiLU MLP."""
    d = cfg["latent_dim"]
    freq = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=t.device) * (-math.log(10000.0) / d))
    ang = t.double()[:, None] * freq
    tab = torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(len(t), d).float()
    h = F.silu(linear(tab, W["time_mlp.fc1.weight"], W["time_mlp.fc1.bias"]))
    return linear(h, W["time_mlp.fc2.weight"], W["time_mlp.fc2.bias"])


def rope(x, sub_heads: int):
    """NeoX rotary embedding over ``sub_heads`` slices of the width."""
    b, n, d = x.shape
    hd = d // sub_heads
    inv = 1.0 / (10000 ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    ang = torch.cat([ang, ang], -1).float()[:, None, :]
    h = x.reshape(b, n, sub_heads, hd)
    rot = torch.cat([-h[..., hd // 2 :], h[..., : hd // 2]], -1)
    return (h * torch.cos(ang) + rot * torch.sin(ang)).reshape(b, n, d)


def _layer_norm(W, name, x):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"], W[name + ".bias"], 1e-6)


def block(W, i, x, heads, rnd=exact):
    p = f"blocks.{i}."
    b, n, d = x.shape
    hd = d // heads
    qkv = linear(_layer_norm(W, p + "norm1", x), W[p + "qkv.weight"], rnd=rnd).reshape(b, n, 3, heads, hd)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    att = torch.softmax((q * hd ** -0.5) @ k.transpose(-1, -2), -1)
    out = (att @ v).transpose(1, 2).reshape(b, n, d)
    x = x + linear(out, W[p + "proj.weight"], W[p + "proj.bias"], rnd)
    h = F.gelu(linear(_layer_norm(W, p + "norm2", x), W[p + "fc1.weight"], W[p + "fc1.bias"], rnd))
    return x + linear(h, W[p + "fc2.weight"], W[p + "fc2.bias"], rnd)


def denoise(W, cfg, x, t_emb, cond: Cond, rnd=exact):
    """x_t (B, T, C), timestep embeddings (B, D) -> the x0 prediction."""
    b, n, _ = x.shape
    style = (cond.seed_emb + t_emb)[:, None, :].expand(b, n, -1)
    x_emb = linear(x, W["input_process.weight"], W["input_process.bias"], rnd)
    h = linear(torch.cat([style, x_emb, cond.at[:, :n]], -1), W["input_process2.weight"], W["input_process2.bias"],
               rnd)
    if cond.prompt is not None:
        h = linear(torch.cat([h, cond.prompt[:, None, :].expand(b, n, -1)], -1), W["input_process3.weight"],
                   W["input_process3.bias"], rnd)
    h = rope(h, cfg["rope_heads"])
    for i in range(cfg["num_layers"]):
        h = block(W, i, h, cfg["num_heads"], rnd)
    return linear(h, W["output_process.weight"], W["output_process.bias"], rnd)
