"""MDM transformer denoiser over the concatenated body-part latent (PyTorch).

Counterpart of ``syntalker_tpu/models/denoiser.py``: ``MDMConfig``, the
``WavEncoder`` conv pyramid, ``encode_cond`` (audio and word features, the
TMR text prompt with its learned null embedding, the MotionCLIP style with a
zero null, and the guidance masks of each) / ``embed_timesteps`` /
``denoise`` (with the ``input_process3`` prompt and ``input_process_style``
style concats) / ``run_blocks``, and ``apply_word_embedding``. The public
methods keep the JAX layout ``(B, T, C)``; the convolutions transpose to
NCW inside. Parameter names mirror the flax tree so that ``bridge.py`` maps
one onto the other name for name.

The WavEncoder norm is GroupNorm (``audio_norm='group'``), flax's BatchNorm
(``'batch'``, the h3d configuration: batch statistics in training mode,
running statistics in eval mode) or none (``'none'``, reference
checkpoints with BatchNorm folded into the convs). ``audio_dtype`` is the
compute dtype of the WavEncoder's convolutions (inputs, kernels and biases
rounded to it, norms in f32) and ``dtype`` that of the plain block stack
(residual stream included, softmax in f32), as in flax.

Training mode (``module.train()``) turns on the BatchNorm batch statistics
and the train-time randomness of flax's ``train=True``: the condition
dropouts (``cond_mask_prob`` swaps the prompt for the null prompt and the
style for zeros, ``cond_mask_prob_audio`` zeroes audio and words) and
per-sample drop-path at rate ``dropout`` after attention and MLP. JAX
draws these from flax's ``make_rng`` streams, which PyTorch cannot replay:
here they come as explicit masks (:class:`TrainDraws`, made by
:func:`draw_train`). ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``). The XLA layout knobs ``scan_blocks`` (read by
the bridge) and ``audio_conv_pack`` are inert; the TPU lane-fill rewrites
of the flax module (``_pair_packed_conv1d``, the fused
``conv1‖down_conv``) are exact rewrites of plain convolutions and are plain
convolutions here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from syntalker_tpu_torch.device import full_f32, resolve_device, torch_dtype


@dataclasses.dataclass(frozen=True)
class MDMConfig:
    latent_total_dim: int = 1536  # 3 body parts x 512
    latent_dim: int = 512
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    rope_heads: int = 8  # RoPE is applied over 8 sub-heads of 64
    dropout: float = 0.1  # drop-path rate, in training
    audio_feat_dim: int = 256
    word_feat_dim: int = 256
    word_embed_dim: int = 300  # fasttext
    vocab_size: int = 11195
    n_seed: int = 4  # latent seed frames carried between windows
    squeeze_scale: int = 4  # motion frames per latent frame
    cond_mask_prob: float = 0.3  # prompt and style dropout, in training
    cond_mask_prob_audio: float = 0.0  # audio/word dropout, in training
    use_prompt: bool = False  # TMR text prompt through input_process3
    prompt_dim: int = 256
    use_motionclip: bool = False  # MotionCLIP style through input_process_style
    style_dim: int = 512
    dtype: torch.dtype = torch.float32  # compute dtype of the plain block stack
    scan_blocks: bool = True  # XLA layout knob; the bridge reads either param layout
    audio_dtype: torch.dtype = torch.float32  # compute dtype of the WavEncoder's convolutions
    audio_conv_pack: bool = False  # XLA layout knob; inert here
    audio_norm: str = "group"  # WavEncoder norm: 'group', 'batch' or 'none'
    remat: bool = False  # recompute each block in the backward

    def __post_init__(self):
        # dtypes may come as names or numpy types (the JAX package's configs)
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))
        object.__setattr__(self, "audio_dtype", torch_dtype(self.audio_dtype))


@dataclasses.dataclass
class Conditioning:
    """Timestep-independent conditioning, computed once per window."""

    at_feat: torch.Tensor  # (B, T_latent, audio_feat_dim) fused audio+word features
    seed_emb: torch.Tensor  # (B, latent_dim) seed-pose embedding
    prompt_feat: Optional[torch.Tensor] = None  # (B, prompt_dim), use_prompt models
    style_feat: Optional[torch.Tensor] = None  # (B, style_dim), use_motionclip models


def _groups(c: int) -> int:
    g = min(32, c)
    while c % g:
        g //= 2
    return g


@dataclasses.dataclass
class TrainDraws:
    """The train-time masks of one forward. ``cond`` maps "audio",
    "prompt" and "style" to (B,) bool masks, True where the condition is
    dropped; a missing entry drops nothing. ``drop_path`` holds the
    (num_layers, 2, B) bool keep masks of each block's attention and MLP
    branches, or None when the rate is 0."""

    cond: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    drop_path: Optional[torch.Tensor] = None

    def to(self, device) -> "TrainDraws":
        dp = None if self.drop_path is None else self.drop_path.to(device)
        return TrainDraws({k: v.to(device) for k, v in self.cond.items()}, dp)


def draw_train(cfg: MDMConfig, batch: int, generator: torch.Generator, device=None) -> TrainDraws:
    """The masks of one train forward from ``generator``: a Bernoulli per
    sample for each condition dropout the model has (audio+word at
    ``cond_mask_prob_audio``, prompt and style at ``cond_mask_prob``), then
    the drop-path keep masks at 1 - ``dropout``."""
    def bern(p):
        return torch.rand(batch, generator=generator, device=device) < p

    cond = {}
    if cfg.cond_mask_prob_audio > 0:
        cond["audio"] = bern(cfg.cond_mask_prob_audio)
    if cfg.use_prompt and cfg.cond_mask_prob > 0:
        cond["prompt"] = bern(cfg.cond_mask_prob)
    if cfg.use_motionclip and cfg.cond_mask_prob > 0:
        cond["style"] = bern(cfg.cond_mask_prob)
    drop_path = None
    if cfg.dropout > 0:
        drop_path = torch.rand(cfg.num_layers, 2, batch, generator=generator, device=device) < 1.0 - cfg.dropout
    return TrainDraws(cond, drop_path)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NCW (momentum 0.9, eps 1e-5). In training
    mode it normalizes by the batch statistics, taken in f32 as flax takes
    them (the variance is E[x²] - E[x]², biased, clamped at 0), and moves
    the running statistics r <- 0.9·r + 0.1·batch with that biased
    variance (``torch.nn.BatchNorm1d`` would store the unbiased one). In
    eval mode it normalizes by the running statistics."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        x = x.float()
        mean = x.mean((0, 2))
        var = torch.clamp((x * x).mean((0, 2)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


def make_norm(kind: str, c: int) -> nn.Module:
    """The wav encoder's norm over c channels (NCW)."""
    if kind == "group":
        return nn.GroupNorm(_groups(c), c, eps=1e-6)
    if kind == "batch":
        return BatchNorm(c)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown audio_norm {kind!r}: 'group', 'batch' or 'none'")


class AudioBasicBlock(nn.Module):
    """Residual k=15 conv block of the wav encoder; ``norm`` as in
    :func:`make_norm`, leaky_relu 0.01. ``pad`` reproduces the 16 kHz →
    30 fps arithmetic."""

    def __init__(self, cin: int, cout: int, stride: int, pad: int, downsample: bool, norm: str = "group",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv1d(cin, cout, 15, stride=stride, padding=pad)
        self.norm1 = make_norm(norm, cout)
        self.conv2 = nn.Conv1d(cout, cout, 15, padding=7)
        self.norm2 = make_norm(norm, cout)
        if downsample:
            self.down_conv = nn.Conv1d(cin, cout, 15, stride=stride, padding=pad)
            self.down_norm = make_norm(norm, cout)
        else:
            self.down_conv = None

    def _conv(self, conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        """The convolution in ``dtype``, its bias added in ``dtype``, then f32
        for the norm (flax's order)."""
        if self.dtype == torch.float32:
            return conv(x)
        dt = self.dtype
        h = F.conv1d(x.to(dt), conv.weight.to(dt), None, conv.stride, conv.padding)
        return (h + conv.bias.to(dt)[:, None]).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCW
        h = F.leaky_relu(self.norm1(self._conv(self.conv1, x)), 0.01)
        h = self.norm2(self._conv(self.conv2, h))
        sc = x if self.down_conv is None else self.down_norm(self._conv(self.down_conv, x))
        return F.leaky_relu(h + sc, 0.01)


class WavEncoder(nn.Module):
    """Raw 16 kHz (amplitude, onset) channels -> 30 fps features.
    Stride plan 5·6·1·6·1·3 with pads 1700/0/7/0/7/0 maps 16000/30·F
    samples to exactly F frames."""

    def __init__(self, out_dim: int = 256, in_channels: int = 2, norm: str = "group",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = out_dim
        plan = [
            (d // 4, 5, 1700, True),
            (d // 4, 6, 0, True),
            (d // 4, 1, 7, False),
            (d // 2, 6, 0, True),
            (d // 2, 1, 7, False),
            (d, 3, 0, True),
        ]
        blocks, cin = [], in_channels
        for c, s, p, down in plan:
            blocks.append(AudioBasicBlock(cin, c, s, p, down, norm, dtype))
            cin = c
        self.blocks = nn.ModuleList(blocks)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if wav.ndim == 2:
            wav = wav[..., None]
        h = wav.transpose(1, 2)
        for blk in self.blocks:
            h = blk(h)
        return h.transpose(1, 2)  # (B, F, out_dim)


def sinusoidal_table(length: int, dim: int) -> torch.Tensor:
    """(length, dim) sin/cos table: sin on even columns, cos on odd ones."""
    pos = torch.arange(length, dtype=torch.float32)[:, None]
    div = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32)
        * (-torch.log(torch.tensor(10000.0)) / dim)
    )
    tab = torch.zeros(length, dim)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab


def rope_angles(n: int, dim: int) -> torch.Tensor:
    """NeoX-style rotary angles (n, dim): freqs duplicated across halves."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freqs = torch.arange(n, dtype=torch.float32)[:, None] * inv_freq[None, :]
    return torch.cat([freqs, freqs], dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate (..., n, d) by the half-split rotation."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * torch.cos(angles) + rotated * torch.sin(angles)


class TransformerBlock(nn.Module):
    """Pre-LN block: LayerNorm eps 1e-6, fused qkv without bias (rows
    [q|k|v], head-major), f32 softmax, exact erf GELU MLP. In another
    ``dtype`` than f32, weights and activations are rounded to it, LayerNorm
    takes its statistics in f32 and the softmax runs in f32, as flax does."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None, rate: float = 0.0) -> torch.Tensor:
        """``keep`` (2, B) bool: drop-path keep masks of the attention and
        MLP branches at ``rate`` (training); None keeps both."""
        dt = x.dtype

        def lin(m, h):
            return F.linear(h, m.weight.to(dt), None if m.bias is None else m.bias.to(dt))

        def norm(m, h):
            return F.layer_norm(h.float(), m.normalized_shape, m.weight, m.bias, m.eps).to(dt)

        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = lin(self.qkv, norm(self.norm1, x)).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, N, hd)
        attn = torch.softmax(((q * hd**-0.5) @ k.transpose(-1, -2)).float(), dim=-1).to(dt)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        x = x + drop_path(lin(self.proj, out), None if keep is None else keep[0], rate)
        h = lin(self.fc2, F.gelu(lin(self.fc1, norm(self.norm2, x))))
        return x + drop_path(h, None if keep is None else keep[1], rate)


def drop_path(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """Per-sample drop-path: x · keep / (1 - rate) with a (B,) keep mask;
    no mask is the identity."""
    if keep is None or rate <= 0.0:
        return x
    return x * keep.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1)) / (1.0 - rate)


class TimestepMLP(nn.Module):
    """Sinusoidal table -> SiLU MLP."""

    def __init__(self, latent_dim: int):
        super().__init__()
        self.register_buffer("table", sinusoidal_table(5000, latent_dim), persistent=False)
        self.fc1 = nn.Linear(latent_dim, latent_dim)
        self.fc2 = nn.Linear(latent_dim, latent_dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(self.table[t])))


class MDM(nn.Module):
    """x0-predicting denoiser over (B, T_latent, 1536) latents."""

    def __init__(self, cfg: MDMConfig):
        super().__init__()
        c = self.cfg = cfg
        self.wav_encoder = WavEncoder(c.audio_feat_dim, norm=c.audio_norm, dtype=c.audio_dtype)
        self.word_embedding = nn.Parameter(torch.randn(c.vocab_size, c.word_embed_dim) * 0.02)
        self.text_encoder = nn.Linear(c.word_embed_dim, c.word_feat_dim)
        self.mix_audio_text = nn.Linear(c.audio_feat_dim + c.word_feat_dim, c.audio_feat_dim)
        self.embed_seed = nn.Linear(c.n_seed * c.latent_total_dim, c.latent_dim)
        self.time_mlp = TimestepMLP(c.latent_dim)
        self.input_process = nn.Linear(c.latent_total_dim, c.latent_dim)
        self.input_process2 = nn.Linear(2 * c.latent_dim + c.audio_feat_dim, c.latent_dim)
        if c.use_prompt:
            # the null prompt is learned, not zeros
            self.uncond_prompt_embedding = nn.Parameter(torch.zeros(1, c.prompt_dim))
            self.input_process3 = nn.Linear(c.latent_dim + c.prompt_dim, c.latent_dim)
        if c.use_motionclip:
            self.input_process_style = nn.Linear(c.latent_dim + c.style_dim, c.latent_dim)
        self.blocks = nn.ModuleList(
            TransformerBlock(c.latent_dim, c.num_heads, c.ff_size) for _ in range(c.num_layers)
        )
        self.output_process = nn.Linear(c.latent_dim, c.latent_total_dim)

    def encode_cond(self, audio: torch.Tensor, word: torch.Tensor, seed: torch.Tensor, *,
                    prompt: Optional[torch.Tensor] = None, style: Optional[torch.Tensor] = None,
                    uncond_audio=False, uncond_prompt=False, uncond_style=False,
                    draws: Optional[TrainDraws] = None) -> Conditioning:
        """audio (B, S, 2) raw 16 kHz channels, word (B, F) ids, seed
        (B, n_seed, 1536), prompt (B, prompt_dim), style (B, style_dim) ->
        per-latent-frame conditioning. Each ``uncond_*`` is a bool or a (B,)
        mask that swaps the condition for its null: zero audio and word
        features, the learned null prompt (also taken when ``prompt`` is
        None), a zero style (also when ``style`` is None). In training mode
        ``draws.cond`` drops conditions to the same nulls first."""
        c = self.cfg
        drop = draws.cond if (self.training and draws is not None) else {}
        with full_f32():
            audio_feat = self.wav_encoder(audio)
        text_feat = self.text_encoder(self.word_embedding[word])
        b = audio_feat.shape[0]
        if "audio" in drop:
            keep = 1.0 - drop["audio"].float().reshape(-1, 1, 1)
            audio_feat, text_feat = audio_feat * keep, text_feat * keep
        keep_a = 1.0 - _mask(uncond_audio, audio_feat).reshape(-1, 1, 1)
        audio_feat, text_feat = audio_feat * keep_a, text_feat * keep_a
        # the conv arithmetic can overshoot the word-frame count by a frame
        # for off-spec lengths; align on the common prefix
        f_common = min(audio_feat.shape[1], text_feat.shape[1])
        at = torch.cat([audio_feat[:, :f_common], text_feat[:, :f_common]], dim=-1)
        at = self.mix_audio_text(at)
        f = at.shape[1] // c.squeeze_scale
        at = at[:, : f * c.squeeze_scale].reshape(b, f, c.squeeze_scale, -1).mean(2)
        seed_emb = self.embed_seed(seed.reshape(b, -1))

        prompt_feat = style_feat = None
        if c.use_prompt:
            null = self.uncond_prompt_embedding
            if prompt is None:
                prompt = null.expand(b, -1)
            if "prompt" in drop:
                dp = drop["prompt"].float().reshape(-1, 1)
                prompt = prompt * (1.0 - dp) + null * dp
            mask_p = _mask(uncond_prompt, at).reshape(-1, 1)
            prompt_feat = prompt * (1.0 - mask_p) + null * mask_p
        if c.use_motionclip:
            if style is None:
                style = at.new_zeros(b, c.style_dim)
            if "style" in drop:
                style = style * (1.0 - drop["style"].float().reshape(-1, 1))
            style_feat = style * (1.0 - _mask(uncond_style, at).reshape(-1, 1))
        return Conditioning(at_feat=at, seed_emb=seed_emb, prompt_feat=prompt_feat, style_feat=style_feat)

    def embed_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        """(N,) int timesteps -> (N, latent) embeddings."""
        return self.time_mlp(t)

    def prepare_sequence(self, x_t, t_emb, cond: Conditioning) -> torch.Tensor:
        """The block-stack input: input projections, seed/timestep and
        audio concat, the prompt concat (``input_process3``) and the style
        concat (``input_process_style``) where the model has them and
        ``cond`` carries them, RoPE over ``rope_heads`` sub-heads."""
        c = self.cfg
        b, n, _ = x_t.shape
        x_emb = self.input_process(x_t)
        style = (cond.seed_emb + t_emb)[:, None, :].expand(b, n, c.latent_dim)
        xseq = self.input_process2(torch.cat([style, x_emb, cond.at_feat[:, :n]], dim=-1))
        if c.use_prompt and cond.prompt_feat is not None:
            p = cond.prompt_feat[:, None, :].expand(b, n, -1)
            xseq = self.input_process3(torch.cat([xseq, p], dim=-1))
        if c.use_motionclip and cond.style_feat is not None:
            s = cond.style_feat[:, None, :].expand(b, n, -1)
            xseq = self.input_process_style(torch.cat([xseq, s], dim=-1))
        hd = c.latent_dim // c.rope_heads
        angles = rope_angles(n, hd).to(xseq.device)[:, None, :]
        return apply_rope(xseq.reshape(b, n, c.rope_heads, hd), angles).reshape(b, n, c.latent_dim)

    def run_blocks(self, xseq: torch.Tensor, *, dtype=None, draws: Optional[TrainDraws] = None) -> torch.Tensor:
        """The block stack in ``dtype`` (default ``cfg.dtype``); f32 out. In
        training mode with a drop-path rate, ``draws.drop_path`` holds each
        block's keep masks; with ``remat`` each block is recomputed in the
        backward."""
        c = self.cfg
        keep = None
        if self.training and c.dropout > 0:
            if draws is None or draws.drop_path is None:
                raise ValueError("drop-path in training mode needs its keep masks: see draw_train")
            keep = draws.drop_path
        xseq = xseq.to(c.dtype if dtype is None else dtype)
        for i, blk in enumerate(self.blocks):
            k = None if keep is None else keep[i]
            if c.remat and torch.is_grad_enabled():
                xseq = torch.utils.checkpoint.checkpoint(blk, xseq, k, c.dropout, use_reentrant=False)
            else:
                xseq = blk(xseq, k, c.dropout)
        return xseq.float()

    def denoise(self, x_t, t, cond: Conditioning, *, t_emb=None, dtype=None,
                draws: Optional[TrainDraws] = None) -> torch.Tensor:
        """x_t (B, T, 1536), t (B,) original timesteps (ignored when t_emb
        is given) -> x0 prediction (B, T, 1536); the blocks in ``dtype``
        (default ``cfg.dtype``), drop-path from ``draws`` in training."""
        if t_emb is None:
            t_emb = self.embed_timesteps(t)
        return self.output_process(self.run_blocks(self.prepare_sequence(x_t, t_emb, cond), dtype=dtype,
                                                   draws=draws))


def _mask(flag, like: torch.Tensor) -> torch.Tensor:
    """A bool or (B,) guidance mask as f32 on ``like``'s device."""
    return torch.as_tensor(flag, dtype=torch.float32, device=like.device)


def build_mdm(cfg: MDMConfig, *, seed: int, device=None) -> MDM:
    """An MDM with PyTorch's default init drawn from ``seed``, in eval mode."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        mdm = MDM(cfg)
    return mdm.to(device).eval().requires_grad_(False)


@torch.no_grad()
def apply_word_embedding(mdm: MDM, matrix) -> MDM:
    """Overwrite ``word_embedding`` with a pretrained (vocab, dim) matrix
    (the fasttext table of the reference's vocab); it stays trainable.
    Raises on a shape mismatch, so that a stale vocab fails loudly."""
    m = torch.as_tensor(np.asarray(matrix, np.float32))
    cur = mdm.word_embedding
    if tuple(m.shape) != tuple(cur.shape):
        raise ValueError(f"vocab embedding {tuple(m.shape)} != model word_embedding {tuple(cur.shape)}; "
                         f"build the MDM with vocab_size={m.shape[0]}, word_embed_dim={m.shape[1]}")
    cur.copy_(m)
    return mdm


def migrate_qkv_kernels(tree, num_heads: int):
    """Legacy flat qkv kernels -> the head-aligned layout, as in JAX.

    Checkpoints written before the head-aligned layout hold the fused
    attention kernel flat, ``(C, 3C)`` unrolled or ``(L, C, 3C)``
    scan-stacked; the head-aligned ``(..., C, 3, H, C // H)`` is the same
    memory in C order, so this is a reshape. Trees already migrated pass
    through unchanged. Works on nested dicts of numpy arrays."""

    def walk(node):
        out = {}
        for k, v in node.items():
            if k == "qkv" and isinstance(v, dict) and "kernel" in v:
                kern = np.asarray(v["kernel"])
                if kern.ndim in (2, 3) and kern.shape[-1] == 3 * kern.shape[-2]:
                    c = kern.shape[-2]
                    v = dict(v, kernel=kern.reshape(kern.shape[:-1] + (3, num_heads, c // num_heads)))
            out[k] = walk(v) if isinstance(v, dict) else v
        return out

    return walk(tree)
