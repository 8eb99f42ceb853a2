"""Whisper (arXiv:2212.04356): speech in, words out, for requests that come
without a transcript.

The port's own module, with no JAX counterpart and no ``transformers``:
built from the published equations (openai/whisper ``model.py`` and
``audio.py``), parameters named as Hugging Face's
``WhisperForConditionalGeneration`` names them, so that a snapshot's
``model.safetensors`` loads by name (:func:`load_snapshot`).

- :func:`log_mel`: each request padded or trimmed to 30 s, ``torch.stft``
  (n_fft 400, hop 160, periodic Hann, centred with reflect padding), |.|²
  without the last frame (3,000 frames), Slaney mel filters
  (:func:`~syntalker_tpu_torch.data.audio.mel_filterbank`), log10 clamped at
  1e-10, floored 8 below the request's own maximum, then ``(x + 4) / 4``;
  float32 on the model's device.
- :class:`Whisper`: the encoder (two GELU convolutions, the second at stride
  2, a fixed ``[sin | cos]`` position table, pre-LN blocks, a final
  LayerNorm) and the decoder (token embedding and a learned position table,
  pre-LN blocks of causal self-attention, cross-attention over the encoder
  output and the MLP, a final LayerNorm, logits against the tied token
  embedding in float32). Attention: q, v and out carry a bias, k none;
  scale ``head_dim ** -0.5``; GELU is the exact erf.
- :class:`WhisperASR`: greedy transcription of a batch with a static cache.
  The prompt ``<|startoftranscript|><|en|><|transcribe|><|notimestamps|>``
  runs as one prefill; each step then feeds the last token at a position
  held on the device (``DecodeState.pos``), writes its keys and values into
  the preallocated self-attention cache and attends over the whole cache
  under a mask, so every step has the same shapes. Cross-attention keys and
  values are computed once a call. A row stops at ``<|endoftext|>`` or at
  its cap of new tokens; finished rows feed ``<|endoftext|>`` until every
  row is done. Rows are padded to ``rows``; the cache's length is the
  prompt and the longest cap rounded up to a multiple of 64
  (:func:`context_bucket`). On the card each step replays one CUDA graph
  of the whole step (a :class:`_DecodePlan`), recorded once per (rows,
  cache length) over that shape's static buffers; the CPU runs the step
  eagerly.

Departures from openai's ``decode``: no suppression lists (blank, symbols,
timestamps), no temperature fallback, no timestamp rules and no
compression or log-probability thresholds; one 30 s window a request. None
changes the work a step does. Without a tokenizer each token id stands as
one word (``str(id)``); with one (:class:`ByteLevelDecoder`, a snapshot's
``vocab.json``) the byte-level BPE text is split on white space.

With the tracer of :mod:`~syntalker_tpu_torch.utils.tracking` on,
:meth:`WhisperASR.transcribe` records the spans ``asr.mel``,
``asr.encode``, ``asr.cross_kv``, ``asr.prefill`` and ``asr.decode``
(attributes steps, rows, real, tokens_real, and path: ``graph`` or
``eager``) and counts ``asr.rows``, ``asr.rows_real``, ``asr.tokens`` (rows
x generated positions, the prefill's included), ``asr.tokens_real`` (tokens
kept) and ``asr.decode_steps``; on the card also ``asr.graph_steps`` (each
step that replays its graph) and ``asr.graph_captures`` (each graph
recorded).
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from syntalker_tpu_torch.device import full_f32
from syntalker_tpu_torch.utils import tracking

SAMPLE_RATE, N_FFT, HOP, CHUNK_S = 16000, 400, 160, 30
N_SAMPLES = SAMPLE_RATE * CHUNK_S  # 480,000: one window
LN_EPS = 1e-5
CTX_BUCKET = 64  # the self-attention cache's length is a multiple of this


def context_bucket(n: int, limit: int) -> int:
    """The cache length for ``n`` positions: ``n`` rounded up to a multiple
    of :data:`CTX_BUCKET`, at most ``limit`` (``max_target_positions``), so
    that calls whose longest caps differ a little share one decode graph
    (it pays where the longest cap of a batch varies from call to call).
    The slots past the last position stay masked: they cost masked
    attention columns in every step."""
    return min(-(-n // CTX_BUCKET) * CTX_BUCKET, limit)


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Widths and special tokens under Hugging Face's ``config.json`` names
    (the language, task and no-timestamps ids come from its
    ``generation_config.json``). The defaults are large-v3's."""

    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 32
    encoder_attention_heads: int = 20
    decoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    decoder_ffn_dim: int = 5120
    num_mel_bins: int = 128
    max_source_positions: int = 1500
    max_target_positions: int = 448
    vocab_size: int = 51866
    eos_token_id: int = 50257  # <|endoftext|>
    decoder_start_token_id: int = 50258  # <|startoftranscript|>
    en_token_id: int = 50259  # <|en|>
    transcribe_token_id: int = 50360  # <|transcribe|>
    no_timestamps_token_id: int = 50364  # <|notimestamps|>

    @classmethod
    def large_v3(cls) -> "WhisperConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "WhisperConfig":
        """A CPU test size: every mechanism, small widths, a 96-token vocabulary."""
        return cls(d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
                   decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=16,
                   max_target_positions=64, vocab_size=96, eos_token_id=90, decoder_start_token_id=91,
                   en_token_id=92, transcribe_token_id=93, no_timestamps_token_id=94)

    @classmethod
    def from_hf(cls, config: dict, generation: Optional[dict] = None) -> "WhisperConfig":
        """From a snapshot's ``config.json`` and ``generation_config.json``."""
        keys = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in config.items() if k in keys}
        g = generation or {}
        if "lang_to_id" in g:
            kw["en_token_id"] = g["lang_to_id"]["<|en|>"]
        if "task_to_id" in g:
            kw["transcribe_token_id"] = g["task_to_id"]["transcribe"]
        if "no_timestamps_token_id" in g:
            kw["no_timestamps_token_id"] = g["no_timestamps_token_id"]
        return cls(**kw)

    @property
    def prompt(self) -> tuple:
        return (self.decoder_start_token_id, self.en_token_id, self.transcribe_token_id, self.no_timestamps_token_id)


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> torch.Tensor:
    """The encoder's fixed position table (length, channels): ``[sin | cos]``
    halves at log-spaced timescales."""
    inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float32))
    t = torch.arange(length, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def log_mel(audio: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """(B, N_SAMPLES) float32 waveforms at 16 kHz -> (B, n_mels, 3000) log-mel,
    each row floored 8 below its own maximum. ``filters`` (n_mels, 201)."""
    with full_f32():
        window = torch.hann_window(N_FFT, device=audio.device)
        stft = torch.stft(audio, N_FFT, HOP, window=window, return_complex=True)
        power = stft[..., :-1].abs() ** 2
        mel = torch.clamp(filters @ power, min=1e-10).log10()
        mel = torch.maximum(mel, mel.amax(dim=(1, 2), keepdim=True) - 8.0)
        return (mel + 4.0) / 4.0


class Attention(nn.Module):
    def __init__(self, d: int, heads: int, **fk):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(d, d, **fk)
        self.k_proj = nn.Linear(d, d, bias=False, **fk)
        self.v_proj = nn.Linear(d, d, **fk)
        self.out_proj = nn.Linear(d, d, **fk)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, H, T, D / H)."""
        b, t, _ = x.shape
        return x.view(b, t, self.heads, -1).transpose(1, 2)

    def merge(self, x: torch.Tensor) -> torch.Tensor:
        b, _, t, _ = x.shape
        return self.out_proj(x.transpose(1, 2).reshape(b, t, -1))

    def kv(self, x: torch.Tensor):
        return self.split(self.k_proj(x)), self.split(self.v_proj(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Unmasked self-attention (the encoder's)."""
        k, v = self.kv(x)
        return self.merge(F.scaled_dot_product_attention(self.split(self.q_proj(x)), k, v))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, **fk):
        super().__init__()
        d = cfg.d_model
        self.self_attn = Attention(d, cfg.encoder_attention_heads, **fk)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=LN_EPS, **fk)
        self.fc1 = nn.Linear(d, cfg.encoder_ffn_dim, **fk)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, d, **fk)
        self.final_layer_norm = nn.LayerNorm(d, eps=LN_EPS, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, **fk):
        super().__init__()
        d = cfg.d_model
        self.self_attn = Attention(d, cfg.decoder_attention_heads, **fk)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=LN_EPS, **fk)
        self.encoder_attn = Attention(d, cfg.decoder_attention_heads, **fk)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=LN_EPS, **fk)
        self.fc1 = nn.Linear(d, cfg.decoder_ffn_dim, **fk)
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, d, **fk)
        self.final_layer_norm = nn.LayerNorm(d, eps=LN_EPS, **fk)

    def forward(self, x, cache_k, cache_v, cross, pos, mask=None):
        """``x`` (B, T, D) at cache slots ``pos`` (T,): its keys and values
        are written there, then it attends over the cache under ``mask``
        (causal over the first T slots where None)."""
        a = self.self_attn
        h = self.self_attn_layer_norm(x)
        k, v = a.kv(h)
        cache_k.index_copy_(2, pos, k)
        cache_v.index_copy_(2, pos, v)
        q = a.split(a.q_proj(h))
        if mask is None:  # the prefill: slots [0, T)
            t = x.shape[1]
            o = F.scaled_dot_product_attention(q, cache_k[:, :, :t], cache_v[:, :, :t], is_causal=True)
        else:
            o = F.scaled_dot_product_attention(q, cache_k, cache_v, attn_mask=mask)
        x = x + a.merge(o)
        c = self.encoder_attn
        q = c.split(c.q_proj(self.encoder_attn_layer_norm(x)))
        x = x + c.merge(F.scaled_dot_product_attention(q, *cross))
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class Encoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, **fk):
        super().__init__()
        d = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, d, 3, padding=1, **fk)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1, **fk)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, d, **fk)
        self.layers = nn.ModuleList(EncoderLayer(cfg, **fk) for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(d, eps=LN_EPS, **fk)
        with torch.no_grad():
            self.embed_positions.weight.copy_(sinusoids(cfg.max_source_positions, d))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 3000) -> (B, 1500, D)."""
        x = F.gelu(self.conv2(F.gelu(self.conv1(mel.to(self.conv1.weight.dtype)))))
        x = x.transpose(1, 2) + self.embed_positions.weight
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


class Decoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, **fk):
        super().__init__()
        d = cfg.d_model
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d, **fk)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, d, **fk)
        self.layers = nn.ModuleList(DecoderLayer(cfg, **fk) for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(d, eps=LN_EPS, **fk)


class WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfig, **fk):
        super().__init__()
        self.encoder = Encoder(cfg, **fk)
        self.decoder = Decoder(cfg, **fk)


class Whisper(nn.Module):
    """The encoder-decoder, its parameters under Hugging Face's names
    (``model.encoder.layers.0.self_attn.q_proj.weight``, ...); the output
    projection is the token embedding (``proj_out`` is tied to it)."""

    def __init__(self, cfg: WhisperConfig = WhisperConfig(), *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.model = WhisperModel(cfg, device=device, dtype=dtype)

    def load_hf_state_dict(self, sd: dict) -> None:
        """A Hugging Face state dict, ``proj_out.weight`` (tied) dropped."""
        sd = {k: v for k, v in sd.items() if k != "proj_out.weight"}
        self.load_state_dict(sd, strict=True)


@dataclasses.dataclass
class DecodeState:
    """The static cache of one transcription: self-attention keys and values
    (L, B, H, n_ctx, head_dim), each layer's cross-attention (keys, values),
    the next slot ``pos`` (a 0-dim tensor on the device) and the slot
    indices; ``plan``, on the card, the :class:`_DecodePlan` whose graph,
    recorded over these buffers, :meth:`WhisperASR.step` replays."""

    k: torch.Tensor
    v: torch.Tensor
    cross: list
    pos: torch.Tensor
    slots: torch.Tensor
    plan: Optional["_DecodePlan"] = None


class ByteLevelDecoder:
    """Token ids -> text through a snapshot's ``vocab.json`` (GPT-2's
    byte-level BPE symbols); ids from ``<|endoftext|>`` up are special and
    dropped."""

    def __init__(self, vocab: dict, eot: int):
        self.symbols = {i: s for s, i in vocab.items()}
        self.eot = eot
        self.byte_of = {c: b for b, c in _bytes_to_unicode().items()}

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.symbols.get(int(i), "") for i in ids if int(i) < self.eot)
        return bytes(self.byte_of[c] for c in text if c in self.byte_of).decode("utf-8", errors="replace")


def _bytes_to_unicode() -> dict:
    """GPT-2's map of the 256 byte values onto printable characters."""
    bs = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1), *range(ord("®"), ord("ÿ") + 1)]
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class WhisperASR:
    """Greedy batched transcription with :class:`Whisper` on the model's
    device. ``tokenizer``: a :class:`ByteLevelDecoder`, or None (each token id
    is a word).

    On the card the decode buffers stay with the instance between calls:
    one set of cross keys and values for each ``rows`` value it has seen
    (2 x layers x rows x 1500 x d_model, 1.97 GB at large-v3 and 8 rows),
    and one self-attention cache, decode graph and graph pool for each
    (rows, cache length) pair (the cache up to 0.59 GB at 8 rows and 448
    slots). They go when the instance goes."""

    def __init__(self, model: Whisper, tokenizer: Optional[ByteLevelDecoder] = None):
        from syntalker_tpu_torch.data.audio import mel_filterbank

        self.model = model.eval().requires_grad_(False)
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        w = model.model.decoder.embed_tokens.weight
        self.device = w.device
        self.filters = torch.as_tensor(mel_filterbank(SAMPLE_RATE, N_FFT, self.cfg.num_mel_bins), device=self.device)
        self.head = w.float()  # the tied output projection, read in float32
        self._cross = {}  # rows -> each layer's cross (keys, values) buffers (rows, 1500, D), on the card
        self._plans = {}  # (rows, n_ctx) -> the DecodeState whose plan replays on the card
        self._lock = threading.Lock()  # a transcription holds it while it uses those buffers

    @property
    def max_new_tokens(self) -> int:
        return self.cfg.max_target_positions - len(self.cfg.prompt)

    def mel(self, audios: Sequence[np.ndarray], rows: int) -> torch.Tensor:
        """(rows, n_mels, 3000): each waveform padded or trimmed to 30 s, the
        padding rows silent."""
        x = np.zeros((rows, N_SAMPLES), np.float32)
        for i, y in enumerate(audios):
            n = min(len(y), N_SAMPLES)
            x[i, :n] = y[:n]
        return log_mel(torch.from_numpy(x).to(self.device, non_blocking=True), self.filters)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.model.model.encoder(mel)

    def cross_kv(self, enc: torch.Tensor) -> list:
        """Each decoder layer's cross-attention (keys, values) (B, H, 1500,
        head_dim). On the card they are written into the buffers of B rows
        that the decode graphs read, and are views of them: the caller
        holds them (and ``_lock``, as :meth:`transcribe` does) until its
        last step."""
        layers = [layer.encoder_attn for layer in self.model.model.decoder.layers]
        if self.device.type == "cpu":
            return [a.kv(enc) for a in layers]
        bufs = self._cross_buffers(enc.shape[0])
        for a, (k, v) in zip(layers, bufs):
            k.copy_(a.k_proj(enc))
            v.copy_(a.v_proj(enc))
        return self._cross_views(bufs)

    def _cross_buffers(self, rows: int) -> list:
        """The cross (keys, values) buffers (rows, 1500, D), zeroed when made."""
        bufs = self._cross.get(rows)
        if bufs is None:
            cfg, w = self.cfg, self.model.model.decoder.embed_tokens.weight
            shape = (rows, cfg.max_source_positions, cfg.d_model)
            bufs = self._cross[rows] = [
                (torch.zeros(shape, dtype=w.dtype, device=self.device),
                 torch.zeros(shape, dtype=w.dtype, device=self.device))
                for _ in range(cfg.decoder_layers)]
        return bufs

    def _cross_views(self, bufs: list) -> list:
        return [(layer.encoder_attn.split(k), layer.encoder_attn.split(v))
                for layer, (k, v) in zip(self.model.model.decoder.layers, bufs)]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.model.model.decoder.layer_norm(x).float(), self.head)

    def prefill(self, tokens: torch.Tensor, state: DecodeState) -> torch.Tensor:
        """The prompt (B, P) into cache slots [0, P); the logits (B, V) of the
        first generated token."""
        dec = self.model.model.decoder
        p = tokens.shape[1]
        pos = state.slots[:p]
        x = dec.embed_tokens(tokens) + dec.embed_positions.weight[:p]
        for i, layer in enumerate(dec.layers):
            x = layer(x, state.k[i], state.v[i], state.cross[i], pos)
        state.pos.fill_(p)
        return self._logits(x[:, -1])

    def step(self, tokens: torch.Tensor, state: DecodeState) -> torch.Tensor:
        """Feed (B,) tokens at slot ``state.pos``; the logits (B, V) of the
        next token. Advances ``state.pos``. A state with a plan (the card's)
        replays the plan's graph, and the logits are then the plan's buffer:
        valid until the next step over that plan overwrites them."""
        if state.plan is not None:
            return state.plan.replay(tokens)
        return self._step(tokens, state)

    def _step(self, tokens: torch.Tensor, state: DecodeState) -> torch.Tensor:
        """:meth:`step`'s work, run eagerly (or recorded into a graph)."""
        dec = self.model.model.decoder
        pos = state.pos.view(1)
        x = (dec.embed_tokens(tokens) + dec.embed_positions.weight.index_select(0, pos))[:, None]
        mask = (state.slots <= state.pos)[None]  # (1, n_ctx): the one query row
        for i, layer in enumerate(dec.layers):
            x = layer(x, state.k[i], state.v[i], state.cross[i], pos, mask)
        state.pos.add_(1)
        return self._logits(x[:, 0])

    def _new_cache(self, rows: int, n_ctx: int, cross: list) -> DecodeState:
        cfg, dec = self.cfg, self.model.model.decoder
        h = cfg.decoder_attention_heads
        shape = (cfg.decoder_layers, rows, h, n_ctx, cfg.d_model // h)
        w = dec.embed_tokens.weight
        return DecodeState(k=torch.zeros(shape, dtype=w.dtype, device=self.device),
                           v=torch.zeros(shape, dtype=w.dtype, device=self.device), cross=cross,
                           pos=torch.zeros((), dtype=torch.long, device=self.device),
                           slots=torch.arange(n_ctx, device=self.device))

    def new_state(self, rows: int, n_ctx: int, cross: list) -> DecodeState:
        """An empty cache of ``n_ctx`` slots over ``cross``. On the card,
        ``cross`` is what :meth:`cross_kv` returned for ``rows`` rows, and the
        state is the one state of (rows, n_ctx), emptied, its plan's graph
        recorded at the first such call."""
        if self.device.type == "cpu":
            return self._new_cache(rows, n_ctx, cross)
        bufs = self._cross.get(rows, ())
        if len(bufs) != len(cross) or any(b.data_ptr() != x.data_ptr()
                                          for pair, given in zip(bufs, cross) for b, x in zip(pair, given)):
            raise ValueError(f"the decode graph reads cross_kv's buffers of {rows} rows: pass what it returned")
        state = self._plans.get((rows, n_ctx))
        if state is None:
            with torch.cuda.device(self.device):
                state = self._new_cache(rows, n_ctx, cross)
                state.plan = _DecodePlan(self, state)
            self._plans[(rows, n_ctx)] = state
            tracking.count("asr.graph_captures", 1)
        state.k.zero_()
        state.v.zero_()
        state.pos.zero_()
        return state

    @torch.no_grad()
    def transcribe(self, audios: Sequence[np.ndarray], caps: Sequence[int], rows: Optional[int] = None) -> List[list]:
        """Greedy token ids of each 16 kHz waveform (its first 30 s), at most
        ``caps[i]`` of them (at most :attr:`max_new_tokens`), ``<|endoftext|>``
        not kept. The batch is padded to ``rows`` (default: one a request)."""
        cfg, n = self.cfg, len(audios)
        rows = n if rows is None else rows
        if not 0 < n <= rows:
            raise ValueError(f"{n} requests for {rows} rows")
        caps = [max(1, min(int(c), self.max_new_tokens)) for c in caps] + [1] * (rows - n)
        longest, eot = max(caps), cfg.eos_token_id
        tracking.count("asr.rows", rows)
        tracking.count("asr.rows_real", n)
        with tracking.span("asr.mel"):
            mel = self.mel(audios, rows)
        with tracking.span("asr.encode"):
            enc = self.encode(mel)
        with self._lock:  # the card's cross and cache buffers are this call's until its last step
            with tracking.span("asr.cross_kv"):
                cross = self.cross_kv(enc)
            state = self.new_state(rows, context_bucket(len(cfg.prompt) + longest, cfg.max_target_positions), cross)
            cap = torch.tensor(caps, device=self.device)
            out = torch.full((rows, longest), eot, dtype=torch.long, device=self.device)
            with tracking.span("asr.prefill"):
                prompt = torch.tensor(cfg.prompt, device=self.device).expand(rows, -1)
                tok = self.prefill(prompt, state).argmax(-1)
                out[:, 0] = tok
                done = (tok == eot) | (cap <= 1)
                finished = bool(done.all())  # the first wait for the card: the encoder's and the prefill's work
            made = 1
            path = "eager" if state.plan is None else "graph"
            with tracking.span("asr.decode", rows=rows, real=n, path=path) as sp:
                while made < longest and not finished:
                    tok = torch.where(done, eot, self.step(tok, state).argmax(-1))
                    out[:, made] = tok
                    made += 1
                    done |= (tok == eot) | (cap <= made)
                    finished = bool(done.all())
                kept = [_until_eot(r, eot) for r in out[:n].tolist()]
                real = sum(len(k) for k in kept)
                if sp is not None:
                    sp.attrs.update(steps=made - 1, tokens_real=real)
        tracking.count("asr.decode_steps", made - 1)
        tracking.count("asr.tokens", rows * made)
        tracking.count("asr.tokens_real", real)
        return kept

    def words(self, tokens: Sequence[int]) -> List[str]:
        """A transcription's words: the tokenizer's text split on white space,
        or each token id as a word."""
        if self.tokenizer is None:
            return [str(int(t)) for t in tokens]
        return self.tokenizer.decode(tokens).split()


class _DecodePlan:
    """The greedy step on the card for one (rows, n_ctx): one CUDA graph of
    :meth:`WhisperASR._step` over a state whose buffers it reads and writes
    (the self-attention cache, the slot ``pos``, the slot indices, and
    views of the cross buffers of those rows, which every n_ctx shares) and over the fed tokens (rows,); its logits (rows, V)
    float32 are a buffer of the graph. The state holds the plan, not the
    other way round, so both go with the :class:`WhisperASR` that keeps them.

    The step runs once for real on a side stream (cuDNN's and cuBLAS's
    plans for these shapes are made there), then once under capture in the
    thread-local mode, so other threads may go on using the card meanwhile.
    The real run wrote one cache slot and moved ``pos``; :meth:`WhisperASR.new_state`
    empties both before each transcription."""

    def __init__(self, asr: WhisperASR, state: DecodeState):
        dev = state.k.device
        self.tokens = torch.zeros(state.k.shape[1], dtype=torch.long, device=dev)
        current, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            asr._step(self.tokens, state)
        current.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # a capture stream of this card: torch's default one is made once a process, on the first card that captures
        with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(dev), capture_error_mode="thread_local"):
            self.logits = asr._step(self.tokens, state)
        self.device = dev

    def replay(self, tokens: torch.Tensor) -> torch.Tensor:
        with torch.cuda.device(self.device):
            self.tokens.copy_(tokens)
            self.graph.replay()
        tracking.count("asr.graph_steps", 1)
        return self.logits


def _until_eot(row: list, eot: int) -> list:
    return row[: row.index(eot)] if eot in row else row


def load_snapshot(path, *, device=None, dtype=torch.float32) -> WhisperASR:
    """A :class:`WhisperASR` from a local Hugging Face snapshot directory:
    ``config.json``, ``model.safetensors`` (Hugging Face's names), and where
    present ``generation_config.json`` (special tokens) and ``vocab.json``
    (the tokenizer). Reads nothing else and downloads nothing."""
    from safetensors.torch import load_file

    from syntalker_tpu_torch.device import resolve_device

    p = Path(path)
    gen = p / "generation_config.json"
    cfg = WhisperConfig.from_hf(json.loads((p / "config.json").read_text()),
                                json.loads(gen.read_text()) if gen.exists() else None)
    dev = resolve_device(device)
    model = Whisper(cfg, device=dev, dtype=dtype)
    model.load_hf_state_dict({k: v.to(dtype) for k, v in load_file(str(p / "model.safetensors")).items()})
    vocab = p / "vocab.json"
    tok = ByteLevelDecoder(json.loads(vocab.read_text()), cfg.eos_token_id) if vocab.exists() else None
    return WhisperASR(model, tok)
