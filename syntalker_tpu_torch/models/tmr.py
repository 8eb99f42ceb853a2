"""TMR text and motion encoders at inference: the align space of prompt control.

Counterpart of the inference half of ``syntalker_tpu/models/tmr.py``:

- :class:`ActorAgnosticEncoder` — a transformer encoder with two learned
  distribution tokens (mu, logvar) prepended to the sequence and
  sinusoidal positions; pre-LN blocks of flax's ``LayerNorm`` (eps 1e-6),
  ``MultiHeadDotProductAttention`` and a tanh-GELU MLP (flax ``nn.gelu``'s
  default, not the exact erf of the MDM blocks);
- :class:`DistilbertTextEncoder` — the text head: a projection of the
  token hidden states, then an :class:`ActorAgnosticEncoder`;
- :class:`TextPipeline` — prompt strings -> align-space means through the
  hash-word embedding (:func:`~syntalker_tpu_torch.data.captions.hash_word_vector`);
- :func:`embed_prompts`, :func:`load_tmr_artifact`, :func:`load_text_pipeline`;
- the contrastive alignment training: :func:`info_nce` and
  :func:`make_tmr_train_step`.

Parameter names follow the flax tree (``block_i/LayerNorm_0``,
``MultiHeadDotProductAttention_0/{query,key,value,out}``, ``Dense_0``...),
so :mod:`syntalker_tpu_torch.bridge` copies one onto the other. The
DistilBERT backbone path needs a local snapshot and ``transformers``; it is
not ported and raises.

A default :class:`TextPipeline` head is drawn from an explicit
``torch.Generator`` (seed 0) with flax's initializers; JAX's default head
comes from ``PRNGKey(0)``, whose threefry draws PyTorch cannot make, so
the two defaults differ. A trained head comes from a TMR artifact.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from syntalker_tpu_torch.data.captions import hash_word_vector
from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.train.optim import apply_updates

LN_EPS = 1e-6  # flax LayerNorm


@dataclasses.dataclass(frozen=True)
class TMRConfig:
    latent_dim: int = 256
    ff_size: int = 1024
    num_layers: int = 4
    num_heads: int = 4
    motion_feats: int = 623
    text_feats: int = 768  # DistilBERT hidden size


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention``: q/k/v projections with biases,
    queries scaled by 1/sqrt(head width), masked logits set to the dtype's
    minimum, an output projection."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """q_in (B, Lq, D), kv_in (B, Lk, D), mask broadcastable to
        (B, H, Lq, Lk) bool -> (B, Lq, D)."""
        b, lq, d = q_in.shape
        hd = d // self.heads

        def split(x):
            return x.reshape(b, -1, self.heads, hd).transpose(1, 2)  # (B, H, L, hd)

        q = split(self.query(q_in)) / math.sqrt(hd)
        k, v = split(self.key(kv_in)), split(self.value(kv_in))
        logits = q @ k.transpose(-1, -2)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        out = torch.softmax(logits, dim=-1) @ v
        return self.out(out.transpose(1, 2).reshape(b, lq, d))


class Block(nn.Module):
    """Pre-LN self-attention block with a tanh-GELU MLP (flax ``_Block``)."""

    def __init__(self, dim: int, heads: int, ff: int):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=LN_EPS)
        self.MultiHeadDotProductAttention_0 = Attention(dim, heads)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.Dense_0 = nn.Linear(dim, ff)
        self.Dense_1 = nn.Linear(ff, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.LayerNorm_0(x)
        x = x + self.MultiHeadDotProductAttention_0(h, h, mask)
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """(length, dim) sin on even columns, cos on odd ones, in float64 then
    float32, as the flax module computes them."""
    pos = np.zeros((length, dim), np.float32)
    p = np.arange(length)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    pos[:, 0::2] = np.sin(p * div)
    pos[:, 1::2] = np.cos(p * div)
    return pos


class ActorAgnosticEncoder(nn.Module):
    """Sequence (B, T, input_dim) with a (B, T) validity mask -> (mu, logvar),
    each (B, latent_dim), read from the two distribution tokens."""

    def __init__(self, cfg: TMRConfig, input_dim: int):
        super().__init__()
        c = self.cfg = cfg
        self.skel_embedding = nn.Linear(input_dim, c.latent_dim)
        self.dist_tokens = nn.Parameter(torch.zeros(2, c.latent_dim))
        self.blocks = nn.ModuleList(Block(c.latent_dim, c.num_heads, c.ff_size) for _ in range(c.num_layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        b, t, _ = x.shape
        h = self.skel_embedding(x)
        h = torch.cat([self.dist_tokens[None].expand(b, -1, -1), h], dim=1)
        h = h + torch.as_tensor(sinusoidal_positions(t + 2, self.cfg.latent_dim), device=h.device)[None]
        attn_mask = None
        if mask is not None:
            full = torch.cat([torch.ones(b, 2, dtype=torch.bool, device=h.device), mask.to(h.device).bool()], dim=1)
            attn_mask = full[:, None, None, :]  # (B, 1, 1, L): the two tokens always valid
        for blk in self.blocks:
            h = blk(h, attn_mask)
        return h[:, 0], h[:, 1]


class DistilbertTextEncoder(nn.Module):
    """Token hidden states (B, L, text_feats) + mask -> align-space (mu,
    logvar). The DistilBERT backbone runs outside this module."""

    def __init__(self, cfg: TMRConfig):
        super().__init__()
        self.cfg = cfg
        self.projection = nn.Linear(cfg.text_feats, cfg.latent_dim)
        self.head = ActorAgnosticEncoder(cfg, cfg.latent_dim)

    def forward(self, hidden: torch.Tensor, mask: Optional[torch.Tensor] = None):
        return self.head(self.projection(hidden), mask)


@torch.no_grad()
def init_like_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initializers drawn from ``generator``: Dense and attention
    kernels lecun-normal (truncated at two standard deviations, fan-in the
    input width), biases zero, LayerNorm scale one and bias zero, the
    distribution tokens N(0, 0.02²)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    for name, p in module.named_parameters():
        if name.endswith("dist_tokens"):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
    return module


class TextPipeline:
    """Prompt strings -> align-space embeddings through the hash-word
    embedding: each word of a text (lowercased, at most 16) becomes
    :func:`hash_word_vector`, and the head reads the sequence.
    ``head_params`` is a flax param tree of :class:`DistilbertTextEncoder`
    (nested dicts of arrays); without it the head is initialized from
    ``generator`` (default: seed 0). Runs on CUDA unless ``device="cpu"``."""

    def __init__(self, cfg: TMRConfig = TMRConfig(), backbone_path: str = "", head_params=None,
                 generator: Optional[torch.Generator] = None, device=None):
        if backbone_path:
            raise NotImplementedError(
                "the DistilBERT backbone path needs a local snapshot and `transformers` and is not ported; "
                "leave backbone_path empty for the hash-word text path")
        from syntalker_tpu_torch import bridge

        self.cfg = cfg
        self.device = resolve_device(device)
        head = DistilbertTextEncoder(cfg)
        if head_params is None:
            init_like_flax_(head, generator if generator is not None else torch.Generator().manual_seed(0))
        else:
            bridge.load_tmr_text(head, head_params)
        self.head = head.to(self.device).eval().requires_grad_(False)

    def _hash_hidden(self, text: str, max_len: int = 16) -> np.ndarray:
        words = text.lower().split()[:max_len] or ["<empty>"]
        out = np.zeros((len(words), self.cfg.text_feats), np.float32)
        for i, w in enumerate(words):
            out[i] = hash_word_vector(w, self.cfg.text_feats)
        return out

    def hidden_states(self, texts: list[str], max_len: int = 16):
        """(N,) strings -> hidden states (N, max_len, text_feats) and mask
        (N, max_len), numpy, padded to ``max_len``."""
        hidden = np.zeros((len(texts), max_len, self.cfg.text_feats), np.float32)
        mask = np.zeros((len(texts), max_len), np.float32)
        for i, t in enumerate(texts):
            s = self._hash_hidden(t, max_len)
            hidden[i, : s.shape[0]] = s
            mask[i, : s.shape[0]] = 1
        return hidden, mask

    @torch.no_grad()
    def embed(self, texts: list[str]) -> torch.Tensor:
        """(N,) strings -> (N, latent_dim) align-space means, the batch padded
        to its longest text."""
        seqs = [self._hash_hidden(t) for t in texts]
        tmax = max(s.shape[0] for s in seqs)
        hidden = np.zeros((len(seqs), tmax, self.cfg.text_feats), np.float32)
        mask = np.zeros((len(seqs), tmax), np.float32)
        for i, s in enumerate(seqs):
            hidden[i, : s.shape[0]] = s
            mask[i, : s.shape[0]] = 1
        mu, _ = self.head(torch.as_tensor(hidden, device=self.device), torch.as_tensor(mask, device=self.device))
        return mu


def embed_prompts(cfg, prompts: Dict[str, Optional[str]], pipeline: Optional[TextPipeline] = None, *,
                  device=None) -> Dict[str, Optional[torch.Tensor]]:
    """Body part -> prompt text (or None) -> body part -> (1, latent) embedding
    (or None, which leaves that part audio-driven). ``cfg`` is unused, as in
    JAX; the default pipeline is ``TextPipeline(device=device)``."""
    pipeline = pipeline or TextPipeline(device=device)
    return {part: None if not text else pipeline.embed([text]) for part, text in prompts.items()}


def load_tmr_artifact(path):
    """A TMR artifact (``tmr.npz`` of "/"-joined flax paths and its
    ``tmr.json`` sidecar) -> (TMRConfig, {"text": tree, "motion": tree}),
    the trees nested dicts of float32 numpy arrays. Both sides come from
    the same artifact, or the align space means nothing."""
    from syntalker_tpu_torch.eval.t2m import load_oracle_params

    p = Path(path)
    meta = json.loads(p.with_suffix(".json").read_text())
    return TMRConfig(**meta.get("config", {})), load_oracle_params(p)


def load_text_pipeline(path, *, backbone_path: str = "", device=None) -> TextPipeline:
    """A :class:`TextPipeline` with the trained text head of a TMR artifact."""
    cfg, params = load_tmr_artifact(path)
    return TextPipeline(cfg, backbone_path=backbone_path, head_params=params["text"], device=device)



# ---------------------------------------------------------------------------
# contrastive alignment training
# ---------------------------------------------------------------------------


def info_nce(text_emb: torch.Tensor, motion_emb: torch.Tensor, temperature: float = 0.07) -> torch.Tensor:
    """Symmetric InfoNCE over a batch of (text, motion) pairs."""
    t = text_emb / torch.linalg.vector_norm(text_emb, dim=-1, keepdim=True)
    m = motion_emb / torch.linalg.vector_norm(motion_emb, dim=-1, keepdim=True)
    logits = t @ m.T / temperature
    loss_t = -torch.diagonal(torch.log_softmax(logits, dim=1)).mean()
    loss_m = -torch.diagonal(torch.log_softmax(logits, dim=0)).mean()
    return 0.5 * (loss_t + loss_m)


def train_params(modules: Dict[str, nn.Module]) -> Dict[str, torch.Tensor]:
    """The parameters of named modules as one trainable dict, keyed
    ``<name>.<parameter>`` (flax's ``{name: tree}``; ``bridge.FlaxLayout``
    of an ``nn.ModuleDict`` of the same modules maps one onto the other)."""
    return dict(nn.ModuleDict(modules).requires_grad_(True).named_parameters())


def make_tmr_train_step(text_head: DistilbertTextEncoder, motion_enc: ActorAgnosticEncoder, optimizer):
    """A joint contrastive ``(params, opt_state, batch) -> (params,
    opt_state, metrics)`` step: InfoNCE of the two means plus 1e-5 times
    both KL terms. ``params`` is ``train_params({"text": text_head,
    "motion": motion_enc})`` (updated in place); batch: ``text_hidden``
    (B, L, text_feats), ``text_mask`` (B, L), ``motion`` (B, T, feats) and
    optionally ``motion_mask``."""
    def step(params, opt_state, batch):
        t_mu, t_lv = text_head(batch["text_hidden"], batch["text_mask"])
        m_mu, m_lv = motion_enc(batch["motion"], batch.get("motion_mask"))
        nce = info_nce(t_mu, m_mu)
        kl = 0.5 * (torch.exp(t_lv) + t_mu**2 - 1 - t_lv).mean() + 0.5 * (torch.exp(m_lv) + m_mu**2 - 1 - m_lv).mean()
        loss = nce + 1e-5 * kl
        grads = torch.autograd.grad(loss, list(params.values()))
        updates, opt_state = optimizer.update(dict(zip(params, grads)), opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, {"nce": nce.detach(), "kl": kl.detach(), "loss": loss.detach()}

    return step
