"""HumanML3D text-to-motion evaluation: the metrics, the BiGRU co-embedding oracle and its artifacts.

Counterpart of ``syntalker_tpu/eval/t2m.py``:

- the numpy metrics (the same code, the port keeps its own copy): matching
  score and R-precision over text-motion co-embeddings, FID, Diversity and
  MultiModality (the same ``default_rng(seed)`` draws), and the mean ± 95%
  CI over replications;
- the oracle's towers as ``nn.Module`` s: :class:`MovementConvEncoder`,
  :class:`BiGRU`, :class:`MotionEncoderBiGRUCo` and
  :class:`TextEncoderBiGRUCo`, named as the flax tree is, so that
  :mod:`syntalker_tpu_torch.bridge` copies one onto the other;
- :class:`T2MEvaluator` (``from_artifact`` reads the committed
  ``weights/t2m_oracle/bigru.npz``), :func:`evaluate_replications` and
  :func:`make_t2m_oracle_train_step`;
- the flat-npz I/O of the committed t2m artifacts.

The bidirectional GRU keeps flax's ``GRUCell`` parameters (``ir``, ``iz``,
``in`` with biases, ``hr``, ``hz`` without, ``hn`` with one) and runs them
through ``torch.gru`` (cuDNN on the card) as PyTorch's layout:
``weight_ih = [W_ir; W_iz; W_in]`` and ``bias_hh = [0; 0; b_hn]``. Each
sequence is packed at its own length, so the backward direction starts at
the sequence's last valid step, as flax's ``reverse=True, keep_order=True``
with ``seq_lengths`` does. cuDNN runs RNNs in TF32 by default; the oracle
runs under :func:`~syntalker_tpu_torch.device.full_f32`.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence

from syntalker_tpu_torch.device import full_f32, resolve_device
from syntalker_tpu_torch.eval.metrics import frechet_distance

# ---------------------------------------------------------------------------
# numpy metric math
# ---------------------------------------------------------------------------


def euclidean_distance_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d2 = np.sum(a**2, axis=1, keepdims=True) - 2 * a @ b.T + np.sum(b**2, axis=1)[None]
    return np.sqrt(np.maximum(d2, 0.0))


def calculate_top_k(argsort_mat: np.ndarray, top_k: int = 3) -> np.ndarray:
    """(N, N) argsorted distance rows -> (N, top_k) cumulative hit matrix."""
    n = argsort_mat.shape[0]
    hits = argsort_mat[:, :top_k] == np.arange(n)[:, None]
    return np.cumsum(hits, axis=1) > 0


def matching_and_r_precision(text_emb: np.ndarray, motion_emb: np.ndarray, top_k: int = 3):
    """Matching score (mean ground-truth pair distance) and R-precision@1..k."""
    dist = euclidean_distance_matrix(text_emb, motion_emb)
    matching = float(np.trace(dist)) / dist.shape[0]
    r = calculate_top_k(np.argsort(dist, axis=1), top_k).sum(axis=0) / dist.shape[0]
    return matching, r


def calculate_diversity(activations: np.ndarray, diversity_times: int, seed: int = 0) -> float:
    n = activations.shape[0]
    rng = np.random.default_rng(seed)
    i1 = rng.choice(n, diversity_times, replace=n < diversity_times)
    i2 = rng.choice(n, diversity_times, replace=n < diversity_times)
    return float(np.linalg.norm(activations[i1] - activations[i2], axis=1).mean())


def calculate_multimodality(activations: np.ndarray, multimodality_times: int, seed: int = 0) -> float:
    """activations: (n_prompts, n_repeats, D)."""
    _n, r, _ = activations.shape
    rng = np.random.default_rng(seed)
    i1 = rng.choice(r, multimodality_times, replace=r < multimodality_times)
    i2 = rng.choice(r, multimodality_times, replace=r < multimodality_times)
    return float(np.linalg.norm(activations[:, i1] - activations[:, i2], axis=2).mean())


def calculate_activation_statistics(activations: np.ndarray):
    return activations.mean(axis=0), np.cov(activations, rowvar=False)


def fid_from_activations(gen: np.ndarray, gt: np.ndarray) -> float:
    return frechet_distance(gen, gt)


def get_metric_statistics(values, replication_times: int):
    """Mean ± 95% CI over replications (t2m_eval_tools.py:242-262)."""
    values = np.asarray(values)
    return values.mean(axis=0), 1.96 * values.std(axis=0) / np.sqrt(replication_times)


# ---------------------------------------------------------------------------
# the oracle's towers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class T2MEvalConfig:
    dim_pose: int = 623
    dim_word: int = 300
    dim_pos_ohot: int = 15
    dim_movement: int = 512
    dim_coemb: int = 512
    hidden: int = 1024
    unit_length: int = 4


class MovementConvEncoder(nn.Module):
    """Two stride-2 convolutions over pose features (T -> T/4), leaky ReLU
    0.2 after each, then a projection (channels last in and out)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.conv1 = nn.Conv1d(in_dim, 512, 4, stride=2, padding=1)
        self.conv2 = nn.Conv1d(512, out_dim, 4, stride=2, padding=1)
        self.out = nn.Linear(out_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv1(x.transpose(1, 2)), 0.2)
        h = F.leaky_relu(self.conv2(h), 0.2)
        return self.out(h.transpose(1, 2))


class GRUCell(nn.Module):
    """flax ``GRUCell``'s parameters: input kernels ``ir``/``iz``/``in`` with
    biases, recurrent kernels ``hr``/``hz`` without and ``hn`` with one."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.ir = nn.Linear(in_dim, hidden)
        self.iz = nn.Linear(in_dim, hidden)
        self.add_module("in", nn.Linear(in_dim, hidden))  # a keyword: read with getattr
        self.hr = nn.Linear(hidden, hidden, bias=False)
        self.hz = nn.Linear(hidden, hidden, bias=False)
        self.hn = nn.Linear(hidden, hidden)

    def flat_weights(self) -> list:
        """PyTorch's (w_ih, w_hh, b_ih, b_hh) of one direction, gates r, z, n."""
        n_in = getattr(self, "in")
        return [torch.cat([self.ir.weight, self.iz.weight, n_in.weight]),
                torch.cat([self.hr.weight, self.hz.weight, self.hn.weight]),
                torch.cat([self.ir.bias, self.iz.bias, n_in.bias]),
                torch.cat([torch.zeros_like(self.hn.bias).repeat(2), self.hn.bias])]


class BiGRU(nn.Module):
    """(B, L, in) with per-row lengths -> (B, 2·hidden): the forward state at
    each row's last valid step beside the backward state at step 0, the
    backward direction run from the row's last valid step. ``GRUCell_0`` is
    the forward cell, ``GRUCell_1`` the backward one (flax's names)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.GRUCell_0 = GRUCell(in_dim, hidden)
        self.GRUCell_1 = GRUCell(in_dim, hidden)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        packed = pack_padded_sequence(x, lengths.detach().cpu().long(), batch_first=True, enforce_sorted=False)
        h0 = x.new_zeros(2, x.shape[0], self.hidden)
        weights = self.GRUCell_0.flat_weights() + self.GRUCell_1.flat_weights()
        # cuDNN's backward needs the train-mode forward
        _, h_n = torch.gru(packed.data, packed.batch_sizes, h0, weights, True, 1, 0.0, torch.is_grad_enabled(), True)
        h_n = h_n[:, packed.unsorted_indices]
        return torch.cat([h_n[0], h_n[1]], dim=-1)


class MotionEncoderBiGRUCo(nn.Module):
    """Motion (B, T, dim_pose) and valid frame counts (B,) -> co-embedding
    (B, dim_coemb). Reads the first ``dim_pose - 4`` channels (no foot
    contacts) and ``max(m_lens // unit_length, 1)`` movement steps."""

    def __init__(self, cfg: T2MEvalConfig):
        super().__init__()
        self.cfg = cfg
        self.movement = MovementConvEncoder(cfg.dim_pose - 4, cfg.dim_movement)
        self.input_emb = nn.Linear(cfg.dim_movement, cfg.hidden)
        self.gru = BiGRU(cfg.hidden, cfg.hidden)
        self.output = nn.Linear(2 * cfg.hidden, cfg.dim_coemb)

    def forward(self, motion: torch.Tensor, m_lens: torch.Tensor) -> torch.Tensor:
        mov = self.movement(motion[..., : self.cfg.dim_pose - 4])
        lengths = torch.clamp(torch.div(m_lens, self.cfg.unit_length, rounding_mode="floor"), min=1)
        return self.output(self.gru(self.input_emb(mov), lengths))


class TextEncoderBiGRUCo(nn.Module):
    """Word vectors (B, L, dim_word), POS one-hots (B, L, dim_pos_ohot) and
    caption lengths (B,) -> co-embedding (B, dim_coemb)."""

    def __init__(self, cfg: T2MEvalConfig):
        super().__init__()
        self.cfg = cfg
        self.input_emb = nn.Linear(cfg.dim_word + cfg.dim_pos_ohot, cfg.hidden)
        self.gru = BiGRU(cfg.hidden, cfg.hidden)
        self.output = nn.Linear(2 * cfg.hidden, cfg.dim_coemb)

    def forward(self, word_embs: torch.Tensor, pos_ohot: torch.Tensor, cap_lens: torch.Tensor) -> torch.Tensor:
        h = self.input_emb(torch.cat([word_embs, pos_ohot], dim=-1))
        return self.output(self.gru(h, cap_lens))


@torch.no_grad()
def init_like_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initializers drawn from ``generator``: Dense, Conv and GRU
    input kernels lecun-normal (fan-in the input width times the kernel
    size), GRU recurrent kernels orthogonal, biases zero."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            if name.rsplit(".", 1)[-1] in ("hr", "hz", "hn"):
                q, r = torch.linalg.qr(torch.randn(m.weight.shape, generator=generator))
                m.weight.copy_(q * torch.sign(torch.diagonal(r)))
            else:
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


def _t(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x, device=device).to(dtype)


class T2MEvaluator:
    """The co-embedding oracle (EvaluatorMDMWrapper, t2m_eval_tools.py:833-898).
    ``params`` is a flax tree ``{"motion": ..., "text": ...}`` (nested dicts
    of arrays); without it the towers are initialized from a generator
    seeded ``seed``. Embeddings are numpy, computed in full f32 on
    ``device`` (CUDA unless ``device="cpu"``)."""

    # anchored to the repo root so that from_artifact works from any directory
    DEFAULT_ARTIFACT = str(Path(__file__).resolve().parents[2] / "weights/t2m_oracle/bigru.npz")

    @classmethod
    def from_artifact(cls, path: Optional[str] = None, *, device=None) -> "T2MEvaluator":
        """The committed oracle artifact (npz and its json sidecar with the
        config). Raises ``FileNotFoundError`` when absent, so that nothing
        scores with random weights unnoticed."""
        p = Path(path or cls.DEFAULT_ARTIFACT)
        if not p.exists():
            raise FileNotFoundError(f"t2m oracle artifact {p} missing — train one with the JAX package's "
                                    f"scripts/train_t2m_oracle.py (or pass explicit params)")
        meta = json.loads(p.with_suffix(".json").read_text())
        cfg = T2MEvalConfig(**meta.get("config", {}))
        return cls(cfg, params=load_oracle_params(p), device=device)

    def __init__(self, cfg: T2MEvalConfig = T2MEvalConfig(), params: Optional[dict] = None, *, seed: int = 0,
                 device=None):
        from syntalker_tpu_torch import bridge

        self.cfg = cfg
        self.device = resolve_device(device)
        self.motion_enc = MotionEncoderBiGRUCo(cfg)
        self.text_enc = TextEncoderBiGRUCo(cfg)
        if params is None:
            g = torch.Generator().manual_seed(seed)
            init_like_flax_(self.motion_enc, g)
            init_like_flax_(self.text_enc, g)
        else:
            bridge.load_t2m_oracle(self, params)
        for m in (self.motion_enc, self.text_enc):
            m.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def motion_embeddings(self, motions, m_lens) -> torch.Tensor:
        with full_f32():
            return self.motion_enc(_t(motions, self.device), _t(m_lens, self.device, torch.long))

    def get_motion_embeddings(self, motions, m_lens) -> np.ndarray:
        return self.motion_embeddings(motions, m_lens).cpu().numpy()

    @torch.no_grad()
    def text_embeddings(self, word_embs, pos_ohot, cap_lens) -> torch.Tensor:
        with full_f32():
            return self.text_enc(_t(word_embs, self.device), _t(pos_ohot, self.device),
                                 _t(cap_lens, self.device, torch.long))

    def get_co_embeddings(self, word_embs, pos_ohot, cap_lens, motions, m_lens):
        t = self.text_embeddings(word_embs, pos_ohot, cap_lens).cpu().numpy()
        return t, self.get_motion_embeddings(motions, m_lens)


def evaluate_replications(run_once: Callable[[int], dict], replications: int = 20) -> Dict[str, tuple]:
    """``run_once(rep) -> {metric: value}`` for each replication, then the
    mean ± CI of every metric (the h3d protocol,
    h3d_diffusion_new_trainer.py:907-1060)."""
    acc: Dict[str, list] = {}
    for rep in range(replications):
        for k, v in run_once(rep).items():
            acc.setdefault(k, []).append(v)
    return {k: get_metric_statistics(np.asarray(v), replications) for k, v in acc.items()}


# ---------------------------------------------------------------------------
# oracle training
# ---------------------------------------------------------------------------


def make_t2m_oracle_train_step(motion_enc: MotionEncoderBiGRUCo, text_enc: TextEncoderBiGRUCo, optimizer):
    """Contrastive training of the oracle pair: a ``(params, opt_state,
    batch) -> (params, opt_state, metrics)`` step of the symmetric InfoNCE
    of the two towers' embeddings (every other batch element a negative).
    ``params`` is ``models.tmr.train_params({"text": text_enc, "motion":
    motion_enc})`` (updated in place); ``optimizer`` one of
    :mod:`syntalker_tpu_torch.train.optim`. batch: ``word_embs``,
    ``pos_ohot``, ``cap_lens``, ``motion``, ``m_lens``."""
    from syntalker_tpu_torch.models.tmr import info_nce
    from syntalker_tpu_torch.train.optim import apply_updates

    def step(params, opt_state, batch):
        t = text_enc(batch["word_embs"], batch["pos_ohot"], batch["cap_lens"])
        m = motion_enc(batch["motion"], batch["m_lens"])
        nce = info_nce(t, m)
        grads = torch.autograd.grad(nce, list(params.values()))
        updates, opt_state = optimizer.update(dict(zip(params, grads)), opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, {"nce": nce.detach(), "loss": nce.detach()}

    return step


# ---------------------------------------------------------------------------
# flat-npz parameter trees (the committed t2m artifacts)
# ---------------------------------------------------------------------------


def flatten_params(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> dict:
    """{"a/b/c": array} -> nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_oracle_params(path, params: dict, meta: Optional[Dict] = None) -> Path:
    """The tree as one compressed fp16 npz (small enough to commit), plus a
    JSON sidecar when ``meta`` is given. fp16 is for the small t2m
    artifacts; a denoiser or RVQ checkpoint is written in f32."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(p, **{k: v.astype(np.float16) for k, v in flatten_params(params).items()})
    if meta is not None:
        p.with_suffix(".json").write_text(json.dumps(meta, indent=1))
    return p


def load_oracle_params(path, template: Optional[dict] = None) -> dict:
    """npz -> nested dict of float32 arrays. With a ``template`` tree (of
    arrays or anything with ``.shape``), every template path must be in the
    file with the template's shape, and only those paths are returned."""
    with np.load(path) as data:
        flat = {k: np.asarray(data[k], np.float32) for k in data.files}
    if template is not None:
        want = flatten_params(template)
        for key, v in want.items():
            if key not in flat:
                raise KeyError(f"{key}: missing from {path}")
            if flat[key].shape != np.shape(v):
                raise ValueError(f"{key}: artifact {flat[key].shape} != model {np.shape(v)}")
        flat = {k: flat[k] for k in want}
    return unflatten_params(flat)
