"""Residual vector quantization with EMA-reset codebooks (PyTorch).

Counterpart of ``syntalker_tpu/ops/quantize.py``: the eval half
(``code_distances``, ``rvq_encode``, ``rvq_dequantize``,
``rvq_quantize_eval``) and the train half (``init_rvq_state``,
``rvq_forward`` with lazy codebook init, quantizer dropout, Gumbel
assignment, the EMA update and the dead-code reset, ``_perplexity``). With
``shared_codebook`` the state holds one codebook (1, K, D) that every layer
reads. Layout ``(B, T, D)``.

JAX draws the forward's randomness from threefry keys, which PyTorch cannot
replay. The train forward takes its draws as one :class:`RVQDraws` (made by
:func:`draw_rvq` from a ``torch.Generator``, or by a test from JAX's keys).
The distances, the one-hot code sums and the EMA run in full f32: TF32
would move the argmax. ``torch.argmax``, like ``jnp.argmax``, takes the
first index on a tie.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F

from syntalker_tpu_torch.device import full_f32
from syntalker_tpu_torch.parallel.collectives import all_reduce_sum, gather_rows, rows_of


@dataclasses.dataclass(frozen=True)
class RVQConfig:
    num_quantizers: int = 6
    nb_code: int = 512
    code_dim: int = 512
    mu: float = 0.99  # EMA decay
    quantize_dropout_prob: float = 0.2
    quantize_dropout_cutoff: int = 0
    gumbel_temperature: float = 0.5
    shared_codebook: bool = False  # one codebook for every layer


@dataclasses.dataclass
class RVQState:
    """EMA codebook state, stacked on axis 0. An inference state carries
    the codebooks alone (``code_sum``/``code_count`` None); training needs
    all four fields, as :func:`init_rvq_state` gives them."""

    codebook: torch.Tensor  # (Q, K, D) float32; (1, K, D) with shared_codebook
    code_sum: Optional[torch.Tensor] = None  # (Q, K, D) float32
    code_count: Optional[torch.Tensor] = None  # (Q, K) float32
    initialized: bool = True  # False: the next train batch initializes the codebooks


@dataclasses.dataclass
class RVQOutput:
    quantized: torch.Tensor  # (B, T, D) straight-through output
    indices: torch.Tensor  # (B, T, Q) int64, -1 for dropped layers
    commit_loss: torch.Tensor  # () mean over active layers
    perplexity: torch.Tensor  # () mean over active layers
    state: RVQState


@dataclasses.dataclass
class RVQDraws:
    """The random draws of one train forward over N rows, per layer.

    ``last_active`` is the last layer kept by quantizer dropout (a 0-d int
    tensor; Q-1 keeps all). ``init_noise`` and ``reset_noise`` are the
    N(0, 1) jitters (K, D) of the lazy init and the dead-code reset, None
    where the batch has at least K rows (no jitter is drawn then).
    ``gumbel`` holds the uniforms (N, K) on [1e-20, 1) of the Gumbel
    assignment."""

    last_active: torch.Tensor
    init_noise: List[Optional[torch.Tensor]]
    reset_noise: List[Optional[torch.Tensor]]
    gumbel: List[torch.Tensor]

    def to(self, device) -> "RVQDraws":
        move = (lambda t: None if t is None else t.to(device))
        return RVQDraws(self.last_active.to(device), [move(t) for t in self.init_noise],
                        [move(t) for t in self.reset_noise], [t.to(device) for t in self.gumbel])

    def shard(self, axis) -> "RVQDraws":
        """The draws of this rank's block of the rows over a data axis: the
        Gumbel uniforms' rows; the rest is the global batch's."""
        return RVQDraws(self.last_active, self.init_noise, self.reset_noise,
                        [rows_of(t, axis) for t in self.gumbel])


def init_rvq_state(cfg: RVQConfig, device=None) -> RVQState:
    """JAX's fresh state: all-zero codebooks, sums and counts, not yet
    initialized (the first train batch fills them)."""
    q = 1 if cfg.shared_codebook else cfg.num_quantizers
    zeros = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return RVQState(zeros(q, cfg.nb_code, cfg.code_dim), zeros(q, cfg.nb_code, cfg.code_dim),
                    zeros(q, cfg.nb_code), initialized=False)


def layer_codebooks(state: RVQState, cfg: RVQConfig) -> torch.Tensor:
    """The (Q, K, D) codebooks layer by layer: a shared codebook is
    repeated for every layer."""
    if cfg.shared_codebook:
        return state.codebook[:1].expand(cfg.num_quantizers, -1, -1)
    return state.codebook[: cfg.num_quantizers]


def code_distances(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (N, K) = ‖x‖² − 2·x·Cᵀ + ‖c‖², in full f32."""
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (codebook * codebook).sum(-1)
    with full_f32():
        cross = x @ codebook.T
    return x2 - 2.0 * cross + c2[None, :]


def rvq_encode(x: torch.Tensor, state: RVQState, cfg: RVQConfig) -> torch.Tensor:
    """(B, T, D) -> token indices (B, T, Q): residual argmin per layer
    (torch.argmin returns the first, i.e. lowest, index on ties)."""
    b, t, d = x.shape
    residual = x.reshape(b * t, d)
    codebooks = layer_codebooks(state, cfg)
    out = []
    for q in range(cfg.num_quantizers):
        codebook = codebooks[q]
        idx = code_distances(residual, codebook).argmin(-1)
        residual = residual - codebook[idx]
        out.append(idx)
    return torch.stack(out, -1).reshape(b, t, cfg.num_quantizers)


def rvq_dequantize(indices: torch.Tensor, state: RVQState, cfg: RVQConfig) -> torch.Tensor:
    """Indices (B, T, Q) -> summed codes (B, T, D); -1 indices contribute 0."""
    out = torch.zeros(indices.shape[:2] + (cfg.code_dim,), device=indices.device)
    codebooks = layer_codebooks(state, cfg)
    for q in range(indices.shape[-1]):
        idx = indices[..., q]
        code = codebooks[q][idx.clamp_min(0)]
        out = out + torch.where((idx >= 0)[..., None], code, 0.0)
    return out


def rvq_quantize_eval(x: torch.Tensor, state: RVQState, cfg: RVQConfig):
    """(B, T, D) -> (quantized (B, T, D), indices (B, T, Q))."""
    idx = rvq_encode(x, state, cfg)
    return rvq_dequantize(idx, state, cfg), idx


def draw_rvq(cfg: RVQConfig, n: int, generator: torch.Generator, device=None) -> RVQDraws:
    """The draws of one train forward over ``n`` rows from ``generator``
    (on ``device``): the dropout Bernoulli and start layer, each layer's
    init and reset jitter (only when n < K) and Gumbel uniforms."""
    nq, k, d = cfg.num_quantizers, cfg.nb_code, cfg.code_dim
    if cfg.quantize_dropout_prob > 0:
        do_drop = torch.rand((), generator=generator, device=device) < cfg.quantize_dropout_prob
        start = torch.randint(cfg.quantize_dropout_cutoff, nq, (), generator=generator, device=device)
        last_active = torch.where(do_drop, start, nq - 1)
    else:
        last_active = torch.tensor(nq - 1, device=device)
    jitter = lambda: torch.randn(k, d, generator=generator, device=device) if n < k else None  # noqa: E731
    init_noise = [jitter() for _ in range(nq)]
    reset_noise = [jitter() for _ in range(nq)]
    gumbel = [torch.rand(n, k, generator=generator, device=device).clamp_(min=1e-20) for _ in range(nq)]
    return RVQDraws(last_active, init_noise, reset_noise, gumbel)


def _tile_to_codebook(x: torch.Tensor, nb_code: int, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """The first ``nb_code`` rows of x; with fewer rows, x repeated and
    jittered by ``noise`` · 0.01/sqrt(D)."""
    n, d = x.shape
    if n >= nb_code:
        return x[:nb_code]
    out = x.repeat(-(-nb_code // n), 1)[:nb_code]
    std = 0.01 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    return out + noise * std.to(x.device)


def _assign(x: torch.Tensor, codebook: torch.Tensor, *, temperature: float,
            gumbel_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nearest code; with Gumbel uniforms (train) the argmax of
    -distance / temperature + Gumbel noise."""
    logits = -code_distances(x, codebook)
    if gumbel_u is not None and temperature > 0:
        logits = logits / temperature - torch.log(-torch.log(gumbel_u))
    return logits.argmax(-1)


def _perplexity(code_count: torch.Tensor) -> torch.Tensor:
    prob = code_count / torch.clamp(code_count.sum(), min=1e-7)
    return torch.exp(-(prob * torch.log(prob + 1e-7)).sum())


def rvq_forward(x: torch.Tensor, state: RVQState, cfg: RVQConfig, *, train: bool,
                draws: Optional[RVQDraws] = None, force_dropout_index: int = -1, data_axis=None) -> RVQOutput:
    """The full residual-VQ forward, train or eval: straight-through output,
    per-layer indices (-1 where a layer was dropped), commit loss and
    perplexity averaged over the active layers, and the next state.

    In training the codebooks are lazily initialized from the first batch
    (``state.initialized`` False), and each active layer's codebook takes
    its EMA update with dead codes reset from the batch; a dropped layer
    keeps its state. ``draws`` (train only) are :func:`draw_rvq`'s.

    With a ``data_axis`` (:class:`~syntalker_tpu_torch.parallel.collectives.Axis`)
    ``x`` is this rank's block of the global batch and every statistic is
    the global batch's, as under JAX's data sharding: the code sums and
    counts (hence the EMA and the perplexity) are summed over the ranks,
    and the lazy-init and dead-code rows are the global batch's first
    ``nb_code`` rows, gathered across ranks. ``draws`` are then
    :meth:`RVQDraws.shard` of the global batch's. The commit loss stays
    this rank's mean."""
    b, t, d = x.shape
    nq = cfg.num_quantizers
    flat = x.reshape(b * t, d)
    if train:
        if draws is None:
            raise ValueError("a train forward needs its draws: see draw_rvq")
        if state.code_sum is None:
            raise ValueError("training needs the EMA sums and counts: start from init_rvq_state")
        last_active = draws.last_active.to(x.device)
    else:
        last_active = torch.tensor(nq - 1, device=x.device)
    if force_dropout_index >= 0:
        last_active = torch.tensor(force_dropout_index, device=x.device)
    active = torch.arange(nq, device=x.device) <= last_active  # (Q,)
    active_f = active.float()
    num_active = active_f.sum()

    residual = flat
    quantized_out = torch.zeros_like(flat)
    indices, commits, perplexities, codebooks, sums, counts = [], [], [], [], [], []
    with full_f32():
        for q in range(nq):
            slot = 0 if cfg.shared_codebook else q
            sg_res = residual.detach()
            if train:
                # the global batch's first rows: the lazy init's and the dead codes' source
                head = gather_rows(sg_res, data_axis, cfg.nb_code)
            if train and not state.initialized:
                codebook = code_sum = _tile_to_codebook(head, cfg.nb_code, draws.init_noise[q])
                code_count = torch.ones(cfg.nb_code, dtype=x.dtype, device=x.device)
            else:
                codebook = state.codebook[slot]
                code_sum = None if state.code_sum is None else state.code_sum[slot]
                code_count = None if state.code_count is None else state.code_count[slot]
            idx = _assign(sg_res, codebook, temperature=cfg.gumbel_temperature,
                          gumbel_u=draws.gumbel[q] if train else None)
            x_d = codebook[idx]
            onehot = F.one_hot(idx, cfg.nb_code).to(sg_res.dtype)
            if train:
                # EMA + dead-code reset, masked by `active`: a dropped layer keeps its statistics
                sums_counts = all_reduce_sum(torch.cat([onehot.T @ sg_res, onehot.sum(0)[:, None]], 1), data_axis)
                batch_sum, batch_count = sums_counts[:, :-1], sums_counts[:, -1]
                ema_sum = cfg.mu * code_sum + (1.0 - cfg.mu) * batch_sum
                ema_count = cfg.mu * code_count + (1.0 - cfg.mu) * batch_count
                usage = (ema_count >= 1.0).float()[:, None]
                code_update = ema_sum / torch.clamp(ema_count[:, None], min=1e-12)
                code_rand = _tile_to_codebook(head, cfg.nb_code, draws.reset_noise[q])
                upd = usage * code_update + (1.0 - usage) * code_rand
                codebooks.append(torch.where(active[q], upd, codebook))
                sums.append(torch.where(active[q], ema_sum, code_sum))
                counts.append(torch.where(active[q], ema_count, code_count))
            else:
                batch_count = all_reduce_sum(onehot.sum(0), data_axis)
                codebooks.append(codebook)
                sums.append(code_sum)
                counts.append(code_count)
            perplexities.append(_perplexity(batch_count))
            commits.append(((residual - x_d.detach()) ** 2).mean())
            # straight-through, then the residual update; a dropped layer is a no-op
            st = residual + (x_d - residual).detach()
            gate = active_f[q]
            quantized_out = quantized_out + gate * st
            residual = residual - gate * x_d.detach()
            indices.append(torch.where(active[q], idx, -1))

    def stacked(parts):
        if parts[-1] is None:
            return None
        # a shared slot takes the last layer's update
        return parts[-1][None] if cfg.shared_codebook else torch.stack(parts)

    commit = (torch.stack(commits) * active_f).sum() / torch.clamp(num_active, min=1.0)
    perp = (torch.stack(perplexities) * active_f).sum() / torch.clamp(num_active, min=1.0)
    new_state = RVQState(stacked(codebooks), stacked(sums), stacked(counts),
                         initialized=True if train else state.initialized)
    return RVQOutput(quantized=quantized_out.reshape(b, t, d),
                     indices=torch.stack(indices, -1).reshape(b, t, nq),
                     commit_loss=commit, perplexity=perp, state=new_state)
