"""The port's RVQ train half against JAX, f32 on the CPU: ``rvq_forward`` in
training (lazy init, a second EMA step, the dead-code reset, forced and
drawn quantizer dropout, a shared codebook; outputs, the whole state and
the straight-through gradients), the RVQ-VAE train forward, its dropout,
and one and five ``make_rvq_train_step`` steps (loss, metrics, params,
optimizer state, codebooks).

JAX's draws come from threefry keys; :func:`jax_rvq_draws` rebuilds them
from the same key splits as ``rvq_forward`` (``split(rng, 4)``, then
``fold_in(..., q)`` per layer) and feeds them to the port. The residual
blocks' dropout runs at rate 0 in the parity cases (flax's ``make_rng``
stream cannot be replayed) and is tested on its own with a given mask.

Tolerances: outputs, losses and states 1e-5 relative (max error over max
magnitude; f32, summation order only); indices equal. Adam divides each gradient by its own RMS, so an
element whose gradient is within f32 noise of zero moves by up to a
learning rate's fraction either way: params after a step are held to 1e-5
relative plus 1e-3 of the learning rate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu.models.rvqvae import RVQVAEConfig as JaxRVQVAEConfig
from syntalker_tpu.models.rvqvae import create_rvqvae
from syntalker_tpu.ops import quantize as JQ
from syntalker_tpu.train import state as JS
from syntalker_tpu.train.rvq_trainer import RVQLossConfig as JaxLossConfig
from syntalker_tpu.train.rvq_trainer import make_rvq_train_step as jax_rvq_step
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.models import rvqvae as PR
from syntalker_tpu_torch.ops import quantize as PQ
from syntalker_tpu_torch.train import optim as PO
from syntalker_tpu_torch.train import state as PS
from syntalker_tpu_torch.train.rvq_trainer import RVQLossConfig, make_rvq_train_step
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

REL = 1e-5
LR = 1e-3


def close(a, b, rel=REL, atol=0.0, msg=""):
    """max |a - b| <= rel · max |b| + atol (the port tests' relative error)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    err = np.abs(a - b).max(initial=0.0)
    assert err <= rel * np.abs(b).max(initial=0.0) + atol, (msg, err, np.abs(b).max(initial=0.0))


def jax_rvq_draws(key, cfg, n: int) -> PQ.RVQDraws:
    """JAX's draws of ``rvq_forward(train=True, rng=key)`` over n rows."""
    rd, ri, rr, rg = jax.random.split(key, 4)
    nq, k, d = cfg.num_quantizers, cfg.nb_code, cfg.code_dim
    if cfg.quantize_dropout_prob > 0:
        do = jax.random.bernoulli(rd, cfg.quantize_dropout_prob)
        start = jax.random.randint(jax.random.fold_in(rd, 1), (), cfg.quantize_dropout_cutoff, nq)
        last = int(jnp.where(do, start, nq - 1))
    else:
        last = nq - 1
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    jitter = [[t(jax.random.normal(jax.random.fold_in(r, q), (k, d))) if n < k else None for q in range(nq)]
              for r in (ri, rr)]
    gumbel = [t(jax.random.uniform(jax.random.fold_in(rg, q), (n, k), minval=1e-20, maxval=1.0)) for q in range(nq)]
    return PQ.RVQDraws(torch.tensor(last), jitter[0], jitter[1], gumbel)


def jax_opt_dict(s):
    """JAX's optax state as the nested dicts of ``bridge.optax_state_to_flax``."""
    if isinstance(s, dict):
        return jax.tree.map(np.asarray, s)
    if hasattr(s, "_fields"):
        return {f: jax_opt_dict(getattr(s, f)) for f in s._fields}
    if isinstance(s, tuple):
        return {str(i): jax_opt_dict(x) for i, x in enumerate(s)}
    return np.asarray(s, np.float32)


def assert_trees_close(port: dict, ref: dict, rel=REL, atol=0.0, path=""):
    assert set(port) == set(ref), (path, sorted(port), sorted(ref))
    for k in ref:
        if isinstance(ref[k], dict):
            assert_trees_close(port[k], ref[k], rel, atol, f"{path}/{k}")
        else:
            close(port[k], ref[k], rel, atol, f"{path}/{k}")


def assert_state_close(pstate: PQ.RVQState, jstate, rel=REL):
    for name in ("codebook", "code_sum", "code_count"):
        close(getattr(pstate, name).detach().numpy(), getattr(jstate, name), rel, msg=name)
    assert pstate.initialized == bool(jstate.initialized)


# ---------------------------------------------------------------------------
# rvq_forward
# ---------------------------------------------------------------------------

# name -> (config overrides, rows (B, T), steps, force_dropout_index)
FORWARD_CASES = {
    "lazy_init_and_ema": (dict(quantize_dropout_prob=0.0), (4, 8), 2, -1),  # N = 32 >= K: no jitter
    "few_rows_jitter_and_reset": (dict(quantize_dropout_prob=0.0), (2, 3), 3, -1),  # N = 6 < K: tiled + jittered
    "forced_dropout": (dict(quantize_dropout_prob=0.0), (4, 8), 2, 1),
    "drawn_dropout": (dict(quantize_dropout_prob=0.9), (4, 8), 4, -1),
    "shared_codebook": (dict(quantize_dropout_prob=0.5, shared_codebook=True), (4, 8), 3, -1),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_rvq_forward_train_matches_jax(case):
    over, (b, t), steps, force = FORWARD_CASES[case]
    kw = dict(num_quantizers=3, nb_code=16, code_dim=8, **over)
    jc, pc = JQ.RVQConfig(**kw), PQ.RVQConfig(**kw)
    g = np.random.default_rng(1)
    js, ps = JQ.init_rvq_state(jc), PQ.init_rvq_state(pc)
    assert not ps.initialized and float(ps.codebook.abs().sum()) == 0.0
    reset_seen = False
    for step in range(steps):
        x = g.standard_normal((b, t, 8)).astype(np.float32) * (1.0 + step)
        key = jax.random.PRNGKey(100 + step)
        jo = JQ.rvq_forward(jnp.asarray(x), js, jc, train=True, rng=key, force_dropout_index=force)
        xt = torch.as_tensor(x).requires_grad_(True)
        po = PQ.rvq_forward(xt, ps, pc, train=True, draws=jax_rvq_draws(key, jc, b * t), force_dropout_index=force)
        np.testing.assert_array_equal(po.indices.numpy(), np.asarray(jo.indices))
        close(po.quantized.detach().numpy(), jo.quantized)
        close(po.commit_loss.detach().numpy(), jo.commit_loss)
        close(po.perplexity.detach().numpy(), jo.perplexity)
        assert_state_close(po.state, jo.state)
        # dead codes (EMA count under 1) were reset from the batch
        reset_seen |= bool((np.asarray(jo.state.code_count) < 1.0).any())

        # straight-through: the gradient of a loss on the output and the commit
        # loss reaches the input through every active layer
        w = g.standard_normal((b, t, 8)).astype(np.float32)

        def jloss(xx):
            o = JQ.rvq_forward(xx, js, jc, train=True, rng=key, force_dropout_index=force)
            return jnp.sum(o.quantized * w) + o.commit_loss

        jgrad = jax.grad(jloss)(jnp.asarray(x))
        (pgrad,) = torch.autograd.grad((po.quantized * torch.as_tensor(w)).sum() + po.commit_loss, xt)
        close(pgrad.numpy(), jgrad)
        js, ps = jo.state, po.state
    assert reset_seen


def test_rvq_forward_eval_keeps_the_state():
    kw = dict(num_quantizers=2, nb_code=8, code_dim=4)
    jc, pc = JQ.RVQConfig(**kw), PQ.RVQConfig(**kw)
    g = np.random.default_rng(2)
    cb = g.standard_normal((2, 8, 4)).astype(np.float32)
    js = JQ.RVQState(codebook=jnp.asarray(cb), code_sum=jnp.asarray(cb), code_count=jnp.ones((2, 8)),
                     initialized=jnp.asarray(True))
    ps = PQ.RVQState(torch.as_tensor(cb), torch.as_tensor(cb), torch.ones(2, 8))
    x = g.standard_normal((2, 5, 4)).astype(np.float32)
    jo = JQ.rvq_forward(jnp.asarray(x), js, jc, train=False)
    po = PQ.rvq_forward(torch.as_tensor(x), ps, pc, train=False)
    np.testing.assert_array_equal(po.indices.numpy(), np.asarray(jo.indices))
    close(po.quantized.numpy(), jo.quantized)
    close(po.perplexity.numpy(), jo.perplexity)
    assert_state_close(po.state, jo.state)


def test_draw_rvq_draws_what_rvq_forward_needs():
    cfg = PQ.RVQConfig(num_quantizers=4, nb_code=16, code_dim=8, quantize_dropout_prob=0.5, quantize_dropout_cutoff=1)
    gen = torch.Generator().manual_seed(0)
    d = PQ.draw_rvq(cfg, 6, gen)
    assert [n.shape for n in d.init_noise] == [(16, 8)] * 4 and [n.shape for n in d.reset_noise] == [(16, 8)] * 4
    assert all(u.shape == (6, 16) and float(u.min()) >= 1e-20 and float(u.max()) < 1 for u in d.gumbel)
    lasts = []
    for _ in range(2000):
        d = PQ.draw_rvq(cfg, 16, gen)  # N >= K: no jitter is drawn
        assert d.init_noise == [None] * 4 and d.reset_noise == [None] * 4
        lasts.append(int(d.last_active))
    lasts = np.array(lasts)
    # dropping (p 0.5) starts at 1, 2 or 3; it cuts layers unless it starts at 3: 0.5 * 2/3
    assert set(lasts) == {1, 2, 3} and 0.30 < (lasts < 3).mean() < 0.37


# ---------------------------------------------------------------------------
# the RVQ-VAE train forward and its dropout
# ---------------------------------------------------------------------------

SMALL = dict(input_dim=12, width=16, output_emb_width=8, depth=2, dropout_rate=0.0)
Q_KW = dict(num_quantizers=3, nb_code=16, code_dim=8, quantize_dropout_prob=0.3)


def configs(**over):
    jc = JaxRVQVAEConfig(**{**SMALL, **over}, quantizer=JQ.RVQConfig(**Q_KW))
    pc = PR.RVQVAEConfig(**{**SMALL, **over}, quantizer=PQ.RVQConfig(**Q_KW))
    return jc, pc


def test_dropout_with_a_given_mask():
    h = torch.randn(2, 3, 5, generator=torch.Generator().manual_seed(0))
    mask = torch.rand(2, 3, 5, generator=torch.Generator().manual_seed(1)) < 0.8
    out = PR.dropout(h, 0.2, mask)
    np.testing.assert_allclose(out.numpy(), np.where(mask.numpy(), h.numpy() / 0.8, 0.0), rtol=1e-7)
    assert torch.equal(PR.dropout(h, 0.2, None), h)
    blk = PR.ResConv1DBlock(3, 1, dropout_rate=0.2)
    body = blk.conv_proj(torch.relu(blk.conv_dilated(torch.relu(h))))
    torch.testing.assert_close(blk(h, mask), h + torch.where(mask, body / 0.8, 0.0), rtol=0, atol=0)


def test_dropout_masks_keep_their_fraction():
    _, pc = configs(dropout_rate=0.2)
    d = PR.draw_rvqvae(pc, (8, 64, 12), torch.Generator().manual_seed(0))
    assert [tuple(m.shape) for m in d.dropout] == PR.dropout_mask_shapes(pc, 8, 64)
    assert [s[-1] for s in PR.dropout_mask_shapes(pc, 8, 64)] == [32, 32, 16, 16, 16, 16, 32, 32]
    keep = torch.cat([m.flatten() for m in d.dropout]).float().mean()
    assert abs(float(keep) - 0.8) < 0.01
    module = PR.RVQVAE(pc)
    module(torch.randn(8, 64, 12), PQ.init_rvq_state(pc.quantizer), train=True, draws=d)  # the shapes fit
    assert PR.draw_rvqvae(configs()[1], (8, 64, 12), torch.Generator()).dropout == [None] * 8


def test_rvqvae_train_forward_matches_jax():
    jc, pc = configs()
    key = jax.random.PRNGKey(3)
    jmod, params, jstate = create_rvqvae(jc, key, example_len=16)
    module = bridge.load_rvqvae(PR.RVQVAE(pc), params)
    x = np.random.default_rng(3).standard_normal((4, 16, 12)).astype(np.float32)
    kq = jax.random.PRNGKey(4)
    rec, out = jmod.apply({"params": params}, jnp.asarray(x), jstate, train=True, rng=kq)
    draws = PR.RVQVAEDraws([None] * 8, jax_rvq_draws(kq, jc.quantizer, 4 * 4))
    prec, pout = module(torch.as_tensor(x), PQ.init_rvq_state(pc.quantizer), train=True, draws=draws)
    close(prec.detach().numpy(), rec)
    np.testing.assert_array_equal(pout.indices.numpy(), np.asarray(out.indices))
    close(pout.commit_loss.detach().numpy(), out.commit_loss)
    assert_state_close(pout.state, out.state)
    # the eval path of the same module is unchanged by the train forward
    close(module.map2latent(torch.as_tensor(x)).detach().numpy(),
          jmod.apply({"params": params}, jnp.asarray(x), method="map2latent"))


# ---------------------------------------------------------------------------
# make_rvq_train_step
# ---------------------------------------------------------------------------


def build_pair(loss_kw=None, seed=5):
    jc, pc = configs()
    jmod, params, jq = create_rvqvae(jc, jax.random.PRNGKey(seed), example_len=16)
    jtx = JS.make_rvq_optimizer(lr=LR, warmup_iters=2)
    jstate = JS.create_train_state(params, jtx, jax.random.PRNGKey(seed + 1), quantizer_state=jq)
    module = bridge.load_rvqvae(PR.RVQVAE(pc), params)
    ptx = PO.make_rvq_optimizer(lr=LR, warmup_iters=2)
    pstate = PS.create_train_state(module, ptx, torch.Generator().manual_seed(0),
                                   quantizer_state=PQ.init_rvq_state(pc.quantizer))
    loss_kw = loss_kw or {}
    jstep = jax.jit(jax_rvq_step(jmod, jtx, JaxLossConfig(**loss_kw)))
    pstep = make_rvq_train_step(module, ptx, RVQLossConfig(**loss_kw))
    return jc, (jstep, jstate), (pstep, pstate)


def step_both(jc, jpair, ppair, batch):
    (jstep, jstate), (pstep, pstate) = jpair, ppair
    k_q = jax.random.split(jstate.rng, 3)[1]  # TrainState.next_rngs(2)'s first key
    draws = PR.RVQVAEDraws([None] * 8, jax_rvq_draws(k_q, jc.quantizer, batch.shape[0] * batch.shape[1] // 4))
    jstate, jm = jstep(jstate, jnp.asarray(batch))
    pstate, pm = pstep(pstate, torch.as_tensor(batch), draws=draws)
    return (jstep, jstate), (pstep, pstate), jm, pm


@pytest.mark.parametrize("steps,loss_kw", [(1, {}), (5, {}), (1, {"vel_weight": 0.5, "acc_weight": 0.25})],
                         ids=["one_step", "five_steps", "vel_acc"])
def test_rvq_train_step_matches_jax(steps, loss_kw):
    jc, jpair, ppair = build_pair(loss_kw)
    g = np.random.default_rng(6)
    for i in range(steps):
        batch = g.standard_normal((4, 16, 12)).astype(np.float32)
        jpair, ppair, jm, pm = step_both(jc, jpair, ppair, batch)
        assert set(pm) == set(jm)
        for k in jm:
            close(pm[k].numpy(), jm[k], msg=f"step {i} {k}")
        jstate, pstate = jpair[1], ppair[1]
        assert pstate.step == int(jstate.step) == i + 1
        assert_trees_close(pstate.layout.to_flax(pstate.params), jax.tree.map(np.asarray, jstate.params),
                           atol=1e-3 * LR)
        assert_trees_close(bridge.optax_state_to_flax(pstate.opt_state, pstate.layout), jax_opt_dict(jstate.opt_state),
                           atol=1e-3 * LR)
        assert_state_close(pstate.quantizer_state, jstate.quantizer_state)
