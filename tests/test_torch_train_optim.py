"""The port's optimizers and schedules against optax: the nine names of
``make_optimizer`` (with and without a global-norm clip), the RVQ and
diffusion factories and the named schedules, five steps on a small tree of
parameters from the same numpy gradients. Parameters and optimizer state
are compared after each step; the tolerance is f32 rounding of the same
operations in another order (1e-5 relative, 1e-7 absolute), and the
schedules, evaluated in f32 by both, agree to 1e-6."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from syntalker_tpu.train import state as JS
from syntalker_tpu_torch.train import optim as PO
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

RTOL, ATOL = 1e-5, 1e-7
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}


def _tree(seed: int, scale: float = 1.0) -> dict:
    g = np.random.default_rng(seed)
    return {k: (g.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _leaves(state) -> list:
    """Every array of an optimizer state in traversal order (NamedTuple
    fields and chain entries in order, param trees by sorted key)."""
    if isinstance(state, dict):
        return [np.asarray(state[k]) for k in sorted(state)]
    if isinstance(state, tuple):
        return [x for s in state for x in _leaves(s)]
    return [np.asarray(state)]


def _run(jtx, ptx, steps: int = 5, grad_scale: float = 1.0):
    jp = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    pp = {k: torch.as_tensor(v).clone() for k, v in _tree(0).items()}
    js, ps = jtx.init(jp), ptx.init(pp)
    for i in range(steps):
        grads = _tree(10 + i, grad_scale)
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        pu, ps = ptx.update({k: torch.as_tensor(v) for k, v in grads.items()}, ps, pp)
        PO.apply_updates(pp, pu)
        for k in SHAPES:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=ATOL, err_msg=f"step {i} {k}")
        jl, pl = _leaves(js), _leaves(ps)
        assert len(jl) == len(pl)
        for a, b in zip(jl, pl):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f"step {i} state")


CASES = [(name, clip) for name in ("adam", "adamw", "sgd", "adabelief", "lamb", "radam", "adagrad", "rmsprop", "lion")
         for clip in (0.0, 0.5)]


@pytest.mark.parametrize("name,clip", CASES, ids=[f"{n}-clip{c}" for n, c in CASES])
def test_make_optimizer_matches_optax(name, clip):
    kw = dict(weight_decay=0.01, grad_clip=clip)
    # a large gradient scale makes the clip fire
    _run(JS.make_optimizer(name, 1e-2, **kw), PO.make_optimizer(name, 1e-2, **kw), grad_scale=3.0 if clip else 1.0)


@pytest.mark.parametrize("clip", (0.0, 0.5))
def test_make_rvq_optimizer_matches_optax(clip):
    kw = dict(lr=2e-2, warmup_iters=3, milestones=(2, 4), gamma=0.5, grad_clip=clip)
    _run(JS.make_rvq_optimizer(**kw), PO.make_rvq_optimizer(**kw), grad_scale=3.0)


@pytest.mark.parametrize("decay_steps", (0, 2))
def test_make_diffusion_optimizer_matches_optax(decay_steps):
    kw = dict(lr=1e-2, grad_clip=0.99, decay_steps=decay_steps, decay_rate=0.5)
    _run(JS.make_diffusion_optimizer(**kw), PO.make_diffusion_optimizer(**kw), grad_scale=2.0)


SCHEDULES = [("cosine", 0), ("cosine", 5), ("step", 0), ("step", 4), ("tanh", 0), ("tanh", 4), ("constant", 0),
             ("constant", 6)]


@pytest.mark.parametrize("name,warmup", SCHEDULES, ids=[f"{n}-warm{w}" for n, w in SCHEDULES])
def test_make_schedule_matches_optax(name, warmup):
    kw = dict(total_steps=30, warmup_steps=warmup, decay_steps=7, decay_rate=0.3, min_lr=1e-4)
    js, ps = JS.make_schedule(name, 0.1, **kw), PO.make_schedule(name, 0.1, **kw)
    for step in range(0, 40):
        np.testing.assert_allclose(ps(step), float(js(jnp.asarray(step))), rtol=1e-6, atol=1e-9, err_msg=str(step))


def test_optimizer_state_keeps_optax_layout():
    """Field names and chain nesting are optax's, so a state converts field
    by field (``bridge.optax_state_from_flax``)."""
    params = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    pparams = {k: torch.as_tensor(v) for k, v in _tree(0).items()}
    for name in ("adam", "adamw", "sgd", "adabelief", "lamb", "radam", "adagrad", "rmsprop", "lion"):
        js = JS.make_optimizer(name, 1e-3, grad_clip=1.0).init(params)
        ps = PO.make_optimizer(name, 1e-3, grad_clip=1.0).init(pparams)

        def fields(s):
            if hasattr(s, "_fields"):
                return (type(s).__name__.replace("AddDecayedWeightsState", "EmptyState"), s._fields,
                        tuple(fields(getattr(s, f)) for f in s._fields))
            if isinstance(s, tuple):
                return tuple(fields(x) for x in s)
            return "leaf"

        assert fields(ps) == fields(js), name


def test_radam_rectified_branch_matches_optax():
    """With b2 = 0.9 the variance estimate's degrees of freedom pass
    RAdam's threshold of 5 by the seventh step: the rectified update runs."""
    _run(JS.make_optimizer("radam", 1e-2, b2=0.9), PO.make_optimizer("radam", 1e-2, b2=0.9), steps=9)
