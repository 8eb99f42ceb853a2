"""Optimizers and learning-rate schedules with optax's update rules.

Counterpart of ``make_schedule``, ``make_optimizer``, ``make_rvq_optimizer``
and ``make_diffusion_optimizer`` in ``syntalker_tpu/train/state.py``, which
build optax transformations. The port writes each optax transformation it
needs as a pair of functions over dicts of tensors (parameter name ->
tensor): ``init(params) -> state`` and ``update(grads, state, params) ->
(updates, state)``; :func:`apply_updates` adds the updates in place. The
state keeps optax's layout: a chain's state is the tuple of its members',
each member's a NamedTuple with optax's fields (``count``, ``mu``, ``nu``,
``trace``, ``sum_of_squares``...), each moment a dict keyed like the
parameters, each count an int32 0-d tensor on the host. So a state
round-trips through a checkpoint under optax's names, and
:func:`syntalker_tpu_torch.bridge.optax_state_from_flax` reads JAX's.

``torch.optim`` is not used: its rules differ from optax's where the
trainers are sensitive to them (``clip_grad_norm_`` adds 1e-6 to the
norm; AdamW decays before its step and scales the decay by the learning
rate; Adagrad starts its accumulator at 0, optax at 0.1; RMSprop's decay
is 0.99, optax's 0.9; AdaBelief's ``eps_root``, RAdam's threshold and
LAMB's trust ratio have no torch counterpart).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]
ScalarOrSchedule = Union[float, Schedule]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Params
    nu: Params


class ScaleByBeliefState(NamedTuple):
    count: torch.Tensor
    mu: Params
    nu: Params


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class TraceState(NamedTuple):
    trace: Params


class ScaleByRssState(NamedTuple):
    sum_of_squares: Params


class ScaleByRmsState(NamedTuple):
    nu: Params


class ScaleByLionState(NamedTuple):
    count: torch.Tensor
    mu: Params


def _count() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def _full_like(params: Params, value: float) -> Params:
    return {k: torch.full_like(p, value) for k, p in params.items()}


def _map(fn, *trees: Params) -> Params:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def _moment(g: Params, m: Params, decay: float, order: int) -> Params:
    """(1 - decay)·g^order + decay·m, as optax's ``update_moment``."""
    return _map(lambda a, b: (1 - decay) * (a * a if order == 2 else a) + decay * b, g, m)


def _bias_correction(m: Params, decay: float, count: int) -> Params:
    """m / (1 - decay^count), the power taken in f32 as JAX takes it."""
    bc = float(np.float32(1) - np.power(np.float32(decay), np.float32(count)))
    return _map(lambda a: a / bc, m)


def _empty(params) -> EmptyState:
    return EmptyState()


def identity() -> GradientTransformation:
    return GradientTransformation(_empty, lambda u, s, p=None: (u, s))


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """Apply transformations in order; the state is the tuple of theirs."""

    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tree.values()))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every update by max_norm / ‖g‖ when the global norm ‖g‖
    reaches max_norm (no epsilon in the norm, unlike ``clip_grad_norm_``)."""

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return _map(lambda t: torch.where(trigger, t, (t / g_norm) * max_norm), updates), state

    return GradientTransformation(_empty, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0):
    def init(params):
        return ScaleByAdamState(_count(), _full_like(params, 0.0), _full_like(params, 0.0))

    def update(updates, state, params=None):
        mu, nu = _moment(updates, state.mu, b1, 1), _moment(updates, state.nu, b2, 2)
        count = state.count + 1
        mu_hat, nu_hat = _bias_correction(mu, b1, int(count)), _bias_correction(nu, b2, int(count))
        return _map(lambda m, v: m / (torch.sqrt(v + eps_root) + eps), mu_hat, nu_hat), ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def scale_by_belief(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-16, eps_root: float = 1e-16):
    """AdaBelief: the second moment of the prediction error g - mu, with
    ``eps_root`` added to it before the bias correction."""

    def init(params):
        return ScaleByBeliefState(_count(), _full_like(params, 0.0), _full_like(params, 0.0))

    def update(updates, state, params=None):
        mu = _moment(updates, state.mu, b1, 1)
        nu = _moment(_map(torch.sub, updates, mu), state.nu, b2, 2)
        nu = _map(lambda v: v + eps_root, nu)
        count = state.count + 1
        mu_hat, nu_hat = _bias_correction(mu, b1, int(count)), _bias_correction(nu, b2, int(count))
        return _map(lambda m, v: m / (torch.sqrt(v) + eps), mu_hat, nu_hat), ScaleByBeliefState(count, mu, nu)

    return GradientTransformation(init, update)


def scale_by_radam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                   threshold: float = 5.0):
    """RAdam: the rectified Adam step once the variance estimate's degrees
    of freedom ro reach ``threshold``, the bias-corrected momentum before."""
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def init(params):
        return ScaleByAdamState(_count(), _full_like(params, 0.0), _full_like(params, 0.0))

    def update(updates, state, params=None):
        mu, nu = _moment(updates, state.mu, b1, 1), _moment(updates, state.nu, b2, 2)
        count = state.count + 1
        c = np.float32(int(count))
        b2t = np.power(np.float32(b2), c)
        ro = np.float32(ro_inf) - np.float32(2) * c * b2t / (np.float32(1) - b2t)
        mu_hat, nu_hat = _bias_correction(mu, b1, int(count)), _bias_correction(nu, b2, int(count))
        if ro >= threshold:
            r = float(np.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro),
                              dtype=np.float32))
            out = _map(lambda m, v: r * m / (torch.sqrt(v + eps_root) + eps), mu_hat, nu_hat)
        else:
            out = mu_hat
        return out, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1, eps: float = 1e-7):
    """Adagrad: g / sqrt(Σg² + eps), the sum starting at 0.1."""

    def init(params):
        return ScaleByRssState(_full_like(params, initial_accumulator_value))

    def update(updates, state, params=None):
        ss = _map(lambda g, t: g * g + t, updates, state.sum_of_squares)
        inv = _map(lambda t: torch.where(t > 0, torch.rsqrt(t + eps), 0.0), ss)
        return _map(torch.mul, inv, updates), ScaleByRssState(ss)

    return GradientTransformation(init, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8, initial_scale: float = 0.0):
    def init(params):
        return ScaleByRmsState(_full_like(params, initial_scale))

    def update(updates, state, params=None):
        nu = _moment(updates, state.nu, decay, 2)
        return _map(lambda n, g: torch.rsqrt(n + eps) * g, nu, updates), ScaleByRmsState(nu)

    return GradientTransformation(init, update)


def scale_by_lion(b1: float = 0.9, b2: float = 0.99):
    def init(params):
        return ScaleByLionState(_count(), _full_like(params, 0.0))

    def update(updates, state, params=None):
        out = _map(lambda g, m: torch.sign((1.0 - b1) * g + b1 * m), updates, state.mu)
        return out, ScaleByLionState(state.count + 1, _moment(updates, state.mu, b2, 1))

    return GradientTransformation(init, update)


def scale_by_trust_ratio():
    """LAMB's layer-wise trust ratio ‖p‖ / ‖u‖, 1 where either norm is 0."""

    def update(updates, state, params):
        def one(u, p):
            pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
            return u * ratio

        return _map(one, updates, params), state

    return GradientTransformation(_empty, update)


def add_decayed_weights(weight_decay: float = 0.0):
    """u + weight_decay·p, after the step's scaling and before the
    learning rate (optax's AdamW order)."""

    def update(updates, state, params):
        return _map(lambda u, p: u + weight_decay * p, updates, params), state

    return GradientTransformation(_empty, update)


def trace(decay: float, nesterov: bool = False):
    """Momentum: t <- g + decay·t; Nesterov returns g + decay·t."""

    def init(params):
        return TraceState(_full_like(params, 0.0))

    def update(updates, state, params=None):
        new = _map(lambda g, t: g + decay * t, updates, state.trace)
        out = _map(lambda g, t: g + decay * t, updates, new) if nesterov else new
        return out, TraceState(new)

    return GradientTransformation(init, update)


def scale_by_learning_rate(lr: ScalarOrSchedule):
    """Multiply by -lr; a schedule is read at the count before this step."""
    if callable(lr):
        def init(params):
            return ScaleByScheduleState(_count())

        def update(updates, state, params=None):
            step = -lr(int(state.count))
            return _map(lambda g: step * g, updates), ScaleByScheduleState(state.count + 1)

        return GradientTransformation(init, update)
    return GradientTransformation(_empty, lambda u, s, p=None: (_map(lambda g: -lr * g, u), s))


def adam(lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    return chain(scale_by_adam(b1, b2, eps, eps_root), scale_by_learning_rate(lr))


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4):
    return chain(scale_by_adam(b1, b2, eps, eps_root), add_decayed_weights(weight_decay), scale_by_learning_rate(lr))


def sgd(lr, momentum: Optional[float] = None, nesterov: bool = False):
    return chain(trace(momentum, nesterov) if momentum is not None else identity(), scale_by_learning_rate(lr))


def adabelief(lr, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16):
    return chain(scale_by_belief(b1, b2, eps, eps_root), scale_by_learning_rate(lr))


def lamb(lr, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0):
    return chain(scale_by_adam(b1, b2, eps, eps_root), add_decayed_weights(weight_decay), scale_by_trust_ratio(),
                 scale_by_learning_rate(lr))


def radam(lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0):
    return chain(scale_by_radam(b1, b2, eps, eps_root, threshold), scale_by_learning_rate(lr))


def adagrad(lr, initial_accumulator_value=0.1, eps=1e-7):
    return chain(scale_by_rss(initial_accumulator_value, eps), scale_by_learning_rate(lr))


def rmsprop(lr, decay=0.9, eps=1e-8, initial_scale=0.0, momentum: Optional[float] = None, nesterov=False):
    """optax's order: the learning rate, then the momentum trace."""
    return chain(scale_by_rms(decay, eps, initial_scale), scale_by_learning_rate(lr),
                 trace(momentum, nesterov) if momentum is not None else identity())


def lion(lr, b1=0.9, b2=0.99, weight_decay=1e-3):
    return chain(scale_by_lion(b1, b2), add_decayed_weights(weight_decay), scale_by_learning_rate(lr))


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """p <- p + u in place; returns ``params``."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))
    return params


# ---------------------------------------------------------------------------
# schedules: host floats of the step count, computed in f32 as JAX computes them
# ---------------------------------------------------------------------------

_F = np.float32


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        frac = _F(1) - _F(min(max(count, 0), transition_steps) / transition_steps)
        return float((_F(init_value) - _F(end_value)) * frac + _F(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if decay_steps <= 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        cosine = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * _F(min(count, decay_steps)) / _F(decay_steps)))
        return float(_F(init_value) * ((_F(1) - _F(alpha)) * cosine + _F(alpha)))

    return schedule


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      staircase: bool = False) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)

    def schedule(count):
        p = _F(count / transition_steps)
        if staircase:
            p = np.floor(p)
        return init_value if count <= 0 else float(_F(init_value) * np.power(_F(decay_rate), p))

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(count):
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules([linear_schedule(init_value, peak_value, warmup_steps),
                           cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)], [warmup_steps])


def make_schedule(name: str, lr: float, *, total_steps: int = 100_000, warmup_steps: int = 0, decay_steps: int = 0,
                  decay_rate: float = 0.1, min_lr: float = 1e-6) -> Schedule:
    """Named schedules: cosine (with its own warmup), step, tanh (the
    cosine shape, as in JAX) and constant; a linear warmup joins the
    others."""
    if name == "cosine":
        sched = warmup_cosine_decay_schedule(0.0 if warmup_steps else lr, lr, warmup_steps, total_steps, min_lr)
    elif name == "step":
        sched = exponential_decay(lr, max(decay_steps, 1), decay_rate, staircase=True)
    elif name == "tanh":
        sched = cosine_decay_schedule(lr, total_steps, alpha=min_lr / lr)
    elif name == "constant":
        sched = constant_schedule(lr)
    else:
        raise ValueError(f"unknown schedule '{name}'")
    if warmup_steps and name != "cosine":
        sched = join_schedules([linear_schedule(0.0, lr, warmup_steps), sched], [warmup_steps])
    return sched


def make_optimizer(name: str, lr: ScalarOrSchedule, *, weight_decay: float = 0.0, grad_clip: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999, momentum: float = 0.9) -> GradientTransformation:
    """Named optimizers with optax's defaults; ``grad_clip`` > 0 chains a
    global-norm clip in front."""
    opts = {
        "adam": lambda: adam(lr, b1=b1, b2=b2),
        "adamw": lambda: adamw(lr, b1=b1, b2=b2, weight_decay=weight_decay),
        "sgd": lambda: sgd(lr, momentum=momentum, nesterov=True),
        "adabelief": lambda: adabelief(lr, b1=b1, b2=b2),
        "lamb": lambda: lamb(lr, b1=b1, b2=b2, weight_decay=weight_decay),
        "radam": lambda: radam(lr, b1=b1, b2=b2),
        "adagrad": lambda: adagrad(lr),
        "rmsprop": lambda: rmsprop(lr, momentum=momentum),
        "lion": lambda: lion(lr, weight_decay=weight_decay),
    }
    if name not in opts:
        raise ValueError(f"unknown optimizer '{name}'; available: {sorted(opts)}")
    tx = opts[name]()
    if grad_clip > 0:
        tx = chain(clip_by_global_norm(grad_clip), tx)
    return tx


def make_rvq_optimizer(lr: float = 2e-4, warmup_iters: int = 1000, milestones: tuple = (150_000, 250_000),
                       gamma: float = 0.1, grad_clip: float = 0.0) -> GradientTransformation:
    """AdamW(β = 0.9, 0.99, no decay) under a linear warmup and a
    multi-step decay by ``gamma`` at each milestone."""

    def schedule(step):
        decay = _F(1)
        for m in milestones:
            decay = decay * _F(gamma if step >= m else 1.0)
        return float(_F(lr) * min(_F(step / max(warmup_iters, 1)), _F(1)) * decay)

    tx = adamw(schedule, b1=0.9, b2=0.99, weight_decay=0.0)
    if grad_clip > 0:
        tx = chain(clip_by_global_norm(grad_clip), tx)
    return tx


def make_diffusion_optimizer(lr: float = 5e-5, grad_clip: float = 0.99, decay_steps: int = 0,
                             decay_rate: float = 0.1) -> GradientTransformation:
    """Adam behind a global-norm clip (0.99), with an optional step decay."""
    schedule = exponential_decay(lr, decay_steps, decay_rate, staircase=True) if decay_steps > 0 else lr
    return chain(clip_by_global_norm(grad_clip), adam(schedule))
