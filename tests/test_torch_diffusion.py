"""The port's schedule, DDPM/DDIM core and CFG combinators against the JAX
package on the CPU. The samplers run the same toy model function on both
sides and take JAX's own noise draws (``_rng_split`` / ``_rng_fold`` /
``_rng_normal``), since the port has no threefry chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu.diffusion import cfg as jcfg
from syntalker_tpu.diffusion import core as jcore
from syntalker_tpu.diffusion.schedule import make_diffusion as jax_make_diffusion
from syntalker_tpu.models.denoiser import Conditioning as JaxConditioning
from syntalker_tpu_torch.diffusion import cfg, core
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import Conditioning

SAMPLER_ABS = 1e-5
CFG_ABS = 1e-6
SCHEDULES = [dict(steps=1000, timestep_respacing="ddim50"), dict(steps=100, timestep_respacing="ddim4"),
             dict(steps=12)]
FIELDS = ("timestep_map", "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
          "posterior_variance", "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2")


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: f"{kw['steps']}-{kw.get('timestep_respacing')}")
def test_schedule_matches_jax_exactly(kw):
    port, ref = make_diffusion(**kw), jax_make_diffusion(**kw)
    assert port.num_steps == ref.num_steps
    for name in FIELDS:
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    t = np.array([0, port.num_steps // 2, port.num_steps - 1])
    for name in ("posterior_mean_coef1", "posterior_log_variance_clipped"):
        out = port.gather(name, torch.as_tensor(t))
        assert out.shape == (3, 1, 1) and out.dtype == torch.float32
        assert np.array_equal(out.numpy(), np.asarray(ref.gather(name, jnp.asarray(t))))


B, T, C = 2, 5, 6


def _toy(xp):
    """x0 = tanh(x·a + t/1000·b): the same function in numpy-like ``xp``."""
    g = np.random.default_rng(0)
    a, b = g.normal(size=(C, C)).astype(np.float32) * 0.5, g.normal(size=(C,)).astype(np.float32)

    def fn(x, t):
        t = (t.astype(xp.float32) if xp is jnp else t.float()).reshape(-1, 1, 1)
        return xp.tanh(x @ xp.asarray(a) + t / 1000.0 * xp.asarray(b))

    return fn


def _x(seed=1):
    return np.random.default_rng(seed).normal(size=(B, T, C)).astype(np.float32)


def test_q_sample_and_posterior_match_jax():
    port, ref = make_diffusion(steps=100, timestep_respacing="ddim4"), jax_make_diffusion(steps=100, timestep_respacing="ddim4")
    x0, noise, xt = _x(1), _x(2), _x(3)
    t = np.array([0, 3])
    tt = torch.as_tensor(t)
    pairs = [
        (core.q_sample(port, torch.as_tensor(x0), tt, torch.as_tensor(noise)),
         jcore.q_sample(ref, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))),
        (core.q_posterior_mean(port, torch.as_tensor(x0), torch.as_tensor(xt), tt),
         jcore.q_posterior_mean(ref, jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t))),
        (core.predict_eps_from_xstart(port, torch.as_tensor(xt), tt, torch.as_tensor(x0)),
         jcore.predict_eps_from_xstart(ref, jnp.asarray(xt), jnp.asarray(t), jnp.asarray(x0))),
    ]
    for out, want in pairs:
        assert np.abs(out.numpy() - np.asarray(want)).max() < SAMPLER_ABS


def _jax_noise(rng, steps):
    """The initial and per-step noise that JAX's samplers draw from ``rng``."""
    rng, k0 = jcore._rng_split(rng)
    init = np.asarray(jcore._rng_normal(k0, (B, T, C)))
    steps_noise = np.stack([np.asarray(jcore._rng_normal(jcore._rng_fold(rng, it), (B, T, C))) for it in range(steps)])
    return torch.as_tensor(init), torch.as_tensor(steps_noise)


@pytest.mark.parametrize("method,kw", [("ddim", {}), ("ddim", {"eta": 0.5}), ("ddpm", {}),
                                       ("ddpm", {"clip_denoised": True})], ids=["ddim", "ddim-eta", "ddpm", "ddpm-clip"])
@pytest.mark.parametrize("callable_noise", [False, True], ids=["tensor", "callable"])
def test_samplers_match_jax(method, kw, callable_noise):
    sched = dict(steps=100, timestep_respacing="ddim4") if method == "ddim" else dict(steps=12)
    port, ref = make_diffusion(**sched), jax_make_diffusion(**sched)
    rng = jax.random.PRNGKey(7)
    want = jcore.sample(ref, _toy(jnp), (B, T, C), rng, method=method, **kw)
    init, step = _jax_noise(rng, port.num_steps)
    step_noise = (lambda it: step[it]) if callable_noise else step
    out = core.sample(port, _toy(torch), init, method=method, step_noise=step_noise, **kw)
    assert np.abs(out.numpy() - np.asarray(want)).max() < SAMPLER_ABS


def test_stochastic_samplers_need_step_noise():
    with pytest.raises(ValueError, match="step_noise"):
        core.ddpm_sample(make_diffusion(steps=4), _toy(torch), torch.zeros(B, T, C), None)
    with pytest.raises(ValueError, match="step_noise"):
        core.ddim_sample(make_diffusion(steps=4), _toy(torch), torch.zeros(B, T, C), eta=1.0)
    # η = 0 reads none
    core.ddim_sample(make_diffusion(steps=4), _toy(torch), torch.zeros(B, T, C))


# ---------------------------------------------------------------------------
# CFG combinators

D = 1536  # the latent slices of the body parts


def _conds(k, seed=3):
    g = np.random.default_rng(seed)
    return [dict(at_feat=g.normal(size=(B, 4, 3)).astype(np.float32), seed_emb=g.normal(size=(B, 5)).astype(np.float32),
                 prompt_feat=g.normal(size=(B, 2)).astype(np.float32)) for _ in range(k)]


def _denoise(xp):
    """A denoise that reads every field of the conditioning and the step,
    with outputs below 1 so that 1e-6 is a few f32 ulps."""
    def fn(x, t, c):
        t = (t.astype(xp.float32) if xp is jnp else t.float()).reshape(-1, 1, 1)
        feat = c.at_feat.sum(-1).mean(-1) + c.seed_emb.sum(-1) + c.prompt_feat[:, 0]
        return 0.02 * xp.sin(x) * feat.reshape(-1, 1, 1) + t / 1e4
    return fn


def _as(conds, cls, conv):
    return [cls(**{k: conv(v) for k, v in c.items()}) for c in conds]


BODYPART = [{}, {"upper": 2}, {"hands": 2}, {"upper": 2, "lower": 3}, {"upper": 2, "hands": 3, "lower": 4}]


@pytest.mark.parametrize("kind", ["cfg", "two"] + [f"bodypart-{'+'.join(p) or 'none'}" for p in BODYPART])
def test_cfg_combinators_match_jax(kind):
    conds = _conds(5)
    jc = _as(conds, JaxConditioning, jnp.asarray)
    tc = _as(conds, Conditioning, torch.as_tensor)
    jd, td = _denoise(jnp), _denoise(torch)
    if kind == "cfg":
        jfn, tfn = jcfg.make_cfg_model_fn(jd, jc[0], jc[1], 2.5), cfg.make_cfg_model_fn(td, tc[0], tc[1], 2.5)
    elif kind == "two":
        jfn = jcfg.make_two_cfg_model_fn(jd, jc[0], jc[1], jc[2], 1.5, 4.0)
        tfn = cfg.make_two_cfg_model_fn(td, tc[0], tc[1], tc[2], 1.5, 4.0)
    else:
        parts = BODYPART[[f"bodypart-{'+'.join(p) or 'none'}" for p in BODYPART].index(kind)]
        jfn = jcfg.make_bodypart_cfg_model_fn(jd, jc[0], jc[1], {p: jc[i] for p, i in parts.items()},
                                              audio_scale=1.25, prompt_scale=4.0)
        tfn = cfg.make_bodypart_cfg_model_fn(td, tc[0], tc[1], {p: tc[i] for p, i in parts.items()},
                                             audio_scale=1.25, prompt_scale=4.0)
    x = np.random.default_rng(9).normal(size=(B, 4, D)).astype(np.float32)
    t = np.array([250, 250])
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(t)))
    out = tfn(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    assert out.shape == want.shape
    assert np.abs(out - want).max() < CFG_ABS


def test_stack_conditionings_keeps_absent_fields_absent():
    c = Conditioning(at_feat=torch.zeros(2, 3, 4), seed_emb=torch.ones(2, 5))
    s = cfg.stack_conditionings([c, c, c])
    assert s.at_feat.shape == (6, 3, 4) and s.seed_emb.shape == (6, 5)
    assert s.prompt_feat is None and s.style_feat is None
