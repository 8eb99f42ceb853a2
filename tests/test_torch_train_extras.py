"""The port's secondary diffusion machinery and the TMR and MotionCLIP train
steps against JAX, f32 on the CPU.

``diffusion/extras.py``: PLMS (same initial noise), the inpainting
overwrite, the VB terms (normal KL, the discretized Gaussian
log-likelihood, bits per dim at t = 0 and t > 0), the timestep samplers
(shapes, range, importance weights; JAX's and the port's draws come from
different generators) and the parameter EMA. TMR: ``info_nce`` and three
``make_tmr_train_step`` steps; MotionCLIP: ``clip_alignment_loss`` and
three ``make_motionclip_train_step`` steps, with plain SGD (the
gradients) and with Adam.

Tolerances: 1e-5 relative (max error over max magnitude, f32), except:
PLMS 1e-4 (it divides by sqrt(alpha_bar), down to 0.016 at the first of
its 10 steps, so f32 rounding grows over the steps); the discretized
Gaussian likelihood and the bits per dim 1e-3 (a bin's probability is
the difference of two CDF values 2/255 apart, and XLA's and PyTorch's f32
tanh differ by an ulp, which the cancellation amplifies). Gradients (read
through SGD at a rate of 1e4) 1e-5 relative with a floor of 1e-6 of the
largest gradient: TMR's attention key bias has a gradient that is zero in
exact arithmetic (the softmax does not see it), f32 noise in both. Params
after Adam, where JAX's gradient exceeds 100·eps: 1e-5 relative plus
1e-3 of the rate; elsewhere Adam moves an element by at most the rate a
step whatever its gradient, and that bound is held."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from syntalker_tpu.diffusion import extras as JX
from syntalker_tpu.diffusion.schedule import make_diffusion as jax_make_diffusion
from syntalker_tpu.models import motionclip as JMC
from syntalker_tpu.models import tmr as JTMR
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.diffusion import extras as PX
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models import motionclip as PMC
from syntalker_tpu_torch.models import tmr as PTMR
from syntalker_tpu_torch.train import optim as PO

from test_torch_text import SMALL_TMR, _seq, perturbed
from test_torch_train_rvq import assert_trees_close, close
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

LR = 1e-3
SGD_LR = 1e4


def schedules():
    return jax_make_diffusion(steps=100, timestep_respacing="ddim10"), make_diffusion(steps=100,
                                                                                     timestep_respacing="ddim10")


def linear_model(w):
    """An x0 model that reads x_t and the original timestep, in both."""
    return (lambda x, t: jnp.tanh(x @ w) + t[:, None, None] * 1e-3,
            lambda x, t: torch.tanh(x @ torch.as_tensor(w)) + t[:, None, None] * 1e-3)


def test_plms_matches_jax():
    jd, pd = schedules()
    g = np.random.default_rng(0)
    w = g.normal(0, 0.5, (6, 6)).astype(np.float32)
    x = g.normal(size=(2, 5, 6)).astype(np.float32)
    jm, pm = linear_model(w)
    for clip in (False, True):
        ref = JX.plms_sample(jd, jm, x.shape, jax.random.PRNGKey(0), clip_denoised=clip, init_noise=jnp.asarray(x))
        close(PX.plms_sample(pd, pm, torch.as_tensor(x), clip_denoised=clip).numpy(), ref, rel=1e-4)


def test_inpainting_matches_jax():
    jd, pd = schedules()
    g = np.random.default_rng(1)
    w = g.normal(0, 0.5, (6, 6)).astype(np.float32)
    known = g.normal(size=(2, 5, 6)).astype(np.float32)
    mask = g.random((2, 5, 6)) < 0.5
    jm, pm = linear_model(w)
    x, t = g.normal(size=(2, 5, 6)).astype(np.float32), np.array([3, 700])
    ref = JX.inpainting_model_fn(jd, jm, jnp.asarray(known), jnp.asarray(mask))(jnp.asarray(x), jnp.asarray(t))
    got = PX.inpainting_model_fn(pd, pm, torch.as_tensor(known), torch.as_tensor(mask))(torch.as_tensor(x),
                                                                                         torch.as_tensor(t))
    close(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy()[mask], known[mask])


def test_vb_terms_match_jax():
    jd, pd = schedules()
    g = np.random.default_rng(2)
    a, b, c, d = (g.normal(size=(3, 4, 5)).astype(np.float32) for _ in range(4))
    close(PX.normal_kl(*map(torch.as_tensor, (a, b, c, d))).numpy(), JX.normal_kl(a, b, c, d))
    close(PX.approx_standard_normal_cdf(torch.as_tensor(a)).numpy(), JX.approx_standard_normal_cdf(jnp.asarray(a)))
    x = np.clip(g.normal(0, 0.7, (3, 4, 5)), -1, 1).astype(np.float32)
    x[0, 0, :2] = [-1.0, 1.0]  # the edge bins
    ref = JX.discretized_gaussian_log_likelihood(jnp.asarray(x), jnp.asarray(b), jnp.asarray(c) * 0.1)
    close(PX.discretized_gaussian_log_likelihood(torch.as_tensor(x), torch.as_tensor(b),
                                                 torch.as_tensor(c) * 0.1).numpy(), ref, rel=1e-3)
    w = g.normal(0, 0.5, (5, 5)).astype(np.float32)
    jm, pm = linear_model(w)
    t = np.array([0, 4, 9])
    ref = JX.vb_terms_bpd(jd, jm, jnp.asarray(x), jnp.asarray(a), jnp.asarray(t))
    close(PX.vb_terms_bpd(pd, pm, torch.as_tensor(x), torch.as_tensor(a), torch.as_tensor(t)).numpy(), ref, rel=1e-3)


def test_timestep_samplers():
    u = PX.UniformSampler(50)
    t, w = u.sample(torch.Generator().manual_seed(0), 1000)
    jt, jw = JX.UniformSampler(50).sample(jax.random.PRNGKey(0), 1000)
    assert t.shape == jt.shape and int(t.min()) >= 0 and int(t.max()) < 50 and torch.equal(w, torch.ones(1000))
    jr, pr = JX.LossSecondMomentResampler(6, history_per_term=3), PX.LossSecondMomentResampler(6, history_per_term=3)
    g = np.random.default_rng(3)
    for _ in range(30):
        ts, losses = g.integers(0, 6, 8), g.uniform(0, 2, 8) * (1 + np.arange(8) % 3)
        jr.update(ts, losses)
        pr.update(ts, losses)
    np.testing.assert_array_equal(pr.weights(), jr.weights())
    assert (pr._counts == 3).all() and not np.allclose(pr.weights(), pr.weights().mean())
    idx, iw = pr.sample(torch.Generator().manual_seed(1), 20000)
    p = pr.weights() / pr.weights().sum()
    freq = np.bincount(idx.numpy(), minlength=6) / 20000
    np.testing.assert_allclose(freq, p, atol=0.015)
    np.testing.assert_allclose(iw.numpy(), 1.0 / (6 * p[idx.numpy()]), rtol=1e-6)


def test_update_ema_matches_jax():
    g = np.random.default_rng(4)
    e, p = ({"a": g.normal(size=(3, 2)).astype(np.float32), "b": g.normal(size=4).astype(np.float32)} for _ in range(2))
    ref = JX.update_ema(e, p, rate=0.9)
    got = PX.update_ema({k: torch.as_tensor(v) for k, v in e.items()}, {k: torch.as_tensor(v) for k, v in p.items()},
                        rate=0.9)
    for k in e:
        close(got[k].numpy(), ref[k])


# ---------------------------------------------------------------------------
# TMR and MotionCLIP
# ---------------------------------------------------------------------------


def test_info_nce_matches_jax():
    g = np.random.default_rng(5)
    a, b = g.normal(size=(6, 8)).astype(np.float32), g.normal(size=(6, 8)).astype(np.float32)
    close(PTMR.info_nce(torch.as_tensor(a), torch.as_tensor(b)).numpy(), JTMR.info_nce(jnp.asarray(a), jnp.asarray(b)))
    close(PMC.clip_alignment_loss(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
          JMC.clip_alignment_loss(jnp.asarray(a), jnp.asarray(b)))


def run_steps(make_jstep, make_pstep, jparams, modules, batches, opt):
    """Steps of JAX's and the port's train step from the same params and
    batches; ``opt`` "grads" (SGD at SGD_LR) or "adam"."""
    layout = bridge.FlaxLayout(torch.nn.ModuleDict(modules))
    pparams = PTMR.train_params(modules)
    sgd = optax.sgd(SGD_LR)
    jtx, ptx = (sgd, PO.sgd(SGD_LR)) if opt == "grads" else (optax.adam(LR), PO.adam(LR))
    jstep, pstep, jgrad_step = jax.jit(make_jstep(jtx)), make_pstep(ptx), jax.jit(make_jstep(sgd))
    jopt, popt = jtx.init(jparams), ptx.init(pparams)

    def grads_at(p, b):
        p1 = jgrad_step(p, sgd.init(p), b)[0]
        return jax.tree.map(lambda a, c: (np.asarray(c, np.float64) - np.asarray(a)) / SGD_LR, p1, p)

    for i, (jb, pb) in enumerate(batches):
        p0 = jax.tree.map(np.asarray, jparams)
        g = grads_at(jparams, jb)
        jparams, jopt, jm = jstep(jparams, jopt, jb)
        pparams, popt, pm = pstep(pparams, popt, pb)
        for k in jm:
            close(pm[k].numpy(), jm[k], msg=f"step {i} {k}")
        got, ref = layout.to_flax(pparams), jax.tree.map(np.asarray, jparams)
        if opt == "grads":
            floor = 1e-6 * max(np.abs(x).max() for x in jax.tree.leaves(g))
            assert_trees_close(jax.tree.map(lambda a, b: (b.astype(np.float64) - a) / SGD_LR, got, p0), g, atol=floor)
            # each batch's gradients are taken at the same params
            jparams = jax.tree.map(jnp.asarray, p0)
            layout.load(torch.nn.ModuleDict(modules), p0)
            continue
        for (path, gl), a, b in zip(jax.tree_util.tree_leaves_with_path(g), jax.tree.leaves(got), jax.tree.leaves(ref)):
            sure = np.abs(gl) > 100 * 1e-8
            close(a[sure], b[sure], atol=1e-3 * LR, msg=f"step {i} {jax.tree_util.keystr(path)}")
            assert np.abs(a - b).max() <= 2 * LR * (i + 1) * (1 + 1e-5), (i, jax.tree_util.keystr(path))
        # the params stepped from the same values: re-sync the noise-driven elements
        layout.load(torch.nn.ModuleDict(modules), ref)
        popt = bridge.optax_state_from_flax(jax.tree.map(np.asarray, jopt), popt, layout)


@pytest.mark.parametrize("opt", ("grads", "adam"))
def test_tmr_train_step_matches_jax(opt):
    jcfg, pcfg = JTMR.TMRConfig(**SMALL_TMR), PTMR.TMRConfig(**SMALL_TMR)
    text, motion = JTMR.DistilbertTextEncoder(jcfg), JTMR.ActorAgnosticEncoder(jcfg, input_dim=jcfg.motion_feats)
    x, mask = _seq(4, 9, jcfg.text_feats, 0)
    m, mmask = _seq(4, 12, jcfg.motion_feats, 1)
    jparams = perturbed({"text": text.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))["params"],
                         "motion": motion.init(jax.random.PRNGKey(1), jnp.asarray(m))["params"]}, 2)
    np_params = jax.tree.map(np.asarray, jparams)
    ptext = bridge.load_tmr_text(PTMR.DistilbertTextEncoder(pcfg), np_params["text"])
    pmotion = bridge.load_actor_encoder(PTMR.ActorAgnosticEncoder(pcfg, pcfg.motion_feats), np_params["motion"])
    batches = []
    for s in range(3):
        x, mask = _seq(4, 9, jcfg.text_feats, 10 + s)
        m, mmask = _seq(4, 12, jcfg.motion_feats, 20 + s)
        jb = {"text_hidden": jnp.asarray(x), "text_mask": jnp.asarray(mask), "motion": jnp.asarray(m),
              "motion_mask": jnp.asarray(mmask)}
        batches.append((jb, {k: torch.as_tensor(np.asarray(v)) for k, v in jb.items()}))
    run_steps(lambda tx: (lambda p, o, b, _s=JTMR.make_tmr_train_step(text, motion, tx): _s(p, o, b, None)),
              lambda tx: PTMR.make_tmr_train_step(ptext, pmotion, tx), jparams, {"text": ptext, "motion": pmotion},
              batches, opt)


SMALL_MC = dict(clip_dim=16, latent_dim=32, ff_size=48, num_layers=4, num_heads=4, input_feats=12)


@pytest.mark.parametrize("opt", ("grads", "adam"))
def test_motionclip_train_step_matches_jax(opt):
    jcfg, pcfg = JMC.MotionCLIPConfig(**SMALL_MC), PMC.MotionCLIPConfig(**SMALL_MC)
    enc, dec = JMC.MotionCLIP(jcfg), JMC.MotionCLIPDecoder(jcfg, num_frames=10)
    g = np.random.default_rng(6)
    motion = g.normal(size=(3, 10, 12)).astype(np.float32)
    jparams = {"enc": enc.init(jax.random.PRNGKey(0), jnp.asarray(motion))["params"],
               "dec": dec.init(jax.random.PRNGKey(1), jnp.zeros((3, 16)))["params"]}
    jparams = perturbed(jparams, 3)
    np_params = jax.tree.map(np.asarray, jparams)
    penc = bridge.load_motionclip(PMC.MotionCLIP(pcfg), np_params["enc"])
    pdec = bridge.load_motionclip_decoder(PMC.MotionCLIPDecoder(pcfg, num_frames=10), np_params["dec"])
    lambdas = {"rc": 1.0, "vel": 0.5, "clip": 2.0}
    batches = []
    for s in range(3):
        jb = {"motion": jnp.asarray(g.normal(size=(3, 10, 12)).astype(np.float32)),
              "clip_emb": jnp.asarray(g.normal(size=(3, 16)).astype(np.float32))}
        batches.append((jb, {k: torch.as_tensor(np.asarray(v)) for k, v in jb.items()}))
    run_steps(lambda tx: JMC.make_motionclip_train_step(enc, dec, tx, lambdas),
              lambda tx: PMC.make_motionclip_train_step(penc, pdec, tx, lambdas), jparams, {"enc": penc, "dec": pdec},
              batches, opt)


def test_train_params_are_the_modules_own():
    head = PTMR.DistilbertTextEncoder(PTMR.TMRConfig(**SMALL_TMR)).requires_grad_(False)
    params = PTMR.train_params({"text": head})
    assert all(p.requires_grad for p in params.values())
    assert params["text.projection.weight"] is head.projection.weight
