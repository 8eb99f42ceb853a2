"""The prompted body-part CFG path on the CPU: the port's ``sample_windows``
(K2's plain version, f32 weights) against JAX ``sample_windows`` with 1, 2
and 3 prompted parts, a style and DDPM, fed JAX's own noise; the unprompted
K1/K2 samplers of a ``use_prompt`` model against JAX ``sample_windows_lean``,
which, like the JAX service's fast path, reads no prompt; and the prompted
service against an offline replication of its groups."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu import generation as JG
from syntalker_tpu.diffusion.core import _rng_fold, _rng_normal, _rng_split
from syntalker_tpu.diffusion.schedule import make_diffusion as jax_make_diffusion
from syntalker_tpu.models.denoiser import create_mdm
from syntalker_tpu_torch import bridge, generation
from syntalker_tpu_torch.data import audio as A
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import MDMConfig
from syntalker_tpu_torch.ops import mdm_cuda
from syntalker_tpu_torch.serving import MotionRequest

from test_torch_generation import ABS
from test_torch_generation import JAX_CFG as BASE_CFG
from test_torch_generation import _service as service_on_cpu
from test_torch_prompted import perturb
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

P = S = 8  # prompt and style widths
JAX_CFG = dataclasses.replace(BASE_CFG, use_prompt=True, prompt_dim=P, use_motionclip=True, style_dim=S,
                              audio_norm="batch")
CFG = MDMConfig(**{f.name: getattr(JAX_CFG, f.name) for f in dataclasses.fields(MDMConfig)})
STEPS = 8
GUIDANCE = {"audio_scale": 1.0, "prompt_scale": 4.0}


@pytest.fixture(scope="module")
def setup():
    mdm, variables = create_mdm(JAX_CFG, jax.random.PRNGKey(0), frames=128)
    variables = perturb(variables, seed=5)
    plan = JG.plan_windows(240)  # 2 windows: exercises the seed carry
    b = 2
    g = np.random.default_rng(3)
    audio = g.normal(0, 0.1, (b, 533 * 240, 2)).astype(np.float32)
    words = g.integers(0, JAX_CFG.vocab_size, (b, 240)).astype(np.int32)
    data = dict(aw=JG.window_audio(audio, plan), ww=JG.window_words(words, plan),
                seed=g.normal(size=(b, plan.pre_frames, 1536)).astype(np.float32),
                prompts={p: g.normal(size=(b, P)).astype(np.float32) for p in ("upper", "hands", "lower")},
                style=g.normal(size=(b, S)).astype(np.float32))
    tmdm = bridge.mdm_from_flax(CFG, variables, device="cpu")
    return mdm, variables, tmdm, plan, data


def jax_noise(key, plan, b, steps):
    """The initial and per-step noise of each window that JAX's
    ``sample_windows`` draws from ``key``: key -> k_samp per window, then
    k_samp -> (rng, k0) inside the sampler."""
    shape = (b, plan.latent_window, 1536)
    init, per_step = [], []
    for _ in range(plan.num_windows):
        key, k_samp = _rng_split(key)
        rng, k0 = _rng_split(k_samp)
        init.append(np.asarray(_rng_normal(k0, shape)))
        per_step.append([np.asarray(_rng_normal(_rng_fold(rng, it), shape)) for it in range(steps)])
    return torch.as_tensor(np.stack(init)), torch.as_tensor(np.array(per_step, np.float32))


CASES = {  # name -> (sampler, prompted parts, style)
    "upper": ("ddim", ("upper",), False),
    "hands+lower": ("ddim", ("hands", "lower"), False),
    "all-parts": ("ddim", ("upper", "hands", "lower"), False),
    "style-only": ("ddim", (), True),
    "hands+style": ("ddim", ("hands",), True),
    "ddpm-upper+lower": ("ddpm", ("upper", "lower"), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sample_windows_matches_jax(setup, case):
    mdm, variables, tmdm, plan, d = setup
    sampler, parts, styled = CASES[case]
    key = jax.random.PRNGKey(11)
    prompts = {p: d["prompts"][p] for p in parts} or None
    style = d["style"] if styled else None
    ref = JG.sample_windows(mdm, variables, jax_make_diffusion(steps=STEPS), plan, jnp.asarray(d["aw"]),
                            jnp.asarray(d["ww"]), jnp.asarray(d["seed"]), key, sampler=sampler,
                            prompts=None if prompts is None else {p: jnp.asarray(v) for p, v in prompts.items()},
                            guidance=GUIDANCE, style=None if style is None else jnp.asarray(style))
    init, per_step = jax_noise(key, plan, 2, STEPS)
    denoise = mdm_cuda.make_fused_denoise(tmdm, mdm_cuda.stack_block_weights(tmdm, torch.float32))

    def run(step_noise):
        return generation.sample_windows(
            tmdm, make_diffusion(steps=STEPS), generation.plan_windows(240), torch.as_tensor(d["aw"]),
            torch.as_tensor(d["ww"]).long(), torch.as_tensor(d["seed"]), init, sampler=sampler, step_noise=step_noise,
            prompts=None if prompts is None else {p: torch.as_tensor(v) for p, v in prompts.items()},
            guidance=GUIDANCE, style=None if style is None else torch.as_tensor(style), denoise=denoise)

    out = run(per_step)
    assert out.shape == ref.shape == (2, plan.out_latent_frames, 1536)
    assert np.abs(out.numpy() - np.asarray(ref)).max() < ABS
    if sampler == "ddpm":  # the per-step noise as a callable (w, it) reads the same draws
        assert torch.equal(run(lambda w, it: per_step[w, it]), out)


@pytest.fixture(scope="module")
def lean(setup):
    """JAX's lean sampler on the use_prompt model, and the port's inputs with
    the noise of the same key chain."""
    mdm, variables, tmdm, plan, d = setup
    key = jax.random.PRNGKey(12)
    args = (jnp.asarray(d["aw"]), jnp.asarray(d["ww"]), jnp.asarray(d["seed"]), key)
    ref = np.asarray(JG.sample_windows_lean(mdm, variables, jax_make_diffusion(steps=STEPS), plan, *args))
    general = np.asarray(JG.sample_windows(mdm, variables, jax_make_diffusion(steps=STEPS), plan, *args,
                                           sampler="ddim"))
    init, _ = jax_noise(key, plan, 2, 0)
    port = (torch.as_tensor(d["aw"]), torch.as_tensor(d["ww"]).long(), torch.as_tensor(d["seed"]), init)
    return ref, general, port


@pytest.mark.parametrize("route", ["lean", "k1", "k2", "sample_windows"])
def test_unprompted_routes_of_a_prompt_model(setup, lean, route):
    """The JAX service's fast path (lean or fused) skips input_process3, and
    ``sample_windows(prompts=None)`` applies it with the null prompt: the
    two differ, and each route of the port matches its JAX counterpart."""
    _, _, tmdm, _, _ = setup
    ref, general, (aw, ww, seed, noise) = lean
    assert np.abs(ref - general).max() > 100 * ABS  # the two semantics are told apart
    diffusion, plan = make_diffusion(steps=STEPS), generation.plan_windows(240)
    if route == "lean":
        out = generation.sample_windows_lean(tmdm, diffusion, plan, aw, ww, seed, noise)
    elif route == "k1":
        out = generation.make_fused_loop_sampler(tmdm, diffusion, plan, weights_dtype=torch.float32)(aw, ww, seed, noise)
    elif route == "k2":
        out = generation.sample_windows_fused(tmdm, diffusion, plan, aw, ww, seed, noise,
                                              weights=mdm_cuda.stack_block_weights(tmdm, torch.float32))
    else:
        denoise = mdm_cuda.make_fused_denoise(tmdm, mdm_cuda.stack_block_weights(tmdm, torch.float32))
        out = generation.sample_windows(tmdm, diffusion, plan, aw, ww, seed, noise, sampler="ddim", denoise=denoise)
        ref = general
    assert np.abs(out.numpy() - ref).max() < ABS


# ---------------------------------------------------------------------------
# the prompted service on the CPU


def _service(tmdm, seed=3):
    return service_on_cpu(True, mdm=tmdm, seed=seed)


def _mixed_requests():
    """One unprompted request, two with an upper prompt, one with hands and
    lower prompts and a style: three groups."""
    g = np.random.default_rng(5)

    def wav(secs):
        return g.normal(0, 0.1, int(16000 * secs)).astype(np.float32)

    def vec(n):
        return g.normal(size=n).astype(np.float32)

    return [
        MotionRequest(audio=wav(2), words=g.integers(0, CFG.vocab_size, 60), request_id="plain"),
        MotionRequest(audio=wav(3), request_id="up0", prompts={"upper": vec(P)}),
        MotionRequest(audio=wav(1.5), request_id="up1", prompts={"upper": vec(P)}),
        MotionRequest(audio=wav(2.5), request_id="hl", prompts={"hands": vec(P), "lower": vec(P), "upper": None},
                      guidance={"audio_scale": 1.5, "prompt_scale": 3.0}, style=vec(S)),
    ]


def test_prompted_service_matches_offline_sampler(setup):
    _, _, tmdm, _, _ = setup
    svc = _service(tmdm)
    reqs = _mixed_requests()
    events = [svc.submit(r) for r in reqs]
    results = svc.flush()
    assert all(e.is_set() for e in events)
    # group order: the fast path's group first, then each prompt configuration as it first arrived
    assert [r.request_id for r in results] == ["plain", "up0", "up1", "hl"]
    for r in results:
        assert r.axis_angle.shape == (128, 165) and r.trans.shape == (128, 3)
        assert np.isfinite(r.axis_angle).all() and np.isfinite(r.trans).all()

    # offline: the same generator, one noise draw per group in flush order
    gen = torch.Generator().manual_seed(3)
    plan = svc.plan
    noises = [generation.draw_noise(plan, 4, gen, "cpu") for _ in range(3)]
    denoise = mdm_cuda.make_fused_denoise(tmdm, mdm_cuda.stack_block_weights(tmdm))

    def inputs(group):
        feats = []
        for r in group + [None] * (4 - len(group)):
            y = np.zeros(svc.samples, np.float32)
            if r is not None:
                y[: min(len(r.audio), svc.samples)] = r.audio[: svc.samples]
            feats.append(A.onset_amplitude_features(y, 16000))
        aw = torch.as_tensor(generation.window_audio(np.stack(feats), plan))
        ww = torch.zeros(plan.num_windows, 4, plan.pose_length, dtype=torch.long)
        return aw, ww, torch.zeros(4, plan.pre_frames, 1536)

    def rows(vectors):
        return torch.as_tensor(np.stack(vectors + [np.zeros_like(vectors[0])] * (4 - len(vectors))))

    for group, noise, kw in (
        (reqs[1:3], noises[1], dict(prompts={"upper": rows([reqs[1].prompts["upper"], reqs[2].prompts["upper"]])},
                                    guidance=GUIDANCE)),
        (reqs[3:], noises[2], dict(prompts={p: rows([reqs[3].prompts[p]]) for p in ("hands", "lower")},
                                   guidance={"audio_scale": 1.5, "prompt_scale": 3.0}, style=rows([reqs[3].style]))),
    ):
        lat = generation.sample_windows(tmdm, svc.diffusion, plan, *inputs(group), noise, sampler="ddim",
                                        denoise=denoise, **kw)
        dec = generation.decode_latents(lat, rvq_modules=svc.rvq_modules, stats=svc.stats)
        for i, r in enumerate(group):
            np.testing.assert_allclose(svc.results[r.request_id].axis_angle, dec["axis_angle"][i].numpy(),
                                       rtol=1e-4, atol=1e-5)


def test_prompt_and_style_change_the_output(setup):
    _, _, tmdm, _, _ = setup
    outs = []
    for prompts, style in ((None, None), ({"hands": np.ones(P, np.float32)}, None), (None, np.ones(S, np.float32))):
        svc = _service(tmdm, seed=4)
        svc.submit(MotionRequest(audio=np.zeros(16000 * 2, np.float32), request_id="r", prompts=prompts, style=style))
        outs.append(svc.flush()[0].axis_angle)
    assert np.abs(outs[0] - outs[1]).max() > 1e-4
    assert np.abs(outs[0] - outs[2]).max() > 1e-4


@pytest.mark.parametrize("bad", ["part", "width", "style"])
def test_service_refuses_malformed_prompts(setup, bad):
    _, _, tmdm, _, _ = setup
    svc = _service(tmdm)
    kw = {"part": dict(prompts={"face": np.zeros(P, np.float32)}),
          "width": dict(prompts={"upper": np.zeros(P + 1, np.float32)}),
          "style": dict(style=np.zeros(S - 1, np.float32))}[bad]
    with pytest.raises(ValueError):
        svc.submit(MotionRequest(audio=np.zeros(16000, np.float32), **kw))
    assert svc.flush() == []
