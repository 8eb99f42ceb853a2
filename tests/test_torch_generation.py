"""The port's unprompted samplers and service on the CPU. The plain
reference sampler, fed the initial noise of JAX's key chain, against
``sample_windows_lean``; the K1 and K2 samplers (their plain versions, f32
weights) against the same; the service answering requests on
``device="cpu"``. The prompted path: tests/test_torch_prompted_sampling.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu import generation as JG
from syntalker_tpu.diffusion.core import _rng_normal, _rng_split
from syntalker_tpu.diffusion.schedule import make_diffusion as jax_make_diffusion
from syntalker_tpu.models.denoiser import MDMConfig as JaxMDMConfig
from syntalker_tpu.models.denoiser import create_mdm
from syntalker_tpu_torch import bridge, generation
from syntalker_tpu_torch.data.stats import identity_pose_stats
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import MDMConfig, build_mdm
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
from syntalker_tpu_torch.ops import mdm_cuda, quantize_cuda
from syntalker_tpu_torch.ops.quantize import RVQConfig
from syntalker_tpu_torch.serving import MotionGenerationService, MotionRequest
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

# the tiny configuration of tests/test_generation.py
JAX_CFG = JaxMDMConfig(
    latent_total_dim=1536, latent_dim=32, ff_size=64, num_layers=1, num_heads=2,
    rope_heads=4, audio_feat_dim=16, word_feat_dim=16, word_embed_dim=8, vocab_size=50,
)
CFG = MDMConfig(**{f.name: getattr(JAX_CFG, f.name) for f in dataclasses.fields(MDMConfig)})
ABS = 1e-3  # the bound tests/test_generation.py holds the lean sampler to


@pytest.fixture(scope="module")
def setup():
    mdm, params = create_mdm(JAX_CFG, jax.random.PRNGKey(0), frames=128)
    plan = JG.plan_windows(240)  # 2 windows: exercises the seed carry
    b = 2
    g = np.random.default_rng(3)
    audio = g.normal(0, 0.1, (b, 533 * 240, 2)).astype(np.float32)
    words = g.integers(0, JAX_CFG.vocab_size, (b, 240)).astype(np.int32)
    aw, ww = JG.window_audio(audio, plan), JG.window_words(words, plan)
    seed = g.normal(size=(b, plan.pre_frames, 1536)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = JG.sample_windows_lean(mdm, params, jax_make_diffusion(steps=8), plan, jnp.asarray(aw),
                                 jnp.asarray(ww), jnp.asarray(seed), key)
    # the per-window initial noise of the same key chain
    noise = []
    for _ in range(plan.num_windows):
        key, k_samp = _rng_split(key)
        _, k0 = _rng_split(k_samp)
        noise.append(np.asarray(_rng_normal(k0, (b, plan.latent_window, 1536))))
    port = dict(aw=torch.as_tensor(aw), ww=torch.as_tensor(ww).long(), seed=torch.as_tensor(seed),
                noise=torch.as_tensor(np.stack(noise)))
    tmdm = bridge.mdm_from_flax(CFG, params, device="cpu")
    return tmdm, generation.plan_windows(240), port, np.asarray(ref)


def test_plan_and_windows_match_jax():
    for n in (128, 240, 480, 1906):
        assert dataclasses.asdict(generation.plan_windows(n)) == dataclasses.asdict(JG.plan_windows(n))
    plan = generation.plan_windows(300)
    audio = np.random.default_rng(0).normal(size=(2, 533 * 300, 2)).astype(np.float32)
    words = np.arange(600).reshape(2, 300)
    np.testing.assert_array_equal(generation.window_audio(audio, plan), JG.window_audio(audio, JG.plan_windows(300)))
    np.testing.assert_array_equal(generation.window_words(words, plan), JG.window_words(words, JG.plan_windows(300)))


def test_lean_sampler_matches_jax(setup):
    tmdm, plan, p, ref = setup
    out = generation.sample_windows_lean(tmdm, make_diffusion(steps=8), plan, p["aw"], p["ww"], p["seed"], p["noise"])
    assert out.shape == ref.shape == (2, plan.out_latent_frames, 1536)
    assert np.abs(out.numpy() - ref).max() < ABS


def test_fused_loop_sampler_f32_matches_jax(setup):
    """The K1 sampler's wiring (batched encode, seed carry, stitch) through
    K1's plain version with f32 weights."""
    tmdm, plan, p, ref = setup
    sample = generation.make_fused_loop_sampler(tmdm, make_diffusion(steps=8), plan, weights_dtype=torch.float32)
    out = sample(p["aw"], p["ww"], p["seed"], p["noise"])
    assert np.abs(out.numpy() - ref).max() < ABS


def test_sample_windows_fused_loop_matches_jax(setup):
    """The one-shot wrapper (K1's plain version, f32 weights) against JAX's
    ``sample_windows_lean`` within 1e-5; a sampler passed as ``fused=`` is
    the one that runs, and gives the same latents again."""
    tmdm, plan, p, ref = setup
    diffusion = make_diffusion(steps=8)
    args = (p["aw"], p["ww"], p["seed"], p["noise"])
    out = generation.sample_windows_fused_loop(tmdm, diffusion, plan, *args, weights_dtype=torch.float32)
    assert out.shape == ref.shape and np.abs(out.numpy() - ref).max() < 1e-5
    calls = []
    sampler = generation.make_fused_loop_sampler(tmdm, diffusion, plan, weights_dtype=torch.float32)

    def fused(*a):
        calls.append(len(a))
        return sampler(*a)

    again = generation.sample_windows_fused_loop(None, None, plan, *args, fused=fused)
    assert calls == [4] and torch.equal(again, out)


def test_fused_block_sampler_f32_matches_jax(setup):
    """The K2 sampler (host loop over steps, one block stack per step)
    through K2's plain version with f32 weights."""
    tmdm, plan, p, ref = setup
    w = mdm_cuda.stack_block_weights(tmdm, torch.float32)
    out = generation.sample_windows_fused(tmdm, make_diffusion(steps=8), plan, p["aw"], p["ww"], p["seed"],
                                          p["noise"], weights=w)
    assert np.abs(out.numpy() - ref).max() < ABS


def test_draw_noise_is_seeded():
    plan = generation.plan_windows(240)
    a = generation.draw_noise(plan, 3, torch.Generator().manual_seed(1), "cpu")
    b = generation.draw_noise(plan, 3, torch.Generator().manual_seed(1), "cpu")
    assert a.shape == (2, 3, 32, 1536)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the service on the CPU

def _service(fused_loop: bool, mdm=None, **kw):
    q = RVQConfig(num_quantizers=2, nb_code=16, code_dim=512)
    rvq = {part: build_rvqvae(RVQVAEConfig(input_dim=dim, width=32, depth=1, quantizer=q), seed=i, device="cpu")
           for i, (part, dim) in enumerate((("upper", 78), ("hands", 180), ("lower", 57)))}
    return MotionGenerationService(
        mdm=build_mdm(CFG, seed=0, device="cpu") if mdm is None else mdm, diffusion=make_diffusion(steps=4),
        rvq_modules=rvq, stats=identity_pose_stats(), max_batch=4, max_seconds=128 / 30, fused_loop=fused_loop,
        device="cpu", **kw)


def _requests(n):
    g = np.random.default_rng(5)
    return [MotionRequest(audio=g.normal(0, 0.1, 16000 * (2 + i)).astype(np.float32),
                          words=g.integers(0, CFG.vocab_size, 30 * (2 + i)), request_id=f"r{i}")
            for i in range(n)]


@pytest.mark.parametrize("fused_loop", [True, False])
def test_service_answers_requests_on_cpu(fused_loop):
    svc = _service(fused_loop)
    before = (dict(mdm_cuda.launches), dict(quantize_cuda.launches))
    events = [svc.submit(r) for r in _requests(3)]
    results = svc.flush()
    assert [r.request_id for r in results] == ["r0", "r1", "r2"]
    assert all(e.is_set() for e in events)
    for r in results:
        assert r.axis_angle.shape == (128, 165) and r.trans.shape == (128, 3)
        assert np.isfinite(r.axis_angle).all() and np.isfinite(r.trans).all()
        assert svc.results[r.request_id] is r
    assert svc.flush() == []
    # CPU tensors take the plain versions: no kernel was launched
    assert (dict(mdm_cuda.launches), dict(quantize_cuda.launches)) == before


def test_service_background_loop():
    svc = _service(True, max_wait_s=0.01)
    svc.start()
    try:
        events = [svc.submit(r) for r in _requests(2)]
        assert all(e.wait(timeout=120) for e in events)
    finally:
        svc.stop()
    assert svc._thread is None
    assert set(svc.results) == {"r0", "r1"}


def test_service_start_takes_max_wait_s():
    """``start(max_wait_s=...)`` as JAX's service takes it: the argument
    overrides the constructor's wait for the loop. With the constructor's
    hour-long wait, one request (under the bucket of 4) is flushed only
    because the argument's 0.1 s has passed."""
    svc = _service(True, max_wait_s=3600.0)
    rng = np.random.default_rng(2)
    svc.start(max_wait_s=0.1)
    try:
        ev = svc.submit(MotionRequest(audio=rng.normal(0, 0.1, 16000).astype(np.float32), request_id="bg"))
        assert ev.wait(timeout=120), "background flush never fired"
        assert svc.results["bg"].axis_angle.shape == (128, 165)
    finally:
        svc.stop()
    assert svc.max_wait_s == 3600.0


def test_service_rejects_prompted_requests():
    """A prompted request to a model without use_prompt raises JAX's
    ValueError; the queue keeps nothing of it."""
    svc = _service(True)
    req = MotionRequest(audio=np.zeros(16000, np.float32), prompts={"upper": np.zeros(8, np.float32)})
    with pytest.raises(ValueError, match="use_prompt=True"):
        svc.submit(req)
    assert svc.flush() == []
