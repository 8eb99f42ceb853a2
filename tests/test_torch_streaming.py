"""The port's streaming session on the CPU against JAX's
``StreamingMotionSession``: the same bridged weights, JAX's own per-window
noise, unprompted (the lean K1 window) and prompted (upper prompt + style,
one K2 call a step); then the session's own contracts: chunking invariance,
emission latency, ``pad_final``, gapless ``frame_start``, agreement with the
offline sampler + decode, and the signature that ``save_compiled`` writes
and ``load_compiled`` checks. The kernels' plain versions run with f32
weights, so the port holds JAX's f32 to the summation order."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu import generation as JG
from syntalker_tpu.config import body_part_rvq_config
from syntalker_tpu.data.stats import identity_pose_stats as jax_identity_stats
from syntalker_tpu.diffusion.core import _rng_normal, _rng_split
from syntalker_tpu.diffusion.schedule import make_diffusion as jax_make_diffusion
from syntalker_tpu.models.denoiser import MDMConfig as JaxMDMConfig
from syntalker_tpu.models.denoiser import create_mdm
from syntalker_tpu.models.rvqvae import create_rvqvae
from syntalker_tpu.ops.quantize import RVQConfig as JaxRVQConfig
from syntalker_tpu.ops.quantize import rvq_forward, rvq_quantize_eval
from syntalker_tpu.ops.rotations import rotation_6d_to_matrix as jax_rotation_6d_to_matrix
from syntalker_tpu.streaming import StreamingMotionSession as JaxSession
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.data.stats import identity_pose_stats
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import MDMConfig
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig
from syntalker_tpu_torch.ops.quantize import RVQConfig, RVQState
from syntalker_tpu_torch.ops.quantize_cuda import rvq_encode_plain
from syntalker_tpu_torch.ops.rotations import rotation_6d_to_matrix
from syntalker_tpu_torch.streaming import StreamingMotionSession, _value_fingerprint

from test_torch_prompted import perturb
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

# the stack of tests/test_streaming.py: latent 32, 2 layers, ddim4, RVQ width 32
JAX_CFG = JaxMDMConfig(latent_dim=32, ff_size=64, num_layers=2, num_heads=2, rope_heads=4, audio_feat_dim=16,
                       word_feat_dim=16, word_embed_dim=8, vocab_size=64)
P, S = 8, 8  # prompt and style widths of the prompted model
JAX_CFG_PROMPTED = dataclasses.replace(JAX_CFG, use_prompt=True, prompt_dim=P, use_motionclip=True, style_dim=S)
Q = JaxRVQConfig(num_quantizers=2, nb_code=16, code_dim=512)
GUIDANCE = {"audio_scale": 1.0, "prompt_scale": 2.0}
N_FRAMES = 240  # two windows
LAT_REL, POSE_ABS = 1e-5, 1e-4


def torch_cfg(jcfg):
    return MDMConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(MDMConfig)})


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def build_stack(jcfg, variables_fn=lambda v: v):
    """(JAX stack, port stack): the MDM, the ddim4 schedule and three
    RVQ-VAEs with codebooks from a training-mode forward."""
    rng = jax.random.PRNGKey(0)
    mdm, params = create_mdm(jcfg, rng, frames=128)
    params = variables_fn(params)
    rvq, trvq = {}, {}
    for i, part in enumerate(("upper", "hands", "lower")):
        rcfg = body_part_rvq_config(part, width=32, depth=1, quantizer=Q)
        module, p, state = create_rvqvae(rcfg, jax.random.fold_in(rng, i))
        state = rvq_forward(jax.random.normal(rng, (1, 32, 512)), state, Q, train=True, rng=rng).state
        rvq[part] = (module, p, state)
        tcfg = RVQVAEConfig(input_dim=rcfg.input_dim, width=32, depth=1, quantizer=RVQConfig(2, 16, 512))
        trvq[part] = bridge.rvqvae_from_flax(tcfg, p, np.asarray(state.codebook), device="cpu")
    tmdm = bridge.mdm_from_flax(torch_cfg(jcfg), params, device="cpu")
    return ((mdm, params, jax_make_diffusion(steps=100, timestep_respacing="ddim4"), rvq),
            (tmdm, make_diffusion(steps=100, timestep_respacing="ddim4"), trvq))


@pytest.fixture(scope="module")
def stack():
    return build_stack(JAX_CFG)


@pytest.fixture(scope="module")
def prompted_stack():
    return build_stack(JAX_CFG_PROMPTED, lambda v: perturb(v, seed=5))


def jax_window_noise(key, windows):
    """The initial noise of each window that JAX's session draws from
    ``key``: key -> (key, k_samp) a window, then k0 = split(k_samp)[1], on
    the lean and the prompted route alike."""
    out = []
    for _ in range(windows):
        key, k_samp = _rng_split(key)
        _, k0 = _rng_split(k_samp)
        out.append(np.asarray(_rng_normal(k0, (1, 32, J.LATENT_DIM))))
    return torch.as_tensor(np.stack(out))


def session(port, windows=3, **kw):
    tmdm, diffusion, trvq = port
    return StreamingMotionSession(mdm=tmdm, diffusion=diffusion, rvq_modules=trvq, stats=identity_pose_stats(),
                                  noise=jax_window_noise(jax.random.PRNGKey(7), windows),
                                  weights_dtype=torch.float32, device="cpu", **kw)


def features(seed, frames=N_FRAMES):
    return np.random.default_rng(seed).normal(0, 0.1, (533 * frames, 2)).astype(np.float32)


def words(seed, vocab, frames=N_FRAMES):
    return np.random.default_rng(seed + 50).integers(0, vocab, frames)


def concat(segs, key):
    return np.concatenate([s[key] for s in segs])


def stream_both(jax_stack, port, feats, word_ids, chunks, **kw):
    """Push the same ragged chunks through JAX's session and the port's;
    after every push, the states' latents (seed and tail ring) and the
    translation carry are compared. Returns both lists of segments."""
    mdm, params, diffusion, rvq = jax_stack
    jkw = {k: None if v is None else (jax.tree.map(lambda t: jnp.asarray(t.numpy()), v)
                                      if k in ("prompts", "style") else v) for k, v in kw.items()}
    js = JaxSession(mdm=mdm, mdm_params=params, diffusion=diffusion, rvq_modules=rvq, stats=jax_identity_stats(),
                    rng=jax.random.PRNGKey(7), **jkw)
    ps = session(port, **kw)
    jsegs, psegs, pos = [], [], 0
    for size in chunks:
        piece, wp = feats[pos : pos + size], word_ids[pos // 533 : (pos + size) // 533]
        jsegs += js.push_audio(piece, wp)
        psegs += ps.push_audio(piece, wp)
        pos += size
        for name in ("seed", "tail"):
            assert rel_err(ps._state[name].numpy(), js._state[name]) < LAT_REL, name
        np.testing.assert_allclose(ps._state["carry"].numpy(), np.asarray(js._state["carry"]), atol=POSE_ABS)
    jsegs += js.finish()
    psegs += ps.finish()
    return jsegs, psegs, ps


def check_segments(jsegs, psegs):
    assert [len(s["axis_angle"]) for s in psegs] == [len(s["axis_angle"]) for s in jsegs]
    assert [s["frame_start"] for s in psegs] == [s["frame_start"] for s in jsegs]
    for key in ("axis_angle", "trans", "rot6d"):
        assert np.abs(concat(psegs, key) - concat(jsegs, key)).max() < POSE_ABS, key


CHUNKS = (5000, 12345, 40000, 33333, 10**9)


def test_stream_matches_jax_session(stack):
    """The lean K1 window (plain version, f32) against JAX's lean window."""
    jax_stack, port = stack
    feats = features(0)
    jsegs, psegs, ps = stream_both(jax_stack, port, feats, words(0, JAX_CFG.vocab_size), CHUNKS)
    check_segments(jsegs, psegs)
    assert ps.stream_stats.windows_run == 2 and ps.stream_stats.frames_emitted == 2 * 112 + 16
    starts, lens = [s["frame_start"] for s in psegs], [len(s["axis_angle"]) for s in psegs]
    assert starts == list(np.cumsum([0] + lens[:-1]))  # gapless


def test_prompted_stream_matches_jax_session(prompted_stack):
    """Upper-body prompt + style: the general window with three guidance
    branches stacked into one denoise a step (K2's plain version, f32)."""
    jax_stack, port = prompted_stack
    g = np.random.default_rng(1)
    prompts = {"upper": torch.as_tensor(g.normal(size=(1, P)), dtype=torch.float32)}
    style = torch.as_tensor(g.normal(size=(1, S)), dtype=torch.float32)
    jsegs, psegs, _ = stream_both(jax_stack, port, features(1), words(1, JAX_CFG.vocab_size), (533 * N_FRAMES,),
                                  prompts=prompts, guidance=GUIDANCE, style=style)
    check_segments(jsegs, psegs)


def decode_gap(jax_stack, port, feats, word_ids):
    """How far the two frameworks' decodes of the SAME latents lie apart:
    JAX's offline lean sampler on the session's audio, words and key, its
    latents decoded by JAX and by the port. Max abs error by pose field."""
    mdm, params, diffusion, rvq = jax_stack
    plan = JG.plan_windows(N_FRAMES)
    aw = jnp.asarray(JG.window_audio(feats[None], plan))
    ww = jnp.asarray(JG.window_words(word_ids[None, :N_FRAMES], plan))
    seed = jnp.zeros((1, plan.pre_frames, J.LATENT_DIM))
    lat = JG.sample_windows_lean(mdm, params, diffusion, plan, aw, ww, seed, jax.random.PRNGKey(7))
    jdec = JG.decode_latents(lat, rvq_modules=rvq, stats=jax_identity_stats())
    with torch.no_grad():
        pdec = G.decode_latents(torch.as_tensor(np.asarray(lat)), rvq_modules=port[2], stats=identity_pose_stats())
    return {k: float(np.abs(np.asarray(jdec[k]) - pdec[k].numpy()).max()) for k in ("axis_angle", "rot6d", "trans")}


def test_unprompted_stream_reads_no_prompt_on_a_prompt_model(prompted_stack):
    """An unprompted session of a use_prompt model takes the lean window,
    which reads no prompt, as JAX's does. The route shows in the latents,
    compared after every push. On this model the two frameworks' decodes of
    the same latents already differ by ~1.2e-4 in axis-angle and rot6d
    (f32 convolution order, amplified by the rot6d Gram-Schmidt); that gap
    is measured here, and the streamed poses must lie within POSE_ABS of
    it. Translation holds POSE_ABS itself."""
    jax_stack, port = prompted_stack
    feats, word_ids = features(2), words(2, JAX_CFG.vocab_size)
    jsegs, psegs, ps = stream_both(jax_stack, port, feats, word_ids, (533 * N_FRAMES,))
    assert not ps._use_cfg
    assert [s["frame_start"] for s in psegs] == [s["frame_start"] for s in jsegs]
    gap = decode_gap(jax_stack, port, feats, word_ids)
    assert np.abs(concat(psegs, "trans") - concat(jsegs, "trans")).max() < POSE_ABS
    for key in ("axis_angle", "rot6d"):
        assert np.abs(concat(psegs, key) - concat(jsegs, key)).max() < gap[key] + POSE_ABS, (key, gap)


def test_decode_gap_is_located_in_the_rotations_of_the_decoders_parts(prompted_stack, record_property):
    """Where the two frameworks' decodes of the same latents part (the
    ~1.2e-4 of the test above), stage by stage on that fixture:
    1. the snap (K3's plain version against ``rvq_quantize_eval``): the
       same indices and codes, bit for bit;
    2. the decoders' part features: f32 convolution order, ≤ 1e-5
       (2.1e-6 measured);
    3. ``rotation_6d_to_matrix`` on identical inputs: equal;
    4. the port's rotations fed JAX's parts: JAX's decode to ≤ 1e-6;
    5. JAX's own rotations fed the port's parts: JAX's decode moves by as
       much as the two frameworks differ, over 20 times the parts' gap.
    So the gap is the decoders' f32 order, amplified by the rot6d
    Gram-Schmidt of the reference's own math, not a step of the port.
    The stage gaps are printed (``-s``) and kept as junit properties."""
    (mdm, params, diffusion, rvq), (_, _, trvq) = prompted_stack
    plan = JG.plan_windows(N_FRAMES)
    feats, word_ids = features(2), words(2, JAX_CFG.vocab_size)
    lat = JG.sample_windows_lean(mdm, params, diffusion, plan, jnp.asarray(JG.window_audio(feats[None], plan)),
                                 jnp.asarray(JG.window_words(word_ids[None, :N_FRAMES], plan)),
                                 jnp.zeros((1, plan.pre_frames, J.LATENT_DIM)), jax.random.PRNGKey(7))
    z = np.asarray(lat) * 5.0
    jparts, pparts, gaps = {}, {}, {}
    for name, (lo, hi) in J.LATENT_SLICES.items():
        module, p, state = rvq[name]
        tmod, tstate = trvq[name]
        zp = np.ascontiguousarray(z[..., lo:hi])
        jq, jidx = rvq_quantize_eval(jnp.asarray(zp), state, Q)
        pq, pidx = rvq_encode_plain(torch.as_tensor(zp).reshape(-1, 512), tstate.codebook)
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx).reshape(-1, Q.num_quantizers))
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq).reshape(-1, 512))
        jparts[name] = np.asarray(module.apply({"params": p}, jnp.asarray(zp), state, method="latent2origin"))
        with torch.no_grad():
            pparts[name] = tmod.latent2origin(torch.as_tensor(zp), tstate).numpy()
        gaps[name] = np.abs(pparts[name] - jparts[name]).max()
    parts_gap = max(gaps.values())
    assert 0 < parts_gap <= 1e-5, gaps

    r6 = np.random.default_rng(0).normal(size=(1000, 6)).astype(np.float32)
    np.testing.assert_array_equal(rotation_6d_to_matrix(torch.as_tensor(r6)).numpy(),
                                  np.asarray(jax_rotation_6d_to_matrix(jnp.asarray(r6))))

    jdec = JG.decode_parts({k: jnp.asarray(v) for k, v in jparts.items()}, stats=jax_identity_stats())
    jdec_of_port = JG.decode_parts({k: jnp.asarray(v) for k, v in pparts.items()}, stats=jax_identity_stats())
    with torch.no_grad():
        pdec_of_jax = G.decode_parts({k: torch.as_tensor(v) for k, v in jparts.items()}, stats=identity_pose_stats())
        pdec = G.decode_parts({k: torch.as_tensor(v) for k, v in pparts.items()}, stats=identity_pose_stats())
    readings = {"parts_gap": {k: float(v) for k, v in gaps.items()}}
    for key in ("axis_angle", "rot6d"):
        ref = np.asarray(jdec[key])
        port_rotations = float(np.abs(pdec_of_jax[key].numpy() - ref).max())
        full = float(np.abs(pdec[key].numpy() - ref).max())
        amplified = float(np.abs(np.asarray(jdec_of_port[key]) - ref).max())
        readings[key] = {"port_rotations_of_jax_parts": port_rotations, "jax_rotations_of_port_parts": amplified,
                         "decode_gap": full, "over_parts_gap": amplified / float(parts_gap)}
        assert port_rotations <= 1e-6, key
        assert amplified > 20 * parts_gap and abs(amplified - full) <= 1e-5, (key, parts_gap, amplified, full)
    print(json.dumps(readings))
    record_property("stage_gaps", json.dumps(readings))


def test_stream_matches_offline_sampler_and_decode(stack):
    """The stream against the offline K1 sampler + decode of the same audio
    and noise: latents equal, decode within the lookback/lookahead margins
    of tests/test_streaming.py."""
    _, (tmdm, diffusion, trvq) = stack
    feats = features(3)
    plan = G.plan_windows(N_FRAMES)
    noise = jax_window_noise(jax.random.PRNGKey(7), plan.num_windows)
    sampler = G.make_fused_loop_sampler(tmdm, diffusion, plan, weights_dtype=torch.float32)
    aw = torch.as_tensor(G.window_audio(feats[None], plan))
    ww = torch.as_tensor(G.window_words(np.zeros((1, N_FRAMES), np.int64), plan))
    lat = sampler(aw, ww, torch.zeros(1, plan.pre_frames, J.LATENT_DIM), noise)
    off = G.decode_latents(lat, rvq_modules=trvq, stats=identity_pose_stats())
    ps = session(stack[1])
    segs = ps.push_audio(feats) + ps.finish()
    aa, tr = concat(segs, "axis_angle"), concat(segs, "trans")
    off_aa, off_tr = off["axis_angle"][0].numpy(), off["trans"][0].numpy()
    assert aa.shape == off_aa.shape
    assert np.abs(aa - off_aa).max() < 5e-2
    assert np.abs(tr - off_tr).max() < 1e-3 * max(1.0, np.abs(off_tr).max())
    # the session encodes each window alone, the sampler all windows in one batch
    assert rel_err(ps._state["seed"].numpy(), lat[:, -plan.pre_frames :].numpy()) < LAT_REL


def test_chunking_invariance(stack):
    feats = features(4)
    s1 = session(stack[1])
    segs1 = s1.push_audio(feats) + s1.finish()
    s2 = session(stack[1])
    segs2 = []
    for i in range(0, len(feats), 7777):
        segs2 += s2.push_audio(feats[i : i + 7777])
    segs2 += s2.finish()
    for key in ("axis_angle", "trans", "rot6d"):
        np.testing.assert_array_equal(concat(segs1, key), concat(segs2, key))


def test_emission_latency_contract(stack):
    """After exactly one window of audio, one window less the lookahead is out."""
    sess = session(stack[1])
    g = np.random.default_rng(5)
    assert sess.push_audio(g.normal(0, 0.1, (533 * 128 - 100, 2)).astype(np.float32)) == []
    segs = sess.push_audio(g.normal(0, 0.1, (100, 2)).astype(np.float32))
    assert len(segs) == 1 and len(segs[0]["axis_angle"]) == (32 - sess.lookahead) * 4
    assert segs[0]["rot6d"].shape == (96, J.ROT6D_DIM) and segs[0]["trans"].shape == (96, 3)
    assert sess.stream_stats.windows_run == 1


def test_pad_final_covers_tail(stack):
    sess = session(stack[1])
    segs = sess.push_audio(features(6, 188))  # one window + a 60-frame tail
    assert sess.stream_stats.windows_run == 1
    segs += sess.finish(pad_final=True)
    assert sess.stream_stats.windows_run == 2
    assert sum(len(s["axis_angle"]) for s in segs) == 240


def test_save_load_round_trip(stack, tmp_path):
    """A loaded session streams exactly what a fresh one does: the warm-up
    that ``load_compiled`` runs leaves the state and the noise alone. Only
    the signature is saved."""
    feats = features(7)
    ref = session(stack[1])
    ref_segs = ref.push_audio(feats) + ref.finish()
    session(stack[1]).save_compiled(tmp_path / "aot")
    assert sorted(p.name for p in (tmp_path / "aot").iterdir()) == ["signature.json"]
    loaded = session(stack[1], generator=torch.Generator().manual_seed(3))
    loaded.noise = None  # the generator's draws must be untouched by the warm-up
    fresh = session(stack[1], generator=torch.Generator().manual_seed(3))
    fresh.noise = None
    loaded.load_compiled(tmp_path / "aot")
    assert loaded.stream_stats.windows_run == 0 and loaded._w == 0
    for a, b in zip(loaded.push_audio(feats) + loaded.finish(), fresh.push_audio(feats) + fresh.finish()):
        np.testing.assert_array_equal(a["axis_angle"], b["axis_angle"])
    reloaded = session(stack[1])
    reloaded.load_compiled(tmp_path / "aot")
    for a, b in zip(reloaded.push_audio(feats) + reloaded.finish(), ref_segs):
        np.testing.assert_array_equal(a["axis_angle"], b["axis_angle"])
        np.testing.assert_array_equal(a["trans"], b["trans"])


def test_load_compiled_rejects_mismatched_session(stack, tmp_path):
    session(stack[1]).save_compiled(tmp_path / "aot")
    with pytest.raises(ValueError, match="don't match"):
        session(stack[1], lookahead=4).load_compiled(tmp_path / "aot")


def test_load_compiled_rejects_different_weights(stack, tmp_path):
    session(stack[1]).save_compiled(tmp_path / "aot")
    tmdm, diffusion, trvq = stack[1]
    bumped = bridge.mdm_from_flax(torch_cfg(JAX_CFG), stack[0][1], device="cpu")
    with torch.no_grad():
        for p in bumped.parameters():
            p.add_(1e-3)
    with pytest.raises(ValueError, match="weights_fp"):
        session((bumped, diffusion, trvq)).load_compiled(tmp_path / "aot")


def test_load_compiled_rejects_different_latent_scale(stack, tmp_path):
    session(stack[1]).save_compiled(tmp_path / "aot")
    with pytest.raises(ValueError, match="weights_fp"):
        session(stack[1], latent_scale=7.0).load_compiled(tmp_path / "aot")


def test_fingerprint_reads_bf16_tensors_and_rvq_states():
    a = torch.randn(4, 8).to(torch.bfloat16)
    b = a.clone()
    b[0, 0] += 1
    assert _value_fingerprint(a) == _value_fingerprint(a.clone()) != _value_fingerprint(b)
    assert _value_fingerprint(a) != _value_fingerprint(a.float())
    cb = torch.randn(2, 16, 512)
    cb2 = cb.clone()
    cb2[1, 3, 7] += 1e-3
    assert _value_fingerprint(RVQState(cb)) != _value_fingerprint(RVQState(cb2))
