"""The port's text-control evaluation against the JAX package's, f32 on the CPU.

The test split of a ``make_corpus`` corpus (speaker 2, two clips of 5.5 s,
one window each), cached by the port with the synthetic SMPL-X model so
that it carries the 623-d ``h3d`` arrays; JAX's ``BeatCache`` reads the
same files. Both packages run the same weights: a prompted MDM at latent
width 32 (one layer, prompt width 16), three h3d623 RVQ-VAEs of width 32
with the port's seeded codebooks, a TMR text head (latent 16) and a BiGRU
oracle (hidden 16), each seeded in the port and written as a flax tree;
DDIM over 4 steps; the port's K2 stand-in runs f32 weights. JAX's per-clip
noise (its ``fold_in`` keys, then the sampler's splits) reaches the port
through the ``noise`` hook.

- ``decode_latents_h3d``: features and joints within 1e-4 relative;
- ``generate_clip`` unprompted and with an upper-body prompt: features and
  joints within 1e-4 relative (f32 sums of two frameworks through the
  sampler, the snap and the decoders);
- ``evaluate`` (2 replications, 2 clips) and ``steering_metrics`` (1
  clip): the same keys, every value within 1e-3
  relative (FID's matrix square root, the oracle's embeddings of the
  generated motion) or, for the steering gain (a difference of two
  distances), 1e-3 of the distances;
- ``cli.test_h3d`` end to end at a tiny width with ``--device cpu`` (a
  small oracle artifact written by ``save_oracle_params`` through
  ``--oracle``; the committed TMR text head; MultiModality over 2
  repeats): its ``h3d_metrics.json`` has JAX's keys; without ``--device``
  on a machine with no GPU it refuses.

JAX's sampler, decode and oracle towers are jitted here (the same
functions, compiled once a shape instead of run op by op)."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu import generation as JG
from syntalker_tpu.data.cache import BeatCache as JaxBeatCache
from syntalker_tpu.data.captions import caption_batch as jax_caption_batch
from syntalker_tpu.data.h3d import recover_from_ric as jax_recover_from_ric
from syntalker_tpu.data.stats import identity_h3d_stats as jax_identity_h3d_stats
from syntalker_tpu.diffusion.schedule import make_diffusion as jax_make_diffusion
from syntalker_tpu.eval import harness_h3d as JH
from syntalker_tpu.eval import t2m as JT
from syntalker_tpu.models.denoiser import MDM as JaxMDM
from syntalker_tpu.models.denoiser import MDMConfig as JaxMDMConfig
from syntalker_tpu.models.rvqvae import RVQVAE as JaxRVQVAE
from syntalker_tpu.models.rvqvae import RVQVAEConfig as JaxRVQVAEConfig
from syntalker_tpu.models.tmr import TextPipeline as JaxTextPipeline
from syntalker_tpu.models.tmr import TMRConfig as JaxTMRConfig
from syntalker_tpu.ops.quantize import RVQConfig as JaxRVQConfig
from syntalker_tpu.ops.quantize import RVQState as JaxRVQState
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch.cli import test_h3d as TEST_H3D
from syntalker_tpu_torch.data.beat_builder import build_beat_cache
from syntalker_tpu_torch.data.captions import caption_batch
from syntalker_tpu_torch.data.h3d import H3D_PART_DIMS, recover_from_ric
from syntalker_tpu_torch.data.stats import identity_h3d_stats
from syntalker_tpu_torch.data.synthetic import make_corpus
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.eval import t2m as PT
from syntalker_tpu_torch.eval.harness_h3d import H3DEvaluator
from syntalker_tpu_torch.models.denoiser import MDMConfig, build_mdm
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
from syntalker_tpu_torch.models.tmr import TextPipeline, TMRConfig
from syntalker_tpu_torch.ops import mdm_cuda
from syntalker_tpu_torch.ops.quantize import RVQConfig
from syntalker_tpu_torch.ops.smplx import synthetic_smplx_model

from test_torch_streaming import jax_window_noise
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

MDM_KW = dict(latent_dim=32, ff_size=64, num_layers=1, num_heads=2, rope_heads=4, audio_feat_dim=16, word_feat_dim=16,
              word_embed_dim=8, vocab_size=64, use_prompt=True, prompt_dim=16)
TMR_KW = dict(latent_dim=16, ff_size=32, num_layers=1, num_heads=2)
ORACLE_KW = dict(dim_movement=16, dim_coemb=16, hidden=16)
GEN_REL, METRIC_REL = 1e-4, 1e-3
EVAL_KEY, STEER_KEY = 2, 3
PROMPT = {"upper": "wave both hands", "hands": None, "lower": None}


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("h3d_eval")
    # clips of one length: JAX's eager ops and jitted oracle compile once a shape
    make_corpus(root / "corpus", speakers=(2,), clips_per_speaker=2, test_fraction=1.0, seconds_range=(5.5, 5.5),
                seed=3)
    cache, _ = build_beat_cache(root / "corpus", root / "cache", split="test", speakers=(2,),
                                smplx_model=synthetic_smplx_model(device="cpu"))
    assert len(cache) == 2 and "h3d" in cache.get(0)
    return root, cache, JaxBeatCache.open(root / "cache" / "test")


def port_models():
    """The port's seeded models (MDM, h3d623 RVQ stack, text pipeline, oracle)."""
    mdm = build_mdm(MDMConfig(**MDM_KW), seed=0, device="cpu")
    rvq = {part: build_rvqvae(RVQVAEConfig(input_dim=H3D_PART_DIMS[part], width=32, depth=1,
                                           quantizer=RVQConfig(2, 16, 512)), seed=20 + i, device="cpu")
           for i, part in enumerate(("upper", "hands", "lower"))}
    pipe = TextPipeline(TMRConfig(**TMR_KW), generator=torch.Generator().manual_seed(4), device="cpu")
    oracle = PT.T2MEvaluator(PT.T2MEvalConfig(**ORACLE_KW), seed=5, device="cpu")
    return mdm, rvq, pipe, oracle


def jax_rvq(rvq):
    out = {}
    for part, (module, state) in rvq.items():
        cfg = JaxRVQVAEConfig(input_dim=module.cfg.input_dim, width=32, depth=1,
                              quantizer=JaxRVQConfig(num_quantizers=2, nb_code=16, code_dim=512))
        cb = jnp.asarray(state.codebook.numpy())
        out[part] = (JaxRVQVAE(cfg), jax_tree(bridge.FlaxLayout(module).to_flax(dict(module.named_parameters()))),
                     JaxRVQState(cb, jnp.zeros_like(cb), jnp.zeros(cb.shape[:2]), jnp.asarray(True)))
    return out


def jit_jax_harness(mp, jax_ev):
    """JAX's sampler, decode and oracle towers, jitted (the same functions)."""
    sample_windows, decode_latents_h3d = JG.sample_windows, JG.decode_latents_h3d
    # one compile a window count: the sampler reads the plan's window shape, not the clip's frame count
    sample = functools.lru_cache()(lambda windows, prompted, plan: jax.jit(
        lambda aw, ww, seed, key, prompts: sample_windows(
            jax_ev.mdm, jax_ev.mdm_params, jax_ev.diffusion, plan, aw, ww, seed, key, sampler="ddim",
            prompts=prompts if prompted else None, guidance=jax_ev.guidance)))
    decode = jax.jit(lambda lat: decode_latents_h3d(lat, rvq_modules=jax_ev.rvq_modules,
                                                       h3d_stats=jax_ev.h3d_stats, latent_scale=jax_ev.latent_scale))
    first_plan = {}
    mp.setattr(JH.G, "sample_windows", lambda mdm, params, diffusion, plan, aw, ww, seed, key, *, sampler, prompts,
               guidance: sample(plan.num_windows, prompts is not None, first_plan.setdefault(plan.num_windows, plan))(
                   aw, ww, seed, key, prompts))
    mp.setattr(JH.G, "decode_latents_h3d", lambda lat, **kw: decode(lat))
    return decode
    oracle = jax_ev.t2m_evaluator
    motion = jax.jit(lambda p, m, n: oracle.motion_enc.apply({"params": p}, m, n))
    text = jax.jit(lambda p, w, o, n: oracle.text_enc.apply({"params": p}, w, o, n))
    mp.setattr(oracle, "get_motion_embeddings",
               lambda m, n: np.asarray(motion(oracle.params["motion"], jnp.asarray(m), jnp.asarray(n))))
    mp.setattr(oracle, "get_co_embeddings", lambda w, o, c, m, n: (
        np.asarray(text(oracle.params["text"], jnp.asarray(w), jnp.asarray(o), jnp.asarray(c))),
        oracle.get_motion_embeddings(m, n)))


def captions_of(cache, joints_of, batch_of):
    out = []
    for i in range(len(cache)):
        we, po, ln, caps = batch_of(joints_of(cache.get(i)["h3d"]))
        out.append((caps[0].text, {"word_embs": we, "pos_ohot": po, "cap_lens": ln}))
    return out


def fold(key, path):
    for k in path:
        key = jax.random.fold_in(key, k)
    return key


def jax_noise_hook(base: int):
    """JAX's draws of a key path from PRNGKey(base): fold_in along the path,
    then the sampler's splits (DDIM: no step noise)."""
    return lambda path, plan: (jax_window_noise(fold(jax.random.PRNGKey(base), path), plan.num_windows), None)


@pytest.fixture(scope="module")
def evaluated(split):
    """JAX's results (two generations, evaluate, steering) and the port's evaluator, on the same weights."""
    root, cache, jcache = split
    mdm, rvq, pipe, oracle = port_models()
    jpipe = JaxTextPipeline(JaxTMRConfig(**TMR_KW), head_params=jax_tree(
        bridge.FlaxLayout(pipe.head).to_flax(dict(pipe.head.named_parameters()))))
    jor = JT.T2MEvaluator(JT.T2MEvalConfig(**ORACLE_KW), params=jax_tree(bridge.t2m_oracle_to_flax(oracle)))
    jax_ev = JH.H3DEvaluator(mdm=JaxMDM(JaxMDMConfig(**MDM_KW)), mdm_params=jax_tree(bridge.mdm_to_flax(mdm)["params"]),
                             diffusion=jax_make_diffusion(steps=16, timestep_respacing="ddim4"),
                             rvq_modules=jax_rvq(rvq), h3d_stats=jax_identity_h3d_stats(), text_pipeline=jpipe,
                             t2m_evaluator=jor)
    recover = jax.jit(jax_recover_from_ric)
    jcaps = captions_of(jcache, lambda h: np.asarray(recover(jnp.asarray(h[None]))), jax_caption_batch)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        out["decode"] = jit_jax_harness(mp, jax_ev)
        key = jax.random.PRNGKey(1)
        out["plain"] = jax_ev.generate_clip(jcache.get(0), key)
        out["prompted"] = jax_ev.generate_clip(jcache.get(0), key, prompts=PROMPT)
        out["evaluate"] = jax_ev.evaluate(jcache, jax.random.PRNGKey(EVAL_KEY), text_features=[c[1] for c in jcaps],
                                          replications=2)
        out["steering"] = jax_ev.steering_metrics(jcache, jax.random.PRNGKey(STEER_KEY),
                                                  captions=[c[0] for c in jcaps],
                                                  text_features=[c[1] for c in jcaps], max_clips=1)
    port = H3DEvaluator(mdm=mdm, diffusion=make_diffusion(steps=16, timestep_respacing="ddim4"), rvq_modules=rvq,
                        h3d_stats=identity_h3d_stats(), text_pipeline=pipe, t2m_evaluator=oracle,
                        denoise=mdm_cuda.make_fused_denoise(mdm, mdm_cuda.stack_block_weights(mdm, torch.float32)),
                        device="cpu")
    return cache, port, out, jax_ev, jcaps


def test_decode_latents_h3d_matches_jax(evaluated):
    _, port, jout, jax_ev, _ = evaluated
    lat = np.random.default_rng(6).normal(0, 0.2, (1, 32, 1536)).astype(np.float32)
    ref = jout["decode"](jnp.asarray(lat))  # JAX's decode_latents_h3d, jitted at the generations' shape
    got = G.decode_latents_h3d(torch.as_tensor(lat), rvq_modules=port.rvq_modules, h3d_stats=port.h3d_stats)
    assert got["features"].shape == (1, 128, 623) and got["joints"].shape == (1, 128, 52, 3)
    assert rel_err(got["features"], ref["features"]) <= GEN_REL
    assert rel_err(got["joints"], ref["joints"]) <= GEN_REL


@pytest.mark.parametrize("prompted", (False, True), ids=("unprompted", "upper_prompt"))
def test_generate_clip_matches_jax(evaluated, prompted):
    cache, port, jout, _, _ = evaluated
    plan = port.plan(cache.get(0))
    noise = (jax_window_noise(jax.random.PRNGKey(1), plan.num_windows), None)
    got = port.generate_clip(cache.get(0), noise, prompts=PROMPT if prompted else None)
    ref = jout["prompted" if prompted else "plain"]
    assert got["n_frames"] == ref["n_frames"] and got["features"].shape == ref["features"].shape
    assert rel_err(got["features"], ref["features"]) <= GEN_REL
    assert rel_err(got["joints"], ref["joints"]) <= GEN_REL
    np.testing.assert_array_equal(got["gt_features"], ref["gt_features"])
    if prompted:  # the prompt moved the motion
        assert rel_err(got["features"], jout["plain"]["features"]) > 1e-3


def port_captions(cache):
    return captions_of(cache, lambda h: recover_from_ric(torch.as_tensor(h[None])).numpy(), caption_batch)


def test_evaluate_matches_jax(evaluated):
    cache, port, jout, _, jcaps = evaluated
    caps = port_captions(cache)
    assert [c[0] for c in caps] == [c[0] for c in jcaps]
    got = port.evaluate(cache, text_features=[c[1] for c in caps], replications=2, noise=jax_noise_hook(EVAL_KEY))
    ref = jout["evaluate"]
    assert set(got) == set(ref) == {"fid", "diversity", "matching", "r_precision_top1", "r_precision_top2"}
    for k in ref:
        assert rel_err(got[k][0], ref[k][0]) <= METRIC_REL, (k, got[k], ref[k])
        assert rel_err(got[k][1], ref[k][1]) <= METRIC_REL or abs(got[k][1] - ref[k][1]) <= 1e-6, (k, got[k], ref[k])


def test_steering_metrics_match_jax(evaluated):
    cache, port, jout, _, _ = evaluated
    caps = port_captions(cache)
    got = port.steering_metrics(cache, captions=[c[0] for c in caps], text_features=[c[1] for c in caps],
                                max_clips=1, noise=jax_noise_hook(STEER_KEY))
    ref = jout["steering"]
    assert set(got) == set(ref) and got["steering_clips"] == 1 and got["steering_part"] == "upper"
    for k in ("steering_prompted_part_rel_change", "steering_offpart_leakage"):
        assert rel_err(got[k], ref[k]) <= METRIC_REL, (k, got[k], ref[k])
    # the gain is a difference of two oracle distances of the size of the embeddings
    assert abs(got["steering_prompt_gain"] - ref["steering_prompt_gain"]) <= 1e-3, (got, ref)


def test_own_draws_follow_the_key_paths(evaluated):
    """Without the hook, each generation draws from its key path's own
    generator: the same path gives the same motion, another path does not."""
    cache, port, _, _, _ = evaluated
    plan = port.plan(cache.get(0))
    a = port.generate_clip(cache.get(0), port.clip_noise((7, 0, 1), plan))["features"]
    b = port.generate_clip(cache.get(0), port.clip_noise((7, 0, 1), plan))["features"]
    c = port.generate_clip(cache.get(0), port.clip_noise((7, 1, 1), plan))["features"]
    np.testing.assert_array_equal(a, b)
    assert rel_err(a, c) > 1e-3


def cli_argv(root, *extra):
    d = root / "cli"
    return ["-c", "configs/diffusion_h3d.yaml", "--run-dir", str(d / "run"), "representation=h3d623",
            f"data.data_path={root / 'corpus'}", f"data.cache_path={d / 'cache'}", "data.training_speakers=[2]",
            f"data.mean_std_dir={d / 'no_mean_std'}", "data.smplx_model_path=synthetic", f"train.ckpt_dir={d / 'out'}",
            "mdm.latent_dim=32", "mdm.ff_size=64", "mdm.num_layers=1", "mdm.num_heads=2", "mdm.rope_heads=4",
            "mdm.audio_feat_dim=16", "mdm.word_feat_dim=16", "mdm.vocab_size=64", "rvq_width=16", "rvq_depth=1",
            "diffusion.timestep_respacing=ddim4", *extra]


def test_test_h3d_cli_end_to_end(split, evaluated):
    root = split[0]
    _, _, jout, _, _ = evaluated
    oracle = PT.T2MEvaluator(PT.T2MEvalConfig(**ORACLE_KW), seed=5, device="cpu")
    path = PT.save_oracle_params(root / "oracle" / "small.npz", bridge.t2m_oracle_to_flax(oracle),
                                 meta={"config": ORACLE_KW})
    out = TEST_H3D.main(cli_argv(root, "--device", "cpu", "--replications", "2", "--mm-repeats", "2",
                                 "--steering-clips", "1", "--oracle", str(path)))
    written = json.loads((root / "cli" / "out" / "h3d_metrics.json").read_text())
    assert written == json.loads(json.dumps(out))
    # JAX's keys, and MultiModality's, which --mm-repeats adds
    assert set(written) == set(jout["evaluate"]) | set(jout["steering"]) | {"multimodality"}
    for k in jout["evaluate"]:
        assert set(written[k]) == {"mean", "ci95"} and np.isfinite(written[k]["mean"]), k
    assert written["steering_clips"] == 1 and np.isfinite(written["steering_prompt_gain"])


def test_test_h3d_cli_needs_a_device_without_gpu(split, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEST_H3D.main(cli_argv(split[0]))
