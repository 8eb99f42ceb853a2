"""The port's ``GestureEvaluator`` and its CLIs against the JAX package, on the CPU.

The test split of a ``make_corpus`` corpus (speaker 2, three clips of 9,
8 and 7 s: two window-count buckets, one of them of mixed lengths) is
evaluated by JAX's ``GestureEvaluator`` (``batch_clips=2``) and by the
port's, with the stack of ``tests/test_eval_harness.py`` (an MDM at
latent width 32, one layer; three RVQ-VAEs of width 32 with codebooks
from a training-mode forward), the full-width FGD eval VAE (the port's
seeded weights as a flax tree), the synthetic SMPL-X model, DDIM over 4
steps and JAX's per-clip noise (``fold_in(key, i)``, then the sampler's
splits) fed through the port's ``noise`` hook; the port's K2 stand-in
runs f32 weights. Tolerances: the decoded axis-angle and translation in
the ``res_`` npz within rel 1e-4, ``fid`` within rel 1e-3, ``l1div``
within rel 1e-4, ``bc`` and ``srgr`` within 1e-2. The port's
``batch_clips=2`` gives its ``batch_clips=1`` results. Then
``cli.train_aux`` (eval_vae, face_vqvae, tmr; 2 iterations each) and
``cli.test`` (reading the eval-VAE npz just written) end to end with
``--device cpu`` at a tiny width; without it, on a machine with no GPU,
both refuse."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu import generation as JG
from syntalker_tpu.config import body_part_rvq_config
from syntalker_tpu.data import beat_builder as JB
from syntalker_tpu.data.stats import identity_pose_stats as jax_identity_stats
from syntalker_tpu.diffusion.schedule import make_diffusion as jax_make_diffusion
from syntalker_tpu.eval import harness as JH
from syntalker_tpu.eval.harness import GestureEvaluator as JaxEvaluator
from syntalker_tpu.models.denoiser import MDM as JaxMDM
from syntalker_tpu.models.denoiser import MDMConfig as JaxMDMConfig
from syntalker_tpu.models.eval_vae import VAESKConv as JaxVAESKConv
from syntalker_tpu.models.rvqvae import RVQVAE as JaxRVQVAE
from syntalker_tpu.ops.quantize import RVQConfig as JaxRVQConfig
from syntalker_tpu.ops.quantize import RVQState as JaxRVQState
from syntalker_tpu.ops import smplx as JSX
from syntalker_tpu.ops.smplx import synthetic_smplx_model as jax_synthetic_smplx
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.cli import test as TEST
from syntalker_tpu_torch.cli import train_aux as AUX
from syntalker_tpu_torch.data.cache import BeatCache
from syntalker_tpu_torch.data.stats import identity_pose_stats
from syntalker_tpu_torch.data.synthetic import make_corpus
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.eval.harness import GestureEvaluator
from syntalker_tpu_torch.models.denoiser import MDMConfig, build_mdm
from syntalker_tpu_torch.models.eval_vae import VAESKConv
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
from syntalker_tpu_torch.ops import mdm_cuda
from syntalker_tpu_torch.ops.quantize import RVQConfig
from syntalker_tpu_torch.ops.smplx import synthetic_smplx_model

from test_torch_streaming import jax_window_noise
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

JAX_CFG = JaxMDMConfig(latent_dim=32, ff_size=64, num_layers=1, num_heads=2, rope_heads=4, audio_feat_dim=16,
                       word_feat_dim=16, word_embed_dim=8, vocab_size=64)
Q = JaxRVQConfig(num_quantizers=2, nb_code=16, code_dim=512)
MEAN_VEL = np.full(55, 0.05, np.float32)
KEY = 2


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The corpus's test split (9, 8 and 7 s) cached once; JAX's cache
    files, which the port's ``BeatCache`` reads."""
    root = tmp_path_factory.mktemp("eval")
    make_corpus(root / "corpus", speakers=(2,), clips_per_speaker=3, test_fraction=1.0, seconds_range=(5.0, 9.0),
                seed=0)
    cache, _ = JB.build_beat_cache(root / "corpus", root / "cache", split="test", speakers=(2,))
    return root, cache


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


class JaxEvaluatorJit(JaxEvaluator):
    """JAX's evaluator with its FGD embedding and ground-truth latents
    jitted: the same functions, compiled once a shape instead of op by op."""

    def _fgd_embed(self, rot6d):
        if not hasattr(self, "_embed"):
            self._embed = jax.jit(lambda p, x: self.eval_vae.apply({"params": p}, x, method="map2latent"))
        n = rot6d.shape[1] - rot6d.shape[1] % self.vae_test_len
        z = self._embed(self.eval_vae_params, rot6d[:, :n])
        return np.asarray(z.reshape(-1, z.shape[-1]))

    def _gt_latents(self, pose_aa, trans_v):
        if not hasattr(self, "_gt_jit"):
            self._gt_jit = jax.jit(super()._gt_latents)
        return self._gt_jit(pose_aa, trans_v)


def jit_jax_helpers(mp, jax_ev):
    """JAX's decode, rotations and SMPL-X FK/LBS on the evaluator's models,
    jitted (the same functions)."""
    decode = jax.jit(functools.partial(JG.decode_latents, rvq_modules=jax_ev.rvq_modules, stats=jax_ev.stats,
                                       latent_scale=jax_ev.latent_scale))
    fk = jax.jit(functools.partial(JSX.forward_joints, jax_ev.smplx_model))
    lbs = jax.jit(functools.partial(JSX.lbs, jax_ev.smplx_model))
    mp.setattr(JH.G, "decode_latents", lambda lat, **kw: decode(lat))
    mp.setattr(JH, "pose_to_part_rot6d", jax.jit(JH.pose_to_part_rot6d))
    mp.setattr(JSX, "forward_joints", lambda model, *a, **kw: fk(*a, **kw))
    mp.setattr(JSX, "lbs", lambda model, *a, **kw: lbs(*a, **kw))


@pytest.fixture(scope="module")
def evaluated(split):
    """JAX's evaluation of the split and the port's evaluator, on the port's
    seeded weights written as flax trees."""
    root, jcache = split
    tmdm = build_mdm(MDMConfig(**{f.name: getattr(JAX_CFG, f.name) for f in dataclasses.fields(MDMConfig)}),
                     seed=0, device="cpu")
    rvq, trvq = {}, {}
    for i, part in enumerate(("upper", "hands", "lower")):
        rcfg = body_part_rvq_config(part, width=32, depth=1, quantizer=Q)
        tcfg = RVQVAEConfig(input_dim=rcfg.input_dim, width=32, depth=1, quantizer=RVQConfig(2, 16, 512))
        module, state = trvq[part] = build_rvqvae(tcfg, seed=10 + i, device="cpu")
        cb = jnp.asarray(state.codebook.numpy())
        rvq[part] = (JaxRVQVAE(rcfg), jax_tree(bridge.FlaxLayout(module).to_flax(dict(module.named_parameters()))),
                     JaxRVQState(cb, jnp.zeros_like(cb), jnp.zeros(cb.shape[:2]), jnp.asarray(True)))
    torch.manual_seed(3)
    ev = VAESKConv()
    ev_params = bridge.FlaxLayout(ev).to_flax(dict(ev.named_parameters()))
    jax_ev = JaxEvaluatorJit(mdm=JaxMDM(JAX_CFG), mdm_params=jax_tree(bridge.mdm_to_flax(tmdm)),
                             diffusion=jax_make_diffusion(steps=4), rvq_modules=rvq, stats=jax_identity_stats(),
                             eval_vae=JaxVAESKConv(), eval_vae_params=jax_tree(ev_params), smplx_model=jax_synthetic_smplx(),
                             mean_velocity=MEAN_VEL, sampler="ddim")
    with pytest.MonkeyPatch.context() as mp:
        jit_jax_helpers(mp, jax_ev)
        jres = jax_ev.evaluate(jcache, jax.random.PRNGKey(KEY), out_dir=root / "jax", batch_clips=2)

    port = GestureEvaluator(mdm=tmdm, diffusion=make_diffusion(steps=4), rvq_modules=trvq,
                            stats=identity_pose_stats(), eval_vae=bridge.eval_vae_from_flax(ev_params, device="cpu"),
                            smplx_model=synthetic_smplx_model(device="cpu"), mean_velocity=MEAN_VEL, sampler="ddim",
                            denoise=mdm_cuda.make_fused_denoise(tmdm, mdm_cuda.stack_block_weights(tmdm, torch.float32)),
                            device="cpu")
    return root, BeatCache.open(root / "cache" / "test"), jres, port


def jax_noise(i, plan):
    """Clip i's draws in JAX's evaluate: fold_in(key, i), then the windows' splits (DDIM: no step noise)."""
    return jax_window_noise(jax.random.fold_in(jax.random.PRNGKey(KEY), i), plan.num_windows), None


def test_evaluator_matches_jax(evaluated):
    root, cache, jres, port = evaluated
    assert len(cache) == 3
    assert sorted({port.plan(cache.get(i)).num_windows for i in range(3)}) == [1, 2]
    res = port.evaluate(cache, out_dir=root / "port_seq", batch_clips=1, noise=jax_noise)
    assert res.clips == jres.clips == 3 and res.motion_seconds == jres.motion_seconds
    for i in range(3):
        with np.load(root / "port_seq" / f"res_{i:03d}.npz") as got, np.load(root / "jax" / f"res_{i:03d}.npz") as ref:
            assert sorted(got.files) == sorted(ref.files)
            assert rel_err(got["poses"], ref["poses"]) <= 1e-4, i
            assert rel_err(got["trans"], ref["trans"]) <= 1e-4, i
            np.testing.assert_array_equal(got["expressions"], ref["expressions"])
        with np.load(root / "port_seq" / f"gt_{i:03d}.npz") as got, np.load(root / "jax" / f"gt_{i:03d}.npz") as ref:
            np.testing.assert_array_equal(got["poses"], ref["poses"])
    assert np.isfinite([res.fid, res.l1div, res.srgr]).all() and 0 <= res.bc <= 1
    assert rel_err(res.fid, jres.fid) <= 1e-3, (res.fid, jres.fid)
    assert rel_err(res.l1div, jres.l1div) <= 1e-4, (res.l1div, jres.l1div)
    assert abs(res.bc - jres.bc) <= 1e-2 and abs(res.srgr - jres.srgr) <= 1e-2, (res, jres)
    assert set(res.stage_seconds) == {"generate", "decode", "fk_lbs", "fgd_embed", "host_metrics", "write"}

    batched = port.evaluate(cache, out_dir=root / "port_batched", batch_clips=2, noise=jax_noise)
    for i in range(3):
        with np.load(root / "port_batched" / f"res_{i:03d}.npz") as b, \
                np.load(root / "port_seq" / f"res_{i:03d}.npz") as s:
            assert rel_err(b["poses"], s["poses"]) <= 1e-4 and rel_err(b["trans"], s["trans"]) <= 1e-4, i
    assert_metrics_close(batched, res)


def assert_metrics_close(a, b):
    """JAX-parity tolerances: the same clips generated in another batching
    differ by f32 sums in another order."""
    assert (a.clips, a.motion_seconds) == (b.clips, b.motion_seconds)
    assert rel_err(a.fid, b.fid) <= 1e-3 and rel_err(a.l1div, b.l1div) <= 1e-4, (a, b)
    assert abs(a.bc - b.bc) <= 1e-2 and abs(a.srgr - b.srgr) <= 1e-2, (a, b)


def test_own_draws_are_per_clip(evaluated):
    """Without the hook each clip draws from its own (seed, index)
    generator: a batch of clips reproduces them, another seed does not."""
    _, cache, _, port = evaluated
    a = port.evaluate(cache, 5, max_clips=2, batch_clips=1)
    b = port.evaluate(cache, 5, max_clips=2, batch_clips=2)
    c = port.evaluate(cache, 6, max_clips=2, batch_clips=1)
    assert_metrics_close(b, a)
    assert rel_err(c.fid, a.fid) > 1e-3


@pytest.fixture(scope="module")
def cli_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    make_corpus(root / "corpus", speakers=(2,), clips_per_speaker=4, test_fraction=0.5, seconds_range=(5.0, 6.0),
                seed=1)
    return root


def cli_overrides(root):
    return [f"data.data_path={root / 'corpus'}", f"data.cache_path={root / 'cache'}", "data.training_speakers=[2]",
            f"data.mean_std_dir={root / 'no_mean_std'}", "data.smplx_model_path=synthetic",
            f"train.ckpt_dir={root / 'ckpt'}", "train.batch_size=4", "train.log_period=1"]


TINY_MDM = ["mdm.latent_dim=32", "mdm.ff_size=64", "mdm.num_layers=1", "mdm.num_heads=2", "mdm.rope_heads=4",
            "mdm.audio_feat_dim=16", "mdm.word_feat_dim=16", "mdm.vocab_size=64", "rvq_width=16", "rvq_depth=1",
            "rvq_ckpts=[]", "diffusion.timestep_respacing=ddim4", "diffusion.sampler=ddim"]


def test_train_aux_then_test_cli_end_to_end(cli_corpus):
    root = cli_corpus
    outs = {}
    for model in ("eval_vae", "face_vqvae", "tmr"):
        outs[model] = AUX.main(["-c", "configs/rvq_beat2.yaml", "--model", model, "--iters", "2", "--device", "cpu",
                                "--run-dir", str(root / "run_aux"), *cli_overrides(root)])
        path = outs[model]["path"]
        assert path == root / "ckpt" / model / "step_2.npz" and path.exists(), path
        assert [h["it"] for h in outs[model]["history"]] == [1, 2]
        assert all(np.isfinite(v) for h in outs[model]["history"] for v in h.values())
    with np.load(outs["eval_vae"]["path"]) as f:
        assert {"step", "rng"} <= set(f.files) and any(k.startswith("params/encoder/layer_0/conv/") for k in f.files)
    with np.load(outs["tmr"]["path"]) as f:
        assert any(k.startswith("params/text/") for k in f.files) and any(k.startswith("params/motion/")
                                                                         for k in f.files)

    result = TEST.main(["-c", "configs/diffusion_beat2.yaml", "--device", "cpu", "--run-dir", str(root / "run_test"),
                        "--eval-vae-ckpt", str(outs["eval_vae"]["path"]), "--batch-clips", "2",
                        *cli_overrides(root), *TINY_MDM])
    metrics = json.loads((root / "run_test" / "metrics.json").read_text())
    assert metrics["clips"] == result.clips == 2 and metrics["fid"] == result.fid
    assert np.isfinite([metrics["fid"], metrics["l1div"], metrics["srgr"]]).all() and 0 <= metrics["bc"] <= 1
    assert (root / "cache" / TEST.MEAN_VEL_FILE).exists()
    for i in range(2):
        for prefix in ("res", "gt"):
            with np.load(root / "run_test" / "results" / f"{prefix}_{i:03d}.npz") as f:
                assert f["poses"].shape[1] == 165 and f["poses"].shape[0] == f["trans"].shape[0]
                assert np.isfinite(f["poses"]).all()


@pytest.mark.parametrize("cli", ("train_aux", "test"))
def test_clis_need_a_device_without_gpu(cli, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-c", "configs/rvq_beat2.yaml", "--run-dir", str(tmp_path)] + (["--model", "eval_vae"]
                                                                          if cli == "train_aux" else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        {"train_aux": AUX, "test": TEST}[cli].main(argv)
