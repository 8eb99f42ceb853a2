"""The port's trainers on the ``h3d623`` representation against the JAX package's, f32 on the CPU.

A synthetic BEAT2 corpus (``make_corpus``) is cached by the port with the
synthetic SMPL-X model, so that its windows carry the 623-d ``h3d``
arrays; JAX's ``BeatCache`` reads the same files. As in
``test_torch_train_loop.py``, both packages start from JAX's initial state
copied through the bridge and take JAX's draws (each step's keys split from
the state's key as ``TrainState.next_rngs`` does); the RVQ-VAE's residual
dropout and the denoiser's condition dropouts run at rate 0; batches of 8
divide over the test session's 8 JAX CPU devices.

- ``RVQTrainer``, each part on its ``part_mask_623`` channels of the
  normalized array (the lower part without a translation channel), three
  steps from the device-resident dataset;
- ``DiffusionTrainer`` with a prompted MDM and a frozen TMR motion encoder
  (``tmr_motion``: its ``mu`` of the normalized clip is the prompt), three
  steps on latents of the frozen h3d RVQ-VAE encoders.

Tolerances, as in ``test_torch_train_loop.py``: losses 1e-4 relative; the
RVQ-VAE's params 1e-4 relative plus 1e-3 of the rate; the denoiser's params
1e-4 relative plus 0.15 of the rate where Adam's step is determined by the
gradient (at least 90% of the elements) and Adam's bound of 2 rates a step
everywhere. The TMR prompts of a batch are held to JAX's to 1e-5 relative.

JAX's trainers start from the port's seeded initial weights written as
flax trees (``port_inits``): flax's eager init runs the forward op by op
(~19 s for the tiny MDM, ~4 s an RVQ-VAE), and the port copies whatever
JAX's state holds. The RVQ trainer runs the upper part and the lower one
(its root channels and foot contacts, no translation); the hands part is
the upper part's code on another mask."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu.data import cache as JC
from syntalker_tpu.data.stats import identity_h3d_stats as jax_identity_h3d_stats
from syntalker_tpu.models import denoiser as JD
from syntalker_tpu.models import rvqvae as JR
from syntalker_tpu.models import tmr as JTMR
from syntalker_tpu.ops import quantize as JQ
from syntalker_tpu.train import loop as JL
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.config import load_config
from syntalker_tpu_torch.data import beat_builder as PB
from syntalker_tpu_torch.data import cache as PC
from syntalker_tpu_torch.data.h3d import H3D_PART_DIMS, part_mask_623
from syntalker_tpu_torch.data.synthetic import make_corpus
from syntalker_tpu_torch.models import denoiser as PD
from syntalker_tpu_torch.models import rvqvae as PR
from syntalker_tpu_torch.models import tmr as PTMR
from syntalker_tpu_torch.models.denoiser import build_mdm
from syntalker_tpu_torch.ops import quantize as PQ
from syntalker_tpu_torch.ops.smplx import synthetic_smplx_model
from syntalker_tpu_torch.train import loop as PL
from syntalker_tpu_torch.train.diffusion_trainer import DiffusionDraws

from test_torch_text import perturbed
from test_torch_train_loop import TINY_MDM, TINY_RVQ, configs, key_chain, record
from test_torch_train_rvq import assert_trees_close, close, jax_opt_dict, jax_rvq_draws
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

LOSS_REL, PARAM_REL, PROMPT_REL = 1e-4, 1e-4, 1e-5
STEPS = 3
RVQ_LR, MDM_LR = 1e-3, 1e-3
H3D = ["representation=h3d623", "data.mean_std_dir=/nonexistent"]
PROMPTED = ["mdm.use_prompt=true", "mdm.prompt_dim=16"]
SMALL_TMR = dict(latent_dim=16, ff_size=32, num_layers=1, num_heads=2)


def port_cfg(port_cls, jax_cfg):
    """The port's config dataclass with a JAX config's fields."""
    kw = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(port_cls)}
    if "quantizer" in kw:
        kw["quantizer"] = port_cfg(PQ.RVQConfig, kw["quantizer"])
    return port_cls(**kw)


@pytest.fixture(autouse=True)
def port_inits(monkeypatch):
    """JAX's ``create_mdm`` and ``create_rvqvae`` in the trainers return the
    port's seeded weights (seed 0) as flax trees."""

    def create_mdm(cfg, rng, *, frames=128):
        return JD.MDM(cfg), bridge.mdm_to_flax(build_mdm(port_cfg(PD.MDMConfig, cfg), seed=0, device="cpu"))["params"]

    def create_rvqvae(cfg, rng, example_len=64):
        module, _ = PR.build_rvqvae(port_cfg(PR.RVQVAEConfig, cfg), seed=0, device="cpu")
        params = jax.tree.map(jnp.asarray, bridge.FlaxLayout(module).to_flax(dict(module.named_parameters())))
        return JR.RVQVAE(cfg), params, JQ.init_rvq_state(cfg.quantizer)

    monkeypatch.setattr(JL, "create_mdm", create_mdm)
    monkeypatch.setattr(JL, "create_rvqvae", create_rvqvae)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("h3d_corpus")
    make_corpus(root, speakers=(2, 4), clips_per_speaker=3, seconds_range=(8.0, 9.0), seed=2)
    return root


def h3d_caches(corpus, out, pose_length: int, speakers, stride: int):
    """(port cache with h3d arrays, JAX's cache of the same files)."""
    pc, _ = PB.build_beat_cache(corpus, out, speakers=speakers, smplx_model=synthetic_smplx_model(device="cpu"),
                                cfg=PC.ClipConfig(pose_length=pose_length, stride=stride))
    return pc, JC.BeatCache.open(out / "train")


@pytest.fixture(scope="module")
def rvq_caches(corpus, tmp_path_factory):
    return h3d_caches(corpus, tmp_path_factory.mktemp("h3d_rvq_cache"), 16, (2, 4), 20)


def test_cache_windows_carry_h3d(rvq_caches):
    pc, jc = rvq_caches
    a, b = pc.get(0), jc.get(0)
    assert a["h3d"].shape == (16, 623) and np.isfinite(a["h3d"]).all()
    np.testing.assert_array_equal(a["h3d"], b["h3d"])


@pytest.mark.parametrize("part", ("upper", "lower"))
def test_h3d_rvq_trainer_tracks_jax(rvq_caches, part, tmp_path, monkeypatch):
    pc, jc = rvq_caches
    monkeypatch.setattr(JL, "_rvq_cfg", lambda cfg, p, f=JL._rvq_cfg: dataclasses.replace(f(cfg, p), dropout_rate=0.0))
    monkeypatch.setattr(PL, "rvq_config",
                        lambda cfg, p, f=PL.rvq_config: dataclasses.replace(f(cfg, p), dropout_rate=0.0))
    overrides = [*TINY_RVQ, *H3D, f"rvq_train.body_part={part}", "rvq_train.batch_size=8", f"rvq_train.lr={RVQ_LR}",
                 "rvq_train.warmup_iters=2", "rvq_train.save_every=100", "train.log_period=1", "train.seed=13",
                 "train.device_data=true", f"train.ckpt_dir={tmp_path}"]
    pcfg, jcfg = configs(overrides)
    jt = JL.RVQTrainer(jcfg, jc)
    pt = PL.RVQTrainer(pcfg, pc, device="cpu")
    assert not pt.use_trans and pt.module.cfg.input_dim == H3D_PART_DIMS[part] == len(part_mask_623(part))
    assert pt._batch_keys == ("h3d",)
    bridge.load_rvqvae(pt.module, jt.state.params)
    jseen = record(jt, ("step", "step_indexed"))
    pseen = record(pt, ("step",))
    rcfg = pt.module.cfg
    rows, masks = 8 * 16 // rcfg.temporal_scale, len(PR.dropout_mask_shapes(rcfg, 8, 16))
    keys = key_chain(jt.state.rng, 2, STEPS)
    jt.train(STEPS)
    pt.train(STEPS, draws=lambda it: PR.RVQVAEDraws([None] * masks, jax_rvq_draws(keys[it][0], rcfg.quantizer, rows)))
    assert len(pseen) == len(jseen) == STEPS
    for i, (a, b) in enumerate(zip(pseen, jseen)):
        for k in ("loss", "recon", "commit", "perplexity"):
            close(a[k], b[k], rel=LOSS_REL, msg=f"step {i} {k}")
    assert pt.state.step == int(jt.state.step) == STEPS and pt._dataset is not None
    assert_trees_close(pt.state.layout.to_flax(pt.state.params), jax.tree.map(np.asarray, jt.state.params),
                       rel=PARAM_REL, atol=1e-3 * RVQ_LR)
    close(pt.state.quantizer_state.codebook.numpy(), jt.state.quantizer_state.codebook, rel=PARAM_REL)


# ---------------------------------------------------------------------------
# DiffusionTrainer with the TMR prompt channel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mdm_caches(corpus, tmp_path_factory):
    """One speaker's 32-frame windows: three batches of 8 an epoch."""
    pc, jc = h3d_caches(corpus, tmp_path_factory.mktemp("h3d_mdm_cache"), 32, (2,), 16)
    assert len(pc) // 8 == STEPS, len(pc)
    return pc, jc


def tmr_encoders():
    """A TMR motion encoder in both packages: the port's flax-style init
    with every leaf perturbed (the zero distribution tokens prove nothing)."""
    port = PTMR.init_like_flax_(PTMR.ActorAgnosticEncoder(PTMR.TMRConfig(**SMALL_TMR), 623),
                                torch.Generator().manual_seed(0))
    params = perturbed(bridge.FlaxLayout(port).to_flax(dict(port.named_parameters())), 9)
    bridge.load_actor_encoder(port, jax.tree.map(np.asarray, params)).eval().requires_grad_(False)
    return (JTMR.ActorAgnosticEncoder(JTMR.TMRConfig(**SMALL_TMR), input_dim=623), params), port


def test_h3d_diffusion_trainer_with_tmr_prompt_tracks_jax(mdm_caches, tmp_path):
    pc, jc = mdm_caches
    over = [*TINY_RVQ, *TINY_MDM, *H3D, *PROMPTED, "mdm.num_layers=1", "mdm.vocab_size=64", "data.pose_length=32",
            "train.batch_size=8", f"train.lr={MDM_LR}", "train.log_period=1", "train.seed=5", "diffusion.steps=100",
            f"train.ckpt_dir={tmp_path}", "train.device_data=true"]
    pcfg, jcfg = configs(over)
    (jenc, jtparams), penc = tmr_encoders()
    jt = JL.DiffusionTrainer(jcfg, jc, tmr_motion=(jenc, jtparams))
    pt = PL.DiffusionTrainer(pcfg, pc, tmr_motion=penc, device="cpu")
    assert pt._batch_keys == ("h3d", "audio", "word")
    bridge.load_mdm(pt.mdm, jax.tree.map(np.asarray, {"params": jt.state.params}))
    for part, (_module, params, _q) in jt.rvq.items():
        assert pt.rvq[part][0].cfg.input_dim == H3D_PART_DIMS[part]
        bridge.load_rvqvae(pt.rvq[part][0], jax.tree.map(np.asarray, params))

    # the featurized batch: latents of the masked parts and the TMR prompt
    batch = next(iter(pt.epoch_batches(0)))
    feats = pt.featurize(batch)
    x = jax_identity_h3d_stats().normalize(jnp.asarray(batch["h3d"].numpy()))
    ref_prompt = jenc.apply({"params": jtparams}, x)[0]
    assert feats["prompt"].shape == (8, 16) and feats["latent_in"].shape == (8, 8, 48)
    close(feats["prompt"].numpy(), np.asarray(ref_prompt), rel=PROMPT_REL)
    given = pt.featurize({**batch, "prompt": torch.ones(8, 16)})["prompt"]  # a batch's own prompt wins
    assert torch.equal(given, torch.ones(8, 16))

    jseen = record(jt, ("step", "step_indexed"))
    pseen = record(pt, ("step",))
    x0_shape = (8, 32 // pt.mdm.cfg.squeeze_scale, pt.mdm.cfg.latent_total_dim)
    keys = key_chain(jt.state.rng, 4, STEPS)

    def draws(it):
        t = jax.random.randint(keys[it][0], (8,), 0, pt.diffusion.num_steps)
        noise = jax.random.normal(keys[it][1], x0_shape)
        return DiffusionDraws(torch.as_tensor(np.array(t)), torch.as_tensor(np.array(noise)), PD.TrainDraws())

    jm, pm = jt.train_epoch(0), pt.train_epoch(0, draws=draws)
    assert len(pseen) == len(jseen) == STEPS
    for i, (a, b) in enumerate(zip(pseen, jseen)):
        close(a["predict_x0_loss"], b["predict_x0_loss"], rel=LOSS_REL, msg=f"step {i}")
    close(pm["train/predict_x0_loss"], jm["train/predict_x0_loss"], rel=LOSS_REL)
    assert pt.state.step == int(jt.state.step) == STEPS
    adam = jax_opt_dict(jt.state.opt_state)["1"]["0"]  # clip, then Adam's (scale_by_adam, scale)
    got, ref = pt.state.layout.to_flax(pt.state.params), jax.tree.map(np.asarray, jt.state.params)
    determined = total = 0
    for (path, a), b, m, v in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(ref),
                                  jax.tree.leaves(adam["mu"]), jax.tree.leaves(adam["nu"])):
        m_hat, v_root = m / (1 - 0.9**STEPS), np.sqrt(v / (1 - 0.999**STEPS))
        sure = (v_root > 100 * 1e-8) & (np.abs(m_hat) >= 0.1 * v_root)
        close(a[sure], b[sure], rel=PARAM_REL, atol=0.15 * MDM_LR, msg=jax.tree_util.keystr(path))
        assert np.abs(a - b).max() <= 2 * MDM_LR * STEPS, jax.tree_util.keystr(path)
        determined, total = determined + int(sure.sum()), total + sure.size
    assert determined >= 0.9 * total, (determined, total)
    assert pt.save().name == f"step_{STEPS}.npz"


def test_h3d_diffusion_trainer_without_tmr_takes_no_prompt(mdm_caches):
    pc, _ = mdm_caches
    over = [*TINY_RVQ, *TINY_MDM, *H3D, "mdm.vocab_size=64", "data.pose_length=32", "train.batch_size=8",
            "train.log_period=1"]
    pt = PL.DiffusionTrainer(load_config(None, over), pc, device="cpu")
    feats = pt.featurize(next(iter(pt.epoch_batches(0))))
    assert set(feats) == {"latent_in", "audio", "word"}
    assert np.isfinite(pt.train_epoch(0)["train/predict_x0_loss"])
