"""The port's trainers' loops against the JAX package's, f32 on the CPU.

Both packages train on the same window cache (a synthetic corpus built by
the port, read by each package's ``BeatCache``), from JAX's initial state
copied through the bridge, with JAX's draws fed through ``draws=``: each
step's key is split from the state's key as ``TrainState.next_rngs`` does
(``jax_rvq_draws`` and ``jax_step_draws`` rebuild the draws from it). The
RVQ-VAE's residual-block dropout and the denoiser's condition dropouts and
drop-path run at rate 0: flax's ``make_rng`` streams cannot be replayed
(their masks are tested in ``test_torch_train_rvq.py`` and
``test_torch_train_diffusion.py``).

``RVQTrainer`` (upper, hands, and lower with the translation velocity) and
``DiffusionTrainer`` (beat2, the word table from a vocab's weights) run
three steps with ``train.device_data`` on and off. Tolerances: the
per-step losses 1e-4 relative (the featurization's f32 rotations and the
f32 sums of two frameworks); the params after the steps 1e-4 relative plus
1e-3 of the learning rate (Adam moves an element whose gradient is within
f32 noise of zero by up to its rate either way; ``test_torch_train_rvq.py``
gives the argument). The denoiser's WavEncoder has conv biases ahead of a
BatchNorm, whose gradient is zero in exact arithmetic and f32 noise
(~1e-10) in both frameworks; Adam turns that noise into steps of up to
its rate, and over three steps other elements whose gradient changes sign
become as sensitive: the noise-moved biases shift the f32 rounding of the
activations that the norm then removes, and the kernels' gradients
downstream of them take that rounding. So the denoiser's params are held
at 1e-4 relative plus 0.15 of the rate where Adam's step is determined by
the gradient (JAX's bias-corrected moments: sqrt(v) above 100 eps and |m|
at least a tenth of sqrt(v)), which must be at least 90% of the elements,
and everywhere within Adam's bound of 2 rates a step. A wrong gradient
term moves determined elements by the order of the rate itself. The debug save/load cycle and ``maybe_resume`` are
held to the uninterrupted run bit for bit. The train CLIs, the decode
without translation and the tracking utilities are in
``test_torch_train_clis.py``."""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from syntalker_tpu import config as JCFG
from syntalker_tpu.data import cache as JC
from syntalker_tpu.train import loop as JL
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.config import load_config
from syntalker_tpu_torch.data import beat_builder as PB
from syntalker_tpu_torch.data import cache as PC
from syntalker_tpu_torch.data.synthetic import make_corpus
from syntalker_tpu_torch.models import denoiser as PD
from syntalker_tpu_torch.models import rvqvae as PR
from syntalker_tpu_torch.train import loop as PL
from syntalker_tpu_torch.train import state as PS
from syntalker_tpu_torch.train.diffusion_trainer import DiffusionDraws

from test_torch_train_diffusion import jax_step_draws
from test_torch_train_rvq import assert_trees_close, close, jax_opt_dict, jax_rvq_draws
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

LOSS_REL, PARAM_REL = 1e-4, 1e-4
STEPS = 3
RVQ_LR, MDM_LR = 1e-3, 1e-3
TINY_RVQ = ["mdm.latent_total_dim=48", "rvq_width=16", "rvq_depth=1"]
TINY_MDM = ["mdm.latent_dim=32", "mdm.ff_size=64", "mdm.num_layers=2", "mdm.num_heads=2", "mdm.rope_heads=4",
            "mdm.audio_feat_dim=16", "mdm.word_feat_dim=16", "mdm.word_embed_dim=8", "mdm.cond_mask_prob=0.0",
            "mdm.cond_mask_prob_audio=0.0", "mdm.dropout=0.0"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    make_corpus(root, speakers=(2, 4), clips_per_speaker=3, seconds_range=(8.0, 9.0), seed=2)
    return root


def caches(corpus, out, pose_length: int, speakers, stride: int = 20):
    """(port cache, JAX cache of the same files, vocab)."""
    pc, vocab = PB.build_beat_cache(corpus, out, speakers=speakers,
                                    cfg=PC.ClipConfig(pose_length=pose_length, stride=stride))
    return pc, JC.BeatCache.open(out / "train"), vocab


def configs(overrides):
    return load_config(None, overrides), JCFG.load_config(None, overrides)


def record(trainer, names):
    """Wrap the trainer's step attributes to keep each step's metrics."""
    seen = []
    for name in names:
        fn = getattr(trainer, name)

        def wrapped(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            seen.append({k: float(v) for k, v in out[1].items()})
            return out

        setattr(trainer, name, wrapped)
    return seen


def key_chain(key, n_keys: int, steps: int):
    """Each step's keys of ``next_rngs(n_keys)`` from the initial key."""
    out = []
    for _ in range(steps):
        keys = jax.random.split(key, n_keys + 1)
        key = keys[0]
        out.append(keys[1:])
    return out


# ---------------------------------------------------------------------------
# RVQTrainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rvq_caches(corpus, tmp_path_factory):
    return caches(corpus, tmp_path_factory.mktemp("rvq_cache"), 16, (2, 4))


@pytest.mark.parametrize("device_data", (True, False), ids=("device_data", "host_batches"))
@pytest.mark.parametrize("part", ("upper", "hands", "lower"))
def test_rvq_trainer_tracks_jax(rvq_caches, part, device_data, tmp_path, monkeypatch):
    pc, jc, _ = rvq_caches
    # the residual blocks' dropout at rate 0 in both packages
    monkeypatch.setattr(JL, "_rvq_cfg", lambda cfg, p, f=JL._rvq_cfg: dataclasses.replace(f(cfg, p), dropout_rate=0.0))
    monkeypatch.setattr(PL, "rvq_config",
                        lambda cfg, p, f=PL.rvq_config: dataclasses.replace(f(cfg, p), dropout_rate=0.0))
    overrides = [*TINY_RVQ, f"rvq_train.body_part={part}", "rvq_train.batch_size=8", f"rvq_train.lr={RVQ_LR}",
                 "rvq_train.warmup_iters=2", "rvq_train.save_every=2", "train.log_period=1", "train.seed=11",
                 f"train.device_data={str(device_data).lower()}", f"train.ckpt_dir={tmp_path}"]
    pcfg, jcfg = configs(overrides)
    jt = JL.RVQTrainer(dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, ckpt_dir=str(tmp_path / "j"))),
                       jc)
    pt = PL.RVQTrainer(pcfg, pc, device="cpu")
    assert pt.use_trans == (part == "lower") and pt.module.cfg.input_dim == {"upper": 78, "hands": 180,
                                                                            "lower": 57}[part]
    bridge.load_rvqvae(pt.module, jt.state.params)
    jseen = record(jt, ("step", "step_indexed"))
    pseen = record(pt, ("step",))
    rcfg = pt.module.cfg
    rows, masks = 8 * 16 // rcfg.temporal_scale, len(PR.dropout_mask_shapes(rcfg, 8, 16))
    keys = key_chain(jt.state.rng, 2, STEPS)
    jt.train(STEPS)
    pt.train(STEPS, draws=lambda it: PR.RVQVAEDraws([None] * masks, jax_rvq_draws(keys[it][0], rcfg.quantizer,
                                                                                    rows)))
    assert len(pseen) == len(jseen) == STEPS
    for i, (a, b) in enumerate(zip(pseen, jseen)):
        for k in ("loss", "recon", "commit", "perplexity"):
            close(a[k], b[k], rel=LOSS_REL, msg=f"step {i} {k}")
    assert pt.state.step == int(jt.state.step) == STEPS
    assert_trees_close(pt.state.layout.to_flax(pt.state.params), jax.tree.map(np.asarray, jt.state.params),
                       rel=PARAM_REL, atol=1e-3 * RVQ_LR)
    close(pt.state.quantizer_state.codebook.numpy(), jt.state.quantizer_state.codebook, rel=PARAM_REL)
    assert [h["it"] for h in pt.history] == [1, 2, 3]
    assert (pt._dataset is not None) == device_data
    assert sorted(p.name for p in (tmp_path / f"rvq_{part}").iterdir()) == ["step_2.npz"]
    assert pt.save().name == "step_3.npz"


def test_rvq_trainer_streams_host_batches_above_the_budget(rvq_caches, tmp_path, monkeypatch, caplog):
    """A window set above the device budget: the trainer logs it, turns
    ``device_data`` off and takes the host loader's batches, the same ones."""
    pc, _, _ = rvq_caches
    overrides = [*TINY_RVQ, "rvq_train.batch_size=8", "train.log_period=1", "train.device_data=true",
                 f"train.ckpt_dir={tmp_path}"]
    ref = PL.RVQTrainer(load_config(None, overrides[:-2] + ["train.device_data=false"]), pc, device="cpu")
    ref.train(2)
    monkeypatch.setattr(PC, "default_memory_budget", lambda device: 1000)
    small = PL.RVQTrainer(load_config(None, overrides), pc, device="cpu")
    with caplog.at_level(logging.WARNING, logger="syntalker"):
        small.train(2)
    assert "streaming batches from the host" in caplog.text and not small.cfg.train.device_data
    assert [h["loss"] for h in small.history] == [h["loss"] for h in ref.history]


def test_trainers_refuse_what_is_not_ported(rvq_caches):
    pc, _, _ = rvq_caches
    # a mesh larger than the process group (one process here) raises: nothing falls back to one device
    for over in (["train.data_parallel=2"], ["train.model_parallel=2"]):
        with pytest.raises(ValueError, match="larger than the process group of 1"):
            PL.RVQTrainer(load_config(None, TINY_RVQ + over), pc, device="cpu")
        with pytest.raises(ValueError, match="larger than the process group of 1"):
            PL.DiffusionTrainer(load_config(None, TINY_RVQ + over), pc, device="cpu")
    # the h3d623 representation is ported (tests/test_torch_h3d_train.py): its trainers build
    h3d = load_config(None, TINY_RVQ + ["representation=h3d623"])
    assert PL.RVQTrainer(h3d, pc, device="cpu").module.cfg.input_dim == 156
    assert PL.DiffusionTrainer(h3d, pc, device="cpu")._batch_keys == ("h3d", "audio", "word")
    empty = PL.RVQTrainer(load_config(None, TINY_RVQ + ["rvq_train.batch_size=100000"]), pc, device="cpu")
    with pytest.raises(ValueError, match="no full batches"):
        empty.train(1)


# ---------------------------------------------------------------------------
# DiffusionTrainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mdm_setup(corpus, tmp_path_factory):
    """One speaker's 32-frame windows (three batches of 8 an epoch: the
    test session's JAX shards a batch over 8 CPU devices) and a vocab that
    carries word-table weights."""
    out = tmp_path_factory.mktemp("mdm_cache")
    pc, jc, vocab = caches(corpus, out, 32, (2,), stride=16)
    vocab.build_embedding(dim=8, seed=3)
    vocab.save(out / "vocab_emb.json")
    batch = 8
    assert len(pc) // batch == STEPS, len(pc)
    return pc, jc, vocab, out / "vocab_emb.json", batch


def mdm_overrides(vocab, vocab_path, batch, **extra):
    over = [*TINY_RVQ, *TINY_MDM, f"mdm.vocab_size={vocab.n_words}", f"data.vocab_path={vocab_path}",
            "data.pose_length=32", f"train.batch_size={batch}", f"train.lr={MDM_LR}", "train.log_period=1",
            "train.seed=5", "diffusion.steps=100"]
    return over + [f"{k}={v}" for k, v in extra.items()]


@pytest.mark.parametrize("device_data", (True, False), ids=("device_data", "host_batches"))
def test_diffusion_trainer_tracks_jax(mdm_setup, device_data, tmp_path):
    pc, jc, vocab, vocab_path, batch = mdm_setup
    pcfg, jcfg = configs(mdm_overrides(vocab, vocab_path, batch, **{
        "mdm.audio_norm": "batch", "train.device_data": str(device_data).lower(), "train.ckpt_dir": tmp_path}))
    jt = JL.DiffusionTrainer(jcfg, jc)
    pt = PL.DiffusionTrainer(pcfg, pc, device="cpu")
    # the port seeds its word table from the vocab's weights, as JAX's does
    np.testing.assert_array_equal(pt.mdm.word_embedding.detach().numpy(), vocab.word_embedding_weights)
    variables = {"params": jt.state.params, **(jt.state.model_state or {})}
    bridge.load_mdm(pt.mdm, jax.tree.map(np.asarray, variables))
    for part, (module, _params, _q) in jt.rvq.items():
        bridge.load_rvqvae(pt.rvq[part][0], jax.tree.map(np.asarray, _params))
    jseen = record(jt, ("step", "step_indexed"))
    pseen = record(pt, ("step",))
    x0_shape = (batch, 32 // pt.mdm.cfg.squeeze_scale, pt.mdm.cfg.latent_total_dim)
    keys = key_chain(jt.state.rng, 4, STEPS)

    def draws(it):
        t = jax.random.randint(keys[it][0], (batch,), 0, pt.diffusion.num_steps)
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
    # BatchNorm's running statistics: the variance as the batches give it; the mean also takes the noise-moved
    # bias ahead (apart by up to Adam's bound), weighted by the momentum's share of the three batches
    stats = jt.state.model_state["batch_stats"]
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(pt.state.stats_layout.to_flax(pt.state.model_state)),
                            jax.tree.leaves(jax.tree.map(np.asarray, stats))):
        bias_share = 2 * MDM_LR * STEPS * (1 - 0.9**STEPS) if jax.tree_util.keystr(path).endswith("['mean']") else 0
        close(a, b, rel=PARAM_REL, atol=bias_share, msg=jax.tree_util.keystr(path))
    assert (pt._dataset is not None) == device_data
    assert pt.save().name == f"step_{STEPS}.npz"


def test_jax_step_draws_match_the_key_chain(mdm_setup):
    """The draws rebuilt from ``key_chain`` are the ones the step tests feed."""
    pc, jc, vocab, vocab_path, batch = mdm_setup
    jt = JL.DiffusionTrainer(configs(mdm_overrides(vocab, vocab_path, batch))[1], jc)
    d = jax_step_draws(jt.state, (2, 8, 48), 100)
    k = key_chain(jt.state.rng, 4, 1)[0]
    np.testing.assert_array_equal(d.t.numpy(), np.array(jax.random.randint(k[0], (2,), 0, 100)))


def states_equal(a: PS.TrainState, b: PS.TrainState) -> bool:
    same = a.step == b.step and all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    fa, fb = bridge.optax_state_to_flax(a.opt_state, a.layout), bridge.optax_state_to_flax(b.opt_state, b.layout)
    leaves = zip(jax.tree.leaves(fa), jax.tree.leaves(fb))
    same &= all(np.array_equal(x, y) for x, y in leaves)
    same &= torch.equal(a.generator.get_state(), b.generator.get_state())
    return same and all(torch.equal(a.model_state[k], b.model_state[k]) for k in a.model_state or {})


def test_debug_cycle_and_resume_give_the_uninterrupted_state(mdm_setup, tmp_path):
    """The debug epoch (two steps, then a save and a load) and a run resumed
    from a checkpoint are the uninterrupted run bit for bit; the draws come
    from the state's generator, which the checkpoint carries."""
    pc, _, vocab, vocab_path, batch = mdm_setup
    base = mdm_overrides(vocab, vocab_path, batch, **{"mdm.audio_norm": "batch", "mdm.cond_mask_prob": 0.3,
                                                      "mdm.dropout": 0.2})

    def trainer(name, **extra):
        over = base + [f"train.ckpt_dir={tmp_path / name}"] + [f"{k}={v}" for k, v in extra.items()]
        return PL.DiffusionTrainer(load_config(None, over), pc, device="cpu")

    debug, plain = trainer("debug", **{"train.debug": "true"}), trainer("plain")
    debug.train_epoch(0)
    assert (tmp_path / "debug" / "step_2.npz").exists() and debug.state.step == 2
    first_two = trainer("two")
    seen = 0
    for batch_ in first_two.epoch_batches(0):
        first_two.state, _ = first_two.step(first_two.state, batch_)
        seen += 1
        if seen == 2:
            break
    assert states_equal(debug.state, first_two.state)

    plain.train_epoch(0)
    plain.save()
    resumed = trainer("plain")
    assert resumed.maybe_resume() == STEPS and states_equal(resumed.state, plain.state)
    plain.train_epoch(1)
    resumed.train_epoch(1)
    assert states_equal(resumed.state, plain.state)
    assert trainer("none").maybe_resume() == 0
