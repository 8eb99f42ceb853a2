"""The port's diffusion train step against JAX, f32 on the CPU: ``smooth_l1``
and ``training_loss`` (with and without a frame mask), one
``make_diffusion_train_step`` step for the GroupNorm and the BatchNorm wav
encoder with prompt and style inputs (loss, gradients, params after Adam
behind the 0.99 clip, the BatchNorm running statistics), flax's BatchNorm
in training mode, the train-time masks on their own (condition dropouts,
drop-path: given masks, keep fractions, the 1/keep scale), ``remat``
against no ``remat``, the frozen RVQ latent encoder, its scale
calibration and ``apply_word_embedding``.

JAX's timesteps and noise are rebuilt from the step's key splits
(``TrainState.next_rngs(4)``) and fed to the port. The condition dropouts
and drop-path run at rate 0 in the parity steps: flax's ``make_rng``
streams cannot be replayed. Tolerance 1e-5 relative (max error over max
magnitude, f32). Params after Adam: Adam's first step maps a gradient g to
lr·g / (|g| + eps) (eps 1e-8), whose slope near g = 0 is lr / eps, so f32
noise in a gradient near zero moves that element anywhere within its ±lr
bound. Elements whose gradient (JAX's) exceeds 100·eps are held to 1e-5
relative plus 1e-3 of the rate; the others to Adam's bound, 2·lr apart at
most."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from syntalker_tpu.data.stats import PoseStats as JaxPoseStats
from syntalker_tpu.diffusion import core as JC
from syntalker_tpu.diffusion.schedule import make_diffusion as jax_make_diffusion
from syntalker_tpu.models.denoiser import apply_word_embedding as jax_apply_word_embedding
from syntalker_tpu.models.denoiser import create_mdm
from syntalker_tpu.models.rvqvae import RVQVAEConfig as JaxRVQVAEConfig
from syntalker_tpu.models.rvqvae import create_rvqvae
from syntalker_tpu.ops.quantize import RVQConfig as JaxRVQConfig
from syntalker_tpu.train import diffusion_trainer as JDT
from syntalker_tpu.train import state as JS
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.data.stats import PoseStats
from syntalker_tpu_torch.diffusion import core as PC
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models import denoiser as PD
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig
from syntalker_tpu_torch.ops.quantize import RVQConfig
from syntalker_tpu_torch.train import diffusion_trainer as PDT
from syntalker_tpu_torch.train import optim as PO
from syntalker_tpu_torch.train import state as PS

from test_torch_denoiser import torch_cfg
from test_torch_prompted import P, S, jax_cfg, perturb
from test_torch_train_rvq import assert_trees_close, close
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

LR = 1e-3
SGD_LR = 1e4
STEPS = 100  # diffusion steps of the test schedule


def cfg_for(norm, **over):
    return dataclasses.replace(jax_cfg(norm), **{"cond_mask_prob": 0.0, "cond_mask_prob_audio": 0.0, "dropout": 0.0,
                                                 **over})


def batch_of(seed: int, b: int = 3, frames: int = 32, cfg=None) -> dict:
    g = np.random.default_rng(seed)
    cfg = cfg or jax_cfg("group")
    return {
        "latent_in": g.normal(size=(b, frames // 4, cfg.latent_total_dim)).astype(np.float32),
        "audio": g.normal(0, 0.1, (b, 533 * frames, 2)).astype(np.float32),
        "word": g.integers(0, cfg.vocab_size, (b, frames)),
        "prompt": g.normal(size=(b, P)).astype(np.float32),
        "style": g.normal(size=(b, S)).astype(np.float32),
    }


def to_torch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def test_smooth_l1_matches_jax():
    g = np.random.default_rng(0)
    a, b = g.normal(size=(50,)).astype(np.float32) * 2, g.normal(size=(50,)).astype(np.float32)
    close(PC.smooth_l1(torch.as_tensor(a), torch.as_tensor(b)).numpy(), JC.smooth_l1(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("masked", (False, True))
def test_training_loss_matches_jax(masked):
    jd, pd = jax_make_diffusion(steps=STEPS, timestep_respacing="ddim10"), make_diffusion(steps=STEPS,
                                                                                          timestep_respacing="ddim10")
    g = np.random.default_rng(1)
    x0 = g.normal(size=(4, 6, 5)).astype(np.float32)
    noise = g.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 3, 9, 5])
    w = g.normal(size=(5, 5)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0, 0], [1] * 6, [0] * 6, [1, 0, 1, 0, 1, 0]], bool) if masked else None
    # a model that depends on x_t and on the original timestep
    jl = JC.training_loss(jd, lambda x, to: x @ w + to[:, None, None] * 1e-3, jnp.asarray(x0), jnp.asarray(t),
                          jnp.asarray(noise), None if mask is None else jnp.asarray(mask))
    pl = PC.training_loss(pd, lambda x, to: x @ torch.as_tensor(w) + to[:, None, None] * 1e-3, torch.as_tensor(x0),
                          torch.as_tensor(t), torch.as_tensor(noise), None if mask is None else torch.as_tensor(mask))
    close(pl.numpy(), jl)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------


def jax_step_draws(jstate, x0_shape, num_steps):
    """The t and noise of JAX's step, from ``next_rngs(4)``'s keys."""
    keys = jax.random.split(jstate.rng, 5)
    t = jax.random.randint(keys[1], (x0_shape[0],), 0, num_steps)
    noise = jax.random.normal(keys[2], x0_shape)
    return PDT.DiffusionDraws(torch.as_tensor(np.array(t)), torch.as_tensor(np.array(noise)), PD.TrainDraws())


def jax_grads(mdm, jstate, jd, batch) -> dict:
    """JAX's gradients of the step's loss, read through one plain-SGD step
    at rate SGD_LR (see ``test_diffusion_train_step_matches_jax``)."""
    sgd = optax.sgd(SGD_LR)
    s0 = jstate.replace(opt_state=sgd.init(jstate.params))
    s1, _ = jax.jit(JDT.make_diffusion_train_step(mdm, jd, sgd))(s0, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(lambda a, b: (np.asarray(b, np.float64) - np.asarray(a)) / SGD_LR, s1.params, s0.params)


def build(norm, jtx, ptx, seed=0, **over):
    cfg = cfg_for(norm, **over)
    mdm, variables = create_mdm(cfg, jax.random.PRNGKey(seed), frames=32)
    variables = perturb(variables, seed=seed + 1)
    jstate = JS.create_train_state(variables if norm == "batch" else variables["params"], jtx, jax.random.PRNGKey(7))
    tmdm = PD.MDM(torch_cfg(cfg))
    bridge.load_mdm(tmdm, variables)
    pstate = PS.create_train_state(tmdm, ptx, torch.Generator().manual_seed(0))
    return cfg, mdm, jstate, tmdm, pstate


@pytest.mark.parametrize("norm", ("group", "batch"))
@pytest.mark.parametrize("opt", ("grads", "adam_clip"))
def test_diffusion_train_step_matches_jax(norm, opt):
    """"grads": plain SGD at a rate of 1e4 moves each param by 1e4 times
    minus its gradient, far above the params' own rounding, so (p0 - p1) /
    1e4 compares the gradients (each leaf to 1e-5 of its own largest,
    with a floor of 1e-6 of the model's largest gradient: a bias ahead of
    a one-channel-per-group GroupNorm has a gradient that is zero in exact
    arithmetic, f32 noise in both); "adam_clip": the shipped optimizer, Adam
    behind the 0.99 global-norm clip."""
    jtx, ptx = ((optax.sgd(SGD_LR), PO.sgd(SGD_LR)) if opt == "grads"
                else (JS.make_diffusion_optimizer(lr=LR), PO.make_diffusion_optimizer(lr=LR)))
    cfg, mdm, jstate, tmdm, pstate = build(norm, jtx, ptx)
    jd, pd = jax_make_diffusion(steps=STEPS), make_diffusion(steps=STEPS)
    batch = batch_of(2, cfg=cfg)
    draws = jax_step_draws(jstate, batch["latent_in"].shape, STEPS)
    p0 = jax.tree.map(np.asarray, jstate.params)
    jstate2, jm = jax.jit(JDT.make_diffusion_train_step(mdm, jd, jtx))(jstate, jax.tree.map(jnp.asarray, batch))
    pstate, pm = PDT.make_diffusion_train_step(tmdm, pd, ptx)(pstate, to_torch(batch), draws=draws)
    close(pm["predict_x0_loss"].numpy(), jm["predict_x0_loss"])
    ref = jax.tree.map(np.asarray, jstate2.params)
    got = pstate.layout.to_flax(pstate.params)
    if opt == "grads":
        grads = jax.tree.map(lambda a, b: (b.astype(np.float64) - a) / SGD_LR, ref, p0)
        floor = 1e-6 * max(np.abs(g).max() for g in jax.tree.leaves(grads))
        assert_trees_close(jax.tree.map(lambda a, b: (b.astype(np.float64) - a) / SGD_LR, got, p0), grads, atol=floor)
    else:
        grads = jax_grads(mdm, jstate, jd, batch)
        for (path, g), a, b in zip(jax.tree_util.tree_leaves_with_path(grads), jax.tree.leaves(got),
                                   jax.tree.leaves(ref)):
            sure = np.abs(g) > 100 * 1e-8
            close(a[sure], b[sure], atol=1e-3 * LR, msg=jax.tree_util.keystr(path))
            assert np.abs(a - b).max() <= 2 * LR * (1 + 1e-5), jax.tree_util.keystr(path)
    if norm == "batch":
        jstats = jax.tree.map(np.asarray, jstate2.model_state["batch_stats"])
        assert_trees_close(pstate.stats_layout.to_flax(pstate.model_state), jstats)
        # the statistics moved
        assert not np.allclose(jstats["wav_encoder"]["block_0"]["norm1"]["mean"],
                               np.asarray(jstate.model_state["batch_stats"]["wav_encoder"]["block_0"]["norm1"]["mean"]))
    else:
        assert pstate.model_state is None and jstate2.model_state is None


def test_batchnorm_train_mode_matches_flax():
    g = np.random.default_rng(3)
    x = g.normal(1.0, 2.0, (4, 20, 6)).astype(np.float32)  # NWC
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    scale, bias = g.uniform(0.5, 1.5, 6).astype(np.float32), g.normal(size=6).astype(np.float32)
    mean0, var0 = g.normal(size=6).astype(np.float32), g.uniform(0.5, 2, 6).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tbn = PD.BatchNorm(6)
    with torch.no_grad():
        for t, v in ((tbn.weight, scale), (tbn.bias, bias), (tbn.running_mean, mean0), (tbn.running_var, var0)):
            t.copy_(torch.as_tensor(v))
    yt = tbn.train()(torch.as_tensor(x).transpose(1, 2)).transpose(1, 2)
    close(yt.detach().numpy(), y)
    close(tbn.running_mean.numpy(), upd["batch_stats"]["mean"])
    close(tbn.running_var.numpy(), upd["batch_stats"]["var"])  # the biased variance, as flax stores it
    # eval mode reads the running statistics, as before
    xe = torch.as_tensor(x).transpose(1, 2)
    torch.testing.assert_close(tbn.eval()(xe), torch.nn.functional.batch_norm(
        xe, tbn.running_mean, tbn.running_var, tbn.weight, tbn.bias, False, 0.0, 1e-5), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the train-time masks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def group_models():
    cfg = cfg_for("group")
    mdm, variables = create_mdm(cfg, jax.random.PRNGKey(1), frames=32)
    variables = perturb(variables, seed=4)
    tmdm = bridge.mdm_from_flax(torch_cfg(cfg), variables, device="cpu")
    return cfg, mdm, variables, tmdm


def test_condition_dropouts_with_given_masks(group_models):
    """A dropped condition in training is its null, as JAX's
    ``uncond_*`` masks give it: zero audio and words, the learned null
    prompt, a zero style."""
    cfg, mdm, variables, tmdm = group_models
    batch = batch_of(5, cfg=cfg)
    masks = {"audio": np.array([True, False, True]), "prompt": np.array([False, True, True]),
             "style": np.array([True, True, False])}
    ref = mdm.apply(variables, jnp.asarray(batch["audio"]), jnp.asarray(batch["word"]),
                    jnp.asarray(batch["latent_in"][:, :4]), prompt=jnp.asarray(batch["prompt"]),
                    style=jnp.asarray(batch["style"]), uncond_audio=jnp.asarray(masks["audio"]),
                    uncond_prompt=jnp.asarray(masks["prompt"]), uncond_style=jnp.asarray(masks["style"]),
                    method="encode_cond")
    tb = to_torch(batch)
    draws = PD.TrainDraws({k: torch.as_tensor(v) for k, v in masks.items()})
    with torch.no_grad():
        got = tmdm.train().encode_cond(tb["audio"], tb["word"], tb["latent_in"][:, :4], prompt=tb["prompt"],
                                       style=tb["style"], draws=draws)
        plain = tmdm.eval().encode_cond(tb["audio"], tb["word"], tb["latent_in"][:, :4], prompt=tb["prompt"],
                                        style=tb["style"], draws=draws)  # eval mode ignores the masks
    for name in ("at_feat", "seed_emb", "prompt_feat", "style_feat"):
        close(getattr(got, name).numpy(), getattr(ref, name))
    assert not torch.allclose(plain.prompt_feat, got.prompt_feat)


def test_drop_path_mask_and_scale():
    x = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(0))
    keep = torch.tensor([True, False, True, True])
    torch.testing.assert_close(PD.drop_path(x, keep, 0.25), x * keep[:, None, None].float() / 0.75, rtol=0, atol=0)
    assert torch.equal(PD.drop_path(x, None, 0.25), x)
    blk = PD.TransformerBlock(8, 2, 16)
    h = torch.randn(2, 3, 8)
    # both branches dropped: the block is the identity for that sample
    out = blk(h, torch.tensor([[False, True], [False, True]]), 0.5)
    torch.testing.assert_close(out[0], h[0], rtol=0, atol=0)


def test_draw_train_fractions():
    cfg = PD.MDMConfig(num_layers=4, use_prompt=True, use_motionclip=True, cond_mask_prob=0.3,
                       cond_mask_prob_audio=0.1, dropout=0.2)
    d = PD.draw_train(cfg, 20000, torch.Generator().manual_seed(0))
    assert set(d.cond) == {"audio", "prompt", "style"}
    for name, p in (("audio", 0.1), ("prompt", 0.3), ("style", 0.3)):
        assert abs(float(d.cond[name].float().mean()) - p) < 0.01, name
    assert d.drop_path.shape == (4, 2, 20000) and abs(float(d.drop_path.float().mean()) - 0.8) < 0.01
    none = PD.draw_train(dataclasses.replace(cfg, cond_mask_prob=0.0, cond_mask_prob_audio=0.0, dropout=0.0), 4,
                         torch.Generator())
    assert none.cond == {} and none.drop_path is None


def test_drop_path_needs_masks_in_training(group_models):
    cfg, _, _, tmdm = group_models
    m = PD.MDM(dataclasses.replace(tmdm.cfg, dropout=0.1)).train()
    with pytest.raises(ValueError, match="keep masks"):
        m.run_blocks(torch.randn(1, 4, m.cfg.latent_dim))


@pytest.mark.parametrize("norm", ("group", "batch"))
def test_remat_gives_the_same_gradients(norm):
    cfg = torch_cfg(cfg_for(norm, dropout=0.2))
    torch.manual_seed(0)
    a = PD.MDM(cfg).train()
    b = PD.MDM(dataclasses.replace(cfg, remat=True)).train()
    b.load_state_dict(a.state_dict())
    batch = to_torch(batch_of(6, cfg=cfg))
    masks = PD.draw_train(cfg, 3, torch.Generator().manual_seed(1))
    grads = []
    for m in (a, b):
        cond = m.encode_cond(batch["audio"], batch["word"], batch["latent_in"][:, :4], prompt=batch["prompt"],
                             style=batch["style"], draws=masks)
        out = m.denoise(batch["latent_in"], torch.tensor([1, 50, 99]), cond, draws=masks)
        grads.append(torch.autograd.grad(out.square().mean(), list(m.parameters())))
    for ga, gb in zip(*grads):
        torch.testing.assert_close(ga, gb, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the latent encoder and the word embedding
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rvq_stacks():
    dims = {"upper": 78, "hands": 180, "lower": 57}
    jstack, pstack = {}, {}
    for i, (part, dim) in enumerate(dims.items()):
        q = dict(num_quantizers=2, nb_code=8, code_dim=8)
        jc = JaxRVQVAEConfig(input_dim=dim, width=16, output_emb_width=8, depth=1, quantizer=JaxRVQConfig(**q))
        jm, params, js = create_rvqvae(jc, jax.random.PRNGKey(i), example_len=16)
        jstack[part] = (jm, params, js)
        pc = RVQVAEConfig(input_dim=dim, width=16, output_emb_width=8, depth=1, quantizer=RVQConfig(**q))
        pstack[part] = bridge.rvqvae_from_flax(pc, params, np.asarray(js.codebook), device="cpu")
    g = np.random.default_rng(8)
    arrays = dict(mean_full=g.normal(size=330).astype(np.float32), std_full=g.uniform(0.5, 2, 330).astype(np.float32),
                  trans_mean=g.normal(size=3).astype(np.float32), trans_std=g.uniform(0.5, 2, 3).astype(np.float32))
    feats = {"upper": g.normal(size=(2, 16, 78)), "hands": g.normal(size=(2, 16, 180)),
             "lower": g.normal(size=(2, 16, 54)), "trans_v": g.normal(size=(2, 16, 3))}
    feats = {k: v.astype(np.float32) for k, v in feats.items()}
    return jstack, pstack, JaxPoseStats(**arrays), PoseStats(**arrays), feats


def test_latent_encoder_matches_jax(rvq_stacks):
    jstack, pstack, jstats, pstats, f = rvq_stacks
    ref = JDT.make_latent_encoder(jstack, jstats, latent_scale=2.5)(f["upper"], f["hands"], f["lower"], f["trans_v"])
    t = {k: torch.as_tensor(v) for k, v in f.items()}
    got = PDT.make_latent_encoder(pstack, pstats, latent_scale=2.5)(t["upper"], t["hands"], t["lower"], t["trans_v"])
    assert got.shape == (2, 4, 24)
    close(got.numpy(), ref)
    jscale = JDT.calibrate_latent_scale(jstack, jstats, {k: f[k] for k in ("upper", "hands", "lower")}, f["trans_v"],
                                        target_std=0.5)
    pscale = PDT.calibrate_latent_scale(pstack, pstats, {k: t[k] for k in ("upper", "hands", "lower")}, t["trans_v"],
                                        target_std=0.5)
    close(pscale, jscale)
    close(pstats.normalize_part(t["hands"], "hands").numpy(), jstats.normalize_part(f["hands"], "hands"))


def test_apply_word_embedding_matches_jax(group_models):
    cfg, _, variables, _ = group_models
    tmdm = bridge.mdm_from_flax(torch_cfg(cfg), variables, device="cpu")
    m = np.random.default_rng(9).normal(size=(cfg.vocab_size, cfg.word_embed_dim)).astype(np.float32)
    ref = jax_apply_word_embedding(variables["params"], m)["word_embedding"]
    np.testing.assert_array_equal(PD.apply_word_embedding(tmdm, m).word_embedding.detach().numpy(), ref)
    with pytest.raises(ValueError, match="vocab_size"):
        PD.apply_word_embedding(tmdm, m[:-1])
