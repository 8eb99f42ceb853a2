"""The port's train checkpoints (``step_<N>.npz``), f32 on the CPU.

- Saving, loading and resuming an RVQ-VAE and a BatchNorm MDM gives, bit
  for bit, the run that was never interrupted: params, optimizer state,
  codebooks, statistics and the generator's next draws.
- A port-written checkpoint unflattened into flax trees gives JAX's
  forward: the MDM's ``denoise`` (with its ``batch_stats``) and the
  RVQ-VAE's decode of its own codebooks.
- A JAX train state (params, optax state, quantizer state, statistics)
  bridged into the port takes JAX's next step.
- ``latest_checkpoint`` skips in-flight temporary files and foreign names.
- The port's ``generate`` CLI reads the trained MDM and RVQ checkpoints
  unchanged (``test_ckpt``, ``rvq_ckpts``).

Tolerances: bit for bit within the port; 1e-5 relative against JAX (max
error over max magnitude); params after Adam as in
``test_torch_train_diffusion``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from syntalker_tpu.diffusion.schedule import make_diffusion as jax_make_diffusion
from syntalker_tpu.models.denoiser import create_mdm
from syntalker_tpu.models.rvqvae import RVQVAE as JaxRVQVAE
from syntalker_tpu.ops import quantize as JQ
from syntalker_tpu.train import diffusion_trainer as JDT
from syntalker_tpu.train import state as JS
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.cli import generate as GEN
from syntalker_tpu_torch.config import load_config
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.eval.t2m import unflatten_params
from syntalker_tpu_torch.models import denoiser as PD
from syntalker_tpu_torch.models import rvqvae as PR
from syntalker_tpu_torch.ops import quantize as PQ
from syntalker_tpu_torch.train import optim as PO
from syntalker_tpu_torch.train import state as PS
from syntalker_tpu_torch.train.diffusion_trainer import make_diffusion_train_step
from syntalker_tpu_torch.train.loop import rvq_config
from syntalker_tpu_torch.train.rvq_trainer import make_rvq_train_step

from test_torch_denoiser import torch_cfg
from test_torch_train_diffusion import batch_of, cfg_for, jax_grads, jax_step_draws, to_torch
from test_torch_train_rvq import (assert_state_close, assert_trees_close, build_pair, close, configs, jax_opt_dict,
                                  step_both)
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

LR = 1e-3


def read_npz(path) -> dict:
    with np.load(path) as f:
        return unflatten_params({k: f[k] for k in f.files})


def assert_states_equal(a: PS.TrainState, b: PS.TrainState):
    assert a.step == b.step
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    fa, fb = (bridge.optax_state_to_flax(s.opt_state, s.layout) for s in (a, b))
    jax.tree.map(np.testing.assert_array_equal, fa, fb)
    if a.quantizer_state is not None:
        for name in ("codebook", "code_sum", "code_count"):
            assert torch.equal(getattr(a.quantizer_state, name), getattr(b.quantizer_state, name)), name
        assert a.quantizer_state.initialized == b.quantizer_state.initialized
    for k in a.model_state or {}:
        assert torch.equal(a.model_state[k], b.model_state[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ---------------------------------------------------------------------------
# resume within the port
# ---------------------------------------------------------------------------


def rvq_run(seed=0):
    _, pc = configs(dropout_rate=0.2)
    module = PR.build_rvqvae(pc, seed=seed, device="cpu")[0]
    tx = PO.make_rvq_optimizer(lr=LR, warmup_iters=2)
    state = PS.create_train_state(module, tx, torch.Generator().manual_seed(seed),
                                  quantizer_state=PQ.init_rvq_state(pc.quantizer))
    return state, make_rvq_train_step(module, tx)


def mdm_run(seed=0):
    cfg = torch_cfg(dataclasses.replace(cfg_for("batch"), dropout=0.1, cond_mask_prob=0.3, cond_mask_prob_audio=0.2))
    mdm = PD.build_mdm(cfg, seed=seed, device="cpu")
    tx = PO.make_diffusion_optimizer(lr=LR)
    state = PS.create_train_state(mdm, tx, torch.Generator().manual_seed(seed))
    return state, make_diffusion_train_step(mdm, make_diffusion(steps=100), tx)


def rvq_batches(n):
    g = np.random.default_rng(11)
    return [torch.as_tensor(g.standard_normal((4, 16, 12)).astype(np.float32)) for _ in range(n)]


def mdm_batches(n):
    return [to_torch(batch_of(20 + i)) for i in range(n)]


@pytest.mark.parametrize("kind", ("rvq", "mdm"))
def test_save_load_resume_is_the_uninterrupted_run(kind, tmp_path):
    run, batches = (rvq_run, rvq_batches(3)) if kind == "rvq" else (mdm_run, mdm_batches(3))
    full, step = run()
    for b in batches:
        full, _ = step(full, b)
    part, step = run()
    for b in batches[:2]:
        part, _ = step(part, b)
    path = PS.save_checkpoint(tmp_path, part)
    assert path.name == "step_2.npz" and PS.latest_checkpoint(tmp_path) == path
    resumed, step = run(seed=5)  # other initial weights, optimizer state and generator: all are overwritten
    PS.load_checkpoint(path, resumed)
    assert_states_equal(resumed, part)
    resumed, _ = step(resumed, batches[2])
    assert_states_equal(resumed, full)


def test_checkpoint_layout(tmp_path):
    state, step = mdm_run()
    state, _ = step(state, mdm_batches(1)[0])
    raw = read_npz(PS.save_checkpoint(tmp_path, state))
    assert set(raw) == {"step", "params", "opt_state", "rng", "model_state"}
    assert float(raw["step"]) == 1.0
    # optax's chain of (clip, (adam, lr)): clip and a constant rate have empty states
    assert set(raw["opt_state"]) == {"1"} and set(raw["opt_state"]["1"]) == {"0"}
    assert set(raw["opt_state"]["1"]["0"]) == {"count", "mu", "nu"}
    assert raw["params"]["blocks"]["block"]["qkv"]["kernel"].shape == (3, 256, 3, 4, 64)
    assert raw["opt_state"]["1"]["0"]["mu"]["blocks"]["block"]["qkv"]["kernel"].shape == (3, 256, 3, 4, 64)
    assert "norm1" in raw["model_state"]["batch_stats"]["wav_encoder"]["block_0"]
    # the inference loader reads the train checkpoint
    variables = PS.load_model_variables(tmp_path / "step_1.npz")
    assert set(variables) == {"params", "batch_stats"}


def test_latest_checkpoint_skips_inflight_and_foreign_names(tmp_path):
    assert PS.latest_checkpoint(tmp_path / "missing") is None
    assert PS.latest_checkpoint(tmp_path) is None
    state, _ = rvq_run()
    PS.save_checkpoint(tmp_path, state, step=3)
    for name in ("step_9.npz.tmp-123", "step_x.npz", "step_12", "notes.txt", "step_7.npz.bak"):
        (tmp_path / name).write_text("")
    (tmp_path / "step_11.npz").mkdir()  # a directory, not a checkpoint
    assert PS.latest_checkpoint(tmp_path) == tmp_path / "step_3.npz"
    PS.save_checkpoint(tmp_path, state, step=10)
    assert PS.latest_checkpoint(tmp_path) == tmp_path / "step_10.npz"
    # a save leaves no temporary file behind
    assert sorted(p.name for p in tmp_path.glob("*.tmp-*")) == ["step_9.npz.tmp-123"]


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------


def test_port_checkpoint_gives_jax_forward(tmp_path):
    """An MDM and an RVQ-VAE trained a step in the port, written, read back
    as flax trees: JAX's modules give the port's outputs."""
    jcfg = cfg_for("batch")
    mdm = PD.build_mdm(torch_cfg(jcfg), seed=0, device="cpu")
    tx = PO.make_diffusion_optimizer(lr=LR)
    state = PS.create_train_state(mdm, tx, torch.Generator().manual_seed(0))
    state, _ = make_diffusion_train_step(mdm, make_diffusion(steps=100), tx)(state, mdm_batches(1)[0])
    raw = read_npz(PS.save_checkpoint(tmp_path / "mdm", state))
    jmdm, _ = create_mdm(jcfg, jax.random.PRNGKey(0), frames=32)
    variables = {"params": raw["params"], **raw["model_state"]}
    jax.tree.map(np.testing.assert_array_equal, bridge.mdm_to_flax(mdm), variables)
    b = batch_of(30, cfg=jcfg)
    x_t, t = b["latent_in"], np.array([3, 40, 99])
    kw = dict(prompt=jnp.asarray(b["prompt"]), style=jnp.asarray(b["style"]))
    cond = jmdm.apply(variables, jnp.asarray(b["audio"]), jnp.asarray(b["word"]), jnp.asarray(x_t[:, :4]),
                      method="encode_cond", **kw)
    ref = jmdm.apply(variables, jnp.asarray(x_t), jnp.asarray(t), cond, method="denoise")
    mdm.eval()
    tb = to_torch(b)
    with torch.no_grad():
        pc = mdm.encode_cond(tb["audio"], tb["word"], tb["latent_in"][:, :4], prompt=tb["prompt"], style=tb["style"])
        got = mdm.denoise(tb["latent_in"], torch.as_tensor(t), pc)
    close(got.numpy(), ref)

    rstate, rstep = rvq_run()
    for batch in rvq_batches(2):
        rstate, _ = rstep(rstate, batch)
    raw = read_npz(PS.save_checkpoint(tmp_path / "rvq", rstate))
    jc, pc_ = configs(dropout_rate=0.2)
    qs = raw["quantizer_state"]
    jstate = JQ.RVQState(codebook=jnp.asarray(qs["codebook"]), code_sum=jnp.asarray(qs["code_sum"]),
                         code_count=jnp.asarray(qs["code_count"]), initialized=jnp.asarray(qs["initialized"] > 0.5))
    x = np.random.default_rng(12).standard_normal((2, 16, 12)).astype(np.float32)
    jrec, jout = JaxRVQVAE(jc).apply({"params": raw["params"]}, jnp.asarray(x), jstate, train=False)
    module = PR.RVQVAE(pc_)
    bridge.load_rvqvae(module, raw["params"])
    with torch.no_grad():
        prec, pout = module(torch.as_tensor(x), rstate.quantizer_state, train=False)
    np.testing.assert_array_equal(pout.indices.numpy(), np.asarray(jout.indices))
    close(prec.numpy(), jrec)


def test_jax_rvq_state_resumes_in_the_port():
    """JAX takes one step; its state is bridged into the port; both take the
    next step from the same draws."""
    jc, jpair, ppair = build_pair()
    g = np.random.default_rng(13)
    b1, b2 = (g.standard_normal((4, 16, 12)).astype(np.float32) for _ in range(2))
    jstep, jstate = jpair
    jstate, _ = jstep(jstate, jnp.asarray(b1))
    pstep, pstate = ppair
    np_params = jax.tree.map(np.asarray, jstate.params)
    for name, v in pstate.layout.from_flax(np_params).items():
        with torch.no_grad():
            pstate.params[name].copy_(v)
    pstate.opt_state = bridge.optax_state_from_flax(jstate.opt_state, pstate.opt_state, pstate.layout)
    qs = jstate.quantizer_state
    pstate.quantizer_state = bridge.rvq_state_from_flax(
        {k: np.asarray(getattr(qs, k)) for k in ("codebook", "code_sum", "code_count", "initialized")}, device="cpu")
    pstate.step = int(jstate.step)
    jpair, ppair, jm, pm = step_both(jc, (jstep, jstate), (pstep, pstate), b2)
    for k in jm:
        close(pm[k].numpy(), jm[k], msg=k)
    jstate, pstate = jpair[1], ppair[1]
    assert_trees_close(pstate.layout.to_flax(pstate.params), jax.tree.map(np.asarray, jstate.params), atol=1e-3 * LR)
    assert_trees_close(bridge.optax_state_to_flax(pstate.opt_state, pstate.layout), jax_opt_dict(jstate.opt_state),
                       atol=1e-3 * LR)
    assert_state_close(pstate.quantizer_state, jstate.quantizer_state)


def test_jax_diffusion_state_resumes_in_the_port():
    """A BatchNorm MDM: JAX's state after one Adam step (params, optax
    state, ``batch_stats``) bridged into the port; the next step agrees."""
    cfg = cfg_for("batch")
    jmdm, variables = create_mdm(cfg, jax.random.PRNGKey(3), frames=32)
    jtx = JS.make_diffusion_optimizer(lr=LR)
    jstate = JS.create_train_state(variables, jtx, jax.random.PRNGKey(4))
    jd = jax_make_diffusion(steps=100)
    jstep = jax.jit(JDT.make_diffusion_train_step(jmdm, jd, jtx))
    jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, batch_of(40, cfg=cfg)))

    tmdm = PD.MDM(torch_cfg(cfg))
    ptx = PO.make_diffusion_optimizer(lr=LR)
    pstate = PS.create_train_state(tmdm, ptx, torch.Generator())
    bridge.load_mdm(tmdm, {"params": jax.tree.map(np.asarray, jstate.params),
                           **jax.tree.map(np.asarray, jstate.model_state)})
    pstate.opt_state = bridge.optax_state_from_flax(jstate.opt_state, pstate.opt_state, pstate.layout)
    pstate.step = int(jstate.step)

    batch = batch_of(41, cfg=cfg)
    draws = jax_step_draws(jstate, batch["latent_in"].shape, 100)
    grads = jax_grads(jmdm, jstate, jd, batch)
    jstate2, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    pstate, pm = make_diffusion_train_step(tmdm, make_diffusion(steps=100), ptx)(pstate, to_torch(batch), draws=draws)
    close(pm["predict_x0_loss"].numpy(), jm["predict_x0_loss"])
    got, ref = pstate.layout.to_flax(pstate.params), jax.tree.map(np.asarray, jstate2.params)
    for (path, g), a, b in zip(jax.tree_util.tree_leaves_with_path(grads), jax.tree.leaves(got), jax.tree.leaves(ref)):
        sure = np.abs(g) > 100 * 1e-8
        close(a[sure], b[sure], atol=1e-3 * LR, msg=jax.tree_util.keystr(path))
    assert_trees_close(pstate.stats_layout.to_flax(pstate.model_state),
                       jax.tree.map(np.asarray, jstate2.model_state["batch_stats"]))
    assert pstate.step == int(jstate2.step) == 2


# ---------------------------------------------------------------------------
# generate reads what the trainers write
# ---------------------------------------------------------------------------

TINY = ["mdm.latent_dim=32", "mdm.ff_size=64", "mdm.num_layers=2", "mdm.num_heads=2", "mdm.rope_heads=4",
        "mdm.audio_feat_dim=16", "mdm.word_feat_dim=16", "mdm.word_embed_dim=8", "mdm.vocab_size=64",
        "mdm.audio_norm=batch", "rvq_width=32", "rvq_depth=1", "diffusion.timestep_respacing=ddim4"]


def test_generate_reads_trained_checkpoints(tmp_path):
    cfg = load_config(None, TINY)
    g = np.random.default_rng(14)
    gen = torch.Generator().manual_seed(0)
    rvq_paths, trained = [], {}
    for i, part in enumerate(("upper", "hands", "lower")):
        rcfg = rvq_config(cfg, part)
        module = PR.build_rvqvae(rcfg, seed=i, device="cpu")[0]
        tx = PO.make_rvq_optimizer(warmup_iters=1)
        st = PS.create_train_state(module, tx, gen, quantizer_state=PQ.init_rvq_state(rcfg.quantizer))
        st, _ = make_rvq_train_step(module, tx)(st, torch.as_tensor(g.standard_normal((2, 16, rcfg.input_dim)),
                                                                    dtype=torch.float32))
        rvq_paths.append(str(PS.save_checkpoint(tmp_path / f"rvq_{part}", st)))
        trained[part] = (module, st.quantizer_state)
    mdm = PD.build_mdm(cfg.mdm, seed=0, device="cpu")
    tx = PO.make_diffusion_optimizer()
    st = PS.create_train_state(mdm, tx, gen)
    batch = {"latent_in": torch.randn(2, 8, cfg.mdm.latent_total_dim, generator=gen),
             "audio": torch.randn(2, 533 * 32, 2, generator=gen) * 0.1,
             "word": torch.randint(0, cfg.mdm.vocab_size, (2, 32), generator=gen)}
    st, _ = make_diffusion_train_step(mdm, make_diffusion(steps=cfg.diffusion.steps), tx)(st, batch)
    mdm_path = PS.save_checkpoint(tmp_path / "mdm", st)

    overrides = TINY + [f"test_ckpt={mdm_path}", f"rvq_ckpts=[{','.join(rvq_paths)}]"]
    loaded, rvq, _, _ = GEN.load_models(load_config(None, overrides), "cpu")
    mdm.eval()
    for (n, a), b in zip(mdm.state_dict().items(), loaded.state_dict().values()):
        assert torch.equal(a, b), n
    for part, (module, qstate) in trained.items():
        for (n, a), b in zip(module.state_dict().items(), rvq[part][0].state_dict().values()):
            assert torch.equal(a, b), (part, n)
        assert torch.equal(rvq[part][1].codebook, qstate.codebook)

    sr, seconds = 16000, 4.5
    y = (np.sin(np.arange(int(sr * seconds)) * 0.05) * 0.3 * 32767).astype(np.int16)
    wavfile.write(str(tmp_path / "a.wav"), sr, y)
    out = tmp_path / "out.npz"
    GEN.main(["--wav", str(tmp_path / "a.wav"), "--out", str(out), "--run-dir", str(tmp_path / "run"), "--device",
              "cpu", *overrides])
    with np.load(out) as f:
        assert f["poses"].shape[1] == 165 and np.isfinite(f["poses"]).all() and np.isfinite(f["trans"]).all()
