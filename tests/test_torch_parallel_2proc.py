"""The port's process-group forms in two real processes (gloo on the CPU,
``file://`` rendezvous), against one process on the global batch and
against JAX.

Two ranks (``torch.multiprocessing.spawn`` of
``tests/torch_parallel_worker.py``, which imports no JAX) run one module
of work each; JAX's references are computed here, in the test process:

- three data-parallel steps of a denoiser whose wav encoder is the h3d
  configuration's BatchNorm (``audio_norm='batch'``, drop-path and the
  audio condition dropout on), from the same seed and global batches,
  against the same steps in one process: loss rtol 2e-4, params 1e-5
  relative, the BatchNorm running statistics to 1e-6, every rank the same
  bit for bit (SGD: the trainer's Adam would move each zero-gradient bias
  in front of a norm by its whole rate, in the direction of f32 noise);
- three RVQ-VAE steps on JAX's draws (the lazy init from the global
  batch's first rows, which span both ranks; the EMA; quantizer dropout)
  against one process and against JAX's step on a ``data=4`` mesh of
  ``tests/conftest.py``'s devices: loss rtol 2e-4, params 1e-5 relative
  (plus 1e-3 of the learning rate: Adam moves an element whose gradient is
  f32 noise by up to a learning rate's fraction), codebooks within 2e-5
  and the same bit for bit on both ranks;
- ``DeviceDataset``'s ``data_sharded`` batches against its replicated
  ones, bit for bit;
- the tensor-parallel forward of the full-width MDM with two blocks
  (``model=2``) against its replicated forward: atol 5e-5, rtol 1e-5
  (JAX's ``tests/test_parallel.py``);
- ``init_multihost`` / ``is_primary``'s topology;
- ``RVQTrainer``'s loop under the group on a window set sharded over the
  data axis, against the loop in one process (loss rtol 2e-4).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from syntalker_tpu.models.rvqvae import RVQVAE as JaxRVQVAE
from syntalker_tpu.ops import quantize as JQ
from syntalker_tpu.parallel import mesh as JM
from syntalker_tpu.train import state as JS
from syntalker_tpu.train.rvq_trainer import RVQLossConfig as JaxLossConfig
from syntalker_tpu.train.rvq_trainer import make_rvq_train_step as jax_rvq_step
from syntalker_tpu_torch.data.synthetic import make_corpus
from syntalker_tpu_torch.models import rvqvae as PR
from syntalker_tpu_torch.ops import quantize as PQ
from syntalker_tpu_torch.train import optim as PO
from syntalker_tpu_torch.train import state as PS
from test_torch_train_rvq import LR, assert_trees_close, close, configs, jax_rvq_draws
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

WORLD = 2
STEPS = 3
LOSS_RTOL = 2e-4
PARAM_REL = 1e-5
CODEBOOK_ABS = 2e-5
RUNNING_ABS = 1e-6
DEADLINE_S = 240

DIFFUSION_CFG = dict(latent_total_dim=48, latent_dim=32, ff_size=64, num_layers=2, num_heads=2, rope_heads=4,
                     audio_feat_dim=16, word_feat_dim=16, word_embed_dim=8, vocab_size=32, audio_norm="batch",
                     cond_mask_prob_audio=0.2)


def diffusion_spec():
    g = np.random.default_rng(1)
    batches = [{"latent_in": g.standard_normal((4, 8, 48)).astype(np.float32),
                "audio": (0.1 * g.standard_normal((4, 533 * 32, 2))).astype(np.float32),
                "word": g.integers(0, 32, (4, 32))} for _ in range(STEPS)]
    return {"cfg": DIFFUSION_CFG, "seed": 0, "lr": 0.1, "batches": batches}


def rvq_job():
    """The RVQ-VAE of ``test_torch_train_rvq``'s configuration, seeded in
    the port and copied into JAX's module (flax's eager init of it takes
    ~16 s), JAX's draws of three steps and JAX's three steps on a data=4
    mesh."""
    jc, pc = configs()
    torch.manual_seed(5)
    module = PR.RVQVAE(pc)
    pstate = PS.create_train_state(module, PO.make_rvq_optimizer(lr=LR, warmup_iters=2), torch.Generator())
    jtx = JS.make_rvq_optimizer(lr=LR, warmup_iters=2)
    jparams = jax.tree.map(jnp.asarray, pstate.layout.to_flax(pstate.params))
    jstate = JS.create_train_state(jparams, jtx, jax.random.PRNGKey(6), quantizer_state=JQ.init_rvq_state(jc.quantizer))
    jstep = jax.jit(jax_rvq_step(JaxRVQVAE(jc), jtx, JaxLossConfig()))
    g = np.random.default_rng(6)
    batches = [g.standard_normal((4, 16, 12)).astype(np.float32) for _ in range(STEPS)]
    mesh = JM.make_mesh(4, 1, devices=jax.devices()[:4])
    jstate = JM.replicate(jstate, mesh)
    draws, jax_metrics = [], []
    for batch in batches:
        k_q = jax.random.split(jstate.rng, 3)[1]  # the step's quantizer key (TrainState.next_rngs)
        draws.append(PR.RVQVAEDraws([None] * 8, jax_rvq_draws(k_q, jc.quantizer, batch.shape[0] * 4)))
        jstate, m = jstep(jstate, JM.shard_batch(jnp.asarray(batch), mesh))
        jax_metrics.append({k: float(v) for k, v in m.items()})
    spec = {"cfg": pc, "lr": LR, "batches": batches, "draws": draws,
            "weights": {k: v.detach().clone() for k, v in module.state_dict().items()},
            "qstate": PQ.init_rvq_state(pc.quantizer)}
    return spec, jax_metrics, jstate, pstate.layout


def trainer_spec(d):
    """A small corpus and its 16-frame window cache (built here; the ranks
    reuse it), the RVQ-VAE trainer's overrides (the window set on the
    device, batch 8 over the data axis of every rank) and a budget that
    only half the set fits; and the loop in one process (the whole set)."""
    make_corpus(d / "corpus", speakers=(2, 4), clips_per_speaker=2, seconds_range=(8.0, 9.0), seed=2)
    spec = {"corpus": str(d / "corpus"), "cache": str(d / "cache"), "iters": STEPS,
            "overrides": ["mdm.latent_total_dim=48", "rvq_width=16", "rvq_depth=1", "rvq_train.batch_size=8",
                          "rvq_train.warmup_iters=2", "train.log_period=1", "train.device_data=true",
                          f"train.ckpt_dir={d / 'ckpt'}"]}
    one = W.rvq_trainer_losses(spec)
    return {**spec, "budget": one["nbytes"] // 2 + 64}, one


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("two_ranks")
    rvq_spec, jax_metrics, jstate, layout = rvq_job()
    trainer, one_trainer = trainer_spec(d)
    job = {"diffusion": diffusion_spec(), "rvq": rvq_spec, "trainer": trainer}
    torch.save(job, d / "job.pt")
    ctx = torch.multiprocessing.spawn(W.worker, args=(WORLD, str(d / "rendezvous"), str(d / "job.pt"), str(d)),
                                      nprocs=WORLD, join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the two ranks did not finish in {DEADLINE_S} s")
    outs = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"job": job, "outs": outs, "jax_metrics": jax_metrics, "jstate": jstate, "layout": layout,
            "one_trainer": one_trainer}


def rel_close(a: torch.Tensor, b: torch.Tensor, rel: float, atol: float = 0.0, msg=""):
    close(a.numpy(), b.numpy(), rel, atol, msg)


def test_topology(ranks):
    for r, out in enumerate(ranks["outs"]):
        assert out["info"] == {"process_index": r, "process_count": WORLD, "local_devices": 1,
                               "global_devices": WORLD}
        assert out["primary"] == (r == 0)
        assert out["data_axis"] == (WORLD, r)


def test_diffusion_step_matches_one_process(ranks):
    one = W.diffusion_steps(ranks["job"]["diffusion"])
    outs = [o["diffusion"] for o in ranks["outs"]]
    np.testing.assert_allclose(outs[0]["loss"], one["loss"], rtol=LOSS_RTOL)
    assert outs[0]["loss"] == outs[1]["loss"]
    for name, ref in one["params"].items():
        rel_close(outs[0]["params"][name], ref, PARAM_REL, msg=name)
        assert torch.equal(outs[0]["params"][name], outs[1]["params"][name]), name


def test_batchnorm_takes_the_global_moments(ranks):
    one = W.diffusion_steps(ranks["job"]["diffusion"])
    outs = [o["diffusion"] for o in ranks["outs"]]
    assert len(one["running"]) == 2 * 16  # mean and var of the wav encoder's 16 BatchNorms
    for name, ref in one["running"].items():
        assert (outs[0]["running"][name] - ref).abs().max() <= RUNNING_ABS, name
        assert torch.equal(outs[0]["running"][name], outs[1]["running"][name]), name
    # the moments moved: a rank's own half-batch would give other statistics
    assert all((v - (0.0 if "mean" in k else 1.0)).abs().max() > 1e-3 for k, v in one["running"].items())


def test_rvq_step_matches_one_process_and_jax(ranks):
    spec = ranks["job"]["rvq"]
    one = W.rvq_steps(spec)
    outs = [o["rvq"] for o in ranks["outs"]]
    for step, (got, ref, jref) in enumerate(zip(outs[0]["metrics"], one["metrics"], ranks["jax_metrics"])):
        assert set(got) == set(ref) == set(jref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, err_msg=f"step {step} {k}")
            np.testing.assert_allclose(got[k], jref[k], rtol=LOSS_RTOL, err_msg=f"step {step} {k} (JAX)")
    for name, ref in one["params"].items():
        rel_close(outs[0]["params"][name], ref, PARAM_REL, 1e-3 * LR, name)
        assert torch.equal(outs[0]["params"][name], outs[1]["params"][name]), name
    jq = ranks["jstate"].quantizer_state
    for field in ("codebook", "code_sum", "code_count"):
        a, b = getattr(outs[0]["quantizer"], field), getattr(outs[1]["quantizer"], field)
        assert torch.equal(a, b), field  # the EMA codebooks are the same on every rank, bit for bit
        assert (a - getattr(one["quantizer"], field)).abs().max() <= CODEBOOK_ABS, field
        assert np.abs(a.numpy() - np.asarray(getattr(jq, field))).max() <= CODEBOOK_ABS, field
    assert_trees_close(ranks["layout"].to_flax(outs[0]["params"]), jax.tree.map(np.asarray, ranks["jstate"].params),
                       rel=PARAM_REL, atol=1e-3 * LR)


def test_device_dataset_shards_give_the_replicated_batches(ranks):
    for out in ranks["outs"]:
        ds = out["dataset"]
        assert ds["placements"] == ("replicated", "data_sharded")
        assert ds["rows"] == {"pose": (6, 8, 3), "word": (6, 8)}  # 11 windows padded to 12, 6 a rank
        assert len(ds["same"]) == 4 and all(ds["same"])


def test_tensor_parallel_forward_matches_replicated(ranks):
    outs = [o["tp"] for o in ranks["outs"]]
    for out in outs:
        assert out["heads"] == [2, 2] and out["qkv_rows"] == 3 * 512 // 2  # whole heads: 2 of 4 a rank
        np.testing.assert_allclose(out["out"].numpy(), out["ref"].numpy(), atol=5e-5, rtol=1e-5)
    assert torch.equal(outs[0]["out"], outs[1]["out"])


def test_rvq_trainer_loop_over_a_sharded_window_set(ranks):
    """``RVQTrainer`` under the group: every rank loads the global batch,
    takes its shard and reduces; the window set, too large for a rank's
    budget, sits half on each rank. Its losses are the one-process loop's
    on the whole set; only the primary writes the checkpoint."""
    one = ranks["one_trainer"]
    outs = [o["trainer"] for o in ranks["outs"]]
    assert one["placement"] == "replicated" and [o["placement"] for o in outs] == ["data_sharded"] * WORLD
    assert len(one["loss"]) == STEPS
    np.testing.assert_allclose(outs[0]["loss"], one["loss"], rtol=LOSS_RTOL)
    assert outs[0]["loss"] == outs[1]["loss"]
    assert outs[0]["saved"].name == f"step_{STEPS}.npz" and outs[1]["saved"] is None
