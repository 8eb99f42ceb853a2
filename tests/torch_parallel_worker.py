"""The work of tests/test_torch_parallel_2proc.py, importable without JAX:
each function runs the same in the test's own process (no mesh) and in
the ranks of a process group (``worker``), so the two can be compared.

``worker`` is a rank of a gloo group on the CPU (``file://`` rendezvous),
one torch thread: the topology, three data-parallel steps of a denoiser
with a ``'batch'``-norm wav encoder and of an RVQ-VAE, a
``DeviceDataset``'s sharded batches against its replicated ones, the
tensor-parallel forward of a full-width two-block MDM against its
replicated forward, and ``RVQTrainer``'s loop on a data-sharded window set.
It saves what it saw to ``<out>/rank<r>.pt``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from syntalker_tpu_torch.data.cache import DeviceDataset
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import MDMConfig, build_mdm
from syntalker_tpu_torch.models.rvqvae import RVQVAE
from syntalker_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params
from syntalker_tpu_torch.parallel.multihost import init_multihost, is_primary
from syntalker_tpu_torch.train import optim
from syntalker_tpu_torch.train.diffusion_trainer import make_diffusion_train_step
from syntalker_tpu_torch.train.rvq_trainer import make_rvq_train_step
from syntalker_tpu_torch.train.state import create_train_state

CPU = torch.device("cpu")


def _local(batch, mesh):
    if mesh is None:
        return {k: torch.as_tensor(v) for k, v in batch.items()} if isinstance(batch, dict) else torch.as_tensor(batch)
    return shard_batch(batch, mesh)[0]


def diffusion_steps(spec: dict, mesh=None) -> dict:
    """``spec``: MDM config kwargs, seed, SGD's rate and the global
    batches. Draws from the state's generator at the global batch's shape.
    SGD, not the trainer's Adam: a convolution's bias in front of a norm
    has a zero gradient, which Adam turns into a step of its whole rate in
    the direction of f32 noise, different in one process and in two."""
    mdm = build_mdm(MDMConfig(**spec["cfg"]), seed=spec["seed"], device=CPU)
    opt = optim.sgd(spec["lr"])
    state = create_train_state(mdm, opt, torch.Generator().manual_seed(spec["seed"]))
    step = make_diffusion_train_step(mdm, make_diffusion(steps=8), opt, mesh=mesh)
    losses = []
    for batch in spec["batches"]:
        state, m = step(state, _local(batch, mesh))
        losses.append(float(m["predict_x0_loss"]))
    return {"loss": losses, "params": {k: v.detach().clone() for k, v in state.params.items()},
            "running": {k: v.clone() for k, v in mdm.named_buffers() if "running" in k}}


def rvq_steps(spec: dict, mesh=None) -> dict:
    """``spec``: the RVQ-VAE config, its initial weights and quantizer
    state, lr, and the global batches with their global draws."""
    module = RVQVAE(spec["cfg"])
    module.load_state_dict(spec["weights"])
    opt = optim.make_rvq_optimizer(lr=spec["lr"], warmup_iters=2)
    state = create_train_state(module, opt, torch.Generator().manual_seed(0), quantizer_state=spec["qstate"])
    step = make_rvq_train_step(module, opt, mesh=mesh)
    metrics = []
    for batch, draws in zip(spec["batches"], spec["draws"]):
        state, m = step(state, _local(batch, mesh), draws=draws)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": {k: v.detach().clone() for k, v in state.params.items()},
            "quantizer": state.quantizer_state}


class FakeCache:
    """Eleven windows (an odd count: the sharded set is padded) of floats,
    with negative zeros among them, and int ids."""

    def __init__(self, n=11):
        g = np.random.default_rng(0)
        self.pose = g.standard_normal((n, 8, 3)).astype(np.float32)
        self.pose[:, 0, 0] = -0.0
        self.word = g.integers(0, 1000, (n, 8))

    def __len__(self):
        return len(self.pose)

    def get(self, i):
        return {"pose": self.pose[i], "word": self.word[i]}


def dataset_batches(mesh) -> dict:
    """Two epochs of a ``DeviceDataset``, whole and sharded (a budget of
    just over half the set), batch for batch and bit for bit."""
    cache = FakeCache()
    whole = DeviceDataset(cache, ("pose", "word"), 4, seed=3, device=CPU, mesh=mesh)
    sharded = DeviceDataset(cache, ("pose", "word"), 4, seed=3, device=CPU, mesh=mesh,
                            memory_budget_bytes=whole.nbytes // 2 + 64)
    same = []
    for epoch in range(2):
        for a, b in zip(whole.epoch_indices(epoch), sharded.epoch_indices(epoch)):
            x, y = whole.batch(a), sharded.batch(b)
            same.append(np.array_equal(a, b) and torch.equal(x["word"], y["word"])
                        and torch.equal(x["pose"].view(torch.int32), y["pose"].view(torch.int32)))
    return {"placements": (whole.placement, sharded.placement), "same": same,
            "rows": {k: tuple(v.shape) for k, v in sharded.arrays.items()}}


def tp_inputs(cfg: MDMConfig, b: int = 2, frames: int = 128) -> dict:
    g = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return {"x_t": t(g.standard_normal((b, frames // 4, cfg.latent_total_dim))),
            "t": torch.tensor([7, 431]),
            "audio": t(0.1 * g.standard_normal((b, 533 * frames, 2))),
            "word": torch.as_tensor(g.integers(0, cfg.vocab_size, (b, frames))),
            "seed": t(g.standard_normal((b, cfg.n_seed, cfg.latent_total_dim)))}


@torch.no_grad()
def denoise(mdm, x) -> torch.Tensor:
    return mdm.denoise(x["x_t"], x["t"], mdm.encode_cond(x["audio"], x["word"], x["seed"]))


def tp_forward(world: int) -> dict:
    """The full-width MDM with two blocks: replicated, then under
    ``shard_params`` at model=world."""
    mdm = build_mdm(MDMConfig(num_layers=2), seed=0, device=CPU)
    x = tp_inputs(mdm.cfg)
    ref = denoise(mdm, x)
    shard_params(mdm, make_mesh(1, world, devices=[CPU] * world))
    heads = [blk.num_heads for blk in mdm.blocks]
    return {"ref": ref, "out": denoise(mdm, x), "heads": heads, "qkv_rows": mdm.blocks[0].qkv.weight.shape[0]}


def rvq_trainer_losses(spec: dict) -> dict:
    """``RVQTrainer`` on ``spec``'s cache (built from its corpus, or reused)
    for ``spec["iters"]`` iterations, the window set on the device; with
    ``spec["budget"]`` the device budget is that many bytes (the data-
    sharded tier under a group). The loop's losses, where its dataset went
    and what ``save`` returned."""
    from syntalker_tpu_torch.config import load_config
    from syntalker_tpu_torch.data import cache as PC
    from syntalker_tpu_torch.data.beat_builder import build_beat_cache
    from syntalker_tpu_torch.train.loop import RVQTrainer

    cache, _ = build_beat_cache(spec["corpus"], spec["cache"], speakers=(2, 4), cfg=PC.ClipConfig(pose_length=16))
    budget = PC.default_memory_budget
    if spec.get("budget"):
        PC.default_memory_budget = lambda device: spec["budget"]
    try:
        trainer = RVQTrainer(load_config(None, spec["overrides"]), cache, device=CPU)
        trainer.train(spec["iters"])
    finally:
        PC.default_memory_budget = budget
    ds = trainer.device_dataset()
    return {"loss": [h["loss"] for h in trainer.history], "placement": ds.placement, "nbytes": ds.nbytes,
            "saved": trainer.save()}


def worker(rank: int, world: int, rendezvous: str, job_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    info = init_multihost(f"file://{rendezvous}", world, rank, backend="gloo")
    job = torch.load(job_path, weights_only=False)
    mesh = make_mesh(world, 1, devices=[CPU] * world)
    out = {"info": info, "primary": is_primary(), "data_axis": (mesh.data.size, mesh.data.index),
           "diffusion": diffusion_steps(job["diffusion"], mesh), "rvq": rvq_steps(job["rvq"], mesh),
           "dataset": dataset_batches(mesh), "tp": tp_forward(world), "trainer": rvq_trainer_losses(job["trainer"])}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    dist.destroy_process_group()
