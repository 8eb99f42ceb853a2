"""The trainers' loops, and the body-part RVQ-VAE stack.

Counterpart of ``syntalker_tpu/train/loop.py``:

- ``rvq_config`` and ``load_rvq_stack``: one RVQ-VAE per body part, sized
  to a third of the denoiser's latent, loaded from npz checkpoints (see
  :mod:`syntalker_tpu_torch.train.state`) or, without one, initialized from
  a seed. JAX's fresh quantizer state has all-zero codebooks; the stack's
  are drawn from ``randn`` so that the snap has codes to choose between.
- ``RVQTrainer`` trains one body part's RVQ-VAE for a number of
  iterations, ``DiffusionTrainer`` the denoiser epoch by epoch on latents
  of the frozen RVQ-VAE encoders. Each step featurizes the batch on the
  device and runs the train step of
  :mod:`~syntalker_tpu_torch.train.rvq_trainer` or
  :mod:`~syntalker_tpu_torch.train.diffusion_trainer`. On the ``beat330``
  representation the features are ``pose_to_part_rot6d`` under the pose
  statistics, with the lower part's translation velocity; on ``h3d623``
  (the text-control stack) they are the cache's 623-d ``h3d`` arrays under
  the h3d statistics, cut by ``part_mask_623`` (no translation channel),
  and a frozen TMR motion encoder (``tmr_motion``) gives the denoiser its
  prompt where a batch has none.

Batches come from the host ``BatchLoader`` or, with ``train.device_data``,
from a ``DeviceDataset``: the whole window set on the trainer's device (or,
under a data-parallel mesh, its slice when the whole does not fit), each
batch gathered there by index. A set above the budget raises
``DatasetTooLargeError``, and the trainer logs it and streams host batches
instead, as JAX's does. Every draw of a step comes from the train state's
``torch.Generator`` unless the caller passes ``draws``, a callable
``(it) -> draws`` of the loop's iteration (the CPU tests feed JAX's draws
this way).

Data and model parallelism run one process per device over
``torch.distributed`` (``torchrun``; :func:`~syntalker_tpu_torch.parallel.multihost.init_multihost`):
the mesh is ``train.data_parallel`` x ``train.model_parallel`` over the
process group (-1: the ranks that remain). Every rank loads the same global
batch (``batch_size`` is global, as in JAX) and trains on its data shard;
the steps average the gradients over the data axis, so every rank applies
the same update. ``model_parallel > 1`` replicates the parameters over the
model axis, as JAX's trainer does. Checkpoints and logs are the primary
rank's. A mesh larger than the group raises.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.config import ExperimentConfig, body_part_rvq_config
from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.data.cache import BatchLoader, BeatCache, DatasetTooLargeError, DeviceDataset
from syntalker_tpu_torch.data.features import pose_to_part_rot6d
from syntalker_tpu_torch.data.h3d import H3D_PART_DIMS, part_mask_623
from syntalker_tpu_torch.data.stats import (H3DStats, PoseStats, identity_h3d_stats, identity_pose_stats,
                                            load_h3d_stats, load_pose_stats)
from syntalker_tpu_torch.data.vocab import Vocab
from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import apply_word_embedding, build_mdm
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
from syntalker_tpu_torch.ops.quantize import RVQConfig, init_rvq_state
from syntalker_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch
from syntalker_tpu_torch.parallel.multihost import group_started, is_primary
from syntalker_tpu_torch.train import optim
from syntalker_tpu_torch.train import state as ts
from syntalker_tpu_torch.train.diffusion_trainer import (DiffusionTrainConfig, make_diffusion_train_step,
                                                         make_latent_encoder)
from syntalker_tpu_torch.train.rvq_trainer import RVQLossConfig, make_rvq_train_step
from syntalker_tpu_torch.utils.tracking import EpochTracker, StepTimer, set_random_seed

log = logging.getLogger("syntalker")

RVQ_SEED_OFFSET = 99  # the RVQ stack's seeds, after the denoiser's


def rvq_config(cfg: ExperimentConfig, part: str) -> RVQVAEConfig:
    """A body part's RVQ-VAE config: code width a third of the denoiser's
    latent, input width of the chosen motion representation."""
    code_dim = cfg.mdm.latent_total_dim // J.NUM_PARTS
    q = RVQConfig(code_dim=code_dim, nb_code=512)
    if cfg.representation == "h3d623":
        rcfg = RVQVAEConfig(input_dim=H3D_PART_DIMS[part], width=cfg.rvq_width, depth=cfg.rvq_depth, quantizer=q)
    else:
        rcfg = body_part_rvq_config(part, cfg.rvq_width, cfg.rvq_depth, q)
    return dataclasses.replace(rcfg, output_emb_width=code_dim)


def load_rvq_stack(cfg: ExperimentConfig, *, seed: int, device=None) -> Dict[str, tuple]:
    """Body part -> (RVQVAE, RVQState): from ``cfg.rvq_ckpts`` (upper, hands,
    lower) where given, else initialized with ``seed + i`` for part i."""
    device = resolve_device(device)
    out = {}
    for i, part in enumerate(("upper", "hands", "lower")):
        rcfg = rvq_config(cfg, part)
        if i < len(cfg.rvq_ckpts) and cfg.rvq_ckpts[i]:
            raw = ts.load_checkpoint_npz(cfg.rvq_ckpts[i], skip=ts.TRAIN_ONLY_KEYS)
            out[part] = bridge.rvqvae_from_flax(rcfg, raw["params"], raw["quantizer_state"]["codebook"],
                                                device=device)
        else:
            out[part] = build_rvqvae(rcfg, seed=seed + i, device=device)
    return out


def check_supported(cfg: ExperimentConfig) -> None:
    """Raise for a mesh larger than the process group (one process when
    there is none): nothing falls back to fewer devices."""
    world = torch.distributed.get_world_size() if group_started() else 1
    data, model = cfg.train.data_parallel, cfg.train.model_parallel
    if model < 1 or model * max(data, 1) > world or (data == -1 and world % model):
        raise ValueError(
            f"train.data_parallel={data} x train.model_parallel={model} is larger than the process group of {world}: "
            "start one process per device (torchrun --nproc_per_node=N -m syntalker_tpu_torch.cli.train ...)")


def train_mesh(cfg: ExperimentConfig, device=None) -> Optional[Mesh]:
    """The trainers' (data, model) mesh over the process group, each rank
    on ``device`` when given; None in a single process."""
    check_supported(cfg)
    if not group_started():
        return None
    devices = None if device is None else [device] * torch.distributed.get_world_size()
    return make_mesh(cfg.train.data_parallel, cfg.train.model_parallel, devices=devices)


def pose_stats(cfg: ExperimentConfig, stats: Optional[PoseStats]) -> PoseStats:
    """The given stats, else those in ``data.mean_std_dir``, else identity."""
    if stats is not None:
        return stats
    return load_pose_stats(cfg.data.mean_std_dir) if Path(cfg.data.mean_std_dir).exists() else identity_pose_stats()


def h3d_stats(cfg: ExperimentConfig) -> H3DStats:
    """The 623-d statistics in ``data.mean_std_dir``, else identity."""
    return load_h3d_stats(cfg.data.mean_std_dir) if Path(cfg.data.mean_std_dir).exists() else identity_h3d_stats()


Draws = Optional[Callable[[int], object]]


class _Loop:
    """What both trainers share: the host loader, the device-resident
    dataset and an epoch's steps from either."""

    device: torch.device
    loader: BatchLoader
    _batch_keys: tuple

    def _init_loop(self, cfg: ExperimentConfig, cache: BeatCache, batch_size: int, device) -> None:
        self.mesh = train_mesh(cfg, device)
        self.cfg = cfg
        self.device = resolve_device(device) if self.mesh is None else self.mesh.device
        set_random_seed(cfg.train.seed)
        self.loader = BatchLoader(cache, batch_size, seed=cfg.train.seed)
        self._dataset = None
        self.history: list = []  # one entry a logged iteration

    def device_dataset(self) -> DeviceDataset:
        """The whole cache on the trainer's device, made at first use."""
        if self._dataset is None:
            self._dataset = DeviceDataset(self.loader.cache, self._batch_keys, self.loader.batch_size,
                                          seed=self.cfg.train.seed, device=self.device, mesh=self.mesh)
            if is_primary():
                log.info(f"device-resident dataset: {self._dataset.n} windows, {self._dataset.nbytes / 1e9:.2f} GB "
                         f"copied once to {self.device} ({self._dataset.placement})")
        return self._dataset

    def _to_device(self, batch: dict) -> Dict[str, torch.Tensor]:
        """A global batch's tensors, this rank's data shard under a mesh."""
        batch = {k: batch[k] for k in self._batch_keys if k in batch}
        if self.mesh is not None:
            return shard_batch(batch, self.mesh)[0]
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _replicate(self, module: torch.nn.Module) -> None:
        """Rank 0's weights on every rank (replicated over the model axis
        too)."""
        if self.mesh is not None:
            replicate(module, self.mesh)

    def epoch_batches(self, epoch: int):
        """The epoch's batches as device tensors (this rank's data shard
        under a mesh): gathered from the device-resident dataset with
        ``train.device_data``, else copied from the host loader's."""
        if self.cfg.train.device_data:
            try:
                ds = self.device_dataset()
            except DatasetTooLargeError as e:
                log.warning(f"{e}; streaming batches from the host instead")
                self.cfg = dataclasses.replace(self.cfg, train=dataclasses.replace(self.cfg.train,
                                                                                   device_data=False))
            else:
                for idx in ds.epoch_indices(epoch):
                    yield self._to_device(ds.batch(idx))
                return
        for batch in self.loader.epoch(epoch):
            yield self._to_device(batch)


class DiffusionTrainer(_Loop):
    """Epoch-based denoiser training (the reference's
    diffusion_rvqvae_trainer.py:543-571) on latents of the frozen RVQ stack
    of ``cfg.rvq_ckpts``. On ``h3d623``, ``tmr_motion`` (a frozen
    ``ActorAgnosticEncoder`` on the trainer's device) embeds each batch's
    normalized 623-d clip, and its ``mu`` is the prompt of a batch without
    one (the self-supervised prompt channel,
    h3d_diffusion_new_trainer.py:351-392)."""

    def __init__(self, cfg: ExperimentConfig, cache: BeatCache, stats: Optional[PoseStats] = None, *,
                 tmr_motion: Optional[torch.nn.Module] = None, device=None):
        self._init_loop(cfg, cache, cfg.train.batch_size, device)
        self.tmr_motion = tmr_motion
        self.stats = pose_stats(cfg, stats)
        self.mdm = build_mdm(cfg.mdm, seed=cfg.train.seed, device=self.device)
        if cfg.data.vocab_path and Path(cfg.data.vocab_path).exists():
            # a vocab that stores the pretrained fasttext matrix seeds the word table
            vocab = Vocab.load(cfg.data.vocab_path)
            if vocab.word_embedding_weights is not None:
                apply_word_embedding(self.mdm, vocab.word_embedding_weights)
        self.rvq = load_rvq_stack(cfg, seed=cfg.train.seed + RVQ_SEED_OFFSET, device=self.device)
        self.diffusion = make_diffusion(schedule=cfg.diffusion.schedule, steps=cfg.diffusion.steps,
                                        timestep_respacing=cfg.diffusion.timestep_respacing or None)
        self._replicate(self.mdm)
        self.optimizer = optim.make_diffusion_optimizer(cfg.train.lr, cfg.train.grad_clip)
        self.state = ts.create_train_state(self.mdm, self.optimizer,
                                           torch.Generator(self.device).manual_seed(cfg.train.seed))
        self._raw_step = make_diffusion_train_step(self.mdm, self.diffusion, self.optimizer,
                                                   DiffusionTrainConfig(cfg.pre_frames, cfg.latent_scale),
                                                   mesh=self.mesh)
        if cfg.representation == "h3d623":
            self.h3d_stats = h3d_stats(cfg)
            self._masks = {p: torch.as_tensor(part_mask_623(p), device=self.device).long() for p in J.LATENT_SLICES}
            self._batch_keys = ("h3d", "audio", "word")
        else:
            self._encode_latent = make_latent_encoder(self.rvq, self.stats, latent_scale=cfg.latent_scale)
            self._batch_keys = ("pose", "trans_v", "audio", "word")
        self.tracker = EpochTracker({"fid": False, "bc": True, "l1div": True})

    @torch.no_grad()
    def _h3d_inputs(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        x = self.h3d_stats.normalize(batch["h3d"])
        latent_in = torch.cat([self.rvq[p][0].map2latent(x[..., self._masks[p]]) for p in J.LATENT_SLICES],
                              dim=-1) / self.cfg.latent_scale
        out = {"latent_in": latent_in}
        if "prompt" in batch:
            out["prompt"] = batch["prompt"]
        elif self.tmr_motion is not None:
            out["prompt"] = self.tmr_motion(x)[0]
        return out

    def featurize(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A window batch -> the step's inputs: scaled latents of the frozen
        encoders (and, on ``h3d623``, the prompt), the raw audio and the
        word ids."""
        if self.cfg.representation == "h3d623":
            out = self._h3d_inputs(batch)
        else:
            parts = pose_to_part_rot6d(batch["pose"][..., : J.AXIS_ANGLE_DIM])
            out = {"latent_in": self._encode_latent(parts["upper"], parts["hands"], parts["lower"], batch["trans_v"])}
        return {**out, "audio": batch["audio"], "word": batch["word"].long()}

    def step(self, state: ts.TrainState, batch: Dict[str, torch.Tensor], draws=None):
        return self._raw_step(state, self.featurize(batch), draws=draws)

    def maybe_resume(self) -> int:
        """Restore the whole train state from ``train.resume`` or the newest
        checkpoint in ``train.ckpt_dir``. Returns the restored step (0 when
        there is none)."""
        path = self.cfg.train.resume or ts.latest_checkpoint(self.cfg.train.ckpt_dir)
        if not path:
            return 0
        ts.load_checkpoint(path, self.state)
        log.info(f"resumed from {path} at step {self.state.step}")
        return self.state.step

    def train_epoch(self, epoch: int, draws: Draws = None) -> Dict[str, float]:
        """One epoch. ``draws(it)`` gives iteration it's draws (default: the
        state's generator). With ``train.debug`` the epoch stops after two
        iterations with a save and a load of the checkpoint."""
        timer, last = StepTimer(), (time.perf_counter(), -1)
        for it, batch in enumerate(self.epoch_batches(epoch)):
            timer.mark_data()
            self.state, metrics = self.step(self.state, batch, draws=draws(it) if draws else None)
            if it % self.cfg.train.log_period == 0:
                loss = float(metrics["predict_x0_loss"])
                self.tracker.update("predict_x0_loss", "train", loss)
                timer.mark_step()
                now = time.perf_counter()
                self.history.append({"epoch": epoch, "it": it, "loss": loss, "data_ms": 1e3 * timer.data_s,
                                     "step_ms": 1e3 * timer.step_s,
                                     "ms_per_step": 1e3 * (now - last[0]) / (it - last[1])})
                last = (now, it)
                if is_primary():
                    log.info(f"epoch {epoch} it {it}: loss {loss:.4f} "
                             f"(data {timer.data_s * 1e3:.0f}ms step {timer.step_s * 1e3:.0f}ms)")
            if self.cfg.train.debug and it >= 1:
                # the checkpoint round trip of a debug run (the primary's; the others hold the same state)
                path = self.save()
                if path is not None:
                    ts.load_checkpoint(path, self.state)
                break
        return self.tracker.end_epoch(epoch)

    def save(self, step: Optional[int] = None) -> Optional[Path]:
        """Write the train state (the primary rank; None on the others)."""
        return ts.save_checkpoint(self.cfg.train.ckpt_dir, self.state, step) if is_primary() else None


class RVQTrainer(_Loop):
    """Iteration-based training of one body part's RVQ-VAE
    (``rvq_train.body_part``; the reference's rvq_beatx_train.py:333-404)."""

    def __init__(self, cfg: ExperimentConfig, cache: BeatCache, stats: Optional[PoseStats] = None, *, device=None):
        self._init_loop(cfg, cache, cfg.rvq_train.batch_size, device)
        rt = cfg.rvq_train
        self.part = rt.body_part
        self.stats = pose_stats(cfg, stats)
        rcfg = rvq_config(cfg, self.part)
        self.module = build_rvqvae(rcfg, seed=cfg.train.seed, device=self.device)[0]
        self._replicate(self.module)
        self.optimizer = optim.make_rvq_optimizer(rt.lr, rt.warmup_iters, rt.milestones, rt.gamma)
        self.state = ts.create_train_state(self.module, self.optimizer,
                                           torch.Generator(self.device).manual_seed(cfg.train.seed),
                                           quantizer_state=init_rvq_state(rcfg.quantizer, self.device))
        self.h3d = cfg.representation == "h3d623"
        self.use_trans = self.part == "lower" and cfg.data.use_trans and not self.h3d
        self._raw_step = make_rvq_train_step(self.module, self.optimizer,
                                             RVQLossConfig(commit_weight=rt.commit_weight), mesh=self.mesh)
        if self.h3d:
            self.h3d_stats = h3d_stats(cfg)
            self._mask = torch.as_tensor(part_mask_623(self.part), device=self.device).long()
            self._batch_keys = ("h3d",)
        else:
            self._batch_keys = ("pose", "trans_v")
        self.tracker = EpochTracker()

    def featurize(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """A window batch -> the part's normalized features: on ``h3d623``
        the part's channels of the normalized 623-d array; else its rot6d,
        with the normalized translation velocity on the lower part when
        ``data.use_trans``."""
        if self.h3d:
            return self.h3d_stats.normalize(batch["h3d"])[..., self._mask]
        parts = pose_to_part_rot6d(batch["pose"][..., : J.AXIS_ANGLE_DIM])
        x = self.stats.normalize_part(parts[self.part], self.part)
        if self.use_trans:
            x = torch.cat([x, self.stats.normalize_trans(batch["trans_v"])], dim=-1)
        return x

    def step(self, state: ts.TrainState, batch: Dict[str, torch.Tensor], draws=None):
        return self._raw_step(state, self.featurize(batch), draws=draws)

    def train(self, total_iters: Optional[int] = None, draws: Draws = None) -> ts.TrainState:
        """``total_iters`` steps (default ``rvq_train.total_iters``), epoch
        after epoch, with a checkpoint every ``rvq_train.save_every``.
        ``draws(it)`` gives the draws of the loop's iteration it (from 0)."""
        total = total_iters or self.cfg.rvq_train.total_iters
        if len(self.loader) == 0:
            raise ValueError(f"no full batches: {len(self.loader.cache)} windows < batch size "
                             f"{self.loader.batch_size}")
        it, epoch = 0, 0
        timer, last = StepTimer(), (time.perf_counter(), 0)
        while it < total:
            for batch in self.epoch_batches(epoch):
                timer.mark_data()
                self.state, metrics = self.step(self.state, batch, draws=draws(it) if draws else None)
                it += 1
                if it % self.cfg.train.log_period == 0:
                    m = {k: float(metrics[k]) for k in ("loss", "recon", "perplexity")}
                    timer.mark_step()
                    now = time.perf_counter()
                    self.history.append({"it": it, **m, "data_ms": 1e3 * timer.data_s, "step_ms": 1e3 * timer.step_s,
                                         "ms_per_step": 1e3 * (now - last[0]) / (it - last[1])})
                    last = (now, it)
                    if is_primary():
                        log.info(f"iter {it}: loss {m['loss']:.4f} recon {m['recon']:.4f} "
                                 f"perplexity {m['perplexity']:.1f}")
                if it % self.cfg.rvq_train.save_every == 0:
                    self.save(it)
                if it >= total:
                    break
            epoch += 1
        return self.state

    def save(self, step: Optional[int] = None) -> Optional[Path]:
        """Write the train state (the primary rank; None on the others)."""
        if not is_primary():
            return None
        return ts.save_checkpoint(Path(self.cfg.train.ckpt_dir) / f"rvq_{self.part}", self.state, step)
