"""Diffusion (denoiser) training CLI.

Usage: python -m syntalker_tpu_torch.cli.train -c configs/diffusion_beat2.yaml \
           rvq_ckpts=[up.npz,hands.npz,lower.npz] [--device cpu]

Counterpart of ``syntalker_tpu/cli/train.py``: builds (or reuses) the
training split's window cache of ``data.data_path`` under
``data.cache_path``, then runs the configured trainer (``trainer``,
default ``diffusion_rvqvae``) for ``train.epochs`` epochs, writing
``<train.ckpt_dir>/step_<N>.npz`` every ``train.test_period`` epochs and at
the end. Runs on CUDA unless ``--device cpu``. Data-parallel on N cards:
``torchrun --nproc_per_node=N -m syntalker_tpu_torch.cli.train ...``
(``train.data_parallel`` / ``train.model_parallel`` shape the mesh; the
primary rank builds the cache and writes the checkpoints).
"""

from __future__ import annotations

import logging

import syntalker_tpu_torch.components  # noqa: F401  (fills the registries)
from syntalker_tpu_torch.cli.common import base_parser, load_smplx_if_available, primary_first, setup
from syntalker_tpu_torch.data.cache import ClipConfig
from syntalker_tpu_torch.parallel.multihost import init_multihost
from syntalker_tpu_torch.registry import DATASETS, TRAINERS

log = logging.getLogger("syntalker")


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    # one process per device under torchrun; nothing in a single process
    init_multihost(backend="gloo" if args.device == "cpu" else None)
    cfg = setup(args)
    smplx_model = load_smplx_if_available(cfg, args.device)

    clip_cfg = ClipConfig(pose_fps=cfg.data.pose_fps, audio_sr=cfg.data.audio_sr, pose_length=cfg.data.pose_length,
                          stride=cfg.data.stride)
    build_cache = DATASETS.get(cfg.data.dataset)
    train_cache, _vocab = primary_first(lambda: build_cache(
        cfg.data.data_path, cfg.data.cache_path, split="train", speakers=cfg.data.training_speakers, cfg=clip_cfg,
        smplx_model=smplx_model))

    trainer = TRAINERS.get(cfg.trainer)(cfg, train_cache, device=args.device)
    for epoch in range(cfg.train.epochs):
        metrics = trainer.train_epoch(epoch)
        log.info(f"epoch {epoch}: {metrics}")
        if (epoch + 1) % cfg.train.test_period == 0 or epoch == cfg.train.epochs - 1:
            log.info(f"checkpoint: {trainer.save()}")
    return trainer


if __name__ == "__main__":
    main()
