"""Body-part RVQ-VAE training CLI.

Usage: python -m syntalker_tpu_torch.cli.train_rvq -c configs/rvq_beat2.yaml \
           rvq_train.body_part=upper [--device cpu]

Counterpart of ``syntalker_tpu/cli/train_rvq.py``: builds (or reuses) the
training split's cache of ``rvq_train.window``-frame windows under
``<data.cache_path>_rvq``, trains the part for ``rvq_train.total_iters``
iterations and writes ``<train.ckpt_dir>/rvq_<part>/step_<N>.npz`` (every
``rvq_train.save_every`` iterations and at the end). The three parts train
independently. Runs on CUDA unless ``--device cpu``; under ``torchrun``
data-parallel, one process per card.
"""

from __future__ import annotations

import logging

from syntalker_tpu_torch.cli.common import base_parser, load_smplx_if_available, primary_first, setup
from syntalker_tpu_torch.data.beat_builder import build_beat_cache
from syntalker_tpu_torch.data.cache import ClipConfig
from syntalker_tpu_torch.parallel.multihost import init_multihost
from syntalker_tpu_torch.train.loop import RVQTrainer

log = logging.getLogger("syntalker")


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    # one process per device under torchrun; nothing in a single process
    init_multihost(backend="gloo" if args.device == "cpu" else None)
    cfg = setup(args)
    smplx_model = load_smplx_if_available(cfg, args.device)

    clip_cfg = ClipConfig(pose_fps=cfg.data.pose_fps, audio_sr=cfg.data.audio_sr,
                          pose_length=cfg.rvq_train.window, stride=cfg.data.stride)
    cache, _ = primary_first(lambda: build_beat_cache(
        cfg.data.data_path, cfg.data.cache_path + "_rvq", split="train", speakers=cfg.data.training_speakers,
        cfg=clip_cfg, smplx_model=smplx_model))

    trainer = RVQTrainer(cfg, cache, device=args.device)
    trainer.train()
    log.info(f"final checkpoint: {trainer.save()}")
    return trainer


if __name__ == "__main__":
    main()
