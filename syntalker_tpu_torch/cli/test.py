"""BEAT2 evaluation CLI: FGD / BeatAlign / L1Div / SRGR on the test split.

Usage: python -m syntalker_tpu_torch.cli.test -c configs/diffusion_beat2.yaml \
           test_ckpt=... rvq_ckpts=[...] data.smplx_model_path=synthetic \
           [--eval-vae-ckpt eval_vae/step_N.npz] [--max-clips N] [--batch-clips N] [--device cpu]

Counterpart of ``syntalker_tpu/cli/test.py``, step for step: the test cache
(with foot contacts and h3d arrays when an SMPL-X model is configured), the
BeatAlign mean joint velocity (``<data_path>/weights/mean_vel_smplxflame_30.npy``
when shipped, else computed by the port's FK from the test clips and kept
beside the cache), the config's denoiser and RVQ stack (npz checkpoints or
seeded initializations, as ``generate`` loads them), the FGD eval VAE (an npz
that ``cli.train_aux --model eval_vae`` writes, or a seeded one), then
``GestureEvaluator.evaluate`` (K2 a denoise step, K3 in the decode on the
card). Writes ``<run-dir>/metrics.json`` and the ``res_``/``gt_`` npz pairs
under ``<run-dir>/results``. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.cli import generate as GEN
from syntalker_tpu_torch.cli.common import base_parser, load_smplx_if_available, setup
from syntalker_tpu_torch.config import ExperimentConfig
from syntalker_tpu_torch.data.beat_builder import build_beat_cache
from syntalker_tpu_torch.data.cache import ClipConfig
from syntalker_tpu_torch.data.stats import compute_mean_velocity_from_clips
from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.eval.harness import GestureEvaluator
from syntalker_tpu_torch.models.eval_vae import EvalVAEConfig, build_eval_vae
from syntalker_tpu_torch.train.state import TRAIN_ONLY_KEYS, load_checkpoint_npz

log = logging.getLogger("syntalker")

MEAN_VEL_FILE = "mean_vel_smplxflame_30.npy"
EVAL_VAE_SEED = 1


def build_evaluator(cfg: ExperimentConfig, smplx_model=None, eval_vae_ckpt: str = "",
                    mean_velocity: np.ndarray | None = None, *, device=None) -> GestureEvaluator:
    device = resolve_device(device)
    mdm, rvq, _, stats = GEN.load_models(cfg, device)
    diffusion = make_diffusion(schedule=cfg.diffusion.schedule, steps=cfg.diffusion.steps,
                               timestep_respacing=cfg.diffusion.timestep_respacing or None)
    if eval_vae_ckpt:
        params = load_checkpoint_npz(eval_vae_ckpt, skip=TRAIN_ONLY_KEYS)["params"]
        eval_vae = bridge.eval_vae_from_flax(params, EvalVAEConfig(), device=device)
    else:
        eval_vae = build_eval_vae(EvalVAEConfig(), seed=EVAL_VAE_SEED, device=device)
    if mean_velocity is None:
        mv_file = Path(cfg.data.data_path) / "weights" / MEAN_VEL_FILE
        mean_velocity = np.load(mv_file) if mv_file.exists() else None
    return GestureEvaluator(mdm=mdm, diffusion=diffusion, rvq_modules=rvq, stats=stats, eval_vae=eval_vae,
                            smplx_model=smplx_model, mean_velocity=mean_velocity, pose_length=cfg.data.pose_length,
                            pre_frames=cfg.pre_frames, latent_scale=cfg.latent_scale, sampler=cfg.diffusion.sampler,
                            device=device)


def main(argv=None):
    """Returns the ``EvalResult``."""
    p = base_parser(__doc__)
    p.add_argument("--eval-vae-ckpt", type=str, default="", help="an eval-VAE npz checkpoint")
    p.add_argument("--max-clips", type=int, default=None)
    p.add_argument("--batch-clips", type=int, default=1, help="generate N same-window-count clips per batch")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    cfg = setup(args)
    device = resolve_device(args.device)
    smplx_model = load_smplx_if_available(cfg, device)

    test_cache, _ = build_beat_cache(cfg.data.data_path, cfg.data.cache_path, split="test",
                                     speakers=cfg.data.training_speakers,
                                     cfg=ClipConfig(pose_length=cfg.data.pose_length), smplx_model=smplx_model)
    # the BeatAlign normalizer: the shipped dataset statistic, else computed
    # from the test clips by the port's FK and kept beside the cache
    mean_vel = None
    if not (Path(cfg.data.data_path) / "weights" / MEAN_VEL_FILE).exists() and smplx_model is not None:
        mv_cache = Path(cfg.data.cache_path) / MEAN_VEL_FILE
        if mv_cache.exists():
            mean_vel = np.load(mv_cache)
        else:
            log.info("computing the mean joint velocity from the cached clips (SMPL-X FK)")
            mean_vel = compute_mean_velocity_from_clips(list(test_cache.clips.values()), smplx_model)
            mv_cache.parent.mkdir(parents=True, exist_ok=True)
            np.save(mv_cache, mean_vel)

    evaluator = build_evaluator(cfg, smplx_model, args.eval_vae_ckpt, mean_vel, device=device)
    result = evaluator.evaluate(test_cache, 999, out_dir=Path(args.run_dir) / "results", max_clips=args.max_clips,
                                batch_clips=args.batch_clips)
    out = Path(args.run_dir) / "metrics.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result.as_dict(), indent=1))
    log.info(f"metrics -> {out}")
    return result


if __name__ == "__main__":
    main()
