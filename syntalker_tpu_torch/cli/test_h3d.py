"""HumanML3D-suite evaluation CLI (the text-control stack).

Usage: python -m syntalker_tpu_torch.cli.test_h3d -c configs/diffusion_h3d.yaml \
           representation=h3d623 test_ckpt=... rvq_ckpts=[...] data.smplx_model_path=synthetic \
           [--replications 20] [--max-clips N] [--mm-repeats N] [--steering-clips 4] [--no-steering] \
           [--oracle bigru.npz] [--tmr tmr.npz|none] [--device cpu]

Counterpart of ``syntalker_tpu/cli/test_h3d.py``, step for step: the test
cache (its 623-d ``h3d`` arrays need an SMPL-X model:
``data.smplx_model_path``), the config's denoiser and h3d623 RVQ stack (npz
checkpoints or seeded initializations, as ``generate`` loads them), the h3d
statistics of ``data.mean_std_dir`` or identity, the BiGRU oracle (the
committed ``weights/t2m_oracle/bigru.npz`` unless ``--oracle``), the prompt
text pipeline (the trained TMR head of ``weights/t2m_oracle/tmr.npz`` unless
``--tmr``; ``none`` takes the seeded untrained one), caption features from
the deterministic captioner over the ground-truth joints
(``recover_from_ric``), then ``H3DEvaluator.evaluate`` over
``--replications`` and, for a ``use_prompt`` model, the steering metrics on
the first ``--steering-clips`` clips. Writes ``<train.ckpt_dir>/h3d_metrics.json``
with JAX's keys. K2 runs every denoise step and K3 every decode on the
card. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from syntalker_tpu_torch.cli import generate as GEN
from syntalker_tpu_torch.cli.common import base_parser, load_smplx_if_available, setup
from syntalker_tpu_torch.config import ExperimentConfig
from syntalker_tpu_torch.data.beat_builder import build_beat_cache
from syntalker_tpu_torch.data.cache import ClipConfig
from syntalker_tpu_torch.data.captions import caption_batch
from syntalker_tpu_torch.data.h3d import recover_from_ric
from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.eval import t2m
from syntalker_tpu_torch.eval.harness_h3d import H3DEvaluator
from syntalker_tpu_torch.models.tmr import load_text_pipeline
from syntalker_tpu_torch.train.loop import h3d_stats

log = logging.getLogger("syntalker")

DEFAULT_TMR = Path(__file__).resolve().parents[2] / "weights/t2m_oracle/tmr.npz"
EVAL_KEY, STEERING_KEY = 7, 8  # the runs' key paths start (train.seed, 7) and (train.seed, 8), as JAX folds them


def build_evaluator(cfg: ExperimentConfig, *, oracle: str = "", tmr: str = "", device=None) -> H3DEvaluator:
    device = resolve_device(device)
    mdm, rvq, _, _ = GEN.load_models(cfg, device)
    diffusion = make_diffusion(schedule=cfg.diffusion.schedule, steps=cfg.diffusion.steps,
                               timestep_respacing=cfg.diffusion.timestep_respacing or None)
    # the prompts take the TRAINED TMR text head (the align space the prompt
    # channel was trained against); an untrained head would void the steering
    text_pipeline = None
    if tmr != "none":
        tmr_path = Path(tmr) if tmr else DEFAULT_TMR
        if tmr_path.exists():
            text_pipeline = load_text_pipeline(tmr_path, device=device)
            log.info(f"prompt text pipeline: {tmr_path}")
        elif tmr:
            raise FileNotFoundError(tmr_path)
    return H3DEvaluator(mdm=mdm, diffusion=diffusion, rvq_modules=rvq, h3d_stats=h3d_stats(cfg),
                        text_pipeline=text_pipeline, t2m_evaluator=t2m.T2MEvaluator.from_artifact(oracle or None,
                                                                                                  device=device),
                        pose_length=cfg.data.pose_length, pre_frames=cfg.pre_frames, latent_scale=cfg.latent_scale,
                        device=device)


def caption_features(cache, n_clips: int) -> tuple:
    """Clip i's caption text and its oracle text inputs (word vectors, POS
    one-hots, length), from the deterministic captioner over the joints
    that its ground-truth 623-d features give."""
    text_features, captions = [], []
    for i in range(n_clips):
        joints = recover_from_ric(torch.as_tensor(cache.get(i)["h3d"][None])).numpy()
        we, po, ln, caps = caption_batch(joints)
        log.info(f"clip {i} caption: {caps[0].text}")
        text_features.append({"word_embs": we, "pos_ohot": po, "cap_lens": ln})
        captions.append(caps[0].text)
    return text_features, captions


def main(argv=None):
    """Returns the metrics dict written to ``h3d_metrics.json``."""
    p = base_parser(__doc__)
    p.add_argument("--oracle", type=str, default="", help="a bigru oracle npz (default: the committed artifact)")
    p.add_argument("--tmr", type=str, default="",
                   help="TMR artifact npz for the prompt text pipeline (default: weights/t2m_oracle/tmr.npz when "
                        "present; 'none' takes the untrained one)")
    p.add_argument("--replications", type=int, default=20)
    p.add_argument("--max-clips", type=int, default=None)
    p.add_argument("--mm-repeats", type=int, default=0)
    p.add_argument("--steering-clips", type=int, default=4, help="clips for the tracked prompt-steering metric")
    p.add_argument("--no-steering", action="store_true")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    cfg = setup(args)
    device = resolve_device(args.device)
    smplx_model = load_smplx_if_available(cfg, device)

    cache, _ = build_beat_cache(cfg.data.data_path, cfg.data.cache_path, split="test",
                                speakers=cfg.data.training_speakers, cfg=ClipConfig(pose_length=cfg.data.pose_length),
                                smplx_model=smplx_model)
    evaluator = build_evaluator(cfg, oracle=args.oracle, tmr=args.tmr, device=device)
    n_clips = min(len(cache), args.max_clips or len(cache))
    text_features, captions = caption_features(cache, n_clips)

    results = evaluator.evaluate(cache, (cfg.train.seed, EVAL_KEY), text_features=text_features,
                                 replications=args.replications, max_clips=args.max_clips,
                                 mm_repeats=args.mm_repeats)
    out = {k: {"mean": np.asarray(v[0]).tolist(), "ci95": np.asarray(v[1]).tolist()} for k, v in results.items()}
    if cfg.mdm.use_prompt and not args.no_steering:
        out.update(evaluator.steering_metrics(cache, (cfg.train.seed, STEERING_KEY), captions=captions,
                                              text_features=text_features,
                                              max_clips=min(n_clips, args.steering_clips)))
    out_path = Path(cfg.train.ckpt_dir or ".") / "h3d_metrics.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=1))
    log.info(f"h3d metrics -> {out_path}\n{json.dumps(out, indent=1)}")
    return out


if __name__ == "__main__":
    main()
