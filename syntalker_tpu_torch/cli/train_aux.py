"""Auxiliary model training CLI: the FGD eval VAE, the face VQ-VAE, the TMR encoders.

Usage:
  python -m syntalker_tpu_torch.cli.train_aux -c configs/rvq_beat2.yaml --model eval_vae [--device cpu]
  python -m syntalker_tpu_torch.cli.train_aux -c ... --model face_vqvae
  python -m syntalker_tpu_torch.cli.train_aux -c ... --model tmr

Counterpart of ``syntalker_tpu/cli/train_aux.py``: the train split cached
beside ``data.cache_path`` (``_aux``; 32-frame windows, 128 for TMR, with
contacts and h3d arrays when an SMPL-X model is configured), shuffled
batches of ``train.batch_size``, Adam with optax's rules
(:mod:`~syntalker_tpu_torch.train.optim`), and an npz checkpoint of flax
paths under ``<train.ckpt_dir>/<model>/step_<N>.npz``, which
``cli.test --eval-vae-ckpt`` reads for the eval VAE. ``tmr`` captions each
window's joints (recovered from its h3d features) with the rule-based
captioner and embeds the captions with the hash-word ``TextPipeline``.
Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import torch
from torch import nn

from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.cli.common import base_parser, load_smplx_if_available, setup
from syntalker_tpu_torch.data.beat_builder import build_beat_cache
from syntalker_tpu_torch.data.captions import caption_motion
from syntalker_tpu_torch.data.cache import BatchLoader, ClipConfig
from syntalker_tpu_torch.data.features import pose_to_part_rot6d
from syntalker_tpu_torch.data.h3d import recover_from_ric
from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.models.eval_vae import build_eval_vae, build_face_vqvae
from syntalker_tpu_torch.models.tmr import (ActorAgnosticEncoder, DistilbertTextEncoder, TextPipeline, TMRConfig,
                                            init_like_flax_, make_tmr_train_step, train_params)
from syntalker_tpu_torch.train import optim
from syntalker_tpu_torch.train import state as ts
from syntalker_tpu_torch.train.ae_trainer import make_eval_vae_train_step, make_face_vqvae_train_step

log = logging.getLogger("syntalker")


def _batches(cfg, cache, iters: int):
    """(iteration, host batch) over shuffled epochs until ``iters``."""
    loader = BatchLoader(cache, cfg.train.batch_size, seed=cfg.train.seed)
    it, epoch = 0, 0
    while it < iters:
        for batch in loader.epoch(epoch):
            it += 1
            yield it, batch
            if it >= iters:
                return
        epoch += 1


def _log(history: list, cfg, it: int, name: str, metrics: dict, t_last: list) -> None:
    """Every ``train.log_period`` iterations: the metrics as floats (which
    waits for the device) and the host time a step since the last log."""
    if it % cfg.train.log_period:
        return
    now = time.perf_counter()
    entry = {"it": it, **{k: float(v) for k, v in metrics.items()},
             "ms_per_step": 1e3 * (now - t_last[0]) / (it - t_last[1])}
    t_last[:] = [now, it]
    history.append(entry)
    log.info(f"{name} iter {it}: " + " ".join(f"{k} {v:.5f}" for k, v in entry.items() if k != "it"))


def _train_autoencoder(cfg, cache, iters: int, lr: float, device, name: str, module: nn.Module, make_step, features):
    opt = optim.adam(lr)
    state = ts.create_train_state(module, opt, torch.Generator(device).manual_seed(1))
    step = make_step(module, opt)
    history, t_last = [], [time.perf_counter(), 0]
    for it, batch in _batches(cfg, cache, iters):
        state, m = step(state, features(batch))
        _log(history, cfg, it, name, m, t_last)
    return ts.save_checkpoint(f"{cfg.train.ckpt_dir}/{name}", state, iters), history


def train_eval_vae(cfg, cache, iters: int, lr: float, device):
    """The skeleton-conv FGD featurizer on the windows' 330-d rot6d."""
    def features(batch):
        pose = torch.as_tensor(batch["pose"][..., :165], device=device)
        return pose_to_part_rot6d(pose)["full"][:, :32]

    return _train_autoencoder(cfg, cache, iters, lr, device, "eval_vae", build_eval_vae(seed=0, device=device),
                              make_eval_vae_train_step, features)


def train_face_vqvae(cfg, cache, iters: int, lr: float, device):
    """The face VQ-VAE on jaw rot6d + expressions (106-d)."""
    def features(batch):
        jaw6d = pose_to_part_rot6d(torch.as_tensor(batch["pose"][..., :165], device=device))["jaw"]
        return torch.cat([jaw6d, torch.as_tensor(batch["facial"], device=device)], dim=-1)

    return _train_autoencoder(cfg, cache, iters, lr, device, "face_vqvae", build_face_vqvae(seed=0, device=device),
                              make_face_vqvae_train_step, features)


def train_tmr(cfg, cache, iters: int, lr: float, device):
    """Contrastive text-motion alignment over the h3d features: each
    window captioned from its recovered joints, the captions embedded by
    the hash-word ``TextPipeline``."""
    tcfg = TMRConfig()
    pipeline = TextPipeline(tcfg, device=device)
    gen = torch.Generator().manual_seed(0)
    text = init_like_flax_(DistilbertTextEncoder(tcfg), gen).to(device)
    motion = init_like_flax_(ActorAgnosticEncoder(tcfg, input_dim=623), gen).to(device)
    params = train_params({"text": text, "motion": motion})
    opt = optim.adam(lr)
    opt_state = opt.init(params)
    step = make_tmr_train_step(text, motion, opt)
    history, t_last = [], [time.perf_counter(), 0]
    for it, batch in _batches(cfg, cache, iters):
        if "h3d" not in batch:
            raise SystemExit("TMR training needs h3d features in the cache (build it with an SMPL-X model: "
                             "data.smplx_model_path=synthetic or the released npz)")
        h3d = torch.as_tensor(batch["h3d"], device=device)
        caps = [caption_motion(j).text for j in recover_from_ric(h3d).cpu().numpy()]
        hidden, mask = pipeline.hidden_states(caps)
        params, opt_state, m = step(params, opt_state, {"text_hidden": torch.as_tensor(hidden, device=device),
                                                        "text_mask": torch.as_tensor(mask, device=device),
                                                        "motion": h3d})
        _log(history, cfg, it, "tmr", m, t_last)
    state = ts.TrainState(step=iters, params=params, opt_state=opt_state, generator=gen,
                          layout=bridge.FlaxLayout(nn.ModuleDict({"text": text, "motion": motion})))
    return ts.save_checkpoint(f"{cfg.train.ckpt_dir}/tmr", state, iters), history


TRAINERS = {"eval_vae": train_eval_vae, "face_vqvae": train_face_vqvae, "tmr": train_tmr}


def main(argv=None):
    """Returns ``{"model", "path", "history"}``: the checkpoint written and
    the logged metrics."""
    p = base_parser(__doc__)
    p.add_argument("--model", choices=sorted(TRAINERS), required=True)
    p.add_argument("--iters", type=int, default=20_000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    cfg = setup(args)
    device = resolve_device(args.device)
    smplx_model = load_smplx_if_available(cfg, device)
    cache, _ = build_beat_cache(cfg.data.data_path, cfg.data.cache_path + "_aux", split="train",
                                speakers=cfg.data.training_speakers,
                                cfg=ClipConfig(pose_length=128 if args.model == "tmr" else 32),
                                smplx_model=smplx_model)
    path, history = TRAINERS[args.model](cfg, cache, args.iters, args.lr, device)
    log.info(f"saved {args.model} -> {path}")
    return {"model": args.model, "path": Path(path), "history": history}


if __name__ == "__main__":
    main()
