"""Single-clip audio -> motion generation, with optional text prompts.

Usage: python -m syntalker_tpu_torch.cli.generate -c configs/diffusion_h3d.yaml \
           --wav input.wav [--textgrid input.TextGrid | --transcript "..."] \
           [--upper-prompt "raise both arms"] [--device cpu]

Counterpart of ``syntalker_tpu/cli/generate.py``, step for step: the
config's denoiser (``test_ckpt``) and RVQ stack (``rvq_ckpts``), npz
checkpoints or seeded initializations; the wav featurized; word ids from a
TextGrid, or from a transcript aligned by energy, or silence; each prompt
embedded by the TMR text pipeline; the windows sampled (DDIM when the
schedule is respaced) with the body-part CFG of ``cfg.guidance`` when a
prompt is given, every step's branches in one K2 call on the card; the
latents snapped (K3) and decoded; an SMPL-X npz written with the JAX CLI's
keys. Runs on CUDA unless ``--device cpu``. JAX's threefry noise has no
PyTorch counterpart: the initial noise comes from a ``torch.Generator``
seeded with ``train.seed``. Rendering (``--render``) waits for the port of
``render.py`` and ``ops/smplx.py``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from syntalker_tpu_torch import bridge
from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch.cli.common import base_parser, setup
from syntalker_tpu_torch.config import ExperimentConfig
from syntalker_tpu_torch.data import audio as A
from syntalker_tpu_torch.data.stats import identity_pose_stats, load_pose_stats
from syntalker_tpu_torch.data.textgrid import words_tier
from syntalker_tpu_torch.data.vocab import Vocab, words_to_frame_ids
from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import build_mdm, migrate_qkv_kernels
from syntalker_tpu_torch.models.tmr import TextPipeline, embed_prompts
from syntalker_tpu_torch.train.loop import load_rvq_stack
from syntalker_tpu_torch.train.state import load_model_variables

log = logging.getLogger("syntalker")

RVQ_SEED_OFFSET = 99  # the RVQ stack's seeds, after the denoiser's


def load_models(cfg: ExperimentConfig, device):
    """(MDM, RVQ stack, schedule, pose stats) of a config."""
    if cfg.test_ckpt:
        # flat legacy qkv kernels migrate to the head-aligned layout (numerics unchanged)
        variables = migrate_qkv_kernels(load_model_variables(cfg.test_ckpt), cfg.mdm.num_heads)
        mdm = bridge.mdm_from_flax(cfg.mdm, variables, device=device)
    else:
        mdm = build_mdm(cfg.mdm, seed=cfg.train.seed, device=device)
    rvq = load_rvq_stack(cfg, seed=cfg.train.seed + RVQ_SEED_OFFSET, device=device)
    if cfg.diffusion.schedule != "cosine":
        raise ValueError(f"schedule {cfg.diffusion.schedule!r} is not ported; the port has the cosine schedule")
    diffusion = make_diffusion(steps=cfg.diffusion.steps,
                               timestep_respacing=cfg.diffusion.timestep_respacing or "ddim50")
    mean_std = Path(cfg.data.mean_std_dir)
    stats = load_pose_stats(mean_std) if mean_std.exists() else identity_pose_stats()
    return mdm, rvq, diffusion, stats


def word_ids(cfg: ExperimentConfig, y: np.ndarray, sr: int, n_frames: int, textgrid: str = "",
             transcript: str = "") -> np.ndarray:
    """(1, n_frames) word ids: from a TextGrid, else from a transcript
    placed over the voiced audio, else silence (zeros); both need
    ``cfg.data.vocab_path``."""
    if textgrid and cfg.data.vocab_path:
        vocab = Vocab.load(cfg.data.vocab_path)
        return words_to_frame_ids(words_tier(textgrid), n_frames, vocab)[None]
    if transcript and cfg.data.vocab_path:
        vocab = Vocab.load(cfg.data.vocab_path)
        intervals = A.align_words_by_energy(transcript.split(), y, sr)
        return words_to_frame_ids(intervals, n_frames, vocab)[None]
    return np.zeros((1, n_frames), np.int32)


@torch.no_grad()
def generate_clip(cfg: ExperimentConfig, wav, *, textgrid: str = "", transcript: str = "",
                  prompts: Optional[Dict[str, Optional[str]]] = None, generator: Optional[torch.Generator] = None,
                  denoise=None, noise: Optional[torch.Tensor] = None, pipeline: Optional[TextPipeline] = None,
                  models=None, device=None) -> dict:
    """One wav file -> ``{"npz": the SMPL-X fields, "latents": (1, T, 1536)}``.

    ``prompts`` maps body parts to text (empty or None: unprompted).
    ``generator`` draws the initial noise of each window (default: seeded
    with ``train.seed`` on the device); ``noise`` (W, 1, T, 1536) replaces
    it. ``denoise(x_t, t_emb, cond) -> x0`` defaults to K2 with bf16
    weights. ``pipeline`` embeds the prompts (default: ``TextPipeline()``).
    ``models`` is :func:`load_models`' tuple, built from ``cfg`` when None."""
    device = resolve_device(device)
    mdm, rvq, diffusion, stats = models if models is not None else load_models(cfg, device)

    y, sr = A.load_wav_mono(wav, cfg.data.audio_sr)
    feats = A.onset_amplitude_features(y, sr)[None]  # (1, S, 2)
    n_frames = int(len(y) / sr * cfg.data.pose_fps)
    plan = G.plan_windows(n_frames, pose_length=cfg.data.pose_length, pre_frames=cfg.pre_frames)
    word = word_ids(cfg, y, sr, n_frames, textgrid, transcript)

    aw = torch.as_tensor(G.window_audio(feats, plan, sr=sr, fps=cfg.data.pose_fps), device=device)
    ww = torch.as_tensor(G.window_words(word, plan), device=device).long()
    seed = torch.zeros(1, plan.pre_frames, cfg.mdm.latent_total_dim, device=device)

    embedded = None
    if prompts and any(prompts.values()):
        embedded = embed_prompts(cfg, {p: prompts.get(p) or None for p in ("upper", "hands", "lower")},
                                 pipeline or TextPipeline(device=device))

    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.train.seed)
    if noise is None:
        noise = G.draw_noise(plan, 1, generator, device)
    sampler = "ddim" if diffusion.num_steps < cfg.diffusion.steps else cfg.diffusion.sampler
    step_noise = None
    if sampler == "ddpm":
        def step_noise(w, it):
            return torch.randn(noise.shape[1:], generator=generator, device=device)

    latents = G.sample_windows(
        mdm, diffusion, plan, aw, ww, seed, noise.to(device), sampler=sampler, step_noise=step_noise,
        prompts=embedded, guidance={"audio_scale": cfg.guidance.audio_scale, "prompt_scale": cfg.guidance.prompt_scale},
        denoise=denoise)
    dec = G.decode_latents(latents, rvq_modules=rvq, stats=stats, latent_scale=cfg.latent_scale)
    poses = dec["axis_angle"][0].cpu().numpy()
    npz = dict(
        poses=poses,
        trans=dec["trans"][0].cpu().numpy(),
        betas=np.zeros(300, np.float32),
        expressions=np.zeros((poses.shape[0], 100), np.float32),
        model="smplx2020",
        gender="neutral",
        mocap_frame_rate=30,
    )
    return {"npz": npz, "latents": latents}


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--wav", type=str, required=True)
    p.add_argument("--textgrid", type=str, default="")
    p.add_argument("--transcript", type=str, default="",
                   help="transcript text; energy-aligned to the audio when no TextGrid is given")
    p.add_argument("--out", type=str, default="./outputs/generated.npz")
    p.add_argument("--render", action="store_true", help="not ported yet")
    p.add_argument("--upper-prompt", type=str, default="")
    p.add_argument("--hands-prompt", type=str, default="")
    p.add_argument("--lower-prompt", type=str, default="")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.render:
        p.error("--render waits for the port of render.py and ops/smplx.py")
    cfg = setup(args)

    result = generate_clip(
        cfg, args.wav, textgrid=args.textgrid, transcript=args.transcript,
        prompts={"upper": args.upper_prompt, "hands": args.hands_prompt, "lower": args.lower_prompt},
        device=args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **result["npz"])
    log.info(f"motion -> {out} ({result['npz']['poses'].shape[0]} frames)")
    return result


if __name__ == "__main__":
    main()
