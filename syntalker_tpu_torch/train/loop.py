"""The body-part RVQ-VAE stack for inference.

Counterpart of ``_rvq_cfg`` and ``load_rvq_stack`` in
``syntalker_tpu/train/loop.py``: one RVQ-VAE per body part, sized to a third
of the denoiser's latent, loaded from checkpoints (npz, see
:mod:`syntalker_tpu_torch.train.state`: ``params`` and
``quantizer_state/codebook``) or, without one, initialized from a seed.
JAX's fresh quantizer state has all-zero codebooks; the port's draws them
from ``randn`` so that the snap has codes to choose between. The train
steps are :mod:`~syntalker_tpu_torch.train.rvq_trainer` and
:mod:`~syntalker_tpu_torch.train.diffusion_trainer`; the trainers' loops
over a dataset (``DiffusionTrainer``, ``RVQTrainer``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.config import ExperimentConfig, body_part_rvq_config
from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
from syntalker_tpu_torch.ops.quantize import RVQConfig
from syntalker_tpu_torch.train.state import TRAIN_ONLY_KEYS, load_checkpoint_npz

H3D_PART_DIMS = {"upper": 156, "hands": 360, "lower": 107}  # the 623-dim representation's parts


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
            raw = load_checkpoint_npz(cfg.rvq_ckpts[i], skip=TRAIN_ONLY_KEYS)
            out[part] = bridge.rvqvae_from_flax(rcfg, raw["params"], raw["quantizer_state"]["codebook"],
                                                device=device)
        else:
            out[part] = build_rvqvae(rcfg, seed=seed + i, device=device)
    return out
