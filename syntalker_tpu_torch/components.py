"""Concrete component registrations.

Counterpart of ``syntalker_tpu/components.py`` for what the port has:
importing this module fills the registries with the BEAT2 dataset builder,
the models (``MDM``/``denoiser``, ``RVQVAE``/``rvqvae``, ``MotionCLIP``,
``TMRMotion``), the evaluation models (``VAESKConv``, ``VQVAEConvZero``),
the trainers and the samplers. The CLIs resolve configured names through
them. The ``amass_npz`` and ``beat_sep_lower_h3d`` datasets and
``TMRText`` are registered by the slices that port them.
"""

from __future__ import annotations

from syntalker_tpu_torch.data.beat_builder import build_beat_cache
from syntalker_tpu_torch.diffusion.core import ddim_sample, ddpm_sample
from syntalker_tpu_torch.diffusion.extras import plms_sample
from syntalker_tpu_torch.models.denoiser import MDM, build_mdm
from syntalker_tpu_torch.models.eval_vae import VAESKConv, VQVAEConvZero
from syntalker_tpu_torch.models.motionclip import MotionCLIP
from syntalker_tpu_torch.models.rvqvae import RVQVAE, build_rvqvae
from syntalker_tpu_torch.models.tmr import ActorAgnosticEncoder
from syntalker_tpu_torch.registry import DATASETS, EVAL_MODELS, MODELS, SAMPLERS, TRAINERS
from syntalker_tpu_torch.train.loop import DiffusionTrainer, RVQTrainer

# datasets (reference: dataloaders/<name>.py CustomDataset)
DATASETS.register("beat_sep_lower")(build_beat_cache)

# models (reference: models/<name>.py, args.g_name)
MODELS.register("MDM")(MDM)
MODELS.register("denoiser")(build_mdm)
MODELS.register("RVQVAE")(RVQVAE)
MODELS.register("rvqvae")(build_rvqvae)
MODELS.register("MotionCLIP")(MotionCLIP)
MODELS.register("TMRMotion")(ActorAgnosticEncoder)

# evaluation models (reference: models/motion_representation.py)
EVAL_MODELS.register("VAESKConv")(VAESKConv)
EVAL_MODELS.register("VQVAEConvZero")(VQVAEConvZero)

# trainers (reference: args.trainer -> <name>_trainer.py)
TRAINERS.register("diffusion_rvqvae")(DiffusionTrainer)
TRAINERS.register("rvq")(RVQTrainer)

SAMPLERS.register("ddpm")(ddpm_sample)
SAMPLERS.register("ddim")(ddim_sample)
SAMPLERS.register("plms")(plms_sample)
