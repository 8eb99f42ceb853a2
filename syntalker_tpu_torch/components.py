"""Concrete component registrations.

Counterpart of ``syntalker_tpu/components.py``: importing this module
fills the registries with the dataset builders (``beat_sep_lower``,
``beat_sep_lower_h3d``, whose caches carry the 623-d ``h3d`` arrays when an
SMPL-X model is given, and ``amass_npz``), the models (``MDM``/``denoiser``,
``RVQVAE``/``rvqvae``, ``MotionCLIP``, ``TMRText``, ``TMRMotion``), the
evaluation models (``VAESKConv``, ``VQVAEConvZero``), the trainers and the
samplers. The CLIs resolve configured names through them. ``TMRText`` is
the text head; its DistilBERT backbone is not ported and raises
(``TextPipeline(backbone_path=...)``).
"""

from __future__ import annotations

from syntalker_tpu_torch.data.amass import load_amass_npz
from syntalker_tpu_torch.data.beat_builder import build_beat_cache
from syntalker_tpu_torch.diffusion.core import ddim_sample, ddpm_sample
from syntalker_tpu_torch.diffusion.extras import plms_sample
from syntalker_tpu_torch.models.denoiser import MDM, build_mdm
from syntalker_tpu_torch.models.eval_vae import VAESKConv, VQVAEConvZero
from syntalker_tpu_torch.models.motionclip import MotionCLIP
from syntalker_tpu_torch.models.rvqvae import RVQVAE, build_rvqvae
from syntalker_tpu_torch.models.tmr import ActorAgnosticEncoder, DistilbertTextEncoder
from syntalker_tpu_torch.registry import DATASETS, EVAL_MODELS, MODELS, SAMPLERS, TRAINERS
from syntalker_tpu_torch.train.loop import DiffusionTrainer, RVQTrainer

# datasets (reference: dataloaders/<name>.py CustomDataset)
DATASETS.register("beat_sep_lower")(build_beat_cache)
DATASETS.register("beat_sep_lower_h3d")(build_beat_cache)  # the h3d arrays ride along
DATASETS.register("amass_npz")(load_amass_npz)

# models (reference: models/<name>.py, args.g_name)
MODELS.register("MDM")(MDM)
MODELS.register("denoiser")(build_mdm)
MODELS.register("RVQVAE")(RVQVAE)
MODELS.register("rvqvae")(build_rvqvae)
MODELS.register("MotionCLIP")(MotionCLIP)
MODELS.register("TMRText")(DistilbertTextEncoder)
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
