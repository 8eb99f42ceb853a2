"""Typed experiment configuration: YAML + dotted overrides -> frozen dataclasses.

Counterpart of ``syntalker_tpu/config.py``: the same sections, fields and
defaults, and the same loader. Priority is dotted overrides > YAML >
defaults. ``MDMConfig``, ``RVQVAEConfig`` and ``RVQConfig`` are the port's,
and dtype strings (``bf16``, ``f32``, ...) become torch dtypes. Training
fields are carried so that every config of the JAX package loads; the
inference path reads the data, model, diffusion and guidance sections.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, get_origin

import yaml

from syntalker_tpu_torch.device import torch_dtype
from syntalker_tpu_torch.models.denoiser import MDMConfig
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig
from syntalker_tpu_torch.ops.quantize import RVQConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    data_path: str = "./datasets/beat_v2.0.0/beat_english_v2.0.0/"
    cache_path: str = "./cache/beat2"
    dataset: str = "beat_sep_lower"
    training_speakers: Tuple[int, ...] = (2,)
    pose_fps: int = 30
    pose_length: int = 128
    stride: int = 20
    audio_sr: int = 16000
    mean_std_dir: str = "/root/reference/mean_std"
    smplx_model_path: str = ""
    vocab_path: str = ""
    pose_norm: bool = True
    use_trans: bool = True


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    schedule: str = "cosine"
    steps: int = 1000
    timestep_respacing: str = ""  # '' = full DDPM; 'ddim50' for eval/demo
    sampler: str = "ddpm"  # or 'ddim'


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 40
    lr: float = 5e-5
    epochs: int = 2000
    grad_clip: float = 0.99
    test_period: int = 20
    log_period: int = 50
    seed: int = 2021
    ckpt_dir: str = "./outputs/ckpt"
    resume: str = ""
    debug: bool = False
    device_data: bool = False
    data_parallel: int = -1  # -1 = all devices
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class RVQTrainConfig:
    body_part: str = "upper"  # upper | hands | lower
    batch_size: int = 256
    lr: float = 2e-4
    total_iters: int = 300_000
    warmup_iters: int = 1000
    milestones: Tuple[int, ...] = (150_000, 250_000)
    gamma: float = 0.1
    commit_weight: float = 0.02
    window: int = 64
    save_every: int = 10_000


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    audio_scale: float = 1.0
    prompt_scale: float = 4.0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "syntalker_tpu"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mdm: MDMConfig = dataclasses.field(default_factory=MDMConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    rvq_train: RVQTrainConfig = dataclasses.field(default_factory=RVQTrainConfig)
    guidance: GuidanceConfig = dataclasses.field(default_factory=GuidanceConfig)
    trainer: str = "diffusion_rvqvae"  # the JAX package's trainer registry name
    representation: str = "beat330"  # or "h3d623" (text-control stack)
    latent_scale: float = 5.0
    pre_frames: int = 4
    rvq_width: int = 512
    rvq_depth: int = 3
    rvq_ckpts: Tuple[str, ...] = ()  # upper, hands, lower checkpoints
    test_ckpt: str = ""


def body_part_rvq_config(part: str, width: int = 512, depth: int = 3, quantizer: RVQConfig = RVQConfig()) -> RVQVAEConfig:
    dims = {"upper": 78, "hands": 180, "lower": 57}
    return RVQVAEConfig(input_dim=dims[part], width=width, depth=depth, quantizer=quantizer)


# ---------------------------------------------------------------------------
# dict -> dataclass with dotted overrides


def _resolve_type(field):
    t = field.type
    if isinstance(t, str):
        try:
            return eval(t, globals())  # noqa: S307 — this module's annotations
        except Exception:
            return None
    return t


def _from_dict(cls, d: Dict[str, Any]):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown config key '{k}' for {cls.__name__}")
        t = _resolve_type(fields[k])
        if t is not None and dataclasses.is_dataclass(t) and isinstance(v, dict):
            kwargs[k] = _from_dict(t, v)
        elif t is not None and get_origin(t) is tuple and isinstance(v, (list, tuple)):
            kwargs[k] = tuple(v)
        elif k.endswith("dtype") and isinstance(v, str):
            kwargs[k] = torch_dtype(v)
        elif t is float and isinstance(v, (str, int)):
            # YAML 1.1 reads exponent-only literals ("5e-5") as strings
            kwargs[k] = float(v)
        elif t is int and isinstance(v, (str, float)):
            if float(v) != int(float(v)):
                raise ValueError(f"config key '{k}' expects an int, got {v!r}")
            kwargs[k] = int(float(v))
        else:
            kwargs[k] = v
    return cls(**kwargs)


def _set_dotted(d: Dict[str, Any], dotted: str, value: Any):
    parts = dotted.split(".")
    cur = d
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def _parse_value(s: str) -> Any:
    try:
        v = yaml.safe_load(s)
    except Exception:
        return s
    if isinstance(v, str):
        # YAML 1.1 misses bare scientific notation like '1e-3'
        try:
            return float(v)
        except ValueError:
            return v
    return v


def load_config(yaml_path: Optional[str | Path] = None, overrides: Optional[List[str]] = None) -> ExperimentConfig:
    """An ExperimentConfig from a YAML file plus 'a.b.c=value' strings."""
    d: Dict[str, Any] = {}
    if yaml_path:
        d = yaml.safe_load(Path(yaml_path).read_text()) or {}
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key.path=value, got '{ov}'")
        k, v = ov.split("=", 1)
        _set_dotted(d, k, _parse_value(v))
    return _from_dict(ExperimentConfig, d)
