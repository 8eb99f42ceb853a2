"""The models of a configuration, made from the seed: the program's modules
(the port's ``MDM`` and one ``RVQVAE`` a body part) and, from the same
tensors, the reference's weight dicts.

Weights are drawn on the device by one ``torch.Generator`` in one normal
draw per model, and scaled by the role a tensor's name gives it: a matrix
or kernel by 1/sqrt(fan-in), a norm's scale around 1, biases and norm
shifts small, running statistics near (0, 1), the word table and the null
prompt at the scale of their inputs. Codebooks are standard normal, as the
port's own seeded RVQ-VAEs draw them. Statistics are drawn on the host
from the seed (std in [0.5, 1.5)).
"""

from __future__ import annotations

import dataclasses
import hashlib
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference.model import Reference


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = hashlib.blake2b(f"{seed}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def _scale(name: str, t: torch.Tensor) -> tuple:
    """(multiplier, offset) of a standard normal draw for a tensor."""
    if name.endswith("running_mean"):
        return 0.1, 0.0
    if name.endswith("running_var"):
        return 0.1, 1.0
    if "norm" in name:
        return (0.1, 1.0) if name.endswith(".weight") else (0.1, 0.0)
    if name == "word_embedding":
        return 0.1, 0.0
    if name == "uncond_prompt_embedding":
        return t.shape[-1] ** -0.5, 0.0
    if t.ndim >= 2:
        return (t[0].numel()) ** -0.5, 0.0
    return 0.02, 0.0


def seeded_weights(module: torch.nn.Module, generator: torch.Generator) -> dict:
    """Every parameter and persistent buffer of ``module`` from one draw;
    returns name -> tensor (the benchmark's own, loaded into a copy in the
    module)."""
    sd = module.state_dict()
    names = sorted(n for n, t in sd.items() if t.is_floating_point())
    flat = torch.randn(sum(sd[n].numel() for n in names), generator=generator, device=generator.device)
    out, pos = {}, 0
    for n in names:
        t = sd[n]
        mul, add = _scale(n, t)
        draw = flat[pos : pos + t.numel()]
        out[n] = ((draw.abs() if n.endswith("running_var") else draw) * mul + add).view(t.shape)
        pos += t.numel()
    module.load_state_dict({**sd, **out})
    return out


def seeded_stats(seed: int) -> dict:
    rng = np.random.default_rng(sub_seed(seed, "stats"))
    return {"mean_full": (0.1 * rng.standard_normal(330)).astype(np.float32),
            "std_full": (0.5 + rng.random(330)).astype(np.float32),
            "trans_mean": (0.1 * rng.standard_normal(3)).astype(np.float32),
            "trans_std": (0.5 + rng.random(3)).astype(np.float32)}


def build(cfg: dict, seed: int, device, mark=lambda step: None) -> SimpleNamespace:
    """The program's models and the reference for ``cfg`` (a configuration
    file's contents) on ``device``; ``mark(step)`` after the imports."""
    from syntalker_tpu_torch.data.stats import PoseStats
    from syntalker_tpu_torch.diffusion.schedule import make_diffusion
    from syntalker_tpu_torch.models.denoiser import MDM, MDMConfig
    from syntalker_tpu_torch.models.rvqvae import RVQVAE, RVQVAEConfig
    from syntalker_tpu_torch.ops.quantize import RVQConfig, RVQState

    mark("imports of the program")
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(sub_seed(seed, "weights"))
    fields = {f.name for f in dataclasses.fields(MDMConfig)}
    with torch.device(dev):
        mdm = MDM(MDMConfig(**{k: v for k, v in cfg["mdm"].items() if k in fields}))
    mdm_w = seeded_weights(mdm, gen)
    mdm.eval().requires_grad_(False)
    r = cfg["rvq"]
    qcfg = RVQConfig(num_quantizers=r["num_quantizers"], nb_code=r["nb_code"], code_dim=r["code_dim"])
    rvq, rvq_w, books = {}, {}, {}
    for part, dim in r["parts"].items():
        rcfg = RVQVAEConfig(input_dim=dim, width=r["width"], output_emb_width=r["code_dim"], down_t=r["down_t"],
                            stride_t=r["stride_t"], depth=r["depth"], dilation_growth_rate=r["dilation_growth_rate"],
                            quantizer=qcfg)
        with torch.device(dev):
            module = RVQVAE(rcfg)
        rvq_w[part] = seeded_weights(module, gen)
        books[part] = torch.randn(r["num_quantizers"], r["nb_code"], r["code_dim"], generator=gen, device=dev)
        rvq[part] = (module.eval().requires_grad_(False), RVQState(codebook=books[part].clone()))
    stats = seeded_stats(seed)
    d = cfg["diffusion"]
    diffusion = make_diffusion(schedule=d["schedule"], steps=d["steps"], timestep_respacing=d["respacing"])
    return SimpleNamespace(
        mdm=mdm, rvq=rvq, stats=PoseStats(**stats), diffusion=diffusion,
        reference=lambda **prec: Reference(cfg, mdm_w, rvq_w, books, stats, **prec))
