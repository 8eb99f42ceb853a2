"""Weight bridge: the JAX package's parameters -> the port's modules.

Takes flax parameter trees given as nested dicts of arrays (anything
``np.asarray`` reads; no JAX import here) and copies them into the port's
modules, name for name:

- Dense kernel (in, out) -> Linear weight (out, in);
- Conv kernel (k, in, out) -> Conv1d weight (out, in, k);
- LayerNorm / GroupNorm / BatchNorm ``scale`` -> ``weight``; the
  BatchNorm ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var``;
- the scan-stacked ``blocks/block/*`` are split on axis 0 (an unrolled
  ``block_i`` tree, ``scan_blocks=False``, is read as it is), and the
  head-aligned qkv kernel (L, C, 3, H, hd) is flattened in C order, which
  gives the [q | k | v] column blocks;
- flax attention kernels (D, H, hd) and (H, hd, D) are flattened to
  (D, D) and their (H, hd) biases to (D,);
- ``word_embedding``, ``uncond_prompt_embedding``, the TMR
  ``dist_tokens``, the MotionCLIP decoder's ``time_queries`` and the RVQ
  codebooks (Q, K, D) are carried as they are.

An MDM is loaded from its flax variables: ``{'params': ..., 'batch_stats':
...}`` as ``create_mdm`` returns them for ``audio_norm='batch'``, or the bare
param tree of a model without statistics.
"""

from __future__ import annotations

import numpy as np
import torch

from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.models.denoiser import MDM, MDMConfig, RunningBatchNorm
from syntalker_tpu_torch.models.motionclip import MotionCLIP, MotionCLIPDecoder
from syntalker_tpu_torch.models.rvqvae import RVQVAE, RVQVAEConfig
from syntalker_tpu_torch.models.tmr import ActorAgnosticEncoder, Attention, DistilbertTextEncoder
from syntalker_tpu_torch.ops.quantize import RVQState


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32))


def load_dense(linear: torch.nn.Linear, p: dict) -> None:
    linear.weight.copy_(_t(p["kernel"]).reshape(linear.in_features, -1).T)
    if linear.bias is not None:
        linear.bias.copy_(_t(p["bias"]).reshape(-1))


def load_conv(conv: torch.nn.Conv1d, p: dict) -> None:
    conv.weight.copy_(_t(p["kernel"]).permute(2, 1, 0))
    conv.bias.copy_(_t(p["bias"]))


def load_norm(norm, p: dict, stats: dict | None = None) -> None:
    """A norm's scale and bias; a BatchNorm's running mean and variance from
    its ``batch_stats`` entry. A missing norm (``audio_norm='none'``) has
    nothing to load."""
    if isinstance(norm, torch.nn.Identity):
        return
    norm.weight.copy_(_t(p["scale"]))
    norm.bias.copy_(_t(p["bias"]))
    if isinstance(norm, RunningBatchNorm):
        norm.running_mean.copy_(_t(stats["mean"]))
        norm.running_var.copy_(_t(stats["var"]))


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else np.asarray(v)[i] for k, v in tree.items()}


@torch.no_grad()
def load_mdm(mdm: MDM, variables: dict) -> MDM:
    """Copy flax MDM variables (scan-stacked blocks) into ``mdm``."""
    p = variables.get("params", variables)
    stats = variables.get("batch_stats", {}).get("wav_encoder", {})
    for i, blk in enumerate(mdm.wav_encoder.blocks):
        bp, bs = p["wav_encoder"][f"block_{i}"], stats.get(f"block_{i}", {})
        load_conv(blk.conv1, bp["conv1"])
        load_conv(blk.conv2, bp["conv2"])
        names = ("norm1", "norm2") + (("down_norm",) if blk.down_conv is not None else ())
        for name in names:
            load_norm(getattr(blk, name), bp.get(name), bs.get(name))
        if blk.down_conv is not None:
            load_conv(blk.down_conv, bp["down_conv"])
    mdm.word_embedding.copy_(_t(p["word_embedding"]))
    dense = ["text_encoder", "mix_audio_text", "embed_seed", "input_process", "input_process2", "output_process"]
    if mdm.cfg.use_prompt:
        mdm.uncond_prompt_embedding.copy_(_t(p["uncond_prompt_embedding"]))
        dense.append("input_process3")
    if mdm.cfg.use_motionclip:
        dense.append("input_process_style")
    for name in dense:
        load_dense(getattr(mdm, name), p[name])
    load_dense(mdm.time_mlp.fc1, p["time_mlp"]["fc1"])
    load_dense(mdm.time_mlp.fc2, p["time_mlp"]["fc2"])
    for i, blk in enumerate(mdm.blocks):
        lp = _layer(p["blocks"]["block"], i) if "blocks" in p else p[f"block_{i}"]
        load_dense(blk.qkv, lp["qkv"])
        for name in ("proj", "fc1", "fc2"):
            load_dense(getattr(blk, name), lp[name])
        load_norm(blk.norm1, lp["norm1"])
        load_norm(blk.norm2, lp["norm2"])
    return mdm


def _load_resnet(res, p: dict) -> None:
    for j, blk in enumerate(res.blocks):
        load_conv(blk.conv_dilated, p[f"block_{j}"]["conv_dilated"])
        load_conv(blk.conv_proj, p[f"block_{j}"]["conv_proj"])


@torch.no_grad()
def load_rvqvae(module: RVQVAE, params: dict) -> RVQVAE:
    """Copy a flax RVQVAE param tree, encoder and decoder, into ``module``."""
    p = params.get("params", params)
    enc, dec = module.encoder, module.decoder
    for name in ("stem", "head"):
        load_conv(getattr(enc, name), p["encoder"][name])
    for i, (down, res) in enumerate(zip(enc.down, enc.res)):
        load_conv(down, p["encoder"][f"down_{i}"])
        _load_resnet(res, p["encoder"][f"res_{i}"])
    for name in ("stem", "mid", "head"):
        load_conv(getattr(dec, name), p["decoder"][name])
    for i, (res, up) in enumerate(zip(dec.res, dec.up)):
        _load_resnet(res, p["decoder"][f"res_{i}"])
        load_conv(up, p["decoder"][f"up_{i}"])
    return module


def load_attention(attn: Attention, p: dict) -> None:
    for name in ("query", "key", "value", "out"):
        load_dense(getattr(attn, name), p[name])


@torch.no_grad()
def load_actor_encoder(enc: ActorAgnosticEncoder, p: dict) -> ActorAgnosticEncoder:
    """A flax ``ActorAgnosticEncoder`` tree (TMR motion side, a text head's
    ``head``, MotionCLIP's ``encoder``) into ``enc``."""
    load_dense(enc.skel_embedding, p["skel_embedding"])
    enc.dist_tokens.copy_(_t(p["dist_tokens"]))
    for i, blk in enumerate(enc.blocks):
        bp = p[f"block_{i}"]
        load_norm(blk.LayerNorm_0, bp["LayerNorm_0"])
        load_attention(blk.MultiHeadDotProductAttention_0, bp["MultiHeadDotProductAttention_0"])
        load_norm(blk.LayerNorm_1, bp["LayerNorm_1"])
        load_dense(blk.Dense_0, bp["Dense_0"])
        load_dense(blk.Dense_1, bp["Dense_1"])
    return enc


@torch.no_grad()
def load_tmr_text(head: DistilbertTextEncoder, p: dict) -> DistilbertTextEncoder:
    """A flax ``DistilbertTextEncoder`` tree (``projection``, ``head``)."""
    load_dense(head.projection, p["projection"])
    load_actor_encoder(head.head, p["head"])
    return head


@torch.no_grad()
def load_motionclip(model: MotionCLIP, p: dict) -> MotionCLIP:
    """A flax ``MotionCLIP`` tree (``encoder``, ``proj``)."""
    load_actor_encoder(model.encoder, p["encoder"])
    load_dense(model.proj, p["proj"])
    return model


@torch.no_grad()
def load_motionclip_decoder(dec: MotionCLIPDecoder, p: dict) -> MotionCLIPDecoder:
    """A flax ``MotionCLIPDecoder`` tree."""
    dec.time_queries.copy_(_t(p["time_queries"]))
    load_dense(dec.latent_in, p["latent_in"])
    for i in range(len(dec.cross)):
        load_norm(dec.ln_q[i], p[f"ln_q{i}"])
        load_attention(dec.cross[i], p[f"cross{i}"])
        load_norm(dec.ln_f[i], p[f"ln_f{i}"])
        load_dense(dec.fc1[i], p[f"fc1_{i}"])
        load_dense(dec.fc2[i], p[f"fc2_{i}"])
    load_dense(dec.out, p["out"])
    return dec


def mdm_from_flax(cfg: MDMConfig, variables: dict, *, device=None) -> MDM:
    """The port's MDM, in eval mode, from flax variables (or a bare param
    tree, as ``mdm_variables`` takes them in JAX)."""
    mdm = load_mdm(MDM(cfg), variables)
    return mdm.to(resolve_device(device)).eval().requires_grad_(False)


def rvqvae_from_flax(cfg: RVQVAEConfig, params: dict, codebook, *, device=None):
    """(RVQVAE, RVQState) from a flax param tree and the RVQState codebook."""
    device = resolve_device(device)
    module = load_rvqvae(RVQVAE(cfg), params).to(device).eval().requires_grad_(False)
    return module, RVQState(codebook=_t(codebook).to(device))
