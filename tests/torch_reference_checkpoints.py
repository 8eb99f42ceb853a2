"""Reference-layout state dicts built from flax-layout trees (no JAX).

The inverse of the converters in ``syntalker_tpu/convert.py`` and
``syntalker_tpu_torch/convert.py``: a flax param tree (as the port's
``bridge`` writes it from a module) laid out under the reference's torch key
names and shapes, Conv1d weights (out, in, k), Linear weights (out, in), the
Sequential indices of its encoders and decoders. Each builder also adds
keys that the converters ignore (BatchNorm batch counters, positional
tables, the EMA buffers of the codebooks, the eval VAE's variational
heads), as real checkpoints carry them. ``tests/test_torch_convert.py``
feeds the dicts to both packages' converters; ``chip_smoke.py`` builds the
full-width ones from seeded modules and saves them as the reference's
checkpoint files. ``flax_tree`` reads a port module's tree, and
``perturb_wav_norms`` gives a BatchNorm WavEncoder seeded scales, shifts
and running statistics (positive variances): the initial ones fold to
the identity and prove nothing.
"""

import numpy as np
import torch

from syntalker_tpu_torch import bridge


def flax_tree(module: torch.nn.Module) -> dict:
    """The module's parameters as the flax tree the bridge maps them to."""
    return bridge.FlaxLayout(module).to_flax(dict(module.named_parameters()))


def perturb_wav_norms(variables: dict, seed: int) -> dict:
    """In place: every WavEncoder norm's scale and shift, and its running
    mean and variance, drawn from ``seed``. Returns ``variables``."""
    g = np.random.default_rng(seed)
    for block, stats in zip(variables["params"]["wav_encoder"].values(),
                            variables["batch_stats"]["wav_encoder"].values()):
        for name, norm in stats.items():
            block[name]["scale"] = g.uniform(0.5, 1.5, norm["mean"].shape).astype(np.float32)
            block[name]["bias"] = g.normal(0, 0.1, norm["mean"].shape).astype(np.float32)
            norm["mean"] = g.normal(0, 0.2, norm["mean"].shape).astype(np.float32)
            norm["var"] = g.uniform(0.5, 2.0, norm["var"].shape).astype(np.float32)
    return variables


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _conv(d: dict) -> dict:
    return {"weight": _t(np.transpose(d["kernel"], (2, 1, 0))), "bias": _t(d["bias"])}


def _linear(d: dict) -> dict:
    return {"weight": _t(np.transpose(d["kernel"], (1, 0))), "bias": _t(d["bias"])}


def _put(sd: dict, prefix: str, tensors: dict) -> None:
    for k, v in tensors.items():
        sd[f"{prefix}.{k}"] = v


def module_prefixed(sd: dict) -> dict:
    """The state dict as ``nn.DataParallel`` saves it."""
    return {f"module.{k}": v for k, v in sd.items()}


def rvqvae_state_dict(params: dict, codebooks, *, down_t: int = 2, depth: int = 3) -> dict:
    """RVQVAE (models/vq/encdec.py + quantizer.py) from the port's flax tree
    (``encoder``/``decoder``) and codebooks (Q, K, D)."""
    enc, dec, sd = params["encoder"], params["decoder"], {}

    def resnet(prefix, tree):
        for d in range(depth):
            _put(sd, f"{prefix}.model.{d}.conv1", _conv(tree[f"block_{d}"]["conv_dilated"]))
            _put(sd, f"{prefix}.model.{d}.conv2", _conv(tree[f"block_{d}"]["conv_proj"]))

    _put(sd, "encoder.model.0", _conv(enc["stem"]))
    for i in range(down_t):
        _put(sd, f"encoder.model.{2 + i}.0", _conv(enc[f"down_{i}"]))
        resnet(f"encoder.model.{2 + i}.1", enc[f"res_{i}"])
    _put(sd, f"encoder.model.{2 + down_t}", _conv(enc["head"]))
    _put(sd, "decoder.model.0", _conv(dec["stem"]))
    for i in range(down_t):
        resnet(f"decoder.model.{2 + i}.0", dec[f"res_{i}"])
        _put(sd, f"decoder.model.{2 + i}.2", _conv(dec[f"up_{i}"]))
    _put(sd, f"decoder.model.{2 + down_t}", _conv(dec["mid"]))
    _put(sd, f"decoder.model.{4 + down_t}", _conv(dec["head"]))
    for q, cb in enumerate(np.asarray(codebooks)):
        sd[f"quantizer.layers.{q}.codebook"] = _t(cb)
        sd[f"quantizer.layers.{q}.code_sum"] = _t(cb)  # EMA buffers: not read
        sd[f"quantizer.layers.{q}.code_count"] = torch.ones(cb.shape[0])
    return sd


def mdm_state_dict(variables: dict) -> dict:
    """MDM (models/denoiser.py) from the flax variables of an
    ``audio_norm='batch'`` model: ``params`` with the WavEncoder's norms and
    ``batch_stats`` with their running statistics, unfolded."""
    p, stats, sd = variables["params"], variables["batch_stats"]["wav_encoder"], {}
    for i in range(6):
        blk, st, base = p["wav_encoder"][f"block_{i}"], stats[f"block_{i}"], f"WavEncoder.feat_extractor.{i}"
        pairs = [("conv1", "norm1", "conv1", "bn1"), ("conv2", "norm2", "conv2", "bn2")]
        if "down_conv" in blk:
            pairs.append(("down_conv", "down_norm", "downsample.0", "downsample.1"))
        for conv, norm, tconv, tbn in pairs:
            _put(sd, f"{base}.{tconv}", _conv(blk[conv]))
            _put(sd, f"{base}.{tbn}", {"weight": _t(blk[norm]["scale"]), "bias": _t(blk[norm]["bias"]),
                                      "running_mean": _t(st[norm]["mean"]), "running_var": _t(st[norm]["var"]),
                                      "num_batches_tracked": torch.tensor(1000)})
    sd["text_pre_encoder_body.weight"] = _t(p["word_embedding"])
    for tkey, fkey in (("text_encoder_body", "text_encoder"), ("mix_audio_text", "mix_audio_text"),
                       ("embed_text", "embed_seed"), ("input_process.poseEmbedding", "input_process"),
                       ("input_process2", "input_process2"), ("output_process.poseFinal", "output_process")):
        _put(sd, tkey, _linear(p[fkey]))
    _put(sd, "embed_timestep.time_embed.0", _linear(p["time_mlp"]["fc1"]))
    _put(sd, "embed_timestep.time_embed.2", _linear(p["time_mlp"]["fc2"]))
    blocks = p["blocks"]["block"]
    for i in range(blocks["norm1"]["scale"].shape[0]):
        one = {k: {kk: np.asarray(vv)[i] for kk, vv in v.items()} for k, v in blocks.items()}
        base = f"mytimmblocks.{i}"
        for norm in ("norm1", "norm2"):
            _put(sd, f"{base}.{norm}", {"weight": _t(one[norm]["scale"]), "bias": _t(one[norm]["bias"])})
        qkv = one["qkv"]["kernel"]  # (C, 3, H, hd): part-major, then head-major columns
        sd[f"{base}.attn.qkv.weight"] = _t(qkv.reshape(qkv.shape[0], -1).T)
        _put(sd, f"{base}.attn.proj", _linear(one["proj"]))
        _put(sd, f"{base}.mlp.fc1", _linear(one["fc1"]))
        _put(sd, f"{base}.mlp.fc2", _linear(one["fc2"]))
    width = sd["input_process2.weight"].shape[0]
    sd["sequence_pos_encoder.pe"] = torch.zeros(64, 1, width)  # positional tables: not read
    sd["embed_timestep.sequence_pos_encoder.pe"] = torch.zeros(64, 1, width)
    return sd


def _res_block(sd: dict, prefix: str, tree: dict) -> None:
    _put(sd, f"{prefix}.model.0", _conv(tree["conv1"]))
    _put(sd, f"{prefix}.model.2", _conv(tree["conv2"]))


def _vq_decoder(sd: dict, tree: dict, num_layers: int, *, upsampling: bool) -> None:
    """VQDecoderV3 / V5 Sequential: [proj conv], 2 ResBlocks, per stage
    (Upsample,) Conv, LeakyReLU, then the head."""
    p = 1 if "proj" in tree else 0
    if p:
        _put(sd, "decoder.main.0", _conv(tree["proj"]))
    _res_block(sd, f"decoder.main.{p}", tree["res_0"])
    _res_block(sd, f"decoder.main.{p + 1}", tree["res_1"])
    stride, name = (3, "up") if upsampling else (2, "conv")
    for i in range(num_layers):
        _put(sd, f"decoder.main.{p + 2 + stride * i + int(upsampling)}", _conv(tree[f"{name}_{i}"]))
    _put(sd, f"decoder.main.{p + 2 + stride * num_layers}", _conv(tree["head"]))


def eval_vae_state_dict(params: dict) -> dict:
    """VAESKConv (motion_representation.py): the LocalEncoder's
    SkeletonResidual layers, a VQDecoderV3, and the variational heads."""
    sd, enc = {}, params["encoder"]
    n = len(enc)
    for i in range(n):
        layer, base = enc[f"layer_{i}"], f"encoder.layers.{i}.0"
        _put(sd, f"{base}.residual.0", _conv(layer["conv"]))
        _put(sd, f"{base}.residual.1", {"weight": _t(layer["norm"]["scale"]), "bias": _t(layer["norm"]["bias"])})
        _put(sd, f"{base}.shortcut", _conv(layer["shortcut"]))
        sd[f"{base}.residual.0.mask"] = torch.ones(1)  # topology masks: rebuilt, not read
    _vq_decoder(sd, params["decoder"], n, upsampling=True)
    width = sd["encoder.layers.0.0.shortcut.bias"].shape[0]
    sd["fc_mu.weight"], sd["fc_logvar.weight"] = torch.zeros(width, width), torch.zeros(width, width)
    return sd


def face_vqvae_state_dict(params: dict) -> dict:
    """VQVAEConvZero: VQEncoderV5 [Conv, LeakyReLU, ResBlock] × n, the
    quantizer's embedding, a VQDecoderV5."""
    sd, enc = {}, params["encoder"]
    n = len([k for k in enc if k.startswith("conv_")])
    for i in range(n):
        _put(sd, f"encoder.main.{3 * i}", _conv(enc[f"conv_{i}"]))
        _res_block(sd, f"encoder.main.{3 * i + 2}", enc[f"res_{i}"])
    _vq_decoder(sd, params["decoder"], n, upsampling=False)
    sd["quantizer.embedding.weight"] = _t(params["codebook"])
    return sd
