"""Reference torch checkpoints -> the port's modules.

Counterpart of ``syntalker_tpu/convert.py``. Users of the reference stack
hold its torch checkpoints: the body-part RVQ-VAEs (``net_300000.pth``,
``{'net': state_dict}``), the denoiser (``last_500.bin``, a bare state
dict), the FGD eval VAE (``AESKConv_240_100.bin``) and the face VQ-VAE
(``{'model_state': state_dict}``). The converters map a state dict onto the
flax-layout numpy trees that the JAX package's converters return, array for
array, and the bridge loads those into the port's modules:

- :func:`convert_rvqvae` -> ``bridge.rvqvae_from_flax(RVQVAEConfig(...),
  params, qstate.codebook)``;
- :func:`convert_mdm` -> ``bridge.mdm_from_flax(MDMConfig(audio_norm='none',
  ...), params)``: the WavEncoder's eval-mode BatchNorm is an affine map per
  channel and is folded into its convs;
- :func:`convert_eval_vae` -> ``bridge.eval_vae_from_flax(params)``;
- :func:`convert_face_vqvae` -> ``bridge.face_vqvae_from_flax(params)``.

Layout rules: torch Conv1d (out, in, k) -> flax (k, in, out); torch Linear
(out, in) -> flax (in, out); embeddings and codebooks as they are. A
``module.`` prefix (DataParallel) is dropped; keys that no converter reads
are ignored. The loaders call ``torch.load(path, map_location="cpu")``,
which loads tensors only (``weights_only``) on PyTorch 2.6 and later.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from syntalker_tpu_torch.ops.quantize import RVQState


def _conv(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 1, 0)))


def _linear(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (1, 0)))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _dense(sd: Dict, key: str, transform=_linear) -> Dict:
    return {"kernel": transform(sd[f"{key}.weight"]), "bias": sd[f"{key}.bias"]}


def convert_rvqvae(state_dict: Dict, *, down_t: int = 2, depth: int = 3,
                   num_quantizers: int = 6) -> Tuple[Dict, RVQState]:
    """Reference RVQVAE state dict -> (flax params, ``RVQState``).

    The reference's Sequential indices (models/vq/encdec.py): encoder
    ``model.0`` stem, ``model.{2+i}`` = (down conv, Resnet1D), then the head
    conv; decoder ``model.0`` stem, ``model.{2+i}`` = (Resnet1D, Upsample,
    conv), then the mid conv and, after an activation, the head. The
    activations hold no parameters. The EMA sums and counts are not saved,
    so the state warm-starts as JAX's does: ``code_sum`` the codebooks,
    ``code_count`` ones, initialized."""
    sd = {k: _np(v) for k, v in state_dict.items()}

    def conv(key):
        return _dense(sd, key, _conv)

    def resnet(prefix: str) -> Dict:
        # ResConv1DBlock: conv1 (dilated k3), conv2 (k1)
        return {f"block_{d}": {"conv_dilated": conv(f"{prefix}.model.{d}.conv1"),
                               "conv_proj": conv(f"{prefix}.model.{d}.conv2")} for d in range(depth)}

    enc: Dict = {"stem": conv("encoder.model.0")}
    for i in range(down_t):
        enc[f"down_{i}"] = conv(f"encoder.model.{2 + i}.0")
        enc[f"res_{i}"] = resnet(f"encoder.model.{2 + i}.1")
    enc["head"] = conv(f"encoder.model.{2 + down_t}")

    dec: Dict = {"stem": conv("decoder.model.0")}
    for i in range(down_t):
        dec[f"res_{i}"] = resnet(f"decoder.model.{2 + i}.0")
        dec[f"up_{i}"] = conv(f"decoder.model.{2 + i}.2")
    dec["mid"] = conv(f"decoder.model.{2 + down_t}")
    dec["head"] = conv(f"decoder.model.{4 + down_t}")

    codebooks = torch.from_numpy(np.stack(
        [sd[f"quantizer.layers.{q}.codebook"] for q in range(num_quantizers)]).astype(np.float32))
    qstate = RVQState(codebook=codebooks, code_sum=codebooks.clone(),
                      code_count=torch.ones(codebooks.shape[:2]), initialized=True)
    return {"params": {"encoder": enc, "decoder": dec}}, qstate


def _fold_bn(conv_w, conv_b, bn_w, bn_b, bn_mean, bn_var, eps=1e-5):
    """Fold eval-mode BatchNorm into the conv before it (flax layout):
    BN(conv(x)) = conv(x)·s + t with s = γ/√(σ²+ε), t = β − μ·s."""
    s = bn_w / np.sqrt(bn_var + eps)
    return conv_w * s[None, None, :], conv_b * s + (bn_b - bn_mean * s)


def convert_mdm(state_dict: Dict, num_layers: int = 8, num_heads: int = 4) -> Dict:
    """Reference MDM (models/denoiser.py) state dict -> flax variables.

    The WavEncoder's six BasicBlocks have their BatchNorm running statistics
    folded into the convs, so build the target with
    ``MDMConfig(audio_norm='none')``. The blocks come stacked on axis 0
    (the scan layout); torch's flat (C, 3C) qkv projection is part-major,
    then head-major in its columns, so a C-order reshape gives the
    head-aligned (L, C, 3, H, C/H) kernel."""
    sd = {k.removeprefix("module."): _np(v) for k, v in state_dict.items()}

    def folded(conv: str, bn: str) -> Dict:
        w, b = _fold_bn(_conv(sd[f"{conv}.weight"]), sd[f"{conv}.bias"], sd[f"{bn}.weight"], sd[f"{bn}.bias"],
                        sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"])
        return {"kernel": w, "bias": b}

    wav: Dict = {}
    for i in range(6):
        base = f"WavEncoder.feat_extractor.{i}"
        blk = {"conv1": folded(f"{base}.conv1", f"{base}.bn1"), "conv2": folded(f"{base}.conv2", f"{base}.bn2")}
        if f"{base}.downsample.0.weight" in sd:
            blk["down_conv"] = folded(f"{base}.downsample.0", f"{base}.downsample.1")
        wav[f"block_{i}"] = blk

    def stacked(key: str, transform=np.asarray) -> np.ndarray:
        return np.stack([transform(sd[f"mytimmblocks.{i}.{key}"]) for i in range(num_layers)])

    def stacked_dense(key: str) -> Dict:
        return {"kernel": stacked(f"{key}.weight", _linear), "bias": stacked(f"{key}.bias")}

    def stacked_norm(key: str) -> Dict:
        return {"scale": stacked(f"{key}.weight"), "bias": stacked(f"{key}.bias")}

    width = sd["mytimmblocks.0.attn.qkv.weight"].shape[1]
    params = {
        "wav_encoder": wav,
        "word_embedding": sd["text_pre_encoder_body.weight"],
        "text_encoder": _dense(sd, "text_encoder_body"),
        "mix_audio_text": _dense(sd, "mix_audio_text"),
        "embed_seed": _dense(sd, "embed_text"),
        "time_mlp": {"fc1": _dense(sd, "embed_timestep.time_embed.0"),
                     "fc2": _dense(sd, "embed_timestep.time_embed.2")},
        "input_process": _dense(sd, "input_process.poseEmbedding"),
        "input_process2": _dense(sd, "input_process2"),
        "output_process": _dense(sd, "output_process.poseFinal"),
        "blocks": {"block": {
            "norm1": stacked_norm("norm1"),
            "qkv": {"kernel": stacked("attn.qkv.weight", _linear).reshape(
                num_layers, -1, 3, num_heads, width // num_heads)},
            "proj": stacked_dense("attn.proj"),
            "norm2": stacked_norm("norm2"),
            "fc1": stacked_dense("mlp.fc1"),
            "fc2": stacked_dense("mlp.fc2"),
        }},
    }
    return {"params": params}


def _res_block(sd: Dict, prefix: str) -> Dict:
    """ResBlock (layer.py:203-216): convs at ``model.0`` and ``model.2``."""
    return {"conv1": _dense(sd, f"{prefix}.model.0", _conv), "conv2": _dense(sd, f"{prefix}.model.2", _conv)}


def _vq_decoder(sd: Dict, prefix: str, num_layers: int, *, upsampling: bool) -> Dict:
    """VQDecoderV3 (``upsampling``) or VQDecoderV5 Sequential -> param tree.

    Layout: a projection conv when ``main.0`` is a conv (input width !=
    channels[0]), 2 ResBlocks, then per stage (Upsample,) Conv, LeakyReLU,
    and the head conv."""
    out: Dict = {}
    p = 1 if f"{prefix}.main.0.weight" in sd else 0  # main.0 is a conv, not a ResBlock
    if p:
        out["proj"] = _dense(sd, f"{prefix}.main.0", _conv)
    out["res_0"] = _res_block(sd, f"{prefix}.main.{p}")
    out["res_1"] = _res_block(sd, f"{prefix}.main.{p + 1}")
    stride = 3 if upsampling else 2  # a V3 stage carries a parameter-free Upsample
    name = "up" if upsampling else "conv"
    for i in range(num_layers):
        out[f"{name}_{i}"] = _dense(sd, f"{prefix}.main.{p + 2 + stride * i + int(upsampling)}", _conv)
    out["head"] = _dense(sd, f"{prefix}.main.{p + 2 + stride * num_layers}", _conv)
    return out


def convert_eval_vae(state_dict: Dict, num_layers: int = 4) -> Dict:
    """Reference VAESKConv -> the port's :class:`~.models.eval_vae.VAESKConv`
    params. Encoder layer i is a SkeletonResidual (``residual.0`` the masked
    conv, ``residual.1`` GroupNorm, ``shortcut`` the k=1 conv); the topology
    masks are rebuilt on the port's side, and the ``fc_mu``/``fc_logvar``
    heads are skipped (the FGD embedding is not variational)."""
    sd = {k.removeprefix("module."): _np(v) for k, v in state_dict.items()}
    enc = {}
    for i in range(num_layers):
        base = f"encoder.layers.{i}.0"
        enc[f"layer_{i}"] = {
            "conv": _dense(sd, f"{base}.residual.0", _conv),
            "norm": {"scale": sd[f"{base}.residual.1.weight"], "bias": sd[f"{base}.residual.1.bias"]},
            "shortcut": _dense(sd, f"{base}.shortcut", _conv),
        }
    return {"params": {"encoder": enc, "decoder": _vq_decoder(sd, "decoder", num_layers, upsampling=True)}}


def convert_face_vqvae(state_dict: Dict, num_layers: int = 2) -> Dict:
    """Reference VQVAEConvZero -> the port's
    :class:`~.models.eval_vae.VQVAEConvZero` params: the encoder's
    Sequential [Conv, LeakyReLU, ResBlock] × n, the quantizer's embedding
    as the codebook, a VQDecoderV5."""
    sd = {k.removeprefix("module."): _np(v) for k, v in state_dict.items()}
    enc = {}
    for i in range(num_layers):
        enc[f"conv_{i}"] = _dense(sd, f"encoder.main.{3 * i}", _conv)
        enc[f"res_{i}"] = _res_block(sd, f"encoder.main.{3 * i + 2}")
    return {"params": {"encoder": enc, "decoder": _vq_decoder(sd, "decoder", num_layers, upsampling=False),
                       "codebook": sd["quantizer.embedding.weight"]}}


def load_torch_rvqvae(path: str, **kw) -> Tuple[Dict, RVQState]:
    """A reference ``net_*.pth`` (``{'net': state_dict}``), converted."""
    blob = torch.load(path, map_location="cpu")
    sd = blob.get("net", blob)
    return convert_rvqvae({k.removeprefix("module."): v for k, v in sd.items()}, **kw)


def load_torch_eval_checkpoint(path: str) -> Dict:
    """A reference eval checkpoint (``{'model_state': state_dict}``) as a
    state dict without the ``module.`` prefix, for
    :func:`convert_eval_vae` or :func:`convert_face_vqvae`."""
    blob = torch.load(path, map_location="cpu")
    sd = blob.get("model_state", blob)
    return {k.removeprefix("module."): v for k, v in sd.items()}
