"""Weight bridge between the JAX package's parameter trees and the port's modules.

Flax parameter trees are nested dicts of arrays (anything ``np.asarray``
reads; no JAX import here). A :class:`FlaxLayout` maps a module's
parameters (or its BatchNorm statistics) onto flax paths, name for name,
in both directions:

- Dense kernel (in, out) <-> Linear weight (out, in); the head-aligned qkv
  kernel (C, 3, H, hd) and flax attention kernels (D, H, hd) / (H, hd, D)
  with their (H, hd) biases are the same memory in C order, so they are
  flattened and reshaped;
- Conv kernel (k, in, out) <-> Conv1d weight (out, in, k);
- LayerNorm / GroupNorm / BatchNorm ``scale`` <-> ``weight``; the BatchNorm
  ``batch_stats`` ``mean`` / ``var`` <-> ``running_mean`` / ``running_var``;
- a ModuleList entry ``blocks.i`` is flax's ``block_i`` (``down_i``,
  ``res_i``, ``up_i``, ``conv_i``, ``layer_i``, the MotionCLIP decoder's
  ``ln_q{i}``, ``cross{i}``, ``fc1_{i}``...); the MDM's scan-stacked ``blocks/block/*`` hold the
  layers on axis 0 (an unrolled ``block_i`` tree, ``scan_blocks=False``, is
  read as it is);
- ``word_embedding``, ``uncond_prompt_embedding``, the TMR ``dist_tokens``,
  the MotionCLIP decoder's ``time_queries``, the RVQ codebooks (Q, K, D),
  the face VQ-VAE's codebook and the skeleton convs' (k, in, out) kernels
  are carried as they are;
- the t2m oracle's GRU cells keep flax's per-gate Dense layers
  (``gru/GRUCell_i/{ir,iz,in,hr,hz,hn}``), so they map as any Dense does
  (:func:`load_t2m_oracle`, :func:`t2m_oracle_to_flax`).

An MDM is loaded from its flax variables: ``{'params': ..., 'batch_stats':
...}`` as ``create_mdm`` returns them for ``audio_norm='batch'``, or the bare
param tree of a model without statistics. :func:`mdm_to_flax`,
``FlaxLayout(module).to_flax`` (an RVQ-VAE, the TMR heads, MotionCLIP)
and :func:`rvq_state_to_flax` go the other way, and
:func:`optax_state_from_flax` turns a JAX optimizer state into the port's
(:mod:`syntalker_tpu_torch.train.optim`), so that a JAX train state resumes
in the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from syntalker_tpu_torch.device import resolve_device
from syntalker_tpu_torch.models.denoiser import MDM, BatchNorm, MDMConfig, TransformerBlock
from syntalker_tpu_torch.models.eval_vae import EvalVAEConfig, VAESKConv, VQVAEConvZero
from syntalker_tpu_torch.models.motionclip import MotionCLIP, MotionCLIPDecoder
from syntalker_tpu_torch.models.rvqvae import RVQVAE, RVQVAEConfig
from syntalker_tpu_torch.models.tmr import ActorAgnosticEncoder, Attention, DistilbertTextEncoder
from syntalker_tpu_torch.ops.quantize import RVQState

# ModuleList name -> flax name of entry i
_INDEXED = {"blocks": "block_{}", "down": "down_{}", "res": "res_{}", "up": "up_{}", "ln_q": "ln_q{}",
            "ln_f": "ln_f{}", "cross": "cross{}", "fc1": "fc1_{}", "fc2": "fc2_{}", "conv": "conv_{}",
            "layer": "layer_{}"}
_NORMS = (torch.nn.LayerNorm, torch.nn.GroupNorm, BatchNorm)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32))


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: str  # "/"-joined flax path inside its collection
    names: Tuple[str, ...]  # torch names, one per layer when stacked
    kind: str  # "linear" (transposed), "conv" (axes reversed) or "plain" (reshaped)
    shape: Tuple[int, ...]  # flax shape of one torch tensor
    torch_shape: Tuple[int, ...]
    stacked: bool  # the flax leaf holds the layers on axis 0


def _flax_prefix(torch_prefix: str, stacked: Optional[str]):
    """(flax module path, layer index or None) of a torch module path."""
    parts, out, layer, i = torch_prefix.split(".") if torch_prefix else [], [], None, 0
    while i < len(parts):
        if i + 1 < len(parts) and parts[i + 1].isdigit():
            if i == 0 and parts[i] == stacked:
                out += [stacked, "block"]
                layer = int(parts[i + 1])
            else:
                out.append(_INDEXED[parts[i]].format(parts[i + 1]))
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return out, layer


def _linear_shapes(module: torch.nn.Linear, name: str, parent) -> Tuple[tuple, tuple]:
    """Flax (kernel, bias) shapes of a Linear: a DenseGeneral's where the
    flax module has one."""
    din, dout = module.in_features, module.out_features
    if isinstance(parent, TransformerBlock) and name == "qkv":
        h = parent.num_heads
        return (din, 3, h, din // h), (3, h, din // h)
    if isinstance(parent, Attention):
        h = parent.heads
        if name == "out":
            return (h, din // h, dout), (dout,)
        return (din, h, dout // h), (h, dout // h)
    return (din, dout), (dout,)


def _entries(m: torch.nn.Module, own: str, parent, collection: str) -> list:
    """(torch name, flax name, kind, flax shape) of a module's own tensors."""
    if collection == "batch_stats":
        if isinstance(m, BatchNorm):
            c = m.running_mean.numel()
            return [("running_mean", "mean", "plain", (c,)), ("running_var", "var", "plain", (c,))]
        return []
    if isinstance(m, torch.nn.Linear):
        kshape, bshape = _linear_shapes(m, own, parent)
        out = [("weight", "kernel", "linear", kshape)]
        return out + ([("bias", "bias", "plain", bshape)] if m.bias is not None else [])
    if isinstance(m, torch.nn.Conv1d):
        return [("weight", "kernel", "conv", tuple(m.weight.shape[::-1])), ("bias", "bias", "plain", (m.out_channels,))]
    if isinstance(m, _NORMS):
        return [("weight", "scale", "plain", tuple(m.weight.shape)), ("bias", "bias", "plain", tuple(m.bias.shape))]
    return [(n, n, "plain", tuple(p.shape)) for n, p in m.named_parameters(recurse=False)]


class FlaxLayout:
    """The flax paths of a module's parameters (``collection='params'``) or
    of its BatchNorm statistics (``'batch_stats'``). With ``stacked``, the
    entries of the top-level ModuleList of that name are stacked on axis 0
    under ``<stacked>/block`` (flax's ``nn.scan``)."""

    def __init__(self, module: torch.nn.Module, *, stacked: Optional[str] = None, collection: str = "params"):
        groups: Dict[str, list] = {}
        modules = dict(module.named_modules())
        tensors = dict(module.named_parameters()) if collection == "params" else dict(module.named_buffers())
        for prefix, m in modules.items():
            parent_name, _, own = prefix.rpartition(".")
            fpath, layer = _flax_prefix(prefix, stacked)
            for tname, fname, kind, shape in _entries(m, own, modules.get(parent_name) if prefix else None,
                                                      collection):
                full = f"{prefix}.{tname}" if prefix else tname
                g = groups.setdefault("/".join(fpath + [fname]), [kind, shape, tuple(tensors[full].shape),
                                                                  layer is not None, {}])
                g[4][0 if layer is None else layer] = full
        self.collection = collection
        self.leaves = [Leaf(path, tuple(names[i] for i in sorted(names)), kind, shape, tshape, st)
                       for path, (kind, shape, tshape, st, names) in groups.items()]

    def names(self) -> list:
        return [n for leaf in self.leaves for n in leaf.names]

    def to_flax(self, tensors: Mapping[str, torch.Tensor]) -> dict:
        """Torch-named tensors (parameters, or anything shaped like them:
        gradients, optimizer moments) -> nested flax dict of f32 numpy."""
        tree: dict = {}
        for leaf in self.leaves:
            arrs = []
            for n in leaf.names:
                a = tensors[n].detach().float().cpu()
                if leaf.kind == "linear":
                    a = a.T
                elif leaf.kind == "conv":
                    a = a.permute(2, 1, 0)
                arrs.append(a.reshape(leaf.shape).numpy())
            node, keys = tree, leaf.path.split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = np.stack(arrs) if leaf.stacked else arrs[0]
        return tree

    def from_flax(self, tree: Mapping) -> Dict[str, torch.Tensor]:
        """A flax tree (nested dicts of arrays) -> torch-named f32 tensors in
        the torch layout."""
        out = {}
        for leaf in self.leaves:
            node = tree
            for k in leaf.path.split("/"):
                node = node[k]
            arr = _t(node)
            for i, n in enumerate(leaf.names):
                a = arr[i] if leaf.stacked else arr
                if leaf.kind == "linear":
                    a = a.reshape(leaf.torch_shape[1], leaf.torch_shape[0]).T
                elif leaf.kind == "conv":
                    a = a.permute(2, 1, 0)
                out[n] = a.reshape(leaf.torch_shape).contiguous()
        return out

    @torch.no_grad()
    def load(self, module: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
        """Copy a flax tree into ``module``'s parameters (or statistics)."""
        own = dict(module.named_parameters()) if self.collection == "params" else dict(module.named_buffers())
        for name, v in self.from_flax(tree).items():
            own[name].copy_(v)
        return module


def flax_layouts(module: torch.nn.Module, *, stacked: Optional[bool] = None) -> Tuple[FlaxLayout, FlaxLayout]:
    """A module's (params, batch_stats) layouts. An MDM's blocks are
    scan-stacked as ``cfg.scan_blocks`` says unless ``stacked`` is given."""
    if isinstance(module, MDM):
        stacked = module.cfg.scan_blocks if stacked is None else stacked
    return (FlaxLayout(module, stacked="blocks" if stacked else None),
            FlaxLayout(module, collection="batch_stats"))


def load_mdm(mdm: MDM, variables: dict) -> MDM:
    """Copy flax MDM variables (scan-stacked blocks, or unrolled
    ``block_i``) into ``mdm``."""
    p = variables.get("params", variables)
    params, stats = flax_layouts(mdm, stacked="blocks" in p)
    params.load(mdm, p)
    if stats.leaves:
        stats.load(mdm, variables["batch_stats"])
    return mdm


def mdm_to_flax(mdm: MDM) -> dict:
    """The MDM's flax variables: ``{'params': ...}`` plus ``batch_stats``
    for a BatchNorm wav encoder; blocks laid out as ``cfg.scan_blocks``."""
    params, stats = flax_layouts(mdm)
    out = {"params": params.to_flax(dict(mdm.named_parameters()))}
    if stats.leaves:
        out["batch_stats"] = stats.to_flax(dict(mdm.named_buffers()))
    return out


def load_rvqvae(module: RVQVAE, params: dict) -> RVQVAE:
    """Copy a flax RVQVAE param tree, encoder and decoder, into ``module``."""
    return FlaxLayout(module).load(module, params.get("params", params))


def load_actor_encoder(enc: ActorAgnosticEncoder, p: dict) -> ActorAgnosticEncoder:
    """A flax ``ActorAgnosticEncoder`` tree (TMR motion side, a text head's
    ``head``, MotionCLIP's ``encoder``) into ``enc``."""
    return FlaxLayout(enc).load(enc, p)


def load_tmr_text(head: DistilbertTextEncoder, p: dict) -> DistilbertTextEncoder:
    """A flax ``DistilbertTextEncoder`` tree (``projection``, ``head``)."""
    return FlaxLayout(head).load(head, p)


def load_motionclip(model: MotionCLIP, p: dict) -> MotionCLIP:
    """A flax ``MotionCLIP`` tree (``encoder``, ``proj``)."""
    return FlaxLayout(model).load(model, p)


def load_motionclip_decoder(dec: MotionCLIPDecoder, p: dict) -> MotionCLIPDecoder:
    """A flax ``MotionCLIPDecoder`` tree."""
    return FlaxLayout(dec).load(dec, p)


def load_eval_vae(module: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Copy a flax ``VAESKConv`` or ``VQVAEConvZero`` param tree (numpy
    arrays) into ``module``."""
    return FlaxLayout(module).load(module, params.get("params", params))


def eval_vae_from_flax(params: dict, cfg: EvalVAEConfig = EvalVAEConfig(), *, device=None) -> VAESKConv:
    """The FGD eval VAE, in eval mode, from a flax param tree."""
    return load_eval_vae(VAESKConv(cfg), params).to(resolve_device(device)).eval().requires_grad_(False)


def face_vqvae_from_flax(params: dict, *, device=None) -> VQVAEConvZero:
    """The face VQ-VAE, in eval mode, from a flax param tree."""
    return load_eval_vae(VQVAEConvZero(), params).to(resolve_device(device)).eval().requires_grad_(False)


def mdm_from_flax(cfg: MDMConfig, variables: dict, *, device=None) -> MDM:
    """The port's MDM, in eval mode, from flax variables (or a bare param
    tree, as ``mdm_variables`` takes them in JAX)."""
    mdm = load_mdm(MDM(cfg), variables)
    return mdm.to(resolve_device(device)).eval().requires_grad_(False)


def rvq_state_from_flax(qstate: Mapping, *, device=None) -> RVQState:
    """An ``RVQState`` from its flax fields: the codebooks alone (an
    inference checkpoint) or all four (a train state)."""
    device = resolve_device(device)
    get = (lambda k: _t(qstate[k]).to(device) if k in qstate else None)
    init = qstate.get("initialized")
    return RVQState(get("codebook"), get("code_sum"), get("code_count"),
                    initialized=True if init is None else bool(np.asarray(init) > 0.5))


def rvq_state_to_flax(state: RVQState) -> dict:
    out = {k: getattr(state, k).detach().float().cpu().numpy() for k in ("codebook", "code_sum", "code_count")
           if getattr(state, k) is not None}
    out["initialized"] = np.asarray(state.initialized, np.float32)
    return out


def rvqvae_from_flax(cfg: RVQVAEConfig, params: dict, codebook, *, device=None):
    """(RVQVAE, RVQState) from a flax param tree and the RVQState codebook
    (an array, or the flax ``quantizer_state`` dict)."""
    device = resolve_device(device)
    module = load_rvqvae(RVQVAE(cfg), params).to(device).eval().requires_grad_(False)
    qstate = codebook if isinstance(codebook, Mapping) else {"codebook": codebook}
    return module, rvq_state_from_flax(qstate, device=device)


def _field(node, key):
    """A NamedTuple field, a tuple entry or a dict key; a state that
    contributes no leaves (optax's ``EmptyState``) may be absent from a
    dict."""
    if isinstance(node, Mapping):
        return node.get(str(key), {})
    return node[key] if isinstance(key, int) else getattr(node, key)


def load_t2m_oracle(evaluator, params: Mapping):
    """A flax oracle tree ``{"motion": ..., "text": ...}`` into a
    ``T2MEvaluator``'s two towers."""
    for name, tower in (("motion", evaluator.motion_enc), ("text", evaluator.text_enc)):
        FlaxLayout(tower).load(tower, params[name])
    return evaluator


def t2m_oracle_to_flax(evaluator) -> dict:
    """A ``T2MEvaluator``'s two towers as the flax oracle tree."""
    return {name: FlaxLayout(tower).to_flax(dict(tower.named_parameters()))
            for name, tower in (("motion", evaluator.motion_enc), ("text", evaluator.text_enc))}


def optax_state_from_flax(jax_state, template, layout: FlaxLayout):
    """A JAX optimizer state -> the port's state shaped like ``template``
    (the port's ``init`` of the same optimizer). ``jax_state`` is optax's
    own (NamedTuples, tuples and param trees, numpy or JAX arrays at the
    leaves) or its nested-dict form (:func:`optax_state_to_flax`, a
    checkpoint): NamedTuple fields by name, chain entries by position, each
    param tree through ``layout`` to torch names on the template's device,
    counts as int32 host tensors."""
    if isinstance(template, dict):
        device = next(iter(template.values())).device if template else None
        return {k: v.to(device) for k, v in layout.from_flax(jax_state).items()}
    if hasattr(template, "_fields"):
        return type(template)(*(optax_state_from_flax(_field(jax_state, f), getattr(template, f), layout)
                                for f in template._fields))
    if isinstance(template, tuple):
        return tuple(optax_state_from_flax(_field(jax_state, i), t, layout) for i, t in enumerate(template))
    return torch.as_tensor(np.asarray(jax_state), dtype=template.dtype, device=template.device)


def optax_state_to_flax(state, layout: FlaxLayout) -> dict:
    """The port's optimizer state as nested dicts of f32 numpy: NamedTuple
    fields by name, chain entries by their position as a string, param
    trees in ``layout``'s flax paths."""
    if isinstance(state, dict):
        return layout.to_flax(state)
    if hasattr(state, "_fields"):
        return {f: optax_state_to_flax(getattr(state, f), layout) for f in state._fields}
    if isinstance(state, tuple):
        return {str(i): optax_state_to_flax(s, layout) for i, s in enumerate(state)}
    return np.asarray(state.detach().cpu(), np.float32)
