"""Device meshes: data-parallel batches and the tensor-parallel layout.

Counterpart of ``syntalker_tpu/parallel/mesh.py``. JAX runs one program
over a ``Mesh`` of ``(data, model)`` devices and lets ``NamedSharding``
place arrays while XLA inserts the collectives. PyTorch has no global
sharded array (outside DTensor), so the port uses two forms behind one
:class:`Mesh`:

- **One process, no collectives** (serving): the process owns every device
  of the mesh. :func:`shard_batch` gives one block of the batch per data
  index, each on its device, and :func:`replicate` one copy per device;
  the service and the samplers run each shard with its own weights, graph
  plans and kernel launches, and gather the results to the host in
  data-axis order. JAX's serving forms have no collectives either.
- **One process per device** over ``torch.distributed`` (training, tensor
  parallelism): rank ``r`` owns the mesh position ``divmod(r, model)`` and
  its device, and the mesh holds the data-axis and model-axis subgroups
  (:class:`~syntalker_tpu_torch.parallel.collectives.Axis`) through which
  the train steps reduce (:mod:`~syntalker_tpu_torch.parallel.collectives`).
  :func:`shard_batch` gives this rank's block, :func:`replicate` broadcasts
  rank 0's values, :func:`shard_params` cuts the tensor-parallel weights.

One departure from JAX: a device may appear more than once in a mesh. A
mesh of eight ``cpu`` entries stands in for the eight virtual XLA devices
of the CPU tests, and a ``data=2`` mesh of ``[cuda:0, cuda:0]`` runs the
sharded service on one card (one copy of the weights per distinct device;
the shards take turns on it).
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from syntalker_tpu_torch.parallel.collectives import Axis, broadcast_
from syntalker_tpu_torch.parallel.multihost import group_started, local_device


class P(tuple):
    """A parameter's partition spec, as ``jax.sharding.PartitionSpec``: one
    entry per dimension, None (replicated) or a mesh axis name. ``blocks``
    says that the sharded dimension holds that many equal blocks, each cut
    over the axis, so a rank takes its piece of every block (the [q | k | v]
    rows of a fused qkv weight)."""

    def __new__(cls, *axes, blocks: int = 1):
        self = super().__new__(cls, axes)
        self.blocks = blocks
        return self

    def __eq__(self, other):
        return tuple.__eq__(self, other) and getattr(other, "blocks", 1) == self.blocks

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash((tuple(self), self.blocks))

    def __repr__(self):
        extra = f", blocks={self.blocks}" if self.blocks != 1 else ""
        return f"P({', '.join(map(repr, self))}{extra})"


def _canonical(device) -> torch.device:
    """``cuda`` as the card it means (the current one), so that a device
    compares equal to its tensors'."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A ``(data, model)`` grid of ``torch.device``s (``devices[d][m]``),
    ``shape = {"data": .., "model": ..}`` as JAX's. Without a process group
    the process owns every position; under one, rank ``r`` owns position
    ``divmod(r, model)``, and ``data`` / ``model`` are its axes (the ranks
    that share its model index, and those that share its data index).
    Outside a group both axes are None: a single process runs no
    collectives. ``local`` makes a mesh this process runs alone even under
    a group (a service inside a training process)."""

    def __init__(self, devices: Sequence[Sequence], *, local: bool = False):
        self.devices = [[_canonical(d) for d in row] for row in devices]
        n_data, n_model = len(self.devices), len(self.devices[0])
        self.shape = {"data": n_data, "model": n_model}
        self.in_group = group_started() and not local
        self.data: Optional[Axis] = None
        self.model: Optional[Axis] = None
        if not self.in_group:
            self.owned = [(d, m) for d in range(n_data) for m in range(n_model)]
            return
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_data * n_model != world:
            raise ValueError(f"mesh {n_data}x{n_model} against a process group of {world}: a mesh takes one rank a "
                             "device (start one process per device with torchrun)")
        d_own, m_own = divmod(rank, n_model)
        self.owned = [(d_own, m_own)]
        # every rank enters every new_group, in the same order
        for m in range(n_model):
            ranks = [d * n_model + m for d in range(n_data)]
            group = dist.new_group(ranks) if n_data > 1 else None
            if m == m_own:
                self.data = Axis(group, n_data, d_own)
        for d in range(n_data):
            ranks = [d * n_model + m for m in range(n_model)]
            group = dist.new_group(ranks) if n_model > 1 else None
            if d == d_own:
                self.model = Axis(group, n_model, m_own)

    @property
    def device(self) -> torch.device:
        """The device of this process's first position (its only one under
        a group)."""
        d, m = self.owned[0]
        return self.devices[d][m]

    @property
    def data_index(self) -> int:
        return self.owned[0][0]

    @property
    def model_index(self) -> int:
        return self.owned[0][1]

    def data_shards(self) -> List[tuple]:
        """(data index, device) of each data shard this process runs: every
        data index on the model axis's first device in a single process,
        its own position under a group."""
        if self.in_group:
            return [(self.data_index, self.device)]
        return [(d, self.devices[d][0]) for d in range(self.shape["data"])]

    def local_devices(self) -> List[torch.device]:
        """The distinct devices this process owns, in mesh order."""
        out = []
        for d, m in self.owned:
            if self.devices[d][m] not in out:
                out.append(self.devices[d][m])
        return out

    def __repr__(self):
        return f"Mesh({self.shape}, owned={self.owned})"


def make_mesh(data: int = -1, model: int = 1, *, devices: Optional[Sequence] = None) -> Mesh:
    """Create a (data, model) mesh; ``data=-1`` uses all remaining devices.
    ``devices`` default to one a rank (``cuda:<local rank>``) under a
    process group, else every CUDA device of the process. Raises
    ``ValueError`` when the devices do not fill the mesh."""
    if devices is None:
        if group_started():
            world, rank = dist.get_world_size(), dist.get_rank()
            own = local_device()
            cards = max(1, torch.cuda.device_count())
            other = (lambda r: torch.device("cuda", r % cards)) if own.type == "cuda" else (lambda r: own)
            devices = [own if r == rank else other(r) for r in range(world)]
        else:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device available; pass devices= (e.g. [torch.device('cpu')] * 8) "
                                   "to build a mesh of CPU entries")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data == -1:
        if model < 1 or n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data < 1 or data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh([devices[i * model : (i + 1) * model] for i in range(data)])


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists, tuples and dataclass
    instances; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _map(lambda x: out.append(x), tree)
    return out


def shard_batch(batch: Any, mesh: Mesh, *, axis: int = 0) -> List[Any]:
    """Every tensor leaf's ``axis`` split into contiguous blocks in data-index
    order, as ``P("data")`` places it: one tree a data shard this process
    runs (:meth:`Mesh.data_shards`), each on its device. numpy leaves become
    tensors. Raises ``ValueError`` when the axis does not divide."""
    n_data = mesh.shape["data"]

    def check(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.shape[axis] % n_data:
            raise ValueError(f"batch size {x.shape[axis]} not divisible by the data axis ({n_data} devices); "
                             "pick train.batch_size as a multiple, or shrink the mesh with train.data_parallel")
        return x

    _map(check, batch)

    def block(index, device):
        def take(x):
            if not isinstance(x, (torch.Tensor, np.ndarray)):
                return x
            x = torch.as_tensor(x)
            size = x.shape[axis] // n_data
            return x.narrow(axis, index * size, size).to(device).contiguous()
        return take

    return [_map(block(index, device), batch) for index, device in mesh.data_shards()]


def _module_device(module: nn.Module) -> Optional[torch.device]:
    for t in list(module.parameters()) + list(module.buffers()):
        return t.device
    return None


def replicate(tree: Any, mesh: Mesh) -> Dict[torch.device, Any]:
    """A copy of ``tree`` (tensors, modules, and dicts, lists and dataclasses
    of them) on each distinct device this process owns: ``{device: tree}``.
    A module already on a device is that device's copy. Under a process
    group rank 0's values are first broadcast to every rank, so replicas
    cannot drift; modules are updated in place."""
    out = {}
    for device in mesh.local_devices():
        def put(x, device=device):
            if isinstance(x, nn.Module):
                if mesh.in_group or _module_device(x) in (None, device):
                    return x.to(device)
                return copy.deepcopy(x).to(device)
            if isinstance(x, (torch.Tensor, np.ndarray)):
                x = torch.as_tensor(x).to(device)
                return x.clone() if mesh.in_group else x
            return x

        out[device] = _map(put, tree)
        if mesh.in_group:
            tensors = []
            for leaf in _leaves(out[device]):
                if isinstance(leaf, nn.Module):
                    tensors += list(leaf.parameters()) + list(leaf.buffers())
                elif isinstance(leaf, torch.Tensor):
                    tensors.append(leaf)
            broadcast_(tensors)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement over a mesh: ``P("data")`` shards the leading axis
    (:func:`shard_batch`), ``P()`` replicates (:func:`replicate`)."""

    mesh: Mesh
    spec: P

    def put(self, tree):
        return shard_batch(tree, self.mesh) if self.spec == P("data") else replicate(tree, self.mesh)


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# The tensor-parallel layout of the MDM transformer stack (Megatron-style,
# as JAX's): the attention and the MLP are each a column-parallel matmul
# followed by a row-parallel one, whose partial sums one all-reduce over the
# model axis adds (``TransformerBlock`` does it after proj and after fc2).
# The fused qkv is ``nn.Linear(dim, 3*dim)``: its weight rows are
# [q | k | v], each head-major, so a contiguous cut of the rows would fall
# mid-k (the round-1 bug JAX's table records). ``blocks=3`` cuts each of the
# three blocks instead, which gives every rank whole heads of q, k and v.
# A weight is (out, in): column-parallel cuts its rows, row-parallel its
# columns. Keys are suffixes of the parameter path with the block index
# dropped (``blocks.3.qkv.weight`` -> ``blocks/qkv/weight``). Everything not
# listed (embeddings, LayerNorms, the WavEncoder, the input and output
# projections, the timestep MLP, proj's and fc2's biases, added once after
# the all-reduce) stays replicated.
MDM_TP_LAYOUT: Dict[str, P] = {
    "blocks/qkv/weight": P("model", None, blocks=3),
    "blocks/proj/weight": P(None, "model"),
    "blocks/fc1/weight": P("model", None),
    "blocks/fc1/bias": P("model"),
    "blocks/fc2/weight": P(None, "model"),
}

_BLOCK_INDEX = re.compile(r"(^|/)blocks/\d+/")


def _path_str(name: str) -> str:
    """A parameter name as a layout path, the block index dropped."""
    return _BLOCK_INDEX.sub(r"\1blocks/", name.replace(".", "/"))


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(params, layout: Optional[dict] = None) -> Dict[str, P]:
    """Parameter name -> partition spec from the layout table (default
    :data:`MDM_TP_LAYOUT`) for a module or a dict of named tensors;
    unmatched parameters are replicated (``P()``)."""
    table = MDM_TP_LAYOUT if layout is None else layout

    def lookup(path):
        for suffix, spec in table.items():
            if path == suffix or path.endswith("/" + suffix):
                return spec
        return P()

    return {name: lookup(_path_str(name)) for name in _named(params)}


def shard_tensor(x: torch.Tensor, spec: P, index: int, size: int) -> torch.Tensor:
    """The piece of ``x`` that position ``index`` of a ``size``-long axis
    holds under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = x.shape[dim] // spec.blocks
        piece = n // size
        x = x.unflatten(dim, (spec.blocks, n)).narrow(dim + 1, index * piece, piece).flatten(dim, dim + 1)
    return x.contiguous()


def shard_params(params, mesh: Mesh, *, layout: Optional[dict] = None):
    """Place parameters per the tensor-parallel layout: with ``model=1``,
    :func:`replicate`; with ``model > 1``, under a process group, every
    matched parameter of this rank is cut to its piece (a module in place;
    its ``TransformerBlock``s then run their local heads and all-reduce
    after proj and fc2). Returns ``{device: params}``.

    Raises ``ValueError`` for a spec that does not divide its parameter, a
    spec of more dimensions than its parameter, a layout that matches no
    parameter (tensor parallelism would be silently disabled), heads that
    do not divide over the axis, and a mesh with ``model > 1`` in a single
    process: tensor parallelism runs one process per device."""
    if mesh.shape["model"] == 1:
        return replicate(params, mesh)
    size = mesh.shape["model"]
    specs = param_specs(params, layout)
    named = _named(params)
    any_model_sharded = False
    for name, x in named.items():
        spec = specs[name]
        if len(spec) > x.ndim:
            raise ValueError(f"TP layout error: {name} has rank {x.ndim} but its layout spec {spec} has {len(spec)} "
                             "dims")
        for i, axis in enumerate(spec):
            if axis is not None and x.shape[i] % (mesh.shape[axis] * spec.blocks):
                raise ValueError(f"TP layout error: {name} shape {tuple(x.shape)} dim {i} not divisible by mesh axis "
                                 f"'{axis}'={mesh.shape[axis]} in {spec.blocks} block(s)")
        any_model_sharded = any_model_sharded or "model" in spec
    if not any_model_sharded:
        raise ValueError(f"TP layout error: mesh has model={size} but no parameter matched a model-sharded layout "
                         "entry — tensor parallelism would be silently disabled. Check the layout table against "
                         "the parameter names.")
    heads = [m for m in params.modules() if hasattr(m, "shard_heads")] if isinstance(params, nn.Module) else []
    for blk in heads:
        if blk.num_heads % size:
            raise ValueError(f"TP layout error: {blk.num_heads} heads do not split into whole heads over model={size}")
    if not mesh.in_group:
        raise ValueError(f"tensor parallelism (model={size}) runs one process per device: start them with torchrun "
                         "(or init_multihost) and build the mesh in each")
    replicate(params, mesh)
    index = mesh.model_index
    if isinstance(params, nn.Module):
        params.to(mesh.device)
        for name, p in params.named_parameters():
            if "model" in specs[name]:
                p.data = shard_tensor(p.data, specs[name], index, size)
        for blk in heads:
            blk.shard_heads(mesh.model)
        return {mesh.device: params}
    return {mesh.device: {name: shard_tensor(torch.as_tensor(x).to(mesh.device), specs[name], index, size)
                          if "model" in specs[name] else torch.as_tensor(x).to(mesh.device)
                          for name, x in named.items()}}


def attach_data_axis(module: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Give every submodule that reduces over the batch in training (a
    ``data_axis`` attribute: the wav encoder's BatchNorm, the RVQ-VAE's
    quantizer statistics) the mesh's data axis; None detaches."""
    axis = None if mesh is None else mesh.data
    for m in module.modules():
        if hasattr(m, "data_axis"):
            m.data_axis = axis
    return module
