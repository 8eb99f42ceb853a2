"""Skeleton-topology-aware convolutions (Aberman et al. style).

Counterpart of ``syntalker_tpu/models/skeleton.py``: the edge topology of a
kinematic tree, edge-distance neighbourhoods, the chain-pooling plans and
their matrices (host numpy, computed once at construction), and the
modules over (B, T, edges*channels): ``SkeletonConv``, a dense conv1d whose
kernel is multiplied by a static 0/1 neighbourhood mask at every call,
``SkeletonPool``, a static mean-pool matmul, and ``SkeletonResidual``, the
strided conv + GroupNorm residual block followed by pooling and tanh.

``SkeletonConv`` keeps its raw kernel in flax's (k, in, out) layout as the
parameter and the mask as a buffer, so that a converted checkpoint whose
masked-out entries are not zero computes what it computes in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# topology (host numpy)


def build_edge_topology(parents: Sequence[int]) -> List[Tuple[int, int]]:
    """Edges (parent, child), with a virtual root edge first."""
    joint_num = len(parents)
    edges = [(0, joint_num)]
    for i in range(1, joint_num):
        edges.append((int(parents[i]), i))
    return edges


def calc_edge_mat(edges: List[Tuple[int, int]]) -> np.ndarray:
    """All-pairs distances in the edge adjacency graph."""
    n = len(edges)
    mat = np.full((n, n), 100000, dtype=np.int64)
    for i, a in enumerate(edges):
        for j, b in enumerate(edges):
            if a[0] in b or a[1] in b:
                mat[i, j] = 1
    np.fill_diagonal(mat, 0)
    for k in range(n):
        mat = np.minimum(mat, mat[:, k : k + 1] + mat[k : k + 1, :])
    return mat


def find_neighbor(edges: List[Tuple[int, int]], d: int) -> List[List[int]]:
    """Per edge, the edge indices within graph distance d."""
    mat = calc_edge_mat(edges)
    return [list(np.nonzero(mat[i] <= d)[0]) for i in range(len(edges))]


@dataclasses.dataclass
class PoolingPlan:
    pooling_list: List[List[int]]
    new_edges: List[Tuple[int, int]]


def skeleton_pooling_plan(edges: List[Tuple[int, int]], last_pool: bool = False) -> PoolingPlan:
    """Chain-merging plan: the edges of each degree-2 chain merge pairwise
    (an odd chain keeps its first edge alone); ``last_pool`` merges each
    chain whole."""
    degree = [0] * (max(max(e) for e in edges) + 2)
    for a, b in edges:
        degree[a] += 1
        degree[b] += 1

    seq_list: List[List[int]] = []

    def find_seq(j: int, seq: List[int]):
        if degree[j] > 2 and j != 0:
            seq_list.append(seq)
            seq = []
        if degree[j] == 1:
            seq_list.append(seq)
            return
        for idx, e in enumerate(edges):
            if e[0] == j:
                find_seq(e[1], seq + [idx])

    find_seq(0, [])

    pooling_list: List[List[int]] = []
    new_edges: List[Tuple[int, int]] = []
    for seq in seq_list:
        if last_pool:
            pooling_list.append(seq)
            continue
        if len(seq) % 2 == 1:
            pooling_list.append([seq[0]])
            new_edges.append(edges[seq[0]])
            seq = seq[1:]
        for i in range(0, len(seq), 2):
            pooling_list.append([seq[i], seq[i + 1]])
            new_edges.append((edges[seq[i]][0], edges[seq[i + 1]][1]))
    return PoolingPlan(pooling_list, new_edges)


def pooling_matrix(plan: PoolingPlan, channels_per_edge: int, n_edges: int) -> np.ndarray:
    """(new_edges*c, old_edges*c) mean-pool matrix."""
    w = np.zeros((len(plan.pooling_list) * channels_per_edge, n_edges * channels_per_edge), np.float32)
    for i, group in enumerate(plan.pooling_list):
        for j in group:
            for c in range(channels_per_edge):
                w[i * channels_per_edge + c, j * channels_per_edge + c] = 1.0 / len(group)
    return w


def unpooling_matrix(plan: PoolingPlan, channels_per_edge: int) -> np.ndarray:
    """(old_edges*c, new_edges*c) copy-unpool matrix."""
    out_edges = sum(len(g) for g in plan.pooling_list)
    w = np.zeros((out_edges * channels_per_edge, len(plan.pooling_list) * channels_per_edge), np.float32)
    for i, group in enumerate(plan.pooling_list):
        for j in group:
            for c in range(channels_per_edge):
                w[j * channels_per_edge + c, i * channels_per_edge + c] = 1.0
    return w


def skeleton_conv_mask(neighbour_list: List[List[int]], in_per_joint: int, out_per_joint: int,
                       kernel_size: int) -> np.ndarray:
    """Static 0/1 mask (k, in_ch, out_ch) restricting each edge's output
    channels to its neighbourhood's input channels (flax's conv layout)."""
    n = len(neighbour_list)
    mask = np.zeros((kernel_size, n * in_per_joint, n * out_per_joint), np.float32)
    for i, neigh in enumerate(neighbour_list):
        cols = slice(i * out_per_joint, (i + 1) * out_per_joint)
        for k in neigh:
            mask[:, k * in_per_joint : (k + 1) * in_per_joint, cols] = 1.0
    return mask


# ---------------------------------------------------------------------------
# modules over (B, T, C)


class SkeletonConv(nn.Module):
    """Topology-masked conv1d over (B, T, edges*channels). ``kernel`` is
    (k, in, out), flax's layout; the mask multiplies it at every call."""

    def __init__(self, neighbour_list, in_per_joint: int, out_per_joint: int, kernel_size: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        n = len(neighbour_list)
        in_ch, out_ch = n * in_per_joint, n * out_per_joint
        self.stride, self.padding = stride, padding
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        # flax's he_uniform over a (k, in, out) kernel: fan_in = k * in
        bound = (6.0 / (kernel_size * in_ch)) ** 0.5
        nn.init.uniform_(self.kernel, -bound, bound)
        mask = skeleton_conv_mask([list(t) for t in neighbour_list], in_per_joint, out_per_joint, kernel_size)
        self.register_buffer("mask", torch.as_tensor(mask))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.kernel * self.mask).permute(2, 1, 0)  # (out, in, k)
        return F.conv1d(x.transpose(1, 2), w, self.bias, stride=self.stride, padding=self.padding).transpose(1, 2)


class SkeletonPool(nn.Module):
    """Static mean-pool over merged edge chains: (B, T, E*c) -> (B, T, E'*c)."""

    def __init__(self, weight: np.ndarray):
        super().__init__()
        self.register_buffer("weight", torch.as_tensor(np.asarray(weight, np.float32)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.T


class SkeletonResidual(nn.Module):
    """Stride-2 skeleton conv + GroupNorm(10, eps 1e-5, torch's, as the
    converted reference checkpoints need) plus a stride-2 k=1 shortcut, then
    chain pooling and tanh."""

    def __init__(self, neighbour_list, in_per_joint: int, out_per_joint: int, kernel_size: int,
                 pool_weight: np.ndarray):
        super().__init__()
        out_ch = len(neighbour_list) * out_per_joint
        self.conv = SkeletonConv(neighbour_list, in_per_joint, out_per_joint, kernel_size, stride=2,
                                 padding=(kernel_size - 1) // 2)
        self.norm = nn.GroupNorm(10, out_ch, eps=1e-5)
        self.shortcut = SkeletonConv(neighbour_list, in_per_joint, out_per_joint, 1, stride=2, padding=0)
        self.pool = SkeletonPool(pool_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.norm(self.conv(x).transpose(1, 2)).transpose(1, 2)
        return torch.tanh(self.pool(res + self.shortcut(x)))
