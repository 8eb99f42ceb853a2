"""Latents -> motion: the residual-VQ snap, the RVQ-VAE decoder, the
denormalization and the rotations.

The snap picks, layer by layer, the code nearest the residual. It runs in
float64 here. A row whose two nearest codes lie within ``TIE`` of each
other (relative to the residual's squared norm) is a near tie: float32
arithmetic in any order may take either code, and the two decode to
different motion. So :func:`snap_variants` branches on the nearest ties of
a part (at most ``MAX_TIES``, on distinct rows) and returns every choice;
a judge takes the variant closest to what it judges.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import exact

TIE = 1e-5  # a near tie: top-2 squared distances within TIE * |r|^2
MAX_TIES = 4  # branches per part and clip: 2**MAX_TIES variants at most
PART_JOINTS = {
    "upper": (3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21),
    "hands": tuple(range(25, 55)),
    "lower": (0, 1, 2, 4, 5, 7, 8, 10, 11),
}


def part_index(part: str, per_joint: int = 6) -> np.ndarray:
    return np.asarray([j * per_joint + k for j in PART_JOINTS[part] for k in range(per_joint)])


def _chain(z, codebooks, forced):
    """The residual chain of (N, D) float64 rows; ``forced`` maps (row,
    layer) to a code. Returns (summed codes, near ties [(gap, row, layer,
    runner-up)])."""
    r, out, ties = z.clone(), torch.zeros_like(z), []
    for q, cb in enumerate(codebooks):
        r2 = (r * r).sum(-1)
        dist = r2[:, None] - 2.0 * (r @ cb.t()) + (cb * cb).sum(-1)[None]
        top = dist.topk(2, dim=-1, largest=False)
        idx = top.indices[:, 0].clone()
        gap = top.values[:, 1] - top.values[:, 0]
        for n in torch.nonzero(gap <= TIE * r2).flatten().tolist():
            if (n, q) not in forced:
                ties.append((gap[n].item(), n, q, top.indices[n, 1].item()))
        for (n, fq), code in forced.items():
            if fq == q:
                idx[n] = code
        code = cb[idx]
        r, out = r - code, out + code
    return out, ties


def snap_variants(z: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(T, D) latent rows of one part -> (V, T, D) snapped rows, float32:
    the float64 nearest-code chain and, for up to MAX_TIES near ties on
    distinct rows, every choice between the two nearest codes."""
    z64, cb64 = z.double(), codebooks.double()
    base, ties = _chain(z64, cb64, {})
    chosen, rows = [], set()
    for gap, n, q, alt in sorted(ties):
        if n not in rows and len(chosen) < MAX_TIES:
            chosen.append((n, q, alt))
            rows.add(n)
    out = [base]
    for k in range(1, len(chosen) + 1):
        for subset in itertools.combinations(chosen, k):
            out.append(_chain(z64, cb64, {(n, q): alt for n, q, alt in subset})[0])
    return torch.stack(out).float()


def decoder(W, prefix: str, rcfg: dict, z: torch.Tensor, rnd=exact) -> torch.Tensor:
    """RVQ-VAE decoder: (V, T, 512) -> (V, 4T, input_dim). A k=3 stem, per
    level a residual stack (dilations 9, 3, 1: relu, dilated k=3 conv, relu,
    k=1 conv, plus the input) then nearest x2 upsampling and a k=3 conv, then
    a k=3 conv, relu and the k=3 head."""

    def conv(name, h, dilation=1, pad=1):
        return F.conv1d(rnd(h), rnd(W[f"{prefix}{name}.weight"]), W[f"{prefix}{name}.bias"],
                        padding=pad, dilation=dilation)

    dil = [rcfg["dilation_growth_rate"] ** d for d in range(rcfg["depth"])][::-1]
    h = F.relu(conv("stem", z.transpose(1, 2)))
    for lvl in range(rcfg["down_t"]):
        for j, d in enumerate(dil):
            blk = f"res.{lvl}.blocks.{j}."
            h = h + conv(blk + "conv_proj", F.relu(conv(blk + "conv_dilated", F.relu(h), d, d)), pad=0)
        h = conv(f"up.{lvl}", h.repeat_interleave(rcfg["stride_t"], dim=-1))
    return conv("head", F.relu(conv("mid", h))).transpose(1, 2)


def rot6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3): Gram-Schmidt on the two encoded rows."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-8)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(1e-8)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-2)


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors -> (..., 3, 3), Rodrigues in float64."""
    aa = aa.double()
    theta = torch.linalg.norm(aa, dim=-1, keepdim=True)
    k = aa / theta.clamp_min(1e-12)
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], -1).reshape(aa.shape[:-1] + (3, 3))
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + s * K + (1 - c) * (K @ K)


def part_motion(part: str, x: torch.Tensor, stats: dict):
    """A part's normalized features (V, T, dim) -> rotation matrices (V, T,
    J, 3, 3) of its joints, float64, and on the lower part the translation
    (V, T, 3): its last 3 channels are the root velocity, integrated over
    time but for the height, which is taken as it is; else None."""
    dev = x.device

    def stat(name, idx=None):
        a = np.asarray(stats[name], np.float64)
        return torch.as_tensor(a if idx is None else a[idx], device=dev)

    x = x.double()
    trans = None
    if part == "lower":
        vel = x[..., -3:] * stat("trans_std") + stat("trans_mean")
        trans = torch.cumsum(vel, dim=-2)
        trans[..., 1] = vel[..., 1]
        x = x[..., :-3]
    idx = part_index(part)
    rot6d = x * stat("std_full", idx) + stat("mean_full", idx)
    return rot6d_to_matrix(rot6d.reshape(x.shape[:2] + (len(PART_JOINTS[part]), 6))), trans
