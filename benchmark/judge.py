"""The comparisons that decide ``correct``: what the timed path produced,
held against the plain reference (``benchmark/reference``).

A served clip is judged in two stages, because the residual-VQ snap turns
any change of a latent beyond a near tie into other codes and so other
motion:

- sampling: the program's latents (read at the decode's input) against
  the reference's from the same inputs and noise, ``latent_rel`` (the
  largest error over the largest reference value);
- decoding: the reference's snap, decoder, denormalization and rotations
  applied to the program's latents, against the motion the program
  returned: ``pose_err``, the largest error of a rotation-matrix entry of
  the modeled joints (the program's axis-angle turned into matrices), and
  ``trans_rel``, the largest translation error over the largest reference
  translation. Near ties of the snap are enumerated
  (:func:`benchmark.reference.decode.snap_variants`) and each part takes
  the variant nearest the program.
"""

from __future__ import annotations

import torch

from benchmark.reference import decode as D
from benchmark.reference.sampler import SLICES

XZ = torch.tensor([1.0, 0.0, 1.0], dtype=torch.float64)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-12)).item()


def returned(aa, trans, rot6d=None, device=None) -> dict:
    """What the program returned for some frames: axis-angle (F, 165) turned
    into each part's rotation matrices, the translation (F, 3), and where
    given the rot6d (F, 330) of each part's joints."""
    m = D.axis_angle_to_matrix(torch.as_tensor(aa, device=device).reshape(-1, 55, 3))
    r6 = None if rot6d is None else torch.as_tensor(rot6d, device=device).double().reshape(-1, 55, 6)
    return {"mats": {p: m[:, list(j)] for p, j in D.PART_JOINTS.items()},
            "rot6d": None if r6 is None else {p: r6[:, list(j)] for p, j in D.PART_JOINTS.items()},
            "trans": torch.as_tensor(trans, device=device).double()}


def decode_errors(ref, latents, frames, got: dict, *, carry=None):
    """Decode-stage errors of one clip or stream window.

    ``latents`` (T, 1536) the program's decode input; ``frames`` the (start,
    end) of the decoded frames the program returned, ``got`` what it
    returned for them (:func:`returned`). A stream rebases the translation
    on ``carry`` (3,), the last translation it emitted before (x and z are
    carried, y is not). Returns {"pose_err", "trans_rel", "variants"}."""
    s, e = frames
    dev = latents.device
    out = {"pose_err": 0.0, "trans_rel": 0.0, "variants": 0}
    z = latents.float() * ref.cfg["latent_scale"]
    for part, (lo, hi) in SLICES.items():
        zq = D.snap_variants(z[:, lo:hi], ref.codebooks[part])
        mats, tr = D.part_motion(part, ref.decode_part(part, zq), ref.stats)
        errs = (mats[:, s:e] - got["mats"][part][None]).abs().amax(dim=(1, 2, 3, 4))
        if got["rot6d"] is not None:
            mats6 = mats[:, s:e, :, :2].reshape(mats.shape[:1] + (e - s, mats.shape[2], 6))
            errs = torch.maximum(errs, (mats6 - got["rot6d"][part][None]).abs().amax(dim=(1, 2, 3)))
        terr = torch.zeros_like(errs)
        if tr is not None:
            base = tr[:, s - 1] if s > 0 else torch.zeros_like(tr[:, 0])
            c = torch.zeros(3, dtype=torch.float64, device=dev) if carry is None else torch.as_tensor(
                carry, dtype=torch.float64, device=dev)
            want = tr[:, s:e] + ((c - base) * XZ.to(dev))[:, None, :]
            terr = (want - got["trans"][None]).abs().amax(dim=(1, 2)) / want.abs().amax(dim=(1, 2)).clamp_min(1e-3)
        best = int(torch.argmin(torch.maximum(errs, terr)))
        out["pose_err"] = max(out["pose_err"], errs[best].item())
        out["trans_rel"] = max(out["trans_rel"], terr[best].item())
        out["variants"] += len(zq)
    return out


def fold(rows: list) -> dict:
    """The largest of each number over the judged items."""
    keys = {k for r in rows for k in r}
    return {k: max(r[k] for r in rows if k in r) for k in keys}


def checks(rows: list, limits: dict) -> list:
    """(name, largest value over the judged items, limit) of each limited
    number, in the order of ``limits``; a number no item gave reads 0."""
    worst = fold(rows)
    return [(n, float(worst.get(n, 0.0)), float(limits[n])) for n in limits]
