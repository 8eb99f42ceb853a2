"""How far the full-width RVQ decoder reaches, in the JAX package and in
the port alike.

The streaming session decodes each window's buffer alone: ``lookback`` (16)
latent frames of history before the frames it emits and ``lookahead`` (8)
after them. JAX's design note (``syntalker_tpu/streaming.py``) bounds the
decoder's influence beyond those margins. At the full ``RVQVAEConfig``
widths (width 512, depth 3, down_t 2) with seeded random weights, latents
beyond the margins still move the output, and the streamed frames lie far
from the whole clip decoded at once. These tests decode the same latents
with both frameworks on the same bridged weights, cut as the session cuts
them and whole, and hold the port's gap to JAX's frame by frame: the gap
is the design's, not the port's.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_decode_reach.py

prints the readings (gap of the streamed frames to the whole-clip decode,
and the output change from latents beyond 8, 16 and 23 frames) as one JSON
line."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu import generation as JG
from syntalker_tpu.data.stats import identity_pose_stats as jax_identity_stats
from syntalker_tpu.models.rvqvae import RVQVAEConfig as JaxRVQVAEConfig
from syntalker_tpu.models.rvqvae import create_rvqvae
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch.data.stats import identity_pose_stats
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig

PARTS = (("upper", 78), ("hands", 180), ("lower", 57))
N_LAT = 116  # a 16 s clip: 4 windows of 28 fresh latent frames after the 4 seed frames
LW, LOOKBACK, LOOKAHEAD, FRESH, SQ = 32, 16, 8, 28, 4  # the session's defaults
DISTANCES = (8, 16, 23)  # latent frames: JAX's note puts the influence beyond them at <=7e-3, <=5e-4 and 0
ABS = 1e-3  # the frameworks' f32 decodes of the same latents differ by ~1e-4 in rot6d (unit scale)


def spans(n):
    """(buffer start, buffer end, first emitted, end of emitted) in latent
    frames: the first window, each steady window, the flush."""
    out = [(0, LW, 0, LW - LOOKAHEAD)]
    out += [(s - LOOKBACK, s + FRESH + LOOKAHEAD, s, s + FRESH) for s in range(LW - LOOKAHEAD, n - LOOKAHEAD, FRESH)]
    return out + [(n - LOOKAHEAD - LOOKBACK, n, n - LOOKAHEAD, n)]


def build_decoders():
    """(JAX decode, port decode, latents): latents (1, N_LAT, 1536) ->
    {rot6d, trans} as numpy, on the same bridged full-width RVQ-VAEs."""
    g = np.random.default_rng(0)
    jrvq, trvq = {}, {}
    for i, (name, dim) in enumerate(PARTS):
        module, params, state = create_rvqvae(JaxRVQVAEConfig(input_dim=dim), jax.random.PRNGKey(i))
        cb = (g.normal(size=(6, 512, 512)) * 0.5 ** np.arange(6)[:, None, None]).astype(np.float32)
        jrvq[name] = (module, params, state.replace(codebook=jnp.asarray(cb), initialized=jnp.asarray(True)))
        trvq[name] = bridge.rvqvae_from_flax(RVQVAEConfig(input_dim=dim), params, cb, device="cpu")

    def jax_decode(lat):
        d = JG.decode_latents(jnp.asarray(lat), rvq_modules=jrvq, stats=jax_identity_stats())
        return {k: np.asarray(d[k][0]) for k in ("rot6d", "trans")}

    def port_decode(lat):
        with torch.no_grad():
            d = G.decode_latents(torch.as_tensor(lat), rvq_modules=trvq, stats=identity_pose_stats())
        return {k: d[k][0].numpy() for k in ("rot6d", "trans")}

    lat = (g.normal(size=(1, N_LAT, 1536)) / 5.0).astype(np.float32)  # x latent_scale: unit-variance latents
    return jax_decode, port_decode, lat


@pytest.fixture(scope="module")
def decoders():
    return build_decoders()


def stream_gap(decode, lat):
    """Per-frame max |streamed - whole| in rot6d, and the translation's
    largest gap relative to its scale: each buffer decoded alone, its
    emitted frames kept, the x/z velocity integrated over them as the
    session's carry does."""
    whole = decode(lat)
    r6, vel, height = [], [], []
    for b0, b1, e0, e1 in spans(lat.shape[1]):
        d = decode(lat[:, b0:b1])
        keep = slice((e0 - b0) * SQ, (e1 - b0) * SQ)
        r6.append(d["rot6d"][keep])
        vel.append(np.diff(d["trans"], axis=0, prepend=np.zeros((1, 3), np.float32))[keep])
        height.append(d["trans"][keep, 1])
    trans = np.cumsum(np.concatenate(vel), axis=0)
    trans[:, 1] = np.concatenate(height)
    r6_gap = np.abs(np.concatenate(r6) - whole["rot6d"]).max(-1)
    return r6_gap, float(np.abs(trans - whole["trans"]).max() / max(1.0, np.abs(whole["trans"]).max()))


def reach(decode, lat, centre=N_LAT // 2):
    """For each of DISTANCES: the largest rot6d change of the centre latent
    frame's 4 output frames when every latent frame more than that far from
    it is redrawn."""
    base = decode(lat)["rot6d"][centre * SQ : (centre + 1) * SQ]
    other = np.random.default_rng(1).normal(size=lat.shape).astype(np.float32) / 5.0
    far = np.abs(np.arange(lat.shape[1]) - centre)
    out = {}
    for d in DISTANCES:
        moved = np.where((far > d)[None, :, None], other, lat)
        out[d] = float(np.abs(decode(moved)["rot6d"][centre * SQ : (centre + 1) * SQ] - base).max())
    return out


def test_streamed_frames_lie_as_far_from_the_whole_clip_in_both_frameworks(decoders):
    jax_decode, port_decode, lat = decoders
    j_r6, j_tr = stream_gap(jax_decode, lat)
    p_r6, p_tr = stream_gap(port_decode, lat)
    assert np.abs(p_r6 - j_r6).max() <= ABS, np.abs(p_r6 - j_r6).max()
    assert abs(p_tr - j_tr) <= ABS, (p_tr, j_tr)


def test_decoder_reach_is_the_same_in_both_frameworks(decoders):
    jax_decode, port_decode, lat = decoders
    j, p = reach(jax_decode, lat), reach(port_decode, lat)
    for d in DISTANCES:
        assert abs(p[d] - j[d]) <= ABS, (d, p[d], j[d])


if __name__ == "__main__":
    jax_decode, port_decode, lat = build_decoders()
    readings = {}
    for name, decode in (("jax", jax_decode), ("port", port_decode)):
        r6, tr = stream_gap(decode, lat)
        readings[name] = {"stream_vs_whole_rot6d_max": float(r6.max()),
                          "frames_over_5e-2": int((r6 > 5e-2).sum()), "frames": len(r6),
                          "stream_vs_whole_trans_rel": tr,
                          "rot6d_change_from_latents_beyond": reach(decode, lat)}
    print(json.dumps(readings))
