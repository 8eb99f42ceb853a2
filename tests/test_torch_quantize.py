"""The port's decode path against the JAX package on the CPU: the RVQ eval
half, K3's plain version (against ``rvq_quantize_eval`` and the Pallas
kernel in interpret mode), the RVQ-VAE decoder through the weight bridge,
the rotations and ``decode_latents`` on the same latents. Inputs come from
numpy seeds. The K3 kernel on the card: tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu import generation as JG
from syntalker_tpu.data.stats import PoseStats as JaxPoseStats
from syntalker_tpu.models.rvqvae import RVQVAEConfig as JaxRVQVAEConfig
from syntalker_tpu.models.rvqvae import create_rvqvae
from syntalker_tpu.ops import quantize as JQ
from syntalker_tpu.ops import rotations as JR
from syntalker_tpu.ops.quantize_pallas import rvq_encode_fused as pallas_rvq_encode
from syntalker_tpu_torch import bridge, generation
from syntalker_tpu_torch.data.stats import PoseStats
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig
from syntalker_tpu_torch.ops import quantize, quantize_cuda
from syntalker_tpu_torch.ops import rotations as R
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

Q_CFG = quantize.RVQConfig(num_quantizers=4, nb_code=64, code_dim=128)
JQ_CFG = JQ.RVQConfig(num_quantizers=4, nb_code=64, code_dim=128)
ATOL = 1e-4  # f32 sums of 128-512 products in another order; indices must agree exactly


def jax_state(codebook: np.ndarray) -> JQ.RVQState:
    cfg = JQ.RVQConfig(num_quantizers=codebook.shape[0], nb_code=codebook.shape[1], code_dim=codebook.shape[2])
    return JQ.init_rvq_state(cfg).replace(codebook=jnp.asarray(codebook), initialized=jnp.asarray(True))


def codebooks(seed=0, q=4, k=64, d=128):
    return np.random.default_rng(seed).normal(size=(q, k, d)).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 8), (1, 13)])
def test_rvq_quantize_eval_matches_jax(shape):
    cb = codebooks()
    z = np.random.default_rng(1).normal(size=shape + (128,)).astype(np.float32)
    q_ref, idx_ref = JQ.rvq_quantize_eval(jnp.asarray(z), jax_state(cb), JQ_CFG)
    q_out, idx_out = quantize.rvq_quantize_eval(torch.as_tensor(z), quantize.RVQState(torch.as_tensor(cb)), Q_CFG)
    np.testing.assert_array_equal(idx_out.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(q_out.numpy(), np.asarray(q_ref), atol=ATOL)


def test_code_distances_and_dequantize_match_jax():
    cb = codebooks(2)
    g = np.random.default_rng(3)
    x = g.normal(size=(10, 128)).astype(np.float32)
    ref = JQ.code_distances(jnp.asarray(x), jnp.asarray(cb[0]))
    out = quantize.code_distances(torch.as_tensor(x), torch.as_tensor(cb[0]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-3)
    idx = g.integers(-1, 64, (2, 5, 4)).astype(np.int32)  # -1 = a dropped layer, contributes 0
    ref = JQ.rvq_dequantize(jnp.asarray(idx), jax_state(cb), JQ_CFG)
    out = quantize.rvq_dequantize(torch.as_tensor(idx).long(), quantize.RVQState(torch.as_tensor(cb)), Q_CFG)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("n", [13, 96])
def test_rvq_encode_plain_matches_pallas_and_eval(n):
    """K3's plain version (what the wrapper runs on CPU tensors) against the
    Pallas kernel in interpret mode and against ``rvq_quantize_eval``."""
    cb = codebooks(4)
    x = np.random.default_rng(5).normal(size=(n, 128)).astype(np.float32)
    before = quantize_cuda.launches["rvq_encode"]
    out, idx = quantize_cuda.rvq_encode_fused(torch.as_tensor(x), torch.as_tensor(cb))
    assert quantize_cuda.launches["rvq_encode"] == before  # the plain version launches nothing
    assert idx.dtype == torch.int32 and idx.shape == (n, 4)
    q_ref, idx_ref = pallas_rvq_encode(jnp.asarray(x), jnp.asarray(cb), num_quantizers=4, tile_n=32, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(out.numpy(), np.asarray(q_ref), atol=ATOL)
    q_eval, idx_eval = JQ.rvq_quantize_eval(jnp.asarray(x)[None], jax_state(cb), JQ_CFG)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_eval)[0])
    np.testing.assert_allclose(out.numpy(), np.asarray(q_eval)[0], atol=ATOL)


def test_rvq_encode_rejects_other_devices():
    x = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        quantize_cuda.rvq_encode_fused(x, torch.empty(2, 8, 128, device="meta"))


# ---------------------------------------------------------------------------
# RVQ-VAE decoder and the decode path

PARTS = (("upper", 78), ("hands", 180), ("lower", 57))
DEC_Q = JQ.RVQConfig(num_quantizers=2, nb_code=16, code_dim=512)


@pytest.fixture(scope="module")
def rvq_pairs():
    """part -> ((flax module, params, state), (port module, port state))."""
    out = {}
    for i, (name, dim) in enumerate(PARTS):
        jcfg = JaxRVQVAEConfig(input_dim=dim, width=32, depth=2, quantizer=DEC_Q)
        module, params, state = create_rvqvae(jcfg, jax.random.PRNGKey(i))
        cb = codebooks(10 + i, q=2, k=16, d=512) * 0.5
        state = state.replace(codebook=jnp.asarray(cb), initialized=jnp.asarray(True))
        tcfg = RVQVAEConfig(input_dim=dim, width=32, depth=2,
                            quantizer=quantize.RVQConfig(num_quantizers=2, nb_code=16, code_dim=512))
        out[name] = ((module, params, state), bridge.rvqvae_from_flax(tcfg, params, cb, device="cpu"))
    return out


def test_rvqvae_bridge_parameter_by_parameter(rvq_pairs):
    (_, params, state), (module, tstate) = rvq_pairs["hands"]
    p = params["decoder"]
    dec = module.decoder
    np.testing.assert_array_equal(dec.stem.weight.numpy(), np.asarray(p["stem"]["kernel"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(dec.head.bias.numpy(), np.asarray(p["head"]["bias"]))
    blk = dec.res[1].blocks[0]
    assert blk.conv_dilated.dilation == (3,)  # reversed dilations [3, 1] at depth 2
    np.testing.assert_array_equal(blk.conv_dilated.weight.numpy(),
                                  np.asarray(p["res_1"]["block_0"]["conv_dilated"]["kernel"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(tstate.codebook.numpy(), np.asarray(state.codebook))
    assert sum(t.numel() for t in module.parameters()) == sum(np.asarray(a).size for a in jax.tree.leaves(params))


def test_latent2origin_matches_jax(rvq_pairs):
    (jmod, params, state), (module, tstate) = rvq_pairs["lower"]
    z = np.random.default_rng(7).normal(size=(2, 6, 512)).astype(np.float32)
    ref = jmod.apply({"params": params}, jnp.asarray(z), state, method="latent2origin")
    with torch.no_grad():
        out = module.latent2origin(torch.as_tensor(z), tstate)
    assert out.shape == (2, 24, 57)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_rotations_match_jax():
    g = np.random.default_rng(8)
    d6 = g.normal(size=(64, 6)).astype(np.float32)
    d6[0] = [1, 0, 0, 0, 1, 0]  # identity: the small-angle series
    d6[1] = [1, 1e-8, 0, -1e-8, 1, 0]
    m_ref = JR.rotation_6d_to_matrix(jnp.asarray(d6))
    m = R.rotation_6d_to_matrix(torch.as_tensor(d6))
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), atol=1e-6)
    np.testing.assert_allclose(R.matrix_to_rotation_6d(m).numpy(),
                               np.asarray(JR.matrix_to_rotation_6d(m_ref)), atol=1e-6)
    np.testing.assert_allclose(R.matrix_to_quaternion(m).numpy(),
                               np.asarray(JR.matrix_to_quaternion(m_ref)), atol=1e-6)
    np.testing.assert_allclose(R.matrix_to_axis_angle(m).numpy(),
                               np.asarray(JR.matrix_to_axis_angle(m_ref)), atol=1e-5)
    np.testing.assert_allclose(R.matrix_to_axis_angle(m[:2]).numpy(), 0.0, atol=1e-6)


def test_decode_latents_matches_jax(rvq_pairs):
    """Both packages decode the SAME latents (the RVQ snap is discontinuous,
    so decoding two independently sampled latents would not compare)."""
    g = np.random.default_rng(9)
    mean, std = g.normal(size=330).astype(np.float32), g.uniform(0.5, 2, 330).astype(np.float32)
    tm, ts = g.normal(size=3).astype(np.float32), g.uniform(0.5, 2, 3).astype(np.float32)
    latents = g.normal(0, 0.3, size=(2, 5, 1536)).astype(np.float32)
    ref = JG.decode_latents(jnp.asarray(latents), rvq_modules={k: v[0] for k, v in rvq_pairs.items()},
                            stats=JaxPoseStats(mean, std, tm, ts))
    out = generation.decode_latents(torch.as_tensor(latents), rvq_modules={k: v[1] for k, v in rvq_pairs.items()},
                                    stats=PoseStats(mean, std, tm, ts))
    for key in ("rot6d", "trans"):
        assert out[key].shape == ref[key].shape
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["axis_angle"].numpy(), np.asarray(ref["axis_angle"]), atol=1e-3)
    assert np.all(out["axis_angle"].numpy()[..., 66:69] == 0)  # jaw left for the caller
