"""The encode half of the port's RVQ-VAE against JAX at the full
``RVQVAEConfig`` widths (width 512, depth 3, down_t 2, 6 x 512 x 512
codebooks) on the CPU: the bridge's encoder half parameter by parameter,
``map2latent``, ``encode`` (K3's plain version) whose indices equal JAX's on
every row without a near tie, ``decode_indices`` on JAX's indices, and
``decode_indices(encode(x))`` against ``latent2origin(map2latent(x))``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu.models.rvqvae import RVQVAEConfig as JaxRVQVAEConfig
from syntalker_tpu.models.rvqvae import create_rvqvae
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig
from syntalker_tpu_torch.ops.quantize import code_distances

PARTS = (("upper", 78), ("hands", 180), ("lower", 57))
REL = 1e-5  # f32 against f32: only summation order differs
TIE = 1e-5  # a top-2 gap under TIE * |r|^2 at some layer is a near tie


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module", params=PARTS, ids=[p for p, _ in PARTS])
def pair(request):
    """(flax module, params, state, port module, port state, poses) for one
    part. The codebooks are seeded at the scale of the part's latents and
    halve from layer to layer, as trained residual codebooks do."""
    name, dim = request.param
    seed = [p for p, _ in PARTS].index(name)
    module, params, state = create_rvqvae(JaxRVQVAEConfig(input_dim=dim), jax.random.PRNGKey(seed))
    g = np.random.default_rng(seed)
    x = g.normal(size=(2, 64, dim)).astype(np.float32)
    z = np.asarray(module.apply({"params": params}, jnp.asarray(x), method="map2latent"))
    scale = z.std() * 0.5 ** np.arange(6)[:, None, None]
    cb = (g.normal(size=(6, 512, 512)) * scale).astype(np.float32)
    state = state.replace(codebook=jnp.asarray(cb), initialized=jnp.asarray(True))
    tmod, tstate = bridge.rvqvae_from_flax(RVQVAEConfig(input_dim=dim), params, cb, device="cpu")
    return module, params, state, tmod, tstate, x


def near_tie_rows(z: torch.Tensor, codebooks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows whose top-2 distances along the residual chain of ``idx`` come
    within TIE * |r|^2 of each other at some layer."""
    r = z.reshape(-1, z.shape[-1]).clone()
    idx = idx.reshape(r.shape[0], -1).long()
    tie = torch.zeros(r.shape[0], dtype=torch.bool)
    for q, cb in enumerate(codebooks):
        top2 = code_distances(r, cb).topk(2, dim=-1, largest=False).values
        tie |= (top2[:, 1] - top2[:, 0]) <= TIE * (r * r).sum(-1)
        r = r - cb[idx[:, q]]
    return tie


def test_bridge_copies_the_encoder(pair):
    _, params, _, tmod, _, _ = pair
    p = params["encoder"]
    enc = tmod.encoder
    np.testing.assert_array_equal(enc.stem.weight.numpy(), np.asarray(p["stem"]["kernel"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(enc.head.bias.numpy(), np.asarray(p["head"]["bias"]))
    assert enc.down[1].stride == (2,) and enc.down[1].kernel_size == (4,) and enc.down[1].padding == (1,)
    np.testing.assert_array_equal(enc.down[1].weight.numpy(), np.asarray(p["down_1"]["kernel"]).transpose(2, 1, 0))
    blk = enc.res[0].blocks[0]
    assert blk.conv_dilated.dilation == (9,)  # reversed dilations [9, 3, 1], as in the reference encoder
    np.testing.assert_array_equal(blk.conv_proj.weight.numpy(),
                                  np.asarray(p["res_0"]["block_0"]["conv_proj"]["kernel"]).transpose(2, 1, 0))
    assert sum(t.numel() for t in enc.parameters()) == sum(np.asarray(a).size for a in jax.tree.leaves(p))


def test_map2latent_matches_jax(pair):
    module, params, _, tmod, _, x = pair
    ref = module.apply({"params": params}, jnp.asarray(x), method="map2latent")
    with torch.no_grad():
        out = tmod.map2latent(torch.as_tensor(x))
    assert out.shape == (2, 16, 512)
    assert rel_err(out.numpy(), ref) < REL


def test_encode_indices_match_jax_off_near_ties(pair):
    module, params, state, tmod, tstate, x = pair
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x), state, method="encode"))
    with torch.no_grad():
        idx = tmod.encode(torch.as_tensor(x), tstate)
        tie = near_tie_rows(tmod.map2latent(torch.as_tensor(x)), tstate.codebook, idx)
    assert idx.shape == ref.shape == (2, 16, 6) and idx.dtype == torch.int32
    agree = (idx.reshape(-1, 6).numpy() == ref.reshape(-1, 6)).all(-1)
    assert agree[~tie.numpy()].all()
    assert len(np.unique(ref[..., 0])) > 1 and len(np.unique(ref[..., 5])) > 1  # the layers do choose


def test_decode_indices_matches_jax(pair):
    module, params, state, tmod, tstate, x = pair
    idx = module.apply({"params": params}, jnp.asarray(x), state, method="encode")
    ref = module.apply({"params": params}, idx, state, method="decode_indices")
    with torch.no_grad():
        out = tmod.decode_indices(torch.as_tensor(np.array(idx)), tstate)
    assert out.shape == x.shape
    assert rel_err(out.numpy(), ref) < REL


def test_decode_of_encode_is_latent2origin(pair):
    """The two halves meet: decoding the encoded indices is the snap and
    decode of the continuous latent."""
    _, _, _, tmod, tstate, x = pair
    with torch.no_grad():
        xt = torch.as_tensor(x)
        a = tmod.decode_indices(tmod.encode(xt, tstate), tstate)
        b = tmod.latent2origin(tmod.map2latent(xt), tstate)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
