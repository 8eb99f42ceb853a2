"""K1 (whole-window DDIM loop) and K2 (block stack): the plain versions
against the flax blocks and the Pallas kernels (interpret mode) on the CPU.
The CUDA kernels against the plain versions: tests/test_torch_kernels_cuda.py."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu.diffusion.schedule import make_diffusion as jax_make_diffusion
from syntalker_tpu.models.denoiser import Conditioning as JaxConditioning
from syntalker_tpu.models.denoiser import TransformerBlock, create_mdm
from syntalker_tpu.ops.mdm_pallas import fused_block_stack, make_fused_ddim_window, stack_block_weights as jax_stack
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import Conditioning
from syntalker_tpu_torch.ops import mdm_cuda

from test_torch_denoiser import JAX_CFG, rel_err, torch_cfg
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

# bf16 weights and matmul inputs on both sides; the Pallas kernels use a
# tanh GELU and a bf16 RoPE permutation matmul where the port is exact
BF16_REL = 2e-2


@pytest.fixture(scope="module")
def models():
    mdm, params = create_mdm(JAX_CFG, jax.random.PRNGKey(0), frames=32)
    return mdm, params, bridge.mdm_from_flax(torch_cfg(JAX_CFG), params, device="cpu")


def flax_blocks(block_params, x, cfg=JAX_CFG):
    blk = TransformerBlock(cfg.latent_dim, cfg.num_heads, cfg.ff_size, 0.0)
    for i in range(cfg.num_layers):
        x = blk.apply({"params": jax.tree.map(lambda p: p[i], block_params)}, x)
    return x


def test_block_stack_plain_f32_matches_flax(models):
    _, params, tmdm = models
    x = np.random.default_rng(1).normal(size=(2, 32, JAX_CFG.latent_dim)).astype(np.float32)
    ref = flax_blocks(params["blocks"]["block"], jnp.asarray(x))
    w = mdm_cuda.stack_block_weights(tmdm, torch.float32)
    out = mdm_cuda.block_stack(torch.as_tensor(x), w, num_heads=JAX_CFG.num_heads)
    assert rel_err(out, ref) < 1e-5


def test_block_stack_plain_bf16_matches_pallas(models):
    _, params, tmdm = models
    x = np.random.default_rng(2).normal(size=(2, 32, JAX_CFG.latent_dim)).astype(np.float32)
    ref = fused_block_stack(jnp.asarray(x), jax_stack(params["blocks"]["block"]),
                            num_heads=JAX_CFG.num_heads, interpret=True)
    out = mdm_cuda.block_stack(torch.as_tensor(x), mdm_cuda.stack_block_weights(tmdm),
                               num_heads=JAX_CFG.num_heads)
    assert rel_err(out, ref) < BF16_REL


def test_fused_denoise_f32_matches_mdm_denoise(models):
    mdm, params, tmdm = models
    g = np.random.default_rng(3)
    b = 2
    at = g.normal(size=(b, 8, JAX_CFG.audio_feat_dim)).astype(np.float32)
    seed_emb = g.normal(size=(b, JAX_CFG.latent_dim)).astype(np.float32)
    x_t = g.normal(size=(b, 8, JAX_CFG.latent_total_dim)).astype(np.float32)
    t = np.array([7, 400])
    cond = JaxConditioning(at_feat=jnp.asarray(at), seed_emb=jnp.asarray(seed_emb))
    ref = mdm.apply({"params": params}, jnp.asarray(x_t), jnp.asarray(t), cond, method="denoise")
    denoise = mdm_cuda.make_fused_denoise(tmdm, mdm_cuda.stack_block_weights(tmdm, torch.float32))
    with torch.no_grad():
        out = denoise(torch.as_tensor(x_t), tmdm.embed_timesteps(torch.as_tensor(t)),
                      Conditioning(torch.as_tensor(at), torch.as_tensor(seed_emb)))
    assert rel_err(out, ref) < 1e-5


def _window_inputs(b, t=32, seed=4):
    g = np.random.default_rng(seed)
    return (
        g.normal(size=(b, t, JAX_CFG.latent_total_dim)).astype(np.float32),
        g.normal(size=(b, JAX_CFG.latent_dim)).astype(np.float32),
        g.normal(size=(b, t, JAX_CFG.audio_feat_dim)).astype(np.float32),
    )


def test_ddim_window_plain_matches_pallas(models):
    _, params, tmdm = models
    x_init, seed_emb, at = _window_inputs(2)
    jdiff = jax_make_diffusion(steps=100, timestep_respacing="ddim4")
    run = make_fused_ddim_window(JAX_CFG, params, jdiff, interpret=True)

    # the two fields of the Conditioning that the Pallas window reads
    ref = run(jnp.asarray(x_init), SimpleNamespace(seed_emb=jnp.asarray(seed_emb), at_feat=jnp.asarray(at)))
    fused = mdm_cuda.FusedDDIMWindow(tmdm, make_diffusion(steps=100, timestep_respacing="ddim4"))
    out = fused(torch.as_tensor(x_init), Conditioning(torch.as_tensor(at), torch.as_tensor(seed_emb)))
    assert out.shape == ref.shape
    assert rel_err(out, ref) < BF16_REL
