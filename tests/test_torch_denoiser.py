"""The port's MDM and weight bridge against the flax MDM, in f32 on the CPU.

Same tiny configuration as tests/test_mdm_pallas.py; inputs from a numpy
seed go through both packages; the bridge copies the flax weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu.models.denoiser import MDMConfig as JaxMDMConfig
from syntalker_tpu.models.denoiser import create_mdm
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.models.denoiser import Conditioning, MDMConfig
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

JAX_CFG = JaxMDMConfig(
    latent_total_dim=48, latent_dim=256, ff_size=512, num_layers=3, num_heads=4,
    rope_heads=4, audio_feat_dim=16, word_feat_dim=16, word_embed_dim=8,
    vocab_size=32, dropout=0.0,
)
REL = 1e-5  # f32 against f32: only summation order differs


def torch_cfg(cfg) -> MDMConfig:
    return MDMConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(MDMConfig)})


def rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12)


@pytest.fixture(scope="module")
def models():
    mdm, params = create_mdm(JAX_CFG, jax.random.PRNGKey(0), frames=32)
    tmdm = bridge.mdm_from_flax(torch_cfg(JAX_CFG), params, device="cpu")
    return mdm, params, tmdm


@pytest.fixture(scope="module")
def inputs():
    g = np.random.default_rng(0)
    b = 3
    return {
        "audio": g.normal(0, 0.1, (b, 533 * 32, 2)).astype(np.float32),
        "word": g.integers(0, JAX_CFG.vocab_size, (b, 32)),
        "seed": g.normal(size=(b, 4, JAX_CFG.latent_total_dim)).astype(np.float32),
        "x_t": g.normal(size=(b, 8, JAX_CFG.latent_total_dim)).astype(np.float32),
        "t": np.array([5, 99, 731]),
        "xseq": g.normal(size=(b, 8, JAX_CFG.latent_dim)).astype(np.float32),
    }


def test_bridge_parameter_by_parameter(models):
    _, params, tmdm = models
    p = params
    np.testing.assert_array_equal(tmdm.word_embedding.numpy(), np.asarray(p["word_embedding"]))
    np.testing.assert_array_equal(tmdm.input_process.weight.numpy(), np.asarray(p["input_process"]["kernel"]).T)
    np.testing.assert_array_equal(tmdm.time_mlp.fc2.bias.numpy(), np.asarray(p["time_mlp"]["fc2"]["bias"]))
    for i, blk in enumerate(tmdm.wav_encoder.blocks):
        bp = p["wav_encoder"][f"block_{i}"]
        np.testing.assert_array_equal(blk.conv1.weight.numpy(), np.asarray(bp["conv1"]["kernel"]).transpose(2, 1, 0))
        np.testing.assert_array_equal(blk.norm2.weight.numpy(), np.asarray(bp["norm2"]["scale"]))
        if blk.down_conv is not None:
            np.testing.assert_array_equal(blk.down_conv.bias.numpy(), np.asarray(bp["down_conv"]["bias"]))
    stacked = p["blocks"]["block"]
    for i, blk in enumerate(tmdm.blocks):
        qkv = np.asarray(stacked["qkv"]["kernel"])[i]  # (C, 3, H, hd)
        np.testing.assert_array_equal(blk.qkv.weight.numpy(), qkv.reshape(qkv.shape[0], -1).T)
        np.testing.assert_array_equal(blk.fc1.weight.numpy(), np.asarray(stacked["fc1"]["kernel"])[i].T)
        np.testing.assert_array_equal(blk.norm1.bias.numpy(), np.asarray(stacked["norm1"]["bias"])[i])
    n_torch = sum(t.numel() for t in tmdm.parameters())
    n_flax = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert n_torch == n_flax


def _jax_cond(mdm, params, inputs):
    return mdm.apply({"params": params}, jnp.asarray(inputs["audio"]), jnp.asarray(inputs["word"]),
                     jnp.asarray(inputs["seed"]), method="encode_cond")


def test_encode_cond(models, inputs):
    mdm, params, tmdm = models
    ref = _jax_cond(mdm, params, inputs)
    with torch.no_grad():
        out = tmdm.encode_cond(torch.as_tensor(inputs["audio"]), torch.as_tensor(inputs["word"]),
                               torch.as_tensor(inputs["seed"]))
    assert out.at_feat.shape == ref.at_feat.shape
    assert rel_err(out.at_feat, ref.at_feat) < REL
    assert rel_err(out.seed_emb, ref.seed_emb) < REL


def test_embed_timesteps(models, inputs):
    mdm, params, tmdm = models
    ref = mdm.apply({"params": params}, jnp.asarray(inputs["t"]), method="embed_timesteps")
    with torch.no_grad():
        out = tmdm.embed_timesteps(torch.as_tensor(inputs["t"]))
    assert rel_err(out, ref) < REL


def test_denoise(models, inputs):
    mdm, params, tmdm = models
    cond = _jax_cond(mdm, params, inputs)
    ref = mdm.apply({"params": params}, jnp.asarray(inputs["x_t"]), jnp.asarray(inputs["t"]), cond, method="denoise")
    tcond = Conditioning(torch.tensor(np.array(cond.at_feat)), torch.tensor(np.array(cond.seed_emb)))
    with torch.no_grad():
        out = tmdm.denoise(torch.as_tensor(inputs["x_t"]), torch.as_tensor(inputs["t"]), tcond)
    assert rel_err(out, ref) < REL


def test_run_blocks(models, inputs):
    mdm, params, tmdm = models
    ref = mdm.apply({"params": params}, jnp.asarray(inputs["xseq"]), method="run_blocks")
    with torch.no_grad():
        out = tmdm.run_blocks(torch.as_tensor(inputs["xseq"]))
    assert rel_err(out, ref) < REL
