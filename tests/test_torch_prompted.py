"""The port's prompt and style conditioning against the flax MDM, f32 on the
CPU: the bridge parameter by parameter, ``encode_cond`` under every mask,
``denoise`` with its prompt and style concats, and K2's denoise in both of
its modes (plain version, f32 weights), for each WavEncoder norm.

The flax initial values would prove little (BatchNorm statistics 0 and 1,
scales 1, the null prompt zeros), so every one of them is perturbed with
seeded random values before the weights are copied."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu.models.denoiser import Conditioning as JaxConditioning
from syntalker_tpu.models.denoiser import create_mdm, mdm_variables
from syntalker_tpu.ops.mdm_pallas import make_fused_denoise as jax_fused_denoise
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch.models.denoiser import BatchNorm, Conditioning
from syntalker_tpu_torch.ops import mdm_cuda

from test_torch_denoiser import JAX_CFG as BASE_CFG
from test_torch_denoiser import rel_err, torch_cfg
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

REL = 1e-5  # f32 against f32: only summation order differs
NORMS = ("group", "batch", "none")
P, S = 8, 8  # prompt and style widths


def jax_cfg(norm):
    return dataclasses.replace(BASE_CFG, use_prompt=True, prompt_dim=P, use_motionclip=True, style_dim=S,
                               audio_norm=norm)


def perturb(variables, seed):
    """Seeded random values in place of the untouched initial ones: the null
    prompt, every wav-encoder norm's scale and bias, BatchNorm's statistics."""
    g = np.random.default_rng(seed)
    v = mdm_variables(variables)
    params = jax.tree.map(np.asarray, v["params"])
    params["uncond_prompt_embedding"] = g.normal(size=(1, P)).astype(np.float32)
    for block in params["wav_encoder"].values():
        for name, leaf in block.items():
            if "norm" in name:
                leaf["scale"] = g.uniform(0.5, 1.5, leaf["scale"].shape).astype(np.float32)
                leaf["bias"] = g.normal(0, 0.1, leaf["bias"].shape).astype(np.float32)
    out = {"params": params}
    if "batch_stats" in v:
        out["batch_stats"] = jax.tree.map(np.asarray, v["batch_stats"])
        for block in out["batch_stats"]["wav_encoder"].values():
            for stats in block.values():
                stats["mean"] = g.normal(0, 0.2, stats["mean"].shape).astype(np.float32)
                stats["var"] = g.uniform(0.5, 2.0, stats["var"].shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, out)


@pytest.fixture(scope="module", params=NORMS)
def models(request):
    cfg = jax_cfg(request.param)
    mdm, variables = create_mdm(cfg, jax.random.PRNGKey(0), frames=32)
    variables = perturb(variables, seed=NORMS.index(request.param))
    assert ("batch_stats" in variables) == (request.param == "batch")
    return mdm, variables, bridge.mdm_from_flax(torch_cfg(cfg), variables, device="cpu")


@pytest.fixture(scope="module")
def inputs():
    g = np.random.default_rng(0)
    b = 3
    return {
        "audio": g.normal(0, 0.1, (b, 533 * 32, 2)).astype(np.float32),
        "word": g.integers(0, BASE_CFG.vocab_size, (b, 32)),
        "seed": g.normal(size=(b, 4, BASE_CFG.latent_total_dim)).astype(np.float32),
        "x_t": g.normal(size=(b, 8, BASE_CFG.latent_total_dim)).astype(np.float32),
        "t": np.array([5, 99, 731]),
        "prompt": g.normal(size=(b, P)).astype(np.float32),
        "style": g.normal(size=(b, S)).astype(np.float32),
    }


def test_bridge_parameter_by_parameter(models):
    _, variables, tmdm = models
    p = variables["params"]
    np.testing.assert_array_equal(tmdm.uncond_prompt_embedding.numpy(), p["uncond_prompt_embedding"])
    for name in ("input_process3", "input_process_style"):
        np.testing.assert_array_equal(getattr(tmdm, name).weight.numpy(), p[name]["kernel"].T)
        np.testing.assert_array_equal(getattr(tmdm, name).bias.numpy(), p[name]["bias"])
    stats = variables.get("batch_stats", {}).get("wav_encoder", {})
    for i, blk in enumerate(tmdm.wav_encoder.blocks):
        for name in ("norm1", "norm2", "down_norm"):
            norm = getattr(blk, name, None)
            if norm is None or isinstance(norm, torch.nn.Identity):
                assert name not in p["wav_encoder"][f"block_{i}"]
                continue
            bp = p["wav_encoder"][f"block_{i}"][name]
            np.testing.assert_array_equal(norm.weight.numpy(), bp["scale"])
            np.testing.assert_array_equal(norm.bias.numpy(), bp["bias"])
            if isinstance(norm, BatchNorm):
                np.testing.assert_array_equal(norm.running_mean.numpy(), stats[f"block_{i}"][name]["mean"])
                np.testing.assert_array_equal(norm.running_var.numpy(), stats[f"block_{i}"][name]["var"])
    assert sum(t.numel() for t in tmdm.parameters()) == sum(a.size for a in jax.tree.leaves(p))
    n_stats = sum(a.size for a in jax.tree.leaves(variables.get("batch_stats", {})))
    assert sum(b.numel() for n, b in tmdm.named_buffers() if n.endswith(("running_mean", "running_var"))) == n_stats


# name -> (prompt and style given, uncond_audio, uncond_prompt, uncond_style): every combination of the
# three masks, the null inputs, and masks that differ by row
MASKS = {
    "conditioned" if not any(m) else "uncond-" + "+".join(n for n, on in zip(("audio", "prompt", "style"), m) if on):
        (True, *m)
    for m in itertools.product((False, True), repeat=3)
}
MASKS["null-inputs"] = (False, False, False, False)
MASKS["per-row"] = (True, np.array([True, False, True]), np.array([False, True, True]), np.array([True, True, False]))


def _encode_jax(mdm, variables, inputs, given, ua, up, us):
    return mdm.apply(variables, jnp.asarray(inputs["audio"]), jnp.asarray(inputs["word"]), jnp.asarray(inputs["seed"]),
                     prompt=jnp.asarray(inputs["prompt"]) if given else None,
                     style=jnp.asarray(inputs["style"]) if given else None,
                     uncond_audio=ua, uncond_prompt=up, uncond_style=us, method="encode_cond")


def _encode_torch(tmdm, inputs, given, ua, up, us):
    def m(flag):
        return torch.as_tensor(flag) if isinstance(flag, np.ndarray) else flag

    with torch.no_grad():
        return tmdm.encode_cond(torch.as_tensor(inputs["audio"]), torch.as_tensor(inputs["word"]),
                                torch.as_tensor(inputs["seed"]),
                                prompt=torch.as_tensor(inputs["prompt"]) if given else None,
                                style=torch.as_tensor(inputs["style"]) if given else None,
                                uncond_audio=m(ua), uncond_prompt=m(up), uncond_style=m(us))


@pytest.mark.parametrize("mask", list(MASKS))
def test_encode_cond_under_masks(models, inputs, mask):
    mdm, variables, tmdm = models
    ref = _encode_jax(mdm, variables, inputs, *MASKS[mask])
    out = _encode_torch(tmdm, inputs, *MASKS[mask])
    for name in ("at_feat", "seed_emb", "prompt_feat", "style_feat"):
        want, got = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        assert got.shape == want.shape, name
        assert rel_err(got, want) < REL, name


def _torch_cond(ref):
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(Conditioning)}
    return Conditioning(**{k: None if v is None else torch.tensor(np.array(v)) for k, v in fields.items()})


@pytest.mark.parametrize("mask", ["conditioned", "uncond-audio+prompt+style", "per-row"])
def test_denoise_with_prompt_and_style(models, inputs, mask):
    mdm, variables, tmdm = models
    cond = _encode_jax(mdm, variables, inputs, *MASKS[mask])
    ref = mdm.apply(variables, jnp.asarray(inputs["x_t"]), jnp.asarray(inputs["t"]), cond, method="denoise")
    with torch.no_grad():
        out = tmdm.denoise(torch.as_tensor(inputs["x_t"]), torch.as_tensor(inputs["t"]), _torch_cond(cond))
    assert rel_err(out, ref) < REL


@pytest.mark.parametrize("prompted", [True, False], ids=["prompted", "fused-semantics"])
def test_block_stack_denoise_modes(models, inputs, prompted):
    """K2's denoise (plain version, f32 weights): on a conditioning with
    prompt and style, the whole flax denoise; on one without them, as the
    unprompted samplers pass it, JAX's fused denoise, which reads neither
    even on this model."""
    mdm, variables, tmdm = models
    cond = _encode_jax(mdm, variables, inputs, *MASKS["conditioned"])
    x_t, t = jnp.asarray(inputs["x_t"]), jnp.asarray(inputs["t"])
    if prompted:
        ref = mdm.apply(variables, x_t, t, cond, method="denoise")
    else:
        t_emb = mdm.apply(variables, t, method="embed_timesteps")
        ref = jax_fused_denoise(BASE_CFG, variables, tile_samples=1, interpret=True)(x_t, t_emb, cond)
        # the fused denoise is the plain denoise of a conditioning without prompt and style
        cond = JaxConditioning(at_feat=cond.at_feat, seed_emb=cond.seed_emb)
        assert rel_err(ref, mdm.apply(variables, x_t, t, cond, method="denoise")) < 2e-2  # its bf16 block stack
        ref = mdm.apply(variables, x_t, t, cond, method="denoise")
    denoise = mdm_cuda.make_fused_denoise(tmdm, mdm_cuda.stack_block_weights(tmdm, torch.float32))
    with torch.no_grad():
        out = denoise(torch.as_tensor(inputs["x_t"]), tmdm.embed_timesteps(torch.as_tensor(inputs["t"])),
                      _torch_cond(cond))
    assert rel_err(out, ref) < REL
