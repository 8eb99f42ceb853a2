"""The port's config loader against JAX's, and the config fields that change
numerics: every ``configs/*.yaml`` with and without dotted overrides, field
for field; the override parser; the errors; the model dataclasses' fields
and defaults; ``dtype`` / ``audio_dtype`` in bf16 against flax's bf16, and
the unrolled ``scan_blocks=False`` param tree; ``shared_codebook``."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu import config as JC
from syntalker_tpu.models.denoiser import MDMConfig as JaxMDMConfig
from syntalker_tpu.models.denoiser import create_mdm
from syntalker_tpu.models.rvqvae import RVQVAEConfig as JaxRVQVAEConfig
from syntalker_tpu.ops import quantize as JQ
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch import config as PC
from syntalker_tpu_torch.models.denoiser import Conditioning, MDMConfig
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig
from syntalker_tpu_torch.ops import quantize as PQ
from syntalker_tpu_torch.ops.quantize_cuda import rvq_quantize_eval_fused
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

CONFIGS = sorted(str(p) for p in Path(__file__).resolve().parent.parent.glob("configs/*.yaml"))
OVERRIDES = {
    "none": [],
    "serving": ["diffusion.timestep_respacing=ddim50", "rvq_ckpts=[]", "test_ckpt=ckpt/mdm.npz",
                "data.vocab_path=/tmp/vocab.json", "guidance.prompt_scale=3"],
    "numbers": ["train.lr=1e-3", "rvq_train.lr=2e-4", "mdm.num_layers=2.0", "latent_scale=4",
                "rvq_train.milestones=[10, 20]", "data.training_speakers=[2,4]", "train.debug=true"],
    "dtypes": ["mdm.dtype=bf16", "mdm.audio_dtype=float32", "mdm.use_prompt=false"],
}


def plain(obj):
    """A dataclass tree as comparable python values; dtypes by name."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, torch.dtype):
        return str(obj).replace("torch.", "")
    if isinstance(obj, (tuple, list)):
        return [plain(v) for v in obj]
    if isinstance(obj, type) or isinstance(obj, np.dtype):
        return np.dtype(obj).name
    return obj


@pytest.mark.parametrize("overrides", list(OVERRIDES))
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).stem)
def test_load_config_matches_jax(path, overrides):
    ov = OVERRIDES[overrides]
    ref, out = JC.load_config(path, ov), PC.load_config(path, ov)
    assert plain(out) == plain(ref)
    assert isinstance(out.mdm.dtype, torch.dtype) and isinstance(out.mdm.audio_dtype, torch.dtype)
    assert isinstance(out.train.lr, float) and isinstance(out.mdm.num_layers, int)


def test_beat2_reads_bf16_and_exponent_strings():
    cfg = PC.load_config("configs/diffusion_beat2.yaml")
    assert cfg.mdm.dtype == cfg.mdm.audio_dtype == torch.bfloat16
    assert cfg.train.lr == 5e-5 and cfg.mdm.cond_mask_prob == 0.3
    assert cfg.rvq_ckpts == ("./outputs/rvq/rvq_upper/step_300000", "./outputs/rvq/rvq_hands/step_300000",
                             "./outputs/rvq/rvq_lower/step_300000")


@pytest.mark.parametrize("value", ["5e-5", "1e-3", "3", "2.5", "true", "ddim50", "[]", "[1, 2]", "{a: 1}",
                                   "''", "null", "a: b: c", "x=y"])
def test_parse_value_matches_jax(value):
    assert PC._parse_value(value) == JC._parse_value(value)


@pytest.mark.parametrize("overrides,error", [
    (["mdm.not_a_field=1"], KeyError),
    (["nope=1"], KeyError),
    (["mdm.num_layers=2.5"], ValueError),
    (["train.lr"], ValueError),
])
def test_config_errors_match_jax(overrides, error):
    with pytest.raises(error):
        JC.load_config("configs/diffusion_h3d.yaml", overrides)
    with pytest.raises(error):
        PC.load_config("configs/diffusion_h3d.yaml", overrides)


@pytest.mark.parametrize("pair", [
    (JaxMDMConfig(), MDMConfig()),
    (JQ.RVQConfig(), PQ.RVQConfig()),
    (JaxRVQVAEConfig(input_dim=78), RVQVAEConfig(input_dim=78)),
    (JC.ExperimentConfig(), PC.ExperimentConfig()),
    (JC.body_part_rvq_config("hands", 32, 1), PC.body_part_rvq_config("hands", 32, 1)),
], ids=["mdm", "rvq", "rvqvae", "experiment", "body_part_rvq"])
def test_dataclasses_have_jax_fields_and_defaults(pair):
    ref, out = pair
    assert plain(out) == plain(ref)


# ---------------------------------------------------------------------------
# fields that change numerics

SMALL = dict(latent_total_dim=48, latent_dim=64, ff_size=128, num_layers=2, num_heads=4, rope_heads=4,
             audio_feat_dim=16, word_feat_dim=16, word_embed_dim=8, vocab_size=32, audio_norm="batch")


def rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12)


def _inputs():
    g = np.random.default_rng(0)
    return dict(audio=g.normal(0, 0.1, (2, 533 * 32, 2)).astype(np.float32), word=g.integers(0, 32, (2, 32)),
                seed=g.normal(size=(2, 4, 48)).astype(np.float32), x_t=g.normal(size=(2, 8, 48)).astype(np.float32),
                t=np.array([5, 731]))


def _both(**fields):
    """(JAX module, variables, port MDM) at SMALL widths with ``fields``."""
    jcfg = JaxMDMConfig(**SMALL, dropout=0.0, **fields)
    mdm, variables = create_mdm(jcfg, jax.random.PRNGKey(0), frames=32)
    pcfg = PC.load_config(None, [f"mdm.{k}={v}" for k, v in SMALL.items()]
                          + [f"mdm.{k}={'bf16' if v is jnp.bfloat16 else v}" for k, v in fields.items()]).mdm
    return mdm, variables, bridge.mdm_from_flax(pcfg, variables, device="cpu")


def _run(mdm, variables, tmdm, d):
    """(JAX, port) of encode_cond's at_feat and denoise's x0 on the same
    inputs; the port's denoise reads JAX's conditioning."""
    cond = mdm.apply(variables, jnp.asarray(d["audio"]), jnp.asarray(d["word"]), jnp.asarray(d["seed"]),
                     method="encode_cond")
    ref = mdm.apply(variables, jnp.asarray(d["x_t"]), jnp.asarray(d["t"]), cond, method="denoise")
    with torch.no_grad():
        pc = tmdm.encode_cond(torch.as_tensor(d["audio"]), torch.as_tensor(d["word"]), torch.as_tensor(d["seed"]))
        tcond = Conditioning(torch.tensor(np.array(cond.at_feat)), torch.tensor(np.array(cond.seed_emb)))
        out = tmdm.denoise(torch.as_tensor(d["x_t"]), torch.as_tensor(d["t"]), tcond)
    return (np.asarray(cond.at_feat), pc.at_feat.numpy()), (np.asarray(ref), out.numpy())


@pytest.fixture(scope="module")
def f32_outputs():
    return _run(*_both(), _inputs())


# bf16 against bf16: both round the same operands; the order of the f32
# accumulations under them differs, which moves a rounding now and then
BF16_REL = 2e-2


@pytest.mark.parametrize("field", ["dtype", "audio_dtype"])
def test_bf16_fields_match_flax(field, f32_outputs):
    """``dtype`` rounds the block stack to bf16, ``audio_dtype`` the
    WavEncoder's convolutions, as flax does: the port's bf16 lies near
    flax's bf16, and the field moves both away from f32. The gaps are
    printed (``-s``)."""
    (jat, pat), (jx0, px0) = _run(*_both(**{field: jnp.bfloat16}), _inputs())
    (fat, _), (fx0, _) = f32_outputs
    print(json.dumps({"field": field, "at_feat": {"port_vs_flax": rel_err(pat, jat), "flax_vs_f32": rel_err(jat, fat)},
                      "x0": {"port_vs_flax": rel_err(px0, jx0), "flax_vs_f32": rel_err(jx0, fx0)}}))
    if field == "audio_dtype":
        assert rel_err(pat, jat) < BF16_REL
        assert rel_err(jat, fat) > 1e-4 and rel_err(pat, fat) > 1e-4
    else:
        assert rel_err(pat, jat) < 1e-5  # the conditioning stays f32
        assert rel_err(px0, jx0) < BF16_REL
        assert rel_err(jx0, fx0) > 1e-4 and rel_err(px0, fx0) > 1e-4


def test_unrolled_block_tree_bridges():
    """``scan_blocks=False`` keeps the blocks as ``block_i``; the bridge
    reads that tree too, with the same numerics as the stacked one."""
    (jat, pat), (jx0, px0) = _run(*_both(scan_blocks=False), _inputs())
    assert rel_err(pat, jat) < 1e-5 and rel_err(px0, jx0) < 1e-5


def test_shared_codebook_matches_jax():
    cfg = dict(num_quantizers=4, nb_code=16, code_dim=8, shared_codebook=True)
    g = np.random.default_rng(1)
    x = g.normal(size=(2, 5, 8)).astype(np.float32)
    cb = g.normal(size=(1, 16, 8)).astype(np.float32)
    jstate = JQ.init_rvq_state(JQ.RVQConfig(**cfg)).replace(codebook=jnp.asarray(cb))
    assert jstate.codebook.shape == (1, 16, 8)
    jq, jidx = JQ.rvq_quantize_eval(jnp.asarray(x), jstate, JQ.RVQConfig(**cfg))
    pq, pidx = PQ.rvq_quantize_eval(torch.as_tensor(x), PQ.RVQState(torch.as_tensor(cb)), PQ.RVQConfig(**cfg))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), atol=1e-6)
    # the K3 wrapper reads the shared codebook for every layer too
    kq, kidx = rvq_quantize_eval_fused(torch.as_tensor(x), PQ.RVQState(torch.as_tensor(cb)), PQ.RVQConfig(**cfg))
    np.testing.assert_array_equal(kidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(kq.numpy(), np.asarray(jq), atol=1e-6)
