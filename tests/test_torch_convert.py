"""The port's converters of reference torch checkpoints against the JAX
package's, and the public names that came with them, on the CPU.

Reference-layout state dicts are built from the port's seeded modules at
small widths (``torch_reference_checkpoints.py``: the key names and shapes
that ``syntalker_tpu/convert.py`` reads, plus keys it ignores), and each
goes through both packages' converters: the trees must be equal array for
array (``np.array_equal``, the same dtypes), and the port's must be the tree
the dict was built from. Forward checks through the bridge: the RVQ-VAE
(encode indices equal; decode within 1e-5 relative) and the MDM with its
WavEncoder BatchNorm folded (``audio_norm='none'``, the full forward within
1e-5 relative of flax's on JAX's converted params); the fold itself, the
``'batch'`` model carrying the unfolded statistics against the folded
``'none'`` model, within 1e-5 relative (f32: only the order of the affine
ops differs). The eval VAE's and the face VQ-VAE's trees are checked for
equality alone: the bridge's tests (``test_torch_eval_vae.py``) hold their
modules to flax's. ``rotation_6d_to_axis_angle`` within 1e-5 of JAX's; the
six ``PoseStats`` part properties equal JAX's."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syntalker_tpu import convert as JCV
from syntalker_tpu.data.stats import PoseStats as JaxPoseStats
from syntalker_tpu.models.denoiser import MDM as JaxMDM
from syntalker_tpu.models.denoiser import MDMConfig as JaxMDMConfig
from syntalker_tpu.models.rvqvae import RVQVAE as JaxRVQVAE
from syntalker_tpu.models.rvqvae import RVQVAEConfig as JaxRVQVAEConfig
from syntalker_tpu.ops import rotations as JR
from syntalker_tpu.ops.quantize import RVQConfig as JaxRVQConfig
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch import convert as CV
from syntalker_tpu_torch.data.stats import PoseStats
from syntalker_tpu_torch.models.denoiser import MDMConfig, build_mdm
from syntalker_tpu_torch.models.eval_vae import EvalVAEConfig, VAESKConv, build_face_vqvae
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
from syntalker_tpu_torch.ops import rotations as R
from syntalker_tpu_torch.ops.quantize import RVQConfig
import torch_reference_checkpoints as REF
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

REL = 1e-5  # f32 against f32: only summation order differs
MDM_KW = dict(latent_total_dim=48, latent_dim=32, ff_size=64, num_layers=2, num_heads=2, rope_heads=4,
              audio_feat_dim=16, word_feat_dim=16, word_embed_dim=8, vocab_size=50, dropout=0.0)
RVQ_KW = dict(input_dim=78, width=16, depth=1)
Q = 2  # quantizer layers


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def assert_same_tree(got, want, path=""):
    """The same nested keys; every leaf the same dtype, shape and values."""
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
        assert np.array_equal(g, w), path


# ---------------------------------------------------------------------------
# RVQ-VAE


@pytest.fixture(scope="module")
def rvq():
    """(source tree, codebooks, reference state dict, poses)."""
    module, _ = build_rvqvae(RVQVAEConfig(**RVQ_KW, quantizer=RVQConfig(num_quantizers=Q, nb_code=16)), seed=3,
                             device="cpu")
    g = np.random.default_rng(3)
    x = g.normal(size=(2, 32, 78)).astype(np.float32)
    with torch.no_grad():
        z = module.map2latent(torch.as_tensor(x)).numpy()
    codebooks = (g.normal(size=(Q, 16, 512)) * z.std() * 0.5 ** np.arange(Q)[:, None, None]).astype(np.float32)
    tree = REF.flax_tree(module)
    return tree, codebooks, REF.rvqvae_state_dict(tree, codebooks, depth=1), x


def test_convert_rvqvae_is_jaxs(rvq):
    tree, codebooks, sd, _ = rvq
    params, qstate = CV.convert_rvqvae(sd, depth=1, num_quantizers=Q)
    jparams, jstate = JCV.convert_rvqvae(sd, depth=1, num_quantizers=Q)
    assert_same_tree(params, jparams)
    assert_same_tree(params, {"params": tree})
    for name in ("codebook", "code_sum", "code_count"):
        assert np.array_equal(getattr(qstate, name).numpy(), np.asarray(getattr(jstate, name))), name
    assert np.array_equal(qstate.codebook.numpy(), codebooks) and qstate.initialized is True
    assert bool(jstate.initialized) and torch.equal(qstate.code_count, torch.ones(Q, 16))


def test_converted_rvqvae_forward_is_jaxs(rvq):
    """Encode indices equal; decode of them within REL; through the bridge."""
    _, _, sd, x = rvq
    params, qstate = CV.convert_rvqvae(sd, depth=1, num_quantizers=Q)
    jparams, jstate = JCV.convert_rvqvae(sd, depth=1, num_quantizers=Q)
    jmod = JaxRVQVAE(JaxRVQVAEConfig(**RVQ_KW, quantizer=JaxRVQConfig(num_quantizers=Q, nb_code=16)))
    jidx = np.asarray(jmod.apply(jparams, jnp.asarray(x), jstate, method="encode"))
    jdec = jmod.apply(jparams, jnp.asarray(jidx), jstate, method="decode_indices")
    module, state = bridge.rvqvae_from_flax(RVQVAEConfig(**RVQ_KW, quantizer=RVQConfig(num_quantizers=Q, nb_code=16)),
                                            params["params"], qstate.codebook, device="cpu")
    with torch.no_grad():
        idx = module.encode(torch.as_tensor(x), state)
        dec = module.decode_indices(idx, state)
    assert np.array_equal(idx.numpy(), jidx) and len(np.unique(jidx[..., 0])) > 1
    assert rel_err(dec, jdec) < REL


def test_load_torch_rvqvae_reads_the_net_blob(rvq, tmp_path):
    _, _, sd, _ = rvq
    torch.save({"net": REF.module_prefixed(sd), "ep": 300000}, tmp_path / "net_300000.pth")
    params, qstate = CV.load_torch_rvqvae(str(tmp_path / "net_300000.pth"), depth=1, num_quantizers=Q)
    jparams, jstate = JCV.load_torch_rvqvae(str(tmp_path / "net_300000.pth"), depth=1, num_quantizers=Q)
    assert_same_tree(params, jparams)
    assert_same_tree(params, CV.convert_rvqvae(sd, depth=1, num_quantizers=Q)[0])
    assert np.array_equal(qstate.codebook.numpy(), np.asarray(jstate.codebook))


# ---------------------------------------------------------------------------
# MDM


@pytest.fixture(scope="module")
def mdm():
    """(the port's 'batch' model with perturbed norms and statistics, its
    reference state dict, inputs)."""
    cfg = MDMConfig(**MDM_KW, audio_norm="batch")
    source = REF.perturb_wav_norms(bridge.mdm_to_flax(build_mdm(cfg, seed=4, device="cpu")), seed=4)
    g = np.random.default_rng(4)
    b = 3
    inputs = {"x_t": g.normal(size=(b, 8, 48)).astype(np.float32), "t": np.array([5, 99, 731]),
              "audio": g.normal(0, 0.1, (b, 533 * 32, 2)).astype(np.float32),
              "word": g.integers(0, MDM_KW["vocab_size"], (b, 32)),
              "seed": g.normal(size=(b, 4, 48)).astype(np.float32)}
    return bridge.mdm_from_flax(cfg, source, device="cpu"), REF.mdm_state_dict(source), inputs


def port_forward(model, inputs):
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    with torch.no_grad():
        return model.denoise(t["x_t"], t["t"], model.encode_cond(t["audio"], t["word"], t["seed"])).numpy()


def test_convert_mdm_is_jaxs(mdm):
    _, sd, _ = mdm
    for d in (sd, REF.module_prefixed(sd)):
        assert_same_tree(CV.convert_mdm(d, num_layers=2, num_heads=2), JCV.convert_mdm(d, num_layers=2, num_heads=2))


def test_converted_mdm_forward_is_flaxs(mdm):
    _, sd, inputs = mdm
    jcfg = JaxMDMConfig(**MDM_KW, audio_norm="none")
    ref = JaxMDM(jcfg).apply(JCV.convert_mdm(sd, num_layers=2, num_heads=2), *(jnp.asarray(inputs[k]) for k in (
        "x_t", "t", "audio", "word", "seed")))
    model = bridge.mdm_from_flax(MDMConfig(**MDM_KW, audio_norm="none"), CV.convert_mdm(sd, num_layers=2, num_heads=2),
                                 device="cpu")
    out = port_forward(model, inputs)
    assert out.shape == (3, 8, 48) and rel_err(out, ref) < REL


def test_batchnorm_fold_is_exact(mdm):
    """The 'batch' model on the unfolded statistics is the folded 'none' model."""
    unfolded, sd, inputs = mdm
    folded = bridge.mdm_from_flax(MDMConfig(**MDM_KW, audio_norm="none"), CV.convert_mdm(sd, num_layers=2,
                                                                                          num_heads=2), device="cpu")
    ref = port_forward(unfolded, inputs)
    assert rel_err(port_forward(folded, inputs), ref) < REL
    # the statistics matter: the same convs without their norms give another model
    params = bridge.mdm_to_flax(unfolded)["params"]
    params["wav_encoder"] = {name: {k: v for k, v in block.items() if "norm" not in k}
                             for name, block in params["wav_encoder"].items()}
    unnormed = bridge.mdm_from_flax(MDMConfig(**MDM_KW, audio_norm="none"), params, device="cpu")
    assert rel_err(port_forward(unnormed, inputs), ref) > 1e-2


# ---------------------------------------------------------------------------
# the eval VAE and the face VQ-VAE


@pytest.mark.parametrize("latent_dim", (240, 64), ids=("shipped", "decoder-proj"))
def test_convert_eval_vae_is_jaxs(latent_dim, tmp_path):
    """The shipped widths, and a latent width whose decoder needs the
    projection conv (``main.0``), which shifts every later index by one."""
    cfg = EvalVAEConfig(latent_dim=latent_dim)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        tree = REF.flax_tree(VAESKConv(cfg))
    assert ("proj" in tree["decoder"]) == (latent_dim != 240)
    sd = REF.eval_vae_state_dict(tree)
    torch.save({"model_state": REF.module_prefixed(sd), "epoch": 100}, tmp_path / "AESKConv_240_100.bin")
    loaded = CV.load_torch_eval_checkpoint(str(tmp_path / "AESKConv_240_100.bin"))
    assert sorted(loaded) == sorted(sd)
    jloaded = JCV.load_torch_eval_checkpoint(str(tmp_path / "AESKConv_240_100.bin"))
    params = CV.convert_eval_vae(loaded)
    assert_same_tree(params, JCV.convert_eval_vae(jloaded))
    assert_same_tree(params, {"params": tree})
    model = bridge.eval_vae_from_flax(params, cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(np.asarray(a).size for a in jax.tree.leaves(tree))


def test_convert_face_vqvae_is_jaxs():
    tree = REF.flax_tree(build_face_vqvae(seed=6, device="cpu"))
    sd = REF.face_vqvae_state_dict(tree)
    params = CV.convert_face_vqvae(REF.module_prefixed(sd))
    assert_same_tree(params, JCV.convert_face_vqvae(sd))
    assert_same_tree(params, {"params": tree})
    model = bridge.face_vqvae_from_flax(params, device="cpu")
    assert torch.equal(model.codebook, torch.as_tensor(tree["codebook"]))


# ---------------------------------------------------------------------------
# public names


def test_rotation_6d_to_axis_angle_is_jaxs():
    d6 = np.random.default_rng(7).normal(size=(4, 55, 6)).astype(np.float32)
    ref = np.asarray(JR.rotation_6d_to_axis_angle(jnp.asarray(d6)))
    out = R.rotation_6d_to_axis_angle(torch.as_tensor(d6)).numpy()
    assert out.shape == (4, 55, 3) and np.abs(out - ref).max() < 1e-5


def test_pose_stats_part_properties_are_jaxs():
    g = np.random.default_rng(8)
    fields = dict(mean_full=g.normal(size=330).astype(np.float32), std_full=g.uniform(0.5, 2, 330).astype(np.float32),
                  trans_mean=g.normal(size=3).astype(np.float32), trans_std=g.uniform(0.5, 2, 3).astype(np.float32))
    port, ref = PoseStats(**fields), JaxPoseStats(**fields)
    for part in ("upper", "hands", "lower"):
        for kind in ("mean", "std"):
            name = f"{kind}_{part}"
            got, want = getattr(port, name), getattr(ref, name)
            assert got.dtype == want.dtype and np.array_equal(got, want), name
