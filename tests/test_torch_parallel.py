"""The port's mesh layer against JAX's, in one process on the CPU.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``; the port's
meshes stand for them with repeated ``cpu`` entries (the port's one
departure from JAX: a device may appear more than once). Covered:
``make_mesh``'s shapes and errors; ``shard_batch``'s blocks against the
shards of JAX's ``P("data")`` and its error; ``replicate``; the
tensor-parallel layout (every entry names a port parameter, the rest
replicate, each rank's piece is JAX's piece of the same weight: whole
heads of q, k and v) and its errors; the sharded service (``data=4`` over
four ``cpu`` entries) against the unsharded one on latents, its errors;
``make_fused_loop_sampler(mesh=)`` against JAX's mesh form with JAX's
noise. The process-group forms: tests/test_torch_parallel_2proc.py.

Tolerances: sharded against unsharded in the port, 1e-5 relative (max
error over max magnitude) in f32: the CPU's convolutions (oneDNN) and
GEMMs (MKL) pick their kernels by batch size and may sum in another
order, an ulp here and there (~1.5e-6 after four steps). On the card,
where each sample's arithmetic does not depend on the batch,
``chip_smoke.py`` holds the kernels' shards to 1e-6 absolute. Latents
are compared, not decodes: a snap can flip near a tie. The port's K1
sampler (plain version, f32 weights) against JAX's mesh K1 in interpret
mode: 2e-2 relative, the bound of JAX's Pallas kernels (bf16 weights,
tanh GELU) against f32."""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from syntalker_tpu import generation as JG
from syntalker_tpu.diffusion.core import _rng_normal, _rng_split
from syntalker_tpu.diffusion.schedule import make_diffusion as jax_make_diffusion
from syntalker_tpu.models.denoiser import MDM as JaxMDM
from syntalker_tpu.parallel import mesh as JM
from syntalker_tpu_torch import bridge, generation, serving
from syntalker_tpu_torch.data.stats import identity_pose_stats
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import Conditioning, MDMConfig, build_mdm
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
from syntalker_tpu_torch.ops import mdm_cuda
from syntalker_tpu_torch.ops.mdm_cuda import stack_block_weights
from syntalker_tpu_torch.ops.quantize import RVQConfig
from syntalker_tpu_torch.parallel import mesh as PM
from syntalker_tpu_torch.parallel.multihost import init_multihost, is_primary
from syntalker_tpu_torch.serving import MotionGenerationService, MotionRequest
from test_torch_generation import CFG, JAX_CFG
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

CPU8 = [torch.device("cpu")] * 8
SHARDED_REL = 1e-5
PALLAS_REL = 2e-2


def jax_mesh(data, model=1):
    return JM.make_mesh(data, model, devices=jax.devices()[: data * model])


# ---------------------------------------------------------------------------
# make_mesh, shard_batch, replicate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data,model", [(-1, 1), (8, 1), (4, 2), (-1, 2), (2, 4), (1, 8)])
def test_make_mesh_shapes_match_jax(data, model):
    jm = JM.make_mesh(data, model)
    pm = PM.make_mesh(data, model, devices=CPU8)
    assert pm.shape == dict(jm.shape)
    assert np.array(pm.devices, dtype=object).shape == jm.devices.shape
    assert pm.data is None and pm.model is None and not pm.in_group  # one process: no collectives
    assert len(pm.owned) == 8 and pm.local_devices() == [torch.device("cpu")]


@pytest.mark.parametrize("data,model", [(3, 1), (-1, 3), (4, 4)])
def test_make_mesh_errors_match_jax(data, model):
    with pytest.raises(AssertionError) as jerr:
        JM.make_mesh(data, model)
    with pytest.raises(ValueError) as perr:
        PM.make_mesh(data, model, devices=CPU8)
    assert str(perr.value) == str(jerr.value)


def jax_blocks(arr, mesh, axis):
    """data index -> the block of a JAX array sharded on ``axis`` over 'data'."""
    out = {}
    for shard in arr.addressable_shards:
        d = int(np.argwhere(mesh.devices == shard.device)[0][0])
        out[d] = np.asarray(shard.data)
    return out


@pytest.mark.parametrize("axis", [0, 1])
def test_shard_batch_blocks_match_jax(axis):
    x = np.arange(3 * 8 * 5, dtype=np.float32).reshape((8, 3, 5) if axis == 0 else (3, 8, 5))
    jm = jax_mesh(4, 2)
    spec = JP("data") if axis == 0 else JP(None, "data")
    jb = jax_blocks(jax.device_put(jnp.asarray(x), NamedSharding(jm, spec)), jm, axis)
    pm = PM.make_mesh(4, 2, devices=CPU8)
    shards = PM.shard_batch({"x": x, "n": None}, pm, axis=axis)
    assert [d for d, _ in pm.data_shards()] == [0, 1, 2, 3] and len(shards) == 4
    for d, s in enumerate(shards):
        assert s["n"] is None and s["x"].is_contiguous()
        np.testing.assert_array_equal(s["x"].numpy(), jb[d])
    # P("data") through the port's NamedSharding is the same placement
    for a, b in zip(PM.data_sharding(pm).put(torch.as_tensor(x) if axis == 0 else x.swapaxes(0, 1)),
                    PM.shard_batch(x if axis == 0 else x.swapaxes(0, 1), pm)):
        assert torch.equal(a, b)


def test_shard_batch_error_matches_jax():
    x = np.zeros((6, 2), np.float32)
    with pytest.raises(ValueError) as jerr:
        JM.shard_batch({"x": x}, jax_mesh(4))
    with pytest.raises(ValueError) as perr:
        PM.shard_batch({"x": x}, PM.make_mesh(4, 1, devices=CPU8[:4]))
    assert str(perr.value) == str(jerr.value)


def test_replicate_copies_once_a_distinct_device():
    pm = PM.make_mesh(4, 1, devices=CPU8[:4])
    module = torch.nn.Linear(3, 2)
    tree = {"m": module, "t": (torch.ones(2), np.zeros(3, np.float32)), "k": 3}
    out = PM.replicate(tree, pm)
    assert list(out) == [torch.device("cpu")]
    rep = out[torch.device("cpu")]
    assert rep["m"] is module and rep["k"] == 3  # a module already on the device is its copy
    assert torch.equal(rep["t"][0], torch.ones(2)) and isinstance(rep["t"][1], torch.Tensor)
    assert PM.replicated_sharding(pm).put(tree)[torch.device("cpu")]["m"] is module


def test_single_process_topology():
    info = init_multihost()
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["global_devices"] == info["local_devices"] >= 1
    assert is_primary()


# ---------------------------------------------------------------------------
# the tensor-parallel layout
# ---------------------------------------------------------------------------

TP_CFG = dataclasses.replace(CFG, num_layers=2)
# the port's layout key -> JAX's, and how JAX's piece reads in the port's (out, in) layout
TP_PAIRS = {
    "blocks/qkv/weight": ("blocks/block/qkv/kernel", lambda k: k.transpose(1, 2, 3, 0).reshape(-1, k.shape[0])),
    "blocks/proj/weight": ("blocks/block/proj/kernel", lambda k: k.T),
    "blocks/fc1/weight": ("blocks/block/fc1/kernel", lambda k: k.T),
    "blocks/fc1/bias": ("blocks/block/fc1/bias", lambda k: k),
    "blocks/fc2/weight": ("blocks/block/fc2/kernel", lambda k: k.T),
}


@pytest.fixture(scope="module")
def tp_models():
    """A two-block port MDM and its weights as flax variables (flax's own
    eager init of the MDM takes ~20 s on the CPU)."""
    tmdm = build_mdm(TP_CFG, seed=0, device="cpu")
    return jax.tree.map(jnp.asarray, bridge.mdm_to_flax(tmdm)), tmdm


def test_layout_table_matches_port_parameters(tp_models):
    _, tmdm = tp_models
    names = {PM._path_str(n) for n, _ in tmdm.named_parameters()}
    for suffix in PM.MDM_TP_LAYOUT:
        assert any(n == suffix or n.endswith("/" + suffix) for n in names), suffix
    specs = PM.param_specs(tmdm)
    assert specs["blocks.0.qkv.weight"] == PM.P("model", None, blocks=3) != PM.P("model", None)
    assert specs["blocks.1.fc2.weight"] == PM.P(None, "model")
    assert specs["blocks.1.fc1.bias"] == PM.P("model")
    sharded = {n for n, s in specs.items() if "model" in s}
    assert len(sharded) == len(PM.MDM_TP_LAYOUT) * TP_CFG.num_layers
    for name in ("word_embedding", "output_process.weight", "blocks.0.proj.bias", "blocks.0.fc2.bias",
                 "blocks.0.norm1.weight", "wav_encoder.blocks.0.conv1.weight", "input_process2.weight"):
        assert specs[name] == PM.P(), name  # embeddings, norms, projections and row-parallel biases replicate


@pytest.mark.parametrize("key", list(TP_PAIRS))
def test_each_rank_holds_jaxs_piece(tp_models, key):
    """A rank's piece of each sharded weight is JAX's device's piece of the
    same weight under MDM_TP_LAYOUT at model=2; for qkv that is whole heads
    of q, k and v (JAX shards the H axis of its head-aligned kernel)."""
    variables, tmdm = tp_models
    jkey, to_port = TP_PAIRS[key]
    jspec = JM.MDM_TP_LAYOUT[jkey]
    jfull = np.asarray(variables["params"]["blocks"]["block"][jkey.split("/")[2]][jkey.split("/")[3]])
    layer, name = 1, key.replace("blocks/", "blocks.1.").replace("/", ".")
    port_full = dict(tmdm.named_parameters())[name].detach()
    for index in range(2):
        jpiece = jfull[layer]
        for dim, axis in enumerate(jspec[1:]):
            if axis == "model":
                n = jpiece.shape[dim] // 2
                jpiece = np.take(jpiece, range(index * n, (index + 1) * n), axis=dim)
        piece = PM.shard_tensor(port_full, PM.MDM_TP_LAYOUT[key], index, 2)
        np.testing.assert_array_equal(piece.numpy(), to_port(jpiece))
    if key == "blocks/qkv/weight":  # whole heads: rank 1 holds heads 1 of q, k and v (2 heads of 16)
        d, hd = TP_CFG.latent_dim, TP_CFG.latent_dim // TP_CFG.num_heads
        piece = PM.shard_tensor(port_full, PM.MDM_TP_LAYOUT[key], 1, 2)
        for i in range(3):
            assert torch.equal(piece[i * hd : (i + 1) * hd], port_full[i * d + hd : i * d + 2 * hd])


@pytest.mark.parametrize("case", ["indivisible", "rank", "no_match"])
def test_layout_errors_match_jax(case):
    params, layout, phrase = {
        "indivisible": ({"odd": {"kernel": np.zeros((3, 5), np.float32)}}, ("odd/kernel", (None, "model")),
                        "not divisible"),
        "rank": ({"w": {"kernel": np.zeros((8, 8), np.float32)}}, ("w/kernel", (None, None, "model")), "rank"),
        "no_match": ({"enc": {"kernel": np.zeros((8, 8), np.float32)}}, ("missing/kernel", (None, "model")),
                     "silently disabled"),
    }[case]
    with pytest.raises(ValueError, match=phrase):
        JM.shard_params(jax.tree.map(jnp.asarray, params), jax_mesh(4, 2), layout={layout[0]: JP(*layout[1])})
    flat = {k + "." + kk: torch.as_tensor(v) for k, sub in params.items() for kk, v in sub.items()}
    with pytest.raises(ValueError, match=phrase):
        PM.shard_params(flat, PM.make_mesh(4, 2, devices=CPU8), layout={layout[0]: PM.P(*layout[1])})


def test_tensor_parallelism_needs_whole_heads_and_a_process_group(tp_models):
    _, tmdm = tp_models
    odd = build_mdm(dataclasses.replace(TP_CFG, latent_dim=48, num_heads=3, rope_heads=4), seed=0, device="cpu")
    with pytest.raises(ValueError, match="whole heads"):
        PM.shard_params(odd, PM.make_mesh(4, 2, devices=CPU8))
    with pytest.raises(ValueError, match="one process per device"):
        PM.shard_params(tmdm, PM.make_mesh(4, 2, devices=CPU8))
    assert tmdm.blocks[0].num_heads == TP_CFG.num_heads and tmdm.blocks[0].tp is None  # untouched
    assert PM.shard_params(tmdm, PM.make_mesh(8, 1, devices=CPU8))[torch.device("cpu")] is tmdm  # model=1: replicate


# ---------------------------------------------------------------------------
# the sharded service
# ---------------------------------------------------------------------------

PROMPT_DIM = 16
SERVE_CFG = dataclasses.replace(CFG, use_prompt=True, prompt_dim=PROMPT_DIM)


@pytest.fixture(scope="module")
def serve_models():
    q = RVQConfig(num_quantizers=2, nb_code=16, code_dim=512)
    rvq = {part: build_rvqvae(RVQVAEConfig(input_dim=dim, width=32, depth=1, quantizer=q), seed=i, device="cpu")
           for i, (part, dim) in enumerate((("upper", 78), ("hands", 180), ("lower", 57)))}
    return build_mdm(SERVE_CFG, seed=0, device="cpu"), rvq


def service(models, fused_loop, mesh=None, max_batch=4):
    """The service on the CPU (the kernels' plain versions)."""
    mdm, rvq = models
    return MotionGenerationService(mdm=mdm, diffusion=make_diffusion(steps=4), rvq_modules=rvq,
                                   stats=identity_pose_stats(), max_batch=max_batch, max_seconds=128 / 30,
                                   fused_loop=fused_loop, device="cpu", seed=3, mesh=mesh)


def mixed_requests():
    """Two unprompted requests (the fast path) and two with an upper-body
    prompt (one K2 call a step for the group's three branches)."""
    g = np.random.default_rng(5)
    reqs = []
    for i in range(4):
        prompts = {"upper": g.normal(size=PROMPT_DIM).astype(np.float32)} if i % 2 else None
        reqs.append(MotionRequest(audio=g.normal(0, 0.1, 16000 * (2 + i)).astype(np.float32),
                                  words=g.integers(0, CFG.vocab_size, 30 * (2 + i)), request_id=f"r{i}",
                                  prompts=prompts))
    return reqs


def flush_latents(svc, monkeypatch):
    """Flush the mixed requests; the latents each decode call was given,
    concatenated per group (a sharded flush decodes shard by shard)."""
    seen = []
    decode = generation.decode_latents

    def record(latents, **kw):
        seen.append(latents.clone())
        return decode(latents, **kw)

    monkeypatch.setattr(generation, "decode_latents", record)
    for r in mixed_requests():
        svc.submit(r)
    results = svc.flush()
    monkeypatch.setattr(generation, "decode_latents", decode)
    groups = 2
    per = len(seen) // groups
    return [torch.cat(seen[g * per : (g + 1) * per]) for g in range(groups)], results


@pytest.mark.parametrize("fused_loop", [True, False], ids=["k1", "k2"])
def test_sharded_service_matches_unsharded(serve_models, fused_loop, monkeypatch):
    """The sharded flush against the whole bucket in one batch, on f32
    weights in K1 and K2: a batch-dependent CPU kernel (oneDNN's
    convolutions, MKL's GEMMs at another M) differs from batch to batch by
    an ulp now and then, which bf16 weights would magnify to ~1e-3 in the
    latents."""
    monkeypatch.setattr(serving, "stack_block_weights", functools.partial(stack_block_weights,
                                                                          weights_dtype=torch.float32))
    monkeypatch.setattr(generation, "make_fused_loop_sampler",
                        functools.partial(generation.make_fused_loop_sampler, weights_dtype=torch.float32))
    plain, plain_results = flush_latents(service(serve_models, fused_loop), monkeypatch)
    mesh = PM.make_mesh(4, 1, devices=CPU8[:4])
    sharded, results = flush_latents(service(serve_models, fused_loop, mesh=mesh), monkeypatch)
    assert [r.request_id for r in results] == [r.request_id for r in plain_results] == ["r0", "r2", "r1", "r3"]
    for a, b in zip(sharded, plain):  # the fast-path group, then the prompted one
        assert a.shape == b.shape == (4, 32, 1536)
        assert (a - b).abs().max() <= SHARDED_REL * b.abs().max()
    for r in results:
        assert r.axis_angle.shape == (128, 165) and np.isfinite(r.axis_angle).all()


@pytest.mark.parametrize("fused_loop,prompted", [(True, False), (False, False), (True, True)],
                         ids=["k1", "k2", "prompted"])
def test_sharded_service_matches_the_service_at_a_shards_batch(serve_models, fused_loop, prompted, monkeypatch):
    """The sharded flush as served (bf16 weights, data=4: one request a
    shard) against the unsharded service at a shard's batch flushing the
    same requests one by one on their slices of the same noise: the same
    operations at the same shapes, bit for bit."""
    queue, draw = [], generation.draw_noise
    monkeypatch.setattr(generation, "draw_noise", lambda plan, b, gen, dev: queue.pop(0) if queue else draw(plan, b, gen, dev))
    g = np.random.default_rng(7)
    reqs = [MotionRequest(audio=g.normal(0, 0.1, 16000 * (2 + i)).astype(np.float32), request_id=f"r{i}",
                          prompts={"upper": g.normal(size=PROMPT_DIM).astype(np.float32)} if prompted else None)
            for i in range(4)]
    noise = torch.randn(1, 4, 32, 1536, generator=torch.Generator().manual_seed(8))

    def latents(svc, chunks):
        seen, decode = [], generation.decode_latents
        monkeypatch.setattr(generation, "decode_latents", lambda lat, **kw: seen.append(lat) or decode(lat, **kw))
        for lo, hi in chunks:
            queue.append(noise[:, lo:hi])
            for r in reqs[lo:hi]:
                svc.submit(r)
            assert [r.request_id for r in svc.flush()] == [f"r{i}" for i in range(lo, hi)]
        monkeypatch.setattr(generation, "decode_latents", decode)
        return torch.cat(seen)

    sharded = latents(service(serve_models, fused_loop, mesh=PM.make_mesh(4, 1, devices=CPU8[:4])), [(0, 4)])
    one_by_one = latents(service(serve_models, fused_loop, max_batch=1), [(i, i + 1) for i in range(4)])
    assert sharded.shape == one_by_one.shape == (4, 32, 1536)
    assert torch.equal(sharded, one_by_one)


def test_sharded_service_errors_match_jax(serve_models):
    with pytest.raises(ValueError, match="max_batch 4 not divisible by data axis 3"):
        service(serve_models, True, mesh=PM.make_mesh(3, 1, devices=CPU8[:3]))
    with pytest.raises(ValueError, match="mesh needs a 'data' axis"):
        service(serve_models, True, mesh=SimpleNamespace(shape={"model": 4}))


# ---------------------------------------------------------------------------
# make_fused_loop_sampler(mesh=)
# ---------------------------------------------------------------------------


def test_fused_ddim_window_mesh_runs_each_shard_on_its_device(tp_models):
    """K1's mesh form: one FusedDDIMWindow a distinct device, the batch's
    data shards through it in order; against the whole batch through one
    (plain version, f32 weights)."""
    _, tmdm = tp_models
    diffusion = make_diffusion(steps=4)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(4, 32, 1536, generator=g)
    cond = Conditioning(at_feat=torch.randn(4, 32, TP_CFG.audio_feat_dim, generator=g),
                        seed_emb=torch.randn(4, TP_CFG.latent_dim, generator=g))
    run = mdm_cuda.make_fused_ddim_window(tmdm, diffusion, weights_dtype=torch.float32,
                                          mesh=PM.make_mesh(4, 1, devices=CPU8[:4]))
    shards = run(x, cond)
    whole = mdm_cuda.make_fused_ddim_window(tmdm, diffusion, weights_dtype=torch.float32)(x, cond)
    assert len(shards) == 4 and all(s.shape == (1, 32, 1536) for s in shards)
    assert (torch.cat(shards) - whole).abs().max() <= SHARDED_REL * whole.abs().max()


def test_fused_loop_sampler_mesh_matches_jax(tp_models):
    """The port's K1 sampler over a data=4 mesh (its plain version, f32
    weights) against JAX's ``make_fused_loop_sampler(mesh=)`` (the Pallas
    kernel in interpret mode, over 4 of the 8 virtual devices) on JAX's
    noise, and against the port's unsharded sampler."""
    variables, tmdm = tp_models
    jmdm = JaxMDM(dataclasses.replace(JAX_CFG, num_layers=2))
    plan, b, steps = generation.plan_windows(240), 4, 4
    g = np.random.default_rng(3)
    aw = JG.window_audio(g.normal(0, 0.1, (b, 533 * 240, 2)).astype(np.float32), JG.plan_windows(240))
    ww = JG.window_words(g.integers(0, CFG.vocab_size, (b, 240)).astype(np.int32), JG.plan_windows(240))
    seed = g.normal(size=(b, plan.pre_frames, 1536)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jm = jax_mesh(4)
    jsample = JG.make_fused_loop_sampler(jmdm, variables, jax_make_diffusion(steps=steps), JG.plan_windows(240),
                                         interpret=True, mesh=jm)
    ref = np.asarray(jsample(jnp.asarray(aw), jnp.asarray(ww), jnp.asarray(seed), key))
    noise, k = [], key  # the per-window initial noise of the same key chain
    for _ in range(plan.num_windows):
        k, k_samp = _rng_split(k)
        _, k0 = _rng_split(k_samp)
        noise.append(np.asarray(_rng_normal(k0, (b, plan.latent_window, 1536))))
    args = (torch.as_tensor(aw), torch.as_tensor(ww).long(), torch.as_tensor(seed), torch.as_tensor(np.stack(noise)))
    pm = PM.make_mesh(4, 1, devices=CPU8[:4])
    shards = generation.make_fused_loop_sampler(tmdm, make_diffusion(steps=steps), plan, weights_dtype=torch.float32,
                                                mesh=pm)(*args)
    assert len(shards) == 4 and all(s.shape == (1, plan.out_latent_frames, 1536) for s in shards)
    out = torch.cat(shards)
    whole = generation.make_fused_loop_sampler(tmdm, make_diffusion(steps=steps), plan,
                                               weights_dtype=torch.float32)(*args)
    assert (out - whole).abs().max() <= SHARDED_REL * whole.abs().max()
    assert np.abs(out.numpy() - ref).max() <= PALLAS_REL * np.abs(ref).max()
