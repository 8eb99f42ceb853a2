"""What the K1/K2/K3 wrappers decide on the host, checked on the CPU: how
many kernels a graph replay or a call runs, that repeated CPU calls with
other inputs and batch sizes equal the plain versions, K3's grid, that the
shape and dtype checks in front of the kernels raise on what the kernels do
not take, and that K3's wrapper takes the same operands on every device."""

import pytest
import torch

from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import Conditioning, MDMConfig, build_mdm
from syntalker_tpu_torch.ops import mdm_cuda as E
from syntalker_tpu_torch.ops import quantize_cuda as K3
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

SMALL = MDMConfig(latent_total_dim=48, latent_dim=64, ff_size=128, num_layers=2, num_heads=4, rope_heads=4,
                  audio_feat_dim=16, word_feat_dim=16, word_embed_dim=8, vocab_size=32)


@pytest.fixture(scope="module")
def mdm():
    return build_mdm(SMALL, seed=0, device="cpu")


@pytest.mark.parametrize("layers,steps,per_stack,per_window", [
    (8, 50, 56, 2952),  # MDMConfig() under DDIM-50: what chip_smoke.py asserts per call and per replay
    (3, 4, 21, 98),  # the card-only tests' config
    (1, 1, 7, 12),
])
def test_launch_counts(layers, steps, per_stack, per_window):
    assert E.block_launches(layers) == per_stack
    assert E.window_launches(layers, steps) == per_window
    # a window is two launches, then per step four around the stack, less the
    # first LayerNorm, which the prologue does
    assert per_window == 2 + steps * (3 + per_stack)
    assert per_window < 2 + steps * (4 + per_stack)  # fewer than one launch per kernel and step


def test_launch_counts_of_the_full_config_match_its_defaults():
    cfg = MDMConfig()
    steps = make_diffusion(steps=1000, timestep_respacing="ddim50").num_steps
    assert (E.block_launches(cfg.num_layers), E.window_launches(cfg.num_layers, steps)) == (56, 2952)


def window_inputs(b, g):
    return (torch.randn(b, 32, SMALL.latent_total_dim, generator=g),
            Conditioning(torch.randn(b, 32, SMALL.audio_feat_dim, generator=g),
                         torch.randn(b, SMALL.latent_dim, generator=g)))


def test_cpu_calls_in_turns_equal_the_plain_versions(mdm):
    """Two batch sizes in turns, new inputs every call: the CPU path keeps
    no state between calls and counts no launch."""
    fused = E.FusedDDIMWindow(mdm, make_diffusion(steps=100, timestep_respacing="ddim4"))
    w = E.stack_block_weights(mdm)
    g = torch.Generator().manual_seed(0)
    before = dict(E.launches)
    outs = []
    for b in (2, 3, 2, 3):
        x_init, cond = window_inputs(b, g)
        out = fused(x_init, cond)
        assert torch.equal(out, fused.plain(x_init, cond))
        outs.append(out)
        x = torch.randn(b, 32, SMALL.latent_dim, generator=g)
        assert torch.equal(E.block_stack(x, w, num_heads=SMALL.num_heads),
                           E.block_stack_plain(x, w, num_heads=SMALL.num_heads))
    assert not torch.equal(outs[0], outs[2]) and not torch.equal(outs[1], outs[3])
    assert E.launches == before and not fused._plans and not w.plans


def gemm_operands(m=8, n=16, k=24, a_dtype=torch.bfloat16):
    return dict(a=torch.zeros(m, k, dtype=a_dtype), w=torch.zeros(k, n, dtype=torch.bfloat16),
                bias=torch.zeros(n), out_f=torch.zeros(m, n), out_h=torch.zeros(m, n, dtype=torch.bfloat16))


def check(epi, ops, **override):
    ops = {**ops, **override}
    return E.check_gemm(ops.pop("a"), ops.pop("w"), epi, **ops)


@pytest.mark.parametrize("epi,override", [
    (E.EPI_STORE, dict(out_h=None)),
    (E.EPI_BIAS_BF16, dict(out_f=None)),
    (E.EPI_BIAS_GELU_BF16, dict(out_f=None)),
    (E.EPI_BIAS_RESIDUAL, {}),
    (E.EPI_BIAS_RESIDUAL, dict(out_h=None)),  # the bf16 copy is optional
    (E.EPI_DDIM, dict(bias=None)),
], ids=["store", "bias_bf16", "bias_gelu_bf16", "residual_with_copy", "residual", "ddim_without_bias"])
def test_check_gemm_takes_what_the_path_launches(epi, override):
    check(epi, gemm_operands(), **override)


@pytest.mark.parametrize("why,epi,ops,override", [
    ("K of A and W differ", E.EPI_STORE, gemm_operands(), dict(w=torch.zeros(32, 16, dtype=torch.bfloat16))),
    ("f32 weights", E.EPI_STORE, gemm_operands(), dict(w=torch.zeros(24, 16))),
    ("f16 A", E.EPI_STORE, gemm_operands(a_dtype=torch.float16), dict(out_h=None)),
    ("f32 A", E.EPI_STORE, gemm_operands(a_dtype=torch.float32), dict(out_h=None)),
    ("N not a multiple of 8", E.EPI_BIAS_RESIDUAL, gemm_operands(n=12), dict(out_h=None)),
    ("K not a multiple of 8", E.EPI_BIAS_RESIDUAL, gemm_operands(k=20), dict(out_h=None)),
    ("no f32 output for a residual epilogue", E.EPI_BIAS_RESIDUAL, gemm_operands(), dict(out_f=None)),
    ("f32 output where the epilogue writes bf16", E.EPI_BIAS_BF16, gemm_operands(), dict(out_h=torch.zeros(8, 16))),
    ("output of another shape", E.EPI_DDIM, gemm_operands(), dict(out_f=torch.zeros(8, 24))),
    ("bf16 copy from the plain store", E.EPI_STORE, gemm_operands(), {}),
    ("bias of another length", E.EPI_BIAS_BF16, gemm_operands(), dict(bias=torch.zeros(8))),
    ("A not contiguous", E.EPI_BIAS_BF16, gemm_operands(), dict(a=torch.zeros(24, 8, dtype=torch.bfloat16).t())),
    ("bf16 bias", E.EPI_BIAS_BF16, gemm_operands(), dict(bias=torch.zeros(16, dtype=torch.bfloat16))),
    ("bf16 copy of another shape", E.EPI_DDIM, gemm_operands(), dict(out_h=torch.zeros(8, 24, dtype=torch.bfloat16))),
], ids=lambda v: v.replace(" ", "_") if isinstance(v, str) else None)
def test_check_gemm_raises(why, epi, ops, override):
    with pytest.raises(ValueError, match="gemm"):
        check(epi, ops, **override)


@pytest.mark.parametrize("why,qkv,out,d,heads", [
    ("head width not a multiple of 4", torch.zeros(64, 72), torch.zeros(64, 24, dtype=torch.bfloat16), 24, 4),
    ("heads do not divide the width", torch.zeros(64, 192), torch.zeros(64, 64, dtype=torch.bfloat16), 64, 3),
    ("bf16 qkv", torch.zeros(64, 192, dtype=torch.bfloat16), torch.zeros(64, 64, dtype=torch.bfloat16), 64, 4),
    ("f32 output", torch.zeros(64, 192), torch.zeros(64, 64), 64, 4),
    ("rows of another count", torch.zeros(32, 192), torch.zeros(64, 64, dtype=torch.bfloat16), 64, 4),
], ids=lambda v: v.replace(" ", "_") if isinstance(v, str) else None)
def test_check_attention_raises(why, qkv, out, d, heads):
    with pytest.raises(ValueError, match="attention"):
        E.check_attention(qkv, out, 2, 32, d, heads)


def test_check_attention_takes_the_full_width_and_refuses_what_shared_memory_cannot_hold():
    E.check_attention(torch.zeros(64, 1536), torch.zeros(64, 512, dtype=torch.bfloat16), 2, 32, 512, 4)
    t = 512  # K and V of 512 tokens x 128 alone are 512 KB
    with pytest.raises(ValueError, match="shared memory"):
        E.check_attention(torch.zeros(t, 1536), torch.zeros(t, 512, dtype=torch.bfloat16), 1, t, 512, 4)


def test_check_cuda_refuses_a_cpu_tensor(mdm):
    w = E.stack_block_weights(mdm)
    with pytest.raises(ValueError, match="unsupported device"):
        E._check_cuda(torch.zeros(1, 32, SMALL.latent_dim), w)


def test_stacked_weights_keep_their_graphs_beside_the_tensors(mdm):
    """K2's graphs live on the weights they read: a new stack starts with
    none, and holds only tensors as a dict."""
    w = E.stack_block_weights(mdm)
    assert isinstance(w, E.StackedWeights) and w.plans == {}
    assert all(isinstance(v, torch.Tensor) for v in w.values()) and len(w) == 11
    assert E.stack_block_weights(mdm).plans is not w.plans


def test_a_window_starts_without_graphs(mdm):
    """K1 keeps its graphs on the FusedDDIMWindow and K2's on the stacked
    weights: both start empty, and building K1 records nothing."""
    fused = E.FusedDDIMWindow(mdm, make_diffusion(steps=100, timestep_respacing="ddim4"))
    assert fused._plans == {} and isinstance(fused.blocks, E.StackedWeights)
    assert fused.blocks.plans == {}  # K1 records its own graph, not K2's


# ---------------------------------------------------------------------------
# K3: the residual-VQ snap


def test_rvq_plan_fills_the_card():
    serve = K3.rvq_plan(928, 6, 512, 512)  # B=8 x 116 latent frames: one body part of a flush
    assert serve.blocks >= K3.SMS
    assert (serve.rows, serve.codes) == K3.TILE and serve.grid == (16, 29)
    knee = K3.rvq_plan(29696, 6, 512, 512)  # B=256 x 116
    assert (knee.rows, knee.codes) == K3.TILE and knee.blocks >= K3.SMS


@pytest.mark.parametrize("qkd", [(6, 512, 512), (4, 64, 128)], ids=["6x512x512", "4x64x128"])
@pytest.mark.parametrize("n", [1, 31, 300, 928, 1001, 4096, 29696])
def test_rvq_plan_covers_every_row_and_code_once(n, qkd):
    q, k, d = qkd
    plan = K3.rvq_plan(n, q, k, d)
    bm, bn = plan.rows, plan.codes
    rows, codes = torch.zeros(n, dtype=torch.int64), torch.zeros(k, dtype=torch.int64)
    for by in range(plan.grid[1]):  # a block masks the rows past N
        rows[by * bm: min(n, (by + 1) * bm)] += 1
    for bx in range(plan.grid[0]):
        codes[bx * bn: (bx + 1) * bn] += 1
    assert bool((rows == 1).all()) and bool((codes == 1).all())
    assert plan.grid[0] * bn == k and (plan.grid[1] - 1) * bm < n <= plan.grid[1] * bm


@pytest.mark.parametrize("why,n,q,k,d", [
    ("no rows", 0, 6, 512, 512),
    ("no layers", 8, 0, 512, 512),
    ("width not a multiple of the slice", 8, 6, 512, 100),
    ("width under one slice", 8, 6, 512, 16),
    ("codes not a multiple of any tile", 8, 6, 48, 128),
    ("fewer codes than any tile", 8, 6, 16, 128),
    ("more row tiles than the grid holds", 128 * 65535 + 1, 6, 512, 512),
], ids=lambda v: v.replace(" ", "_") if isinstance(v, str) else None)
def test_rvq_plan_raises(why, n, q, k, d):
    with pytest.raises(ValueError, match="rvq_plan"):
        K3.rvq_plan(n, q, k, d)


@pytest.mark.parametrize("q,kernels", [(6, 13), (4, 9), (1, 3)])
def test_rvq_kernel_launches(q, kernels):
    assert K3.rvq_kernel_launches(q) == kernels  # the norms, then a distance and an apply launch a layer


def rvq_operands(n=40, d=128, dtype=torch.float32):
    return torch.zeros(n, d, dtype=dtype), torch.zeros(4, 64, d)


@pytest.mark.parametrize("why,x,cb", [
    ("f16 rows", rvq_operands(dtype=torch.float16)[0], rvq_operands()[1]),
    ("bf16 codebooks", rvq_operands()[0], rvq_operands()[1].to(torch.bfloat16)),
    ("rows not contiguous", torch.zeros(128, 40).t(), rvq_operands()[1]),
    ("rows off 16-byte alignment", torch.zeros(40 * 128 + 1)[1:].view(40, 128), rvq_operands()[1]),
    ("widths differ", rvq_operands(d=96)[0], rvq_operands()[1]),
    ("rows without a batch dimension", torch.zeros(128), rvq_operands()[1]),
    ("width the plan refuses", rvq_operands(d=100)[0], torch.zeros(4, 64, 100)),
], ids=lambda v: v.replace(" ", "_") if isinstance(v, str) else None)
def test_check_rvq_raises(why, x, cb):
    with pytest.raises(ValueError, match="rvq_"):
        K3.check_rvq(x, cb)


def test_check_rvq_takes_the_main_path_and_the_tests_shapes():
    assert K3.check_rvq(*rvq_operands()) == K3.rvq_plan(40, 4, 64, 128)
    assert K3.check_rvq(torch.zeros(928, 512), torch.zeros(6, 512, 512)) == K3.rvq_plan(928, 6, 512, 512)


def other_operands(why):
    g = torch.Generator().manual_seed(6)
    x, cb = torch.randn(40, 128, generator=g), torch.randn(4, 64, 128, generator=g)
    if why == "bf16 rows":
        return x.bfloat16(), cb
    if why == "f16 codebooks":
        return x, cb.half()
    if why == "rows not contiguous":
        return x.t().contiguous().t(), cb
    return torch.cat([torch.zeros(1), x.flatten()])[1:].view(40, 128), cb  # rows off 16-byte alignment


@pytest.mark.parametrize("why", ["bf16 rows", "f16 codebooks", "rows not contiguous", "rows off 16-byte alignment"])
def test_rvq_encode_takes_the_kernels_operands_on_every_device(why):
    """The wrapper brings any float dtype and layout to the operands that
    check_rvq asks the kernels for before it picks a device, so the CPU
    takes exactly what the card does."""
    x, cb = other_operands(why)
    with pytest.raises(ValueError, match="rvq_encode"):
        K3.check_rvq(x, cb)
    taken = [K3._operand(t) for t in (x, cb)]
    assert K3.check_rvq(*taken) == K3.rvq_plan(40, 4, 64, 128)
    out, idx = K3.rvq_encode_fused(x, cb)
    ref, ref_idx = K3.rvq_encode_plain(*taken)
    assert out.dtype == torch.float32 and torch.equal(idx, ref_idx) and torch.equal(out, ref)
