"""The hand-written CUDA kernels against their plain versions, on the card.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

The shapes are small and ragged on purpose (rows, output columns and the
reduction depth that are not multiples of the kernels' tiles); full-width
parity is chip_smoke.py's."""

import pytest
import torch

from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import Conditioning, MDMConfig, build_mdm
from syntalker_tpu_torch.ops import mdm_cuda, quantize_cuda

pytestmark = pytest.mark.cuda

SMALL = MDMConfig(latent_total_dim=48, latent_dim=256, ff_size=512, num_layers=3, num_heads=4, rope_heads=4,
                  audio_feat_dim=16, word_feat_dim=16, word_embed_dim=8, vocab_size=32)
REL = 1e-2  # the same bf16 rounding points; f32 sums in another order


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mdm(dev):
    return build_mdm(SMALL, seed=0, device=dev)


def rel_err(out, ref):
    return ((out - ref).abs().max() / ref.abs().max()).item()


def test_block_stack_kernel_matches_plain(mdm, dev):
    w = mdm_cuda.stack_block_weights(mdm)
    x = torch.randn(5, 32, SMALL.latent_dim, device=dev, generator=torch.Generator(dev).manual_seed(1))
    plan = mdm_cuda.block_launches(SMALL.num_layers)
    assert plan == 7 * SMALL.num_layers
    before = mdm_cuda.launches["block_stack"]
    out = mdm_cuda.block_stack(x, w, num_heads=SMALL.num_heads)
    torch.cuda.synchronize()
    # a new (B, T): one real pass on a side stream before the capture, then the replay
    assert mdm_cuda.launches["block_stack"] == before + 2 * plan
    assert rel_err(out, mdm_cuda.block_stack_plain(x, w, num_heads=SMALL.num_heads)) < REL
    out = mdm_cuda.block_stack(x, w, num_heads=SMALL.num_heads)
    assert mdm_cuda.launches["block_stack"] == before + 3 * plan  # a replay and nothing else


@pytest.mark.parametrize("b", [24, 32, 40])
def test_block_stack_at_prompted_batches(mdm, dev, b):
    """K2 at the batches of the prompted path: K = 3, 4 or 5 guidance
    branches of 8 samples stacked into one call."""
    w = mdm_cuda.stack_block_weights(mdm)
    g = torch.Generator(dev).manual_seed(b)
    for _ in range(2):  # the capture's call, then a replay on new inputs
        x = torch.randn(b, 32, SMALL.latent_dim, device=dev, generator=g)
        out = mdm_cuda.block_stack(x, w, num_heads=SMALL.num_heads)
        assert rel_err(out, mdm_cuda.block_stack_plain(x, w, num_heads=SMALL.num_heads)) < REL


def test_prompted_denoise_matches_plain_mdm(dev):
    """The prompted path's denoise (the whole prepare_sequence, prompt and
    style concats included, then K2) against MDM.denoise in f32."""
    import dataclasses

    cfg = dataclasses.replace(SMALL, use_prompt=True, prompt_dim=16, use_motionclip=True, style_dim=8)
    model = build_mdm(cfg, seed=1, device=dev)
    g = torch.Generator(dev).manual_seed(9)
    b = 24
    cond = Conditioning(torch.randn(b, 32, cfg.audio_feat_dim, device=dev, generator=g),
                        torch.randn(b, cfg.latent_dim, device=dev, generator=g),
                        prompt_feat=torch.randn(b, 16, device=dev, generator=g),
                        style_feat=torch.randn(b, 8, device=dev, generator=g))
    x_t = torch.randn(b, 32, cfg.latent_total_dim, device=dev, generator=g)
    t_emb = model.embed_timesteps(torch.full((b,), 500, device=dev))
    denoise = mdm_cuda.make_fused_denoise(model, mdm_cuda.stack_block_weights(model))
    with torch.no_grad():
        assert rel_err(denoise(x_t, t_emb, cond), model.denoise(x_t, None, cond, t_emb=t_emb)) < REL


def window_inputs(b, g, dev):
    return (torch.randn(b, 32, SMALL.latent_total_dim, device=dev, generator=g),
            Conditioning(torch.randn(b, 32, SMALL.audio_feat_dim, device=dev, generator=g),
                         torch.randn(b, SMALL.latent_dim, device=dev, generator=g)))


def test_ddim_window_kernel_matches_plain(mdm, dev):
    fused = mdm_cuda.FusedDDIMWindow(mdm, make_diffusion(steps=100, timestep_respacing="ddim4"))
    x_init, cond = window_inputs(3, torch.Generator(dev).manual_seed(2), dev)
    # per step: input_process, x slab, prologue (with the first LayerNorm), 7 per layer less that
    # LayerNorm, output + update; per window: the audio/word slab and the style rows
    plan = mdm_cuda.window_launches(SMALL.num_layers, 4)
    assert plan == 2 + 4 * (4 + 7 * SMALL.num_layers - 1)
    before = mdm_cuda.launches["ddim_window"]
    out = fused(x_init, cond)
    torch.cuda.synchronize()
    assert mdm_cuda.launches["ddim_window"] == before + 2 * plan  # the real pass, then the replay
    assert rel_err(out, fused.plain(x_init, cond)) < REL
    fused(x_init, cond)
    assert mdm_cuda.launches["ddim_window"] == before + 3 * plan


def test_graph_replay_sees_each_calls_inputs(mdm, dev):
    """Two batch sizes alive at once, called in turns with new inputs: every
    call matches the plain version on ITS inputs (no stale static buffer)."""
    fused = mdm_cuda.FusedDDIMWindow(mdm, make_diffusion(steps=100, timestep_respacing="ddim4"))
    w = mdm_cuda.stack_block_weights(mdm)
    g = torch.Generator(dev).manual_seed(5)
    for b in (2, 3, 2, 3):
        x_init, cond = window_inputs(b, g, dev)
        assert rel_err(fused(x_init, cond), fused.plain(x_init, cond)) < REL
        x = torch.randn(b, 32, SMALL.latent_dim, device=dev, generator=g)
        out = mdm_cuda.block_stack(x, w, num_heads=SMALL.num_heads)
        assert rel_err(out, mdm_cuda.block_stack_plain(x, w, num_heads=SMALL.num_heads)) < REL
    assert len(fused._plans) == 2 and len(w.plans) == 2


H3D = MDMConfig(latent_dim=512, ff_size=1024, num_layers=8, num_heads=4, rope_heads=8, audio_feat_dim=256,
                word_feat_dim=256, word_embed_dim=300, vocab_size=11195, use_prompt=True, prompt_dim=256,
                audio_norm="batch")  # configs/diffusion_h3d.yaml's widths


@pytest.fixture(scope="module")
def h3d(dev):
    return build_mdm(H3D, seed=2, device=dev), make_diffusion(steps=1000, timestep_respacing="ddim50")


def guided_inputs(b, parts, g, dev):
    """One window's audio, words, seed, noise and prompts at batch b."""
    return (torch.rand(b, 533 * 128, 2, device=dev, generator=g),
            torch.randint(0, H3D.vocab_size, (b, 128), device=dev, generator=g),
            torch.randn(b, 4, 1536, device=dev, generator=g), torch.randn(b, 32, 1536, device=dev, generator=g),
            {p: torch.randn(b, H3D.prompt_dim, device=dev, generator=g) for p in parts})


def guided_pair(model, diffusion, kernel, inputs, guidance):
    """A prompted window through the guided window's graph, and through the
    step loop on the same K2 (a caller's own denoise keeps the loop)."""
    from syntalker_tpu_torch import generation as G

    audio, word, seed, noise, prompts = inputs
    outs = []
    for denoise in (kernel, lambda x, t_emb, cond: kernel(x, t_emb, cond)):
        fn = G.make_denoise_fn(model, diffusion, denoise)
        outs.append(G.sample_window(model, diffusion, fn, audio, word, seed, noise, sampler="ddim", prompts=prompts,
                                    guidance=guidance))
    return outs


@pytest.mark.parametrize("parts,b", [(("upper",), 8), (("hands", "lower"), 8), (("upper",), 1)],
                         ids=["k3-b8", "k4-b8", "k3-b1"])
def test_guided_window_graph_matches_the_step_loop(h3d, dev, parts, b):
    """The guided window's graph at the h3d widths, DDIM-50, against the
    eager guided ``sample_window`` on the same inputs and noise: the same
    K2, the f32 products summed in another order."""
    model, diffusion = h3d
    kernel = mdm_cuda.make_fused_denoise(model, mdm_cuda.stack_block_weights(model))
    inputs = guided_inputs(b, parts, torch.Generator(dev).manual_seed(b + len(parts)), dev)
    before = mdm_cuda.launches["guided_window"]
    graph, loop = guided_pair(model, diffusion, kernel, inputs, {"audio_scale": 1.0, "prompt_scale": 4.0})
    torch.cuda.synchronize()
    # the capture's real run, then the replay
    assert mdm_cuda.launches["guided_window"] - before == 2 * mdm_cuda.guided_window_launches(H3D.num_layers, 50)
    assert rel_err(graph, loop) < REL


def test_guided_graph_replay_sees_each_calls_inputs(h3d, dev):
    """One graph (K=3, B=2) for two calls with other prompts, guidance
    scales and noise: each matches the step loop on its own inputs; one
    capture, then a replay."""
    from syntalker_tpu_torch.utils import tracking

    model, diffusion = h3d
    kernel = mdm_cuda.make_fused_denoise(model, mdm_cuda.stack_block_weights(model))
    g = torch.Generator(dev).manual_seed(21)
    tracking.enable()
    try:
        for guidance in ({"audio_scale": 1.0, "prompt_scale": 4.0}, {"audio_scale": 0.5, "prompt_scale": 2.0}):
            graph, loop = guided_pair(model, diffusion, kernel, guided_inputs(2, ("upper",), g, dev), guidance)
            assert rel_err(graph, loop) < REL, guidance
    finally:
        tracking.disable()
        counts = tracking.drain()["counts"]
    assert counts == {"sample.graph_captures": 1, "sample.graph_windows": 2}
    (win,) = kernel.weights.guided.values()
    assert [key[1:] for key in win._plans] == [(3, 2, 32, True, False)]


def test_guided_window_threads_take_turns(dev):
    """Four threads call one guided window (one graph) at once, each with
    its own inputs, switching threads as often as the interpreter allows:
    every call returns what the same call returns alone."""
    import dataclasses
    import sys
    import threading

    cfg = dataclasses.replace(SMALL, latent_total_dim=1536, use_prompt=True, prompt_dim=16)
    model = build_mdm(cfg, seed=4, device=dev)
    win = mdm_cuda.guided_ddim_window(model, make_diffusion(steps=100, timestep_respacing="ddim4"),
                                      mdm_cuda.stack_block_weights(model))
    g = torch.Generator(dev).manual_seed(13)
    calls = [(torch.randn(2, 32, 1536, device=dev, generator=g),
              Conditioning(torch.randn(6, 32, cfg.audio_feat_dim, device=dev, generator=g),
                           torch.randn(6, cfg.latent_dim, device=dev, generator=g),
                           prompt_feat=torch.randn(6, 16, device=dev, generator=g)),
              torch.rand(3, 1536, device=dev, generator=g)) for _ in range(8)]
    alone = [win(*c) for c in calls]
    got, errors = {}, []

    def work(i):
        try:
            for j in range(i, len(calls), 4):
                got[j] = win(*calls[j])
        except Exception as e:  # noqa: BLE001 (reported by the main thread)
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads), errors
    torch.cuda.synchronize()
    assert all(torch.equal(got[j], alone[j]) for j in range(len(calls)))
    assert len(win._plans) == 1


def gelu(h):
    return h * 0.5 * (1.0 + torch.erf(h * 0.70710678118654752))


def gemm_case(dev, m, n, k, epi, seed=0):
    """One mdm_gemm launch against a.float() @ w.float() and the epilogue in
    PyTorch. Returns (error, scale of the reference)."""
    g = torch.Generator(dev).manual_seed(seed)
    a = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.randn(k, n, device=dev, generator=g) / k**0.5).to(torch.bfloat16)
    bias = torch.randn(n, device=dev, generator=g)
    out_f = torch.randn(m, n, device=dev, generator=g)
    out_h = torch.zeros(m, n, dtype=torch.bfloat16, device=dev)
    prev = out_f.clone()
    acc = a.float() @ w.float() + bias
    ca, cb = 0.75, -0.5
    ref = {mdm_cuda.EPI_STORE: acc, mdm_cuda.EPI_BIAS_BF16: acc.to(torch.bfloat16).float(),
           mdm_cuda.EPI_BIAS_GELU_BF16: gelu(acc).to(torch.bfloat16).float(),
           mdm_cuda.EPI_BIAS_RESIDUAL: prev + acc, mdm_cuda.EPI_DDIM: ca * prev + cb * acc}[epi]
    mdm_cuda._Launcher("block_stack", dev).gemm(
        a, w, epi, bias=bias, out_f=out_f, out_h=None if epi == mdm_cuda.EPI_STORE else out_h, ca=ca, cb=cb)
    torch.cuda.synchronize()
    to_h = epi in (mdm_cuda.EPI_BIAS_BF16, mdm_cuda.EPI_BIAS_GELU_BF16)
    out = out_h.float() if to_h else out_f
    if epi in (mdm_cuda.EPI_BIAS_RESIDUAL, mdm_cuda.EPI_DDIM):  # the bf16 copy of the f32 output
        assert torch.equal(out_h, out_f.to(torch.bfloat16))
    return (out - ref).abs().max().item(), ref.abs().max().item()


GEMM_ATOL = 2e-2  # one bf16 ulp of an output of size ~4 where the epilogue rounds; f32 sums in another order


@pytest.mark.parametrize("epi", range(5))
@pytest.mark.parametrize("m", [1, 160, 257])
def test_gemm_matches_reference_at_ragged_shapes(dev, m, epi):
    err, _ = gemm_case(dev, m, 136, 200, epi)
    assert err < GEMM_ATOL


# rows and columns for which the kernel picks each of its tiles (pick_tile in csrc/mdm_block.cu), ragged
@pytest.mark.parametrize("m,n", [(300, 256), (300, 1800), (1080, 1024), (2100, 1024)],
                         ids=["64x32", "64x64", "64x128", "128x128_two_warpgroups"])
def test_gemm_every_tile(dev, m, n):
    err, _ = gemm_case(dev, m, n, 512, mdm_cuda.EPI_STORE)
    assert err < 1e-3  # f32 out: only the order of the f32 sums differs


def test_layernorm_matches_plain(dev):
    g = torch.Generator(dev).manual_seed(7)
    x = torch.randn(77, 512, device=dev, generator=g) * 3 + 1
    scale, shift = torch.rand(512, device=dev, generator=g) + 0.5, torch.randn(512, device=dev, generator=g)
    out = torch.zeros(77, 512, dtype=torch.bfloat16, device=dev)
    mdm_cuda._Launcher("block_stack", dev).layernorm(x, scale, shift, out)
    torch.cuda.synchronize()
    # f32 rounding before the bf16 rounding: an element here and there lands one bf16 ulp of ~4 away
    assert (out.float() - mdm_cuda._layer_norm(x, scale, shift)).abs().max() < 4e-2


@pytest.mark.parametrize("b,t,d,heads", [(3, 32, 256, 4), (2, 20, 512, 4), (70, 32, 256, 4)])
def test_attention_matches_plain_softmax(dev, b, t, d, heads):
    g = torch.Generator(dev).manual_seed(6)
    qkv = torch.randn(b * t, 3 * d, device=dev, generator=g)
    out = torch.zeros(b * t, d, dtype=torch.bfloat16, device=dev)
    mdm_cuda._Launcher("block_stack", dev).attention(qkv, out, b, t, d, heads)
    torch.cuda.synchronize()
    hd = d // heads
    q, k, v = (qkv.reshape(b, t, 3, heads, hd)[:, :, i].transpose(1, 2) for i in range(3))
    ref = (torch.softmax((q * hd**-0.5) @ k.transpose(-1, -2), dim=-1) @ v).transpose(1, 2).reshape(b * t, d)
    assert (out.float() - ref).abs().max() < 2e-2  # the bf16 rounding of an output of size ~2


def test_kernels_refuse_a_plain_dict_of_weights(mdm, dev):
    w = dict(mdm_cuda.stack_block_weights(mdm))  # nowhere to keep the graphs
    with pytest.raises(TypeError, match="StackedWeights"):
        mdm_cuda.block_stack(torch.zeros(1, 32, SMALL.latent_dim, device=dev), w, num_heads=SMALL.num_heads)


def test_capture_leaves_other_threads_free_to_use_the_card(mdm, dev):
    """A thread that copies to the card and allocates there while another
    records a window's graph breaks neither."""
    import threading

    stop, errors = threading.Event(), []

    def other():
        try:
            while not stop.is_set():
                torch.zeros(1 << 20).to(dev).sum().item()
        except Exception as exc:  # noqa: BLE001 - reported to the test's thread
            errors.append(exc)

    thread = threading.Thread(target=other)
    thread.start()
    try:
        fused = mdm_cuda.FusedDDIMWindow(mdm, make_diffusion(steps=100, timestep_respacing="ddim4"))
        g = torch.Generator(dev).manual_seed(8)
        for b in (1, 2, 4, 6):  # four captures
            x_init, cond = window_inputs(b, g, dev)
            assert rel_err(fused(x_init, cond), fused.plain(x_init, cond)) < REL
    finally:
        stop.set()
        thread.join()
    assert not errors, errors


def test_kernels_refuse_f32_weights(mdm, dev):
    w = mdm_cuda.stack_block_weights(mdm, torch.float32)
    with pytest.raises(ValueError, match="bf16 weights"):
        mdm_cuda.block_stack(torch.zeros(1, 32, SMALL.latent_dim, device=dev), w, num_heads=SMALL.num_heads)


def rvq_inputs(case, n, q, k, d, dev, seed=3):
    """Rows and codebooks for one K3 case: random; every code duplicated
    (an exact tie at every row and layer, which the lower index must win);
    every other row equal to a code of the first layer (a distance near 0,
    which can round below it); or random rows in bf16 or in a strided view,
    which the wrapper takes as the CPU does."""
    g = torch.Generator(dev).manual_seed(seed)
    cb = torch.randn(q, k, d, device=dev, generator=g)
    x = torch.randn(n, d, device=dev, generator=g)
    if case == "duplicated_codes":
        cb[:, 1::2] = cb[:, 0::2]
    elif case == "rows_on_codes":
        x[::2] = cb[0, torch.randint(0, k, ((n + 1) // 2,), device=dev, generator=g)]
    elif case == "bf16_rows":
        x = x.bfloat16()
    elif case == "strided_rows":
        x = x.t().contiguous().t()
    return x, cb


def rvq_kernels_in_one_call(x, cb, out, idx):
    """The K3 kernels that one call runs on the card, by the profiler. The
    profiler now and then drops the records of kernels that ran: a session
    without any of a call's kernels, and sessions without one of two spin
    kernels launched around the call, whose result was right. So the call
    is framed by two spin kernels, its result must equal ``out`` and
    ``idx``, and a session that does not show both spin kernels is read
    again, up to five times. A session that shows both is the count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100)
            got = quantize_cuda.rvq_encode_fused(x, cb)
            torch.cuda._sleep(100)
            torch.cuda.synchronize()
        assert torch.equal(got[0], out) and torch.equal(got[1], idx)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in kernels if "spin_kernel" in e.key) == 2:
            return sum(e.count for e in kernels if "rvq_" in e.key)
    raise AssertionError("five profiler sessions in a row dropped a spin kernel's record")


@pytest.mark.parametrize("case", ["random", "duplicated_codes", "rows_on_codes", "bf16_rows", "strided_rows"])
@pytest.mark.parametrize("qkd", [(6, 512, 512), (4, 64, 128)], ids=["6x512x512", "4x64x128"])
@pytest.mark.parametrize("n", [1, 31, 300, 928, 1001, 4099])
def test_rvq_encode_kernel_matches_plain(dev, n, qkd, case):
    check_rvq_case(dev, n, qkd, case)


# the row count of two failures that were never diagnosed: every case again with other inputs
@pytest.mark.parametrize("case", ["random", "duplicated_codes", "rows_on_codes", "bf16_rows", "strided_rows"])
@pytest.mark.parametrize("repeat", range(5))
def test_rvq_encode_1001_rows_repeated(dev, repeat, case):
    check_rvq_case(dev, 1001, (6, 512, 512), case, seed=10 + repeat)


def check_rvq_case(dev, n, qkd, case, seed=3):
    """K3 against its plain version: indices, output, determinism, and the
    kernels of one call."""
    q, k, d = qkd
    x, cb = rvq_inputs(case, n, q, k, d, dev, seed)
    before = quantize_cuda.launches["rvq_encode"]
    out, idx = quantize_cuda.rvq_encode_fused(x, cb)
    torch.cuda.synchronize()
    assert quantize_cuda.launches["rvq_encode"] == before + 1  # one C call a call
    assert out.shape == (n, d) and idx.shape == (n, q) and idx.dtype == torch.int32
    if case == "duplicated_codes":
        assert bool((idx % 2 == 0).all())  # the lower of two equal codes, at every layer
        ref, ref_idx = quantize_cuda.rvq_encode_plain(x, cb[:, 0::2])
        ref_idx = 2 * ref_idx
    else:
        ref, ref_idx = quantize_cuda.rvq_encode_plain(x, cb)
    if case == "rows_on_codes":  # the row's own code, whatever the sign of its rounded distance
        assert torch.equal(cb[0, idx[::2, 0].long()], x[::2])
    agree = (idx == ref_idx).all(-1)
    assert agree.float().mean() > 0.98  # random rows: a near tie may flip one
    assert (out - ref)[agree].abs().max() <= 1e-4
    out2, idx2 = quantize_cuda.rvq_encode_fused(x, cb)  # no order of blocks shows in the result
    assert torch.equal(out, out2) and torch.equal(idx, idx2)
    assert rvq_kernels_in_one_call(x, cb, out, idx) == quantize_cuda.rvq_kernel_launches(q)


# the streaming session's decode rows a body part: the flush's tail ring (lookback + lookahead), the first
# window, the emitted span of a steady window, and a steady window's whole buffer (tail ring + 28 fresh)
@pytest.mark.parametrize("n", [24, 32, 44, 52])
def test_rvq_encode_at_stream_rows(dev, n):
    x, cb = rvq_inputs("random", n, 6, 512, 512, dev)
    out, idx = quantize_cuda.rvq_encode_fused(x, cb)
    ref, ref_idx = quantize_cuda.rvq_encode_plain(x, cb)
    assert quantize_cuda.rvq_plan(n, 6, 512, 512).grid == (16, -(-n // 32))
    assert torch.equal(idx, ref_idx)  # a few dozen random rows: no near tie to excuse a difference
    assert (out - ref).abs().max() <= 1e-4
    assert rvq_kernels_in_one_call(x, cb, out, idx) == quantize_cuda.rvq_kernel_launches(6)


def test_steady_stream_window_matches_plain(dev):
    """Two streamed windows (first, then steady) on the card against the same
    session on the CPU, which takes the kernels' plain versions with the
    same bf16 weights and noise: the latents within the kernels' tolerance,
    the window's decode through K3 and the convolutions against the plain
    decode of the same latents, and the launches exact."""
    import copy

    import numpy as np

    from syntalker_tpu_torch.data.stats import identity_pose_stats
    from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
    from syntalker_tpu_torch.ops.quantize import RVQConfig
    from syntalker_tpu_torch.streaming import StreamingMotionSession

    cfg = MDMConfig(latent_dim=256, ff_size=512, num_layers=2, num_heads=4, rope_heads=4, audio_feat_dim=16,
                    word_feat_dim=16, word_embed_dim=8, vocab_size=32)
    diffusion = make_diffusion(steps=100, timestep_respacing="ddim4")
    model = build_mdm(cfg, seed=1, device=dev)
    rvq = {part: build_rvqvae(RVQVAEConfig(input_dim=dim, width=64, depth=1, quantizer=RVQConfig(2, 64, 512)),
                              seed=20 + i, device=dev)
           for i, (part, dim) in enumerate((("upper", 78), ("hands", 180), ("lower", 57)))}
    noise = torch.randn(2, 1, 32, 1536, device=dev, generator=torch.Generator(dev).manual_seed(4))
    feats = np.random.default_rng(0).normal(0, 0.1, (533 * 240, 2)).astype(np.float32)

    def session(device, mdm, modules, noise):
        return StreamingMotionSession(mdm=mdm, diffusion=diffusion, rvq_modules=modules,
                                      stats=identity_pose_stats(), noise=noise, device=device)

    cpu = session("cpu", copy.deepcopy(model).cpu(),
                  {p: (copy.deepcopy(m).cpu(), type(s)(s.codebook.cpu())) for p, (m, s) in rvq.items()}, noise.cpu())
    card = session(dev, model, rvq, noise)
    before = (mdm_cuda.launches["ddim_window"], quantize_cuda.launches["rvq_encode"])
    segs = card.push_audio(feats)
    torch.cuda.synchronize()
    plan = mdm_cuda.window_launches(cfg.num_layers, 4)
    # the first window captures K1's graph (a real pass, then the replay); the steady window replays it
    assert mdm_cuda.launches["ddim_window"] - before[0] == 3 * plan
    assert quantize_cuda.launches["rvq_encode"] - before[1] == 2 * 3
    assert [len(s["axis_angle"]) for s in segs] == [96, 112]
    cpu.push_audio(feats)
    for name in ("seed", "tail"):
        assert rel_err(card._state[name].cpu(), cpu._state[name]) < REL, name
    with torch.no_grad():
        dec = card._decode(card._state["tail"])
        ref = cpu._decode(card._state["tail"].cpu())
    for part, value in dec["parts"].items():
        assert rel_err(value.cpu(), ref["parts"][part]) < 1e-4, part


def test_generate_clip_on_the_card_matches_plain(dev, tmp_path):
    """The port's ``generate_clip`` at a tiny width on the card with two text
    prompts (four guidance branches in one K2 call a step) against the same
    clip on the plain f32 ``MDM.denoise``; exact K2 and K3 counts."""
    import json

    import numpy as np
    from scipy.io import wavfile

    from syntalker_tpu_torch.cli import generate as GEN
    from syntalker_tpu_torch.config import load_config

    g = np.random.default_rng(0)
    wavfile.write(str(tmp_path / "x.wav"), 44100, (g.normal(0, 0.2, (44100 * 9, 2)).clip(-1, 1) * 32767).astype(np.int16))
    (tmp_path / "vocab.json").write_text(json.dumps({"name": "w", "word2index": {"wave": 4}, "word2count": {"wave": 1}}))
    cfg = load_config("configs/diffusion_h3d.yaml", [
        "mdm.latent_dim=256", "mdm.ff_size=512", "mdm.num_layers=2", "mdm.rope_heads=4", "mdm.audio_feat_dim=16",
        "mdm.word_feat_dim=16", "mdm.word_embed_dim=8", "mdm.vocab_size=32", "rvq_width=64", "rvq_depth=1",
        "diffusion.timestep_respacing=ddim4", f"data.vocab_path={tmp_path / 'vocab.json'}"])
    models = GEN.load_models(cfg, dev)
    mdm = models[0]
    prompts = {"upper": "raise both arms", "lower": "step left"}

    def clip(denoise):
        return GEN.generate_clip(cfg, tmp_path / "x.wav", transcript="wave wave", prompts=prompts, denoise=denoise,
                                 generator=torch.Generator(dev).manual_seed(1), models=models, device=dev)

    kernel = mdm_cuda.make_fused_denoise(mdm, mdm_cuda.stack_block_weights(mdm))
    clip(kernel)  # captures the guided window's graph
    before = (mdm_cuda.launches["guided_window"], quantize_cuda.launches["rvq_encode"], mdm_cuda.launches["block_stack"])
    out = clip(kernel)
    torch.cuda.synchronize()
    windows = 2  # 270 frames
    assert mdm_cuda.launches["guided_window"] - before[0] == windows * mdm_cuda.guided_window_launches(2, 4)
    assert quantize_cuda.launches["rvq_encode"] - before[1] == 3
    assert mdm_cuda.launches["block_stack"] == before[2]  # K2 runs inside the window's graph
    ref = clip(lambda x, t_emb, cond: mdm.denoise(x, None, cond, t_emb=t_emb, dtype=torch.float32))
    assert out["npz"]["poses"].shape == (240, 165) and np.isfinite(out["npz"]["poses"]).all()
    assert rel_err(out["latents"], ref["latents"]) < 5e-2


def test_h3d_generate_clip_on_the_card_matches_plain(dev, tmp_path, monkeypatch):
    """``H3DEvaluator.generate_clip`` at a tiny width on the card with an
    upper-body prompt (three guidance branches in one K2 call a step, the
    decode through K3) against the same clip on the plain f32
    ``MDM.denoise``: the sampled latents (the decode's snap is
    discontinuous, so the decode is not compared); exact K2 and K3 counts,
    and the oracle's embedding of the generated motion on the card against
    the CPU."""
    import numpy as np

    from syntalker_tpu_torch.eval import harness_h3d

    from syntalker_tpu_torch.data.beat_builder import build_beat_cache
    from syntalker_tpu_torch.data.h3d import H3D_PART_DIMS
    from syntalker_tpu_torch.data.stats import identity_h3d_stats
    from syntalker_tpu_torch.data.synthetic import make_corpus
    from syntalker_tpu_torch.eval.harness_h3d import H3DEvaluator
    from syntalker_tpu_torch.eval.t2m import T2MEvaluator
    from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
    from syntalker_tpu_torch.models.tmr import TextPipeline, TMRConfig
    from syntalker_tpu_torch.ops.quantize import RVQConfig
    from syntalker_tpu_torch.ops.smplx import synthetic_smplx_model

    make_corpus(tmp_path / "corpus", speakers=(2,), clips_per_speaker=1, test_fraction=1.0, seconds_range=(8.0, 8.5))
    cache, _ = build_beat_cache(tmp_path / "corpus", tmp_path / "cache", split="test", speakers=(2,),
                                smplx_model=synthetic_smplx_model(device=dev))
    cfg = MDMConfig(latent_dim=256, ff_size=512, num_layers=2, num_heads=4, rope_heads=4, audio_feat_dim=16,
                    word_feat_dim=16, word_embed_dim=8, vocab_size=32, use_prompt=True, prompt_dim=16)
    model = build_mdm(cfg, seed=1, device=dev)
    rvq = {part: build_rvqvae(RVQVAEConfig(input_dim=H3D_PART_DIMS[part], width=64, depth=1,
                                           quantizer=RVQConfig(2, 64, 512)), seed=20 + i, device=dev)
           for i, part in enumerate(("upper", "hands", "lower"))}
    oracle = T2MEvaluator.from_artifact(device=dev)

    def evaluator(denoise=None):
        return H3DEvaluator(mdm=model, diffusion=make_diffusion(steps=100, timestep_respacing="ddim4"),
                            rvq_modules=rvq, h3d_stats=identity_h3d_stats(),
                            text_pipeline=TextPipeline(TMRConfig(latent_dim=16, ff_size=32, num_layers=1, num_heads=2),
                                                       device=dev),
                            t2m_evaluator=oracle, denoise=denoise, device=dev)

    latents = []
    decode = harness_h3d.G.decode_latents_h3d
    monkeypatch.setattr(harness_h3d.G, "decode_latents_h3d", lambda lat, **kw: latents.append(lat) or decode(lat, **kw))
    card = evaluator()
    plain = evaluator(lambda x, t_emb, cond: model.denoise(x, None, cond, t_emb=t_emb, dtype=torch.float32))
    sample = cache.get(0)
    plan = card.plan(sample)
    noise = card.clip_noise((0, 0, 0), plan)
    prompts = {"upper": "raise both arms"}
    card.generate_clip(sample, noise, prompts=prompts)  # captures the guided window's graph at three branches
    before = (mdm_cuda.launches["guided_window"], quantize_cuda.launches["rvq_encode"])
    out = card.generate_clip(sample, noise, prompts=prompts)
    torch.cuda.synchronize()
    assert mdm_cuda.launches["guided_window"] - before[0] == plan.num_windows * mdm_cuda.guided_window_launches(2, 4)
    assert quantize_cuda.launches["rvq_encode"] - before[1] == 3
    ref = plain.generate_clip(sample, noise, prompts=prompts)
    assert out["features"].shape == ref["features"].shape == (out["n_frames"], 623)
    assert np.isfinite(out["joints"]).all()
    assert rel_err(latents[1], latents[2]) < 5e-2  # bf16 weights and matmul inputs against f32, 4 steps
    n = np.asarray([out["n_frames"]])
    emb = oracle.get_motion_embeddings(out["features"][None], n)
    cpu = T2MEvaluator.from_artifact(device="cpu").get_motion_embeddings(out["features"][None], n)
    assert rel_err(torch.as_tensor(emb), torch.as_tensor(cpu)) < 1e-5
