"""The guided DDIM window (``mdm_cuda.GuidedDDIMWindow``) on the CPU: its
plain version, reached through ``sample_windows`` with the card's dispatch
forced, against the step loop of ``diffusion.core`` that the CPU keeps
(K2's plain version with f32 weights on both sides, so the two differ only
in the order of f32 sums); the branch weights against the body-part
combinator; and the dispatch, which leaves the CPU, DDPM and a caller's own
denoiser on the step loop. The file imports no JAX. The graph itself is
held against the eager sampler on the card in
``tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch.data import joints as J
from syntalker_tpu_torch.diffusion import cfg as CFG_FNS
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import Conditioning, MDMConfig, build_mdm
from syntalker_tpu_torch.ops import mdm_cuda
from syntalker_tpu_torch.utils import tracking

from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

P = S = 8  # prompt and style widths
CFG = MDMConfig(latent_dim=32, ff_size=64, num_layers=2, num_heads=2, rope_heads=4, audio_feat_dim=16,
                word_feat_dim=16, word_embed_dim=8, vocab_size=50, use_prompt=True, prompt_dim=P,
                use_motionclip=True, style_dim=S, audio_norm="batch")
STEPS = 6
REL = 2e-5  # f32 sums in another order: hoisted products, split concats, the two-coefficient update


@pytest.fixture(scope="module")
def setup():
    mdm = build_mdm(CFG, seed=3, device="cpu")
    with torch.no_grad():  # BatchNorm's running statistics away from their 0/1 start
        for m in mdm.modules():
            if hasattr(m, "running_mean"):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
        mdm.uncond_prompt_embedding.normal_()
    diffusion = make_diffusion(steps=100, timestep_respacing=f"ddim{STEPS}")
    plan = G.plan_windows(240)  # 2 windows: the seed carry
    b = 2
    g = np.random.default_rng(4)
    audio = g.normal(0, 0.1, (b, 533 * 240, 2)).astype(np.float32)
    words = g.integers(0, CFG.vocab_size, (b, 240))
    tg = torch.Generator().manual_seed(7)
    data = dict(aw=torch.as_tensor(G.window_audio(audio, plan)), ww=torch.as_tensor(G.window_words(words, plan)),
                seed=torch.randn(b, plan.pre_frames, J.LATENT_DIM, generator=tg),
                noise=G.draw_noise(plan, b, tg, "cpu"),
                prompts={p: torch.randn(b, P, generator=tg) for p in J.LATENT_SLICES},
                style=torch.randn(b, S, generator=tg))
    denoise = mdm_cuda.make_fused_denoise(mdm, mdm_cuda.stack_block_weights(mdm, torch.float32))
    return mdm, diffusion, plan, data, denoise


def run(setup, parts, style=False, sampler="ddim", denoise=None, guidance=None, step_noise=None):
    mdm, diffusion, plan, d, default = setup
    prompts = None if parts is None else {p: d["prompts"][p] for p in parts}
    return G.sample_windows(mdm, diffusion, plan, d["aw"], d["ww"], d["seed"], d["noise"], sampler=sampler,
                            prompts=prompts, guidance=guidance or {"audio_scale": 1.0, "prompt_scale": 4.0},
                            style=d["style"] if style else None, denoise=denoise or default, step_noise=step_noise)


def rel_err(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


CASES = {  # name -> (prompted parts or None, style, guidance): K = 1, 3, 4, 5 branches
    "k1-unprompted": (None, False, None),
    "k3-upper": (("upper",), False, None),
    "k4-hands+lower": (("hands", "lower"), False, None),
    "k5-all-parts": (("upper", "hands", "lower"), False, {"audio_scale": 1.5, "prompt_scale": 2.5}),
    "k3-hands+style": (("hands",), True, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_window_matches_the_step_loop(setup, case, monkeypatch):
    """``sample_windows(sampler="ddim")`` through the guided window's plain
    version (the branches stacked once a window, the (K, C) weights, the
    hoisted products) against the same call on the step loop."""
    parts, style, guidance = CASES[case]
    ref = run(setup, parts, style, guidance=guidance)
    monkeypatch.setattr(G, "_on_card", lambda x: True)  # the CPU window runs its plain version
    calls = []
    orig = mdm_cuda.GuidedDDIMWindow.plain
    monkeypatch.setattr(mdm_cuda.GuidedDDIMWindow, "plain", lambda *a: calls.append(a[3].shape[0]) or orig(*a))
    out = run(setup, parts, style, guidance=guidance)
    plan = setup[2]
    assert calls == [1 if parts is None else 2 + len(parts)] * plan.num_windows
    assert out.shape == ref.shape == (2, plan.out_latent_frames, J.LATENT_DIM)
    assert rel_err(out, ref) < REL, case


@pytest.mark.parametrize("parts", [(), ("upper",), ("hands",), ("hands", "lower"), ("upper", "hands", "lower")])
def test_branch_weights_mix_as_the_combinator(parts):
    """Σ_k W[k] ⊙ out_k with ``bodypart_branch_weights`` equals
    ``make_bodypart_cfg_model_fn``'s result on the same branch outputs."""
    g = torch.Generator().manual_seed(len(parts))
    k = 2 + len(parts)
    outs = torch.randn(k, 2, 3, J.LATENT_DIM, generator=g)
    conds = [Conditioning(torch.full((2, 1), float(i)), torch.zeros(2, 1)) for i in range(k)]

    def denoise_fn(x, t, cond):  # branch i's rows carry i in at_feat
        return torch.cat([outs[int(cond.at_feat[r, 0])][r % 2][None] for r in range(cond.at_feat.shape[0])])

    part_conds = {p: conds[2 + i] for i, p in enumerate(parts)}
    scales = {"audio_scale": 1.25, "prompt_scale": 3.5}
    ref = CFG_FNS.make_bodypart_cfg_model_fn(denoise_fn, conds[1], conds[0], part_conds, **scales)(
        torch.zeros(2, 3, J.LATENT_DIM), torch.zeros(2))
    branches, index = CFG_FNS.bodypart_branches(conds[1], conds[0], part_conds)
    assert branches == conds
    w = CFG_FNS.bodypart_branch_weights(index, J.LATENT_DIM, **scales)
    assert w.shape == (k, J.LATENT_DIM) and torch.allclose(w.sum(0), torch.ones(J.LATENT_DIM))
    assert torch.allclose((w[:, None, None] * outs).sum(0), ref, atol=1e-5)


@pytest.mark.parametrize("route", ["cpu", "ddpm", "own-denoise", "card-ddim"])
def test_dispatch_keeps_the_step_loop_where_the_graph_cannot_serve(setup, route, monkeypatch):
    """The CPU, DDPM (its per-step noise) and a caller's own ``denoise`` run
    ``diffusion.core.sample``; an η=0 DDIM window on the default K2
    denoiser with its tensors on the card runs the guided window, one call
    a window, in a ``sample.window`` span of path ``guided_graph``."""
    mdm, diffusion, plan, d, default = setup
    loops, windows = [], []
    sample = G.sample
    monkeypatch.setattr(G, "sample", lambda *a, **kw: loops.append(kw["method"]) or sample(*a, **kw))
    call = mdm_cuda.GuidedDDIMWindow.__call__
    monkeypatch.setattr(mdm_cuda.GuidedDDIMWindow, "__call__", lambda *a: windows.append(1) or call(*a))
    if route != "cpu":
        monkeypatch.setattr(G, "_on_card", lambda x: True)
    kw = {}
    if route == "ddpm":
        kw = dict(sampler="ddpm", step_noise=lambda w, it: torch.zeros(2, plan.latent_window, J.LATENT_DIM))
    if route == "own-denoise":
        kw = dict(denoise=lambda x, t_emb, cond: default(x, t_emb, cond))
    tracking.enable()
    try:
        run(setup, ("upper",), **kw)
    finally:
        tracking.disable()
        got = tracking.drain()
    paths = [s.attrs["path"] for s in got["spans"] if s.name == "sample.window"]
    steps = sum(s.name == "sample.step" for s in got["spans"])
    if route == "card-ddim":
        assert (loops, len(windows), steps) == ([], plan.num_windows, 0)
        assert paths == ["guided_graph"] * plan.num_windows
    else:
        assert (loops, windows) == ([kw.get("sampler", "ddim")] * plan.num_windows, [])
        assert paths == ["guided"] * plan.num_windows and steps == plan.num_windows * STEPS


def test_guided_window_is_kept_with_the_weights(setup):
    """One window a schedule on a model's K2 weights, found again by the
    dispatch; another schedule gets its own."""
    mdm, diffusion, plan, d, default = setup
    fn = G.make_denoise_fn(mdm, diffusion, default)
    noise = d["noise"]
    assert G.guided_window_for(mdm, diffusion, fn, noise, "ddim") is None  # the CPU
    win = mdm_cuda.guided_ddim_window(mdm, diffusion, default.weights)
    assert win is mdm_cuda.guided_ddim_window(mdm, diffusion, default.weights)
    assert win is not mdm_cuda.guided_ddim_window(mdm, make_diffusion(steps=100, timestep_respacing="ddim4"),
                                                   default.weights)
    assert len(win.coef_a) == STEPS and win.t_embs.shape == (STEPS, CFG.latent_dim)
