"""The mesh forms on the card: a sharded flush through K1, K2 (unprompted
and a prompted group) and K3 on a ``data=2`` mesh of ``[cuda:0, cuda:0]``,
and, with two or more cards, the kernels' device guard (each runs on its
tensors' card while another card is current).

Every test needs a CUDA device and skips without one; the guard tests skip
with fewer than two cards. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel_cuda.py

Sharded against the unsharded service at a shard's batch, on the same
requests and noise: 1e-6 absolute on the latents (the same operations at
the same shapes). Against the whole batch in one call the path is not
batch-free: cuBLAS's f32 linears (the seed embedding, K2's projections)
sum in another order at another row count, and bf16 rounding magnifies
that (``chip_smoke.py`` reports it). Latents are compared, not decodes (a
snap can flip near a tie)."""

import numpy as np
import pytest
import torch

from syntalker_tpu_torch import generation
from syntalker_tpu_torch.data.stats import identity_pose_stats
from syntalker_tpu_torch.diffusion.schedule import make_diffusion
from syntalker_tpu_torch.models.denoiser import Conditioning, MDMConfig, build_mdm
from syntalker_tpu_torch.models.rvqvae import RVQVAEConfig, build_rvqvae
from syntalker_tpu_torch.ops import mdm_cuda, quantize_cuda
from syntalker_tpu_torch.ops.quantize import RVQConfig
from syntalker_tpu_torch.parallel.mesh import make_mesh
from syntalker_tpu_torch.serving import MotionGenerationService, MotionRequest

pytestmark = pytest.mark.cuda

SMALL = MDMConfig(latent_dim=256, ff_size=512, num_layers=2, num_heads=4, rope_heads=4, audio_feat_dim=16,
                  word_feat_dim=16, word_embed_dim=8, vocab_size=32, use_prompt=True, prompt_dim=32)
SHARDED_ABS = 1e-6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def models(dev):
    q = RVQConfig(num_quantizers=2, nb_code=32, code_dim=512)
    rvq = {part: build_rvqvae(RVQVAEConfig(input_dim=dim, width=64, depth=1, quantizer=q), seed=i, device=dev)
           for i, (part, dim) in enumerate((("upper", 78), ("hands", 180), ("lower", 57)))}
    return build_mdm(SMALL, seed=0, device=dev), rvq


def requests(prompted: bool, seed: int):
    g = np.random.default_rng(seed)
    return [MotionRequest(audio=g.normal(0, 0.1, 16000 * 3).astype(np.float32), request_id=f"r{i}",
                          prompts={"upper": g.normal(size=SMALL.prompt_dim).astype(np.float32)} if prompted else None)
            for i in range(4)]


def flush(models, fused_loop, prompted, mesh, max_batch, noise, monkeypatch):
    """A cold flush (graph captures), then the four requests in flushes of
    ``max_batch``, each on its slice of ``noise``: the real requests'
    latents and the warm flushes' kernel counts."""
    mdm, rvq = models
    svc = MotionGenerationService(mdm=mdm, diffusion=make_diffusion(steps=8), rvq_modules=rvq,
                                  stats=identity_pose_stats(), max_batch=max_batch, max_seconds=128 / 30,
                                  fused_loop=fused_loop, seed=3, mesh=mesh, device=noise.device)
    for r in requests(prompted, 4)[:max_batch]:
        svc.submit(r)
    svc.flush()
    queue, seen = [], []
    draw, decode = generation.draw_noise, generation.decode_latents
    monkeypatch.setattr(generation, "draw_noise", lambda *a: queue.pop(0))
    monkeypatch.setattr(generation, "decode_latents", lambda lat, **kw: seen.append(lat.clone()) or decode(lat, **kw))
    before = {**mdm_cuda.launches, **quantize_cuda.launches}
    reqs = requests(prompted, 5)
    for lo in range(0, 4, max_batch):
        queue.append(noise[:, lo : lo + max_batch].contiguous())
        for r in reqs[lo : lo + max_batch]:
            svc.submit(r)
        assert all(np.isfinite(r.axis_angle).all() for r in svc.flush())
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in {**mdm_cuda.launches, **quantize_cuda.launches}.items()}
    monkeypatch.setattr(generation, "draw_noise", draw)
    monkeypatch.setattr(generation, "decode_latents", decode)
    return torch.cat(seen), counts


@pytest.mark.parametrize("fused_loop,prompted", [(True, False), (False, False), (True, True)],
                         ids=["k1", "k2", "prompted"])
def test_sharded_flush_on_one_card_matches_the_service_at_a_shards_batch(models, dev, fused_loop, prompted,
                                                                        monkeypatch):
    """A data=2 flush on [cuda:0, cuda:0] against the unsharded service at a
    shard's batch flushing the same requests and noise two by two: the same
    kernels at the same shapes, bit for bit; exact counts on the warm
    sharded flush."""
    noise = torch.randn(1, 4, 32, 1536, generator=torch.Generator(dev).manual_seed(6), device=dev)
    mesh = make_mesh(2, 1, devices=[dev, dev])
    sharded, counts = flush(models, fused_loop, prompted, mesh, 4, noise, monkeypatch)
    pairs, _ = flush(models, fused_loop, prompted, None, 2, noise, monkeypatch)
    assert sharded.shape == pairs.shape == (4, 32, 1536)
    assert (sharded - pairs).abs().max().item() <= SHARDED_ABS
    windows, steps, layers = 1, 8, SMALL.num_layers
    k1 = not prompted and fused_loop
    assert counts["ddim_window"] == (2 * windows * mdm_cuda.window_launches(layers, steps) if k1 else 0)
    # the prompted group's windows replay the guided window's graph, with K2's launches inside it
    assert counts["block_stack"] == (2 * windows * steps * mdm_cuda.block_launches(layers) if not fused_loop else 0)
    assert counts["guided_window"] == (2 * windows * mdm_cuda.guided_window_launches(layers, steps) if prompted else 0)
    assert counts["rvq_encode"] == 2 * 3  # two shards, three parts


@pytest.fixture(scope="module")
def two_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("the device guard needs two cards")
    return torch.device("cuda", 1)


def test_kernels_run_on_their_tensors_card(models, dev, two_cards):
    """K2, K1 and K3 on cuda:1 while cuda:0 is current give what they give
    on cuda:0, and their graphs are the second card's."""
    mdm, rvq = models
    other = build_mdm(SMALL, seed=0, device=two_cards)
    torch.cuda.set_device(dev)
    x = torch.randn(3, 32, SMALL.latent_dim, generator=torch.Generator().manual_seed(1))
    rows = torch.randn(96, 512, generator=torch.Generator().manual_seed(3))
    outs = {}
    for m in (mdm, other):
        d = m.input_process.weight.device
        w = mdm_cuda.stack_block_weights(m)
        k2 = mdm_cuda.block_stack(x.to(d), w, num_heads=SMALL.num_heads)
        assert list(w.plans)[0][0] == d
        fused = mdm_cuda.FusedDDIMWindow(m, make_diffusion(steps=8))
        cond = Conditioning(at_feat=torch.ones(3, 32, SMALL.audio_feat_dim, device=d),
                            seed_emb=torch.zeros(3, SMALL.latent_dim, device=d))
        k1 = fused(torch.randn(3, 32, 1536, generator=torch.Generator().manual_seed(2)).to(d), cond)
        k3 = quantize_cuda.rvq_encode_fused(rows.to(d), rvq["upper"][1].codebook.to(d))
        outs[d] = {"k2": k2.cpu(), "k1": k1.cpu(), "k3": k3[0].cpu(), "k3_indices": k3[1].cpu()}
    assert torch.cuda.current_device() == 0
    first, second = outs.values()
    for name, a in first.items():
        assert torch.equal(a, second[name]), (name, (a.float() - second[name].float()).abs().max().item())
