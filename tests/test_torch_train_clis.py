"""The train CLIs end to end, the decode without translation and the
tracking utilities, against the JAX package on the CPU.

``cli.train_rvq`` for the three parts and ``cli.train`` run end to end with
``--device cpu`` at a tiny width on a synthetic corpus, and ``generate``
reads their checkpoints; ``decode_latents(use_trans=False)`` holds JAX's
decoded parts to 1e-5 and its rot6d and axis-angle to 1e-3 absolute;
``utils/tracking.py`` gives JAX's seeds, epoch summaries, history and trial
files. The trainers' loops against JAX's are in
``test_torch_train_loop.py``, whose corpus fixture and tiny widths these
tests share."""

import jax
import numpy as np
import torch

from syntalker_tpu import generation as JG
from syntalker_tpu.data.stats import identity_pose_stats as jax_identity_stats
from syntalker_tpu_torch import bridge
from syntalker_tpu_torch import generation as G
from syntalker_tpu_torch.cli import generate as GEN
from syntalker_tpu_torch.cli import train as TRAIN
from syntalker_tpu_torch.cli import train_rvq as TRAIN_RVQ
from syntalker_tpu_torch.config import load_config
from syntalker_tpu_torch.data.stats import identity_pose_stats
from syntalker_tpu_torch.data.vocab import Vocab
from syntalker_tpu_torch.models import rvqvae as PR
from syntalker_tpu_torch.train import state as PS

from test_torch_train_loop import TINY_MDM, corpus  # noqa: F401  (the corpus fixture)
from test_torch_train_rvq import close
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)


# ---------------------------------------------------------------------------
# decode without translation, the CLIs end to end
# ---------------------------------------------------------------------------


def test_decode_latents_without_translation_is_jaxs():
    import jax.numpy as jnp

    from syntalker_tpu.models.rvqvae import RVQVAEConfig as JaxRVQVAEConfig
    from syntalker_tpu.models.rvqvae import create_rvqvae
    from syntalker_tpu.ops.quantize import RVQConfig as JaxRVQConfig
    from syntalker_tpu_torch.ops.quantize import RVQConfig

    jstack, pstack = {}, {}
    g = np.random.default_rng(4)
    for i, (part, dim) in enumerate((("upper", 78), ("hands", 180), ("lower", 54))):
        q = dict(num_quantizers=2, nb_code=8, code_dim=512)  # the latent's fixed 512-wide part slices
        jm, params, js = create_rvqvae(JaxRVQVAEConfig(input_dim=dim, width=16, output_emb_width=512, depth=1,
                                                       quantizer=JaxRVQConfig(**q)), jax.random.PRNGKey(i))
        cb = g.normal(size=(2, 8, 512)).astype(np.float32)
        jstack[part] = (jm, params, js.replace(codebook=jnp.asarray(cb), initialized=jnp.asarray(True)))
        pstack[part] = bridge.rvqvae_from_flax(PR.RVQVAEConfig(input_dim=dim, width=16, output_emb_width=512, depth=1,
                                                               quantizer=RVQConfig(**q)), params, cb, device="cpu")
    lat = (g.normal(size=(1, 6, 1536)) / 5).astype(np.float32)
    ref = JG.decode_latents(jnp.asarray(lat), rvq_modules=jstack, stats=jax_identity_stats(), use_trans=False)
    got = G.decode_latents(torch.as_tensor(lat), rvq_modules=pstack, stats=identity_pose_stats(), use_trans=False)
    assert got["trans"] is None and ref["trans"] is None and got["parts"]["lower"].shape == (1, 24, 54)
    # the decoded parts to 1e-5 (f32 convolution order); rot6d and axis-angle to 1e-3 absolute, as in
    # test_torch_decode_reach.py: rot6d's Gram-Schmidt amplifies the parts' f32 differences
    for name in ("upper", "hands", "lower"):
        close(got["parts"][name].numpy(), ref["parts"][name], rel=1e-5, msg=name)
    for k in ("rot6d", "axis_angle"):
        close(got[k].numpy(), ref[k], rel=0.0, atol=1e-3, msg=k)


def test_train_clis_end_to_end_and_generate_reads_them(corpus, tmp_path):
    common = [f"data.data_path={corpus}", f"data.cache_path={tmp_path / 'cache'}", f"train.ckpt_dir={tmp_path / 'ck'}",
              "data.training_speakers=[2,4]", "train.log_period=2", "train.device_data=true",
              "rvq_width=16", "rvq_depth=1"]  # generate decodes 1536-d latents: the full code width
    run = ["--device", "cpu", "--run-dir", str(tmp_path / "run")]
    paths = []
    for part in ("upper", "hands", "lower"):
        tr = TRAIN_RVQ.main(["-c", "configs/rvq_beat2.yaml", *run, f"rvq_train.body_part={part}",
                             "rvq_train.batch_size=8", "rvq_train.total_iters=2", "rvq_train.save_every=1000",
                             *common])
        assert all(v.device.type == "cpu" for v in tr._dataset.arrays.values()) and tr.state.step == 2
        paths.append(tmp_path / "ck" / f"rvq_{part}" / "step_2.npz")
        assert paths[-1].exists()
    vocab_path = tmp_path / "cache_rvq" / "vocab.json"  # the RVQ cache's, of the same TextGrids
    mdm = [*TINY_MDM, f"mdm.vocab_size={Vocab.load(vocab_path).n_words}", "train.batch_size=8", "train.epochs=2",
           "train.test_period=1", "diffusion.steps=50", f"data.vocab_path={vocab_path}"]
    rvq_ckpts = f"rvq_ckpts=[{','.join(map(str, paths))}]"
    tr = TRAIN.main(["-c", "configs/diffusion_beat2.yaml", *run, rvq_ckpts, *mdm, *common])
    per_epoch = len(tr.loader)
    ckpt = tmp_path / "ck" / f"step_{2 * per_epoch}.npz"
    assert ckpt.exists() and (tmp_path / "ck" / f"step_{per_epoch}.npz").exists()
    assert np.isfinite([h["loss"] for h in tr.history]).all()
    # the trained RVQ-VAEs are the ones the denoiser's featurizer read
    raw = PS.load_checkpoint_npz(paths[2], skip=PS.TRAIN_ONLY_KEYS)
    np.testing.assert_array_equal(tr.rvq["lower"][1].codebook.numpy(), raw["quantizer_state"]["codebook"])

    wav = next((corpus / "wave16k").glob("2_*.wav"))
    out = tmp_path / "gen.npz"
    res = GEN.main(["-c", "configs/diffusion_beat2.yaml", "--wav", str(wav), "--out", str(out), *run,
                    f"test_ckpt={ckpt}", rvq_ckpts, *mdm, *common, "diffusion.timestep_respacing=ddim4"])
    with np.load(out) as f:
        poses, trans = f["poses"], f["trans"]
    assert poses.shape[1] == 165 and trans.shape == (poses.shape[0], 3) and poses.shape[0] >= 200
    assert np.isfinite(poses).all() and np.isfinite(trans).all()
    # generate's denoiser is the trained one
    mdm_loaded = GEN.load_models(load_config("configs/diffusion_beat2.yaml", [f"test_ckpt={ckpt}", rvq_ckpts, *mdm,
                                                                              *common]), "cpu")[0]
    torch.testing.assert_close(mdm_loaded.word_embedding, tr.mdm.word_embedding, rtol=0, atol=0)
    assert res["latents"].shape[-1] == 1536


# ---------------------------------------------------------------------------
# tracking
# ---------------------------------------------------------------------------


def test_tracking_is_jaxs(tmp_path):
    import random

    from syntalker_tpu.utils import tracking as JT
    from syntalker_tpu_torch.utils import tracking as PT

    draws = []
    for mod in (PT, JT):
        mod.set_random_seed(7)
        draws.append((random.random(), np.random.rand()))
    assert draws[0] == draws[1]
    trackers = [PT.EpochTracker({"bc": True}), JT.EpochTracker({"bc": True})]
    for epoch, values in enumerate(((0.5, 2.0), (0.25, 3.0), (0.75, 1.0))):
        for t in trackers:
            t.update("loss", "train", values[0], n=2)
            t.update("bc", "test", values[1])
            t.update("loss", "train", values[0] / 2)
        assert trackers[0].end_epoch(epoch) == trackers[1].end_epoch(epoch)
    trackers[0].save_history(tmp_path / "p.json")
    trackers[1].save_history(tmp_path / "j.json")
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    for name, mod in (("p", PT), ("j", JT)):
        for row in ({"lr": 1e-4, "fid": 0.5}, {"lr": 2e-4, "fid": 0.25}):
            mod.record_trial(tmp_path / name / "trials.csv", row)
    assert (tmp_path / "p" / "trials.csv").read_bytes() == (tmp_path / "j" / "trials.csv").read_bytes()
    meter = PT.AverageMeter()
    meter.update(2.0, n=3)
    meter.update(6.0)
    assert meter.avg == 3.0 and meter.count == 4
    meter.reset()
    assert meter.avg == 0.0
    timer = PT.StepTimer()
    timer.mark_data()
    timer.mark_step()
    assert timer.data_s >= 0 and timer.step_s >= 0
    with PT.profile_trace(tmp_path / "trace"):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with PT.profile_trace(tmp_path / "off", enabled=False):
        pass
    assert not (tmp_path / "off").exists()
