"""The port's ``generate`` CLI against the JAX package on the CPU: npz
checkpoints into the MDM (stacked and legacy flat qkv) and the RVQ stack;
``generate_clip`` against the same steps of ``syntalker_tpu.cli.generate``
composed in JAX with the same weights (written as npz the way README.md
says) and JAX's own noise; ``main()`` writing the JAX CLI's npz. Audio is a
synthetic 44.1 kHz stereo int16 wav, words a TextGrid or a transcript."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from syntalker_tpu import config as JC
from syntalker_tpu import generation as JG
from syntalker_tpu.cli import generate as jax_cli
from syntalker_tpu.data import audio as JA
from syntalker_tpu.data.stats import load_pose_stats as jax_load_pose_stats
from syntalker_tpu.data.textgrid import words_tier as jax_words_tier
from syntalker_tpu.data.vocab import Vocab as JaxVocab
from syntalker_tpu.data.vocab import words_to_frame_ids as jax_words_to_frame_ids
from syntalker_tpu.diffusion.schedule import make_diffusion as jax_make_diffusion
from syntalker_tpu.models import tmr as JTMR
from syntalker_tpu.models.denoiser import create_mdm
from syntalker_tpu.models.denoiser import migrate_qkv_kernels as jax_migrate
from syntalker_tpu.train.loop import load_rvq_stack as jax_load_rvq_stack
from syntalker_tpu_torch import config as PC
from syntalker_tpu_torch.cli import generate as port_cli
from syntalker_tpu_torch.models import tmr as PTMR
from syntalker_tpu_torch.models.denoiser import Conditioning, migrate_qkv_kernels
from syntalker_tpu_torch.ops import mdm_cuda
from syntalker_tpu_torch.train import state as PS
from syntalker_tpu_torch.train.loop import load_rvq_stack

from test_torch_prompted_sampling import jax_noise
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

TINY = ["mdm.latent_dim=32", "mdm.ff_size=64", "mdm.num_layers=2", "mdm.num_heads=2", "mdm.rope_heads=4",
        "mdm.audio_feat_dim=16", "mdm.word_feat_dim=16", "mdm.word_embed_dim=8", "mdm.vocab_size=64",
        "rvq_width=32", "rvq_depth=1", "diffusion.timestep_respacing=ddim4"]
SECONDS = 8.5  # 255 frames: two windows
PROMPTS = {"upper": "raise both arms", "hands": "", "lower": "step to the left"}


def flatten(tree) -> dict:
    """A JAX tree as README.md's conversion writes it: '/'-joined paths, f32."""
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v, np.float32)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def perturb(variables, seed):
    """Seeded noise on every parameter, random BatchNorm statistics: the
    initial zeros and ones prove nothing."""
    g = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + g.normal(0, 0.02, np.shape(a)).astype(np.float32),
                          variables["params"])
    out = {"params": params}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree.map(lambda a: g.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                                          variables["batch_stats"])
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The wav, a TextGrid, a vocab and pose statistics on disk."""
    d = tmp_path_factory.mktemp("gen")
    g = np.random.default_rng(0)
    sr = 44100
    y = np.zeros((int(sr * SECONDS), 2))
    for t0 in np.arange(0.3, SECONDS - 0.5, 0.7):  # bursts and pauses
        s = int(t0 * sr)
        y[s : s + int(0.45 * sr)] = g.normal(0, 0.25, (int(0.45 * sr), 2))
    wavfile.write(str(d / "speech.wav"), sr, (y.clip(-1, 1) * 32767).astype(np.int16))
    words = ["raise", "your", "hands", "and", "wave", "now"]
    marks = [""] + words + [""]
    edges = np.linspace(0, SECONDS, len(marks) + 1)
    body = "".join(f'        intervals [{i + 1}]:\n            xmin = {a}\n            xmax = {b}\n'
                   f'            text = "{m}"\n' for i, (a, b, m) in enumerate(zip(edges[:-1], edges[1:], marks)))
    (d / "speech.TextGrid").write_text(
        f'File type = "ooTextFile"\nObject class = "TextGrid"\n\nxmin = 0\nxmax = {SECONDS}\n'
        f'tiers? <exists>\nsize = 1\nitem []:\n    item [1]:\n        class = "IntervalTier"\n'
        f'        name = "words"\n        xmin = 0\n        xmax = {SECONDS}\n'
        f'        intervals: size = {len(marks)}\n' + body)
    (d / "vocab.json").write_text(json.dumps({"name": "w", "word2index": {w: 4 + i for i, w in enumerate(words)},
                                              "word2count": {w: 1 for w in words}}))
    stats = d / "mean_std"
    stats.mkdir()
    np.save(stats / "beatx_2_330_mean.npy", g.normal(0, 0.1, 330).astype(np.float32))
    np.save(stats / "beatx_2_330_std.npy", g.uniform(0.5, 1.5, 330).astype(np.float32))
    np.save(stats / "beatx_2_trans_mean.npy", g.normal(0, 0.01, 3).astype(np.float32))
    np.save(stats / "beatx_2_trans_std.npy", g.uniform(0.01, 0.1, 3).astype(np.float32))
    return d


def overrides(files, *extra):
    return TINY + [f"data.vocab_path={files / 'vocab.json'}", f"data.mean_std_dir={files / 'mean_std'}", *extra]


@pytest.fixture(scope="module", params=["h3d", "beat2"])
def checkpoints(request, files):
    """JAX's models of a config, with perturbed weights and random codebooks,
    and the npz checkpoints of them: the MDM's variables, and per body part
    ``params`` + ``quantizer_state``."""
    yaml = f"configs/diffusion_{request.param}.yaml"
    # the parity runs in f32: beat2's bf16 is held against flax in test_torch_config.py
    ov = overrides(files, "mdm.dtype=f32", "mdm.audio_dtype=f32", "rvq_ckpts=[]")
    jcfg = JC.load_config(yaml, ov)
    rng = jax.random.PRNGKey(jcfg.train.seed)
    mdm, variables = create_mdm(jcfg.mdm, rng, frames=jcfg.data.pose_length)
    if "batch_stats" not in variables:
        variables = {"params": variables}
    variables = jax.tree.map(jnp.asarray, perturb(variables, 1))
    np.savez(files / f"{request.param}_mdm.npz", **flatten(variables))
    g = np.random.default_rng(2)
    rvq, ckpts = {}, []
    for part, (module, params, state) in jax_load_rvq_stack(jcfg, jax.random.fold_in(rng, 99)).items():
        params = jax.tree.map(jnp.asarray, perturb({"params": params}, 3)["params"])
        state = state.replace(codebook=jnp.asarray(g.normal(size=state.codebook.shape).astype(np.float32)))
        rvq[part] = (module, params, state)
        path = files / f"{request.param}_rvq_{part}.npz"
        np.savez(path, **flatten({"params": params, "quantizer_state": {"codebook": state.codebook,
                                                                       "code_count": state.code_count}}))
        ckpts.append(str(path))
    ov += [f"test_ckpt={files / f'{request.param}_mdm.npz'}", f"rvq_ckpts=[{','.join(ckpts)}]"]
    return request.param, yaml, ov, jcfg, mdm, variables, rvq


def test_mdm_checkpoint_round_trip(checkpoints, tmp_path):
    """The npz of a variables dict loads into the port's MDM: the same
    denoise as flax; a flat legacy qkv kernel migrates to the same model."""
    name, yaml, ov, jcfg, mdm, variables, _ = checkpoints
    cfg = PC.load_config(yaml, ov)
    g = np.random.default_rng(4)
    x = g.normal(size=(2, 8, 1536)).astype(np.float32)
    audio = g.normal(0, 0.1, (2, 533 * 32, 2)).astype(np.float32)
    word, seed = g.integers(0, 64, (2, 32)), g.normal(size=(2, 4, 1536)).astype(np.float32)
    cond = mdm.apply(variables, jnp.asarray(audio), jnp.asarray(word), jnp.asarray(seed), method="encode_cond")
    ref = np.asarray(mdm.apply(variables, jnp.asarray(x), jnp.asarray([3, 700]), cond, method="denoise"))

    flat = dict(np.load(cfg.test_ckpt))
    legacy = dict(flat)
    k = legacy["params/blocks/block/qkv/kernel"]
    legacy["params/blocks/block/qkv/kernel"] = k.reshape(k.shape[0], k.shape[1], -1)  # (L, C, 3C)
    np.savez(tmp_path / "legacy.npz", **legacy)
    for path in (cfg.test_ckpt, tmp_path / "legacy.npz"):
        loaded = PS.load_model_variables(path)
        assert set(loaded) == set(variables)
        migrated = migrate_qkv_kernels(loaded, cfg.mdm.num_heads)
        for a, b in zip(jax.tree.leaves(migrated), jax.tree.leaves(jax_migrate(jax.tree.map(jnp.asarray, loaded),
                                                                              cfg.mdm.num_heads))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        tmdm = port_cli.load_models(PC.load_config(yaml, ov + [f"test_ckpt={path}"]), "cpu")[0]
        tcond = Conditioning(torch.tensor(np.array(cond.at_feat)), torch.tensor(np.array(cond.seed_emb)),
                             None if cond.prompt_feat is None else torch.tensor(np.array(cond.prompt_feat)))
        with torch.no_grad():
            out = tmdm.denoise(torch.as_tensor(x), torch.as_tensor([3, 700]), tcond).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_rvq_stack_round_trip(checkpoints):
    name, yaml, ov, jcfg, _, _, rvq = checkpoints
    stack = load_rvq_stack(PC.load_config(yaml, ov), seed=0, device="cpu")
    z = np.random.default_rng(5).normal(size=(1, 12, 512)).astype(np.float32)
    for part, (module, params, state) in rvq.items():
        ref = np.asarray(module.apply({"params": params}, jnp.asarray(z), state, method="latent2origin"))
        tmod, tstate = stack[part]
        np.testing.assert_array_equal(tstate.codebook.numpy(), np.asarray(state.codebook))
        with torch.no_grad():
            out = tmod.latent2origin(torch.as_tensor(z), tstate).numpy()
        assert np.abs(out - ref).max() < 1e-4


def test_seeded_rvq_stack_without_checkpoints(files):
    cfg = PC.load_config("configs/diffusion_h3d.yaml", overrides(files))
    a, b = (load_rvq_stack(cfg, seed=7, device="cpu") for _ in range(2))
    for part in ("upper", "hands", "lower"):
        assert a[part][1].codebook.shape == (6, 512, 512)
        assert torch.equal(a[part][1].codebook, b[part][1].codebook)
    assert a["upper"][0].cfg.input_dim == 78 and a["lower"][0].cfg.output_emb_width == 512


def test_orbax_directory_is_refused(tmp_path):
    (tmp_path / "step_100").mkdir()
    with pytest.raises(ValueError, match="orbax.*npz"):
        PS.load_model_variables(tmp_path / "step_100")


def jax_generate(jcfg, mdm, variables, rvq, wav, *, textgrid="", transcript="", prompts=None, pipeline=None):
    """``syntalker_tpu/cli/generate.py:55-140`` composed with given weights."""
    rng = jax.random.PRNGKey(jcfg.train.seed)
    diffusion = jax_make_diffusion(schedule=jcfg.diffusion.schedule, steps=jcfg.diffusion.steps,
                                   timestep_respacing=jcfg.diffusion.timestep_respacing or "ddim50")
    stats = jax_load_pose_stats(jcfg.data.mean_std_dir)
    y, sr = JA.load_wav_mono(wav, jcfg.data.audio_sr)
    feats = JA.onset_amplitude_features(y, sr)[None]
    n_frames = int(len(y) / sr * jcfg.data.pose_fps)
    plan = JG.plan_windows(n_frames, pose_length=jcfg.data.pose_length, pre_frames=jcfg.pre_frames)
    if textgrid:
        word = jax_words_to_frame_ids(jax_words_tier(textgrid), n_frames, JaxVocab.load(jcfg.data.vocab_path))[None]
    elif transcript:
        intervals = JA.align_words_by_energy(transcript.split(), y, sr)
        word = jax_words_to_frame_ids(intervals, n_frames, JaxVocab.load(jcfg.data.vocab_path))[None]
    else:
        word = np.zeros((1, n_frames), np.int32)
    aw = jnp.asarray(JG.window_audio(feats, plan, sr=sr, fps=jcfg.data.pose_fps))
    ww = jnp.asarray(JG.window_words(word, plan))
    embedded = None
    if prompts:
        embedded = JTMR.embed_prompts(jcfg, {p: prompts.get(p) or None for p in ("upper", "hands", "lower")},
                                      pipeline)
    key = jax.random.fold_in(rng, 7)
    latents = JG.sample_windows(
        mdm, variables, diffusion, plan, aw, ww, jnp.zeros((1, plan.pre_frames, jcfg.mdm.latent_total_dim)), key,
        sampler="ddim" if diffusion.num_steps < jcfg.diffusion.steps else jcfg.diffusion.sampler, prompts=embedded,
        guidance={"audio_scale": jcfg.guidance.audio_scale, "prompt_scale": jcfg.guidance.prompt_scale})
    dec = JG.decode_latents(latents, rvq_modules=rvq, stats=stats, latent_scale=jcfg.latent_scale)
    return np.asarray(latents), dec, jax_noise(key, plan, 1, 0)[0]


@pytest.fixture(scope="module")
def tmr_head():
    """JAX's default text head (PRNGKey(0)), as the JAX CLI embeds prompts."""
    return JTMR.TextPipeline()


CASES = {  # config -> (words, prompted) of each case
    "h3d": [("textgrid", True), ("", True)],
    "beat2": [("transcript", False), ("textgrid", False)],
}


@pytest.mark.parametrize("case", [0, 1])
def test_generate_clip_matches_jax(checkpoints, files, tmr_head, case):
    name, yaml, ov, jcfg, mdm, variables, rvq = checkpoints
    words, prompted = CASES[name][case]
    kw = dict(textgrid=str(files / "speech.TextGrid") if words == "textgrid" else "",
              transcript="raise your hands and wave now" if words == "transcript" else "",
              prompts=PROMPTS if prompted else None)
    ref_lat, ref_dec, noise = jax_generate(jcfg, mdm, variables, rvq, files / "speech.wav", pipeline=tmr_head, **kw)

    cfg = PC.load_config(yaml, ov)
    models = port_cli.load_models(cfg, "cpu")
    denoise = mdm_cuda.make_fused_denoise(models[0], mdm_cuda.stack_block_weights(models[0], torch.float32))
    pipeline = PTMR.TextPipeline(head_params=jax.tree.map(np.asarray, tmr_head.head_params), device="cpu")
    out = port_cli.generate_clip(cfg, files / "speech.wav", noise=noise, denoise=denoise, pipeline=pipeline,
                                 models=models, device="cpu", **kw)
    assert out["latents"].shape == ref_lat.shape == (1, 60, 1536)
    np.testing.assert_allclose(out["latents"].numpy(), ref_lat, rtol=1e-4, atol=1e-5)
    npz = out["npz"]
    assert npz["poses"].shape == np.asarray(ref_dec["axis_angle"][0]).shape == (240, 165)
    np.testing.assert_allclose(npz["trans"], np.asarray(ref_dec["trans"][0]), rtol=1e-4, atol=1e-4)
    # the rot6d Gram-Schmidt amplifies the decoders' f32 convolution order (ROADMAP.md §3, fault 2)
    poses_gap = float(np.abs(npz["poses"] - np.asarray(ref_dec["axis_angle"][0])).max())
    print(json.dumps({"config": name, "case": case, "poses_max_abs_gap": poses_gap,
                      "latents_max_abs_gap": float(np.abs(out["latents"].numpy() - ref_lat).max()),
                      "latents_max_abs": float(np.abs(ref_lat).max())}))
    assert poses_gap < 1e-3


def test_main_writes_the_jax_clis_npz(files, tmp_path):
    """Both CLIs on the same wav and config: the same keys, shapes and
    dtypes (weights differ: each framework draws its own)."""
    args = ["-c", "configs/diffusion_h3d.yaml", "--wav", str(files / "speech.wav"),
            "--textgrid", str(files / "speech.TextGrid"), "--upper-prompt", "wave"]
    port_cli.main(args + ["--out", str(tmp_path / "port.npz"), "--run-dir", str(tmp_path / "run"), "--device", "cpu",
                          *overrides(files)])
    jax_cli.main(args + ["--out", str(tmp_path / "jax.npz"), "--run-dir", str(tmp_path / "run"), *overrides(files)])
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "jax.npz") as j:
        assert sorted(p.files) == sorted(j.files) == sorted(
            ["poses", "trans", "betas", "expressions", "model", "gender", "mocap_frame_rate"])
        for k in j.files:
            assert p[k].shape == j[k].shape and p[k].dtype == j[k].dtype, k
            if p[k].dtype.kind in "US":
                assert p[k] == j[k]
        assert p["poses"].shape == (240, 165) and np.isfinite(p["poses"]).all() and np.isfinite(p["trans"]).all()
    assert (tmp_path / "run" / "log.txt").exists()


def test_ddpm_config_runs(files, tmp_path):
    """A schedule that is not respaced samples with the config's DDPM."""
    out = tmp_path / "ddpm.npz"
    port_cli.main(["-c", "configs/diffusion_beat2.yaml", "--wav", str(files / "speech.wav"), "--out", str(out),
                   "--run-dir", str(tmp_path / "run"), "--device", "cpu",
                   *overrides(files, "diffusion.steps=4", "diffusion.timestep_respacing=ddim4", "rvq_ckpts=[]")])
    with np.load(out) as d:
        assert d["poses"].shape == (240, 165) and np.isfinite(d["poses"]).all()


def test_render_is_refused(files, tmp_path):
    """``--render`` was refused until the renderer was ported; now it writes
    the stick-figure video of the npz beside it (2 s of audio in 32-frame
    windows, the synthetic SMPL-X model: the config's file is absent)."""
    sr = 16000
    y = np.random.default_rng(2).normal(0, 0.2, 2 * sr)
    wavfile.write(str(tmp_path / "short.wav"), sr, (y.clip(-1, 1) * 32767).astype(np.int16))
    out = tmp_path / "render.npz"
    port_cli.main(["-c", "configs/diffusion_beat2.yaml", "--wav", str(tmp_path / "short.wav"), "--out", str(out),
                   "--render", "--run-dir", str(tmp_path / "run"), "--device", "cpu",
                   *overrides(files, "data.pose_length=32", "rvq_ckpts=[]", "data.smplx_model_path=")])
    videos = [p for p in (out.with_suffix(".mp4"), out.with_suffix(".gif")) if p.exists()]
    assert len(videos) == 1
    import imageio

    with np.load(out) as d:
        assert len(imageio.mimread(videos[0])) == d["poses"].shape[0] == 48
