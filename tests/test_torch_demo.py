"""The port's demo CLI on the CPU at tiny widths.

One-shot mode on a synthetic 2 s wav (32-frame windows, so that 2 s make
two): ``demo_out.npz`` equals, array for array, what the port's
``generate`` writes for the same arguments, and its video lies beside it.
Without ``--wav`` and without gradio it exits with JAX's message. The
transcription needs a local whisper snapshot and ``transformers``; without
them the demo runs on the audio alone, as JAX's does."""

import sys

import imageio
import numpy as np
import pytest
from scipy.io import wavfile

from syntalker_tpu_torch.cli import demo
from syntalker_tpu_torch.cli import generate as GEN
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse: the worker's share of the cores)

TINY = ["mdm.latent_dim=32", "mdm.ff_size=64", "mdm.num_layers=2", "mdm.num_heads=2", "mdm.rope_heads=4",
        "mdm.audio_feat_dim=16", "mdm.word_feat_dim=16", "mdm.word_embed_dim=8", "mdm.vocab_size=64",
        "rvq_width=32", "rvq_depth=1", "diffusion.timestep_respacing=ddim4", "data.pose_length=32", "rvq_ckpts=[]"]


def test_one_shot_writes_generates_npz_and_a_video(tmp_path):
    sr = 16000
    t = np.arange(2 * sr) / sr
    y = 0.3 * (np.sin(2 * np.pi * 1.5 * t) > 0) * np.sin(2 * np.pi * 180 * t)
    wav = tmp_path / "speech.wav"
    wavfile.write(str(wav), sr, (y * 32767).astype(np.int16))
    common = ["-c", "configs/diffusion_beat2.yaml", "--device", "cpu"]
    video = demo.main(common + ["--wav", str(wav), "--run-dir", str(tmp_path / "demo"), *TINY])
    out = tmp_path / "demo" / "demo_out.npz"
    assert video == str(out.with_suffix(".mp4" if video.endswith(".mp4") else ".gif"))
    GEN.main(common + ["--wav", str(wav), "--out", str(tmp_path / "gen.npz"), "--run-dir", str(tmp_path / "gen"),
                       *TINY])
    with np.load(out) as a, np.load(tmp_path / "gen.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        frames = a["poses"].shape[0]
        assert frames == 48 and np.isfinite(a["poses"]).all()
    assert len(imageio.mimread(video)) == frames


def test_without_wav_or_gradio_it_exits_with_jaxs_message(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # as where gradio is not installed
    with pytest.raises(SystemExit, match="gradio is not installed; run one-shot mode with --wav input.wav"):
        demo.main(["--run-dir", str(tmp_path)])
