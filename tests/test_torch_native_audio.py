"""The port's host featurization ops in C++ against their plain numpy
versions (rolling max exact, peaks equal), the port's
``onset_amplitude_features`` and ``onset_detect_times`` against JAX's bit
for bit on seeded synthetic audio of 1, 6.3 and 16 s, and a failed build
that raises instead of falling back."""

import numpy as np
import pytest

from syntalker_tpu.data import audio as JA
from syntalker_tpu_torch import native
from syntalker_tpu_torch.data import audio as A

SECONDS = (1.0, 6.3, 16.0)


def speech_like(seconds: float, seed: int) -> np.ndarray:
    """A pitched tone with a 2.5 Hz syllable envelope plus noise, 16 kHz."""
    g = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    wave = 0.3 * np.sin(2 * np.pi * (110 + 40 * seed) * t) * (1 + np.sin(2 * np.pi * 2.5 * t))
    return (wave + 0.05 * g.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("seconds", SECONDS)
def test_features_equal_jax_bit_for_bit(seconds):
    y = speech_like(seconds, seed=int(seconds * 10) % 7)
    out = A.onset_amplitude_features(y)
    assert out.shape == (len(y), 2) and out[:, 1].sum() > 0
    np.testing.assert_array_equal(out, JA.onset_amplitude_features(y))
    np.testing.assert_array_equal(A.onset_detect_times(y), JA.onset_detect_times(y))


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 48_000])
def test_rolling_max_equals_plain(n):
    y = np.random.default_rng(n).normal(size=n).astype(np.float32)
    np.testing.assert_array_equal(A.amplitude_envelope(y), A.amplitude_envelope_plain(y))


@pytest.mark.parametrize("seconds", SECONDS)
def test_peak_pick_equals_plain(seconds):
    """On the normalized onset envelope of a clip, and on a random envelope
    with plateaus (ties for the local maximum)."""
    env = A.onset_strength(speech_like(seconds, seed=3))
    env = (env - env.min()) / (env.max() - env.min())
    g = np.random.default_rng(int(seconds))
    plateaus = np.round(g.uniform(size=len(env)) * 8).astype(np.float32) / 8
    for e in (env, plateaus):
        got = native.peak_pick(e, **A.peak_pick_args())
        np.testing.assert_array_equal(got, A.peak_pick_plain(e, **A.peak_pick_args()))
    assert len(native.peak_pick(env, **A.peak_pick_args())) > 0


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ cannot compile raises with its output; no numpy path."""
    bad = tmp_path / "audio_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.library.__wrapped__()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.library.__wrapped__()
