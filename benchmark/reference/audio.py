"""16 kHz featurization: amplitude envelope and onset impulse train, numpy.

The model's audio input is (S, 2) per sample: the rolling max of |x| over
1024 samples (stride 1, the tail padded with the last full window), and a
train of unit impulses at the onsets that librosa's ``onset_detect`` finds
with its defaults (mel spectral flux of a centred 2048-point STFT, hop 512,
128 Slaney mels, dB with top 80, peak picking over 30/100 ms windows,
delta 0.07), the envelope normalized to [0, 1] first.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import maximum_filter1d

N_FFT, HOP, N_MELS, FRAME = 2048, 512, 128, 1024


def amplitude_envelope(y: np.ndarray, frame: int = FRAME) -> np.ndarray:
    a = np.abs(np.asarray(y, np.float32))
    if len(a) < frame:
        return np.full(len(a), a.max() if len(a) else 0.0, np.float32)
    env = maximum_filter1d(a, frame, mode="nearest", origin=-(frame // 2))  # max over [i, i + frame)
    env[len(a) - frame + 1 :] = env[len(a) - frame]
    return env.astype(np.float32)


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / np.log(6.4) * 27.0,
                    f / 66.6666666666667)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0), m * 66.6666666666667)


def mel_filterbank(sr: int, n_fft: int = N_FFT, n_mels: int = N_MELS) -> np.ndarray:
    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    lower = -ramps[:n_mels] / fdiff[:n_mels, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (pts[2:] - pts[:n_mels]))[:, None]
    return w.astype(np.float32)


def onset_envelope(y: np.ndarray, sr: int) -> np.ndarray:
    pad = N_FFT // 2
    yp = np.pad(y, pad, mode="reflect") if len(y) > pad else np.pad(y, pad)
    n = 1 + (len(yp) - N_FFT) // HOP
    frames = yp[np.arange(N_FFT)[None, :] + HOP * np.arange(n)[:, None]] * np.hanning(N_FFT + 1)[:-1]
    spec = np.fft.rfft(frames, axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    mel = power @ mel_filterbank(sr).T
    db = 10.0 * np.log10(np.maximum(1e-10, mel) / np.maximum(1e-10, mel.max()))
    db = np.maximum(db, -80.0)
    flux = np.maximum(0.0, db[1:] - db[:-1]).mean(axis=1)
    return np.concatenate([np.zeros(1 + N_FFT // (2 * HOP), np.float32), flux.astype(np.float32)])


def peak_pick(env: np.ndarray, sr: int) -> np.ndarray:
    pre_max, post_max = int(0.03 * sr // HOP), int(0.0 * sr // HOP) + 1
    pre_avg, post_avg = int(0.1 * sr // HOP), int(0.1 * sr // HOP) + 1
    wait, delta = int(0.03 * sr // HOP), 0.07
    csum = np.concatenate([[0.0], np.cumsum(env, dtype=np.float64)])
    n, last, peaks = len(env), -1 - wait, []
    for i in range(n):
        if env[i] < env[max(0, i - pre_max) : min(n, i + post_max + 1)].max():
            continue
        lo, hi = max(0, i - pre_avg), min(n, i + post_avg + 1)
        if env[i] < (csum[hi] - csum[lo]) / (hi - lo) + delta:
            continue
        if i - last <= wait:
            continue
        peaks.append(i)
        last = i
    return np.asarray(peaks, np.int64)


def features(y: np.ndarray, sr: int = 16000) -> np.ndarray:
    """(S,) waveform -> (S, 2) [amplitude envelope, onset impulses]."""
    y = np.asarray(y, np.float32)
    env = onset_envelope(y, sr)
    span = env.max() - env.min()
    if span > 0:
        env = (env - env.min()) / span
    onset = np.zeros(len(y), np.float32)
    at = peak_pick(env, sr) * HOP
    onset[at[at < len(y)]] = 1.0
    return np.stack([amplitude_envelope(y), onset], axis=1)
