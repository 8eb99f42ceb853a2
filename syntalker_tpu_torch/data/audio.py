"""Host-side audio featurization: amplitude envelope + onset impulses.

Counterpart of ``syntalker_tpu/data/audio.py`` for what the service and the
streaming session feed the model (``onset_amplitude_features``): a rolling
max of |x| over 1024-sample windows, and an onset impulse train from a mel
spectral-flux envelope with librosa-default peak picking (sr 16 kHz, hop
512). The rolling max and the peak picking run in C++
(:mod:`syntalker_tpu_torch.native`), as JAX's do once ``g++`` built them;
the STFT and the mel projection stay numpy. ``amplitude_envelope_plain``
and ``peak_pick_plain`` are the numpy versions the tests hold the C++
against. For the ``generate`` CLI: ``load_wav_mono`` (PCM or float WAV,
stereo mixed to mono, polyphase resampling) and ``align_words_by_energy``
(transcript words over the voiced audio). The mel features and wav2vec2
features wait for the training slice.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from syntalker_tpu_torch import native
from syntalker_tpu_torch.data.textgrid import Interval


def load_wav_mono(path: str | Path, target_sr: int = 16000) -> Tuple[np.ndarray, int]:
    """A PCM (int16, int32, uint8) or float WAV as float32 mono at ``target_sr``."""
    sr, y = wavfile.read(str(path))
    if y.dtype == np.int16:
        y = y.astype(np.float32) / 32768.0
    elif y.dtype == np.int32:
        y = y.astype(np.float32) / 2147483648.0
    elif y.dtype == np.uint8:
        y = (y.astype(np.float32) - 128.0) / 128.0
    else:
        y = y.astype(np.float32)
    if y.ndim > 1:
        y = y.mean(axis=1)
    if sr != target_sr:
        g = np.gcd(int(sr), target_sr)
        y = resample_poly(y, target_sr // g, int(sr) // g).astype(np.float32)
    return np.ascontiguousarray(y, np.float32), target_sr


def _hz_to_mel(f) -> np.ndarray:
    """Slaney mel scale (librosa default)."""
    f = np.asarray(f, dtype=np.float64)
    mel = f / 66.6666666666667
    log_region = f >= 1000.0
    return np.where(
        log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / np.log(6.4) * 27.0, mel
    )


def _mel_to_hz(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f = m * 66.6666666666667
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0), f)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax=None):
    """Slaney-normalized triangular mel filterbank (n_mels, 1+n_fft//2)."""
    fmax = fmax or sr / 2
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    weights = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def stft_power(y: np.ndarray, n_fft: int = 2048, hop: int = 512) -> np.ndarray:
    """Centered power spectrogram (frames, 1+n_fft//2), hann window."""
    pad = n_fft // 2
    ypad = np.pad(y, pad, mode="reflect") if len(y) > pad else np.pad(y, pad)
    n_frames = 1 + (len(ypad) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = ypad[idx] * np.hanning(n_fft + 1)[:-1]
    spec = np.fft.rfft(frames, axis=-1)
    return (spec.real**2 + spec.imag**2).astype(np.float32)


def power_to_db(S: np.ndarray, amin: float = 1e-10, top_db: float = 80.0) -> np.ndarray:
    ref = np.maximum(amin, S.max())
    db = 10.0 * np.log10(np.maximum(amin, S) / ref)
    return np.maximum(db, -top_db)


def onset_strength(y: np.ndarray, sr: int = 16000, hop: int = 512) -> np.ndarray:
    """Mel spectral-flux onset envelope (128 mels, dB, positive first
    difference, mean over bands, lag-compensated)."""
    n_fft = 2048
    S = power_to_db(stft_power(y, n_fft, hop) @ mel_filterbank(sr, n_fft).T)
    flux = np.maximum(0.0, S[1:] - S[:-1]).mean(axis=1)
    pad = 1 + n_fft // (2 * hop)
    return np.concatenate([np.zeros(pad, np.float32), flux.astype(np.float32)])


def peak_pick_plain(env, *, pre_max, post_max, pre_avg, post_avg, delta, wait) -> np.ndarray:
    """librosa.util.peak_pick semantics on a 1-D envelope; numpy, window
    means in float32 (the C++ takes them from double prefix sums)."""
    n = len(env)
    peaks = []
    last = -1 - wait
    for i in range(n):
        lo_m, hi_m = max(0, i - pre_max), min(n, i + post_max + 1)
        if env[i] < env[lo_m:hi_m].max():
            continue
        lo_a, hi_a = max(0, i - pre_avg), min(n, i + post_avg + 1)
        if env[i] < env[lo_a:hi_a].mean() + delta:
            continue
        if i - last <= wait:
            continue
        peaks.append(i)
        last = i
    return np.asarray(peaks, dtype=np.int64)


def onset_detect_frames(y: np.ndarray, sr: int = 16000, hop: int = 512) -> np.ndarray:
    """Onset frame indices (librosa onset_detect defaults, normalized
    envelope, no backtracking), peaks picked in C++."""
    env = onset_strength(y, sr, hop)
    rng = env.max() - env.min()
    if rng > 0:
        env = (env - env.min()) / rng
    return native.peak_pick(env, **peak_pick_args(sr, hop))


def peak_pick_args(sr: int = 16000, hop: int = 512) -> dict:
    """librosa onset_detect's peak-picking windows at ``sr`` and ``hop``."""
    return dict(pre_max=int(0.03 * sr // hop), post_max=int(0.0 * sr // hop) + 1, pre_avg=int(0.1 * sr // hop),
                post_avg=int(0.1 * sr // hop) + 1, delta=0.07, wait=int(0.03 * sr // hop))


def onset_detect_times(y: np.ndarray, sr: int = 16000, hop: int = 512) -> np.ndarray:
    """Onset times in seconds."""
    return onset_detect_frames(y, sr, hop) * hop / sr


def amplitude_envelope(y: np.ndarray, frame_length: int = 1024) -> np.ndarray:
    """Rolling max of |x| over frame_length, stride 1, end-padded, in C++."""
    return native.rolling_max_abs(y, frame_length)


def amplitude_envelope_plain(y: np.ndarray, frame_length: int = 1024) -> np.ndarray:
    """Rolling max of |x| over frame_length, stride 1, end-padded; numpy."""
    if len(y) < frame_length:
        return np.full(len(y), np.abs(y).max() if len(y) else 0.0, np.float32)
    win = np.lib.stride_tricks.sliding_window_view(np.abs(y), frame_length)
    env = win.max(axis=1)
    return np.pad(env, (0, frame_length - 1), mode="edge").astype(np.float32)


def onset_amplitude_features(y: np.ndarray, sr: int = 16000) -> np.ndarray:
    """(S, 2) model input: [amplitude envelope, onset impulse train]."""
    amp = amplitude_envelope(y)
    onset = np.zeros(len(y), np.float32)
    samples = onset_detect_frames(y, sr) * 512
    onset[samples[samples < len(y)]] = 1.0
    return np.stack([amp, onset], axis=1)


def align_words_by_energy(words: "list[str]", y: np.ndarray, sr: int = 16000, *, frame_length: int = 1024,
                          silence_rel: float = 0.1, min_pause_s: float = 0.15):
    """Transcript words -> TextGrid-style intervals, when no aligner is at hand.

    Each word owns an equal share of the clip's cumulative voiced time
    (voiced: the rolling-max envelope above ``silence_rel`` of its peak) and
    is emitted over the voiced runs it overlaps, runs merged across dips
    shorter than ``min_pause_s``. A catch-all silence interval comes last,
    so frames no word covers resolve to PAD in
    :func:`syntalker_tpu_torch.data.vocab.words_to_frame_ids`."""
    words = [w for w in words if w.strip()]
    duration = len(y) / sr
    if not words or duration == 0:
        return [Interval(0.0, duration, "")]

    env = amplitude_envelope(np.abs(y).astype(np.float32), frame_length)
    hop_t = 1.0 / sr  # the envelope is per sample (rolling max, stride 1)
    voiced = env > silence_rel * (env.max() + 1e-12)
    if not voiced.any():
        return [Interval(0.0, duration, "")]

    # word w owns the cumulative-voiced-time share [w/N, (w+1)/N)
    cum = np.cumsum(voiced.astype(np.float64))
    bounds = np.searchsorted(cum, cum[-1] * np.arange(1, len(words)) / len(words))
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(env)]])

    # voiced runs, merged across sub-pause dips
    v = np.concatenate([[False], voiced, [False]])
    d = np.diff(v.astype(np.int8))
    merged = []
    for r0, r1 in zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)):
        if merged and r0 - merged[-1][1] < min_pause_s * sr:
            merged[-1] = (merged[-1][0], r1)
        else:
            merged.append((r0, r1))

    out = []
    for w, s0, e0 in zip(words, starts, ends):
        for r0, r1 in merged:
            lo, hi = max(s0, r0), min(e0, r1)
            if hi > lo:
                out.append(Interval(lo * hop_t, hi * hop_t, w))
    out.append(Interval(0.0, duration, ""))
    return out
