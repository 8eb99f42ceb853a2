"""The general generator of the benchmark's inputs, driven by a traffic
file's parameters and the run's seed (a ``numpy`` generator).

Speech is synthetic and speech-like: a voiced carrier with a gliding pitch
and five harmonics, gated into syllables of 120-300 ms at a few a second
with pauses between phrases, over a faint noise floor. Word ids change at
word boundaries of 6-15 frames, with silent frames (id 0) in the pauses.
"""

from __future__ import annotations

import numpy as np


def speech(rng: np.random.Generator, seconds: float, sr: int = 16000) -> np.ndarray:
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    f0 = 120.0 + 40.0 * np.sin(2 * np.pi * rng.uniform(0.1, 0.3) * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voice = sum(np.sin(h * phase) / h for h in range(1, 6))
    gate = np.zeros(n)
    pos = int(rng.uniform(0.0, 0.2) * sr)
    while pos < n:
        length = int(rng.uniform(0.12, 0.3) * sr)
        gate[pos : pos + length] = np.hanning(length)[: max(0, min(length, n - pos))]
        pos += length + int((rng.uniform(0.3, 0.8) if rng.random() < 0.1 else rng.uniform(0.02, 0.1)) * sr)
    y = 0.3 * voice * gate + 0.01 * rng.standard_normal(n)
    return y.astype(np.float32)


def words(rng: np.random.Generator, frames: int, vocab: int) -> np.ndarray:
    out = np.zeros(frames, np.int64)
    pos = 0
    while pos < frames:
        length = int(rng.integers(6, 16))
        if rng.random() > 0.15:
            out[pos : pos + length] = rng.integers(1, vocab)
        pos += length
    return out


def unit_vector(rng: np.random.Generator, dim: int) -> np.ndarray:
    v = rng.standard_normal(dim)
    return (v / np.linalg.norm(v)).astype(np.float32)


def lengths(rng: np.random.Generator, lo: float, hi: float, n: int) -> np.ndarray:
    """``n`` lengths spread evenly over [lo, hi) (the midpoints of n equal
    bins), in an order drawn from ``rng``: every draw the same set."""
    return rng.permutation(lo + (np.arange(n) + 0.5) * (hi - lo) / n)
