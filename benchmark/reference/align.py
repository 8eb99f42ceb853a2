"""Words placed over a clip's voiced audio and turned into per-frame word
ids, numpy, for requests whose words come from a transcription.

The alignment by energy: the voiced samples are those whose amplitude
envelope (:func:`benchmark.reference.audio.amplitude_envelope`, the rolling
max of |x| over 1,024 samples) exceeds a tenth of its peak; each word owns
an equal share of the cumulative voiced time and is emitted over the voiced
runs it overlaps, runs merged across dips shorter than 0.15 s; a silence
interval over the whole clip comes last. A sample's time is its index
times ``1 / sr`` (not its index over ``sr``: the two differ in the last bit,
which decides a frame whose time falls on an interval's end). A frame at
``i / fps`` takes the
first interval that covers it: pad (0) for silence, the word's id in
``word_ids``, unknown (3) where the word is not there or nothing covers the
frame.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.audio import amplitude_envelope

PAD, UNK = 0, 3


def align(words: list, y: np.ndarray, sr: int = 16000, frame: int = 1024, silence_rel: float = 0.1,
          min_pause_s: float = 0.15) -> list:
    """(start s, end s, word) intervals, "" for silence."""
    words = [w for w in words if w.strip()]
    duration = len(y) / sr
    if not words or duration == 0:
        return [(0.0, duration, "")]
    env = amplitude_envelope(np.abs(np.asarray(y, np.float32)), frame)
    voiced = env > silence_rel * (env.max() + 1e-12)
    if not voiced.any():
        return [(0.0, duration, "")]
    cum = np.cumsum(voiced.astype(np.float64))
    cuts = [int(np.searchsorted(cum, cum[-1] * k / len(words))) for k in range(1, len(words))]
    starts, ends = [0] + cuts, cuts + [len(env)]
    runs = []
    k = 0
    while k < len(voiced):
        if not voiced[k]:
            k += 1
            continue
        e = k
        while e < len(voiced) and voiced[e]:
            e += 1
        if runs and k - runs[-1][1] < min_pause_s * sr:
            runs[-1] = (runs[-1][0], e)
        else:
            runs.append((k, e))
        k = e
    dt = 1.0 / sr
    out = [(max(s, r0) * dt, min(e, r1) * dt, w) for w, s, e in zip(words, starts, ends) for r0, r1 in runs
           if min(e, r1) > max(s, r0)]
    return out + [(0.0, duration, "")]


def frame_ids(intervals: list, frames: int, word_ids: dict, fps: int = 30) -> np.ndarray:
    out = np.full(frames, UNK, np.int64)
    for i in range(frames):
        t = i / fps
        for s, e, w in intervals:
            if s <= t <= e:
                out[i] = PAD if not w.strip() else word_ids.get(w, UNK)
                break
    return out
