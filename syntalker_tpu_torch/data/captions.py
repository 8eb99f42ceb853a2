"""Deterministic per-word vectors shared by the captioner and the TMR text side.

Counterpart of ``hash_word_vector`` in ``syntalker_tpu/data/captions.py``;
the motion captioner itself waits for the evaluation slice.
"""

from __future__ import annotations

import hashlib

import numpy as np


def hash_word_vector(word: str, dim: int = 300) -> np.ndarray:
    """A Gaussian vector seeded by the word's sha1: word-distinct and the
    same in every run (numpy's generator, as in JAX's package)."""
    seed = int.from_bytes(hashlib.sha1(word.lower().encode()).digest()[:4], "little")
    return np.random.default_rng(seed).normal(0, 1, dim).astype(np.float32)
