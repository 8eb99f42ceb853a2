"""Word vocabulary with an optional embedding matrix.

Counterpart of ``syntalker_tpu/data/vocab.py``: PAD/SOS/EOS/UNK special
tokens, corpus indexing from TextGrid word tiers, the JSON form this repo
writes and the reference's ``vocab.pkl``, and per-frame word ids.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from syntalker_tpu_torch.data.textgrid import words_tier


class _VocabShim:
    """Attribute bag standing in for the reference's ``Vocab`` class when a
    ``vocab.pkl`` is unpickled without the reference package importable."""

    def __init__(self, *a, **k):
        pass


class _RefVocabUnpickler(pickle.Unpickler):
    """Unpickles the reference's ``dataloaders.build_vocab.Vocab`` pickle
    (build_vocab.py:12-107) without importing the reference package: any
    class named ``Vocab`` resolves to :class:`_VocabShim`; everything else
    follows normal resolution (numpy arrays etc.)."""

    def find_class(self, module, name):
        if name == "Vocab":
            return _VocabShim
        return super().find_class(module, name)


class Vocab:
    PAD_token = 0
    SOS_token = 1
    EOS_token = 2
    UNK_token = 3

    def __init__(self, name: str = "words"):
        self.name = name
        self.word2index: dict[str, int] = {}
        self.word2count: dict[str, int] = {}
        self.index2word = {0: "<PAD>", 1: "<SOS>", 2: "<EOS>", 3: "<UNK>"}
        self.n_words = 4
        self.word_embedding_weights: Optional[np.ndarray] = None

    def index_word(self, word: str):
        if word not in self.word2index:
            self.word2index[word] = self.n_words
            self.word2count[word] = 1
            self.index2word[self.n_words] = word
            self.n_words += 1
        else:
            self.word2count[word] += 1

    def get_word_index(self, word: str) -> int:
        return self.word2index.get(word, self.UNK_token)

    def index_textgrid(self, path):
        for iv in words_tier(path):
            for w in iv.mark.split():
                self.index_word(w)

    def build_embedding(
        self,
        dim: int = 300,
        pretrained: Optional[dict[str, np.ndarray]] = None,
        init_sd: float = 0.1,
        seed: int = 0,
    ) -> np.ndarray:
        rng = np.random.default_rng(seed)
        w = rng.normal(0, init_sd, size=(self.n_words, dim)).astype(np.float32)
        hits = 0
        if pretrained:
            for word, idx in self.word2index.items():
                vec = pretrained.get(word)
                if vec is not None:
                    w[idx] = vec
                    hits += 1
        self.word_embedding_weights = w
        return w

    # --- persistence (json-based; the reference pickles the whole object) --

    def save(self, path: str | Path):
        data = {
            "name": self.name,
            "word2index": self.word2index,
            "word2count": self.word2count,
        }
        p = Path(path)
        p.write_text(json.dumps(data))
        if self.word_embedding_weights is not None:
            np.save(p.with_suffix(".emb.npy"), self.word_embedding_weights)

    @classmethod
    def load(cls, path: str | Path) -> "Vocab":
        p = Path(path)
        v = cls()
        if p.suffix == ".pkl":  # reference vocab.pkl compatibility
            with open(p, "rb") as f:
                ref = _RefVocabUnpickler(f).load()
            v.name = getattr(ref, "name", "words")
            v.word2index = dict(ref.word2index)
            v.word2count = dict(ref.word2count)
            v.index2word = dict(ref.index2word)
            v.n_words = ref.n_words
            v.word_embedding_weights = getattr(ref, "word_embedding_weights", None)
            return v
        data = json.loads(p.read_text())
        v.name = data["name"]
        v.word2index = data["word2index"]
        v.word2count = data["word2count"]
        for w, i in v.word2index.items():
            v.index2word[i] = w
        v.n_words = 4 + len(v.word2index)
        emb = p.with_suffix(".emb.npy")
        if emb.exists():
            v.word_embedding_weights = np.load(emb)
        return v


def build_vocab(textgrid_paths: Iterable, name: str = "beat_words") -> Vocab:
    """Index all word tiers (build_vocab.py:135-171)."""
    v = Vocab(name)
    for p in textgrid_paths:
        v.index_textgrid(p)
    return v


def words_to_frame_ids(
    intervals, n_frames: int, vocab: Vocab, fps: int = 30, time_offset: float = 0.0
) -> np.ndarray:
    """Per-motion-frame word ids (beat_sep_lower.py:515-548): the word whose
    alignment interval covers the frame time; PAD for silence marks; UNK
    when no interval covers the frame."""
    out = np.full(n_frames, vocab.UNK_token, dtype=np.int32)
    for i in range(n_frames):
        t = i / fps + time_offset
        for iv in intervals:
            if iv.min_time <= t <= iv.max_time:
                if iv.mark.strip() == "":
                    out[i] = vocab.PAD_token
                else:
                    out[i] = vocab.get_word_index(iv.mark)
                break
    return out
