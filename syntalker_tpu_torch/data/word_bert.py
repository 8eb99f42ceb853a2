"""Per-frame BERT word representations (reference beat_sep_lower.py:432-513).

Counterpart of ``syntalker_tpu/data/word_bert.py``, the same numpy code
(the port keeps its own copy).

The reference's optional ``t_pre_encoder='bert'`` cache path replaces the
per-frame int word id with a per-frame 768-d BERT last-hidden-state vector:
the TextGrid transcript is tokenized in ≤400-word chunks, each word's
subword tokens are spread linearly over the word's time interval
(beat_sep_lower.py:524-531), and frames outside any word interval inherit
the last seen word's final hidden state (:541-543). NOTE: no shipped
reference config sets ``word_cache``, and the shipped denoiser consumes int
ids through an embedding (models/denoiser.py:152) — this path is
dataloader-only in the reference too, so here it is a standalone
featurizer; feed its output to a custom model head if needed.

Encoders:

- :class:`TransformersBertEncoder` — a local ``bert-base-uncased`` snapshot
  via the ``transformers`` package (``local_files_only``: a snapshot
  directory must be provided; without ``transformers`` it raises
  ``ImportError``).
- :class:`HashProjectionEncoder` — the in-env fallback: a deterministic
  768-d Gaussian vector per WordPiece-style token (seeded by the token
  string), with greedy longest-match subword splitting over a small learned
  -free vocab. Not semantic — it preserves the *shape and plumbing* of the
  BERT path (same frame mapping, same chunking) so cached datasets and
  model heads built against it port unchanged when a real snapshot exists.
  Same pattern as the TMR text-encoder fallback (models/tmr.py).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

HIDDEN_DIM = 768
MAX_CHUNK_WORDS = 400  # reference chunking bound (beat_sep_lower.py:438)


class HashProjectionEncoder:
    """Deterministic token -> 768-d vectors; WordPiece-like greedy splits."""

    def __init__(self, dim: int = HIDDEN_DIM):
        self.dim = dim

    def _vec(self, token: str) -> np.ndarray:
        seed = int.from_bytes(
            hashlib.sha256(token.encode()).digest()[:8], "little"
        )
        rng = np.random.default_rng(seed)
        v = rng.standard_normal(self.dim).astype(np.float32)
        return v / np.linalg.norm(v)

    def tokenize(self, word: str) -> List[str]:
        word = word.lower()
        # crude subword split: ≤6-char greedy chunks (stands in for
        # WordPiece; token count per word is what the frame mapping needs)
        return [word[i : i + 6] for i in range(0, len(word), 6)] or [word]

    def encode_words(self, words: Sequence[str]) -> Tuple[np.ndarray, List[List[int]]]:
        """-> (hidden_states (n_tokens, dim), per-word token-index lists)."""
        hidden, mapping = [], []
        for w in words:
            idxs = []
            for tok in self.tokenize(w):
                idxs.append(len(hidden))
                hidden.append(self._vec(tok))
            mapping.append(idxs)
        if not hidden:
            hidden = [np.zeros(self.dim, np.float32)]
        return np.stack(hidden), mapping


class TransformersBertEncoder:
    """Local-snapshot BERT encoder (reference beat_sep_lower.py:433-435)."""

    def __init__(self, snapshot_dir: str):
        from transformers import AutoTokenizer, BertModel  # local snapshot only

        self.tokenizer = AutoTokenizer.from_pretrained(
            snapshot_dir, local_files_only=True
        )
        self.model = BertModel.from_pretrained(
            snapshot_dir, local_files_only=True
        ).eval()
        self.dim = self.model.config.hidden_size

    def encode_words(self, words: Sequence[str]) -> Tuple[np.ndarray, List[List[int]]]:
        import torch

        hidden_chunks: List[np.ndarray] = []
        mapping: List[List[int]] = []
        base = 0
        for c0 in range(0, len(words), MAX_CHUNK_WORDS):
            chunk = list(words[c0 : c0 + MAX_CHUNK_WORDS])
            text = " ".join(chunk)
            # char offsets of each word inside the joined string
            # (beat_sep_lower.py:454-459)
            end = -1
            offsets = []
            for w in chunk:
                start = end + 1
                end = start + len(w)
                offsets.append((start, end))
            enc = self.tokenizer.encode_plus(text, return_offsets_mapping=True)
            token_offsets = enc["offset_mapping"][1:-1]  # drop [CLS]/[SEP]
            for start, end in offsets:
                mapping.append(
                    [
                        base + i
                        for i, (s, e) in enumerate(token_offsets)
                        if start <= s and e <= end
                    ]
                )
            with torch.no_grad():
                inputs = self.tokenizer(text, return_tensors="pt")
                out = self.model(**inputs).last_hidden_state
            h = out.reshape(-1, self.dim).numpy()[1:-1]
            hidden_chunks.append(h)
            base += h.shape[0]
        return np.concatenate(hidden_chunks, 0), mapping


@dataclass(frozen=True)
class WordInterval:
    start: float
    end: float
    word: str


def bert_frame_features(
    intervals,  # textgrid Interval-likes (min_time, max_time, mark)
    n_frames: int,
    *,
    fps: int = 30,
    time_offset: float = 0.0,
    encoder=None,
) -> np.ndarray:
    """Per-frame (n_frames, dim) word features, reference frame mapping:

    - frame inside a word interval: the word's subword tokens are spread
      linearly over [start, end]; the frame takes the token whose linear
      slot covers it (beat_sep_lower.py:524-531). Empty marks are encoded
      as '.' exactly like the reference (:445-447).
    - frame outside all intervals: the last seen word's LAST token hidden
      (:541-543 — j_last semantics; before any word, the first word's).
    """
    encoder = encoder or HashProjectionEncoder()
    ivs = [
        WordInterval(iv.min_time, iv.max_time, iv.mark.strip() or ".")
        for iv in intervals
    ]
    if not ivs:
        return np.zeros((n_frames, encoder.dim), np.float32)
    hidden, mapping = encoder.encode_words([iv.word for iv in ivs])

    out = np.zeros((n_frames, hidden.shape[1]), np.float32)
    j_last = 0
    for f in range(n_frames):
        t = f / fps + time_offset
        hit = None
        for j, iv in enumerate(ivs):
            if iv.start <= t <= iv.end:
                hit = j
                j_last = j
                break
        if hit is None:
            toks = mapping[j_last] or [0]
            out[f] = hidden[toks[-1]]
            continue
        toks = mapping[hit] or [0]
        iv = ivs[hit]
        slots = np.linspace(iv.start, iv.end, len(toks) + 1)
        for tt, t_sep in enumerate(slots[1:]):
            if t <= t_sep:
                out[f] = hidden[toks[tt]]
                break
        else:
            out[f] = hidden[toks[-1]]
    return out


def make_encoder(snapshot_dir: Optional[str] = None):
    """BERT encoder if a local snapshot dir is given (and loadable), else
    the deterministic hash fallback."""
    if snapshot_dir:
        return TransformersBertEncoder(snapshot_dir)
    return HashProjectionEncoder()
