"""Deterministic rule-based motion captions, and per-word vectors.

Counterpart of ``syntalker_tpu/data/captions.py``: ``caption_motion`` phrases
a (T, 22, 3) joint track (the HumanML3D SMPL subset) through a fixed grammar
with known part-of-speech tags (stance, tempo, the dominant hand's trend,
amplitude and height, torso turn, stance width), in units of the shoulder
width; ``caption_to_t2m_inputs`` and ``caption_batch`` give the BiGRU text
oracle's inputs (hashed word vectors and POS one-hots); ``hash_word_vector``
is shared with the TMR text side. numpy only.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Tuple

import numpy as np

# 22-joint h3d indices
ROOT, HEAD = 0, 15
L_SHOULDER, R_SHOULDER = 16, 17
L_WRIST, R_WRIST = 20, 21
L_FOOT, R_FOOT = 10, 11

# google universal POS tagset order used by the t2m oracles (15-dim one-hot)
POS_TAGS = (
    "VERB", "NOUN", "DET", "ADP", "NUM", "AUX", "PRON", "ADJ", "ADV",
    "CCONJ", "X", "OTHER", "PART", "SCONJ", "PUNCT",
)
POS_INDEX = {t: i for i, t in enumerate(POS_TAGS)}


@dataclasses.dataclass(frozen=True)
class Caption:
    text: str
    tokens: Tuple[str, ...]
    pos: Tuple[str, ...]


def _phrase(words_pos: List[Tuple[str, str]]) -> Caption:
    tokens = tuple(w for w, _ in words_pos)
    pos = tuple(p for _, p in words_pos)
    return Caption(" ".join(tokens), tokens, pos)


def caption_motion(joints: np.ndarray, fps: int = 30) -> Caption:
    """(T, 22, 3) joint positions -> deterministic caption.

    Thresholds are in units of the skeleton itself (shoulder width) so the
    captions are invariant to global scale — important because self-hosted
    runs may use the synthetic SMPL-X stand-in skeleton.
    """
    j = np.asarray(joints, np.float32)
    scale = float(np.linalg.norm(j[:, L_SHOULDER] - j[:, R_SHOULDER], axis=-1).mean())
    scale = max(scale, 1e-6)
    vel = np.diff(j, axis=0) * fps / scale  # shoulder-widths per second

    root_speed = float(np.linalg.norm(vel[:, ROOT, :2], axis=-1).mean())
    lw_speed = float(np.linalg.norm(vel[:, L_WRIST], axis=-1).mean())
    rw_speed = float(np.linalg.norm(vel[:, R_WRIST], axis=-1).mean())
    head_speed = float(np.linalg.norm(vel[:, HEAD], axis=-1).mean())
    # dominant wrist's height TREND over the window (end minus start, in
    # shoulder widths) — trend, not absolute height, because absolute rest
    # heights depend on the (possibly synthetic) skeleton
    dom = L_WRIST if lw_speed >= rw_speed else R_WRIST
    k = max(1, j.shape[0] // 8)
    trend = float(
        (j[-k:, dom, 1].mean() - j[:k, dom, 1].mean()) / scale
    )

    words: List[Tuple[str, str]] = [("a", "DET"), ("person", "NOUN")]
    # thresholds calibrated to conversational gesture (BEAT-scale speeds are
    # ~0.5-2.5 shoulder-widths/s, far below full-body locomotion datasets)
    words.append(("walks", "VERB") if root_speed > 0.35 else ("stands", "VERB"))
    words.append(("and", "CCONJ"))

    tempo = lw_speed + rw_speed
    if tempo > 2.0:
        words.append(("quickly", "ADV"))
    elif tempo < 1.5:
        words.append(("slowly", "ADV"))
    else:
        words.append(("steadily", "ADV"))

    if trend > 0.04:
        words.append(("raises", "VERB"))
    elif trend < -0.04:
        words.append(("lowers", "VERB"))
    else:
        words.append(("waves", "VERB"))

    hi, lo = max(lw_speed, rw_speed), min(lw_speed, rw_speed)
    if lo > 0.8 * hi:
        words += [("both", "DET"), ("hands", "NOUN")]
    elif lw_speed >= rw_speed:
        words += [("the", "DET"), ("left", "ADJ"), ("hand", "NOUN")]
    else:
        words += [("the", "DET"), ("right", "ADJ"), ("hand", "NOUN")]

    if head_speed > 0.6:
        words += [("while", "SCONJ"), ("nodding", "VERB")]

    # ---- round-4 clauses: finer-grained attributes so pools of 16 rarely
    # contain duplicate captions (duplicate captions cap R-precision: the
    # text cannot prefer one of two identically-captioned motions) --------
    # gesture amplitude: dominant-wrist excursion around its mean position
    amp = float(np.linalg.norm(
        j[:, dom] - j[:, dom].mean(axis=0), axis=-1
    ).std()) / scale
    if amp > 0.30:
        words += [("with", "ADP"), ("broad", "ADJ"), ("gestures", "NOUN")]
    elif amp < 0.12:
        words += [("with", "ADP"), ("small", "ADJ"), ("gestures", "NOUN")]

    # dominant hand's height relative to the shoulder line (absolute pose
    # attribute, scale-invariant; robust to the synthetic skeleton because
    # it is a DIFFERENCE of two tracked points)
    sh_y = j[:, [L_SHOULDER, R_SHOULDER], 1].mean()
    rel_h = float((j[:, dom, 1].mean() - sh_y) / scale)
    if rel_h > 0.15:
        words += [("held", "VERB"), ("high", "ADV")]
    elif rel_h < -0.75:
        words += [("kept", "VERB"), ("low", "ADV")]

    # torso turning: yaw rate of the shoulder line
    sh_vec = j[:, R_SHOULDER, [0, 2]] - j[:, L_SHOULDER, [0, 2]]
    yaw = np.unwrap(np.arctan2(sh_vec[:, 1], sh_vec[:, 0]))
    yaw_rate = float((yaw[-1] - yaw[0]) * fps / max(j.shape[0] - 1, 1))
    if yaw_rate > 0.25:
        words += [("turning", "VERB"), ("left", "ADV")]
    elif yaw_rate < -0.25:
        words += [("turning", "VERB"), ("right", "ADV")]

    # stance width (feet apart vs together), in shoulder widths
    stance = float(np.linalg.norm(
        j[:, L_FOOT, [0, 2]] - j[:, R_FOOT, [0, 2]], axis=-1
    ).mean()) / scale
    if stance > 1.0:
        words += [("feet", "NOUN"), ("apart", "ADV")]
    elif stance < 0.55:
        words += [("feet", "NOUN"), ("together", "ADV")]
    return _phrase(words)




def hash_word_vector(word: str, dim: int = 300) -> np.ndarray:
    """A Gaussian vector seeded by the word's sha1: word-distinct and the
    same in every run (numpy's generator, as in JAX's package)."""
    seed = int.from_bytes(hashlib.sha1(word.lower().encode()).digest()[:4], "little")
    return np.random.default_rng(seed).normal(0, 1, dim).astype(np.float32)


def caption_to_t2m_inputs(
    cap: Caption, dim_word: int = 300, dim_pos: int = 15, max_len: int = 20
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Caption -> (word_embs (L, dim_word), pos_ohot (L, dim_pos), length)
    in the BiGRU oracle's input format (word vectors + POS one-hots,
    t2m_eval_tools.py text pipeline)."""
    n = min(len(cap.tokens), max_len)
    word_embs = np.zeros((max_len, dim_word), np.float32)
    pos_ohot = np.zeros((max_len, dim_pos), np.float32)
    for i in range(n):
        word_embs[i] = hash_word_vector(cap.tokens[i], dim_word)
        pos_ohot[i, POS_INDEX.get(cap.pos[i], POS_INDEX["OTHER"])] = 1.0
    return word_embs, pos_ohot, n


def caption_batch(
    joints_batch: np.ndarray, fps: int = 30, **kw
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[Caption]]:
    """(B, T, 22, 3) -> stacked t2m text inputs + the captions."""
    caps = [caption_motion(j, fps) for j in joints_batch]
    outs = [caption_to_t2m_inputs(c, **kw) for c in caps]
    word_embs = np.stack([o[0] for o in outs])
    pos_ohot = np.stack([o[1] for o in outs])
    lens = np.asarray([o[2] for o in outs], np.int32)
    return word_embs, pos_ohot, lens, caps
