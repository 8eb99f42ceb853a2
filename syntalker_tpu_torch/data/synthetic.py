"""Synthetic multi-clip, multi-speaker corpus in the BEAT2 directory layout.

Counterpart of ``syntalker_tpu/data/synthetic.py``, the same bytes for the
same arguments: ``smplxflame_30/*.npz``, ``wave16k/*.wav``,
``textgrid/*.TextGrid``, ``sem/*.txt`` and ``train_test_split.csv``, so that
the whole training data path (speaker and split filters, the vocab, the
window cache, the device-resident dataset) runs without the real dataset.

Two clip sources:

- **procedural clips** with a known beat structure: a speaker-specific
  tempo drives both percussive audio onsets and beat-locked upper-body
  gesture impulses; speech-band syllable bursts give the amplitude
  envelope and the word intervals; sem spans mark the gesture-active
  regions.
- **perturbed variants of a base clip** (an npz and wav of real mocap):
  random crops re-labeled to other speakers with small smooth joint
  perturbations.

A procedural clip is deterministic in (seed, speaker, index). A perturbed
clip's generator is seeded by the hash of a tuple holding a string, which
Python salts per process unless ``PYTHONHASHSEED`` is set, as in JAX's
package.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

FPS = 30
SR = 16000

# joints driven by the beat gesture (axis-angle indices into the 165-dof
# vector): shoulders/elbows/wrists — the "upper" body-part group
_BEAT_JOINTS_AA = [np.arange(16 * 3, 22 * 3)]  # collar..wrist span
_WORDS = (
    "the quick brown fox jumps over lazy dog while speaker waves both "
    "hands and nods head to the steady beat of music".split()
)


@dataclasses.dataclass(frozen=True)
class SynthClip:
    clip_id: str
    poses: np.ndarray  # (N, 165)
    trans: np.ndarray  # (N, 3)
    betas: np.ndarray  # (300,)
    expressions: np.ndarray  # (N, 100)
    audio: np.ndarray  # (S,) float32 16 kHz
    words: list  # [(start_s, end_s, word)]
    sem_spans: list  # [(start_s, end_s, score, keyword)]
    beat_times: np.ndarray  # ground-truth beat positions (seconds)


def _smooth_noise(rng, n, dims, cutoff_hz=1.0, fps=FPS):
    """Low-pass filtered gaussian wander (per-joint idle motion)."""
    x = rng.normal(size=(n, dims)).astype(np.float32)
    # single-pole IIR low-pass
    a = float(np.exp(-2 * np.pi * cutoff_hz / fps))
    out = np.empty_like(x)
    acc = np.zeros(dims, np.float32)
    for i in range(n):
        acc = a * acc + (1 - a) * x[i]
        out[i] = acc
    return out


def speaker_tempo_bpm(speaker: int) -> float:
    """Deterministic per-speaker tempo: 84..132 bpm."""
    return 84.0 + (speaker * 37) % 49


def synth_clip(
    speaker: int,
    index: int,
    seconds: float,
    *,
    seed: int = 0,
    base_poses: Optional[np.ndarray] = None,
) -> SynthClip:
    """One procedural clip with beat-locked gestures + matching audio."""
    rng = np.random.default_rng(hash((seed, speaker, index)) % 2**32)
    n = int(round(seconds * FPS))
    t = np.arange(n) / FPS

    # ---- beat grid (speaker tempo, slight jitter) ----
    period = 60.0 / speaker_tempo_bpm(speaker)
    beats = np.arange(period, seconds - 0.25, period)
    beats = beats + rng.normal(0, 0.004, beats.shape)  # ±4 ms jitter

    # ---- motion ----
    if base_poses is not None:
        base = base_poses.mean(0).astype(np.float32)
    else:
        base = np.zeros(165, np.float32)
        base[47 * 3 : 55 * 3] = 0.1  # slight finger curl
    poses = np.tile(base, (n, 1))
    poses += 0.02 * _smooth_noise(rng, n, 165, cutoff_hz=0.5)

    # beat-locked gesture impulses on the upper body: each beat triggers an
    # exponentially-decaying arm swing (velocity peak ON the beat, which is
    # what the BeatAlign motion-beat detector keys on)
    impulse = np.zeros(n, np.float32)
    for b in beats:
        k = int(round(b * FPS))
        if k < n:
            impulse[k] = 1.0
    decay = np.exp(-np.arange(int(0.4 * FPS)) / (0.12 * FPS)).astype(np.float32)
    env = np.convolve(impulse, decay)[:n]
    for span in _BEAT_JOINTS_AA:
        phase = rng.uniform(0, 2 * np.pi, len(span)).astype(np.float32)
        amp = rng.uniform(0.15, 0.45, len(span)).astype(np.float32)
        poses[:, span] += (env[:, None] * amp[None, :]) * np.sin(
            2 * np.pi * 1.3 * t[:, None] + phase[None, :]
        ).astype(np.float32)

    # gentle lower-body weight sway + root drift
    poses[:, 3:9] += 0.05 * np.sin(2 * np.pi * 0.25 * t)[:, None].astype(np.float32)
    trans = np.stack(
        [
            0.02 * np.sin(2 * np.pi * 0.2 * t),
            np.zeros(n),
            0.01 * np.sin(2 * np.pi * 0.13 * t + 1.0),
        ],
        axis=1,
    ).astype(np.float32)

    expressions = np.zeros((n, 100), np.float32)
    expressions[:, :3] = 0.2 * np.abs(
        np.sin(2 * np.pi * 2.0 * t)[:, None]
    ).astype(np.float32)  # jaw-ish AU flutter

    # ---- audio: percussive beat bursts + syllable train + noise floor ----
    s = int(round(seconds * SR))
    audio = rng.normal(0, 1e-4, s).astype(np.float32)
    click = (
        np.hanning(int(0.02 * SR)).astype(np.float32)
        * np.sin(2 * np.pi * 1200 * np.arange(int(0.02 * SR)) / SR).astype(np.float32)
    )
    for b in beats:
        k = int(round(b * SR))
        if k + len(click) < s:
            audio[k : k + len(click)] += 0.7 * click
    # speech-ish syllables at ~3.5 Hz in voiced segments (0.5 s on/0.25 off)
    syl = np.zeros(s, np.float32)
    tt = np.arange(s) / SR
    voiced = (np.mod(tt, 0.75) < 0.5).astype(np.float32)
    f0 = 110.0 + 10 * speaker
    harm = sum(
        np.sin(2 * np.pi * f0 * (h + 1) * tt + rng.uniform(0, 6.28)) / (h + 1)
        for h in range(4)
    )
    syl_env = np.clip(np.sin(2 * np.pi * 3.5 * tt), 0, None) ** 2
    syl = (0.25 * harm * syl_env * voiced).astype(np.float32)
    audio = audio + syl
    audio = np.clip(audio, -1.0, 1.0)

    # ---- word intervals over voiced segments ----
    words = []
    wi = (speaker + index) % len(_WORDS)
    seg_start = 0.0
    while seg_start + 0.5 <= seconds:
        w_per_seg = 2
        for j in range(w_per_seg):
            a = seg_start + j * 0.25
            words.append((a, a + 0.24, _WORDS[wi % len(_WORDS)]))
            wi += 1
        seg_start += 0.75

    # ---- sem spans: gesture-active windows around each 4th beat ----
    sem_spans = []
    for k, b in enumerate(beats[::4]):
        sem_spans.append((max(b - 0.1, 0), min(b + 0.5, seconds), 0.5 + 0.1 * (k % 5), "beat"))

    return SynthClip(
        clip_id=f"{speaker}_synthetic_0_{index}_{index}",
        poses=poses,
        trans=trans,
        betas=np.zeros(300, np.float32),
        expressions=expressions,
        audio=audio,
        words=words,
        sem_spans=sem_spans,
        beat_times=beats,
    )


def perturbed_clip(
    base_npz: str | Path,
    base_wav_audio: np.ndarray,
    speaker: int,
    index: int,
    *,
    seconds: float,
    seed: int = 0,
) -> SynthClip:
    """Random crop of a real clip, re-labeled to `speaker`, with smooth
    low-amplitude joint perturbation (marker-noise-like)."""
    rng = np.random.default_rng(hash((seed, "perturb", speaker, index)) % 2**32)
    data = np.load(base_npz, allow_pickle=True)
    poses = np.asarray(data["poses"], np.float32)
    trans = np.asarray(data["trans"], np.float32)
    expr = np.asarray(data["expressions"], np.float32)[:, :100]
    n_total = poses.shape[0]
    n = int(round(seconds * FPS))
    n = min(n, n_total)
    start = int(rng.integers(0, max(n_total - n, 1)))
    start = (start // FPS) * FPS  # whole-second boundary keeps audio aligned
    sl = slice(start, start + n)

    p = poses[sl].copy()
    p += 0.01 * _smooth_noise(rng, p.shape[0], 165, cutoff_hz=0.8)
    a_start = start // FPS * SR
    audio = base_wav_audio[a_start : a_start + int(seconds * SR)].copy()

    words = []  # perturbed clips rely on the real TextGrid being absent
    return SynthClip(
        clip_id=f"{speaker}_scottvar_0_{100 + index}_{100 + index}",
        poses=p,
        trans=trans[sl].copy(),
        betas=np.asarray(data["betas"], np.float32).reshape(-1)[:300],
        expressions=expr[sl].copy(),
        audio=audio,
        words=words,
        sem_spans=[],
        beat_times=np.zeros(0),
    )


# ---------------------------------------------------------------------------
# BEAT2 directory layout writer
# ---------------------------------------------------------------------------


def _write_textgrid(path: Path, words, duration: float):
    """Minimal Praat long-format TextGrid with one 'words' IntervalTier."""
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        "xmin = 0",
        f"xmax = {duration}",
        "tiers? <exists>",
        "size = 1",
        "item []:",
        "    item [1]:",
        '        class = "IntervalTier"',
        '        name = "words"',
        "        xmin = 0",
        f"        xmax = {duration}",
        f"        intervals: size = {len(words)}",
    ]
    for i, (a, b, w) in enumerate(words, 1):
        lines += [
            f"        intervals [{i}]:",
            f"            xmin = {a}",
            f"            xmax = {b}",
            f'            text = "{w}"',
        ]
    path.write_text("\n".join(lines))


def write_clip(root: Path, clip: SynthClip):
    from scipy.io import wavfile

    (root / "smplxflame_30").mkdir(parents=True, exist_ok=True)
    (root / "wave16k").mkdir(exist_ok=True)
    (root / "textgrid").mkdir(exist_ok=True)
    (root / "sem").mkdir(exist_ok=True)

    np.savez(
        root / "smplxflame_30" / f"{clip.clip_id}.npz",
        poses=clip.poses,
        trans=clip.trans,
        betas=clip.betas,
        expressions=clip.expressions,
        gender="neutral",
        model="smplx2020",
        mocap_frame_rate=FPS,
    )
    wavfile.write(
        root / "wave16k" / f"{clip.clip_id}.wav",
        SR,
        (np.clip(clip.audio, -1, 1) * 32767).astype(np.int16),
    )
    duration = len(clip.audio) / SR
    if clip.words:
        _write_textgrid(root / "textgrid" / f"{clip.clip_id}.TextGrid", clip.words, duration)
    if clip.sem_spans:
        with open(root / "sem" / f"{clip.clip_id}.txt", "w") as f:
            for a, b, score, kw in clip.sem_spans:
                f.write(f"{clip.clip_id}\t{a:.3f}\t{b:.3f}\t{b - a:.3f}\t{score:.2f}\t{kw}\n")


def make_corpus(
    root: str | Path,
    *,
    speakers: Sequence[int] = (2, 4, 6, 8),
    clips_per_speaker: int = 4,
    test_fraction: float = 0.25,
    seconds_range: tuple = (8.0, 24.0),
    base_npz: Optional[str | Path] = None,
    base_wav: Optional[str | Path] = None,
    seed: int = 0,
) -> list:
    """Generate the full corpus + train_test_split.csv. Returns clip ids.

    Heterogeneous clip lengths (drawn from seconds_range on whole seconds)
    exercise the bucketed batched eval; each speaker's LAST
    ceil(test_fraction*clips) clips go to the test split, the rest to
    train — so speaker filtering and split filtering compose exactly like
    the reference csv (beat_sep_lower.py:65-74).
    """
    root = Path(root)
    rng = np.random.default_rng(seed)
    base_audio = None
    if base_npz and base_wav and Path(base_npz).exists():
        from syntalker_tpu_torch.data import audio as A

        base_audio, _ = A.load_wav_mono(base_wav, SR)

    rows = []
    ids = []
    for sp in speakers:
        n_test = max(1, int(round(test_fraction * clips_per_speaker)))
        for i in range(clips_per_speaker):
            seconds = float(rng.integers(int(seconds_range[0]), int(seconds_range[1]) + 1))
            if base_audio is not None and i % 3 == 2:
                clip = perturbed_clip(
                    base_npz, base_audio, sp, i, seconds=seconds, seed=seed
                )
            else:
                clip = synth_clip(sp, i, seconds, seed=seed)
            write_clip(root, clip)
            split = "test" if i >= clips_per_speaker - n_test else "train"
            rows.append((clip.clip_id, split))
            ids.append(clip.clip_id)

    import csv

    with open(root / "train_test_split.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "type"])
        w.writerows(rows)
    return ids
