"""BEAT2 dataset directory -> windowed caches.

Counterpart of ``syntalker_tpu/data/beat_builder.py``: scan the BEAT2 layout
(``smplxflame_30/*.npz``, ``wave16k/*.wav``, ``textgrid/*.TextGrid``,
``sem/*.txt``, ``train_test_split.csv``), filter by speaker and split, build
the vocab, and preprocess every clip into a :class:`BeatCache`. The split
file is read with the standard ``csv`` module (the card machine has no
pandas).
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Optional, Sequence

from syntalker_tpu_torch.data.cache import BeatCache, ClipConfig, preprocess_clip
from syntalker_tpu_torch.data.vocab import Vocab, build_vocab

log = logging.getLogger("syntalker")

POSE_DIR = "smplxflame_30"
WAVE_DIR = "wave16k"
TEXT_DIR = "textgrid"
SEM_DIR = "sem"  # BEAT semantic-relevance tsv per clip (--sem_rep)


def read_split(data_path: str | Path, split: str, speakers: Sequence[int]) -> list[str]:
    """Clip ids of a split for the chosen speakers (beat_sep_lower.py:65-74)."""
    with open(Path(data_path) / "train_test_split.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    wanted = set(speakers)
    return sorted(r["id"] for r in rows if r["type"] == split and int(r["id"].split("_")[0]) in wanted)


def build_beat_cache(
    data_path: str | Path,
    cache_root: str | Path,
    *,
    split: str = "train",
    speakers: Sequence[int] = (2,),
    cfg: ClipConfig = ClipConfig(),
    vocab: Optional[Vocab] = None,
    smplx_model=None,
    rebuild: bool = False,
) -> tuple[BeatCache, Vocab]:
    """Preprocess all clips of a split into `cache_root/split`. Returns the
    cache and the vocab (built from the training TextGrids when absent)."""
    data_path = Path(data_path)
    cache_dir = Path(cache_root) / split
    if (cache_dir / "index.json").exists() and not rebuild:
        log.info(f"cache hit: {cache_dir}")
        cache = BeatCache.open(cache_dir)
        vocab = vocab or _load_or_build_vocab(data_path, cache_root, speakers)
        return cache, vocab

    ids = read_split(data_path, split, speakers)
    log.info(f"building {split} cache: {len(ids)} clips, speakers {list(speakers)}")
    vocab = vocab or _load_or_build_vocab(data_path, cache_root, speakers)

    cache = BeatCache(cache_dir)
    for clip_id in ids:
        pose = data_path / POSE_DIR / f"{clip_id}.npz"
        wav = data_path / WAVE_DIR / f"{clip_id}.wav"
        tg = data_path / TEXT_DIR / f"{clip_id}.TextGrid"
        if not pose.exists() or not wav.exists():
            log.warning(f"skipping {clip_id}: missing pose/audio file")
            continue
        # per-frame semantic scores (SRGR) when the BEAT sem annotations are
        # present (reference --sem_rep, beat_sep_lower.py:579-596)
        sem = data_path / SEM_DIR / f"{clip_id}.txt"
        arrays = preprocess_clip(
            pose,
            wav,
            tg if tg.exists() else None,
            vocab,
            cfg,
            smplx_model=smplx_model,
            sem_path=sem if sem.exists() else None,
        )
        cache.add_clip(clip_id, arrays, cfg, is_test=(split == "test"))
        log.info(f"cached {clip_id}: {arrays['poses'].shape[0]} frames")
    cache.save_index()
    return cache, vocab


def _load_or_build_vocab(data_path: Path, cache_root, speakers) -> Vocab:
    vpath = Path(cache_root) / "vocab.json"
    if vpath.exists():
        return Vocab.load(vpath)
    tg_dir = data_path / TEXT_DIR
    grids = sorted(tg_dir.glob("*.TextGrid")) if tg_dir.exists() else []
    v = build_vocab(grids)
    if grids:
        vpath.parent.mkdir(parents=True, exist_ok=True)
        v.save(vpath)
    return v
