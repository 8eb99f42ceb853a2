"""Minimal Praat TextGrid parser (word-alignment tiers).

Counterpart of ``syntalker_tpu/data/textgrid.py``: BEAT2 ships long-format
TextGrids with one IntervalTier of word alignments; this parser reads that
format, long and short forms, with no dependency.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import List


@dataclasses.dataclass(frozen=True)
class Interval:
    min_time: float
    max_time: float
    mark: str


@dataclasses.dataclass(frozen=True)
class Tier:
    name: str
    intervals: List[Interval]


def parse_textgrid(path: str | Path) -> List[Tier]:
    """Parse a TextGrid file into tiers of intervals."""
    text = Path(path).read_text(encoding="utf-8", errors="replace")
    tiers: List[Tier] = []

    # long format: item [n]: blocks with intervals [k]: xmin/xmax/text
    item_blocks = re.split(r"item\s*\[\d+\]\s*:", text)[1:]
    if item_blocks:
        for block in item_blocks:
            name_m = re.search(r'name\s*=\s*"([^"]*)"', block)
            name = name_m.group(1) if name_m else ""
            intervals = []
            for m in re.finditer(
                r"intervals\s*\[\d+\]\s*:\s*"
                r"xmin\s*=\s*([\d.eE+-]+)\s*"
                r"xmax\s*=\s*([\d.eE+-]+)\s*"
                r'text\s*=\s*"([^"]*)"',
                block,
            ):
                intervals.append(Interval(float(m.group(1)), float(m.group(2)), m.group(3)))
            tiers.append(Tier(name, intervals))
        if any(t.intervals for t in tiers):
            return tiers

    # short format fallback: sequences of xmin, xmax, "text" triplets
    triplet = re.findall(r'([\d.eE+-]+)\s*\n\s*([\d.eE+-]+)\s*\n\s*"([^"]*)"', text)
    if triplet:
        intervals = [Interval(float(a), float(b), c) for a, b, c in triplet]
        return [Tier("words", intervals)]
    return tiers


def words_tier(path: str | Path) -> List[Interval]:
    """First tier's intervals (the word alignment used by the loaders)."""
    tiers = parse_textgrid(path)
    if not tiers:
        return []
    return tiers[0].intervals
