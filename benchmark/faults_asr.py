"""Faults planted in the transcription stage of the timed path, each a
function ``fault(patch)`` as in :mod:`benchmark.faults`. A judge must call
each run they are planted in not correct
(``benchmark/tests/test_bench_asr.py``)."""

from __future__ import annotations


def cache_off_by_one(patch) -> None:
    """Each decode step feeds its token one position late: its keys and
    values go one slot past where they belong, and it attends over the
    unwritten slot before them."""
    from syntalker_tpu_torch.models import whisper as W

    step = W.WhisperASR.step

    def shifted(self, tokens, state):
        state.pos.add_(1)
        out = step(self, tokens, state)
        state.pos.sub_(1)
        return out

    patch(W.WhisperASR, "step", shifted)


def neighbour_cross(patch) -> None:
    """Cross-attention reads the next row's encoder output."""
    from syntalker_tpu_torch.models import whisper as W

    cross_kv = W.WhisperASR.cross_kv
    patch(W.WhisperASR, "cross_kv", lambda self, enc: cross_kv(self, enc.roll(1, 0)))


FAULTS = {f.__name__: f for f in (cache_off_by_one, neighbour_cross)}
