"""The service's model FLOPs over the traced flushes' wall time at the
H100's bf16 peak, %: the real requests' rows only (padded rows are not
model work), with every branch their guidance needs (each branch's
conditioning encode and denoise passes) and their decode."""

from benchmark.roofline import PEAK_BF16


def read(s: dict):
    flop = s.get("model_flop")
    return 100.0 * flop / (s["window_s"] * PEAK_BF16) if flop and s.get("window_s") else None
