"""The stream's model FLOPs (each window's conditioning encode, 50 denoise
steps and decode) over the traced window's wall time at the H100's bf16
peak, %. The stream's pushes run back to back, so that time is the
windows' own."""

from benchmark.roofline import PEAK_BF16


def read(s: dict):
    flop = s.get("model_flop")
    return 100.0 * flop / (s["window_s"] * PEAK_BF16) if flop and s.get("window_s") else None
