"""The service's model FLOPs over the traced flushes' wall time at the
H100's bf16 peak, %: Whisper's encoder, cross-attention keys and values,
prompt and kept tokens for the real requests, and the MDM's encode, K1
windows and decode of their rows."""

from benchmark.roofline import PEAK_BF16


def read(s: dict):
    flop = s.get("model_flop")
    return 100.0 * flop / (s["window_s"] * PEAK_BF16) if flop and s.get("window_s") else None
