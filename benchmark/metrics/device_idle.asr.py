"""Share of the traced flushes of the service with its transcription stage
in which no kernel, copy or set ran on the device, %."""


def read(s: dict):
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s.get("window_s") else None
