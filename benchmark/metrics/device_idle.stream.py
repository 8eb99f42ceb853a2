"""Share of the traced stream window in which no kernel, copy or set ran
on the device, %: the pushes run back to back, so what is idle is the
session's host time."""


def read(s: dict):
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s.get("window_s") else None
