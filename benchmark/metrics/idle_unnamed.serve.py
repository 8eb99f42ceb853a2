"""Share of the profiled flushes' device-idle time during which the
service's thread was in no leaf span of the program (a parent's own time
between its children, or no span at all), %."""


def read(s: dict):
    p = s.get("program", {})
    split = p.get("idle_split")
    return 100.0 * split.get("unnamed", 0.0) / p["idle_s"] if split and p.get("idle_s") else None
