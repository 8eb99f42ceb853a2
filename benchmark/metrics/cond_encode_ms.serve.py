"""Host ms of a prompted window's conditioning encodes, all its guidance
branches together: the program's ``sample.encode`` spans inside prompted
groups (one a window) in the flushes the tracer recorded with the profiler
off."""


def read(s: dict):
    f = s.get("program", {}).get("free_prompted", {}).get("sample.encode")
    return 1e3 * f["host_s"] / f["calls"] if f and f["calls"] else None
