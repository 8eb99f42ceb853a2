"""Mean host ms of a guided denoising step, its conditioning encodes left
out: the program's ``sample.step`` spans inside prompted groups (more than
one guidance branch) in the flushes the tracer recorded with the profiler
off."""


def read(s: dict):
    f = s.get("program", {}).get("free_prompted", {}).get("sample.step")
    return 1e3 * f["host_s"] / f["calls"] if f and f["calls"] else None
