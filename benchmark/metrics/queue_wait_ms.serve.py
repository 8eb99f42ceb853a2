"""Mean ms a request waited in the service's queue, from ``submit`` to the
start of its flush: the program's ``serve.queued`` spans in the flushes the
tracer recorded with the profiler off."""


def read(s: dict):
    q = s.get("program", {}).get("free", {}).get("serve.queued")
    return 1e3 * q["host_s"] / q["calls"] if q and q["calls"] else None
