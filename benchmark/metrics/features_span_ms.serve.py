"""Mean host ms of a request's featurization: the program's
``serve.features`` spans in the flushes the tracer recorded with the
profiler off."""


def read(s: dict):
    f = s.get("program", {}).get("free", {}).get("serve.features")
    return 1e3 * f["host_s"] / f["calls"] if f and f["calls"] else None
