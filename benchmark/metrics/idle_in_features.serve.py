"""Share of the profiled flushes' device-idle time during which the
service's thread was inside a request's featurization (the program's
``serve.features`` span), %."""


def read(s: dict):
    p = s.get("program", {})
    split = p.get("idle_split")
    return 100.0 * split.get("serve.features", 0.0) / p["idle_s"] if split and p.get("idle_s") else None
