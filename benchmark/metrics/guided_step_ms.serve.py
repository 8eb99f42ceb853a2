"""Wall ms per guided DDIM step: the benchmark's spans around each
prompted group's sampling (``generation.sample_windows``) over the steps
they ran (windows x steps)."""


def read(s: dict):
    steps = s.get("guided_steps")
    return 1e3 * s["span_host_s"]["sample_guided"] / steps if steps else None
