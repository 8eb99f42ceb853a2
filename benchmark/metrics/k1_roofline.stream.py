"""K1's share of its roofline in the stream: the bound of the traced
windows' 50-step DDIM at B=1 over the device time of every kernel launched
inside the benchmark's span around the window's sampling
(``generation.fused_window``)."""


def read(s: dict):
    dev = s.get("span_device_s", {}).get("sample")
    bound = s.get("bound_s", {}).get("k1")
    return 100.0 * bound / dev if dev and bound else None
