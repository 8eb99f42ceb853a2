"""K2's share of its roofline in the service: the bound of the guided
steps' block-stack passes at K x max_batch samples (K the group's guidance
branches) over the device time of every kernel launched inside the spans
around the prompted groups' sampling (``generation.sample_windows``): the
work K2 exists for, whatever implements it."""


def read(s: dict):
    dev = s.get("span_device_s", {}).get("sample_guided")
    bound = s.get("bound_s", {}).get("k2")
    return 100.0 * bound / dev if dev and bound else None
