"""K2's share of its roofline in the prompted steps alone: the bound of
each profiled guided step's block-stack pass at K x max_batch samples (K
and max_batch from its group's ``serve.group`` span) over the device time
of the kernels launched inside the program's prompted ``sample.step``
spans, the conditioning encodes left out, %."""


def read(s: dict):
    p = s.get("program", {})
    dev, bound = p.get("prompted_step_device_s"), p.get("k2_step_bound_s")
    return 100.0 * bound / dev if dev and bound else None
