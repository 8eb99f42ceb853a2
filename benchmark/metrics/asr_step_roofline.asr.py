"""A decode step against its roofline, %: each profiled step's bytes (the
decoder's bf16 weights and tied head, the cross-attention keys and values
of every row, the self-attention cache up to the step) over 3.35 TB/s,
over the device time of the kernels launched inside the program's
``asr.decode`` spans."""


def read(s: dict):
    a = s.get("asr", {})
    return 100.0 * a["decode_bound_s"] / a["decode_device_s"] if a.get("decode_device_s") else None
