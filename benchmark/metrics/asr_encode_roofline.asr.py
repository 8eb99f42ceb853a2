"""Whisper's encoder against its roofline in the service, %: the bound of
each profiled encode at ``max_batch`` windows (``roofline_asr``, its FLOPs
over the bf16 peak) over the device time of the kernels launched inside the
program's ``asr.encode`` spans."""


def read(s: dict):
    a = s.get("asr", {})
    return 100.0 * a["encode_bound_s"] / a["encode_device_s"] if a.get("encode_device_s") else None
