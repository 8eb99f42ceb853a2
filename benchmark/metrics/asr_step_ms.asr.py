"""Host ms of one greedy decode step: the program's ``asr.decode`` spans
over the steps they ran (their ``steps``), in the flushes the tracer
recorded with the profiler off."""


def read(s: dict):
    a = s.get("asr", {})
    return 1e3 * a["free_decode_s"] / a["free_steps"] if a.get("free_steps") else None
