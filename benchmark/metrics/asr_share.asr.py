"""Share of a flush's wall time inside the transcription stage, %: the
program's ``asr.*`` spans (mel, encode, cross_kv, prefill, decode, each
request's align) over its ``serve.flush`` spans, in the flushes the tracer
recorded with the profiler off."""


def read(s: dict):
    a = s.get("asr", {})
    return 100.0 * a["free_asr_s"] / a["free_flush_s"] if a.get("free_flush_s") else None
