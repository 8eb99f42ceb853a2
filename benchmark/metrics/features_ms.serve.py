"""Host ms per request of the service's featurization
(``data.audio.onset_amplitude_features``), from the benchmark's span
around each call in the traced flushes."""


def read(s: dict):
    n = s.get("span_calls", {}).get("features")
    return 1e3 * s["span_host_s"]["features"] / n if n else None
