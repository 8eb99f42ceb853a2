"""Host ms per stream window that no device work covers: the part of the
benchmark's spans around the pushes (``StreamingMotionSession.push_audio``)
in which no kernel ran, over the windows they completed."""


def read(s: dict):
    n = s.get("windows")
    idle = s.get("span_idle_s", {}).get("push")
    return 1e3 * idle / n if n and idle is not None else None
