"""stage_ms_per_mtok: milliseconds of the program's span ``stream.stage``
(a host array staged in pinned memory and its copy to the card issued) a
million input tokens; the trace's ``spans``."""


def read(m):
    span = ((m.get("trace") or {}).get("spans") or {}).get("stream.stage")
    if not span or not m.get("tokens"):
        return None
    return span["inclusive_s"] * 1e3 / (m["tokens"] / 1e6)
