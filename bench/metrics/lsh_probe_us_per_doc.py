"""lsh_probe_us_per_doc: microseconds of the program's span ``dedup.probe``
(the band keys and the probe of the LSH index) a document; the trace's
``spans``."""


def read(m):
    span = ((m.get("trace") or {}).get("spans") or {}).get("dedup.probe")
    if not span or not m.get("docs"):
        return None
    return span["inclusive_s"] / m["docs"] * 1e6
