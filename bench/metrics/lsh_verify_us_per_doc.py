"""lsh_verify_us_per_doc: microseconds of the program's span
``dedup.verify`` (the Jaccard verify of the candidates and the inserts, in
document order) a document; the trace's ``spans``."""


def read(m):
    span = ((m.get("trace") or {}).get("spans") or {}).get("dedup.verify")
    if not span or not m.get("docs"):
        return None
    return span["inclusive_s"] / m["docs"] * 1e6
