"""tile_ms_per_mtok: milliseconds of the program's span ``dedup.tile`` (the
host's tiling of a group's documents into chunk blocks) a million tokens
signed; the trace's ``spans``."""


def read(m):
    span = ((m.get("trace") or {}).get("spans") or {}).get("dedup.tile")
    if not span or not m.get("tokens"):
        return None
    return span["inclusive_s"] * 1e3 / (m["tokens"] / 1e6)
