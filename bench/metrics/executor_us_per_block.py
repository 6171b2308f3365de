"""executor_us_per_block: self microseconds of the program's span
``stream.update_many`` a call (the executor's checks and its graph replay
or eager loop, without the stagings nested in it); the trace's
``spans``."""


def read(m):
    span = ((m.get("trace") or {}).get("spans") or {}).get(
        "stream.update_many")
    if not span or not span["count"]:
        return None
    return span["self_s"] / span["count"] * 1e6
