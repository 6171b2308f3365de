"""lsh_us_per_doc: host microseconds a document in the LSH index and the
verify, i.e. in ``add_batch`` outside ``signature_many`` (the benchmark's
own timers around both calls)."""


def read(m):
    calls, sign = m.get("calls_s"), m.get("sign_s")
    if not calls or not sign or not m.get("docs"):
        return None
    return (sum(calls) - sum(sign)) / m["docs"] * 1e6
