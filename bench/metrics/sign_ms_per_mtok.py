"""sign_ms_per_mtok: milliseconds in ``signature_many`` (the benchmark's
timer around the call, which ends with the signatures on the host) a
million tokens signed."""


def read(m):
    sign = m.get("sign_s")
    if not sign or not m["tokens"]:
        return None
    return sum(sign) * 1e3 / (m["tokens"] / 1e6)
