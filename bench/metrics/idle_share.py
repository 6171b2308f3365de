"""idle_share: the share of the traced window in which no operation ran on
the device (torch.profiler's device events; the mean over the cards)."""


def read(m):
    t = m.get("trace")
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
