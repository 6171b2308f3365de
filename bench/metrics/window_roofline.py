"""window_roofline: the bound of all the window's hashing work
(``bench/roofline.py``) over the traced window's wall time on each card,
in percent: the whole window's share of what the card could do, which
bounds any kernel's gain."""


def read(m):
    t = m.get("trace")
    if not t or not t["busy_s"] or not m.get("bound_s"):
        return None
    return 100.0 * m["bound_s"] / (t["window_s"] * m["chips"])
