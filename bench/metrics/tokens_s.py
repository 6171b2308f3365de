"""tokens_s: input tokens whose results the entry point returned in the
window, over the window's wall time (host clock, ending after the device
has finished)."""


def read(m):
    return m["tokens"] / m["window_s"] if m["window_s"] else None
