"""h2d_bytes_per_tok: bytes of host arrays the program sent to the card in
the window (``stream.staged_bytes()``, under ``staged_bytes``) an input
token."""


def read(m):
    if not m.get("staged_bytes") or not m.get("tokens"):
        return None
    return m["staged_bytes"] / m["tokens"]
