"""lsh_candidates_per_doc: LSH candidates a document in the window, by the
program's counter (``dedup.candidate_count()``: the index's and the
batch's candidates of each document), under ``candidates``."""


def read(m):
    if m.get("candidates") is None or not m.get("docs"):
        return None
    return m["candidates"] / m["docs"]
