"""plan_launches_per_mtok: launches of the plan kernel in the window by the
program's own counter (``sketch_fused.launch_counts()["plan"]``, which
counts a CUDA-graph replay's launches), a million input tokens. Nothing
to read where no plan kernel ran."""


def read(m):
    if not m.get("launches") or not m["tokens"]:
        return None
    return m["launches"] / (m["tokens"] / 1e6)
