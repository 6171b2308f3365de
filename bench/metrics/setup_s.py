"""setup_s: seconds from the start of the process to the start of the
measured window: imports, the card's start, the kernels' build or load,
the parameters, the traffic's set-up and the warm-up."""


def read(m):
    return m["setup_s"]
