"""Set-up: from the process's start (imports, the kernels' build where it
is not on disk, weights, the pool, the model, the check steps and the
warm-up) to the window's start, on the host clock."""


def read(facts):
    return facts["setup_s"]
