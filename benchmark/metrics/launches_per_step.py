"""Kernels the device ran per step in the traced block (the profiler's
kernel records; copies and sets are not launches). A count: it repeats
exactly."""


def read(facts):
    tr = facts.get("trace")
    if not tr:
        return None
    return tr["kernels"] / tr["steps"]
