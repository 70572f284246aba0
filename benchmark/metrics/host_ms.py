"""Host time per step (a train step with its ``device_batch``) or per
embedding call: the host clock in the program's root spans of the
traced block, less the time in its ``wait`` spans (where the host blocks
on the card): the host's own work of dispatching the step."""

from benchmark.spans import summary


def read(facts):
    s = summary(facts)
    return None if s is None else s["host_ms"]
