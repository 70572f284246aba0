"""Device time per step in the vision trunk's backward: the CUDA events of
the program's ``mmb/vjp/*`` spans (``PlainVJP.backward`` of K5 and K6,
inside ``mmb/backward``) in the traced block, summed per step (host time
on the CPU). None where the program records no such span."""

from benchmark.spans import summary

PREFIX = "mmb/vjp/"


def read(facts):
    s = summary(facts)
    if s is None:
        return None
    ms = [v for k, v in s["device_ms"].items() if k.startswith(PREFIX)]
    return sum(ms) if ms else None
