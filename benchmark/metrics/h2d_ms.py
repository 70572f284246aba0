"""Device time of host-to-device copies per step in the traced block
(the profiler's HtoD memcpy records)."""


def read(facts):
    tr = facts.get("trace")
    if not tr:
        return None
    return tr["h2d_s"] * 1e3 / tr["steps"]
