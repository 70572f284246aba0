"""The 95th percentile (nearest rank) of every step's or call's time in
the window, each from one end-of-step CUDA event to the next (the first
from an event at the window's start), recorded with no host sync. An
embedding call syncs the host at its end, so there each time holds the
host's share of the call too."""

from benchmark.harness import percentile


def read(facts):
    return percentile(facts["step_ms"], 95)
