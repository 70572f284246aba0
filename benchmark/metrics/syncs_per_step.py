"""Host waits on the card per step or embedding call in the traced block:
the program's ``wait`` spans, plus the synchronizing calls that
``torch.cuda.set_sync_debug_mode("warn")`` counted outside them. None on
the CPU, where nothing is counted."""

from benchmark.spans import summary


def read(facts):
    s = summary(facts)
    return None if s is None else s["syncs"]
