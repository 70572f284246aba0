"""The vision trunk's device time per step: the mean over the window of
the time between CUDA events that a forward pre-hook and a forward hook
record on ``model.vision_encoder.model``."""


def read(facts):
    ms = facts.get("trunk_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
