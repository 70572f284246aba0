"""Frames embedded in the window, over the window (host clock)."""


def read(facts):
    if facts["kind"] != "embed":
        return None
    return facts["steps"] * facts["batch"] / facts["window_s"]
