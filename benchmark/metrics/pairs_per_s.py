"""Image-utterance pairs trained in the window, over the window (host
clock, from the first step's call to the device's end of the last)."""


def read(facts):
    if facts["kind"] != "train":
        return None
    return facts["steps"] * facts["batch"] / facts["window_s"]
