"""The device's idle share in the traced block: 1 - (the union of kernel,
copy and set intervals) / (the block's span from its first device
operation to its last), in percent."""


def read(facts):
    tr = facts.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
