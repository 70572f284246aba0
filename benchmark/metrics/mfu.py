"""The whole step's share of the dense bf16 peak in the traced block:
model operations of its steps over the device span of the block (first
device operation to last) times 989 TFLOP/s, in percent. It bounds the
trunk's roofline share: a step whose trunk gains shows here too."""

from benchmark.harness import PEAK_BF16_FLOPS


def read(facts):
    tr = facts.get("trace")
    if not tr:
        return None
    return (100.0 * facts["step_flops"] * tr["steps"]
            / (tr["window_s"] * PEAK_BF16_FLOPS))
