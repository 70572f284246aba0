"""Model operations of every step in the window (``counters/``, from the
configuration's shapes) over the window times the H100's dense bf16 peak
(989 TFLOP/s), in percent."""

from benchmark.harness import PEAK_BF16_FLOPS


def read(facts):
    return (100.0 * facts["step_flops"] * facts["steps"]
            / (facts["window_s"] * PEAK_BF16_FLOPS))
