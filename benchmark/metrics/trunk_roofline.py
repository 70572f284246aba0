"""The trunk's least time over its measured time (``trunk_ms``), in
percent. The least time is the larger of its operations at 989 TFLOP/s
(bf16) and its bytes (input, weights, output, each once) at 3.35 TB/s,
both from the configuration's layer shapes (``counters/``)."""

from benchmark.harness import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def read(facts):
    ms = facts.get("trunk_ms")
    if not ms:
        return None
    least_s = max(facts["trunk_flops_step"] / PEAK_BF16_FLOPS,
                  facts["trunk_bytes_step"] / PEAK_HBM_BYTES)
    return 100.0 * least_s * 1e3 / (sum(ms) / len(ms))
