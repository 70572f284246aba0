"""The vision trunk's backward: its least time over its measured time
(``trunk_vjp_ms``), in percent. The least time is the larger of twice
the trunk's forward operations at 989 TFLOP/s (bf16) and its bytes
(``counters/clip_vit_l14.py::trunk_vjp_bytes``) at 3.35 TB/s."""

from benchmark.harness import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, metric_reader


def read(facts):
    ms = metric_reader("trunk_vjp_ms").read(facts)
    if not ms or "trunk_vjp_flops_step" not in facts:
        return None
    least_s = max(facts["trunk_vjp_flops_step"] / PEAK_BF16_FLOPS,
                  facts["trunk_vjp_bytes_step"] / PEAK_HBM_BYTES)
    return 100.0 * least_s * 1e3 / ms
