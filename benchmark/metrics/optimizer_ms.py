"""Device time per step in the optimizer: the zero-fill of unused
gradients and AdamW's ``step()``: the CUDA events of the program's
``mmb/optimizer`` spans in the traced block, summed per step (host time
on the CPU)."""

from benchmark.spans import layer_ms


def read(facts):
    return layer_ms(facts, "mmb/optimizer")
