"""Device time per step in the text encoder (``CVCL.encode_text``): the
CUDA events of the program's ``mmb/text`` spans in the traced block,
summed per step (host time on the CPU)."""

from benchmark.spans import layer_ms


def read(facts):
    return layer_ms(facts, "mmb/text")
