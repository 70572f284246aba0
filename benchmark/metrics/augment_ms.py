"""Device time per step in the augment (``data/augment.py``: crop, resize,
flip and blur as two batched resampling products, then the ImageNet
normalisation): the CUDA events of the program's ``mmb/augment`` spans
in the traced block, summed per step (host time on the CPU)."""

from benchmark.spans import layer_ms


def read(facts):
    return layer_ms(facts, "mmb/augment")
