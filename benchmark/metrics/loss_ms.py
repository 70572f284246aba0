"""Device time per step in the loss: the similarity and the logit scale
(``joint_forward``), then the InfoNCE and the metrics (``loss_fn``): the
CUDA events of the program's ``mmb/loss`` spans in the traced block,
summed per step (host time on the CPU)."""

from benchmark.spans import layer_ms


def read(facts):
    return layer_ms(facts, "mmb/loss")
