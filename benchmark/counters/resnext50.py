"""ResNeXt-50 32x4d's operations and bytes from its layer shapes (the
same whatever implements a layer). Operations are the convolutions'
multiply-adds, two each; BatchNorm, ReLU and the pools are not counted.
Bytes are the trunk's input, its weights and its outputs, each once, in
the types the configuration runs them in."""

from __future__ import annotations

STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
GROUPS = 32


def _out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def layers(px: int):
    """(out_h, out_w, c_out, c_in per group, k) of every convolution."""
    out = []
    h = _out(px, 7, 2, 3)
    out.append((h, h, 64, 3, 7))
    h = _out(h, 3, 2, 1)                      # max-pool
    c_in = 64
    for planes, n, stride in STAGES:
        width = planes * 4 // 64 * GROUPS
        c_out = planes * 4
        for i in range(n):
            s = stride if i == 0 else 1
            ho = _out(h, 3, s, 1)
            out.append((h, h, width, c_in, 1))            # conv1
            out.append((ho, ho, width, width // GROUPS, 3))  # conv2
            out.append((ho, ho, c_out, width, 1))         # conv3
            if i == 0:
                out.append((ho, ho, c_out, c_in, 1))      # downsample
            h, c_in = ho, c_out
    return out


def flops(px: int) -> float:
    """Forward operations per frame."""
    return float(sum(2 * ho * wo * co * ci * k * k
                     for ho, wo, co, ci, k in layers(px)))


def weight_elems() -> int:
    """The convolutions' weights (BatchNorm's vectors are a rounding
    error and folded away on the kernel path)."""
    total, c_in = 64 * 3 * 49, 64
    for planes, n, _ in STAGES:
        width = planes * 4 // 64 * GROUPS
        c_out = planes * 4
        for i in range(n):
            total += width * c_in + width * (width // GROUPS) * 9 \
                + c_out * width
            if i == 0:
                total += c_out * c_in
            c_in = c_out
    return total


def bytes_per_batch(batch: int, px: int) -> float:
    """Input frames (bf16), weights (bf16), the pooled features (f32) and
    the feature map (bf16), each once."""
    side = -(-px // 32)
    return float(batch * px * px * 3 * 2 + weight_elems() * 2
                 + batch * 2048 * 4 + batch * side * side * 2048 * 2)


OUT_DIM = 2048
