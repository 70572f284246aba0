"""The operation and byte counters against hand sums of the layer
shapes."""

from benchmark.counters import (resnext50, text_embedding,
                                text_transformer, vit_b14)


def test_resnext50_operations_by_hand():
    # stem 112^2 * 64 * 3 * 49; per stage: conv1 at the input's
    # resolution, the grouped 3x3 (width / 32 inputs a group), conv3, and
    # the head block's downsample at the output's resolution
    macs = 112 * 112 * 64 * 3 * 49
    c_in, h = 64, 56
    for planes, n, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2),
                              (512, 3, 2)):
        width, c_out = planes * 2, planes * 4
        for i in range(n):
            ho = h // stride if i == 0 else h
            macs += h * h * width * c_in + ho * ho * width * (width // 32) * 9 \
                + ho * ho * c_out * width
            if i == 0:
                macs += ho * ho * c_out * c_in
            h, c_in = ho, c_out
    assert resnext50.flops(224) == 2 * macs
    assert abs(macs / 1e9 - 4.23) < 0.01   # torchvision's 4.23 GMACs


def test_resnext50_bytes_by_hand():
    b = 512
    want = b * 224 * 224 * 3 * 2 + resnext50.weight_elems() * 2 \
        + b * 2048 * 4 + b * 7 * 7 * 2048 * 2
    assert resnext50.bytes_per_batch(b, 224) == want
    assert 22.9e6 < resnext50.weight_elems() < 23.0e6


def test_vit_b14_operations_by_hand():
    n, c = 257, 768
    per_block = n * c * (3 * c + c + 4 * c + 4 * c) + 2 * n * n * c
    macs = 12 * per_block + 256 * c * 588
    assert vit_b14.flops(224) == 2 * macs
    assert abs(macs / 1e9 - 23.16) < 0.01  # 12 x 1.92 G + 0.12 G


def test_text_encoders_by_hand():
    assert text_embedding.flops(512, 25, 512) == 0.0
    macs = 25 * 512 * (3 * 512 + 512 + 2 * 2048) + 2 * 25 * 25 * 512
    assert text_transformer.flops(2, 25, 512) == 2 * 2 * macs
