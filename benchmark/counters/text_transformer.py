"""One post-norm transformer encoder layer over the utterance (8 heads,
feed-forward 2048): the in-projection, attention's two products, the
out-projection and the feed-forward pair, two operations a
multiply-add."""

FF = 2048


def flops(batch: int, length: int, dim: int) -> float:
    """Forward operations of a batch of utterances."""
    dense = length * dim * (3 * dim + dim + 2 * FF)
    attn = 2 * length * length * dim
    return 2.0 * batch * (dense + attn)
