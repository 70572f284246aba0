"""The embedding text encoder: lookups and a sum, no products."""


def flops(batch: int, length: int, dim: int) -> float:
    """Forward operations of a batch of utterances."""
    return 0.0
