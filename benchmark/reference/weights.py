"""Seeded weights: every leaf of a configuration drawn from one seed on the
device, in two large calls (one normal draw, one uniform draw, sliced in
the order of the spec). The benchmark hands the result to the program and
draws it again for the reference, so the two sides start from the same
numbers and the reference takes nothing that the program made.

A spec is a list of ``(name, shape, rule)``; a rule is a tuple:

- ``("normal", std)``: N(0, std^2);
- ``("uniform", k)``: U(-k, k);
- ``("scale",)``: 1 + 0.1 N(0, 1) (BatchNorm and LayerNorm gains, so that
  a fold of them changes the numbers); ``("scale", g)``: g (1 + 0.1 N);
- ``("shift",)``: 0.1 N(0, 1) (their biases, BatchNorm running means);
- ``("var",)``: U(0.75, 1.25) (BatchNorm running variances);
- ``("embedding",)``: N(0, 1) with row 0 (the padding token) zero;
- ``("zeros",)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], tuple]]

_NORMAL = ("normal", "scale", "shift", "embedding")
_UNIFORM = ("uniform", "var")


def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``spec`` as an f32 tensor on ``device``."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    n_normal = sum(s for s, (_, _, r) in zip(sizes, spec) if r[0] in _NORMAL)
    n_uniform = sum(s for s, (_, _, r) in zip(sizes, spec)
                    if r[0] in _UNIFORM)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    i_n = i_u = 0
    for (name, shape, rule), size in zip(spec, sizes):
        kind = rule[0]
        if kind in _NORMAL:
            z = normal[i_n:i_n + size].view(shape)
            i_n += size
            if kind == "normal":
                t = z * rule[1]
            elif kind == "scale":
                t = (1.0 + 0.1 * z) * (rule[1] if len(rule) > 1 else 1.0)
            elif kind == "shift":
                t = 0.1 * z
            else:  # embedding
                t = z.clone()
                t[0] = 0.0
        elif kind in _UNIFORM:
            u = uniform[i_u:i_u + size].view(shape)
            i_u += size
            t = (2.0 * u - 1.0) * rule[1] if kind == "uniform" \
                else 0.75 + 0.5 * u
        elif kind == "zeros":
            t = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown rule {rule!r} for {name}")
        out[name] = t.contiguous()
    return out


def check_names(spec: Spec, shapes: Dict[str, Sequence[int]]) -> None:
    """Raise unless ``shapes`` (a program's state dict: name -> shape) holds
    exactly the spec's leaves at the spec's shapes: the program then runs
    the architecture that the configuration states."""
    want = {name: tuple(shape) for name, shape, _ in spec}
    got = {name: tuple(shape) for name, shape in shapes.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    wrong = sorted(n for n in set(want) & set(got) if want[n] != got[n])
    if missing or extra or wrong:
        raise ValueError(f"the program's leaves differ from the "
                         f"configuration's: missing {missing[:5]}, extra "
                         f"{extra[:5]}, other shapes {wrong[:5]}")
