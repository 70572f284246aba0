"""A whole ResNeXt stage in one launch (K3a and K3b) for the PyTorch port.

Counterpart of ``fused_stage_hwbc`` (K3a: the stage with its full spatial
extent resident) and ``fused_stage_banded`` (K3b: banded over N output
rows, halo rows recomputed per band) of
``multimodal_baby_tpu/ops/bottleneck_hwbc.py``, and of its
``stage_reference``. Both TPU kernels compute the chain of the stage's
blocks; one Hopper kernel (``csrc/stage.cu``) serves both: ``fused_stage``
runs it with one band, ``fused_stage_banded`` with bands of N rows. It takes
bf16 blocks (``ops.bottleneck.fold_block_params``), int8 blocks
(``ops.quant.fold_block_params_q``) or int8-transport blocks
(``ops.quant.fold_block_params_t``: the TPU kernels' transport mode, K10a),
NHWC at the public functions.

On a CUDA tensor the wrappers launch the kernel and raise on anything it
cannot take; on a CPU tensor they run ``stage_reference``.
``fused_stage.launches`` and ``fused_stage_banded.launches`` count bf16 and
int8 launches, ``.launches_t`` transport launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

from multimodal_baby_tpu_torch.ops import _build
from multimodal_baby_tpu_torch.ops.bottleneck import (
    _Q_ORDER, _check_args, _out_size, _ptrs, block_dims, block_mode,
    block_reference)

__all__ = ["stage_reference", "fused_stage", "fused_stage_banded",
           "MAX_STAGE_BLOCKS"]

MAX_STAGE_BLOCKS = 6  # ResNeXt-50's longest stage (layer 3)

Folded = Dict[str, torch.Tensor]


def stage_reference(x: torch.Tensor, fws: Sequence[Folded],
                    strides: Sequence[int]) -> torch.Tensor:
    """The stage's plain version: its blocks' plain versions in a chain
    (``ops.bottleneck.block_reference``), on x's device."""
    for fw, s in zip(fws, strides):
        x = block_reference(x, fw, stride=s)
    return x


def _check_stage(x: torch.Tensor, fws: Sequence[Folded],
                 strides: Sequence[int], band: int) -> None:
    def need(cond, msg):
        if not cond:
            raise ValueError(f"fused_stage: {msg}")

    need(1 <= len(fws) <= MAX_STAGE_BLOCKS and len(fws) == len(strides),
         f"needs 1 to {MAX_STAGE_BLOCKS} blocks, one stride each; got "
         f"{len(fws)} blocks, {len(strides)} strides")
    need(all(s == 1 for s in strides[1:]), "a stride only in the first block")
    width, cout = block_dims(fws[0])
    need(all(block_dims(fw) == (width, cout) for fw in fws),
         "every block needs one width and one Cout")
    need(len({fw["w1"].dtype for fw in fws}) == 1,
         "every block needs one kind of fold (bf16, int8 or transport)")
    B, H, W, _ = x.shape
    ho = _out_size(H, strides[0])
    need(band >= 1 and ho % band == 0,
         f"band {band} must divide the output rows {ho}")
    # each block as the per-block kernels take it, at its input's shape
    shape = tuple(x.shape)
    for fw, s in zip(fws, strides):
        _check_args(x, fw, s, shape)
        shape = (B, _out_size(shape[1], s), _out_size(shape[2], s), cout)


_MODES = {"bf16": 0, "q": 1, "t": 2}  # mmb_stage's mode argument


def _launch(x: torch.Tensor, fws: Sequence[Folded], strides: Sequence[int],
            band: int) -> torch.Tensor:
    _check_stage(x, fws, strides, band)
    lib = _build.library()
    B, H, W, cin = x.shape
    width, cout = block_dims(fws[0])
    Ho, Wo = _out_size(H, strides[0]), _out_size(W, strides[0])

    def empty(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device=x.device)

    mid = fws[0]["w1"].dtype  # h1, h2: bf16 in the transport mode too
    h1, h2 = empty(mid, B, H, W, width), empty(mid, B, Ho, Wo, width)
    t0, t1, out = (empty(x.dtype, B, Ho, Wo, cout) for _ in range(3))
    bar = torch.zeros(2, dtype=torch.int32, device=x.device)
    ptrs: List[int | None] = []
    for fw in fws:
        ptrs += _ptrs(fw, _Q_ORDER)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_strides = (ctypes.c_int * len(strides))(*strides)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mmb_stage(
            _MODES[block_mode(x, fws[0])], len(fws), c_ptrs, c_strides,
            x.data_ptr(), h1.data_ptr(), h2.data_ptr(), t0.data_ptr(),
            t1.data_ptr(), out.data_ptr(), bar.data_ptr(), B, H, W, cin,
            width, cout, band, stream)
    _build.check(lib, code, "fused_stage")
    return out


def _dispatch(wrapper, x, fws, strides, band):
    if x.device.type == "cpu":
        return stage_reference(x, fws, strides)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stage: no kernel for device {x.device}")
    out = _launch(x, fws, strides, band)
    transport = block_mode(x, fws[0]) == "t"
    counter = "launches_t" if transport else "launches"
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    return out


def fused_stage(x: torch.Tensor, fws: Sequence[Folded],
                strides: Sequence[int]) -> torch.Tensor:
    """K3a: every block of a stage (or of a stage's tail) in one launch,
    the full output extent as one band. ``x`` NHWC bf16 or int8; a stride
    only in the first block."""
    return _dispatch(fused_stage, x, fws, strides,
                     _out_size(x.shape[1], strides[0]) if len(strides) else 1)


def fused_stage_banded(x: torch.Tensor, fws: Sequence[Folded],
                       strides: Sequence[int], band: int) -> torch.Tensor:
    """K3b: the stage in one launch, banded over ``band`` output rows of
    every image, each band recomputing the halo rows its 3x3 convolutions
    need (``band`` must divide the output rows)."""
    return _dispatch(fused_stage_banded, x, fws, strides, band)


fused_stage.launches = 0
fused_stage.launches_t = 0
fused_stage_banded.launches = 0
fused_stage_banded.launches_t = 0
