"""The K1 kernel on a CUDA card: against its plain version at the shapes
of tests/test_hwbc_kernels.py and on the arguments it refuses.

Marked ``gpu``: each test skips, with its reason, where
``torch.cuda.is_available()`` is false. chip_smoke.py runs the same
comparison at the trunk's real shapes. Tolerances as chip_smoke.py: max
error relative to the largest output <= 1e-2 and cosine >= 0.9999 (both
versions bf16 with the same rounding points; f32 sums in other orders can
move a bf16 rounding of h1 or h2 by one ulp).
"""

import pytest
import torch

from multimodal_baby_tpu_torch.ops.bottleneck import (
    bottleneck_reference, fused_bottleneck)

pytestmark = pytest.mark.gpu

REL_TOL = 1e-2
COS_TOL = 0.9999


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_block(cin, width, cout, has_ds, H, batch, device):
    g = torch.Generator().manual_seed(cin + width + H)

    def w(*shape):
        return (torch.randn(*shape, generator=g) * 0.05).to(
            device, torch.bfloat16)

    def b(n):
        return (torch.randn(n, generator=g) * 0.1).to(device)

    fw = {"w1": w(cin, width), "b1": b(width),
          "w2": w(3, 3, width // 32, width), "b2": b(width),
          "w3": w(width, cout), "b3": b(cout)}
    if has_ds:
        fw["wd"], fw["bd"] = w(cin, cout), b(cout)
    x = torch.randn(batch, H, H, cin, generator=g).to(device, torch.bfloat16)
    return x, fw


@pytest.mark.parametrize("stride,has_ds,H,cin,width,cout", [
    (1, False, 8, 256, 128, 256),
    (1, True, 8, 64, 128, 256),
    (2, True, 8, 256, 256, 512),
    (2, True, 16, 64, 128, 256),
    (2, True, 7, 512, 256, 512),    # odd size: 7 -> 4
    (1, False, 2, 2048, 1024, 2048),
])
def test_kernel_matches_plain_version(cuda, stride, has_ds, H, cin, width,
                                      cout):
    x, fw = make_block(cin, width, cout, has_ds, H, 32, cuda)
    before = fused_bottleneck.launches
    got = fused_bottleneck(x, fw, stride=stride)
    want = bottleneck_reference(x, fw, stride=stride)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches == before + 1
    assert got.shape == want.shape
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    cos = torch.nn.functional.cosine_similarity(
        got.float().flatten(), want.float().flatten(), dim=0)
    assert float(err) <= REL_TOL and float(cos) >= COS_TOL


@pytest.mark.parametrize("bad", ["float32", "non_contiguous", "width"])
def test_kernel_refuses_what_it_cannot_take(cuda, bad):
    x, fw = make_block(64, 128, 256, True, 8, 2, cuda)
    if bad == "float32":
        x = x.float()
    elif bad == "non_contiguous":
        x = x.transpose(1, 2)
    else:  # width 96 is not a multiple of 128
        x, fw = make_block(64, 96, 256, True, 8, 2, cuda)
    before = fused_bottleneck.launches
    with pytest.raises(ValueError):
        fused_bottleneck(x, fw, stride=2)
    assert fused_bottleneck.launches == before
