"""K12, BatchNorm on batch statistics (``ops/batch_norm.py``), and the
trunk's rule for taking it.

On the CPU: the dispatch rule (``takes_k12``) and the plain path it leaves
alone: on the CPU, in f32, with a weight that needs a gradient under grad
mode, or on running statistics, K12's counters stay where they were and
the block and the stem give the bits of the code before K12 (``old_bn``
and ``old_block``, that code written out here); the route itself, forced
on the CPU, where the wrappers run the plain versions; the plain versions
against ``InferenceBN``; and the launch geometry, which refuses C % 8 != 0
and M < 1.

Marked ``gpu`` (each skips where ``torch.cuda.is_available()`` is false):
the kernel pair against the plain ``InferenceBN`` at every BatchNorm shape
class of the trunk (C 64 to 2048, with the identity and with the fused
downsample where the trunk has them) and at M = 1, 7 and 12,545: outputs
within a norm-relative error of 4e-3 (bf16's half step is 3.9e-3; K12
rounds once where the plain path rounds bn3's output and then the sum),
the fold (``mul``, ``add``) and the updated running buffers within 1e-5
(the plain version's f32 means against K12's f64 sums of f32 partials);
two calls
equal bit for bit; a whole train-mode ResNeXt-50 forward at B = 16 and
64 px in bf16 against the plain conv path within
``tests/test_torch_trunk.py``'s BF16_RTOL, with 53 statistics and 49 apply
launches; and the folded path refolding after K12 moved the running
buffers.
"""

import copy

import pytest
import torch

from multimodal_baby_tpu_torch.models import vision_resnext as VR
from multimodal_baby_tpu_torch.models.vision_resnext import (
    BottleneckX, InferenceBN, ResNeXt50, takes_k12)
from multimodal_baby_tpu_torch.ops import batch_norm as BN
from multimodal_baby_tpu_torch.ops.bottleneck import BN_EPS

OUT_RTOL = 4e-3     # norm-relative, bf16 outputs
VEC_RTOL = 1e-5     # norm-relative, f32 mul, add and running buffers
BF16_RTOL = 0.05    # tests/test_torch_trunk.py: max error / max output


def norm_rel(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm())


def launches():
    return BN.batch_norm_stats.launches, BN.batch_norm_apply.launches


def random_bn(c, gen, device="cpu"):
    bn = InferenceBN(c, device=device)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
        bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return bn


def conv_like(B, C, H, W, gen, dtype=torch.float32):
    """An NCHW view of channels-last data with per-channel offsets and
    scales, as a convolution's output has."""
    x = (torch.randn(B, H, W, C, generator=gen)
         * (0.5 + torch.rand(C, generator=gen))
         + 0.5 * torch.randn(C, generator=gen))
    return x.to(dtype).permute(0, 3, 1, 2)


def random_block(cin, planes, stride, has_ds, gen, device="cpu"):
    block = BottleneckX(cin, planes, stride, has_ds, device="cpu")
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, VR._Conv):
                w = m.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=gen)
                        * (2.0 / fan_in) ** 0.5)
        for name, m in block.named_modules():
            if isinstance(m, InferenceBN):
                m.load_state_dict(random_bn(m.weight.numel(),
                                            gen).state_dict())
    return block.to(device)


# ------------------------------------------ the code before K12, written out

def old_bn(bn, x, batch_stats):
    if not batch_stats:
        mul, add = bn.fold()
        return (x * mul.to(x.dtype)[:, None, None]
                + add.to(x.dtype)[:, None, None])
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(0, 2, 3))
    var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.mul_(0.9).add_((1 - 0.9) * mean)
        bn.running_var.mul_(0.9).add_((1 - 0.9) * var)
    mul = torch.rsqrt(var + BN_EPS) * bn.weight.to(xf.dtype)
    y = (xf - mean[:, None, None]) * mul[:, None, None]
    return (y + bn.bias.to(xf.dtype)[:, None, None]).to(x.dtype)


def old_block(b, x, batch_stats):
    y = torch.relu(old_bn(b.bn1, b.conv1(x), batch_stats))
    y = b.conv2(y, stride=b.stride, padding=1, groups=32)
    y = torch.relu(old_bn(b.bn2, y, batch_stats))
    identity = x
    if b.downsample is not None:
        conv, bn = b.downsample
        identity = old_bn(bn, conv(x, stride=b.stride), batch_stats)
    y = old_bn(b.bn3, b.conv3(y), batch_stats)
    return torch.relu(y + identity)


def buffers(module):
    return [t.clone() for name, t in module.named_buffers()]


# -------------------------------------------------------------- CPU tests

class FakeTensor:
    """What ``takes_k12`` reads of a tensor, each property settable."""

    def __init__(self, cuda=True, dtype=torch.bfloat16, C=64,
                 channels_last=True, requires_grad=False, dim=4):
        self.is_cuda, self.dtype, self.requires_grad = cuda, dtype, \
            requires_grad
        self.shape = (2, C, 4, 4)[:dim]
        self._cl = channels_last

    def dim(self):
        return len(self.shape)

    def is_contiguous(self, memory_format=torch.contiguous_format):
        return self._cl and memory_format == torch.channels_last


class FakeBN:
    def __init__(self, grad=False):
        self.weight = FakeTensor(requires_grad=grad)
        self.bias = FakeTensor()


@pytest.mark.parametrize("case", [
    "takes", "running", "cpu", "f32", "c12", "nchw", "x_grad", "weight_grad",
    "residual_f32", "ds_weight_grad", "weight_grad_no_grad_mode"])
def test_dispatch_rule(case):
    """K12 exactly for batch statistics on CUDA bf16 channels-last tensors
    with C % 8 == 0 and no gradient needed; each condition alone turns it
    off."""
    x, bns, tensors, stats = FakeTensor(), [FakeBN()], None, True
    if case == "running":
        stats = False
    elif case == "cpu":
        x = FakeTensor(cuda=False)
    elif case == "f32":
        x = FakeTensor(dtype=torch.float32)
    elif case == "c12":
        x = FakeTensor(C=12)
    elif case == "nchw":
        x = FakeTensor(channels_last=False)
    elif case == "x_grad":
        x = FakeTensor(requires_grad=True)
    elif case in ("weight_grad", "weight_grad_no_grad_mode"):
        bns = [FakeBN(grad=True)]
    elif case == "residual_f32":
        tensors = (x, FakeTensor(dtype=torch.float32))
    elif case == "ds_weight_grad":
        bns = [FakeBN(), FakeBN(grad=True)]
    tensors = tensors or (x,)
    with torch.set_grad_enabled(case != "weight_grad_no_grad_mode"):
        got = takes_k12(stats, tensors, bns)
    assert got == (case in ("takes", "weight_grad_no_grad_mode"))


@pytest.mark.parametrize("case", ["f32", "bf16", "weight_grad", "running"])
@pytest.mark.parametrize("has_ds", [False, True])
def test_plain_path_is_the_code_before_k12(case, has_ds):
    """On the CPU (f32, or bf16 channels-last), with a weight that needs a
    gradient under grad mode, or on running statistics: no K12 launch, and
    the block's output and running buffers equal the earlier code's bit
    for bit."""
    gen = torch.Generator().manual_seed(1 + has_ds)
    cin = 64 if has_ds else 256
    block = random_block(cin, 64, 2 if has_ds else 1, has_ds, gen)
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    x = torch.relu(conv_like(2, cin, 8, 8, gen, dtype))
    if case == "weight_grad":
        block.bn1.weight.requires_grad_(True)
    else:
        block.requires_grad_(False)
    stats = case != "running"
    old = copy.deepcopy(block)
    before = launches()
    got = block(x, stats)
    want = old_block(old, x, stats)
    assert launches() == before
    assert got.dtype == want.dtype and torch.equal(got, want)
    for a, b in zip(buffers(block), buffers(old)):
        assert torch.equal(a, b)


def test_stem_plain_path_is_the_code_before_k12():
    gen = torch.Generator().manual_seed(3)
    trunk = ResNeXt50(torch.bfloat16, frozen=True, generator=gen)
    trunk.bn1.load_state_dict(random_bn(64, gen).state_dict())
    trunk.requires_grad_(False)
    x = conv_like(2, 3, 32, 32, gen, torch.bfloat16)
    bn = copy.deepcopy(trunk.bn1)
    before = launches()
    got = trunk.stem(x, True)
    y = torch.relu(old_bn(bn, trunk.conv1(x, stride=2, padding=3), True))
    want = torch.nn.functional.max_pool2d(y, 3, stride=2, padding=1)
    assert launches() == before and torch.equal(got, want)
    assert torch.equal(trunk.bn1.running_var, bn.running_var)


@pytest.mark.parametrize("has_ds", [False, True])
def test_forced_route_matches_plain_block(monkeypatch, has_ds):
    """The K12 route forced on the CPU, where the wrappers run their plain
    versions: rows views in and out, the downsample's BatchNorm fused into
    bn3's apply. Within one bf16 step of the plain block (one rounding
    where the plain path has two), running buffers to f32 rounding (means
    over rows in another order), and the wrappers count nothing on the
    CPU."""
    gen = torch.Generator().manual_seed(5 + has_ds)
    cin = 64 if has_ds else 256
    block = random_block(cin, 64, 2 if has_ds else 1, has_ds, gen)
    block.requires_grad_(False)
    x = torch.relu(conv_like(4, cin, 8, 8, gen, torch.bfloat16))
    plain = copy.deepcopy(block)
    calls = []
    monkeypatch.setattr(VR, "takes_k12",
                        lambda *a: calls.append(1) or True)
    before = launches()
    got = block(x, True)
    assert len(calls) == 3 and launches() == before
    assert got.is_contiguous(memory_format=torch.channels_last)
    monkeypatch.setattr(VR, "takes_k12", lambda *a: False)
    want = plain(x, True)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert norm_rel(got, want) <= OUT_RTOL
    for a, b in zip(buffers(block), buffers(plain)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_match_inference_bn(dtype):
    """The kernels' plain versions on rows against ``InferenceBN``'s body
    (NCHW, the same formula): mul, add and buffers to f32 rounding."""
    gen = torch.Generator().manual_seed(7)
    x = conv_like(3, 64, 5, 7, gen, dtype)
    bn = random_bn(64, gen)
    twin = copy.deepcopy(bn)
    rows = x.permute(0, 2, 3, 1).reshape(-1, 64)
    fold = BN.batch_norm_stats(rows, bn.weight, bn.bias, bn.running_mean,
                               bn.running_var)
    out = BN.batch_norm_apply(rows, fold)
    want = torch.relu(twin(x, True)).permute(0, 2, 3, 1).reshape(-1, 64)
    assert out.dtype == dtype
    assert norm_rel(out, want) <= (1e-6 if dtype == torch.float32
                                   else OUT_RTOL)
    for a, b in zip(buffers(bn), buffers(twin)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_apply_takes_fold_r_only_with_a_residual():
    x = torch.ones(4, 8)
    fold = torch.ones(2, 8)
    with pytest.raises(ValueError):
        BN.batch_norm_apply(x, fold, None, fold)


@pytest.mark.parametrize("M,C", [(0, 64), (8, 12), (8, 4), (8, 0),
                                 (-1, 64), (8, 2050)])
def test_geometry_refuses_what_the_kernel_cannot_take(M, C):
    with pytest.raises(ValueError):
        BN.batch_norm_geometry(M, C)


# every BatchNorm shape class of the trunk at B = 512 and 224 px, and odd M
@pytest.mark.parametrize("M,C", [
    (6_422_528, 64), (1_605_632, 128), (1_605_632, 256), (401_408, 256),
    (401_408, 512), (100_352, 512), (100_352, 1024), (25_088, 1024),
    (25_088, 2048), (1, 64), (7, 2048), (12_545, 512), (12_545, 24)])
def test_geometry_covers_the_rows_in_one_wave(M, C):
    g = BN.batch_norm_geometry(M, C)
    vectors = C // 8
    assert g.columns == min(vectors, 16)
    assert g.rows_at_once * g.columns <= 256
    assert g.rows_at_once == 256 // g.columns
    assert g.ranges * g.columns >= vectors > (g.ranges - 1) * g.columns
    assert g.slab_rows % g.rows_at_once == 0
    assert (g.slabs - 1) * g.slab_rows < M <= g.slabs * g.slab_rows
    assert g.slabs * g.ranges <= 132 * 2 + g.ranges
    assert 1 <= g.apply_blocks * g.ranges <= 132 * 4 + g.ranges
    assert g.apply_blocks <= -(-M // g.rows_at_once)


# ------------------------------------------------------------- GPU tests

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bn_case(C, M, gen, device):
    """A [1, C, 1, M] channels-last conv-like tensor of M pixels, a
    residual of the same shape and two random BatchNorms."""
    x = conv_like(1, C, 1, M, gen, torch.bfloat16).to(device)
    r = conv_like(1, C, 1, M, gen, torch.bfloat16).to(device)
    return x, r, random_bn(C, gen, device), random_bn(C, gen, device)


SHAPES = [(C, M, mode) for C in (64, 128, 256, 512, 1024, 2048)
          for M in (1, 7, 12_545)
          for mode in (("none", "identity", "downsample") if C >= 256
                       else ("none",))]


@pytest.mark.gpu
@pytest.mark.parametrize("C,M,mode", SHAPES)
def test_kernel_matches_plain(cuda, C, M, mode):
    gen = torch.Generator().manual_seed(C + M)
    x, r, bn, ds = bn_case(C, M, gen, cuda)
    twin, twin_ds = copy.deepcopy(bn), copy.deepcopy(ds)
    residual = None if mode == "none" else r
    downsample = ds if mode == "downsample" else None
    bn.requires_grad_(False)
    ds.requires_grad_(False)
    assert takes_k12(True, (x,) if residual is None else (x, residual),
                     (bn, ds))
    before = launches()
    got = bn.forward_relu(x, True, residual, downsample)
    n_stats = 2 if downsample is not None else 1
    assert launches() == (before[0] + n_stats, before[1] + 1)
    assert got.is_contiguous(memory_format=torch.channels_last)
    y = twin(x, True)
    if mode == "identity":
        y = y + r
    elif mode == "downsample":
        y = y + twin_ds(r, True)
    want = torch.relu(y)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert norm_rel(got, want) <= OUT_RTOL
    for a, b in zip(buffers(bn) + buffers(ds), buffers(twin)
                    + buffers(twin_ds if downsample is not None else ds)):
        assert norm_rel(a, b) <= VEC_RTOL
    rows = x.permute(0, 2, 3, 1).reshape(M, C)
    fold = BN.batch_norm_stats(rows, bn.weight, bn.bias,
                               bn.running_mean.clone(),
                               bn.running_var.clone())
    want = BN.batch_norm_stats_reference(
        rows, bn.weight, bn.bias, bn.running_mean.clone(),
        bn.running_var.clone())
    assert fold.shape == (2, C)
    for a, b in zip(fold, want):  # mul, then add
        assert norm_rel(a, b) <= VEC_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("C,M", [(64, 200_003), (2048, 25_088)])
def test_two_calls_are_bitwise_equal(cuda, C, M):
    gen = torch.Generator().manual_seed(C)
    x, r, bn, ds = bn_case(C, M, gen, cuda)
    rows, res = (t.permute(0, 2, 3, 1).reshape(M, C) for t in (x, r))
    outs = []
    for _ in range(2):
        rm, rv = bn.running_mean.clone(), bn.running_var.clone()
        fold = BN.batch_norm_stats(rows, bn.weight, bn.bias, rm, rv)
        fold_r = BN.batch_norm_stats(res, ds.weight, ds.bias,
                                     ds.running_mean.clone(),
                                     ds.running_var.clone())
        out = BN.batch_norm_apply(rows, fold, res, fold_r)
        outs.append((fold, fold_r, rm, rv, out))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernels_refuse_what_they_cannot_take(cuda):
    x = torch.zeros(16, 64, device=cuda, dtype=torch.bfloat16)
    v = torch.zeros(64, device=cuda)
    fold = torch.zeros(2, 64, device=cuda)
    for bad in (lambda: BN.batch_norm_apply(x.float(), fold),
                lambda: BN.batch_norm_apply(x[:, :60], fold[:, :60]),
                lambda: BN.batch_norm_apply(x, fold.double()),
                lambda: BN.batch_norm_apply(x, fold[:, :32]),
                lambda: BN.batch_norm_apply(x, fold, x[:8]),
                lambda: BN.batch_norm_apply(x, fold, x, fold.t()),
                lambda: BN.batch_norm_stats(x.t(), v, v, v, v),
                lambda: BN.batch_norm_stats(x, v[:32], v, v, v),
                lambda: BN.batch_norm_stats(x, v, v, v.cpu(), v)):
        with pytest.raises(ValueError):
            bad()


def trunk_pair(device):
    """A random trunk in bf16 and its twin whose weights need a gradient
    (the plain path under grad mode). Each block's bn3 gain is 0.2 (1 +
    0.1 N), as the benchmark's configuration assumes: with gains near 1 a
    random trunk on batch statistics is chaotic, and bf16's rounding alone
    moves its output by tens of percent."""
    gen = torch.Generator().manual_seed(11)
    trunk = ResNeXt50(torch.bfloat16, frozen=True, generator=gen)
    for m in trunk.modules():
        if isinstance(m, InferenceBN):
            m.load_state_dict(random_bn(m.weight.numel(), gen).state_dict())
    with torch.no_grad():
        for block in trunk.blocks():
            block.bn3.weight.mul_(0.2)
    trunk = trunk.to(device)
    plain = copy.deepcopy(trunk)  # weights that need a gradient: plain path
    trunk.requires_grad_(False)
    x = torch.randn(16, 64, 64, 3, generator=gen).to(device)
    return trunk, plain, x


@pytest.mark.gpu
def test_trunk_train_forward_matches_plain_conv_path(cuda):
    trunk, plain, x = trunk_pair(cuda)
    before = launches()
    got = trunk(x, train=True)
    assert launches() == (before[0] + 53, before[1] + 49)
    f32 = copy.deepcopy(plain)
    f32.dtype = torch.float32
    want = plain(x, train=True)
    assert launches() == (before[0] + 53, before[1] + 49)
    ref = f32(x, train=True)
    for k in ("pooled", "feature_map"):
        g, w = got[k].float(), want[k].float()
        rel = float((g - w).abs().max() / w.abs().max())
        # beside it, for a failure's message: the plain bf16 path from f32
        rel_plain = float((w - ref[k]).abs().max() / ref[k].abs().max())
        assert rel < BF16_RTOL, (k, rel, rel_plain)
    for (name, a), b in zip(trunk.named_buffers(), buffers(plain)):
        assert norm_rel(a, b) <= 1e-2, name


@pytest.mark.gpu
def test_folded_path_refolds_after_k12_moves_the_buffers(cuda):
    trunk, _, x = trunk_pair(cuda)
    with torch.no_grad():
        before = trunk(x)["pooled"]
        trunk(x, train=True)
        after = trunk(x)["pooled"]
        fresh = copy.deepcopy(trunk)(x)["pooled"]
    assert not torch.equal(before, after)
    assert torch.equal(after, fresh)
