"""The K1, K2, K3a/K3b, K4, K5, K6, K7, K8a-c, K9, K10a, K10b and K11
kernels on a CUDA card: against their plain versions (K1 at the shapes of
tests/test_hwbc_kernels.py, K2 and the stage kernel at those of
tests/test_quant_trunk.py and tests/test_hwbc_kernels.py, the ViT kernels
at small, odd and ViT-B shapes, with kv_valid, K5 and K7 also at a ragged
row count and at two-pass lengths up to 752, K6 and K7 in every GELU
form, K9 at small, odd and CVCL shapes and at the edges of its row and
unit tiles (B 1 to 300, H 16 to 576, L 1 to 128), K4 forward and backward at
B = 16, 72 and 128 and on both sides of its cluster (B 4 to 256) and
grid (260, 1024) paths, K9 and K4 on two streams at once bit for bit
against lone calls, K10a's block, stage and banded stage at
tests/test_quant_trunk.py's transport shapes, K10b at
tests/test_hwbc_kernels.py:74's and every ResNeXt-50 block shape and
against K1 bit for bit, K11 forward and backward at odd M and under one
row tile, M = 1 and 7), K10a's grouped 3x3 launch against K1's bit for
bit, K7 against K5 then K6 bit for bit, K1 on its 1x1
tile at every ResNeXt-50 block shape (B = 2) and at ragged row counts,
the bf16 stage kernel equal bit for bit across band counts and to its
blocks' K1 launches, K2 on the int8 tile at every int8 block shape of the
published plan (B = 32) and at ragged row counts (B = 2), the int8 stage
equal code for code to its blocks' K2 launches and across band counts,
and on the arguments they refuse. The slice's entry points on the
published trunk's kernels against the same calls with the trunk's plain
versions on the card (per-row or per-map cosine >= 0.999): ``grad_cam``
at B = 4 and 1, captioning ``run_textgen_eval`` at B = 64 (int8 plan)
and 16 (bf16), and ``category_feature_sets`` with a 36-frame tail. The
host input path: ``device_batch``'s pinned staging ring against a
consumer that lags on the device (every device batch equal to its host
batch), and the trainer's first step on JPEG frames against the plain
versions.

Marked ``gpu``: each test skips, with its reason, where
``torch.cuda.is_available()`` is false. chip_smoke.py runs the same
comparison at the trunk's real shapes. Tolerances as chip_smoke.py: max
error relative to the largest output <= 1e-2 and cosine >= 0.9999 (both
versions bf16 with the same rounding points; f32 sums in other orders can
move a bf16 rounding of h1 or h2 by one ulp). int8: at most 1 code apart
and fewer than 1e-3 of the codes differing (tests/test_quant_trunk.py's
envelope; both versions sum exactly and round alike, so 0 is expected).
K9 and K4 are f32 kernels whose products run as three TF32 products
(about f32's precision), against f32 plain versions (TF32 off):
K9 max absolute error <= 1e-4 on out, h_last and c_last; K4 loss
relative error <= 1e-5, LSEs absolute 1e-5, accuracies exact, entropies
relative 1e-4, gradients atol 1e-4 and rtol 1e-3 (chip_smoke.py's gates),
and a repeated call gives the same bits.
"""

import pytest
import torch

from multimodal_baby_tpu_torch.ops.attention import (
    attention_pairs_reference, attention_reference,
    block_attention_reference, fused_attention, fused_attention_pairs,
    fused_block_attention, fused_qkv_attention_pairs,
    qkv_attention_pairs_reference)
from multimodal_baby_tpu_torch.ops import _build, infonce
from multimodal_baby_tpu_torch.ops.bottleneck import (
    _grouped, bottleneck_reference, fused_bottleneck, fused_bottleneck_tiles,
    tiles_reference)
from multimodal_baby_tpu_torch.ops.conv_epilogue import (
    conv1x1_bn_residual_relu, epilogue_reference)
from multimodal_baby_tpu_torch.ops.quant import (
    bottleneck_reference_q, bottleneck_reference_t, fold_block_params_q,
    fold_block_params_t)
from multimodal_baby_tpu_torch.ops.stage import (
    fused_stage, fused_stage_banded, stage_reference)
from multimodal_baby_tpu_torch.ops.vit_block import (
    fused_vit_block, vit_block_reference)
from multimodal_baby_tpu_torch.ops.lstm import lstm_fused, scan_reference
from multimodal_baby_tpu_torch.ops.vit_mlp import fused_mlp, mlp_reference

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


def block_state(g, cin, width, cout, has_ds):
    """A random BottleneckX state dict (torch names) with non-trivial BN."""
    def bn(c):
        return {"weight": 1 + .1 * torch.randn(c, generator=g),
                "bias": .1 * torch.randn(c, generator=g),
                "running_mean": .1 * torch.randn(c, generator=g),
                "running_var": .5 + 1.5 * torch.rand(c, generator=g)}

    convs = {"conv1": (width, cin, 1), "conv2": (width, width // 32, 3),
             "conv3": (cout, width, 1)}
    bns = {"bn1": width, "bn2": width, "bn3": cout}
    if has_ds:
        convs["downsample.0"] = (cout, cin, 1)
        bns["downsample.1"] = cout
    sd = {f"{k}.weight": torch.randn(o, i, kk, kk, generator=g)
          / (i * kk * kk) ** 0.5 for k, (o, i, kk) in convs.items()}
    for k, c in bns.items():
        sd.update({f"{k}.{n}": v for n, v in bn(c).items()})
    return sd


def q_block(g, cin, width, cout, has_ds, device):
    fw = fold_block_params_q(block_state(g, cin, width, cout, has_ds),
                             2.0, 1.5, 1.5, 2.5)
    return {k: v.to(device) for k, v in fw.items()}


def codes_close(got, want):
    diff = (got.int() - want.int()).abs()
    assert got.shape == want.shape and got.dtype == torch.int8
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3
    assert 0.05 < float((want > 0).float().mean())  # not all clipped


@pytest.mark.parametrize("stride,has_ds,H,cin,width,cout", [
    (1, False, 8, 256, 128, 256),
    (2, True, 8, 256, 128, 256),
    (1, True, 8, 64, 128, 256),
    (2, True, 7, 512, 512, 1024),   # odd size: 7 -> 4
    (1, False, 5, 1024, 512, 1024),
    (1, False, 2, 2048, 1024, 2048),
])
def test_int8_kernel_matches_plain_version(cuda, stride, has_ds, H, cin,
                                           width, cout):
    g = torch.Generator().manual_seed(cin + width + H)
    fw = q_block(g, cin, width, cout, has_ds, cuda)
    x = torch.randint(0, 100, (32, H, H, cin), generator=g,
                      dtype=torch.int8).to(cuda)
    before = fused_bottleneck.launches_q
    got = fused_bottleneck(x, fw, stride=stride)
    want = bottleneck_reference_q(x, fw, stride=stride)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches_q == before + 1
    codes_close(got, want)


def stage_weights(g, cin, width, cout, strides, int8, device):
    """A stage's folded blocks; the head has a downsample where it changes
    the shape."""
    fws = []
    for j in range(len(strides)):
        c = cin if j == 0 else cout
        ds = j == 0 and (c != cout or strides[0] != 1)
        fws.append(q_block(g, c, width, cout, ds, device) if int8 else
                   make_block(c, width, cout, ds, 2, 1, device)[1])
    return fws


@pytest.mark.parametrize("int8,H,cin,width,cout,strides,band", [
    (True, 8, 256, 128, 256, [2, 1, 1], None),       # test_quant_trunk:100
    (True, 14, 1024, 512, 1024, [1, 1, 1, 1, 1], None),  # layer 3 tail
    (True, 14, 1024, 1024, 2048, [2, 1, 1], None),   # layer 4
    (False, 12, 256, 128, 256, [2, 1, 1], None),     # test_hwbc_kernels:91
    (False, 16, 64, 128, 256, [1, 1, 1], 4),         # banded, 4 bands
    (False, 16, 128, 128, 256, [2, 1, 1], 4),        # banded, stride-2 head
    (True, 16, 64, 128, 256, [1, 1, 1], 8),          # banded int8
])
def test_stage_kernel_matches_plain_version(cuda, int8, H, cin, width, cout,
                                            strides, band):
    g = torch.Generator().manual_seed(H + cin + len(strides))
    fws = stage_weights(g, cin, width, cout, strides, int8, cuda)
    if int8:
        x = torch.randint(0, 100, (32, H, H, cin), generator=g,
                          dtype=torch.int8).to(cuda)
    else:
        x = torch.randn(32, H, H, cin, generator=g).to(cuda, torch.bfloat16)
    counter = fused_stage if band is None else fused_stage_banded
    before = counter.launches
    got = (fused_stage(x, fws, strides) if band is None
           else fused_stage_banded(x, fws, strides, band))
    want = stage_reference(x, fws, strides)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    if int8:
        codes_close(got, want)
    else:
        assert_close_bf16(got, want)
    if band is not None:  # a halo row is computed as in the full stage
        assert torch.equal(got, fused_stage(x, fws, strides))


@pytest.mark.parametrize("bad", ["band", "float32", "weights"])
def test_stage_kernel_refuses_what_it_cannot_take(cuda, bad):
    g = torch.Generator().manual_seed(0)
    fws = stage_weights(g, 64, 128, 256, [1, 1], False, cuda)
    x = torch.randn(2, 8, 8, 64, generator=g).to(cuda, torch.bfloat16)
    band = 3 if bad == "band" else 4
    if bad == "float32":
        x = x.float()
    elif bad == "weights":  # int8 codes with bf16 weights
        x = x.to(torch.int8)
    before = fused_stage_banded.launches
    with pytest.raises(ValueError):
        fused_stage_banded(x, fws, [1, 1], band)
    assert fused_stage_banded.launches == before


def vit_inputs(kind, B, N, C, F, device):
    """bf16 x and the half's parameters: LayerNorm scale and bias, then
    (wqkv, bqkv, wproj, bproj) or (w1, b1, w2, b2)."""
    g = torch.Generator().manual_seed(B + N + C)
    out_a, in_b = (3 * C, C) if kind == "attention" else (F, F)
    shapes = [((B, N, C), 1.0), ((C,), 0.1), ((C,), 0.1),
              ((C, out_a), C ** -0.5), ((out_a,), 0.1),
              ((in_b, C), in_b ** -0.5), ((C,), 0.1)]
    x, *params = [(torch.randn(*s, generator=g) * sc).to(device,
                                                         torch.bfloat16)
                  for s, sc in shapes]
    params[0] = params[0] + 1.0
    return x, params


def assert_close_bf16(got, want):
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    cos = torch.nn.functional.cosine_similarity(
        got.double().flatten(), want.double().flatten(), dim=0)
    assert float(err) <= REL_TOL and float(cos) >= COS_TOL


# K5 at small and odd shapes, at ViT-B/14 (N = 257, one pass of the
# attention core) with a ragged row count (B = 2: M = 514 of the GEMM
# tile's 256-row tiles), and at two-pass lengths (N = 400, 752)
@pytest.mark.parametrize("B,N,C,kv_valid", [
    (2, 10, 256, 7), (2, 17, 256, None), (3, 65, 128, 64),
    (4, 257, 768, None), (2, 272, 768, 257), (1, 752, 256, 700),
    (2, 257, 768, None), (2, 257, 768, 250), (2, 400, 768, None),
    (2, 400, 768, 395), (2, 752, 768, None), (2, 752, 768, 700)])
def test_attention_kernel_matches_plain_version(cuda, B, N, C, kv_valid):
    x, p = vit_inputs("attention", B, N, C, 0, cuda)
    heads, scale = C // 64, 64 ** -0.5
    before = fused_block_attention.launches
    got = fused_block_attention(x, *p, heads, scale, kv_valid)
    want = block_attention_reference(x, *p, heads, scale, kv_valid)
    torch.cuda.synchronize()
    assert fused_block_attention.launches == before + 1
    assert_close_bf16(got, want)


# K6 at small and odd shapes, at ViT-B/14, at ragged row counts of the
# ping-pong tile's 128-row bands (M = 514, 1200, 752) and under one band
# (M = 5)
@pytest.mark.parametrize("gelu", ["erf", "tanh", "sigmoid"])
@pytest.mark.parametrize("B,N,C,F", [
    (2, 10, 256, 1024), (2, 17, 256, 512), (4, 257, 768, 3072),
    (2, 257, 768, 3072), (3, 400, 768, 3072), (1, 752, 768, 3072),
    (1, 5, 256, 512)])
def test_mlp_kernel_matches_plain_version(cuda, B, N, C, F, gelu):
    x, p = vit_inputs("mlp", B, N, C, F, cuda)
    before = fused_mlp.launches
    got = fused_mlp(x, *p, 1e-6, gelu)
    want = mlp_reference(x, *p, 1e-6, gelu)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    assert_close_bf16(got, want)


def block_inputs(B, N, C, F, device):
    """x and the 12 operands of a whole block (K5's then K6's)."""
    x, pa = vit_inputs("attention", B, N, C, F, device)
    _, pm = vit_inputs("mlp", B, N + 1, C, F, device)
    return x, pa + pm


@pytest.mark.parametrize("gelu", ["erf", "tanh", "sigmoid"])
@pytest.mark.parametrize("B,N,C,F,kv_valid", [
    (2, 10, 256, 1024, 7), (2, 17, 256, 512, None),
    (4, 257, 768, 3072, None), (2, 257, 768, 3072, 250),
    (2, 400, 256, 1024, 395), (1, 752, 256, 512, 700)])
def test_vit_block_kernel_matches_plain_and_composition(cuda, B, N, C, F,
                                                        kv_valid, gelu):
    x, p = block_inputs(B, N, C, F, cuda)
    heads, scale = C // 64, 64 ** -0.5
    before = fused_vit_block.launches
    got = fused_vit_block(x, *p, heads, scale, kv_valid, 1e-6, gelu)
    want = vit_block_reference(x, *p, heads, scale, kv_valid, 1e-6, gelu)
    composed = fused_mlp(fused_block_attention(x, *p[:6], heads, scale,
                                               kv_valid), *p[6:], 1e-6, gelu)
    torch.cuda.synchronize()
    assert fused_vit_block.launches == before + 1
    assert_close_bf16(got, want)
    # the same tile routines in one launch: K5 then K6 bit for bit
    assert torch.equal(got.view(torch.int16), composed.view(torch.int16))


def attention_inputs(B, N, C, device, qkv_view):
    """q, k, v [B, N, C] (column slices of one [B, N, 3C] tensor when
    qkv_view) with scores of order 1."""
    g = torch.Generator().manual_seed(B + N + C)
    qkv = (torch.randn(B, N, 3 * C, generator=g) * 0.35).to(device,
                                                            torch.bfloat16)
    if qkv_view:
        return qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    return tuple(t.contiguous() for t in qkv.split(C, -1))


# the edges of K8a-c's register-resident design: N = 257 and 272
# (a row's scores in one chunk of registers), 273 (the first N over it: two
# chunks, two passes), 416 (K8c's cap) and 752 (K8a's cap, three chunks)
EDGE_N = [257, 272, 273, 416, 752]


@pytest.mark.parametrize("B,N,C,kv_valid", [
    (2, 10, 256, 7), (2, 17, 256, None), (3, 65, 128, 64),
    (4, 257, 768, None), (1, 752, 256, 700)] + [
    (2, n, 128, kv) for n in EDGE_N for kv in (None, n - 20)])
def test_attention_kernels_match_plain_versions(cuda, B, N, C, kv_valid):
    """K8a on heads-first copies, K8b on the qkv slices in place."""
    heads, scale = C // 64, 64 ** -0.5
    q, k, v = attention_inputs(B, N, C, cuda, True)
    before = fused_attention_pairs.launches
    got = fused_attention_pairs(q, k, v, heads, scale, kv_valid)
    want = attention_pairs_reference(q, k, v, heads, scale, kv_valid)
    torch.cuda.synchronize()
    assert fused_attention_pairs.launches == before + 1
    assert_close_bf16(got, want)

    def heads_first(t):
        return t.reshape(B, N, heads, 64).transpose(1, 2).reshape(-1, N, 64)

    qh, kh, vh = map(heads_first, (q, k, v))
    before = fused_attention.launches
    got = fused_attention(qh, kh, vh, scale, kv_valid)
    want = attention_reference(qh, kh, vh, scale, kv_valid)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert_close_bf16(got, want)
    # p at f32 grade: K8a is the f32 result rounded once to bf16, give or
    # take 2e-5 of max |v| (a bf16 p would add ~2^-9 p |v| per key)
    exact = attention_reference(qh.float(), kh.float(), vh.float(), scale,
                                kv_valid)
    slack = (got.float() - exact).abs() - 2 ** -8 * exact.abs()
    assert float(slack.max()) <= 2e-5 * float(vh.float().abs().max())


@pytest.mark.parametrize("B,N,C,kv_valid,bias", [
    (2, 10, 256, 7, True), (2, 17, 256, None, False), (3, 65, 128, 64, True),
    (4, 257, 768, None, True), (1, 416, 256, 400, True)] + [
    (2, n, 256, kv, True) for n in EDGE_N[:4] for kv in (None, n - 20)])
def test_qkv_attention_kernel_matches_plain_version(cuda, B, N, C, kv_valid,
                                                    bias):
    x, p = vit_inputs("attention", B, N, C, 0, cuda)
    wqkv, bqkv = p[2], (p[3] if bias else None)
    heads, scale = C // 64, 64 ** -0.5
    before = fused_qkv_attention_pairs.launches
    got = fused_qkv_attention_pairs(x, wqkv, bqkv, heads, scale, kv_valid)
    want = qkv_attention_pairs_reference(x, wqkv, bqkv, heads, scale,
                                         kv_valid)
    torch.cuda.synchronize()
    assert fused_qkv_attention_pairs.launches == before + 1
    assert_close_bf16(got, want)


def test_attention_pairs_kernel_on_fixed_inputs(cuda):
    """K8b on the register-resident core (one block per head and image, p
    rounded to bf16): on fixed seeded inputs at ViT-B/14's shape it stays
    within the gate of its plain version, and a second call gives the same
    bits."""
    g = torch.Generator().manual_seed(8)
    B, N, C, heads = 2, 257, 768, 12
    qkv = (torch.randn(B, N, 3 * C, generator=g) * 0.35).to(cuda,
                                                            torch.bfloat16)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    for kv_valid in (None, 250):
        before = fused_attention_pairs.launches
        got = fused_attention_pairs(q, k, v, heads, 0.125, kv_valid)
        again = fused_attention_pairs(q, k, v, heads, 0.125, kv_valid)
        want = attention_pairs_reference(q, k, v, heads, 0.125, kv_valid)
        torch.cuda.synchronize()
        assert fused_attention_pairs.launches == before + 2
        assert_close_bf16(got, want)
        assert torch.equal(got.view(torch.int16), again.view(torch.int16))


@pytest.mark.parametrize("bad", ["float32", "heads", "too_long", "stride"])
def test_attention_kernels_refuse_what_they_cannot_take(cuda, bad):
    N = {"too_long": 753}.get(bad, 10)
    q, k, v = attention_inputs(2, N, 256, cuda, True)
    heads = 8 if bad == "heads" else 4
    if bad == "float32":
        q = q.float()
    elif bad == "stride":  # rows 4 elements apart
        q = torch.zeros(2, N, 260, dtype=torch.bfloat16,
                        device=cuda)[..., :256]
    before = fused_attention_pairs.launches
    with pytest.raises(ValueError):
        fused_attention_pairs(q, k, v, heads, 0.125)
    assert fused_attention_pairs.launches == before
    x, p = vit_inputs("attention", 2, 417 if bad == "too_long" else 10, 256,
                      0, cuda)
    if bad == "float32":
        x = x.float()
    elif bad == "stride":  # K8c takes contiguous tensors only
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    before = fused_qkv_attention_pairs.launches
    with pytest.raises(ValueError):
        fused_qkv_attention_pairs(x, p[2], p[3], heads, 0.125)
    assert fused_qkv_attention_pairs.launches == before


@pytest.mark.parametrize("bad", ["float32", "heads", "too_long"])
def test_vit_kernels_refuse_what_they_cannot_take(cuda, bad):
    N = 753 if bad == "too_long" else 10
    x, p = vit_inputs("attention", 2, N, 256, 0, cuda)
    heads = 8 if bad == "heads" else 4      # heads of 32
    if bad == "float32":
        x = x.float()
    before = fused_block_attention.launches
    with pytest.raises(ValueError):
        fused_block_attention(x, *p, heads, 0.125)
    assert fused_block_attention.launches == before


def lstm_inputs(L, B, H, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, L + 1, (B,), generator=g)
    lens[0] = L
    t = {"xp": torch.randn(L, B, 4 * H, generator=g),
         "mask": (torch.arange(L)[:, None] < lens[None, :]).float(),
         "whh": torch.randn(H, 4 * H, generator=g) / H ** 0.5,
         "h0": 0.1 * torch.randn(B, H, generator=g),
         "c0": 0.1 * torch.randn(B, H, generator=g)}
    return {k: v.to(device) for k, v in t.items()}


@pytest.mark.parametrize("L,B,H", [(1, 1, 16), (9, 8, 16), (7, 37, 48),
                                   (25, 128, 512), (64, 128, 512),
                                   (3, 5, 576)])
def test_lstm_kernel_matches_plain_version(cuda, L, B, H):
    a = lstm_inputs(L, B, H, cuda)
    args = (a["xp"], a["mask"], a["whh"], a["h0"], a["c0"])
    before = lstm_fused.launches
    with torch.no_grad():
        got = lstm_fused(*args)
        want = scan_reference(*args)
        again = lstm_fused(*args)
    torch.cuda.synchronize()
    assert lstm_fused.launches == before + 2
    for name, g, w, r in zip(("out", "h_last", "c_last"), got, want, again):
        assert g.shape == w.shape, name
        assert float((g - w).abs().max()) <= 1e-4, name
        assert torch.equal(g, r), name


@pytest.mark.parametrize("L", [1, 25, 64, 128])
@pytest.mark.parametrize("H", [16, 512, 576])
@pytest.mark.parametrize("B", [1, 33, 128, 256, 300])
def test_lstm_kernel_at_the_edges_of_its_tiles(cuda, B, H, L):
    """Row tiles of 32 (one short, several a block: B = 256, 300), every
    width's unit tiles, and sequences from one step to 128."""
    a = lstm_inputs(L, B, H, cuda, seed=B + H + L)
    args = (a["xp"], a["mask"], a["whh"], a["h0"], a["c0"])
    with torch.no_grad():
        got = lstm_fused(*args)
        want = scan_reference(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "h_last", "c_last"), got, want):
        assert float((g - w).abs().max()) <= 1e-4, name
    _, flags = _build.sync_words("lstm", 1)
    assert int(flags.abs().sum()) == 0  # left as found


def infonce_case(B, E, device):
    img, txt = unit_rows(B, E, device, B + E)
    nlt = torch.tensor(float(torch.log(torch.tensor(1 / 0.07))),
                       device=device)
    g = torch.tensor(0.7, device=device)
    return img, txt, nlt, g


def run_infonce(img, txt, nlt, g):
    fwd = infonce.fused_infonce_forward(img, txt, nlt)
    bwd = infonce.fused_infonce_backward(img, txt, nlt, fwd[1], fwd[2], g)
    return fwd, bwd


@pytest.mark.parametrize("B,E", [(4, 512), (4, 36), (128, 512), (132, 512),
                                 (256, 512), (260, 512), (260, 68),
                                 (1024, 512)])
def test_infonce_kernels_on_both_sides_of_the_cluster(cuda, B, E):
    """One cluster (T = 32 to B = 128, 64 to 256) and the cooperative grid
    above, against the plain versions, and a repeated call bit for bit."""
    img, txt, nlt, g = infonce_case(B, E, cuda)
    (loss, lse_i, lse_t, metrics), grads = run_infonce(img, txt, nlt, g)
    loss_w, lse_i_w, lse_t_w, m_w = infonce.infonce_reference(img, txt, nlt)
    ref = [t.clone().requires_grad_() for t in (img, txt, nlt)]
    grads_w = torch.autograd.grad(
        g * infonce.infonce_reference(*ref)[0], ref)
    again = run_infonce(img, txt, nlt, g)
    torch.cuda.synchronize()
    loss_w = loss_w.detach()
    assert abs(float(loss) - float(loss_w)) <= 1e-5 * abs(float(loss_w))
    assert float((lse_i - lse_i_w.detach()).abs().max()) <= 1e-5
    assert float((lse_t - lse_t_w.detach()).abs().max()) <= 1e-5
    assert torch.equal(metrics[:2], m_w[:2])
    torch.testing.assert_close(metrics[2:], m_w[2:], rtol=1e-4, atol=0)
    for a, w in zip(grads, grads_w):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-3)
    for a, b in zip((*again[0], *again[1]), (loss, lse_i, lse_t, metrics,
                                             *grads)):
        assert torch.equal(a, b)


def test_calls_on_two_streams_at_once_equal_lone_calls(cuda):
    """K9 and K4 (the cluster and the grid) on two streams at once: each
    call equal bit for bit to the same call alone, and the per-stream
    synchronisation words left as found."""
    a = lstm_inputs(25, 128, 512, cuda, seed=3)
    args = (a["xp"], a["mask"], a["whh"], a["h0"], a["c0"])
    cases = [infonce_case(B, 512, cuda) for B in (128, 1024)]

    def work():
        with torch.no_grad():
            return [lstm_fused(*args), lstm_fused(*args)] + [
                run_infonce(*c) for c in cases]

    lone = work()
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(work())
    torch.cuda.synchronize()

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for y in x for t in flat(y)]

    for got in outs:
        for x, y in zip(flat(got), flat(lone)):
            assert torch.equal(x, y)
    for st in streams:
        handle = st.cuda_stream
        assert int(_build.sync_words("lstm", 1, handle)[1].abs().sum()) == 0
        words = _build.sync_words("infonce", 4, handle)[1]
        assert int(words[0]) == 0 and int(words[2]) == 0


@pytest.mark.parametrize("bad", ["float64", "hidden", "non_contiguous"])
def test_lstm_kernel_refuses_what_it_cannot_take(cuda, bad):
    a = lstm_inputs(4, 8, 32, cuda)
    if bad == "float64":
        a["xp"] = a["xp"].double()
    elif bad == "hidden":
        a = lstm_inputs(4, 8, 20, cuda)
    else:
        a["whh"] = a["whh"].t().contiguous().t()
    with pytest.raises(ValueError):
        lstm_fused(a["xp"], a["mask"], a["whh"], a["h0"], a["c0"])


def unit_rows(B, E, device, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, B, E, generator=g)
    x = x / x.norm(dim=-1, keepdim=True)
    return x[0].to(device), x[1].to(device)


@pytest.mark.parametrize("B,E", [(16, 32), (72, 68), (128, 512)])
def test_infonce_kernels_match_plain_versions(cuda, B, E):
    img, txt = unit_rows(B, E, cuda, B + E)
    nlt = torch.tensor(float(torch.log(torch.tensor(1 / 0.07))), device=cuda)
    f = infonce.fused_infonce_with_metrics
    before = (f.launches, f.launches_bwd)
    args = [t.clone().requires_grad_() for t in (img, txt, nlt)]
    loss, metrics = f(*args)
    (0.7 * loss).backward()
    _, lse_i, lse_t, _ = infonce.fused_infonce_forward(img, txt, nlt)
    loss_w, lse_i_w, lse_t_w, m_w = infonce.infonce_reference(img, txt, nlt)
    ref = [t.clone().requires_grad_() for t in (img, txt, nlt)]
    (0.7 * infonce.infonce_reference(*ref)[0]).backward()
    again = infonce.fused_infonce_forward(img, txt, nlt)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_bwd) == (before[0] + 3, before[1] + 1)
    loss, loss_w = loss.detach(), loss_w.detach()
    assert abs(float(loss) - float(loss_w)) <= 1e-5 * abs(float(loss_w))
    assert float((lse_i - lse_i_w).abs().max()) <= 1e-5
    assert float((lse_t - lse_t_w).abs().max()) <= 1e-5
    got_m = torch.stack([metrics[k] for k in infonce.METRICS])
    assert torch.equal(got_m[:2], m_w[:2])
    torch.testing.assert_close(got_m[2:], m_w[2:], rtol=1e-4, atol=0)
    for a, r in zip(args, ref):
        torch.testing.assert_close(a.grad, r.grad, atol=1e-4, rtol=1e-3)
    assert all(torch.equal(x, y) for x, y in zip(again, (loss, lse_i, lse_t)))


@pytest.mark.parametrize("bad", ["odd_batch", "too_large", "float64"])
def test_infonce_kernel_refuses_what_it_cannot_take(cuda, bad):
    B = {"odd_batch": 10, "too_large": 1032}.get(bad, 16)
    img, txt = unit_rows(B, 32, cuda, 0)
    nlt = torch.tensor(2.0, device=cuda)
    if bad == "float64":
        img = img.double()
    with pytest.raises(ValueError):
        infonce.fused_infonce_forward(img, txt, nlt)


# ------------------------------------------------ K10a, K10b and K11

def t_block(g, cin, width, cout, has_ds, device):
    """An int8-transport fold (tests/test_quant_trunk.py's amax: in 2.0,
    out 2.5) on the card."""
    fw = fold_block_params_t(block_state(g, cin, width, cout, has_ds),
                             2.0, 2.5)
    return {k: v.to(device) for k, v in fw.items()}


@pytest.mark.parametrize("stride,has_ds,H,cin,width,cout", [
    (1, False, 8, 256, 128, 256),   # tests/test_quant_trunk.py:234
    (2, True, 8, 256, 128, 256),
    (1, True, 8, 64, 128, 256),     # layer 1's head
    (2, True, 7, 512, 256, 512),    # odd size: 7 -> 4
    (1, False, 5, 512, 256, 512),
])
def test_transport_kernel_matches_plain_version(cuda, stride, has_ds, H, cin,
                                                width, cout):
    g = torch.Generator().manual_seed(cin + width + H + 1)
    fw = t_block(g, cin, width, cout, has_ds, cuda)
    x = torch.randint(0, 100, (32, H, H, cin), generator=g,
                      dtype=torch.int8).to(cuda)
    before = fused_bottleneck.launches_t
    got = fused_bottleneck(x, fw, stride=stride)
    want = bottleneck_reference_t(x, fw, stride=stride)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches_t == before + 1
    codes_close(got, want)


@pytest.mark.parametrize("H,cin,width,cout,strides,band", [
    (8, 256, 128, 256, [2, 1, 1], None),       # test_quant_trunk.py:255
    (14, 1024, 512, 1024, [1, 1, 1], None),    # layer 3's tail, shortened
    (14, 1024, 1024, 2048, [2, 1, 1], None),   # layer 4
    (8, 256, 128, 256, [1, 1, 1], 4),          # test_quant_trunk.py:273
    (16, 64, 128, 256, [1, 1, 1], 4),          # layer 1's head, 4 bands
])
def test_transport_stage_kernel_matches_plain_version(cuda, H, cin, width,
                                                      cout, strides, band):
    g = torch.Generator().manual_seed(H + cin + len(strides) + 1)
    fws = []
    for j, s in enumerate(strides):
        c = cin if j == 0 else cout
        fws.append(t_block(g, c, width, cout, j == 0 and (c != cout or s != 1),
                           cuda))
    x = torch.randint(0, 100, (32, H, H, cin), generator=g,
                      dtype=torch.int8).to(cuda)
    counter = fused_stage if band is None else fused_stage_banded
    before = (counter.launches, counter.launches_t)
    got = (fused_stage(x, fws, strides) if band is None
           else fused_stage_banded(x, fws, strides, band))
    torch.cuda.synchronize()
    assert (counter.launches, counter.launches_t) == (before[0],
                                                      before[1] + 1)
    # the stage is its blocks' K10a launches in a chain, bit for bit, and
    # each of those is within one code of its plain version on its input
    y = x
    for fw, s in zip(fws, strides):
        want = bottleneck_reference_t(y, fw, stride=s)
        y = fused_bottleneck(y, fw, stride=s)
        codes_close(y, want)
    assert torch.equal(got, y)
    # through the chain a moved code rides the residual path into the
    # next block, so the whole is held to the plain chain by its cosine
    assert_close_codes(got, stage_reference(x, fws, strides))
    if band is not None:  # a halo row is computed as in the full stage
        assert torch.equal(got, fused_stage(x, fws, strides))


def assert_close_codes(got, want):
    a, b = got.double().flatten(), want.double().flatten()
    assert float(a @ b / (a.norm() * b.norm())) >= COS_TOL


@pytest.mark.parametrize("stride,has_ds,B,H,cin,width,cout,Bc,hh", [
    (2, True, 32, 16, 128, 256, 512, 16, 2),   # test_hwbc_kernels.py:74
    (1, False, 16, 8, 256, 128, 256, 8, 4),
    (1, True, 8, 7, 64, 128, 256, 4, 7),       # odd size, one band
    (2, True, 4, 9, 64, 128, 256, 2, 5),       # 9 -> 5, window past the image
    # the 8 ResNeXt-50 block shapes at 224 px
    (1, True, 2, 56, 64, 128, 256, 1, 28), (1, False, 2, 56, 256, 128, 256,
                                            1, 28),
    (2, True, 2, 56, 256, 256, 512, 1, 14), (1, False, 2, 28, 512, 256, 512,
                                             1, 14),
    (2, True, 2, 28, 512, 512, 1024, 1, 7), (1, False, 2, 14, 1024, 512, 1024,
                                             1, 7),
    (2, True, 2, 14, 1024, 1024, 2048, 1, 7), (1, False, 2, 7, 2048, 1024,
                                               2048, 1, 7),
])
def test_tiles_kernel_matches_plain_version_and_k1(cuda, stride, has_ds, B,
                                                   H, cin, width, cout, Bc,
                                                   hh):
    x, fw = make_block(cin, width, cout, has_ds, H, B, cuda)
    x = x.clamp_min(0)
    before = fused_bottleneck_tiles.launches
    got = fused_bottleneck_tiles(x, fw, stride=stride, Bc=Bc, hh=hh)
    torch.cuda.synchronize()
    assert fused_bottleneck_tiles.launches == before + 1  # one launch a call
    assert_close_bf16(got, tiles_reference(x, fw, stride, Bc, hh))
    # each output's sums run in K1's order: the tiles are K1's values
    assert torch.equal(got, fused_bottleneck(x, fw, stride=stride))


@pytest.mark.parametrize("M,cin,cout", [(1, 32, 128), (100, 128, 256),
                                        (4096, 1024, 2048)])
def test_conv_epilogue_kernel_matches_plain_version(cuda, M, cin, cout):
    g = torch.Generator().manual_seed(M + cin)
    x = torch.randn(M, cin, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(cin, cout, generator=g) / cin ** 0.5).to(
        cuda, torch.bfloat16)
    mul = (0.5 + torch.rand(cout, generator=g)).to(cuda)
    add = (0.1 * torch.randn(cout, generator=g)).to(cuda)
    res = torch.randn(M, cout, generator=g).to(cuda, torch.bfloat16)
    args = [t.requires_grad_() for t in (x, w, mul, add, res)]
    before = conv1x1_bn_residual_relu.launches
    got = conv1x1_bn_residual_relu(*args)
    want = epilogue_reference(*args)
    torch.cuda.synchronize()
    assert conv1x1_bn_residual_relu.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert_close_bf16(got, want)
    gout = torch.randn(M, cout, generator=g).to(cuda, torch.bfloat16)
    for a, b, name in zip(torch.autograd.grad(got, args, gout),
                          torch.autograd.grad(want, args, gout),
                          ("x", "w", "mul", "add", "residual")):
        assert torch.equal(a, b), name  # both the plain version's autograd


@pytest.mark.parametrize("stride,H,width", [
    (1, 8, 128), (2, 8, 256), (2, 7, 512), (1, 14, 512), (2, 14, 1024)])
def test_transport_grouped_conv_is_k1s(cuda, stride, H, width):
    """K10a's grouped 3x3 launch (``mmb_bottleneck_t_part`` 2) gives K1's
    h2 (``mmb_bottleneck_bf16_part`` 2) bit for bit on the same bf16 h1:
    both run bottleneck.cuh's halo tiles; and it is within the bf16 gate of
    the plain grouped convolution."""
    g = torch.Generator().manual_seed(H + width + stride)
    B, Ho = 4, (H - 1) // stride + 1
    h1 = torch.randn(B, H, H, width, generator=g).clamp_min(0).to(
        cuda, torch.bfloat16)
    fw = {"w2": (torch.randn(3, 3, width // 32, width, generator=g)
                 * 0.05).to(cuda, torch.bfloat16),
          "b2": (torch.randn(width, generator=g) * 0.1).to(cuda)}
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    w2, b2 = fw["w2"].data_ptr(), fw["b2"].data_ptr()
    k10a = torch.full((B, Ho, Ho, width), 1.0, device=cuda,
                      dtype=torch.bfloat16)
    k1 = torch.full_like(k10a, -1.0)
    dims = (B, H, H, width, width, 4 * width, stride, stream)
    _build.check(lib, lib.mmb_bottleneck_t_part(
        2, None, None, None, w2, b2, None, None, None, None, None, None,
        None, h1.data_ptr(), k10a.data_ptr(), None, *dims), "K10a 3x3")
    _build.check(lib, lib.mmb_bottleneck_bf16_part(
        2, None, None, None, w2, b2, None, None, None, None, h1.data_ptr(),
        k1.data_ptr(), None, *dims), "K1 3x3")
    torch.cuda.synchronize()
    assert torch.equal(k10a, k1)
    assert_close_bf16(k10a, _grouped(h1, fw, stride, torch.bfloat16))


@pytest.mark.parametrize("M,cin,cout", [(1, 32, 128), (1, 256, 512),
                                        (7, 96, 256), (7, 1024, 2048)])
def test_conv_epilogue_kernel_at_few_rows(cuda, M, cin, cout):
    """K11 under one 128-row tile (M = 1 and 7: the TMA reads the rows past
    M as zeros and clips their stores), also with a Cin whose last 64-deep
    slice reads a tail of zeros (96)."""
    g = torch.Generator().manual_seed(M + cin + cout)
    args = ((torch.randn(M, cin, generator=g)).to(cuda, torch.bfloat16),
            (torch.randn(cin, cout, generator=g) / cin ** 0.5).to(
                cuda, torch.bfloat16),
            (0.5 + torch.rand(cout, generator=g)).to(cuda),
            (0.1 * torch.randn(cout, generator=g)).to(cuda),
            torch.randn(M, cout, generator=g).to(cuda, torch.bfloat16))
    before = conv1x1_bn_residual_relu.launches
    got = conv1x1_bn_residual_relu(*args)
    torch.cuda.synchronize()
    assert conv1x1_bn_residual_relu.launches == before + 1
    assert got.shape == (M, cout) and got.dtype == torch.bfloat16
    assert_close_bf16(got, epilogue_reference(*args))


@pytest.mark.parametrize("bad", ["transport_keys", "tiles_int8",
                                 "tiles_wide_row", "epilogue_f32",
                                 "epilogue_cout"])
def test_new_kernels_refuse_what_they_cannot_take(cuda, bad):
    g = torch.Generator().manual_seed(1)
    before = fused_bottleneck_tiles.launches
    with pytest.raises(ValueError):
        if bad == "transport_keys":  # a transport fold without its ai
            fw = t_block(g, 256, 128, 256, False, cuda)
            del fw["ai"]
            fused_bottleneck(torch.zeros(32, 4, 4, 256, dtype=torch.int8,
                                         device=cuda), fw)
        elif bad == "tiles_int8":
            fw = t_block(g, 256, 128, 256, False, cuda)
            fused_bottleneck_tiles(torch.zeros(32, 4, 4, 256,
                                               dtype=torch.int8,
                                               device=cuda), fw, 1, 16, 2)
        elif bad == "tiles_wide_row":  # no band of <= 128 output pixels
            _, fw = make_block(64, 128, 256, True, 4, 1, cuda)
            fused_bottleneck_tiles(torch.zeros(1, 4, 300, 64,
                                               dtype=torch.bfloat16,
                                               device=cuda), fw, 1, 1, 4)
        else:
            cout = 256 if bad == "epilogue_f32" else 200
            dt = torch.float32 if bad == "epilogue_f32" else torch.bfloat16
            conv1x1_bn_residual_relu(
                torch.zeros(8, 64, dtype=dt, device=cuda),
                torch.zeros(64, cout, dtype=dt, device=cuda),
                torch.ones(cout, device=cuda), torch.zeros(cout, device=cuda),
                torch.zeros(8, cout, dtype=dt, device=cuda))
    assert fused_bottleneck_tiles.launches == before


# K1 on the 1x1 convolutions' tile (csrc/conv_gemm.cuh): every ResNeXt-50
# block shape at 224 px (chip_smoke.BLOCKS_224) at B = 2, and ragged row
# counts of the tile's 128-row tiles (B = 3: M = 147 at 7 x 7, 12 x 12 at
# B = 1 and 2, 9 -> 5 at stride 2)
@pytest.mark.parametrize("B,stride,has_ds,H,cin,width,cout", [
    (2, 1, True, 56, 64, 128, 256), (2, 1, False, 56, 256, 128, 256),
    (2, 2, True, 56, 256, 256, 512), (2, 1, False, 28, 512, 256, 512),
    (2, 2, True, 28, 512, 512, 1024), (2, 1, False, 14, 1024, 512, 1024),
    (2, 2, True, 14, 1024, 1024, 2048), (2, 1, False, 7, 2048, 1024, 2048),
    (3, 1, False, 7, 256, 128, 256), (1, 1, True, 12, 64, 128, 256),
    (2, 1, True, 12, 64, 128, 256), (3, 2, True, 9, 256, 256, 512),
])
def test_kernel_matches_plain_version_at_every_block_shape(
        cuda, B, stride, has_ds, H, cin, width, cout):
    x, fw = make_block(cin, width, cout, has_ds, H, B, cuda)
    x = x.clamp_min(0)
    before = fused_bottleneck.launches
    got = fused_bottleneck(x, fw, stride=stride)
    want = bottleneck_reference(x, fw, stride=stride)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches == before + 1
    assert got.shape == want.shape
    assert_close_bf16(got, want)


# K3b on the tile: layer 1's stage at 56 px (B = 2) in bands of 28 (the
# published plan's) and of every other divisor of 56, and the stride-2
# head at 16 px in 1, 2, 4 and 8 bands: each against its plain version and
# every band count equal bit for bit
@pytest.mark.parametrize("H,cin,width,cout,strides,bands", [
    (56, 64, 128, 256, [1, 1, 1], [28, 1, 2, 4, 7, 8, 14, 56]),
    (16, 128, 128, 256, [2, 1, 1], [4, 1, 2, 8]),
])
def test_banded_stage_equal_across_band_counts(cuda, H, cin, width, cout,
                                               strides, bands):
    g = torch.Generator().manual_seed(H + cin)
    fws = stage_weights(g, cin, width, cout, strides, False, cuda)
    x = torch.randn(2, H, H, cin, generator=g).clamp_min(0).to(
        cuda, torch.bfloat16)
    want = stage_reference(x, fws, strides)
    outs = [fused_stage_banded(x, fws, strides, band) for band in bands]
    torch.cuda.synchronize()
    assert_close_bf16(outs[0], want)
    for band, got in zip(bands[1:], outs[1:]):
        words = int((got != outs[0]).sum())
        print(f"band {band}: {words} of {got.numel()} words differ from "
              f"band {bands[0]}")
        assert words == 0


# K3a in bf16 on the tile against the chain of its blocks' K1 launches: both
# run the same tile and grouped 3x3 on every pixel, so 0 words differ
@pytest.mark.parametrize("H,cin,width,cout,strides", [
    (14, 1024, 512, 1024, [1] * 5),      # layer 3's tail
    (14, 1024, 1024, 2048, [2, 1, 1]),   # layer 4
    (12, 256, 128, 256, [2, 1, 1]),      # test_hwbc_kernels.py:91
    (7, 512, 256, 512, [2, 1]),          # odd 7 -> 4
])
def test_bf16_stage_equals_its_k1_chain(cuda, H, cin, width, cout, strides):
    g = torch.Generator().manual_seed(H + cin + width)
    fws = stage_weights(g, cin, width, cout, strides, False, cuda)
    x = torch.randn(4, H, H, cin, generator=g).clamp_min(0).to(
        cuda, torch.bfloat16)
    before = fused_stage.launches
    got = fused_stage(x, fws, strides)
    chain = x
    for fw, s in zip(fws, strides):
        chain = fused_bottleneck(chain, fw, stride=s)
    torch.cuda.synchronize()
    assert fused_stage.launches == before + 1
    assert_close_bf16(got, stage_reference(x, fws, strides))
    words = int((got != chain).sum())
    print(f"K3a bf16: {words} of {got.numel()} words differ from the K1 "
          f"chain")
    assert words == 0


# K2 on the int8 1x1 tile (csrc/conv_gemm_s8.cuh): every int8 block shape
# of the published plan (layers 3-4 at 224 px) at B = 32, and ragged row
# counts of its 128- and 64-row tiles (B = 2 at odd sizes)
@pytest.mark.parametrize("B,stride,has_ds,H,cin,width,cout", [
    (32, 2, True, 28, 512, 512, 1024), (32, 1, False, 14, 1024, 512, 1024),
    (32, 2, True, 14, 1024, 1024, 2048), (32, 1, False, 7, 2048, 1024, 2048),
    (2, 2, True, 9, 512, 512, 1024), (2, 1, False, 7, 1024, 512, 1024),
    (2, 1, True, 5, 64, 128, 256),
])
def test_int8_kernel_matches_plain_version_at_every_block_shape(
        cuda, B, stride, has_ds, H, cin, width, cout):
    g = torch.Generator().manual_seed(B + H + cin)
    fw = q_block(g, cin, width, cout, has_ds, cuda)
    x = torch.randint(0, 100, (B, H, H, cin), generator=g,
                      dtype=torch.int8).to(cuda)
    before = fused_bottleneck.launches_q
    got = fused_bottleneck(x, fw, stride=stride)
    want = bottleneck_reference_q(x, fw, stride=stride)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches_q == before + 1
    codes_close(got, want)
    assert int((got != want).sum()) == 0  # both sum exactly, round alike


# K3a's int8 body on the int8 tile against the chain of its blocks' K2
# launches: both run the same tile arithmetic and grouped 3x3 on every
# pixel, so 0 codes differ
@pytest.mark.parametrize("H,cin,width,cout,strides", [
    (14, 1024, 512, 1024, [1] * 5),      # layer 3's tail
    (14, 1024, 1024, 2048, [2, 1, 1]),   # layer 4
    (9, 512, 512, 1024, [2, 1]),         # stride-2 head, 9 -> 5
])
def test_int8_stage_equals_its_k2_chain(cuda, H, cin, width, cout, strides):
    g = torch.Generator().manual_seed(H + cin + width)
    fws = stage_weights(g, cin, width, cout, strides, True, cuda)
    x = torch.randint(0, 100, (4, H, H, cin), generator=g,
                      dtype=torch.int8).to(cuda)
    before = fused_stage.launches
    got = fused_stage(x, fws, strides)
    chain = x
    for fw, s in zip(fws, strides):
        chain = fused_bottleneck(chain, fw, stride=s)
    torch.cuda.synchronize()
    assert fused_stage.launches == before + 1
    codes_close(got, stage_reference(x, fws, strides))
    codes = int((got != chain).sum())
    print(f"K3a int8: {codes} of {got.numel()} codes differ from the K2 "
          f"chain")
    assert codes == 0


# the banded int8 stage (K3b's banding on int8 codes) in 1, 2, 4, 8 and 16
# bands: every band count equal code for code
@pytest.mark.parametrize("H,cin,width,cout,strides,bands", [
    (16, 64, 128, 256, [1, 1, 1], [8, 1, 2, 4, 16]),
    (16, 256, 128, 256, [2, 1, 1], [4, 1, 2, 8]),
])
def test_banded_int8_stage_equal_across_band_counts(cuda, H, cin, width,
                                                    cout, strides, bands):
    g = torch.Generator().manual_seed(H + cin + 1)
    fws = stage_weights(g, cin, width, cout, strides, True, cuda)
    x = torch.randint(0, 100, (2, H, H, cin), generator=g,
                      dtype=torch.int8).to(cuda)
    want = stage_reference(x, fws, strides)
    outs = [fused_stage_banded(x, fws, strides, band) for band in bands]
    torch.cuda.synchronize()
    codes_close(outs[0], want)
    for band, got in zip(bands[1:], outs[1:]):
        codes = int((got != outs[0]).sum())
        print(f"band {band}: {codes} of {got.numel()} codes differ from "
              f"band {bands[0]}")
        assert codes == 0


# The forced-choice eval's batches (evaluation/forced_choice.py): the trunk
# sees B = 4 x trials in image mode and B = trials in text mode, down to
# B = 4 and B = 1 on a tail chunk. K1, K3b and K3a's bf16 body at B = 1
# and 4 at every shape the published plan gives them (layer 1 banded in 28
# rows, layer 2's blocks and layer 3's head, layer 3's tail and layer 4):
# each K1 launch against its plain version on the same input, and each
# stage against its blocks' K1 launches word for word (a chain of plain
# blocks drifts from the K1 chain by one-ulp roundings carried on; the
# stage is held to the chain, each launch of the chain to its plain block)
PLAN_K1_BLOCKS = [(2, True, 56, 256, 256, 512), (1, False, 28, 512, 256, 512),
                  (2, True, 28, 512, 512, 1024)]
PLAN_BF16_STAGES = [(56, 64, 128, 256, [1, 1, 1], 28),
                    (14, 1024, 512, 1024, [1] * 5, None),
                    (14, 1024, 1024, 2048, [2, 1, 1], None)]


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("stride,has_ds,H,cin,width,cout", PLAN_K1_BLOCKS)
def test_kernel_matches_plain_version_at_eval_batches(
        cuda, B, stride, has_ds, H, cin, width, cout):
    x, fw = make_block(cin, width, cout, has_ds, H, B, cuda)
    x = x.clamp_min(0)
    before = fused_bottleneck.launches
    got = fused_bottleneck(x, fw, stride=stride)
    want = bottleneck_reference(x, fw, stride=stride)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches == before + 1
    assert got.shape == want.shape
    assert_close_bf16(got, want)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("H,cin,width,cout,strides,band", PLAN_BF16_STAGES)
def test_bf16_stages_match_plain_version_at_eval_batches(
        cuda, B, H, cin, width, cout, strides, band):
    g = torch.Generator().manual_seed(H + cin + width + B)
    fws = stage_weights(g, cin, width, cout, strides, False, cuda)
    x = torch.randn(B, H, H, cin, generator=g).clamp_min(0).to(
        cuda, torch.bfloat16)
    counter = fused_stage if band is None else fused_stage_banded
    before = counter.launches
    got = (fused_stage(x, fws, strides) if band is None
           else fused_stage_banded(x, fws, strides, band))
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    chain = x
    for fw, s in zip(fws, strides):
        block_in, chain = chain, fused_bottleneck(chain, fw, stride=s)
        assert_close_bf16(chain, bottleneck_reference(block_in, fw,
                                                      stride=s))
    words = int((got != chain).sum())
    print(f"B = {B}: {words} of {got.numel()} words differ from the K1 "
          f"chain")
    assert words == 0


# K2 and K3a's int8 body at B = 32, the int8 plan's batch in the eval (a
# chunk of 8 image-mode trials or 32 text-mode trials): layer 3's head
# (K2), layer 3's tail and layer 4 (K3a), against their plain versions and
# K3a against its K2 chain code for code
@pytest.mark.parametrize("H,cin,width,cout,strides", [
    (28, 512, 512, 1024, [2]),
    (14, 1024, 512, 1024, [1] * 5),
    (14, 1024, 1024, 2048, [2, 1, 1]),
])
def test_int8_plan_matches_plain_version_at_eval_batch(cuda, H, cin, width,
                                                       cout, strides):
    g = torch.Generator().manual_seed(H + cin + width + 32)
    fws = stage_weights(g, cin, width, cout, strides, True, cuda)
    x = torch.randint(0, 100, (32, H, H, cin), generator=g,
                      dtype=torch.int8).to(cuda)
    chain = x
    for fw, s in zip(fws, strides):
        chain = fused_bottleneck(chain, fw, stride=s)
    want = stage_reference(x, fws, strides)
    if len(strides) == 1:
        codes_close(chain, want)
        assert int((chain != want).sum()) == 0
        return
    before = fused_stage.launches
    got = fused_stage(x, fws, strides)
    torch.cuda.synchronize()
    assert fused_stage.launches == before + 1
    codes_close(got, want)
    assert int((got != chain).sum()) == 0


# The forced-choice eval on the card (the published trunk's default plan in
# bf16: K3b, K1, K3a) against its CPU run (f32, the conv path) on the same
# weights: equal decisions on every trial whose CPU top-two log-probability
# gap exceeds 0.1 (about twice the largest difference between a bf16 path,
# the plain version of the card's plan included, and f32 on random weights
# in tests/test_torch_forced_choice.py; random-weight features of a deep
# trunk lie close together, so most gaps are smaller)
def test_forced_choice_on_the_card_matches_its_cpu_run(cuda):
    import numpy as np
    from multimodal_baby_tpu_torch.core.config import (
        ModelConfig, TextConfig, VisionConfig)
    from multimodal_baby_tpu_torch.evaluation.forced_choice import (
        run_forced_choice)
    from multimodal_baby_tpu_torch.models.multimodal import CVCL
    from multimodal_baby_tpu_torch.models.vision_resnext import InferenceBN

    cfg = ModelConfig(embedding_dim=64, vocab_size=12, normalize_features=True,
                      fix_temperature=True,
                      vision=VisionConfig(frozen_bn="running"),
                      text=TextConfig(text_encoder="embedding"))
    g = torch.Generator().manual_seed(0)
    cpu = CVCL(cfg, device="cpu", generator=g)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, InferenceBN):
                c = m.weight.numel()
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.75 + 0.5 * torch.rand(c, generator=g))
    card = CVCL(cfg, dtype=torch.bfloat16, device=cuda)
    card.load_state_dict(cpu.state_dict())

    rng = np.random.RandomState(1)
    bases = rng.randint(0, 256, (8, 8, 8, 3), np.uint8).repeat(8, 1).repeat(
        8, 2)  # 8 categories of coarse 64 px textures
    trials = []
    for t in range(96):
        cats = [(t + k * 3) % 8 for k in range(4)]
        imgs = np.clip(bases[cats].astype(np.int16)
                       + rng.randint(-20, 21, (4, 64, 64, 3)), 0, 255)
        ids = np.zeros(25, np.int32)
        ids[:3] = [2, 4 + cats[0], 3]
        trials.append((imgs.astype(np.uint8), ids, 3, str(cats[0])))

    _, want = run_forced_choice(cpu, trials, "image", batch_size=32)
    before = fused_stage_banded.launches
    _, got = run_forced_choice(card, trials, "image", batch_size=32)
    assert fused_stage_banded.launches == before + 3  # B = 128 a chunk
    lp = np.log([r["logits"] for r in want])
    top2 = np.sort(lp, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 0.1
    print(f"{int(clear.sum())} of {len(trials)} trials clear; max log-prob "
          f"difference {np.abs(np.log([r['logits'] for r in got]) - lp).max():.4f}")
    assert clear.sum() >= 8
    assert all(g["pred"] == w["pred"]
               for g, w, c in zip(got, want, clear) if c)


# the published recipe's trainer at a small data size: 64 synthetic frames
# at B = 32 (2 steps an epoch; the int8 plan runs at B % 32 == 0), the int8
# ranges measured again after a resume within 1e-6 relative of the saved
def test_trainer_published_trunk_and_resume(cuda, tmp_path):
    from multimodal_baby_tpu_torch.cli.train import make_trainer

    argv = ["--dataset", "synthetic", "--synthetic_size", "64",
            "--cnn_dino", "--frozen_bn", "running", "--trunk_int8",
            "0,0,1,1", "--embedding_dim", "512", "--normalize_features",
            "--fix_temperature", "--augment_frames", "--dropout_i", "0.5",
            "--lr", "1e-4", "--weight_decay", "0.1", "--lr_scheduler",
            "--batch_size", "32", "--val_batch_size", "32", "--drop_last",
            "--optimize_unused", "--num_workers", "4", "--max_epochs", "2",
            "--checkpoint_dir", str(tmp_path), "--device", "cuda"]
    counters = [(fused_bottleneck, "launches"),
                (fused_bottleneck, "launches_q"),
                (fused_stage, "launches"), (fused_stage_banded, "launches")]
    trainer = make_trainer(argv)
    per_step = []
    step = trainer.train_step

    def counted(state, batch):
        before = [getattr(fn, attr) for fn, attr in counters]
        out = step(state, batch)
        per_step.append([getattr(fn, attr) - b
                         for (fn, attr), b in zip(counters, before)])
        return out

    trainer.train_step = counted
    out = trainer.fit()
    assert torch.isfinite(torch.tensor(out["loss"]))
    assert per_step == [[4, 1, 2, 1]] * 4
    saved = torch.load(tmp_path / "default" / "last" / "state.pt",
                       map_location="cuda", weights_only=True)["model"]
    resumed = make_trainer(argv + ["--resume_ckpt", "last",
                                   "--max_epochs", "3"])
    assert (resumed.start_epoch, resumed.state.step) == (2, 4)
    now = resumed.model.state_dict()
    amax = [k for k in now if k.endswith("_amax")]
    assert len(amax) == 1 + 2 * (6 + 3) + 16  # stem; h1, h2 of layers 3-4
    for k in amax:
        assert float(saved[k]) > 0
        assert abs(float(now[k] - saved[k])) <= 1e-6 * float(saved[k]), k
    resumed.fit()
    assert resumed.state.step == 6


# ------------------------------------------------- text generation, grad-CAM
# and the alignment's features on the published trunk's kernels: each run
# against the same run with the trunk's kernels replaced by their plain
# versions on the card (bf16 both, the same rounding points), per-row or
# per-map cosine >= 0.999 (chip_smoke.py's slice gate)

SLICE_COS = 0.999
PLAN_BF16 = [5, 0, 2, 1]   # K1, K2, K3a, K3b launches a forward
PLAN_INT8 = [4, 1, 2, 1]
RESNEXT_COUNTERS = [(fused_bottleneck, "launches"),
                    (fused_bottleneck, "launches_q"),
                    (fused_stage, "launches"), (fused_stage_banded, "launches")]


def launches():
    return [getattr(fn, attr) for fn, attr in RESNEXT_COUNTERS]


class plain_trunk:
    """The trunk's kernels replaced by their plain versions on CUDA tensors
    (the wrappers take those only for CPU tensors)."""

    def __enter__(self):
        from multimodal_baby_tpu_torch.models import vision_resnext
        from multimodal_baby_tpu_torch.ops.bottleneck import block_reference
        self.saved = {n: getattr(vision_resnext, n) for n in (
            "fused_bottleneck", "fused_stage", "fused_stage_banded")}
        vision_resnext.fused_bottleneck = \
            lambda x, fw, stride=1: block_reference(x, fw, stride=stride)
        vision_resnext.fused_stage = vision_resnext.fused_stage_banded = \
            lambda x, fws, strides, band=None: stage_reference(x, fws,
                                                               strides)
        self.module = vision_resnext
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def row_cos(a, b):
    a, b = a.flatten(1).double(), b.flatten(1).double()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-30)


def card_model(device, text="embedding", captioning=False, int8=False,
               vocab=40):
    """A ResNeXt-50 CVCL in bf16 on the card with perturbed BN statistics,
    its int8 plan (layers 3-4) calibrated when asked for."""
    import numpy as np
    from multimodal_baby_tpu_torch.core.config import (
        ModelConfig, TextConfig, VisionConfig)
    from multimodal_baby_tpu_torch.models.multimodal import CVCL
    from multimodal_baby_tpu_torch.models.vision_resnext import InferenceBN
    from multimodal_baby_tpu_torch.train.step import calibrate_trunk

    cfg = ModelConfig(
        embedding_dim=64, vocab_size=vocab, normalize_features=True,
        fix_temperature=True,
        vision=VisionConfig(frozen_bn="running", trunk_int8=(
            (False, False, True, True) if int8 else False)),
        text=TextConfig(text_encoder=text, captioning=captioning))
    g = torch.Generator().manual_seed(0)
    model = CVCL(cfg, dtype=torch.bfloat16, device=device, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, InferenceBN):
                c = m.weight.numel()
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.75 + 0.5 * torch.rand(c, generator=g))
    if int8:
        frames = np.random.RandomState(5).randint(0, 256, (32, 224, 224, 3),
                                                  np.uint8)
        calibrate_trunk(model, {"image_u8": torch.from_numpy(frames).to(
            device)})
    return model


@pytest.mark.parametrize("B", [4, 1])
def test_grad_cam_on_the_card_matches_plain(cuda, B):
    from multimodal_baby_tpu_torch.analysis.attention_maps import grad_cam

    model = card_model(cuda)
    g = torch.Generator().manual_seed(B)
    images = torch.randn((B, 224, 224, 3), generator=g).to(cuda)
    text = torch.zeros((B, 25), dtype=torch.long, device=cuda)
    text[:, 0] = torch.arange(4, 4 + B)
    lens = torch.ones((B,), dtype=torch.long, device=cuda)
    before = launches()
    got = grad_cam(model, images, text, lens)
    assert [a - b for a, b in zip(launches(), before)] == PLAN_BF16
    with plain_trunk():
        want = grad_cam(model, images, text, lens)
    assert got.shape == (B, 224, 224) and got.min() >= 0
    cos = row_cos(torch.from_numpy(got), torch.from_numpy(want))
    assert float(cos.min()) >= SLICE_COS


@pytest.mark.parametrize("B", [64, 16])
def test_captioning_textgen_on_the_card_matches_plain(cuda, B):
    import numpy as np
    from multimodal_baby_tpu_torch.data.augment import normalize_image
    from multimodal_baby_tpu_torch.data.vocab import Vocab
    from multimodal_baby_tpu_torch.evaluation.textgen import (
        ids_to_sentence, run_textgen_eval)

    model = card_model(cuda, text="lstm", captioning=True, int8=True)
    vocab = Vocab({w: i for i, w in enumerate(
        ["<pad>", "<unk>", "<sos>", "<eos>"] + [f"w{i}" for i in range(36)])})
    rng = np.random.RandomState(B)
    batch = {"text": np.zeros((B, 25), np.int32),
             "text_len": np.ones((B,), np.int32),
             "raw": [f"w{i % 36} w{(3 * i) % 36}" for i in range(B)],
             "image_u8": rng.randint(0, 256, (B, 224, 224, 3), np.uint8)}
    x = normalize_image(torch.from_numpy(batch["image_u8"]).to(cuda))
    runs = {}
    for path in ("kernels", "plain"):
        ctx = plain_trunk() if path == "plain" else torch.no_grad()
        with ctx:
            before = launches()
            scores, _, hyps = run_textgen_eval(model, [batch], vocab,
                                               captioning=True)
            counts = [a - b for a, b in zip(launches(), before)]
            with torch.no_grad():
                feats, _ = model.encode_image(x)
                seq, beam = model.beam_search_decode(B, 3, 25, 0.0, feats)
        runs[path] = (counts, scores, hyps, feats, seq, beam)
    counts, scores, hyps, feats, seq, _ = runs["kernels"]
    _, _, p_hyps, p_feats, p_seq, p_beam = runs["plain"]
    assert counts == (PLAN_INT8 if B % 32 == 0 else PLAN_BF16)
    assert float(row_cos(feats, p_feats).min()) >= SLICE_COS
    assert hyps == [ids_to_sentence(s, vocab) for s in seq[:, 0].cpu()]
    clear = (p_beam[:, 0] - p_beam[:, 1]) > 0.05
    same = (seq[:, 0] == p_seq[:, 0]).all(dim=1)
    assert bool(same[clear].all())
    assert all(np.isfinite(v) for v in scores.values())


def test_category_feature_sets_on_the_card_match_plain(cuda, tmp_path):
    import numpy as np
    from PIL import Image
    from multimodal_baby_tpu_torch.analysis.embeddings import (
        category_feature_sets)
    from multimodal_baby_tpu_torch.data.vocab import Vocab

    model = card_model(cuda, int8=True)
    rng = np.random.RandomState(7)
    for cat, n in (("ball", 100), ("car", 8)):  # chunks of 64 and 36; 8
        (tmp_path / cat).mkdir()
        for i in range(n):
            Image.fromarray(rng.randint(0, 256, (32, 32, 3), np.uint8)).save(
                tmp_path / cat / f"{i}.png")
    vocab = Vocab({w: i for i, w in enumerate(
        ["<pad>", "<unk>", "<sos>", "<eos>", "ball", "car"])})
    chunks = []
    encode = model.encode_image

    def counted(x, train=False):
        before = launches()
        out = encode(x, train)
        chunks.append((x.shape[0], [a - b for a, b in
                                    zip(launches(), before)]))
        return out

    model.encode_image = counted
    try:
        got = category_feature_sets(model, tmp_path, vocab)
        with plain_trunk():
            want = category_feature_sets(model, tmp_path, vocab)
    finally:
        del model.encode_image
    assert chunks[:3] == [(64, PLAN_INT8), (36, PLAN_BF16), (8, PLAN_BF16)]
    assert got["all_image_features"].shape == (108, 64)
    for k in ("all_image_features", "mean_image_features"):
        cos = row_cos(torch.from_numpy(got[k]), torch.from_numpy(want[k]))
        assert float(cos.min()) >= SLICE_COS, k
    np.testing.assert_array_equal(got["text_features"],
                                  want["text_features"])


# ------------------------------------------------- the host input path: the
# pinned staging ring of device_batch, and the trainer on JPEG frames


def test_staging_ring_survives_a_slow_consumer(cuda):
    """device_batch through a HostStaging ring of depth 2, 8 batches, each
    consumed behind a device-side delay (torch.cuda._sleep) while the host
    stages the next: every device batch equals its host batch (a slot
    refilled before its copy ran would hand a batch the next one's data);
    int32 ids and lengths arrive as int64 with the host's values."""
    import numpy as np
    from multimodal_baby_tpu_torch.train.step import (
        HostStaging, device_batch)

    rng = np.random.RandomState(0)
    staging = HostStaging(depth=2)
    hosts, seen = [], []
    for i in range(8):
        b = 16 if i < 7 else 5  # a tail batch reuses a slot's first rows
        host = {"image_u8": rng.randint(0, 256, (b, 224, 224, 3), np.uint8),
                "text": rng.randint(0, 2350, (b, 25)).astype(np.int32),
                "text_len": rng.randint(1, 26, b).astype(np.int32),
                "raw": [""] * b}
        dev = device_batch(host, cuda, staging)
        torch.cuda._sleep(20_000_000)  # ~10 ms behind on the stream
        seen.append({k: v.clone() for k, v in dev.items()})
        hosts.append(host)
    torch.cuda.synchronize()
    for host, dev in zip(hosts, seen):
        assert set(dev) == {"image_u8", "text", "text_len"}
        assert dev["image_u8"].dtype == torch.uint8
        assert dev["text"].dtype == dev["text_len"].dtype == torch.int64
        for k, v in dev.items():
            assert torch.equal(v.cpu(), torch.from_numpy(
                host[k].astype(np.int64) if k != "image_u8" else host[k]))


def test_trainer_first_step_on_jpeg_frames_matches_plain(cuda, tmp_path):
    """The published recipe's first train step through cli/train on a
    SAYCam-format directory of 256 px JPEG frames at B = 32: K1, K2, K3a
    and K3b launched [4, 1, 2, 1] times, and its loss within 1e-2 of the
    same step with the trunk's plain versions (chip_smoke.py's phase 10
    gate)."""
    import json
    import numpy as np
    from PIL import Image
    from multimodal_baby_tpu_torch.cli.train import make_trainer
    from multimodal_baby_tpu_torch.train.step import device_batch

    rng = np.random.RandomState(3)
    words = ["ball", "car", "cat", "look", "the"]
    frames = []
    for i in range(16):
        low = rng.randint(0, 256, (16, 16, 3), np.uint8)
        img = Image.fromarray(low).resize((256, 256), Image.BILINEAR)
        path = tmp_path / f"f{i}.jpg"
        img.save(path, quality=90)
        frames.append(str(path))
    data = [{"utterance": " ".join(rng.choice(words, 3)),
             "frame_filenames": list(rng.choice(frames, 2))}
            for _ in range(64)]
    (tmp_path / "train.json").write_text(json.dumps({"data": data}))
    (tmp_path / "vocab.json").write_text(json.dumps({w: i for i, w in
        enumerate(["<pad>", "<unk>", "<sos>", "<eos>"] + words)}))
    argv = ["--dataset", "saycam", "--data_dir", str(tmp_path),
            "--cnn_dino", "--frozen_bn", "running", "--trunk_int8",
            "0,0,1,1", "--embedding_dim", "512", "--normalize_features",
            "--fix_temperature", "--augment_frames", "--batch_size", "32",
            "--drop_last", "--optimize_unused", "--multiple_frames",
            "--checkpoint_dir", str(tmp_path / "ck"), "--device", "cuda"]
    losses = []
    for plain in (False, True):
        trainer = make_trainer(argv)
        batch = trainer.data.datasets["train"].batch_items(np.arange(32))
        before = launches()
        if plain:
            with plain_trunk():
                out = trainer.train_step(trainer.state, device_batch(
                    batch, cuda, trainer.staging))
        else:
            out = trainer.train_step(trainer.state, device_batch(
                batch, cuda, trainer.staging))
            assert [a - b for a, b in zip(launches(), before)] == PLAN_INT8
        losses.append(float(out["loss"]))
    assert all(np.isfinite(losses))
    assert abs(losses[0] - losses[1]) <= 1e-2 * abs(losses[1])


def published_model(seed):
    """The published recipe's CVCL (int8 layers 3-4, the default plan) in
    bf16 on the card, seeded."""
    from multimodal_baby_tpu_torch.core.config import (
        ModelConfig, TextConfig, VisionConfig)
    from multimodal_baby_tpu_torch.models.multimodal import CVCL
    cfg = ModelConfig(
        embedding_dim=512, vocab_size=64, normalize_features=True,
        fix_temperature=True,
        vision=VisionConfig(cnn_dino=True, frozen_bn="running",
                            trunk_int8="0,0,1,1"),
        text=TextConfig(text_encoder="embedding"))
    return CVCL(cfg, torch.bfloat16, device="cuda",
                generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("vit", [False, True])
def test_backbone_checkpoint_features_bit_for_bit(cuda, tmp_path, vit):
    """A seeded trunk written as a DINO checkpoint (teacher/module.backbone.)
    and loaded into a differently seeded CVCL through api/backbones: the
    image features, through the published plan (B = 32: [4, 1, 2, 1]
    launches) or K5 and K6 (the ViT, B = 2), equal the written model's bit
    for bit (the head copied, the int8 ranges calibrated on the same
    frames)."""
    from multimodal_baby_tpu_torch.api.backbones import load_backbone
    from multimodal_baby_tpu_torch.core.config import (
        ModelConfig, TextConfig, VisionConfig)
    from multimodal_baby_tpu_torch.models.multimodal import CVCL
    from multimodal_baby_tpu_torch.train.step import calibrate_trunk

    def build(seed):
        if not vit:
            return published_model(seed)
        cfg = ModelConfig(embedding_dim=512, vocab_size=64,
                          vision=VisionConfig(vit_dino=True),
                          text=TextConfig(text_encoder="embedding"))
        return CVCL(cfg, torch.bfloat16, device="cuda",
                    generator=torch.Generator().manual_seed(seed))

    a, b = build(1), build(2)
    trunk_a, trunk_b = a.vision_encoder.model, b.vision_encoder.model
    head = "head" if vit else "fc"
    name = "dino_sfp_vitb14" if vit else "dino_sfp_resnext50"
    inner = {f"module.backbone.{k}": v.cpu()
             for k, v in trunk_a.state_dict().items()
             if not k.startswith(head + ".") and not k.endswith("_amax")}
    torch.save({"teacher": inner, "epoch": 1}, tmp_path / f"{name}.pth")
    load_backbone(b, name, str(tmp_path / f"{name}.pth"))
    getattr(trunk_b, head).load_state_dict(
        getattr(trunk_a, head).state_dict())
    g = torch.Generator().manual_seed(3)
    n = 2 if vit else 32
    x = (torch.randn(n, 224, 224, 3, generator=g)).to(cuda, torch.bfloat16)
    if not vit:
        calibrate_trunk(a, {"image": x})
        calibrate_trunk(b, {"image": x})
    feats = []
    for model in (a, b):
        before = launches()
        with torch.no_grad():
            feats.append(model.encode_image(x)[0])
        if not vit:
            assert [p - q for p, q in zip(launches(), before)] == PLAN_INT8
    assert torch.equal(feats[0], feats[1])


@pytest.mark.parametrize("global_negatives", [True, False])
def test_world_one_nccl_step_equals_plain_step(cuda, tmp_path,
                                               global_negatives):
    """The published recipe's train step through the distributed path (an
    nccl process group of one through a file:// store, mesh (1, 1)) and
    the one-device step, from the same weights on the same batch of 32:
    equal losses and updated parameters, bit for bit; [4, 1, 2, 1]
    launches each."""
    import numpy as np
    import torch.distributed as dist
    from multimodal_baby_tpu_torch.core.config import (
        ExperimentConfig, TrainConfig)
    from multimodal_baby_tpu_torch.parallel.mesh import create_mesh
    from multimodal_baby_tpu_torch.train.step import (
        calibrate_trunk, device_batch, init_train_state, make_train_step)

    rng = np.random.RandomState(4)
    lens = rng.randint(2, 20, 32)
    text = np.zeros((32, 25), np.int64)
    for i, n in enumerate(lens):
        text[i, :n] = rng.randint(4, 64, n)
    batch = device_batch({"image_u8": rng.randint(0, 256, (32, 224, 224, 3),
                                                  np.uint8),
                          "text": text, "text_len": lens}, cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = create_mesh((1, 1))
        out = []
        for m in (mesh, None):
            model = published_model(5)
            cfg = ExperimentConfig(model=model.cfg, train=TrainConfig(
                lr=1e-4, weight_decay=0.1))
            cfg.parallel.global_batch_negatives = global_negatives
            cfg.data.augment_frames = True
            calibrate_trunk(model, batch)
            state = init_train_state(model, cfg, m)
            step = make_train_step(model, cfg, m)
            before = launches()
            loss = float(step(state, batch)["loss"])
            assert [p - q for p, q in zip(launches(), before)] == PLAN_INT8
            out.append((loss, {k: v.detach().clone() for k, v in
                               model.named_parameters() if v.requires_grad}))
        assert out[0][0] == out[1][0]
        for k, v in out[0][1].items():
            assert torch.equal(v, out[1][1][k]), k
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("M,K,N", [(514, 768, 2304), (514, 768, 768),
                                   (514, 768, 3072), (514, 3072, 768),
                                   (10, 768, 2304)])
def test_int8_dense_on_the_card_matches_plain(cuda, M, K, N):
    """The ViT's int8 Dense (torch._int_mm on the card; 10 rows are padded
    to the 17 it takes) against its plain version on the CPU: the same
    scales (the card divides by 127 as the CPU does), activation and
    weight codes, and outputs within 1e-6 of the largest (both sum the
    codes exactly and dequantize with the same f32 ops)."""
    from multimodal_baby_tpu_torch.ops.quant import (
        activation_scale, dense_weight_codes, int8_dense, quantize_dynamic)
    g = torch.Generator().manual_seed(M + K + N)
    amax = torch.rand(64, generator=g) * 100
    assert torch.equal(torch.stack([activation_scale(a.to(cuda))
                                    for a in amax]).cpu(),
                       torch.stack([activation_scale(a) for a in amax]))
    x = torch.randn(M, K, generator=g).to(torch.bfloat16)
    w = torch.randn(N, K, generator=g) * K ** -0.5
    bias = torch.randn(N, generator=g) * 0.1
    codes, scale = dense_weight_codes(w.to(cuda))
    want_codes, want_scale = dense_weight_codes(w)
    assert torch.equal(codes.cpu(), want_codes)
    assert torch.equal(scale.cpu(), want_scale)
    assert torch.equal(quantize_dynamic(x.to(cuda))[0].cpu(),
                       quantize_dynamic(x)[0])
    got = int8_dense(x.to(cuda), codes, scale, bias.to(cuda), torch.float32)
    want = int8_dense(x, want_codes, want_scale, bias, torch.float32)
    assert got.shape == want.shape == (M, N)
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert float(err) <= 1e-6


@pytest.mark.parametrize("stride,has_ds,H,cin,width,cout", [
    (1, False, 8, 256, 128, 256), (2, True, 16, 64, 128, 256)])
def test_bottleneck_diff_forward_is_k1_and_its_gradients_plain(
        cuda, stride, has_ds, H, cin, width, cout):
    """fused_bottleneck_diff: the forward is K1's output bit for bit (one
    launch), and the gradients of x and of every folded weight are plain
    autograd's through bottleneck_reference (cosine >= 0.9999)."""
    from multimodal_baby_tpu_torch.ops.bottleneck import (
        fused_bottleneck_diff)
    x, fw = make_block(cin, width, cout, has_ds, H, 32, cuda)
    leaves = {"x": x.requires_grad_(),
              **{k: v.requires_grad_() for k, v in fw.items()}}
    before = fused_bottleneck.launches
    y = fused_bottleneck_diff(x, fw, stride)
    assert fused_bottleneck.launches == before + 1
    with torch.no_grad():
        assert torch.equal(y, fused_bottleneck(x, fw, stride))
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(
        cuda, y.dtype)
    got = torch.autograd.grad(y, list(leaves.values()), g)
    want = torch.autograd.grad(bottleneck_reference(x, fw, stride=stride),
                               list(leaves.values()), g)
    for name, a, b in zip(leaves, got, want):
        cos = torch.nn.functional.cosine_similarity(
            a.float().flatten(), b.float().flatten(), dim=0)
        assert a.shape == b.shape and float(cos) >= COS_TOL, name
