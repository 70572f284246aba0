"""The port's bottleneck module (K1) against the JAX package on the CPU.

The port's plain ``bottleneck_reference`` at f32 is held against two JAX
oracles on the same numpy-seeded inputs: the JAX ``bottleneck_reference``
and the Pallas kernel ``fused_bottleneck_hwbc`` in interpret mode (through
``to_hwbc``/``from_hwbc``, as ``tests/test_hwbc_kernels.py`` runs it), at
that test's shapes and its tolerance (RTOL 5e-5, max error relative to
the largest output: f32 with another summation order). The fold is held
against JAX's ``fold_block_params``. The CUDA kernel itself is checked on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_baby_tpu.ops import bottleneck_hwbc as J
from multimodal_baby_tpu_torch.ops import bottleneck as T

RTOL = 5e-5
FOLD_RTOL = 1e-6  # the same f32 formula; rsqrt may differ by an ulp

SHAPES = [  # tests/test_hwbc_kernels.py::test_fused_block
    (1, False, 8, 256, 128, 256, 4, 2),
    (1, True, 8, 64, 128, 256, 8, 4),
    (2, True, 8, 256, 256, 512, 4, 2),
    (2, True, 16, 64, 128, 256, 4, 2),
]


def make_weights(rng, cin, width, cout, has_ds):
    """Folded f32 weights: (port dict with compact w2, JAX dict with w2
    packed by the JAX package)."""
    cg = width // 32
    fw = {
        "w1": rng.randn(cin, width).astype(np.float32) * .05,
        "b1": rng.randn(width).astype(np.float32) * .1,
        "w2": rng.randn(3, 3, cg, width).astype(np.float32) * .05,
        "b2": rng.randn(width).astype(np.float32) * .1,
        "w3": rng.randn(width, cout).astype(np.float32) * .05,
        "b3": rng.randn(cout).astype(np.float32) * .1,
    }
    if has_ds:
        fw["wd"] = rng.randn(cin, cout).astype(np.float32) * .05
        fw["bd"] = rng.randn(cout).astype(np.float32) * .1
    jfw = {k: jnp.asarray(v) for k, v in fw.items()}
    jfw["w2"] = J.pack_grouped_kernel(jfw["w2"], 32)
    return {k: torch.from_numpy(v) for k, v in fw.items()}, jfw


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("stride,has_ds,H,cin,width,cout,hh,R", SHAPES)
def test_reference_matches_jax_reference(stride, has_ds, H, cin, width,
                                         cout, hh, R):
    rng = np.random.RandomState(1)
    tfw, jfw = make_weights(rng, cin, width, cout, has_ds)
    x = rng.randn(32, H, H, cin).astype(np.float32)
    got = T.bottleneck_reference(torch.from_numpy(x), tfw, stride=stride)
    want = J.bottleneck_reference(jnp.asarray(x), jfw, stride=stride)
    assert tuple(got.shape) == want.shape
    assert rel_err(got, want) < RTOL


@pytest.mark.parametrize("stride,has_ds,H,cin,width,cout,hh,R", SHAPES)
def test_reference_matches_pallas_kernel(stride, has_ds, H, cin, width,
                                         cout, hh, R):
    rng = np.random.RandomState(1)
    tfw, jfw = make_weights(rng, cin, width, cout, has_ds)
    x = rng.randn(32, H, H, cin).astype(np.float32)
    got = T.fused_bottleneck(torch.from_numpy(x), tfw, stride=stride)
    want = J.from_hwbc(J.fused_bottleneck_hwbc(
        J.to_hwbc(jnp.asarray(x)), jfw, stride=stride, Bc=16, hh=hh, R=R))
    assert tuple(got.shape) == want.shape
    assert rel_err(got, want) < RTOL


def _random_block_state(rng, cin, width, cout, has_ds):
    """A BottleneckX state dict (torch names) and the matching flax
    params/stats subtrees, with non-trivial BN statistics."""
    cg = width // 32

    def bn(c):
        return {"weight": 1 + .1 * rng.randn(c), "bias": .1 * rng.randn(c),
                "running_mean": .1 * rng.randn(c),
                "running_var": rng.uniform(.5, 2., c)}

    convs = {"conv1": rng.randn(width, cin, 1, 1),
             "conv2": rng.randn(width, cg, 3, 3),
             "conv3": rng.randn(cout, width, 1, 1)}
    bns = {"bn1": bn(width), "bn2": bn(width), "bn3": bn(cout)}
    if has_ds:
        convs["downsample_conv"] = rng.randn(cout, cin, 1, 1)
        bns["downsample_bn"] = bn(cout)
    torch_name = {"downsample_conv": "downsample.0",
                  "downsample_bn": "downsample.1"}
    sd, params, stats = {}, {}, {}
    for name, w in convs.items():
        w = (w * .05).astype(np.float32)
        sd[f"{torch_name.get(name, name)}.weight"] = torch.from_numpy(w)
        params[name] = {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0))}
    for name, p in bns.items():
        p = {k: v.astype(np.float32) for k, v in p.items()}
        for k, v in p.items():
            sd[f"{torch_name.get(name, name)}.{k}"] = torch.from_numpy(v)
        params[name] = {"scale": jnp.asarray(p["weight"]),
                        "bias": jnp.asarray(p["bias"])}
        stats[name] = {"mean": jnp.asarray(p["running_mean"]),
                       "var": jnp.asarray(p["running_var"])}
    return sd, params, stats


@pytest.mark.parametrize("has_ds", [False, True])
def test_fold_matches_jax_fold(has_ds):
    rng = np.random.RandomState(2)
    cin, width, cout = (64, 128, 256) if has_ds else (256, 128, 256)
    sd, params, stats = _random_block_state(rng, cin, width, cout, has_ds)
    got = T.fold_block_params(sd, torch.float32)
    want = J.fold_block_params(params, stats, jnp.float32)
    want["w2"] = T.unpack_grouped_kernel(
        torch.from_numpy(np.array(want["w2"])), width // 32)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=FOLD_RTOL, atol=1e-7, err_msg=k)


def test_fold_dtypes():
    """Weights are cast to the compute dtype after the f32 fold; biases
    stay f32; the grouped weight keeps its compact [3, 3, cg, W] form."""
    rng = np.random.RandomState(3)
    sd, _, _ = _random_block_state(rng, 64, 128, 256, True)
    fw = T.fold_block_params(sd, torch.bfloat16)
    f32 = T.fold_block_params(sd, torch.float32)
    assert tuple(fw["w2"].shape) == (3, 3, 4, 128)
    for k, v in fw.items():
        want = torch.float32 if k.startswith("b") else torch.bfloat16
        assert v.dtype == want, k
        assert torch.equal(v, f32[k].to(want)), k


@pytest.mark.parametrize("cg", [4, 8, 16, 32])
def test_grouped_kernel_unpacks_to_the_packed_matrix(cg):
    """The compact grouped weight is exactly what pack_grouped_kernel packs:
    unpack(pack(w)) == w, and the packed block-diagonal matrix equals the
    dense per-group matrix built from the compact form."""
    width = 32 * cg
    rng = np.random.RandomState(cg)
    w = rng.randn(3, 3, cg, width).astype(np.float32)
    packed = J.pack_grouped_kernel(jnp.asarray(w), 32)
    back = T.unpack_grouped_kernel(torch.from_numpy(np.array(packed)), cg)
    assert torch.equal(back, torch.from_numpy(w))
    dense = np.zeros((9, width, width), np.float32)
    for co in range(width):
        g = co // cg
        dense[:, g * cg:(g + 1) * cg, co] = w.reshape(9, cg, width)[:, :, co]
    nb = width // 128
    for b in range(nb):
        blk = dense[:, b * 128:(b + 1) * 128, b * 128:(b + 1) * 128]
        np.testing.assert_array_equal(np.asarray(packed)[:, b], blk)


@pytest.mark.parametrize("H,stride", [(7, 2), (5, 1), (2, 1), (4, 2)])
def test_reference_small_and_odd_sizes(H, stride):
    """Odd and tiny spatial sizes: the plain version matches a composition
    of torch convolutions on the unfolded block (stride-2 takes rows and
    columns 0, 2, 4, ... with pad 1; the downsample reads x[:, ::2, ::2])."""
    rng = np.random.RandomState(4)
    has_ds = stride != 1
    cin, width, cout = (256, 128, 256) if not has_ds else (64, 128, 256)
    tfw, _ = make_weights(rng, cin, width, cout, has_ds)
    x = torch.from_numpy(rng.randn(2, H, H, cin).astype(np.float32))
    got = T.bottleneck_reference(x, tfw, stride=stride)
    xc = x.permute(0, 3, 1, 2)
    F = torch.nn.functional
    h1 = torch.relu(F.conv2d(xc, tfw["w1"].t()[:, :, None, None])
                    + tfw["b1"][:, None, None])
    h2 = torch.relu(F.conv2d(h1, tfw["w2"].permute(3, 2, 0, 1),
                             stride=stride, padding=1, groups=32)
                    + tfw["b2"][:, None, None])
    y = F.conv2d(h2, tfw["w3"].t()[:, :, None, None]) + tfw["b3"][:, None,
                                                                  None]
    if has_ds:
        idt = (F.conv2d(xc, tfw["wd"].t()[:, :, None, None], stride=stride)
               + tfw["bd"][:, None, None])
    else:
        idt = xc
    want = torch.relu(y + idt).permute(0, 2, 3, 1)
    ho = (H - 1) // stride + 1
    assert tuple(got.shape) == (2, ho, ho, cout)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    rng = np.random.RandomState(5)
    tfw, _ = make_weights(rng, 64, 128, 256, True)
    x = torch.from_numpy(rng.randn(2, 4, 4, 64).astype(np.float32))
    before = T.fused_bottleneck.launches
    got = T.fused_bottleneck(x, tfw, stride=2)
    assert T.fused_bottleneck.launches == before
    assert torch.equal(got, T.bottleneck_reference(x, tfw, stride=2))


def test_wrapper_raises_where_it_has_no_kernel():
    """A tensor on neither the CPU nor CUDA gets no kernel and no fallback."""
    rng = np.random.RandomState(6)
    tfw, _ = make_weights(rng, 64, 128, 256, True)
    x = torch.empty(2, 4, 4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        T.fused_bottleneck(x, {k: v.to("meta") for k, v in tfw.items()}, 2)


@pytest.mark.parametrize("bad", ["dtype", "shape", "no_ds_stride"])
def test_argument_checks(bad):
    """The checks the CUDA path runs before it launches (callable here on
    CPU tensors): wrong dtype, inconsistent shapes, a stride-2 block
    without a downsample."""
    rng = np.random.RandomState(7)
    tfw, _ = make_weights(rng, 256, 128, 256, bad != "no_ds_stride")
    fw = {k: (v if k.startswith("b") else v.to(torch.bfloat16))
          for k, v in tfw.items()}
    x = torch.zeros(2, 4, 4, 256, dtype=torch.bfloat16)
    stride = 1
    if bad == "dtype":
        x = x.float()
    elif bad == "shape":
        fw["w3"] = fw["w3"][:, :128].contiguous()
    else:
        stride = 2
    with pytest.raises(ValueError):
        T._check_args(x, fw, stride)
    if bad == "dtype":  # the well-formed call passes the checks
        T._check_args(x.to(torch.bfloat16), fw, stride)
