"""``ops/bottleneck.py::fused_bottleneck_diff`` (K1's differentiable
wrapper, the JAX package's ``fused_bottleneck_hwbc_diff``) against
``jax.vjp`` of the JAX package's ``hwbc_reference`` on the same
numpy-seeded f32 inputs and cotangent, at two of
``tests/test_hwbc_kernels.py``'s block shapes (B = 16: one batch tile of the
JAX layout). The forward equals ``fused_bottleneck`` bit for bit (on the
CPU both run the plain version; ``tests/test_torch_cuda.py`` holds it to
K1 on the card). The gradients of x and of every folded weight: max error
within 1e-4 of the largest (f32 with other summation orders); the JAX
package's packed grouped weight's gradient is unpacked to the compact form
(its block-diagonal entries). int8 codes have no gradient and are refused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.ops import bottleneck_hwbc as J
from multimodal_baby_tpu_torch.ops import bottleneck as T
from test_torch_bottleneck import make_weights, rel_err

GRAD_RTOL = 1e-4
SHAPES = [(1, True, 8, 64, 128, 256), (2, True, 16, 64, 128, 256),
          (1, False, 8, 256, 128, 256)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work on one intra-op thread: beside the other test
    workers, torch's default thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("stride,has_ds,H,cin,width,cout", SHAPES)
def test_gradients_match_jax_vjp(stride, has_ds, H, cin, width, cout):
    rng = np.random.RandomState(3)
    tfw, jfw = make_weights(rng, cin, width, cout, has_ds)
    x = rng.randn(16, H, H, cin).astype(np.float32)
    ho = (H - 1) // stride + 1
    g = rng.randn(16, ho, ho, cout).astype(np.float32)

    out, vjp = jax.vjp(lambda x_, fw_: J.hwbc_reference(x_, fw_,
                                                         stride=stride),
                       J.to_hwbc(jnp.asarray(x)), jfw)
    gx, gfw = vjp(J.to_hwbc(jnp.asarray(g)))

    xt = torch.from_numpy(x).requires_grad_()
    fw = {k: v.clone().requires_grad_() for k, v in tfw.items()}
    y = T.fused_bottleneck_diff(xt, fw, stride)
    with torch.no_grad():
        assert torch.equal(y, T.fused_bottleneck(xt, fw, stride))
    assert rel_err(y.detach(), J.from_hwbc(out)) < GRAD_RTOL
    y.backward(torch.from_numpy(g))

    assert rel_err(xt.grad, J.from_hwbc(gx)) < GRAD_RTOL
    assert sorted(gfw) == sorted(fw)
    for k, v in fw.items():
        want = np.array(gfw[k])
        if k == "w2":
            want = T.unpack_grouped_kernel(torch.from_numpy(want),
                                           width // 32).numpy()
        assert v.grad.shape == want.shape, k
        assert rel_err(v.grad, want) < GRAD_RTOL, k


def test_int8_codes_are_refused():
    rng = np.random.RandomState(4)
    tfw, _ = make_weights(rng, 64, 128, 256, True)
    x = torch.zeros(2, 8, 8, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="no gradient"):
        T.fused_bottleneck_diff(x, tfw)
