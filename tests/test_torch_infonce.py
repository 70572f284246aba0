"""The port's fused InfoNCE (K4's plain versions and its autograd
wrapper) against the JAX package's ``fused_infonce_with_metrics``, whose
Pallas forward and backward kernels run in interpret mode on the CPU.

The same numpy-seeded features go through both in f32: unit-norm rows at
T = 0.07, as the CVCL heads give them, and the raw aligned pairs of
tests/test_ops.py:149. The loss agrees to rtol 1e-5 (on the aligned
pairs, whose loss of 0.09 is the difference of logits near 36, to atol
1e-5: one f32 ulp of a logit is 4e-6 of it) and the LSEs to atol 1e-5
plus rtol 1e-6 (other summation orders; f32 keeps 7 digits); the
gradients to atol 1e-4, rtol 1e-3 (the JAX kernel's own envelope,
tests/test_ops.py:26-35); the metrics, which follow the kernel's
definitions (ties count toward accuracy; entropy sum p (lse - logit)), to
rtol 1e-4. ``infonce_loss`` keeps the JAX shape rule: the kernel for
B <= 1024 with B % 8 == 0, the plain formula otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.ops import infonce as jinfonce
from multimodal_baby_tpu_torch.models.losses import (
    contrastive_loss_from_logits)
from multimodal_baby_tpu_torch.ops import infonce

NLT = float(np.log(1 / 0.07))


def features(B, E, seed, aligned=False):
    rng = np.random.RandomState(seed)
    if aligned:  # pairs that match: the case of tests/test_ops.py:149
        base = rng.randn(B, E).astype(np.float32)
        return base + 0.05 * rng.randn(B, E).astype(np.float32), base, 1.5
    img, txt = (x / np.linalg.norm(x, axis=1, keepdims=True)
                for x in rng.randn(2, B, E).astype(np.float32))
    return img, txt, NLT


CASES = [(16, 32, False), (64, 128, False), (16, 8, True)]


@pytest.mark.parametrize("B,E,aligned", CASES)
def test_forward_matches_the_jax_kernel(B, E, aligned):
    img, txt, nlt = features(B, E, B + E, aligned)
    j_loss, (j_lse_i, j_lse_t, j_m) = jinfonce._fused_forward(
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(nlt, jnp.float32))
    args = (torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(nlt))
    loss, lse_i, lse_t, metrics = infonce.infonce_reference(*args)
    tol = dict(atol=1e-5, rtol=0) if aligned else dict(rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(j_loss), **tol)
    np.testing.assert_allclose(lse_i.numpy(), np.asarray(j_lse_i)[:, 0],
                               atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(j_lse_t)[:, 0],
                               atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(metrics.numpy(), np.asarray(j_m)[0],
                               rtol=1e-4, atol=1e-6)
    if aligned:
        assert float(metrics[0]) > 0.8  # a case with real accuracies

    # the wrapper: the same numbers, as the JAX dict
    f_loss, f_m = infonce.fused_infonce_with_metrics(*args)
    jw_loss, jw_m = jinfonce.fused_infonce_with_metrics(
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(nlt, jnp.float32))
    np.testing.assert_allclose(float(f_loss), float(jw_loss), **tol)
    assert sorted(f_m) == sorted(jw_m)
    for k in f_m:
        np.testing.assert_allclose(float(f_m[k]), float(jw_m[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("B,E,aligned", CASES)
def test_gradients_match_the_jax_kernel(B, E, aligned):
    img, txt, nlt = features(B, E, B + E + 1, aligned)
    g = 0.7  # a cotangent other than 1
    want = jax.grad(lambda i, t, n: g * jinfonce.fused_infonce(i, t, n),
                    argnums=(0, 1, 2))(
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(nlt, jnp.float32))
    args = [torch.from_numpy(img).requires_grad_(),
            torch.from_numpy(txt).requires_grad_(),
            torch.tensor(nlt, requires_grad=True)]
    (g * infonce.fused_infonce(*args)).backward()
    for name, a, w in zip(("d_img", "d_txt", "d_neg_log_temp"), args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-3, err_msg=name)

    # the backward's plain version against autograd through the forward's
    t_args = [torch.from_numpy(img).requires_grad_(),
              torch.from_numpy(txt).requires_grad_(),
              torch.tensor(nlt, requires_grad=True)]
    loss, lse_i, lse_t, _ = infonce.infonce_reference(*t_args)
    (g * loss).backward()
    closed = infonce.infonce_backward_reference(
        *(t.detach() for t in t_args), lse_i.detach(), lse_t.detach(),
        torch.tensor(g))
    for name, a, c in zip(("d_img", "d_txt", "d_neg_log_temp"), t_args,
                          closed):
        np.testing.assert_allclose(c.numpy(), a.grad.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_metrics_count_ties_and_carry_no_gradient():
    """Two equal columns: each row's max is tied, and the kernel's
    accuracy counts the diagonal (argmax would pick one of the two)."""
    img = torch.eye(8)
    txt = torch.eye(8)
    txt[1] = txt[0]  # row 0 ties between columns 0 and 1
    loss, m = infonce.fused_infonce_with_metrics(img, txt, torch.tensor(0.0))
    assert float(m["image_accuracy"]) == 1.0
    assert not any(v.requires_grad for v in m.values())
    logits = img @ txt.T
    _, ref = contrastive_loss_from_logits(logits, logits.T)
    assert float(ref["image_accuracy"]) < 1.0  # argmax breaks the tie


def test_bf16_inputs_get_bf16_gradients():
    img, txt, nlt = features(16, 32, 2)
    a = torch.from_numpy(img).bfloat16().requires_grad_()
    b = torch.from_numpy(txt).bfloat16().requires_grad_()
    infonce.fused_infonce(a, b, torch.tensor(nlt)).backward()
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("B,fused", [(12, False), (16, True), (1032, False)])
def test_infonce_loss_shape_rule(monkeypatch, B, fused):
    """The kernel at B % 8 == 0 up to MAX_FUSED_BATCH, else the plain
    formula; both equal the JAX package's infonce_loss."""
    calls = []
    real = infonce.fused_infonce

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(infonce, "fused_infonce", spy)
    assert infonce.MAX_FUSED_BATCH == jinfonce.MAX_FUSED_BATCH == 1024
    img, txt, nlt = features(B, 8, B)
    want = jinfonce.infonce_loss(jnp.asarray(img), jnp.asarray(txt),
                                 jnp.asarray(nlt, jnp.float32))
    got = infonce.infonce_loss(torch.from_numpy(img), torch.from_numpy(txt),
                               torch.tensor(nlt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert calls == ([(B, 8)] if fused else [])


def test_no_launch_on_the_cpu():
    img, txt, nlt = features(16, 32, 3)
    before = (infonce.fused_infonce_with_metrics.launches,
              infonce.fused_infonce_with_metrics.launches_bwd)
    a = torch.from_numpy(img).requires_grad_()
    infonce.fused_infonce(a, torch.from_numpy(txt), torch.tensor(nlt)
                          ).backward()
    assert (infonce.fused_infonce_with_metrics.launches,
            infonce.fused_infonce_with_metrics.launches_bwd) == before
