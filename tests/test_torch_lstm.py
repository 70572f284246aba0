"""The port's LSTM recurrence (K9's plain version and its autograd wrapper)
and the LSTM half of its shared layers against the JAX package.

The same numpy-seeded inputs go through both packages on the CPU in f32:
``scan_reference`` and ``lstm_fused`` (which runs the plain version on a
CPU tensor) against JAX's ``_scan_reference`` and the Pallas ``lstm_fused``
in interpret mode, outputs and gradients at atol 1e-5 (f32, other
summation orders); ``lstm_scan``, ``reverse_padded`` and ``lstm_step``
with the weights transposed into the JAX layout; and the ``fused_lstm``
rule that replaces ``MMB_FUSED_LSTM``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_baby_tpu.models import layers as jlayers
from multimodal_baby_tpu.ops import lstm as jlstm
from multimodal_baby_tpu_torch.models import layers
from multimodal_baby_tpu_torch.ops.lstm import (
    MAX_HIDDEN, kernel_takes, lstm_fused, scan_reference)

ATOL = 1e-5


def recurrence_inputs(L, B, H, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, L + 1, B)
    lens[0] = L  # one full row, one that ends at its first step
    lens[1] = 1
    return {"xp": rng.randn(L, B, 4 * H).astype(np.float32),
            "mask": (np.arange(L)[:, None] < lens[None, :]).astype(np.float32),
            "whh": (rng.randn(H, 4 * H) * 0.1).astype(np.float32),
            "h0": (rng.randn(B, H) * 0.1).astype(np.float32),
            "c0": (rng.randn(B, H) * 0.1).astype(np.float32)}


def cotangents(L, B, H, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(L, B, H).astype(np.float32),
            rng.randn(B, H).astype(np.float32),
            rng.randn(B, H).astype(np.float32))


@pytest.mark.parametrize("impl", ["scan_reference", "lstm_fused"])
@pytest.mark.parametrize("L,B,H", [(9, 8, 16), (64, 8, 16)])
def test_recurrence_matches_jax(impl, L, B, H):
    """Outputs and the VJP (x_proj, w_hh, h0, c0; none for the mask) of
    the port's recurrence against the JAX scan and the Pallas kernel."""
    a = recurrence_inputs(L, B, H)
    cts = cotangents(L, B, H)
    j_impl = jlstm._scan_reference if impl == "scan_reference" \
        else jlstm.lstm_fused
    mask = jnp.asarray(a["mask"])
    want, vjp = jax.vjp(lambda xp, w, h, c: j_impl(xp, mask, w, h, c),
                        *(jnp.asarray(a[k]) for k in ("xp", "whh", "h0",
                                                      "c0")))
    want_grads = vjp(tuple(jnp.asarray(c) for c in cts))

    fn = scan_reference if impl == "scan_reference" else lstm_fused
    t = {k: torch.from_numpy(v).requires_grad_(k != "mask")
         for k, v in a.items()}
    got = fn(t["xp"], t["mask"], t["whh"], t["h0"], t["c0"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cts])
    for k, w in zip(("xp", "whh", "h0", "c0"), want_grads):
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0, err_msg=k)
    assert t["mask"].grad is None


def test_lstm_fused_runs_the_plain_version_on_the_cpu():
    """No launch on a CPU tensor, and the same values as scan_reference."""
    a = {k: torch.from_numpy(v)
         for k, v in recurrence_inputs(5, 3, 16).items()}
    before = lstm_fused.launches
    got = lstm_fused(a["xp"], a["mask"], a["whh"], a["h0"], a["c0"])
    want = scan_reference(a["xp"], a["mask"], a["whh"], a["h0"], a["c0"])
    assert lstm_fused.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def layer_inputs(B=6, L=9, E=16, H=16, seed=3):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, L + 1, B)
    return {"w_ih": (rng.randn(E, 4 * H) * 0.2).astype(np.float32),
            "w_hh": (rng.randn(H, 4 * H) * 0.2).astype(np.float32),
            "b_ih": (rng.randn(4 * H) * 0.1).astype(np.float32),
            "b_hh": (rng.randn(4 * H) * 0.1).astype(np.float32),
            "x": rng.randn(B, L, E).astype(np.float32),
            "mask": np.arange(L)[None, :] < lens[:, None],
            "lens": lens.astype(np.int32),
            "h0": (rng.randn(B, H) * 0.1).astype(np.float32),
            "c0": (rng.randn(B, H) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("fused_lstm", [None, True, False])
def test_lstm_scan_matches_jax(fused_lstm):
    """The port's weights are torch-layout [4H, in]; the JAX package's are
    their transposes. Outputs and weight gradients at atol 1e-5, whichever
    recurrence the rule picks (on the CPU both are the plain scan)."""
    a = layer_inputs()
    ws = ("w_ih", "w_hh", "b_ih", "b_hh")
    rng = np.random.RandomState(4)
    ct = rng.randn(*a["x"].shape[:2], a["h0"].shape[1]).astype(np.float32)

    def j_loss(w_ih, w_hh, b_ih, b_hh):
        out, h, c = jlayers.lstm_scan(
            w_ih, w_hh, b_ih, b_hh, jnp.asarray(a["x"]),
            jnp.asarray(a["mask"]), jnp.asarray(a["h0"]),
            jnp.asarray(a["c0"]))
        return (out * ct).sum() + (h * c).sum(), (out, h, c)

    (_, want), want_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *(jnp.asarray(a[k]) for k in ws))
    t = {k: torch.from_numpy(np.ascontiguousarray(a[k].T)).requires_grad_()
         for k in ws}
    out, h, c = layers.lstm_scan(
        t["w_ih"], t["w_hh"], t["b_ih"], t["b_hh"], torch.from_numpy(a["x"]),
        torch.from_numpy(a["mask"]), torch.from_numpy(a["h0"]),
        torch.from_numpy(a["c0"]), fused_lstm)
    ((out * torch.from_numpy(ct)).sum() + (h * c).sum()).backward()
    for g, w in zip((out, h, c), want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0)
    for k, w in zip(ws, want_g):
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(w).T,
                                   atol=ATOL, rtol=0, err_msg=k)


def test_reverse_padded_matches_jax():
    a = layer_inputs()
    want = jlayers.reverse_padded(jnp.asarray(a["x"]), jnp.asarray(a["lens"]))
    got = layers.reverse_padded(torch.from_numpy(a["x"]),
                                torch.from_numpy(a["lens"]).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # [B, L] too, and reversing twice is the identity on the valid steps
    ids = torch.arange(6 * 9).reshape(6, 9)
    lens = torch.from_numpy(a["lens"]).long()
    twice = layers.reverse_padded(layers.reverse_padded(ids, lens), lens)
    valid = torch.from_numpy(a["mask"])
    assert torch.equal(twice[valid], ids[valid])


def test_lstm_step_matches_jax():
    a = layer_inputs()
    x_t = a["x"][:, 0]
    want = jlayers.lstm_step(*(jnp.asarray(a[k]) for k in (
        "w_ih", "w_hh", "b_ih", "b_hh")), jnp.asarray(x_t),
        jnp.asarray(a["h0"]), jnp.asarray(a["c0"]))
    got = layers.lstm_step(
        *(torch.from_numpy(np.ascontiguousarray(a[k].T)) for k in (
            "w_ih", "w_hh", "b_ih", "b_hh")), torch.from_numpy(x_t),
        torch.from_numpy(a["h0"]), torch.from_numpy(a["c0"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_locked_dropout_shares_one_mask_over_time():
    x = torch.ones(4, 7, 32)
    y = layers.locked_dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert torch.equal(y, y[:, :1].expand_as(y))
    assert layers.locked_dropout(x, 0.5, None) is x
    assert layers.locked_dropout(x, 0.0, torch.Generator()) is x


def test_fused_lstm_rule():
    """None: the JAX length rule (K9 from 64 steps) within the kernel's
    limits; True: K9 at every length, raising where the kernel cannot go;
    False: never; anything else is refused."""
    rule = layers.use_fused_lstm
    assert layers.FUSED_LSTM_MIN_LEN == jlayers.FUSED_LSTM_MIN_LEN == 64
    assert not rule(None, 128, 25, 512)
    assert rule(None, 128, 64, 512)
    assert not rule(None, 128, 64, 520)          # H % 16
    assert not rule(None, 128, 64, MAX_HIDDEN + 16)
    assert rule(True, 128, 25, 512) and rule(True, 3, 1, 16)
    assert not rule(False, 128, 64, 512)
    with pytest.raises(ValueError, match="cannot take"):
        rule(True, 128, 25, 520)
    for bad in ("1", 1, 0, "yes"):
        with pytest.raises(ValueError, match="fused_lstm"):
            rule(bad, 128, 64, 512)
    assert kernel_takes(1, 16) and not kernel_takes(0, 16)


@pytest.mark.parametrize("fused_lstm,L,called", [
    (None, 25, False), (None, 64, True), (True, 25, True), (False, 64, False)])
def test_lstm_scan_dispatches_by_the_rule(monkeypatch, fused_lstm, L, called):
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return scan_reference(*args)

    monkeypatch.setattr(layers, "lstm_fused", spy)
    a = layer_inputs(B=2, L=L, E=16, H=16)
    w = [torch.from_numpy(np.ascontiguousarray(a[k].T)) for k in (
        "w_ih", "w_hh", "b_ih", "b_hh")]
    layers.lstm_scan(*w, torch.from_numpy(a["x"]),
                     torch.from_numpy(a["mask"]), torch.from_numpy(a["h0"]),
                     torch.from_numpy(a["c0"]), fused_lstm)
    assert calls == ([(L, 2, 64)] if called else [])
