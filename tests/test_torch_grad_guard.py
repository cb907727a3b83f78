"""Gradients through the kernel backend match ``repro``'s, the calls off
the autograd route still refuse operands that require grad (no silent
zero gradients), and the emulated route's straight-through gradients
still match ``jax.grad`` of ``repro``'s engine.

On the kernel backend ("cuda", alias "pallas") a dense float operand
that requires grad takes ``repro_torch.grad``'s autograd route, where
``repro`` takes ``repro.grad``'s custom VJP: the same forward, and the
backward GEMMs on the engine.  A call the route refuses (``noise=``,
``out_policy=``, a wire-format x) has no backward there, since the plain
version's round has zero derivative and a CUDA launch writes fresh
outputs, so it raises ``BackendUnsupportedError``.

Tolerance: the backward products are float GEMMs (XLA's and PyTorch's
summation orders differ): 1e-5 relative and 1e-5 of the largest
magnitude absolute.  The forward is bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JEG
from repro.core.policy import PALLAS_TILED as J_PALLAS_TILED
from repro.core.policy import TPU_TILED as J_TPU_TILED
from repro_torch import engine as EG
from repro_torch.core.policy import PALLAS_TILED, TPU_TILED
from repro_torch.core.prequant import prequant_act
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

BK = 32
X, W = normal((8, 256), seed=1), normal((256, 128), seed=2, scale=0.1)
XC, WC = normal((2, 7, 6, 32), seed=3), normal((3, 3, 32, 16), seed=4,
                                                  scale=0.1)
GY = normal((8, 128), seed=5)                    # cotangents
GC = normal((2, 7, 6, 16), seed=6)


@pytest.fixture(scope="module")
def refs():
    """repro's forward and jax.grad on the kernel policy (GEMM: the
    Pallas matmul in interpret mode) and on the emulated TILED policy
    (GEMM and conv), in one compiled program."""
    kpol = J_PALLAS_TILED.with_(block_k=BK)
    epol = J_TPU_TILED.with_(block_k=BK)

    def gemm_loss(pol):
        return lambda x, w: jnp.sum(JEG.gemm(x, w, pol) * GY)

    def conv_loss(x, w):
        return jnp.sum(JEG.conv2d(x, w, epol, stride=1, padding="SAME")
                       * GC)

    def ref_fn(x, w, xc, wc):
        return (jax.grad(gemm_loss(kpol), (0, 1))(x, w),
                JEG.gemm(x, w, epol),
                jax.grad(gemm_loss(epol), (0, 1))(x, w),
                JEG.conv2d(xc, wc, epol, stride=1, padding="SAME"),
                jax.grad(conv_loss, (0, 1))(xc, wc))

    return to_numpy_tree(jax.jit(ref_fn)(X, W, XC, WC))


def _grads(fn, a, b, gy):
    at, bt = t(a).requires_grad_(), t(b).requires_grad_()
    out = fn(at, bt)
    (out * t(gy)).sum().backward()
    return out, at.grad, bt.grad


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _kernel_calls():
    """(label, call) pairs reaching the kernel backend; each call takes
    (x, w) tensors.  The bound plan runs on the CPU with float weights."""
    kp = PALLAS_TILED.with_(block_k=BK)

    def plan_gemm(x, w):
        plan = EG.bind({"fc": {"w": w}}, kp, tree="cnn", prequantize=False,
                       device="cpu")
        return plan.gemm(x, plan.params["fc"]["w"], path="fc")

    def plan_conv(x, w):
        plan = EG.bind({"conv1": {"w": w}}, kp, tree="cnn",
                       prequantize=False, device="cpu")
        return plan.conv2d(x, plan.params["conv1"]["w"], path="conv1")

    return [("gemm", (X, W), lambda x, w: EG.gemm(x, w, kp)),
            ("conv2d", (XC, WC), lambda x, w: EG.conv2d(x, w, kp)),
            ("plan-gemm", (X, W), plan_gemm),
            ("plan-conv2d", (XC, WC), plan_conv)]


@pytest.mark.parametrize("which", ["x", "w"])
@pytest.mark.parametrize("i", range(4), ids=[c[0] for c in _kernel_calls()])
def test_kernel_backend_grads_match_reference(refs, i, which):
    """An operand that requires grad gets ``repro``'s gradient (the
    policy is straight-through, so the backward GEMMs are float: the
    stated tolerance): the GEMMs against its Pallas matmul's
    ``jax.grad``, the convs against its emulated TILED conv (R1)."""
    _, (a, b), call = _kernel_calls()[i]
    at, bt = t(a), t(b)
    leaf = at if which == "x" else bt
    leaf.requires_grad_()
    gy = GY if a is X else GC
    (call(at, bt) * t(gy)).sum().backward()
    dx_ref, dw_ref = refs[0] if a is X else refs[4]
    want = dx_ref if which == "x" else dw_ref
    assert np.abs(want).max() > 1.0
    _close(leaf.grad, want)
    other = bt if which == "x" else at
    assert other.grad is None


def _off_route_calls():
    """(label, call) pairs the autograd route refuses on the kernel
    backend; each takes (x, w) with one of them requiring grad."""
    kp = PALLAS_TILED.with_(block_k=BK)
    return [("gemm-out_policy", (X, W),
             lambda x, w: EG.gemm(x, w, kp, out_policy=kp)),
            ("gemm-noise", (X, W),
             lambda x, w: EG.gemm(x, w, kp, noise=torch.rand(x.shape))),
            ("conv2d-out_policy", (XC, WC),
             lambda x, w: EG.conv2d(x, w, kp,
                                    out_policy=kp.with_(block_k=8))),
            ("conv2d-noise", (XC, WC),
             lambda x, w: EG.conv2d(x, w, kp, noise=torch.rand(
                 2 * 7 * 6, 3 * 3 * 32))),
            ("gemm-wire-x", (X, W),
             lambda x, w: EG.gemm(prequant_act(x.detach(), kp), w, kp))]


#: (call, operand that requires grad): a wire-format x holds integer
#: mantissas, so only its weight can require grad
OFF_ROUTE = [(i, which) for i in range(4) for which in ("x", "w")] + [
    (4, "w")]


@pytest.mark.parametrize("i,which", OFF_ROUTE, ids=[
    f"{_off_route_calls()[i][0]}-{which}" for i, which in OFF_ROUTE])
def test_kernel_backend_refuses_grad_off_the_autograd_route(i, which):
    _, (a, b), call = _off_route_calls()[i]
    at, bt = t(a), t(b)
    (at if which == "x" else bt).requires_grad_()
    with pytest.raises(EG.BackendUnsupportedError, match="no backward"):
        call(at, bt)
    with torch.no_grad():      # served as before
        assert call(at, bt) is not None


@pytest.mark.parametrize("i", range(4), ids=[c[0] for c in _kernel_calls()])
def test_kernel_backend_still_serves_without_grad(i):
    """Serving is unaffected: no grad mode, or no operand requiring it,
    runs the kernel's plain version on the CPU, bit-equal to the
    emulated TILED route."""
    _, (a, b), call = _kernel_calls()[i]
    with torch.no_grad():
        got = call(t(a).requires_grad_(), t(b).requires_grad_())
    want = (EG.gemm(t(a), t(b), TPU_TILED.with_(block_k=BK)) if a is X
            else EG.conv2d(t(a), t(b), TPU_TILED.with_(block_k=BK)))
    assert_bits_equal(got, want.numpy())
    assert_bits_equal(call(t(a), t(b)), want.numpy())


def test_reference_gradient_on_the_kernel_policy_is_nonzero(refs):
    """What the port would have returned as zeros: ``repro`` gives x and
    w a real gradient on the kernel policy."""
    dx, dw = refs[0]
    assert np.abs(dx).max() > 1.0 and np.abs(dw).max() > 1.0
    assert np.isfinite(dx).all() and np.isfinite(dw).all()


def test_emulated_gemm_grads_match_jax_grad(refs):
    _, out_ref, (dx_ref, dw_ref) = refs[:3]
    out, dx, dw = _grads(lambda x, w: EG.gemm(x, w, TPU_TILED.with_(
        block_k=BK)), X, W, GY)
    assert_bits_equal(out, out_ref)
    assert np.abs(dx_ref).max() > 0 and np.abs(dw_ref).max() > 0
    _close(dx, dx_ref)
    _close(dw, dw_ref)


def test_emulated_conv_grads_match_jax_grad(refs):
    out_ref, (dx_ref, dw_ref) = refs[3:]
    out, dx, dw = _grads(lambda x, w: EG.conv2d(x, w, TPU_TILED.with_(
        block_k=BK)), XC, WC, GC)
    assert_bits_equal(out, out_ref)
    assert np.abs(dx_ref).max() > 0 and np.abs(dw_ref).max() > 0
    _close(dx, dx_ref)
    _close(dw, dw_ref)
