"""The port's BFP autodiff (``repro_torch.grad``) against ``repro.grad``,
case by case after ``tests/test_grad.py``.

Contracts held here:
  * grad paths, explicit ``#`` rules, the float pin and the fitted
    K-tiles resolve as in ``repro``;
  * every quantized backward GEMM is BIT-EXACT to ``repro``'s given the
    same cotangent (``loss = sum(y * g)`` makes the cotangent ``g``
    itself): dx and dw of a GEMM, dw and the ``conv_dx`` GEMM of a conv,
    on the emulated backend and on the kernel backend (its plain
    versions on the CPU) against ``repro``'s emulated TILED route and,
    for the GEMM, its Pallas matmul in interpret mode;
  * the float backward agrees with plain autograd bit for bit, and the
    default (straight-through) policy with the legacy estimator;
  * gradient NSR stays within the bound at L = 4..12, and a model's
    backward tap records match ``repro``'s in path, kind and order;
  * bind-time backward plans: specs, describe(), strict refusal and the
    warning dedup, and plan-bound gradients equal per-call ones;
  * max-pool ties give the gradient to the window's first maximum and
    ReLU's gradient at 0 is 0, as in ``repro``.

Tolerance, only where the reference is a float BLAS op or a float sum
(the float and straight-through backward, col2im, a whole model's
gradient): 1e-5 relative and 1e-5 of the largest magnitude, as in
``test_torch_grad_guard.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JEG
from repro.core.bfp import Scheme as JScheme
from repro.core.conv_utils import conv_weight_matrix as j_wmat
from repro.core.conv_utils import im2col as j_im2col
from repro.core.policy import BFPPolicy as JPolicy
from repro.engine import PolicyMap as JPolicyMap
from repro.engine import core as JEC
from repro.grad import fit_grad_policy as j_fit
from repro.grad import measure_gradient_nsr as j_measure
from repro.grad import resolve_grad_policy as j_resolve
from repro.grad.vjp import _linearize as j_linearize
from repro.models.cnn import layers as JL
from repro.models.cnn import small as jsmall
from repro_torch import engine as EG
from repro_torch.convert import params_from_numpy
from repro_torch.core import bfp
from repro_torch.core.bfp import Scheme
from repro_torch.core.bfp_dot import bfp_matmul_2d
from repro_torch.core.conv_utils import conv_weight_matrix, im2col
from repro_torch.core.nsr import (gemm_nsr_upper_bound,
                                  grad_dw_nsr_upper_bound,
                                  grad_dx_nsr_upper_bound)
from repro_torch.core.policy import BFPPolicy
from repro_torch.engine import PolicyMap
from repro_torch.engine.backends import BackendUnsupportedError
from repro_torch.engine.policy_map import resolve_policy
from repro_torch.grad import (GRAD_KINDS, fit_grad_policy, grad_path,
                              measure_gradient_nsr, resolve_grad_policy)
from repro_torch.models.cnn import layers as L
from repro_torch.models.cnn import small
from test_torch_util import assert_bits_equal, normal, t, to_numpy_tree

X, W = normal((6, 96), seed=1, scale=1.5), normal((96, 16), seed=2,
                                                   scale=0.1)
GY = normal((6, 16), seed=3)
XC, WC = normal((2, 8, 8, 4), seed=4), normal((3, 3, 4, 8), seed=5,
                                              scale=0.2)
GC = normal((2, 8, 8, 8), seed=6)
XL = normal((2, 28, 28, 1), seed=7)
GL = normal((2, 10), seed=8)


def pols(scheme="eq4", **kw):
    """The same policy in both packages: (repro's, the port's)."""
    return (JPolicy(scheme=JScheme(scheme), **kw),
            BFPPolicy(scheme=Scheme(scheme), **kw))


def maps(*rules, default=None):
    """The same PolicyMap in both packages from (pattern, pols(...) or
    None) rules."""
    pick = lambda p, i: None if p is None else p[i]  # noqa: E731
    return (JPolicyMap.of(*[(r, pick(p, 0)) for r, p in rules],
                          default=pick(default, 0)),
            PolicyMap.of(*[(r, pick(p, 1)) for r, p in rules],
                         default=pick(default, 1)))


EQ4 = pols(straight_through=False)
STE = pols()
L4 = pols(l_w=4, l_i=4)
TILED32 = pols("tiled", block_k=32, straight_through=False)
TILED128 = pols("tiled", block_k=128, straight_through=False)
#: the kernel backend: the port's runs the kernels' plain versions on the
#: CPU; repro's reference is its emulated TILED route (and, for GEMMs,
#: its Pallas matmul in interpret mode)
KERNEL32 = (TILED32[0].with_(backend="pallas"),
            TILED32[1].with_(backend="pallas"))
#: per-layer TILED blocks LeNet's K's divide (c1: 25; c2 400, fc1 1568,
#: fc2 128: 16), so the emulated forward runs on both sides
LENET_BK = dict(straight_through=False)


def lenet_map(L_=8, backend=None):
    c1 = pols("tiled", block_k=25, l_w=L_, l_i=L_, **LENET_BK)
    rest = pols("tiled", block_k=16, l_w=L_, l_i=L_, **LENET_BK)
    if backend:
        c1 = tuple(p.with_(backend=backend) if i else p
                   for i, p in enumerate(c1))
        rest = tuple(p.with_(backend=backend) if i else p
                     for i, p in enumerate(rest))
    return maps(("^c1$", c1), default=rest)


GEMM_CASES = {"float": (None, None), "ste": STE, "eq4": EQ4,
              "rule": maps(("fc#dx", L4), ("fc", EQ4)),
              "pinned": maps(("#dw", None), ("fc", EQ4)),
              "tiled": TILED32, "kernel": KERNEL32}
#: which gradients of a case are quantized backward GEMMs (bit-exact)
EXACT = {"float": (), "ste": (), "eq4": ("dx", "dw"), "rule": ("dx", "dw"),
         "pinned": ("dx",), "tiled": ("dx", "dw"), "kernel": ("dx", "dw")}
CONV = pols("tiled", block_k=12, straight_through=False)


@pytest.fixture(scope="module")
def lenet():
    return to_numpy_tree(jax.jit(jsmall.lenet_init)(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ref(lenet):
    """repro's side in one compiled program: every GEMM case's forward
    and (dx, dw); the conv's forward, (dx, dw) and its conv_dx GEMM; the
    Pallas matmul's backward on the kernel policy; LeNet's parameter
    gradients (float, and TILED at L = 4 for the tie case); the pool +
    ReLU tie unit."""
    def gemm_grads(pol):
        def loss(x, w):
            return jnp.sum(JEG.gemm(x, w, pol, path="fc") * GY)
        return JEG.gemm(X, W, pol, path="fc"), jax.grad(loss, (0, 1))(X, W)

    def conv_parts(pol):
        def loss(x, w):
            return jnp.sum(JEG.conv2d(x, w, pol, stride=1, padding="SAME",
                                      path="c") * GC)
        cols = j_im2col(XC, 3, 3, 1, "SAME")[0]
        _, wq = j_linearize(cols, j_wmat(WC), pol)
        dcols = JEC._gemm_exec(GC.reshape(-1, 8), wq.T,
                               j_fit(pol, 8), None)[0]
        return (JEG.conv2d(XC, WC, pol, stride=1, padding="SAME"),
                jax.grad(loss, (0, 1))(XC, WC), dcols)

    def lenet_grads(params, pol):
        return jax.grad(lambda p: jnp.sum(
            jsmall.lenet_apply(p, XL, pol) * GL))(params)

    def ties(x, g):
        return jax.grad(lambda x: jnp.sum(JL.max_pool(JL.relu(x)) * g))(x)

    def fn(params):
        out = {k: gemm_grads(p[0]) for k, p in GEMM_CASES.items()}
        out["pallas"] = gemm_grads(KERNEL32[0])
        out["conv"] = conv_parts(CONV[0])
        out["conv_float"] = conv_parts(None)
        out["lenet_float"] = lenet_grads(params, None)
        out["lenet_l4"] = lenet_grads(params, lenet_map(4)[0])
        out["ties"] = ties(TIE_X, TIE_G)
        return out

    return to_numpy_tree(jax.jit(fn)(lenet))


def _grads(fn, a, b, gy):
    at, bt = t(a).requires_grad_(), t(b).requires_grad_()
    out = fn(at, bt)
    (out * t(gy)).sum().backward()
    return out, at.grad, bt.grad


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# grad paths and policy resolution
# ---------------------------------------------------------------------------

def test_grad_path_suffixes():
    assert grad_path("c1", "dx") == "c1#dx"
    assert grad_path("blk/fc", "dw") == "blk/fc#dw"
    assert grad_path(None, "dx") is None
    with pytest.raises(ValueError):
        grad_path("c1", "dy")
    assert GRAD_KINDS == ("dx", "dw")


def _same_policy(got, want):
    if want is None:
        assert got is None
    else:
        assert (got.l_w, got.l_i, got.scheme.value, got.block_k,
                got.straight_through) == (want.l_w, want.l_i,
                                          want.scheme.value, want.block_k,
                                          want.straight_through)


@pytest.mark.parametrize("policy", [
    (None, None), STE, EQ4,
    maps(("c1#dx", L4), ("c1", EQ4)),
    maps(("#dw", None), ("c1", EQ4)),
    maps(("c1#dx", L4), ("c2", EQ4), default=STE)],
    ids=["none", "ste", "eq4", "explicit", "pinned", "default"])
@pytest.mark.parametrize("path", ["c1", "c2", None])
def test_resolve_grad_policy_matches_repro(policy, path):
    for which in ("dx", "dw"):
        _same_policy(resolve_grad_policy(policy[1], path, which),
                     j_resolve(policy[0], path, which))


def test_resolve_fallback_semantics():
    assert resolve_grad_policy(None, "c1", "dx") is None
    assert resolve_grad_policy(STE[1], "c1", "dx") is None
    assert resolve_grad_policy(EQ4[1], "c1", "dw") == EQ4[1]
    pm = maps(("c1#dx", L4), ("c1", EQ4))[1]
    assert resolve_grad_policy(pm, "c1", "dx") == L4[1]
    assert resolve_grad_policy(pm, "c1", "dw") == EQ4[1]
    pm2 = maps(("#dw", None), ("c1", EQ4))[1]
    assert resolve_grad_policy(pm2, "c1", "dw") is None
    assert resolve_grad_policy(pm2, "c1", "dx") == EQ4[1]
    # an explicit grad rule never hits forward resolution
    assert resolve_policy(pm, "c1") == EQ4[1]


@pytest.mark.parametrize("k", [256, 96, 80, 100, 7, 392, 1568, 1000, 27,
                               401408])
@pytest.mark.parametrize("policy", [None, EQ4, TILED128,
                                    pols("tiled", block_k=1 << 20, l_w=12,
                                         l_i=12, straight_through=False)],
                         ids=["none", "eq4", "tiled128", "wide"])
def test_fit_grad_policy_matches_repro(policy, k):
    got = fit_grad_policy(None if policy is None else policy[1], k)
    _same_policy(got, j_fit(None if policy is None else policy[0], k))
    if got is not None and got.scheme is Scheme.TILED:
        assert k % got.block_k == 0
        assert got.block_k <= bfp.max_safe_k(got.l_w, got.l_i)


# ---------------------------------------------------------------------------
# backward GEMMs against repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_gemm_grads_match_repro(ref, case):
    """A BFP forward bit-exact; quantized backward GEMMs bit-exact (the
    cotangent is GY itself), float GEMMs within the stated tolerance."""
    pol = GEMM_CASES[case][1]
    out, dx, dw = _grads(lambda x, w: EG.gemm(x, w, pol, path="fc"), X, W,
                         GY)
    want_out, (want_dx, want_dw) = ref[case]
    (_close if pol is None else assert_bits_equal)(out, want_out)
    for name, got, want in (("dx", dx, want_dx), ("dw", dw, want_dw)):
        assert np.abs(want).max() > 0
        if name in EXACT[case]:
            assert_bits_equal(got, want)
        else:
            _close(got, want)


def test_kernel_backward_matches_repro_pallas_matmul(ref):
    """The kernel backend's backward GEMMs (plain versions on the CPU)
    equal repro's Pallas matmul (interpret mode) on the fitted tiles."""
    _, dx, dw = _grads(lambda x, w: EG.gemm(x, w, KERNEL32[1], path="fc"),
                       X, W, GY)
    assert_bits_equal(dx, ref["pallas"][1][0])
    assert_bits_equal(dw, ref["pallas"][1][1])


@pytest.mark.parametrize("backend", [None, "pallas"])
def test_conv_grads_match_repro(ref, backend):
    """dw and the conv_dx GEMM bit-exact; dx (col2im, a float sum of
    kh*kw slabs) within the tolerance.  The kernel backend's forward and
    backward run the kernels' plain versions on the CPU."""
    pol = CONV[1] if backend is None else CONV[1].with_(backend=backend)
    events = []
    with EG.taps(events.append):
        out, dx, dw = _grads(lambda x, w: EG.conv2d(x, w, pol, path="c"),
                             XC, WC, GC)
    want_out, (want_dx, want_dw), want_dcols = ref["conv"]
    assert_bits_equal(out, want_out)
    assert_bits_equal(dw, want_dw)
    _close(dx, want_dx)
    ev = {e.kind: e for e in events}
    assert ev["conv_dx"].path == "c#dx" and ev["conv_dw"].path == "c#dw"
    assert ev["conv_dx"].backend == (backend or "emulated")
    assert_bits_equal(ev["conv_dx"].y, want_dcols)


def test_float_grads_match_autograd(ref):
    """Float policy: the routed gradients are plain autograd's bit for
    bit (GEMM: of x @ w; conv: of the im2col composition), and repro's
    within the tolerance."""
    xt, wt = t(X).requires_grad_(), t(W).requires_grad_()
    (torch.sin(xt @ wt)).sum().backward()
    _, dx, dw = _grads(lambda x, w: torch.sin(EG.gemm(x, w, None)), X, W,
                       np.ones((6, 16), np.float32))
    assert_bits_equal(dx, xt.grad.numpy())
    assert_bits_equal(dw, wt.grad.numpy())

    xc, wc = t(XC).requires_grad_(), t(WC).requires_grad_()
    cols, _ = im2col(xc, 3, 3, 1, "SAME")
    (torch.square(cols @ conv_weight_matrix(wc)).reshape(2, 8, 8, 8)
     * 1.0).sum().backward()
    _, gx, gw = _grads(lambda x, w: torch.square(EG.conv2d(x, w, None)),
                       XC, WC, np.ones((2, 8, 8, 8), np.float32))
    assert_bits_equal(gx, xc.grad.numpy())
    assert_bits_equal(gw, wc.grad.numpy())
    out, dx, dw = _grads(lambda x, w: EG.conv2d(x, w, None, path="c"), XC,
                         WC, GC)
    _close(out, ref["conv_float"][0])
    _close(dx, ref["conv_float"][1][0])
    _close(dw, ref["conv_float"][1][1])


def test_forward_values_unchanged_by_routing():
    xt = t(X).requires_grad_()
    assert_bits_equal(EG.gemm(xt, t(W), EQ4[1]),
                      bfp_matmul_2d(t(X), t(W), EQ4[1]).numpy())


def test_default_policy_matches_legacy_ste():
    """The routed default policy (straight_through=True) equals the
    legacy ``bfp_matmul_2d`` straight-through estimator bit for bit."""
    routed = _grads(lambda x, w: torch.tanh(EG.gemm(x, w, STE[1])), X, W,
                    np.ones((6, 16), np.float32))
    legacy = _grads(lambda x, w: torch.tanh(bfp_matmul_2d(x, w, STE[1])),
                    X, W, np.ones((6, 16), np.float32))
    for a, b in zip(routed, legacy):
        assert_bits_equal(a, b.detach().numpy())


# ---------------------------------------------------------------------------
# backward taps and the gradient NSR bound, L = 4..12
# ---------------------------------------------------------------------------

def test_backward_taps_match_repro():
    """The event list of one GEMM's forward and backward: kind, path and
    order as repro's eager jax.grad emits them."""
    events, jevents = [], []
    with EG.taps(events.append):
        xt = t(X).requires_grad_()
        EG.gemm(xt, t(W), EQ4[1], path="fc").sum().backward()
    with JEG.taps(jevents.append):
        jax.grad(lambda x: jnp.sum(JEG.gemm(x, W, EQ4[0], path="fc")))(X)
    got = [(e.kind, e.path) for e in events]
    assert got == [(e.kind, e.path) for e in jevents]
    assert got == [("gemm", "fc"), ("gemm_dx", "fc#dx"),
                   ("gemm_dw", "fc#dw")]


@pytest.mark.parametrize("L_", [4, 6, 8, 10, 12])
def test_gemm_grad_nsr_within_bound(L_):
    pol = BFPPolicy(l_w=L_, l_i=L_, straight_through=False)
    x, w = t(normal((6, 96), seed=L_, scale=1.5)), t(
        normal((96, 16), seed=L_ + 1, scale=0.1))

    def run():
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        EG.gemm(xr, wr, pol, path="fc").sum().backward()

    recs = measure_gradient_nsr(run)
    assert sorted(r.kind for r in recs) == ["gemm_dw", "gemm_dx"]
    for r in recs:
        assert r.eta_bound < float("inf")
        assert r.within_bound, (r.kind, r.eta_measured, r.eta_bound)


@pytest.mark.parametrize("L_", [4, 8, 12])
def test_conv_grad_nsr_within_bound(L_):
    pol = BFPPolicy(l_w=L_, l_i=L_, straight_through=False)
    x = t(normal((2, 8, 8, 3), seed=L_))
    w = t(normal((3, 3, 3, 8), seed=L_ + 1, scale=0.2))

    def run():
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        EG.conv2d(xr, wr, pol).sum().backward()

    recs = measure_gradient_nsr(run)
    assert sorted(r.kind for r in recs) == ["conv_dw", "conv_dx"]
    for r in recs:
        assert r.within_bound, (r.kind, r.eta_measured, r.eta_bound)


def test_tiled_backward_fits_tile_and_stays_bounded():
    # dL/dw contracts over M = 6, which 128 does not divide: the tap
    # reports the FITTED policy and the bound holds under it
    x = t(normal((6, 256), seed=11))
    w = t(normal((256, 32), seed=12, scale=0.1))
    for pol in (TILED128[1], TILED128[1].with_(backend="pallas")):
        def run():
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            EG.gemm(xr, wr, pol, path="t").sum().backward()

        by_kind = {r.kind: r for r in measure_gradient_nsr(run)}
        assert by_kind["gemm_dw"].policy.block_k == 6
        assert by_kind["gemm_dx"].policy.block_k == 32   # over N
        assert by_kind["gemm_dw"].backend == pol.backend_name
        for r in by_kind.values():
            assert r.within_bound


def test_grad_bound_wrappers_match_forward_geometry():
    x, w, g = t(X), t(W), t(GY)
    assert torch.equal(grad_dx_nsr_upper_bound(g, w, EQ4[1]),
                       gemm_nsr_upper_bound(g, w.T, EQ4[1]))
    assert torch.equal(grad_dw_nsr_upper_bound(x, g, EQ4[1]),
                       gemm_nsr_upper_bound(x.T, g, EQ4[1]))


def test_quantized_backward_differs_from_ste_and_improves_with_l():
    g_ste = _grads(lambda x, w: EG.gemm(x, w, STE[1]), X, W,
                   np.ones((6, 16), np.float32))[1]
    devs = []
    for L_ in (4, 12):
        pol = BFPPolicy(l_w=L_, l_i=L_, straight_through=False)
        g = _grads(lambda x, w: EG.gemm(x, w, pol), X, W,
                   np.ones((6, 16), np.float32))[1]
        devs.append(float(torch.linalg.norm(g - g_ste)))
    assert devs[0] > 0.0
    assert devs[1] < devs[0]


# ---------------------------------------------------------------------------
# bind-time backward plans
# ---------------------------------------------------------------------------

def test_bind_resolves_grad_specs_like_repro(lenet):
    pm = maps(("fc1#dx", L4), ("#dw", None), (".", EQ4))
    plan = EG.bind(params_from_numpy(lenet, "cpu"), pm[1], tree="cnn",
                   prequantize=False, device="cpu")
    sites = plan.sites
    assert sites["fc1"].dx.policy == L4[1]
    assert sites["fc1"].dw.policy is None
    assert sites["c1"].dx.policy == EQ4[1]
    assert sites["c1"].dw.policy is None
    assert sites["c1"].dx.backend.name == "emulated"
    want = JEG.bind(lenet, pm[0], tree="cnn", prequantize=False).describe()
    assert plan.describe() == want
    assert "grad[dx=L4/4@emulated,dw=float]" in want


def test_plan_grads_match_per_call_grads_and_repro(ref, lenet):
    pm = lenet_map(4, backend="pallas")[1]
    params = params_from_numpy(lenet, "cpu")
    plan = EG.bind(params, pm, tree="cnn", prequantize=False, device="cpu")

    def grads(policy):
        p = {k: {n: v.clone().requires_grad_() for n, v in d.items()}
             for k, d in params.items()}
        (small.lenet_apply(p, t(XL), policy) * t(GL)).sum().backward()
        return {k: {n: v.grad for n, v in d.items()} for k, d in p.items()}

    gp, gc = grads(plan), grads(pm)
    for k in gp:
        for n in gp[k]:
            assert torch.equal(gp[k][n], gc[k][n]), (k, n)
            _close(gp[k][n], ref["lenet_l4"][k][n])


def test_strict_bind_raises_for_unsupported_backward_backend(lenet):
    params = params_from_numpy(lenet, "cpu")
    # the kernel backend has no EQ4 slot: a strict bind refuses the #dx
    # rule although every forward site is float
    pm = PolicyMap.of(("fc1#dx", BFPPolicy(backend="pallas")), (".", None))
    with pytest.raises(BackendUnsupportedError, match="fc1#dx"):
        EG.bind(params, pm, tree="cnn", strict=True, prequantize=False,
                device="cpu")


def test_bind_grad_warning_dedup_with_forward(lenet):
    # EQ4 downgrades pallas -> emulated at every site, forward and
    # backward: one warning per forward site, none extra for #dx / #dw
    pm = PolicyMap.of((".", BFPPolicy(backend="pallas",
                                      straight_through=False)))
    with pytest.warns(EG.BackendFallbackWarning) as rec:
        plan = EG.bind(params_from_numpy(lenet, "cpu"), pm, tree="cnn",
                       prequantize=False, device="cpu")
    assert len(rec) == len(plan.sites) == 4
    assert all(s.dx.backend.name == "emulated" for s in plan.sites.values())


# ---------------------------------------------------------------------------
# pooling and ReLU ties
# ---------------------------------------------------------------------------

#: 2x2 windows with exact ties: all-zero windows after ReLU (gradient 0
#: through ReLU at 0), negative windows (ReLU makes them zero), and
#: positive ties in every position pair
TIE_X = np.zeros((1, 4, 6, 2), np.float32)
TIE_X[0, 0:2, 0:2, 0] = [[1.5, 1.5], [0.25, 1.5]]
TIE_X[0, 0:2, 2:4, 0] = [[-1.0, 2.0], [2.0, 2.0]]
TIE_X[0, 2:4, 0:2, 0] = [[-3.0, -1.0], [-2.0, -0.5]]
TIE_X[0, 2:4, 4:6, 1] = [[0.5, 0.25], [0.5, 0.5]]
TIE_X[0, 0:2, 4:6, 1] = [[0.0, 0.0], [0.0, 3.0]]
TIE_G = normal((1, 2, 3, 2), seed=9) + 2.0


def test_pool_and_relu_ties_match_repro(ref):
    xt = t(TIE_X).requires_grad_()
    (L.max_pool(L.relu(xt)) * t(TIE_G)).sum().backward()
    assert_bits_equal(xt.grad, ref["ties"])
    # the first maximum of a tied window takes the whole gradient
    assert xt.grad[0, 0, 0, 0] == TIE_G[0, 0, 0, 0]
    assert xt.grad[0, 0, 1, 0] == 0 and xt.grad[0, 1, 1, 0] == 0


def test_model_grads_with_ties_match_repro(ref, lenet):
    """LeNet at L = 4 on the kernel backend: quantized activations tie
    exactly inside the pool windows, and ReLU outputs zeros; the
    parameter gradients still match repro's."""
    params = params_from_numpy(lenet, "cpu")
    pm = lenet_map(4, backend="pallas")[1]
    seen = []

    def tap(ev):
        if ev.kind == "conv" and ev.path == "c2":
            y = torch.relu(ev.y + params["c2"]["b"])
            win = y.reshape(2, 7, 2, 7, 2, 32).permute(0, 1, 3, 5, 2, 4)
            win = win.reshape(-1, 4)
            top = win.max(-1).values
            seen.append(int(((win == top[:, None]).sum(-1) > 1).sum()))

    p = {k: {n: v.clone().requires_grad_() for n, v in d.items()}
         for k, d in params.items()}
    with EG.taps(tap):
        (small.lenet_apply(p, t(XL), pm) * t(GL)).sum().backward()
    assert seen and seen[0] > 50, seen     # windows with tied maxima
    for k, d in p.items():
        for n, v in d.items():
            _close(v.grad, ref["lenet_l4"][k][n])


def test_float_model_grads_match_repro(ref, lenet):
    params = params_from_numpy(lenet, "cpu")
    p = {k: {n: v.clone().requires_grad_() for n, v in d.items()}
         for k, d in params.items()}
    (small.lenet_apply(p, t(XL), None) * t(GL)).sum().backward()
    for k, d in p.items():
        for n, v in d.items():
            _close(v.grad, ref["lenet_float"][k][n])


def _tiny_apply(layers):
    """A two-site net in either package's layers: conv c1 (5x5, 8
    channels) + ReLU + 2x2 max pool, then dense fc."""
    def apply(params, x, policy):
        y = layers.relu(layers.conv2d(params["c1"], x, 1, "SAME", policy,
                                      path="c1"))
        y = layers.max_pool(y)
        return layers.dense(params["fc"], y.reshape(y.shape[0], -1),
                            policy, path="fc")
    return apply


def test_model_grad_nsr_records_match_repro():
    """measure_gradient_nsr over a two-site net's backward: the records'
    path, kind, fitted block and order are repro's (its eager jax.grad;
    the first conv's #dx included), each within its bound, the bounds
    equal to 1e-4 and the measured NSR to 1e-3 relative (float sums on
    both sides)."""
    x = XL[:1, :8, :8]
    params = {"c1": {"w": normal((5, 5, 1, 8), seed=13, scale=0.3),
                     "b": np.zeros(8, np.float32)},
              "fc": {"w": normal((128, 10), seed=14, scale=0.1),
                     "b": np.zeros(10, np.float32)}}
    pm = maps(("^c1$", pols("tiled", block_k=25, l_w=6, l_i=6,
                            straight_through=False)),
              default=pols("tiled", block_k=32, l_w=6, l_i=6,
                           straight_through=False))
    tparams = params_from_numpy(params, "cpu")

    def run():
        p = {k: {n: v.clone().requires_grad_() for n, v in d.items()}
             for k, d in tparams.items()}
        _tiny_apply(L)(p, t(x), pm[1]).sum().backward()

    recs = measure_gradient_nsr(run)
    jrecs = j_measure(lambda: jax.grad(lambda p: jnp.sum(
        _tiny_apply(JL)(p, x, pm[0])))(params))
    got = [(r.path, r.kind, r.policy.block_k) for r in recs]
    assert got == [(r.path, r.kind, r.policy.block_k) for r in jrecs]
    assert got == [("fc#dx", "gemm_dx", 10), ("fc#dw", "gemm_dw", 1),
                   ("c1#dx", "conv_dx", 8), ("c1#dw", "conv_dw", 16)]
    for r, j in zip(recs, jrecs):
        assert r.within_bound, (r.path, r.eta_measured, r.eta_bound)
        np.testing.assert_allclose(r.eta_bound, j.eta_bound, rtol=1e-4)
        np.testing.assert_allclose(r.eta_measured, j.eta_measured,
                                   rtol=1e-3)


def test_ragged_block_linearizes_at_the_kernels_blocks():
    """A TILED block that does not divide K (VGG16 conv1_1: K = 27 at
    block 128; here 27 at 8), where repro's linearization raises: the
    port linearizes at the kernels' own blocks, the last one zero-padded,
    so the dequantized operands are those the forward kernel formats,
    and the conv's backward GEMMs run on the kernel backend."""
    from repro_torch.grad.vjp import _linearize
    from repro_torch.kernels import bfp_matmul as KM
    pol = BFPPolicy(scheme=Scheme.TILED, block_k=8, straight_through=False,
                    backend="pallas")
    x2d, w = t(normal((10, 27), seed=15)), t(normal((27, 6), seed=16))
    xq, wq = _linearize(x2d, w, pol)
    # equal values (the kernels' float mantissas keep the sign of a zero,
    # the integer ones do not)
    mw, sw = KM._weights_inline(w, 8, 8)
    np.testing.assert_array_equal(wq.numpy(),
                                  (mw * sw).reshape(32, 6)[:27].numpy())
    xt = torch.nn.functional.pad(x2d, (0, 5)).reshape(10, 4, 8)
    mx, sx = KM.block_format(xt, 8, dim=2)
    np.testing.assert_array_equal(xq.numpy(),
                                  (mx * sx).reshape(10, 32)[:, :27].numpy())
    with pytest.raises(ValueError, match="must divide"):
        j_linearize(jnp.asarray(x2d.numpy()), jnp.asarray(w.numpy()),
                    JPolicy(scheme=JScheme.TILED, block_k=8,
                            straight_through=False))
    events = []
    xc = t(normal((2, 6, 6, 3), seed=17)).requires_grad_()
    wc = t(normal((3, 3, 3, 8), seed=18, scale=0.2)).requires_grad_()
    with EG.taps(events.append):
        (EG.conv2d(xc, wc, pol, path="c1") * 1.5).sum().backward()
    back = [e for e in events if e.kind.startswith("conv_")]
    assert [e.kind for e in back] == ["conv_dx", "conv_dw"]
    for e in back:
        assert_bits_equal(e.y, KM.bfp_matmul_plain(
            e.x, e.w, 8, 8, e.policy.block_k).numpy())
    assert torch.isfinite(xc.grad).all() and torch.isfinite(wc.grad).all()


# F5: backward GEMMs whose contraction has length 1 — a GEMM's #dx when
# N = 1, its #dw when the batch is 1.  Zero mantissas meet negative ones,
# so a float64 dot would give -0.0; repro's emulated int32 dot gives +0.0.
# The kernel backend is held against repro's emulated route here, not its
# Pallas matmul.
def _len1_operands():
    xn = normal((4, 32), seed=61)
    wn = -np.abs(normal((32, 1), seed=62, scale=0.1))
    wn[::3] = 0.0
    gn = normal((4, 1), seed=63)
    gn[1] = 0.0
    xb = normal((1, 32), seed=64)
    xb[0, ::2] = 0.0
    wb = normal((32, 8), seed=65, scale=0.1)
    gb = -np.abs(normal((1, 8), seed=66))
    return {"n1": (xn, wn, gn), "b1": (xb, wb, gb)}


LEN1_POLS = {"eq4": EQ4, "tiled": TILED32,
             "kernel": (TILED32[0], KERNEL32[1])}


@pytest.fixture(scope="module")
def len1_ref():
    ops = _len1_operands()

    def fn():
        out = {}
        for pk, pol in LEN1_POLS.items():
            for sk, (x, w, g) in ops.items():
                out[pk, sk] = jax.grad(lambda x, w: jnp.sum(
                    JEG.gemm(x, w, pol[0], path="fc") * g), (0, 1))(x, w)
        return out

    return to_numpy_tree(jax.jit(fn)())


@pytest.mark.parametrize("shape", ["n1", "b1"])
@pytest.mark.parametrize("pk", list(LEN1_POLS))
def test_backward_of_contraction_one_gives_positive_zeros(len1_ref, pk,
                                                          shape):
    x, w, g = _len1_operands()[shape]
    _, dx, dw = _grads(lambda a, b: EG.gemm(a, b, LEN1_POLS[pk][1],
                                            path="fc"), x, w, g)
    want_dx, want_dw = len1_ref[pk, shape]
    want = want_dx if shape == "n1" else want_dw
    assert (want == 0).any() and not np.signbit(want[want == 0]).any()
    assert_bits_equal(dx, want_dx)
    assert_bits_equal(dw, want_dw)
