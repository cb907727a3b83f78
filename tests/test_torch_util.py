"""Shared helpers and cases for the PyTorch-port tests (no tests here).

Inputs are made with numpy from fixed seeds and handed to both packages;
JAX stays on the CPU and data crosses as numpy arrays.  Nothing here
imports JAX at module level, so the card-only tests can use it on a
machine without JAX.
"""
from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(2)     # the suite runs several workers at once


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def normal(shape, seed: int = 0, scale: float = 1.0) -> np.ndarray:
    return (rng(seed).standard_normal(shape) * scale).astype(np.float32)


def to_numpy_tree(tree):
    """A JAX pytree with numpy leaves (prequant dicts stay dicts); Python
    scalars (a model's ``meta`` ints, GoogLeNet's ``fc1_in``) stay as they
    are."""
    import jax     # here, so the card-only tests import this file without JAX
    return jax.tree_util.tree_map(
        lambda a: a if isinstance(a, (int, float)) else np.asarray(a), tree)


def t(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor (copied, so later numpy edits cannot leak)."""
    return torch.from_numpy(np.array(a, copy=True))


def assert_bits_equal(port, ref) -> None:
    """Bit-equality of two float or int arrays (NaN payloads and -0.0
    included), with the worst difference in the message."""
    p = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    assert p.dtype == r.dtype, (p.dtype, r.dtype)
    if p.dtype.kind == "f":
        same = p.view(f"i{p.itemsize}") == r.view(f"i{r.itemsize}")
    else:
        same = p == r
    if not same.all():
        diff = np.abs(p.astype(np.float64) - r.astype(np.float64))
        raise AssertionError(f"{(~same).sum()} of {same.size} elements "
                             f"differ; max |diff| {np.nanmax(diff)}")


# Kernel cases shared by the CPU parity tests and the card tests.
# (B, K, N, bk, L): K not a multiple of bk, odd and tiny blocks, L 4/8/12
MM_CASES = [(5, 200, 17, 128, 8), (4, 64, 9, 8, 8), (3, 96, 70, 32, 12),
            (8, 300, 33, 27, 4)]
# (stride, kernel, padding, bk, L, C)
CONV_CASES = [(1, 3, "SAME", 8, 8, 3), (2, 7, "SAME", 16, 8, 4),
              (1, 1, "VALID", 8, 4, 8), (2, 3, "VALID", 128, 12, 5),
              (1, 3, "SAME", 16, 8, 16), (2, 3, "SAME", 48, 8, 16)]


def mm_inputs(case):
    b, k, n, bk, _ = case
    x = normal((b, k), seed=b * k)
    x[0] = 0.0                                    # all-zero x blocks
    w = normal((k, n), seed=n, scale=0.1)
    w[:, 1] = 0.0                                 # all-zero w blocks
    return x, w


def conv_inputs(case):
    s, kk, pad, bk, _, c = case
    x = normal((2, 9, 10, c), seed=kk * c + s)
    x[1, :, :, :] = 0.0                           # an all-zero image
    return x, normal((kk, kk, c, 6), seed=c, scale=0.2)


# (M, K, bk, bits): ragged K, ragged M past the 256-row tile, a 512
# block, K one past a block, bits above 8 (int8 saturation), tiny blocks
Q_CASES = [(5, 200, 32, 8), (300, 64, 32, 4), (5, 1024, 512, 8),
           (7, 129, 128, 8), (6, 96, 32, 9), (6, 96, 32, 10),
           (6, 96, 32, 12), (6, 40, 8, 8), (9, 384, 128, 6)]


def q_inputs(case):
    """Rows: a zero first block, a NaN, an inf, an all -inf block, a
    x1000 row and exact half-way mantissas, where the shape has them."""
    m, k, bk, bits = case
    x = normal((m, k), seed=m * k + bits)
    x[0, :bk] = 0.0
    x[1, min(3, k - 1)] = np.nan
    x[2, k - 1] = np.inf
    x[3, :min(bk, k)] = -np.inf
    x[4] *= 1000.0
    if m > 5:                      # amax 1.0, so the step is 2^-(bits-2)
        step = np.float32(2.0 ** -(bits - 2))
        x[5, :] = 0.0
        x[5, 0::bk] = 1.0
        x[5, 1::4] = step * np.float32(2.5)
        x[5, 2::4] = step * np.float32(-3.5)
    return x


def pq_k(k, bk):
    """The largest K' <= K that ``bk`` divides (prequant needs bk | K)."""
    return (k // bk) * bk


def hazard_inputs():
    """Rows that separate a faithful kernel from a near miss: exact
    half-way mantissas (round-half-even vs round-half-away), a NaN (its
    block is zeroed), a subnormal amax (subnormal step, where a
    reciprocal multiply overflows and flush-to-zero would read zero), an
    all-zero row, and a plain row.  x [5, 64] with bk = 32, w [64, 6]."""
    step = np.float32(2.0 ** -6)                   # amax 1.0 at L = 8
    x = normal((5, 64), seed=21)
    x[0] = 0.0
    x[0, ::2] = np.float32(1.0)
    x[0, 1::4] = step * np.float32(2.5)
    x[0, 3::4] = step * np.float32(-3.5)
    x[1, 5] = np.nan
    x[2] = np.float32(1e-40) * np.sign(normal(64, seed=22))
    x[3] = 0.0
    return x, normal((64, 6), seed=23, scale=0.2)
