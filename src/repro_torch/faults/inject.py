"""Deterministic, seeded fault injectors for the BFP datapath
(counterpart of ``repro.faults.inject``).

CNNs tolerate BFP's designed computation error; these injectors measure
how much ADDITIONAL, undesigned error (single-event upsets in weight
memory, corrupted wire blocks, activation-buffer glitches) the same
network absorbs.  Every injector is keyed by an explicit seed through
numpy generators (CRC32 of string keys), exactly as in ``repro``: the
same seed flips the same bits in either package.

Three fault surfaces, matching where the bits physically live:

  * **Packed weight storage** (:func:`flip_payload_bits`,
    :func:`flip_exponent_bits`): flips land in the
    :class:`~repro_torch.core.packed.PackedBFP` container's mantissa
    bitstream / int8 exponent plane.  A flipped container still parses
    (range validation happens at pack time), so the corrupted weights
    flow through ``engine.bind`` into the real serving datapath.
  * **Serialized containers** (:func:`corrupt_container_bytes`): flips in
    the byte stream past the header, which ``PackedBFP.from_bytes``
    rejects with :class:`~repro_torch.core.packed.IntegrityError`.
  * **Activations** (:func:`perturb_activations`,
    :func:`activation_faults`): flips in the int8 two's-complement image
    of a block-formatted activation buffer, delivered onto the live
    datapath through the ``engine.taps`` ``transform=True`` hook — run
    the model through ``apply`` (taps see no ``Plan.jit_forward``).

Bit indexing: ``bit=0`` is the least-significant mantissa bit (one
quantization step), ``bit=L-1`` the most significant bit of the L-bit
field; ``bit=None`` makes every bit of the field eligible.
``mode="bernoulli"`` flips each eligible bit independently with
probability ``ber``; ``mode="exact"`` flips exactly
``round(ber * n_eligible)`` distinct bits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import bfp
from repro_torch.core.packed import PackedBFP

__all__ = [
    "FaultStats", "derive_rng", "flip_payload_bits", "flip_exponent_bits",
    "corrupt_container_bytes", "perturb_activations", "activation_faults",
]

SeedLike = Union[int, np.random.Generator]


def derive_rng(seed: SeedLike, *keys: Union[int, str]) -> np.random.Generator:
    """A reproducible sub-generator from (seed, keys).

    String keys (leaf paths, site names) hash through CRC32, which is
    stable across platforms and Python processes — unlike ``hash()``.
    Passing an existing Generator returns it unchanged (caller already
    derived it).
    """
    if isinstance(seed, np.random.Generator):
        return seed
    import zlib
    ent = [int(seed) & 0xFFFFFFFF]
    for k in keys:
        ent.append(zlib.crc32(k.encode()) if isinstance(k, str)
                   else int(k) & 0xFFFFFFFF)
    return np.random.default_rng(ent)


def _check_args(ber: float, mode: str, bit: Optional[int],
                width: int) -> None:
    if not 0.0 <= ber <= 1.0:
        raise ValueError(f"bit-error rate must be in [0, 1], got {ber}")
    if mode not in ("bernoulli", "exact"):
        raise ValueError(f"mode must be 'bernoulli' or 'exact', got {mode!r}")
    if bit is not None and not 0 <= bit < width:
        raise ValueError(f"bit must be in [0, {width}) for this field, "
                         f"got {bit}")


def _pick(rng: np.random.Generator, n_eligible: int, ber: float,
          mode: str) -> np.ndarray:
    """Indices (into the eligible-bit enumeration) to flip."""
    if n_eligible == 0:
        return np.zeros((0,), np.int64)
    if mode == "exact":
        k = min(n_eligible, int(round(ber * n_eligible)))
        return rng.choice(n_eligible, size=k, replace=False)
    return np.nonzero(rng.random(n_eligible) < ber)[0]


def flip_payload_bits(p: PackedBFP, ber: float, seed: SeedLike, *,
                      bit: Optional[int] = None,
                      mode: str = "bernoulli") -> Tuple[PackedBFP, int]:
    """Flip bits in the mantissa bitstream (weight-memory SEU model).

    Eligible bits are the ``n_elements * L`` DATA bits (the final byte's
    padding never flips — it is not part of any mantissa).  With
    ``bit=j`` only position ``j`` of each element's L-bit field is
    eligible (``j=0`` = LSB = one step, ``j=L-1`` = MSB of the
    offset-binary field = half the field's range — the high-order-bit
    experiment).  Returns ``(corrupted container, n_flips)``; the
    original is untouched.  ``stored_crc`` is preserved, so a container
    that came off disk/wire still FAILS ``verify()`` afterwards — which
    is exactly what an integrity layer should detect.
    """
    L = p.bits
    _check_args(ber, mode, bit, L)
    rng = derive_rng(seed)
    n = p.n_elements
    n_eligible = n * L if bit is None else n
    idx = _pick(rng, n_eligible, ber, mode)
    if bit is None:
        abs_bits = idx                       # dense enumeration IS the stream
    else:
        # element i's field occupies stream bits [i*L, (i+1)*L), MSB first
        abs_bits = idx * L + (L - 1 - bit)
    arr = np.frombuffer(p.payload, np.uint8).copy()
    np.bitwise_xor.at(arr, abs_bits // 8,
                      (np.uint8(1) << (7 - (abs_bits % 8)).astype(np.uint8)))
    return dataclasses.replace(p, payload=arr.tobytes()), int(len(abs_bits))


def flip_exponent_bits(p: PackedBFP, ber: float, seed: SeedLike, *,
                       bit: Optional[int] = None,
                       mode: str = "bernoulli") -> Tuple[PackedBFP, int]:
    """Flip bits in the int8 exponent plane (one byte per block).

    A flipped block exponent rescales EVERY element of its block by a
    power of two — the paper's shared-exponent economy is exactly what
    makes these catastrophic, and the campaign quantifies it.  ``bit``
    indexes the int8 two's-complement byte (0 = LSB, 7 = sign).
    """
    _check_args(ber, mode, bit, 8)
    rng = derive_rng(seed)
    e = np.ascontiguousarray(p.exponents, np.int8).reshape(-1).copy()
    n_eligible = e.size * 8 if bit is None else e.size
    idx = _pick(rng, n_eligible, ber, mode)
    if bit is None:
        elem, pos = idx // 8, idx % 8
    else:
        elem, pos = idx, np.full(idx.shape, bit, np.int64)
    u = e.view(np.uint8)
    np.bitwise_xor.at(u, elem, (np.uint8(1) << pos.astype(np.uint8)))
    return (dataclasses.replace(p, exponents=e.reshape(p.exp_shape)),
            int(len(idx)))


def corrupt_container_bytes(p: Union[PackedBFP, bytes], seed: SeedLike,
                            n_flips: int = 1) -> bytes:
    """Flip ``n_flips`` random bits in a SERIALIZED container's data
    region (exponent plane + bitstream — past the header, so the result
    still parses structurally and the CRC check is what trips).

    This is the wire-corruption model: ``PackedBFP.from_bytes`` on the
    returned bytes raises
    :class:`~repro_torch.core.packed.IntegrityError`.
    """
    if isinstance(p, PackedBFP):
        data_len = p.exponents.size + len(p.payload)
        buf = p.to_bytes()
    else:
        parsed = PackedBFP.from_bytes(p, verify=False)
        data_len = parsed.exponents.size + len(parsed.payload)
        buf = bytes(p)
    rng = derive_rng(seed)
    arr = np.frombuffer(buf, np.uint8).copy()
    start = len(buf) - data_len           # data region is the tail
    bits = rng.choice(data_len * 8, size=min(n_flips, data_len * 8),
                      replace=False)
    np.bitwise_xor.at(arr, start + bits // 8,
                      (np.uint8(1) << (7 - (bits % 8)).astype(np.uint8)))
    return arr.tobytes()


# ---------------------------------------------------------------------------
# Activation faults (the taps-integrated hook)
# ---------------------------------------------------------------------------

def perturb_activations(y: Any, ber: float, seed: SeedLike, *,
                        bits: int = 8, block: int = 256,
                        bit: Optional[int] = None,
                        mode: str = "bernoulli") -> Tuple[torch.Tensor, int]:
    """Bit-flip an activation tensor's BFP memory image.

    Models an SEU in the activation SRAM: the tensor is block-formatted
    at ``bits`` (flat ``block``-element blocks), the int8
    two's-complement mantissa image takes ``ber`` flips on the chosen
    ``bit`` (0..7 of the stored byte; None = all 8), and the corrupted
    image is dequantized back.  Returns ``(perturbed, flips)`` with the
    original shape, dtype and device.  ``bits`` must be <= 8 (the int8
    storage the accelerator uses for activations).
    """
    if not 2 <= bits <= 8:
        raise ValueError(f"activation faults model int8 storage: bits "
                         f"must be in [2, 8], got {bits}")
    _check_args(ber, mode, bit, 8)
    rng = derive_rng(seed)
    yt = torch.as_tensor(y)
    arr = yt.detach().to("cpu", torch.float32).numpy()
    n = arr.size
    nb = -(-n // block)
    padded = np.zeros(nb * block, np.float32)
    padded[:n] = arr.reshape(-1)
    blk = bfp.quantize(torch.from_numpy(padded.reshape(nb, block)), bits,
                       (1,))
    m = blk.mantissa.numpy().astype(np.int8).reshape(-1)
    n_eligible = m.size * 8 if bit is None else m.size
    idx = _pick(rng, n_eligible, ber, mode)
    if bit is None:
        elem, pos = idx // 8, idx % 8
    else:
        elem, pos = idx, np.full(idx.shape, bit, np.int64)
    u = m.view(np.uint8)
    np.bitwise_xor.at(u, elem, (np.uint8(1) << pos.astype(np.uint8)))
    step = bfp.pow2(blk.exponent - (bits - 2)).numpy()
    deq = m.reshape(nb, block).astype(np.float32) * step
    out = deq.reshape(-1)[:n].reshape(arr.shape)
    return torch.from_numpy(out).to(yt.device, yt.dtype), int(len(idx))


@dataclasses.dataclass
class FaultStats:
    """What an :func:`activation_faults` context actually injected."""

    events: int = 0     #: engine sites whose output was perturbed
    flips: int = 0      #: total bit flips across those sites


@contextlib.contextmanager
def activation_faults(ber: float, seed: int, *, bits: int = 8,
                      block: int = 256, bit: Optional[int] = None,
                      paths: Optional[set] = None,
                      mode: str = "bernoulli") -> Iterator[FaultStats]:
    """Perturb every engine GEMM/conv output inside the context.

    Rides the ``engine.taps`` ``transform=True`` hook, so the faults
    land on the REAL datapath output of each site and downstream layers
    consume the corrupted activations.  ``paths`` restricts injection to
    the named sites; every event consumes one deterministic sub-seed in
    execution order (the port's sites fire in ``repro``'s order), so the
    flip pattern is a pure function of ``(seed, model, input shapes)``.
    Taps see eager execution only: run the model through ``apply``.
    """
    from repro_torch.engine.taps import taps as datapath_taps
    stats = FaultStats()
    counter = itertools.count()

    def xform(ev):
        i = next(counter)                    # consumed even when filtered:
        if paths is not None and ev.path not in paths:   # stable sub-seeds
            return None
        rng = derive_rng(seed, i)
        y2, k = perturb_activations(ev.y, ber, rng, bits=bits, block=block,
                                    bit=bit, mode=mode)
        stats.events += 1
        stats.flips += k
        return y2

    with datapath_taps(xform, transform=True):
        yield stats
