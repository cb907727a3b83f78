"""Packed BFP container — the storage format of a BFP artifact
(counterpart of ``repro.core.packed``).

Table 1's storage argument is about ``L`` bits per element plus one
shared exponent per block, but a :class:`~repro_torch.core.bfp.BFPBlock`
in memory still pads mantissas to int8/int16 and exponents to int32.
A :class:`PackedBFP` is the byte-real counterpart: any BFPBlock (every
paper scheme, TILED layouts, prequant ``{"m", "s"}`` sidecars) becomes

  * a small self-describing header (version, mantissa width, mantissa /
    exponent-plane geometry, JSON metadata),
  * an **exponent plane**: one ``int8`` per block,
  * optionally a **width plane** (container version 3): one ``uint8``
    per block giving that block's effective mantissa width
    ``L_eff = min(L, 1 + bit_length(max |mantissa|))``, and
  * a **mantissa bitstream**: sign+mantissa packed at exactly the
    configured width (offset-binary, MSB first, byte-padded at the very
    end only).

The bytes are ``repro``'s, byte for byte: a container either package
writes, the other reads, so checkpoints cross between them.  Round
trips are lossless (integer mantissas and exponents in, the same
integers out).  The checkpoint store (``checkpoint.store``
``format="bfp_packed"``), ``engine.bind`` on packed leaves and the fault
injectors share this one container.

Bit packing is host-side numpy; :func:`unpack_prequant`,
:func:`unpack_dequant` and :func:`unpack_block` place what they decode
on ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import bfp
from repro_torch.core.bfp import BFPBlock, Rounding, Scheme

__all__ = [
    "PackedBFP", "IntegrityError", "pack_block", "unpack_block",
    "pack_prequant", "unpack_prequant", "unpack_dequant", "pack_matrix",
    "pack_param_tree", "is_packed", "packed_nbytes",
]

_MAGIC = b"BFPK"
#: container version written by ``to_bytes`` for fixed-width data.  v2
#: adds a CRC32 of the exponent plane + mantissa bitstream to the fixed
#: header; v1 (no checksum) containers remain readable.
_VERSION = 2
#: container version for variable-width data: a per-block uint8 width
#: plane between the exponent plane and the bitstream (the CRC covers
#: it).  Fixed-width containers keep writing version 2.
_VERSION_VAR = 3
_READ_VERSIONS = (1, 2, 3)
#: fixed part of the v2/v3 serialized header (magic, version, bits,
#: ndims, meta length, crc32) — see ``to_bytes``
_FIXED_HEADER = 4 + 1 + 1 + 1 + 1 + 4 + 4
#: v1 fixed header (no crc32 field)
_FIXED_HEADER_V1 = 4 + 1 + 1 + 1 + 1 + 4


class IntegrityError(ValueError):
    """A container's integrity machinery rejected its bytes: the stored
    CRC32 does not match the data (payload / exponent plane / width
    plane corrupted after serialization), or a v3 width plane is
    structurally invalid (a block declares a width outside ``[1, L]``,
    or the plane / its bitstream is truncated).  Raised by
    :meth:`PackedBFP.verify` and, by default, by
    :meth:`PackedBFP.from_bytes` on v2/v3 containers; messages name the
    offending byte offset where one exists."""


def _mantissa_dtype(bits: int):
    return np.int8 if bits <= 8 else (np.int16 if bits <= 16 else np.int32)


#: elements per (un)pack chunk — bounds transient host RAM at
#: ~CHUNK*bits bytes regardless of leaf size.  Must stay a multiple of 8
#: so every non-final chunk's bitstream ends on a byte boundary.
_CHUNK = 1 << 20


def _pack_bits(m: np.ndarray, bits: int) -> bytes:
    """Bit-pack signed mantissas at exactly ``bits`` wide (MSB first).

    Values are stored offset-binary (``m + 2^(L-1)``), so the legal
    mantissa range ``[-(2^(L-1)-1), 2^(L-1)-1]`` maps into
    ``[1, 2^L - 2]`` — always representable in ``bits`` unsigned bits.
    Chunked: peak transient memory is ~``_CHUNK * bits`` bytes.
    """
    flat = np.asarray(m).reshape(-1)
    lim = (1 << (bits - 1)) - 1
    if flat.size and (flat.min() < -lim or flat.max() > lim):
        raise ValueError(
            f"mantissa outside [-{lim}, {lim}] for L={bits} (got "
            f"[{flat.min()}, {flat.max()}]) — not a {bits}-bit BFP block")
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint32)
    out = bytearray()
    for start in range(0, flat.size, _CHUNK):
        u = (flat[start:start + _CHUNK].astype(np.int64)
             + (lim + 1)).astype(np.uint32)
        bitplane = ((u[:, None] >> shifts) & 1).astype(np.uint8)
        out += np.packbits(bitplane.reshape(-1)).tobytes()
    return bytes(out)


def _unpack_bits(payload: bytes, n: int, bits: int) -> np.ndarray:
    """Inverse of :func:`_pack_bits` — n int32 mantissas out (chunked)."""
    if n == 0:
        return np.zeros((0,), np.int32)
    need = -(-n * bits // 8)
    if len(payload) < need:
        raise ValueError(f"mantissa bitstream truncated: have "
                         f"{len(payload)} bytes, need {need}")
    buf = np.frombuffer(payload, np.uint8)
    out = np.empty(n, np.int32)
    for start in range(0, n, _CHUNK):
        cnt = min(_CHUNK, n - start)
        bit0 = start * bits                      # byte-aligned: 8 | _CHUNK
        byte0, byte1 = bit0 // 8, -(-(bit0 + cnt * bits) // 8)
        raw = np.unpackbits(buf[byte0:byte1],
                            count=cnt * bits).reshape(cnt, bits)
        acc = np.zeros(cnt, np.int32)
        for b in range(bits):                    # shift-accumulate: no
            acc = (acc << 1) | raw[:, b]         # (n, bits) int64 matmul
        out[start:start + cnt] = acc
    return out - (1 << (bits - 1))


# ---------------------------------------------------------------------------
# Variable-width (v3) plane mapping + codec
# ---------------------------------------------------------------------------

def _gemm_view(m: np.ndarray, exp_shape: Tuple[int, ...]) -> np.ndarray:
    """View the mantissa tensor with one axis per exponent-plane axis.

    Identity for same-rank layouts (paper schemes' keepdims planes,
    TILED's ``[rows, K/bk]``, the wire's ``[nb, 1]``); conv HWIO
    mantissas (4-D ``m`` against the 2-D GEMM-view ``[K/bk, N]``
    sidecar) reshape to ``(kh*kw*c, n)`` — a C-order-preserving view, so
    bitstream element order is unchanged.  Every exponent axis must
    divide its mantissa axis (size-1 axes broadcast, i.e. divide
    trivially).
    """
    if m.ndim == 4 and len(exp_shape) == 2:
        kh, kw, c, n = m.shape
        m = m.reshape(kh * kw * c, n)
    if m.ndim != len(exp_shape):
        raise ValueError(
            f"cannot map exponent plane {exp_shape} onto mantissa shape "
            f"{m.shape} for variable-width packing")
    for sm, se in zip(m.shape, exp_shape):
        if se < 1 or sm % se:
            raise ValueError(
                f"exponent plane {exp_shape} does not tile mantissa "
                f"shape {m.shape} (axis size {sm} vs {se})")
    return m


def _elem_widths(m: np.ndarray) -> np.ndarray:
    """Per-element occupied width: ``1 + bit_length(|m|)`` (sign bit +
    magnitude bits; zero occupies the minimal 1 bit).  Exact for
    |m| < 2^24 (container ``bits`` <= 24) via float64 frexp."""
    a = np.abs(np.asarray(m, np.int64))
    _, e = np.frexp(a.astype(np.float64))     # e == bit_length for a > 0
    return np.where(a > 0, e + 1, 1).astype(np.int64)


def _reduce_max_to(vals: np.ndarray, exp_shape: Tuple[int, ...]
                   ) -> np.ndarray:
    """Max-reduce a per-element plane onto the exponent-plane geometry
    (same-rank view from :func:`_gemm_view`).  Blocked axes are
    CONTIGUOUS groups — the inverse of ``BFPBlock.scale``'s repeat."""
    split, red = [], []
    for i, (sv, se) in enumerate(zip(vals.shape, exp_shape)):
        split += [se, sv // se]
        red.append(2 * i + 1)
    if not split:
        return vals
    return vals.reshape(split).max(axis=tuple(red))


def _expand_plane(plane: np.ndarray, view_shape: Tuple[int, ...]
                  ) -> np.ndarray:
    """Inverse of :func:`_reduce_max_to`: broadcast/repeat a per-block
    plane to per-element over the same-rank mantissa view."""
    out = plane
    for ax, (sv, se) in enumerate(zip(view_shape, plane.shape)):
        if se != sv:
            out = np.repeat(out, sv // se, axis=ax)
    return out


def _width_planes(m: np.ndarray, exp_shape: Tuple[int, ...], bits: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Derive the per-block width plane ``L_eff = min(L, 1 +
    bit_length(max |m|))`` and its per-element expansion (flat, C-order
    of the stored mantissa tensor)."""
    view = _gemm_view(np.asarray(m), exp_shape)
    widths = np.minimum(_reduce_max_to(_elem_widths(view), exp_shape),
                        bits)
    wid_elem = _expand_plane(widths, view.shape).reshape(-1)
    return widths.astype(np.uint8).reshape(exp_shape), wid_elem


def _pack_bits_var(m: np.ndarray, wid_elem: np.ndarray) -> bytes:
    """Bit-pack signed mantissas, element ``i`` at exactly
    ``wid_elem[i]`` bits (its block's effective width), MSB first,
    offset-binary ``m + 2^(w-1)``.  Chunked like :func:`_pack_bits`;
    chunk seams are NOT byte-aligned here, so up to 7 leftover bits
    carry into the next chunk's bit buffer.
    """
    flat = np.asarray(m).reshape(-1).astype(np.int64)
    w = np.asarray(wid_elem).reshape(-1).astype(np.int64)
    lim = (1 << (w - 1)) - 1
    bad = np.abs(flat) > lim
    if flat.size and bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"mantissa {flat[i]} at element {i} exceeds its block's "
            f"effective width {w[i]} — width plane does not describe "
            f"this data")
    out = bytearray()
    carry = np.zeros(0, np.uint8)
    for start in range(0, flat.size, _CHUNK):
        f = flat[start:start + _CHUNK]
        ww = w[start:start + _CHUNK]
        u = (f + (1 << (ww - 1))).astype(np.uint64)
        ends = carry.size + np.cumsum(ww)
        bitbuf = np.zeros(int(ends[-1]) if ww.size else carry.size,
                          np.uint8)
        bitbuf[:carry.size] = carry
        starts = ends - ww
        for width in np.unique(ww):
            sel = ww == width
            s0, uu = starts[sel], u[sel]
            for j in range(int(width)):
                bitbuf[s0 + j] = (uu >> int(width - 1 - j)) & 1
        nfull = (bitbuf.size // 8) * 8
        out += np.packbits(bitbuf[:nfull]).tobytes()
        carry = bitbuf[nfull:]
    if carry.size:
        out += np.packbits(carry).tobytes()   # final byte zero-padded
    return bytes(out)


def _unpack_bits_var(payload: bytes, wid_elem: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_pack_bits_var` — int32 mantissas out (chunked,
    bit offsets via cumsum)."""
    w = np.asarray(wid_elem).reshape(-1).astype(np.int64)
    n = w.size
    if n == 0:
        return np.zeros((0,), np.int32)
    ends = np.cumsum(w)
    starts = ends - w
    need = -(-int(ends[-1]) // 8)
    if len(payload) < need:
        raise ValueError(f"mantissa bitstream truncated: have "
                         f"{len(payload)} bytes, need {need}")
    buf = np.frombuffer(payload, np.uint8)
    out = np.empty(n, np.int32)
    for c0 in range(0, n, _CHUNK):
        c1 = min(c0 + _CHUNK, n)
        byte0 = int(starts[c0]) // 8
        byte1 = -(-int(ends[c1 - 1]) // 8)
        bits_c = np.unpackbits(buf[byte0:byte1])
        local = starts[c0:c1] - byte0 * 8
        ww = w[c0:c1]
        acc = np.zeros(c1 - c0, np.int64)
        for width in np.unique(ww):
            sel = ww == width
            s0 = local[sel]
            a = np.zeros(s0.size, np.int64)
            for j in range(int(width)):
                a = (a << 1) | bits_c[s0 + j]
            acc[sel] = a - (1 << int(width - 1))
        out[c0:c1] = acc
    return out


def _var_payload_need(shape: Tuple[int, ...], exp_shape: Tuple[int, ...],
                      widths: np.ndarray) -> int:
    """Exact variable-width bitstream size.  Every block covers the same
    ``n / n_blocks`` elements (blocked axes tile evenly), so the total
    is ``ceil(elems_per_block * sum(widths) / 8)``."""
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    n_exp = int(np.prod(exp_shape, dtype=np.int64)) if exp_shape else 1
    if n_exp < 1 or n % n_exp:
        raise ValueError(f"exponent plane {exp_shape} does not evenly "
                         f"tile shape {shape}")
    total_bits = (n // n_exp) * int(np.sum(widths, dtype=np.int64))
    return -(-total_bits // 8)


def _exp_int8(e: np.ndarray) -> np.ndarray:
    e = np.asarray(e)
    if e.size and (e.min() < -128 or e.max() > 127):
        raise ValueError(
            f"block exponent outside int8 range [-128, 127] (got "
            f"[{e.min()}, {e.max()}]) — cannot store one int8 per block")
    return e.astype(np.int8)


@dataclasses.dataclass(frozen=True)
class PackedBFP:
    """One bit-packed BFP tensor: header + exponent plane + bitstream.

    ``shape`` is the mantissa tensor's shape (== the source tensor's);
    ``exp_shape`` the exponent plane's (one entry per block).  ``meta``
    is small JSON-serializable provenance (scheme, operand, block_k,
    ``kind`` = "block" | "prequant" | "wire", conv HWIO geometry, ...) —
    the restore paths read it, the container does not depend on it.
    """

    bits: int
    shape: Tuple[int, ...]
    exp_shape: Tuple[int, ...]
    exponents: np.ndarray            #: int8, C-order, ``exp_shape``
    payload: bytes                   #: ceil(prod(shape) * bits / 8) bytes
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: CRC32 the container was DESERIALIZED with (v2 headers); None for
    #: freshly built or v1 containers.  ``verify()`` checks data against
    #: it, so corruption introduced after parsing is still detectable
    #: in-memory.  Excluded from equality: two containers with the same
    #: data are the same container.
    stored_crc: Optional[int] = dataclasses.field(default=None,
                                                  compare=False)
    #: variable-width (v3) containers carry one uint8 effective width
    #: per block, same geometry as the exponent plane; ``None`` means
    #: fixed-width (every element at ``bits``).  Equality-relevant: two
    #: containers with different width planes hold different bitstreams.
    widths: Optional[np.ndarray] = None

    def __post_init__(self):
        if not 2 <= self.bits <= 24:
            raise ValueError(f"bits must be in [2, 24], got {self.bits}")
        if tuple(self.exponents.shape) != tuple(self.exp_shape):
            raise ValueError("exponent plane shape mismatch")
        n = int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1
        if self.widths is None:
            need = -(-n * self.bits // 8)
        else:
            if tuple(self.widths.shape) != tuple(self.exp_shape):
                raise ValueError("width plane shape mismatch (must match "
                                 "the exponent plane, one width per block)")
            wmin = int(self.widths.min()) if self.widths.size else 1
            wmax = int(self.widths.max()) if self.widths.size else 1
            if wmin < 1 or wmax > self.bits:
                raise ValueError(
                    f"block widths [{wmin}, {wmax}] outside the legal "
                    f"[1, {self.bits}] for an L={self.bits} container")
            need = _var_payload_need(self.shape, self.exp_shape,
                                     self.widths)
        if len(self.payload) != need:
            raise ValueError(f"payload is {len(self.payload)} bytes; "
                             f"shape {self.shape} at L={self.bits}"
                             f"{' (variable-width)' if self.widths is not None else ''}"
                             f" needs {need}")

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def variable(self) -> bool:
        """True when this container stores per-block effective widths."""
        return self.widths is not None

    @property
    def nbytes(self) -> int:
        """Exact serialized size (fixed header + dims + meta + exponent
        plane [+ width plane] + bitstream)."""
        meta_len = len(json.dumps(self.meta).encode())
        return (_FIXED_HEADER + 4 * (len(self.shape) + len(self.exp_shape))
                + meta_len + self.exponents.size
                + (self.exponents.size if self.widths is not None else 0)
                + len(self.payload))

    # -- integrity ----------------------------------------------------------

    def crc32(self) -> int:
        """CRC32 over the exponent plane + (v3) width plane + mantissa
        bitstream — exactly the bytes a bit-flip in storage or on the
        wire would corrupt.  The header (shape/meta) is covered by its
        own structural validation in :meth:`from_bytes`."""
        crc = zlib.crc32(self.exponents.astype(np.int8).tobytes(order="C"))
        if self.widths is not None:
            crc = zlib.crc32(
                self.widths.astype(np.uint8).tobytes(order="C"), crc)
        return zlib.crc32(self.payload, crc) & 0xFFFFFFFF

    def verify(self) -> "PackedBFP":
        """Check data against the deserialized CRC (v2 containers).

        Returns ``self`` on success (or when no stored CRC exists — v1
        containers and freshly built ones have nothing to check
        against); raises :class:`IntegrityError` on mismatch.  The
        checkpoint restore path calls this (and ``repro``'s wire unpack),
        so a flipped payload byte is caught before it reaches a model.
        """
        if self.stored_crc is not None:
            actual = self.crc32()
            if actual != self.stored_crc:
                raise IntegrityError(
                    f"PackedBFP checksum mismatch: stored crc32 "
                    f"{self.stored_crc:#010x} != computed {actual:#010x} "
                    f"(shape {self.shape}, L={self.bits}, "
                    f"kind={self.meta.get('kind')!r}) — payload or "
                    f"exponent plane corrupted after serialization")
        return self

    # -- serialization ------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Serialize (docs/formats.md layout, container version 2 for
        fixed-width data, 3 for variable-width):

        ========  =========================================================
        bytes     field
        ========  =========================================================
        0:4       magic ``b"BFPK"``
        4         version (2 fixed-width | 3 variable-width)
        5         mantissa width L, sign included (v3: the MAXIMUM width;
                  per-block effective widths live in the width plane)
        6, 7      ndim(shape), ndim(exp_shape)
        8:12      meta JSON length (u32 LE)
        12:16     crc32 of exponent [+ width] plane + bitstream (u32 LE)
        ..        shape dims, then exp_shape dims (u32 LE each)
        ..        meta JSON (utf-8)
        ..        exponent plane (int8, C-order, one per block)
        ..        width plane (uint8, C-order, one per block; v3 ONLY)
        ..        mantissa bitstream (offset-binary, MSB first)
        ========  =========================================================

        The CRC is recomputed from the CURRENT data at every
        serialization (checksums certify bytes, not history).
        """
        meta_b = json.dumps(self.meta).encode()
        ver = _VERSION if self.widths is None else _VERSION_VAR
        out = [_MAGIC,
               struct.pack("<BBBBII", ver, self.bits, len(self.shape),
                           len(self.exp_shape), len(meta_b), self.crc32())]
        for d in (*self.shape, *self.exp_shape):
            out.append(struct.pack("<I", d))
        out.append(meta_b)
        out.append(self.exponents.astype(np.int8).tobytes(order="C"))
        if self.widths is not None:
            out.append(self.widths.astype(np.uint8).tobytes(order="C"))
        out.append(self.payload)
        return b"".join(out)

    @classmethod
    def from_bytes(cls, buf: bytes, verify: bool = True) -> "PackedBFP":
        """Parse a serialized container (v1 or v2).

        Every declared length is validated against the actual buffer
        BEFORE slicing, so a truncated or clipped buffer raises a clear
        ``ValueError`` naming the offending offset instead of slicing
        short silently or surfacing a bare ``struct.error``.  v2
        containers additionally verify the stored CRC32 (raise
        :class:`IntegrityError` on mismatch) unless ``verify=False`` —
        fault-injection campaigns parse corrupted containers on purpose.
        """
        buf = bytes(buf)
        if len(buf) < _FIXED_HEADER_V1:
            raise ValueError(
                f"truncated container: {len(buf)} bytes, need at least "
                f"{_FIXED_HEADER_V1} for the fixed header")
        if buf[:4] != _MAGIC:
            raise ValueError(f"not a PackedBFP container (magic "
                             f"{buf[:4]!r} != {_MAGIC!r})")
        ver, bits, nd, ne, meta_len = struct.unpack(
            "<BBBBI", buf[4:_FIXED_HEADER_V1])
        if ver not in _READ_VERSIONS:
            raise ValueError(f"unsupported PackedBFP version {ver}")
        variable = ver >= 3
        stored_crc = None
        off = _FIXED_HEADER_V1
        if ver >= 2:
            if len(buf) < _FIXED_HEADER:
                raise ValueError(
                    f"truncated container: {len(buf)} bytes, need "
                    f"{_FIXED_HEADER} for the v2 fixed header")
            (stored_crc,) = struct.unpack("<I", buf[off:off + 4])
            off += 4
        if len(buf) < off + 4 * (nd + ne):
            raise ValueError(
                f"truncated container: dims region needs "
                f"{4 * (nd + ne)} bytes at offset {off}, buffer has "
                f"{len(buf) - off}")
        dims = struct.unpack(f"<{nd + ne}I", buf[off:off + 4 * (nd + ne)])
        off += 4 * (nd + ne)
        shape, exp_shape = dims[:nd], dims[nd:]
        if len(buf) < off + meta_len:
            raise ValueError(
                f"truncated container: meta region declares {meta_len} "
                f"bytes at offset {off}, buffer has {len(buf) - off}")
        meta = json.loads(buf[off:off + meta_len].decode()) if meta_len \
            else {}
        off += meta_len
        n_exp = int(np.prod(exp_shape, dtype=np.int64)) if ne else 1
        if len(buf) < off + n_exp:
            raise ValueError(
                f"truncated container: exponent plane needs {n_exp} "
                f"bytes at offset {off}, buffer has {len(buf) - off}")
        exps = np.frombuffer(buf[off:off + n_exp],
                             np.int8).reshape(exp_shape)
        off += n_exp
        n = int(np.prod(shape, dtype=np.int64)) if nd else 1
        widths = None
        if variable:
            if len(buf) < off + n_exp:
                raise IntegrityError(
                    f"truncated container: width plane needs {n_exp} "
                    f"bytes at offset {off}, buffer has {len(buf) - off}")
            widths = np.frombuffer(buf[off:off + n_exp],
                                   np.uint8).reshape(exp_shape)
            flatw = widths.reshape(-1)
            bad = (flatw < 1) | (flatw > bits)
            if bad.any():
                i = int(np.argmax(bad))
                raise IntegrityError(
                    f"width plane corrupt: block {i} declares width "
                    f"{flatw[i]} outside [1, {bits}] for an L={bits} "
                    f"container (byte offset {off + i})")
            off += n_exp
            if n_exp and n % n_exp:
                raise IntegrityError(
                    f"width plane geometry invalid: {n_exp} blocks do "
                    f"not evenly tile {n} elements")
            need = _var_payload_need(tuple(shape), tuple(exp_shape),
                                     widths)
            if len(buf) - off < need:
                raise IntegrityError(
                    f"truncated container: variable-width bitstream "
                    f"needs {need} bytes at offset {off}, buffer has "
                    f"{len(buf) - off}")
        else:
            need = -(-n * bits // 8)
        payload = buf[off:off + need]
        if len(payload) != need:
            raise ValueError(f"truncated container: {len(payload)} payload "
                             f"bytes at offset {off}, need {need}")
        p = cls(bits=bits, shape=tuple(shape), exp_shape=tuple(exp_shape),
                exponents=exps, payload=payload, meta=meta,
                stored_crc=stored_crc, widths=widths)
        return p.verify() if verify else p


def is_packed(x: Any) -> bool:
    return isinstance(x, PackedBFP)


def packed_nbytes(shape: Tuple[int, ...], exp_shape: Tuple[int, ...],
                  bits: int, meta_len: int = 2) -> int:
    """Analytic serialized size for a hypothetical container (the Table-1
    accounting, byte-exact): header + one int8 per block + the bitstream."""
    n = int(np.prod(shape, dtype=np.int64))
    n_exp = int(np.prod(exp_shape, dtype=np.int64))
    return (_FIXED_HEADER + 4 * (len(shape) + len(exp_shape)) + meta_len
            + n_exp + -(-n * bits // 8))


# ---------------------------------------------------------------------------
# BFPBlock <-> container
# ---------------------------------------------------------------------------

def _np(x: Any) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pack_payload(m: np.ndarray, exp_shape: Tuple[int, ...], bits: int,
                  variable: bool
                  ) -> Tuple[bytes, Optional[np.ndarray]]:
    """Build (payload, width plane) — width plane ``None`` when fixed."""
    if not variable:
        return _pack_bits(m, bits), None
    widths, wid_elem = _width_planes(m, exp_shape, bits)
    return _pack_bits_var(m, wid_elem), widths


def _unpack_mantissas(p: PackedBFP) -> np.ndarray:
    """Decode a container's bitstream (fixed or variable width) to int32
    mantissas in the stored tensor shape."""
    if p.widths is None:
        return _unpack_bits(p.payload, p.n_elements, p.bits).reshape(p.shape)
    view = _gemm_view(np.empty(p.shape, np.int8), p.exp_shape)
    wid_elem = _expand_plane(p.widths.astype(np.int64).reshape(p.exp_shape),
                             view.shape).reshape(-1)
    return _unpack_bits_var(p.payload, wid_elem).reshape(p.shape)


def pack_block(blk: BFPBlock, variable: bool = False,
               **meta: Any) -> PackedBFP:
    """Serialize a BFPBlock losslessly (any scheme/axes layout, incl. the
    TILED non-keepdims exponent planes).  ``variable=True`` packs each
    block at its effective width (v3 container)."""
    m = _np(blk.mantissa)
    e = _np(blk.exponent)
    meta.setdefault("kind", "block")
    payload, widths = _pack_payload(m, tuple(e.shape), blk.bits, variable)
    return PackedBFP(bits=blk.bits, shape=tuple(m.shape),
                     exp_shape=tuple(e.shape), exponents=_exp_int8(e),
                     payload=payload, meta=dict(meta), widths=widths)


def unpack_block(p: PackedBFP, device: DeviceLike = "cuda") -> BFPBlock:
    """Reconstruct the exact BFPBlock on ``device`` (bit-identical
    mantissas/exponents, fixed- or variable-width container alike)."""
    dev = resolve_device(device)
    m = _unpack_mantissas(p).astype(_mantissa_dtype(p.bits))
    e = p.exponents.astype(np.int32).reshape(p.exp_shape)
    return BFPBlock(mantissa=torch.from_numpy(m).to(dev),
                    exponent=torch.from_numpy(e).to(dev), bits=p.bits)


def pack_matrix(w: torch.Tensor, bits: int, operand: str, scheme: Scheme,
                block_k: Optional[int] = None,
                rounding: Rounding = Rounding.ROUND,
                variable: bool = False,
                **meta: Any) -> PackedBFP:
    """Quantize one GEMM operand under ``scheme`` and pack it — the
    one-call path that measures real bytes."""
    blk = bfp.bfp_quantize_matrix(w, bits, operand, scheme, block_k,
                                  rounding)
    return pack_block(blk, variable=variable, scheme=scheme.value,
                      operand=operand, block_k=block_k, **meta)


# ---------------------------------------------------------------------------
# Prequant {"m", "s"} sidecars <-> container
# ---------------------------------------------------------------------------

def _steps_to_exponents(s: np.ndarray, bits: int) -> np.ndarray:
    """Recover integer BLOCK exponents from the power-of-two step sidecar:
    s = 2^(eps - (L-2)) exactly, so frexp is exact too."""
    s = np.asarray(s, np.float32)
    if s.size and (not np.all(np.isfinite(s)) or np.any(s <= 0)):
        raise ValueError("prequant scale sidecar must be positive finite")
    frac, e = np.frexp(s.astype(np.float64))
    if s.size and not np.all(frac == 0.5):
        raise ValueError("prequant scales are not exact powers of two — "
                         "refusing a lossy pack")
    return (e - 1 + (bits - 2)).astype(np.int64)


def pack_prequant(d: Dict[str, Any], bits: int, variable: bool = False,
                  **meta: Any) -> PackedBFP:
    """Pack a prequant ``{"m", "s"}`` weight losslessly.

    ``bits`` is the policy's ``l_w`` (the mantissa storage width; int8
    sidecars of an L<=8 policy really shrink to L bits here).  Works for
    2-D, stacked ``[.., K, N]``, and conv-HWIO mantissas (``s`` stays in
    the GEMM view ``[K//bk, N]``): the container records both shapes, so
    :func:`unpack_prequant` reproduces the dict bit-exactly.
    ``variable=True`` additionally stores each block at its effective
    occupied width (v3 container) — still bit-exact on round trip.
    """
    m, s = _np(d["m"]), _np(d["s"])
    eps = _steps_to_exponents(s, bits)
    meta.setdefault("kind", "prequant")
    payload, widths = _pack_payload(m, tuple(s.shape), bits, variable)
    return PackedBFP(bits=bits, shape=tuple(m.shape),
                     exp_shape=tuple(s.shape), exponents=_exp_int8(eps),
                     payload=payload, meta=dict(meta), widths=widths)


def unpack_prequant(p: PackedBFP,
                    device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Container -> the exact ``{"m", "s"}`` sidecar dict ``pack_prequant``
    consumed, on ``device`` — int mantissas and float32 power-of-two
    steps, no float weight ever materialized.  Fixed- and variable-width
    containers decode identically (``m`` dtype follows the container's
    L)."""
    dev = resolve_device(device)
    m = _unpack_mantissas(p).astype(_mantissa_dtype(p.bits))
    steps = np.ldexp(1.0, p.exponents.astype(np.int64) - (p.bits - 2))
    s = steps.astype(np.float32).reshape(p.exp_shape)
    return {"m": torch.from_numpy(m).to(dev),
            "s": torch.from_numpy(s).to(dev)}


def unpack_dequant(p: PackedBFP, device: DeviceLike = "cuda") -> torch.Tensor:
    """Container -> dense float32 (``m * s``) on ``device``, for
    float-tree restores.  Handles the conv case (HWIO mantissa with a
    GEMM-view ``[K//bk, N]`` sidecar) by dequantizing in the GEMM view
    and reshaping back."""
    from repro_torch.core.prequant import dequantize_prequant
    if p.meta.get("kind") == "block":
        return unpack_block(p, device).dequantize()
    d = unpack_prequant(p, device)
    m, s = d["m"], d["s"]
    if m.ndim == 4 and s.ndim == 2:          # conv HWIO mantissa
        kh, kw, c, n = m.shape
        flat = dequantize_prequant({"m": m.reshape(kh * kw * c, n), "s": s})
        return flat.reshape(kh, kw, c, n)
    return dequantize_prequant(d)


# ---------------------------------------------------------------------------
# Param-tree packing (the checkpoint walk)
# ---------------------------------------------------------------------------

def pack_param_tree(params: Any, policy: Any, kind: str = "auto",
                    variable: bool = False) -> Any:
    """Replace every prequant-eligible GEMM/conv weight leaf with a
    :class:`PackedBFP`; every other leaf (biases, BN terms, odd-K
    weights, rules resolving to None, Python ints) stays untouched.

    The leaf selection and layer paths are those of
    ``core.prequant.quantize_param_tree`` (LM trees: stacked ``[L, K, N]``
    and ``[L, E, K, N]`` leaves pack whole, one exponent per block of each
    trailing matrix) and ``quantize_cnn_param_tree``, so a packed checkpoint
    stores exactly the leaves a bound plan would pre-quantize —
    restoring to ``{"m", "s"}`` sidecars is bit-identical to binding the
    float tree under the same policy.  A tree that already holds
    prequant ``{"m", "s"}`` dicts at those sites (``plan.params``) packs
    them as-is, losslessly.  Weights are quantized where they live;
    the containers are host bytes.

    ``kind``: "cnn" | "lm" | "auto" (the detection ``engine.bind`` uses).
    ``variable=True`` writes v3 variable-width containers — the
    checkpoint store's ``format="bfp_packed_v2"``.
    """
    from repro_torch.core import prequant as PQ
    if policy is None:
        raise ValueError("pack_param_tree needs a BFPPolicy or PolicyMap "
                         "(got None — nothing would be packed)")
    if kind == "auto":
        kind = PQ.detect_tree_kind(params)   # same detector engine.bind uses
    if kind not in ("cnn", "lm"):
        raise ValueError(f"kind must be 'cnn', 'lm', or 'auto'; got {kind!r}")

    def pack_one(leaf, w, pol, path, conv):
        if PQ.is_prequant(leaf):            # already bound: pack losslessly
            d = leaf
        else:
            d = (PQ.prequant_conv_leaf if conv
                 else PQ.prequant_leaf)(w, pol)
            if not PQ.is_prequant(d):
                return leaf                 # odd K etc.: stays float
        return pack_prequant(d, pol.l_w, variable=variable, path=path,
                             conv=conv, block_k=pol.block_k,
                             scheme=pol.scheme.value)

    def one(tree_path, leaf):
        keys = [str(k) for k in tree_path]
        prequantized = PQ.is_prequant(leaf)
        w = leaf["m"] if prequantized else leaf
        if isinstance(w, np.ndarray):
            w = torch.from_numpy(w)
        if not isinstance(w, torch.Tensor) or (
                not prequantized and not w.is_floating_point()):
            return leaf
        if kind == "lm":
            if not PQ.lm_eligible(keys) or w.ndim < 2:
                return leaf
            path = PQ.lm_rule_path(keys)
            pol = PQ._resolve(policy, path)
            return leaf if pol is None else pack_one(leaf, w, pol, path,
                                                     False)
        if not keys or keys[-1] != "w":
            return leaf
        path = PQ.cnn_rule_path(params, keys)
        pol = None if path is None else PQ._resolve(policy, path)
        if pol is None or w.ndim not in (2, 4):
            return leaf
        return pack_one(leaf, w, pol, path, w.ndim == 4)

    return _tree.map_with_path(one, params, is_leaf=PQ.is_prequant)
