"""Deterministic 64-bit string hashing (FarmHash Fingerprint64).

A copy of ``rectpu/features/hashing.py``'s pure-Python FarmHash: the port
keeps its own copy rather than importing the JAX package. The reference
delegates categorical hashing to TF's ``categorical_column_with_hash_bucket``
(reference trainers/ml_100k.py:19-30), whose C++ kernel computes
``farmhash::Fingerprint64(as_string(x)) % buckets``. Integer inputs are hashed
via their decimal string representation, matching TF's ``as_string``
conversion for non-string hash columns.

The implementation follows the public FarmHash ``farmhashna::Hash64``
algorithm. Inputs in this framework are short (<= 32 bytes: decimal ids,
zipcodes, occupation words), which exercise only the 0-16 and 17-32 byte
branches; longer branches are implemented for generality. rectpu's vectorized
C++ version (``rectpu/io/native/farmhash.cc``) has no counterpart in the port
yet (ROADMAP queue A): ``hash_bucket`` here is the per-element Python loop.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_M = (1 << 64) - 1
K0 = 0xC3A5C85C97CB3127
K1 = 0xB492B66FBE98F273
K2 = 0x9AE16A3B2F90404F


def _rot(v: int, s: int) -> int:
    if s == 0:
        return v
    return ((v >> s) | (v << (64 - s))) & _M


def _shift_mix(v: int) -> int:
    return (v ^ (v >> 47)) & _M


def _fetch64(s: bytes, i: int) -> int:
    return int.from_bytes(s[i : i + 8], "little")


def _fetch32(s: bytes, i: int) -> int:
    return int.from_bytes(s[i : i + 4], "little")


def _hash_len16(u: int, v: int, mul: int) -> int:
    a = ((u ^ v) * mul) & _M
    a ^= a >> 47
    b = ((v ^ a) * mul) & _M
    b ^= b >> 47
    return (b * mul) & _M


def _hash_len_0_to_16(s: bytes) -> int:
    n = len(s)
    if n >= 8:
        mul = (K2 + 2 * n) & _M
        a = (_fetch64(s, 0) + K2) & _M
        b = _fetch64(s, n - 8)
        c = (_rot(b, 37) * mul + a) & _M
        d = ((_rot(a, 25) + b) * mul) & _M
        return _hash_len16(c, d, mul)
    if n >= 4:
        mul = (K2 + 2 * n) & _M
        a = _fetch32(s, 0)
        return _hash_len16((n + (a << 3)) & _M, _fetch32(s, n - 4), mul)
    if n > 0:
        a, b, c = s[0], s[n >> 1], s[n - 1]
        y = (a + (b << 8)) & _M
        z = (n + (c << 2)) & _M
        return (_shift_mix((y * K2) & _M ^ (z * K0) & _M) * K2) & _M
    return K2


def _hash_len_17_to_32(s: bytes) -> int:
    n = len(s)
    mul = (K2 + 2 * n) & _M
    a = (_fetch64(s, 0) * K1) & _M
    b = _fetch64(s, 8)
    c = (_fetch64(s, n - 8) * mul) & _M
    d = (_fetch64(s, n - 16) * K2) & _M
    return _hash_len16(
        (_rot((a + b) & _M, 43) + _rot(c, 30) + d) & _M,
        (a + _rot((b + K2) & _M, 18) + c) & _M,
        mul,
    )


def _hash_len_33_to_64(s: bytes) -> int:
    n = len(s)
    mul = (K2 + 2 * n) & _M
    a = (_fetch64(s, 0) * K2) & _M
    b = _fetch64(s, 8)
    c = (_fetch64(s, n - 8) * mul) & _M
    d = (_fetch64(s, n - 16) * K2) & _M
    y = (_rot((a + b) & _M, 43) + _rot(c, 30) + d) & _M
    z = _hash_len16(y, (a + _rot((b + K2) & _M, 18) + c) & _M, mul)
    e = (_fetch64(s, 16) * mul) & _M
    f = _fetch64(s, 24)
    g = ((y + _fetch64(s, n - 32)) * mul) & _M
    h = ((z + _fetch64(s, n - 24)) * mul) & _M
    return _hash_len16(
        (_rot((e + f) & _M, 43) + _rot(g, 30) + h) & _M,
        (e + _rot((f + a) & _M, 18) + g) & _M,
        mul,
    )


def _weak_hash_len32_with_seeds(w: int, x: int, y: int, z: int, a: int, b: int):
    a = (a + w) & _M
    b = _rot((b + a + z) & _M, 21)
    c = a
    a = (a + x) & _M
    a = (a + y) & _M
    b = (b + _rot(a, 44)) & _M
    return (a + z) & _M, (b + c) & _M


def _weak_hash_bytes(s: bytes, i: int, a: int, b: int):
    return _weak_hash_len32_with_seeds(
        _fetch64(s, i), _fetch64(s, i + 8), _fetch64(s, i + 16), _fetch64(s, i + 24), a, b
    )


def fingerprint64_bytes(s: bytes) -> int:
    """FarmHash-style 64-bit fingerprint of a byte string."""
    n = len(s)
    if n <= 16:
        return _hash_len_0_to_16(s)
    if n <= 32:
        return _hash_len_17_to_32(s)
    if n <= 64:
        return _hash_len_33_to_64(s)

    seed = 81
    x = seed
    y = (seed * K1 + 113) & _M
    z = (_shift_mix((y * K2 + 113) & _M) * K2) & _M
    v = (0, 0)
    w = (0, 0)
    x = (x * K2 + _fetch64(s, 0)) & _M

    end = ((n - 1) // 64) * 64
    last64 = end + ((n - 1) & 63) - 63
    i = 0
    while i != end:
        x = (_rot((x + y + v[0] + _fetch64(s, i + 8)) & _M, 37) * K1) & _M
        y = (_rot((y + v[1] + _fetch64(s, i + 48)) & _M, 42) * K1) & _M
        x ^= w[1]
        y = (y + v[0] + _fetch64(s, i + 40)) & _M
        z = (_rot((z + w[0]) & _M, 33) * K1) & _M
        v = _weak_hash_bytes(s, i, (v[1] * K1) & _M, (x + w[0]) & _M)
        w = _weak_hash_bytes(s, i + 32, (z + w[1]) & _M, (y + _fetch64(s, i + 16)) & _M)
        z, x = x, z
        i += 64

    mul = (K1 + ((z & 0xFF) << 1)) & _M
    i = last64
    w = ((w[0] + ((n - 1) & 63)) & _M, w[1])
    v = ((v[0] + w[0]) & _M, v[1])
    w = ((w[0] + v[0]) & _M, w[1])
    x = (_rot((x + y + v[0] + _fetch64(s, i + 8)) & _M, 37) * mul) & _M
    y = (_rot((y + v[1] + _fetch64(s, i + 48)) & _M, 42) * mul) & _M
    x ^= (w[1] * 9) & _M
    y = (y + v[0] * 9 + _fetch64(s, i + 40)) & _M
    z = (_rot((z + w[0]) & _M, 33) * mul) & _M
    v = _weak_hash_bytes(s, i, (v[1] * mul) & _M, (x + w[0]) & _M)
    w = _weak_hash_bytes(s, i + 32, (z + w[1]) & _M, (y + _fetch64(s, i + 16)) & _M)
    z, x = x, z
    return _hash_len16(
        (_hash_len16(v[0], w[0], mul) + _shift_mix(y) * K0 + z) & _M,
        (_hash_len16(v[1], w[1], mul) + x) & _M,
        mul,
    )


@lru_cache(maxsize=1 << 20)
def fingerprint64(s: str) -> int:
    """Fingerprint of a unicode string (utf-8 encoded)."""
    return fingerprint64_bytes(s.encode("utf-8"))


def hash_bucket(values, num_buckets: int) -> np.ndarray:
    """Map an array of raw categorical values to hash buckets.

    Semantics of TF's ``categorical_column_with_hash_bucket``
    (reference trainers/ml_100k.py:19-30): non-string inputs are
    stringified (decimal), then ``fingerprint64(s) % num_buckets``.

    The per-element Python loop of ``rectpu.features.hashing.hash_bucket``
    (its fallback when the native library is unbuilt), bucket for bucket.
    This is the serving request-encode hot path.
    """
    values = np.asarray(values)
    if values.dtype.kind in "iu":
        out = np.empty(values.shape, dtype=np.int32)
        flat = values.reshape(-1)
        oflat = out.reshape(-1)
        for i in range(flat.shape[0]):
            oflat[i] = fingerprint64(str(int(flat[i]))) % num_buckets
        return out
    out = np.empty(values.shape, dtype=np.int32)
    flat = values.reshape(-1)
    oflat = out.reshape(-1)
    for i in range(flat.shape[0]):
        v = flat[i]
        # S-dtype / bytes elements hash their raw bytes — str(b"x") would
        # hash the "b'x'" repr
        b = bytes(v) if isinstance(v, (bytes, np.bytes_)) else str(v).encode("utf-8")
        oflat[i] = fingerprint64_bytes(b) % num_buckets
    return out
