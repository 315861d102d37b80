"""64-bit integer arithmetic on 32-bit lanes.

JAX runs without 64-bit types unless x64 mode is enabled, so every 64-bit
hash/PRNG kernel in this framework represents a u64 as a ``(hi, lo)`` pair
of uint32 arrays and does schoolbook limb arithmetic with exact
16x16->32 partial products — the device analog of the scalar 64-bit ALU
the reference's hash kernels lean on (SURVEY.md K3), and also the basis
for Poly1305's wide accumulation (K13).

All functions are shape-polymorphic elementwise ops over matching uint32
arrays and are safe inside ``jit``/``shard_map``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_U32 = jnp.uint32
_MASK16 = jnp.uint32(0xFFFF)


class U64(NamedTuple):
    """A u64 as two uint32 limbs. ``hi``/``lo`` broadcast like jnp arrays."""

    hi: jax.Array
    lo: jax.Array

    @classmethod
    def const(cls, value: int) -> "U64":
        value &= (1 << 64) - 1
        return cls(hi=jnp.uint32(value >> 32), lo=jnp.uint32(value & 0xFFFFFFFF))

    @classmethod
    def from_u32(cls, lo: jax.Array) -> "U64":
        lo = lo.astype(_U32)
        return cls(hi=jnp.zeros_like(lo), lo=lo)

    def to_python(self) -> int:
        """Host-side scalar extraction (tests / digests)."""
        return (int(self.hi) << 32) | int(self.lo)

    def to_numpy(self):
        import numpy as np

        return (np.asarray(self.hi).astype(np.uint64) << np.uint64(32)) | np.asarray(self.lo).astype(
            np.uint64
        )


def u64(value: int | U64) -> U64:
    return value if isinstance(value, U64) else U64.const(value)


def add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(_U32)
    return U64(hi=a.hi + b.hi + carry, lo=lo)


def add_many(*values: U64) -> U64:
    acc = values[0]
    for v in values[1:]:
        acc = add(acc, v)
    return acc


def sub(a: U64, b: U64) -> U64:
    lo = a.lo - b.lo
    borrow = (a.lo < b.lo).astype(_U32)
    return U64(hi=a.hi - b.hi - borrow, lo=lo)


def xor(a: U64, b: U64) -> U64:
    return U64(hi=a.hi ^ b.hi, lo=a.lo ^ b.lo)


def shr(a: U64, r: int) -> U64:
    """Logical right shift by a static amount."""
    if r == 0:
        return a
    if r < 32:
        return U64(hi=a.hi >> r, lo=(a.lo >> r) | (a.hi << (32 - r)))
    if r == 32:
        return U64(hi=jnp.zeros_like(a.hi), lo=a.hi)
    return U64(hi=jnp.zeros_like(a.hi), lo=a.hi >> (r - 32))


def shl(a: U64, r: int) -> U64:
    if r == 0:
        return a
    if r < 32:
        return U64(hi=(a.hi << r) | (a.lo >> (32 - r)), lo=a.lo << r)
    if r == 32:
        return U64(hi=a.lo, lo=jnp.zeros_like(a.lo))
    return U64(hi=a.lo << (r - 32), lo=jnp.zeros_like(a.lo))


def rotl(a: U64, r: int) -> U64:
    r %= 64
    if r == 0:
        return a
    if r == 32:
        return U64(hi=a.lo, lo=a.hi)
    if r < 32:
        return U64(
            hi=(a.hi << r) | (a.lo >> (32 - r)),
            lo=(a.lo << r) | (a.hi >> (32 - r)),
        )
    s = r - 32
    return U64(
        hi=(a.lo << s) | (a.hi >> (32 - s)),
        lo=(a.hi << s) | (a.lo >> (32 - s)),
    )


def mul32_wide(a: jax.Array, b: jax.Array) -> U64:
    """Exact 32x32 -> 64 multiply via 16-bit limbs (all products fit u32)."""
    a = a.astype(_U32)
    b = b.astype(_U32)
    al, ah = a & _MASK16, a >> 16
    bl, bh = b & _MASK16, b >> 16
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = lh + hl
    mid_carry = (mid < lh).astype(_U32)
    lo = ll + (mid << 16)
    lo_carry = (lo < ll).astype(_U32)
    hi = hh + (mid >> 16) + (mid_carry << 16) + lo_carry
    return U64(hi=hi, lo=lo)


def mul(a: U64, b: U64) -> U64:
    """Low 64 bits of a 64x64 multiply."""
    wide = mul32_wide(a.lo, b.lo)
    hi = wide.hi + a.lo * b.hi + a.hi * b.lo
    return U64(hi=hi, lo=wide.lo)


def mul_wide(a: U64, b: U64) -> tuple[U64, U64]:
    """Full 64x64 -> 128 multiply, returned as (hi64, lo64)."""
    ll = mul32_wide(a.lo, b.lo)  # contributes at bit 0
    lh = mul32_wide(a.lo, b.hi)  # at bit 32
    hl = mul32_wide(a.hi, b.lo)  # at bit 32
    hh = mul32_wide(a.hi, b.hi)  # at bit 64
    # lo64 = ll + (lh + hl) << 32 ; carries propagate into hi64.
    mid = add(lh, hl)
    mid_overflow = ((mid.hi < lh.hi) | ((mid.hi == lh.hi) & (mid.lo < lh.lo))).astype(_U32)
    lo_lo = ll.lo
    lo_hi = ll.hi + mid.lo
    carry1 = (lo_hi < ll.hi).astype(_U32)
    hi = add(hh, U64(hi=mid_overflow, lo=mid.hi))
    hi = add(hi, U64(hi=jnp.zeros_like(carry1), lo=carry1))
    return hi, U64(hi=lo_hi, lo=lo_lo)


def mul128_fold64(a: U64, b: U64) -> U64:
    """(a*b) folded: hi64 ^ lo64 — the XXH3 mixing primitive."""
    hi, lo = mul_wide(a, b)
    return xor(hi, lo)


def where(mask: jax.Array, a: U64, b: U64) -> U64:
    return U64(hi=jnp.where(mask, a.hi, b.hi), lo=jnp.where(mask, a.lo, b.lo))


def swap_halves(a: U64) -> U64:
    return U64(hi=a.lo, lo=a.hi)


def pack64(hi: jax.Array, lo: jax.Array) -> U64:
    return U64(hi=hi.astype(_U32), lo=lo.astype(_U32))
