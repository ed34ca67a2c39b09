"""64-bit integers as (hi, lo) uint32 pairs.

Without jax_enable_x64, JAX has no s64/u64 arrays at all. The
reference's bit-level contracts (hashed keys, Minimizer/Anchor packing —
/root/reference/src/sketch.rs:16-19, seeds.rs:63-78) are all 64-bit, so
this module provides the handful of u64 operations the kernels need as
plain uint32 ops: shifts across the word boundary, add-with-carry,
bitwise ops, and lexicographic comparison.

A U64Pair is a pytree (works under jit/vmap/scan); all ops are
elementwise and broadcast like jnp.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

_U32 = jnp.uint32
_MASK32 = (1 << 32) - 1


class U64Pair(NamedTuple):
    hi: jnp.ndarray
    lo: jnp.ndarray

    @property
    def shape(self):
        return self.hi.shape

    def astuple(self):
        return self.hi, self.lo


def const(value: int, shape=()) -> U64Pair:
    hi = jnp.full(shape, (value >> 32) & _MASK32, dtype=_U32)
    lo = jnp.full(shape, value & _MASK32, dtype=_U32)
    return U64Pair(hi, lo)


def from_u32(lo: jnp.ndarray) -> U64Pair:
    return U64Pair(jnp.zeros_like(lo, dtype=_U32), lo.astype(_U32))


def full_like(x: U64Pair, value: int) -> U64Pair:
    return U64Pair(
        jnp.full_like(x.hi, (value >> 32) & _MASK32),
        jnp.full_like(x.lo, value & _MASK32),
    )


UMAX = 0xFFFFFFFFFFFFFFFF


def add(a: U64Pair, b: U64Pair) -> U64Pair:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(_U32)
    return U64Pair(a.hi + b.hi + carry, lo)


def add_u32(a: U64Pair, b: jnp.ndarray) -> U64Pair:
    b = b.astype(_U32)
    lo = a.lo + b
    carry = (lo < b).astype(_U32)
    return U64Pair(a.hi + carry, lo)


def sub_u32(a: U64Pair, b: jnp.ndarray) -> U64Pair:
    """a - b for a 32-bit b (wrapping, like Rust u64 arithmetic)."""
    b = b.astype(_U32)
    lo = a.lo - b
    borrow = (a.lo < b).astype(_U32)
    return U64Pair(a.hi - borrow, lo)


def sub_u32_sat(a: U64Pair, b: jnp.ndarray) -> U64Pair:
    """max(a - b, 0) for a 32-bit b (saturating at zero)."""
    b = b.astype(_U32)
    neg = (a.hi == 0) & (a.lo < b)
    lo = a.lo - b
    borrow = (a.lo < b).astype(_U32)
    return U64Pair(
        jnp.where(neg, _U32(0), a.hi - borrow),
        jnp.where(neg, _U32(0), lo),
    )


def xor(a: U64Pair, b: U64Pair) -> U64Pair:
    return U64Pair(a.hi ^ b.hi, a.lo ^ b.lo)


def and_(a: U64Pair, b: U64Pair) -> U64Pair:
    return U64Pair(a.hi & b.hi, a.lo & b.lo)


def or_(a: U64Pair, b: U64Pair) -> U64Pair:
    return U64Pair(a.hi | b.hi, a.lo | b.lo)


def not_(a: U64Pair) -> U64Pair:
    return U64Pair(~a.hi, ~a.lo)


def and_const(a: U64Pair, value: int) -> U64Pair:
    return U64Pair(
        a.hi & _U32((value >> 32) & _MASK32),
        a.lo & _U32(value & _MASK32),
    )


def or_const(a: U64Pair, value: int) -> U64Pair:
    return U64Pair(
        a.hi | _U32((value >> 32) & _MASK32),
        a.lo | _U32(value & _MASK32),
    )


def shl(a: U64Pair, s: int) -> U64Pair:
    """Left shift by a static amount 0..63."""
    if s == 0:
        return a
    if s >= 32:
        return U64Pair(a.lo << _U32(s - 32) if s > 32 else a.lo, jnp.zeros_like(a.lo))
    return U64Pair((a.hi << _U32(s)) | (a.lo >> _U32(32 - s)), a.lo << _U32(s))


def shr(a: U64Pair, s: int) -> U64Pair:
    """Logical right shift by a static amount 0..63."""
    if s == 0:
        return a
    if s >= 32:
        return U64Pair(jnp.zeros_like(a.hi), a.hi >> _U32(s - 32) if s > 32 else a.hi)
    return U64Pair(a.hi >> _U32(s), (a.lo >> _U32(s)) | (a.hi << _U32(32 - s)))


def eq(a: U64Pair, b: U64Pair) -> jnp.ndarray:
    return (a.hi == b.hi) & (a.lo == b.lo)


def lt(a: U64Pair, b: U64Pair) -> jnp.ndarray:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def le(a: U64Pair, b: U64Pair) -> jnp.ndarray:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo <= b.lo))


def gt(a: U64Pair, b: U64Pair) -> jnp.ndarray:
    return lt(b, a)


def where(cond: jnp.ndarray, a: U64Pair, b: U64Pair) -> U64Pair:
    return U64Pair(jnp.where(cond, a.hi, b.hi), jnp.where(cond, a.lo, b.lo))


def min_(a: U64Pair, b: U64Pair) -> U64Pair:
    return where(le(a, b), a, b)


def hash64(key: U64Pair, mask: int) -> U64Pair:
    """The invertible finalizer (sketch.rs:4-13) on uint32 pairs."""
    key = and_const(add(not_(key), shl(key, 21)), mask)
    key = xor(key, shr(key, 24))
    key = and_const(add(add(key, shl(key, 3)), shl(key, 8)), mask)
    key = xor(key, shr(key, 14))
    key = and_const(add(add(key, shl(key, 2)), shl(key, 4)), mask)
    key = xor(key, shr(key, 28))
    key = and_const(add(key, shl(key, 31)), mask)
    return key
