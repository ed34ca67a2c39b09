"""Monotone routing networks: O(log L) masked-shift compaction/spread.

Stream compaction ("pack emitted entries to the front, stable") is the
innermost data-movement primitive of this pipeline: minimizer emission
(sketch.rs:80-96 emits sparsely along the read) and anchor expansion
(seeds.rs:42-60 repeats each minimizer `count` times) both need it.
Instead of a full-width lax.sort, this module does the same movement in
ceil(log2 L) masked shift passes using a classic SIMD
concentration-network result (whether a GPU sort is faster is an open
measurement):

    For a stable compaction, element i moves LEFT by
    delta_i = (# unset slots before i), which is NON-DECREASING in i.
    Routing LSB-first (move by 2^b at stage b iff bit b of delta_i is
    set) is collision-free for any monotone non-decreasing delta.

Because every element moves by exactly its original delta (the sum of
its set bits), delta itself rides along as payload and is never
recomputed. The mirrored statement holds for spreading RIGHT by a
non-decreasing delta (used by the anchor expansion after pre-compacting
the non-empty runs, which makes its deltas monotone).

Both properties are fuzz-validated against numpy oracles in
tests/test_route.py.
"""

from __future__ import annotations

import jax.numpy as jnp

I32 = jnp.int32


def _shl(a: jnp.ndarray, s: int, fill) -> jnp.ndarray:
    """Shift toward LOWER indices along the last axis (a[p] = a[p+s])."""
    pad = jnp.full(a.shape[:-1] + (s,), fill, dtype=a.dtype)
    return jnp.concatenate([a[..., s:], pad], axis=-1)


def _shr(a: jnp.ndarray, s: int, fill) -> jnp.ndarray:
    """Shift toward HIGHER indices along the last axis (a[p] = a[p-s]).
    s >= L drops everything (entries routed past the end)."""
    if s >= a.shape[-1]:
        return jnp.full_like(a, fill)
    pad = jnp.full(a.shape[:-1] + (s,), fill, dtype=a.dtype)
    return jnp.concatenate([pad, a[..., :-s]], axis=-1)


def compact_left(
    payloads: tuple[jnp.ndarray, ...],
    mask: jnp.ndarray,
    fills: tuple | None = None,
) -> tuple[tuple[jnp.ndarray, ...], jnp.ndarray]:
    """Stable-compact masked entries of each (..., L) payload to the
    front. Returns (compacted payloads, live mask). Slots past the
    compacted prefix hold `fills` (default: dtype max for unsigned,
    -1-ish via ~0 for signed)."""
    L = mask.shape[-1]
    if fills is None:
        fills = tuple(
            a.dtype.type(0xFFFFFFFF) if a.dtype == jnp.uint32 else a.dtype.type(-1)
            for a in payloads
        )
    notm = (~mask).astype(I32)
    delta = jnp.cumsum(notm, axis=-1) - notm  # unset slots strictly before i
    live = mask
    arrs = list(payloads) + [delta]
    b = 0
    # at least one pass even for L == 1: the b=0 pass is what writes the
    # documented fills into dead slots
    while (1 << b) < L or b == 0:
        s = 1 << b
        move = live & (((arrs[-1] >> b) & 1) == 1)
        inc = _shl(move, s, False)
        keep = live & ~move
        arrs = [
            jnp.where(inc, _shl(a, s, f), jnp.where(keep, a, f))
            for a, f in zip(arrs, list(fills) + [I32(0)])
        ]
        live = inc | keep
        b += 1
    return tuple(arrs[:-1]), live


def spread_right(
    payloads: tuple[jnp.ndarray, ...],
    live: jnp.ndarray,
    delta: jnp.ndarray,
    fills: tuple | None = None,
    max_delta: int | None = None,
) -> tuple[tuple[jnp.ndarray, ...], jnp.ndarray]:
    """Move live entry at slot i RIGHT by delta_i (non-decreasing over
    live slots; entries must not cross). Mirrored form of compact_left;
    entries routed past the end fall off. max_delta (static) bounds the
    largest delta so stage shifts >= L can still drop far entries.
    Returns (payloads, live)."""
    L = live.shape[-1]
    hi = max(L, (max_delta if max_delta is not None else L - 1) + 1)
    if fills is None:
        fills = tuple(
            a.dtype.type(0xFFFFFFFF) if a.dtype == jnp.uint32 else a.dtype.type(-1)
            for a in payloads
        )
    arrs = list(payloads) + [delta]
    # The spread is the INVERSE permutation of a compaction (gather vs
    # scatter): invert the LSB-first compaction network by running its
    # stages in reverse, i.e. MSB-first.
    nbits = 0
    while (1 << nbits) < hi:
        nbits += 1
    nbits = max(nbits, 1)  # >= one pass so dead slots get the fills
    for b in reversed(range(nbits)):
        s = 1 << b
        move = live & (((arrs[-1] >> b) & 1) == 1)
        inc = _shr(move, s, False)
        keep = live & ~move
        arrs = [
            jnp.where(inc, _shr(a, s, f), jnp.where(keep, a, f))
            for a, f in zip(arrs, list(fills) + [I32(0)])
        ]
        live = inc | keep
    return tuple(arrs[:-1]), live
