"""Device seeding: query-occurrence filter, index lookup, masked anchor
expansion, and the global per-read anchor sort.

Replaces the reference's per-minimizer loop + Vec push + sort
(/root/reference/src/seeds.rs:13-60) with fixed-shape batched ops:
ragged occurrence lists become a prefix-sum + binary-search expansion
into a padded (B, A_max) anchor tensor, sorted per read with a single
4-key lexicographic lax.sort.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import u64
from .index_ops import DeviceIndex, index_lookup
from .u64 import U64Pair

I32 = jnp.int32
U32 = jnp.uint32
INVALID_XHI = 0xFFFFFFFF  # python literal (see chain_ops note)


def sort_minimizers_by_key(ks: U64Pair, ps: jnp.ndarray):
    """Per-read sort of minimizer slots by key pair (padding U64-max goes
    last)."""
    kh, kl, ps2 = jax.lax.sort((ks.hi, ks.lo, ps), dimension=-1, num_keys=2)
    return U64Pair(kh, kl), ps2


def query_occ_filter(
    ks: U64Pair,  # (B, M) key_span pairs, key-sorted per read
    n_mini: jnp.ndarray,  # (B,)
    q_occ_max: int,
    q_occ_frac: float,
):
    """Mask of minimizers surviving the query-frequency filter
    (seeds.rs:13-36): drop keys whose per-read count exceeds both
    q_occ_max and floor(n * q_occ_frac); no-op when n <= q_occ_max.

    ks must be key-sorted per read; counts come from two vmapped binary
    searches of each row into itself."""
    B, M = ks.hi.shape
    keys = u64.shr(ks, 8)
    # per-key counts on the sorted rows via run-length arithmetic (no
    # binary search — cumulative ops only):
    #   count[i] = last_index_of_run(i) - first_index_of_run(i) + 1
    idx = jnp.broadcast_to(jnp.arange(M, dtype=I32), (B, M))
    prev = u64.U64Pair(
        jnp.concatenate([jnp.zeros((B, 1), jnp.uint32), keys.hi[:, :-1]], axis=1),
        jnp.concatenate([jnp.zeros((B, 1), jnp.uint32), keys.lo[:, :-1]], axis=1),
    )
    boundary = ~u64.eq(keys, prev)
    boundary = boundary.at[:, 0].set(True)
    first = jax.lax.cummax(jnp.where(boundary, idx, I32(-1)), axis=1)
    nxt_boundary = jnp.concatenate(
        [boundary[:, 1:], jnp.ones((B, 1), bool)], axis=1
    )
    INF = I32(2**30)
    last = jnp.flip(
        jax.lax.cummin(jnp.flip(jnp.where(nxt_boundary, idx, INF), axis=1), axis=1),
        axis=1,
    )
    counts = last - first + 1
    cutoff = (n_mini.astype(jnp.float32) * q_occ_frac).astype(I32)
    drop = (counts > q_occ_max) & (counts > cutoff[:, None])
    drop = drop & (n_mini[:, None] > q_occ_max)
    slot = jnp.arange(M, dtype=I32)[None, :]
    valid = slot < n_mini[:, None]
    return valid & ~drop


@functools.partial(jax.jit, static_argnames=("max_anchors",))
def build_anchors_device(
    idx: DeviceIndex,
    ks: U64Pair,          # (B, M) key_span pairs, key-sorted per read
    ps: jnp.ndarray,      # (B, M) query pos<<1|strand
    keep: jnp.ndarray,    # (B, M) bool survivor mask
    qlen: jnp.ndarray,    # (B,) query lengths
    mid_occ: jnp.ndarray, # scalar int32 repetitive cutoff
    max_anchors: int,
):
    """Lookup + masked expansion + sort (seeds.rs:42-79).

    Returns anchor tensors x_hi/x_lo/y_hi/y_lo (B, A) uint32 (padding
    sorts to the end with x_hi = 0xFFFFFFFF), n_anchors (B,), overflow
    (B,) bool."""
    B, M = ks.hi.shape
    keys = u64.shr(ks, 8)
    # padding/filtered slots all probe key 0: their binary-search paths
    # converge to identical HBM addresses instead of random walks (counts
    # are masked below, so a coincidental hit is harmless)
    keys = u64.where(keep, keys, u64.U64Pair(jnp.zeros_like(keys.hi), jnp.zeros_like(keys.lo)))
    start, count = index_lookup(idx, keys)
    # skip over-frequent target keys; singletons always kept
    # (seeds.rs:48-53: only Multi blocks are compared against mid_occ)
    count = jnp.where((count > 1) & (count > mid_occ), 0, count)
    count = jnp.where(keep, count, 0)

    cum = jnp.cumsum(count, axis=1)
    total = cum[:, -1]
    n_anchors = jnp.minimum(total, max_anchors)

    # anchor slot a -> minimizer payload (the segmented expansion), as
    # three monotone routing passes (ops/route.py) instead of two
    # full-width lax.sorts:
    #   1. compact the non-empty runs to the front (stable, so run
    #      heads keep increasing anchor-slot destinations cum_prev),
    #   2. spread each run head RIGHT to its first anchor slot — after
    #      compaction delta_k = cum_prev_k - k is non-decreasing
    #      (each kept run contributes count >= 1), the monotone-spread
    #      precondition; runs past capacity clamp to delta=A and land
    #      in the discard margin [A, A+M),
    #   3. forward-fill payloads through each run (log-step carry).
    # Two packed columns carry everything downstream:
    #   d0 = start - cum_prev      (position-table row minus slot base)
    #   d1 = span << 23 | pos<<1|strand  (pos < 2^22: reads bucket to
    #        <= 4M bases — guarded below; span < 256, so 255<<23 < 2^31
    #        keeps d1 a valid non-negative int32)
    from .route import compact_left, spread_right

    a_idx = jnp.arange(max_anchors, dtype=I32)[None, :]
    cum_prev = cum - count
    has = count > 0
    bc = lambda a: jax.lax.bitcast_convert_type(a, I32)
    d0 = start - cum_prev
    d1 = (bc(ks.lo & U32(0xFF)) << 23) | bc(ps & U32(0x7FFFFF))
    (c_dest, c_d0, c_d1), c_live = compact_left(
        (cum_prev, d0, d1), has, fills=(I32(0), I32(0), I32(0))
    )
    k_idx = jnp.arange(M, dtype=I32)[None, :]
    delta = jnp.where(c_live, jnp.minimum(c_dest - k_idx, max_anchors), 0)
    Wm = M + max_anchors
    pad = ((0, 0), (0, Wm - M))
    (s_d0, s_d1), s_live = spread_right(
        (jnp.pad(c_d0, pad), jnp.pad(c_d1, pad)),
        jnp.pad(c_live, pad),
        jnp.pad(delta, pad),
        fills=(I32(0), I32(0)),
        max_delta=max_anchors,
    )
    f_k = jnp.where(s_live[:, :max_anchors], a_idx, I32(-1))
    f0 = s_d0[:, :max_anchors]
    f1 = s_d1[:, :max_anchors]
    step = 1
    while step < max_anchors:
        sh = lambda a, fill: jnp.concatenate(
            [jnp.full((B, step), fill, a.dtype), a[:, :-step]], axis=1
        )
        pk = sh(f_k, -1)
        take = pk > f_k
        f_k = jnp.where(take, pk, f_k)
        f0 = jnp.where(take, sh(f0, 0), f0)
        f1 = jnp.where(take, sh(f1, 0), f1)
        step <<= 1
    g0, g1 = f0, f1

    valid = a_idx < n_anchors[:, None]
    p_idx = jnp.where(valid, g0 + a_idx, 0)
    p_idx = jnp.clip(p_idx, 0, idx.pos.shape[1] - 1)
    if idx.pos_packed:
        # ONE plane gather of abs_pos<<1|strand; rid and the bucket base
        # are recovered by an n_seq-step fused compare chain against the
        # cumulative lengths — no second gather
        w = idx.pos[0][p_idx]
        absp = w >> U32(1)
        r_hi = jnp.zeros_like(w)   # rid
        cbase = jnp.zeros_like(w)  # seq_cum[rid]
        for j in range(1, idx.n_seq):
            cj = idx.seq_cum[j]
            in_j = absp >= cj
            r_hi = r_hi + in_j.astype(U32)
            cbase = jnp.where(in_j, cj, cbase)
        r_lo = ((absp - cbase) << U32(1)) | (w & U32(1))
    else:
        # two plane gathers on the (2, P) position table: 1-D gathers
        # keep the table in its stored layout (a (P, 2) row gather made
        # XLA re-lay-out the whole table column-major on every call)
        r_hi = idx.pos[0][p_idx]  # rid
        r_lo = idx.pos[1][p_idx]  # rpos<<1|rstrand

    ps_m = jax.lax.bitcast_convert_type(g1 & I32(0x7FFFFF), U32)
    span = jax.lax.bitcast_convert_type(g1 >> 23, U32)
    qpos = ps_m >> U32(1)
    qstrand = ps_m & U32(1)
    rpos = r_lo >> U32(1)
    rstrand = r_lo & U32(1)
    forward = rstrand == qstrand

    x_hi = jnp.where(forward, r_hi, r_hi | U32(0x80000000))
    x_lo = rpos
    qlen_u = qlen.astype(U32)[:, None]
    y_lo_fwd = qpos
    y_lo_rev = qlen_u - (qpos + U32(1) - span) - U32(1)
    y_lo = jnp.where(forward, y_lo_fwd, y_lo_rev)
    y_hi = span

    x_hi = jnp.where(valid, x_hi, U32(INVALID_XHI))
    x_lo = jnp.where(valid, x_lo, U32(0xFFFFFFFF))
    # pack (span, qpos') into one sort key: qpos' < 2^24 always (reads are
    # bucketed to <= 2^22 bases, enforced by Mapper), so span<<24 | qpos'
    # preserves the reference's (y_hi, y_lo) lexicographic order with one
    # fewer operand
    y_packed = (y_hi << U32(24)) | y_lo
    y_packed = jnp.where(valid, y_packed, U32(0xFFFFFFFF))

    x_hi, x_lo, y_packed = jax.lax.sort(
        (x_hi, x_lo, y_packed), dimension=-1, num_keys=3
    )
    y_hi = jnp.where(x_hi != U32(INVALID_XHI), y_packed >> U32(24), U32(0xFFFFFFFF))
    y_lo = jnp.where(x_hi != U32(INVALID_XHI), y_packed & U32(0xFFFFFF), U32(0xFFFFFFFF))
    return x_hi, x_lo, y_hi, y_lo, n_anchors, total > max_anchors
