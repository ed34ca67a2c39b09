"""Exact reference-order sketch as a device scan — the even-k path.

Even k admits strand-symmetric k-mers, which pause the reference scan's
`l` counter (/root/reference/src/sketch.rs:67-69). The window-min SET
characterization (ops/sketch.py) relies on window-completion steps being
unique per run, which the pause breaks, so it is exact for odd k only.
This module instead transcribes the scan's window/emission recurrence
into a `lax.scan` over positions, vectorized over the read batch:

- everything per-POSITION is still computed vectorially up front
  (registers, l counter, spans, hashes) — including the reference's
  stale-register semantics across N resets (the registers are never
  cleared at an N, sketch.rs:76-78, so the k-mer at a warm-up position
  mixes pre- and post-reset bases; the strand-symmetry test on that
  stale content gates the l counter, which is parity-relevant for
  even k). That is reproduced by rolling the k-mers over the
  N-compacted sequence and gathering back.
- the sequential part carried through the scan is only the reference's
  w-slot ring buffer + tracked minimum (sketch.rs:80-96); each step is
  a handful of masked (B, w) elementwise ops.
- emissions are reported per step as (ring-slot mask, tracked-min
  distance) and reassembled into the (B, L) `emitted` mask afterwards
  with w bounded shifted-ORs — the slot j of step i always holds
  position i - ((i - j) mod w), and the tracked minimum always lies
  within [i-w, i].

The output contract matches ops/sketch.sketch_positions exactly, so the
rest of the pipeline (compaction, lookup, chaining) is unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import u64
from .sketch import _shift_left, _shift_right

I32 = jnp.int32
U32 = jnp.uint32
_INV_PS = 0xFFFFFFFF


def _kmer_info_even(codes, lengths, k: int, is_hpc: bool):
    """Per-position (key_span: U64Pair, pos_strand, l_eff, valid) with the
    reference's even-k register semantics: rolling k-mers over the
    N-compacted sequence (so post-reset registers keep stale pre-reset
    bases, sketch.rs:65-66), symmetric k-mers pause l (sketch.rs:67-69).
    """
    from .route import compact_left
    from .sketch import kmer_keys

    B, L = codes.shape
    codes = codes.astype(I32)
    idx = jnp.broadcast_to(jnp.arange(L, dtype=I32), (B, L))
    in_range = idx < lengths[:, None]
    is_base = (codes < 4) & in_range

    # registers over the N-compacted base stream, gathered back to the
    # original positions (a (B, L) row gather — acceptable on the
    # even-k-only path)
    (comp_codes,), _ = compact_left((codes,), is_base, fills=(I32(0),))
    canon_c, strand_c, sym_c = kmer_keys(comp_codes, k)
    rank = jnp.cumsum(is_base.astype(I32), axis=1) - 1
    g = lambda a: jnp.take_along_axis(a, jnp.maximum(rank, 0), axis=1)
    canon = u64.U64Pair(g(canon_c.hi), g(canon_c.lo))
    strand = g(strand_c.astype(I32)).astype(bool)
    sym = g(sym_c.astype(I32)).astype(bool) & is_base

    last_bad = jax.lax.cummax(jnp.where(~is_base, idx, I32(-1)), axis=1)
    inc = (is_base & ~sym).astype(I32)
    cs = jnp.cumsum(inc, axis=1)
    cs_at_bad = jnp.maximum(
        jax.lax.cummax(jnp.where(~is_base, cs, I32(-1)), axis=1), 0
    )
    l_eff = jnp.where(is_base, cs - cs_at_bad, 0)

    if is_hpc:
        nxt = _shift_left(codes, 1, I32(4))
        boundary = (codes != nxt) | ~is_base
        INF = I32(2**30)
        bpos = jnp.where(boundary, idx, INF)
        next_boundary = jnp.flip(
            jax.lax.cummin(jnp.flip(bpos, axis=1), axis=1), axis=1
        )
        skip_len = jnp.where(is_base, next_boundary - idx + 1, 0)
        css = jnp.cumsum(skip_len, axis=1)
        cand_k = _shift_right(css, k, I32(-1))
        cand_bad = jax.lax.cummax(jnp.where(~is_base, css, I32(-1)), axis=1)
        css_lo = jnp.maximum(jnp.maximum(cand_k, cand_bad), 0)
        kspan = css - css_lo
    else:
        kspan = jnp.minimum(idx - last_bad, k)

    valid = is_base & ~sym & (l_eff >= k) & (kspan < 256)
    key = u64.hash64(canon, (1 << (2 * k)) - 1)
    ks = u64.or_(
        u64.shl(key, 8),
        u64.U64Pair(jnp.zeros_like(key.hi), kspan.astype(U32)),
    )
    ks = u64.where(valid, ks, u64.full_like(ks, u64.UMAX))
    ps = (idx.astype(U32) << U32(1)) | strand.astype(U32)
    ps = jnp.where(valid, ps, U32(_INV_PS))
    return ks, ps, l_eff


@functools.partial(jax.jit, static_argnames=("w", "k"))
def _window_scan(ks, ps, l_eff, lengths, w: int, k: int, emit_final):
    """The sequential window recurrence (sketch.rs:80-96), exact."""
    B, L = ps.shape
    UM = u64.full_like(u64.U64Pair(jnp.zeros((B,), U32), jnp.zeros((B,), U32)), u64.UMAX)

    xs = (
        jnp.swapaxes(ks.hi, 0, 1), jnp.swapaxes(ks.lo, 0, 1),
        jnp.swapaxes(ps, 0, 1), jnp.swapaxes(l_eff, 0, 1),
        jnp.arange(L, dtype=I32),
    )
    slot_ids = jnp.broadcast_to(jnp.arange(w, dtype=I32), (B, w))

    def step(carry, x):
        buf_hi, buf_lo, buf_y, mn_hi, mn_lo, mn_y, min_pos = carry
        ih, il, iy, l, i = x
        bp = jnp.mod(i, w)  # buf_pos is data-independent
        # buf[buf_pos] = info
        at_bp = slot_ids == bp
        buf_hi = jnp.where(at_bp, ih[:, None], buf_hi)
        buf_lo = jnp.where(at_bp, il[:, None], buf_lo)
        buf_y = jnp.where(at_bp, iy[:, None], buf_y)
        buf_x = u64.U64Pair(buf_hi, buf_lo)
        mn = u64.U64Pair(mn_hi, mn_lo)
        info = u64.U64Pair(ih, il)
        mn_valid = ~u64.eq(mn, UM)

        # slot ages: slot j holds position i - ((i - j) mod w)
        age = jnp.mod(bp[None, None] - slot_ids, w)  # (B, w), age of slot
        emit_slots = jnp.zeros((B, w), bool)

        # first-full-window tie emission (sketch.rs:81-82): every tie of
        # the tracked min in the PREVIOUS buffer (slot != buf_pos)
        condA = (l == (w + k - 1)) & mn_valid
        tie = u64.eq(buf_x, u64.U64Pair(mn_hi[:, None], mn_lo[:, None])) & (
            buf_y != mn_y[:, None]
        ) & ~at_bp
        emit_slots |= condA[:, None] & tie

        # branch select (sketch.rs:84-96)
        le = u64.le(info, mn)  # info.x <= mn.x (U64 sentinels included)
        emit_mn_B = le & (l >= (w + k)) & mn_valid
        slide = ~le & (bp == min_pos)
        emit_mn_C = slide & (l >= (w + k - 1)) & mn_valid
        emit_mn = emit_mn_B | emit_mn_C
        old_mn_y = mn_y

        # rescan after the min slid out: min over all w slots, ties to
        # the NEWEST position (the circular loop ends at buf_pos)
        pos_of_slot = i - age  # (B, w) absolute positions
        # two-word min: reduce via sort-free pairwise fold over w slots
        bh, bl = buf_hi[:, 0], buf_lo[:, 0]
        bpos_best = pos_of_slot[:, 0]
        by = buf_y[:, 0]
        for j in range(1, w):
            cand = u64.U64Pair(buf_hi[:, j], buf_lo[:, j])
            cur = u64.U64Pair(bh, bl)
            # cand wins when strictly smaller, or tied and newer
            cw = u64.lt(cand, cur) | (
                u64.eq(cand, cur) & (pos_of_slot[:, j] > bpos_best)
            )
            bh = jnp.where(cw, cand.hi, bh)
            bl = jnp.where(cw, cand.lo, bl)
            by = jnp.where(cw, buf_y[:, j], by)
            bpos_best = jnp.where(cw, pos_of_slot[:, j], bpos_best)
        new_mn = u64.U64Pair(bh, bl)
        new_valid = ~u64.eq(new_mn, UM)
        # post-rescan tie emission (sketch.rs:92-96): all slots tied with
        # the new min except the new min itself
        tie2 = u64.eq(buf_x, u64.U64Pair(bh[:, None], bl[:, None])) & (
            buf_y != by[:, None]
        )
        emit_slots |= (slide & (l >= (w + k - 1)) & new_valid)[:, None] & tie2

        # state updates
        take_info = le
        mn_hi = jnp.where(take_info, ih, jnp.where(slide, bh, mn_hi))
        mn_lo = jnp.where(take_info, il, jnp.where(slide, bl, mn_lo))
        mn_y = jnp.where(take_info, iy, jnp.where(slide, by, mn_y))
        new_min_slot = jnp.mod(bpos_best, w)
        min_pos = jnp.where(
            take_info, bp, jnp.where(slide, new_min_slot, min_pos)
        )
        mn_valid_after = ~u64.eq(u64.U64Pair(mn_hi, mn_lo), UM)

        carry = (buf_hi, buf_lo, buf_y, mn_hi, mn_lo, mn_y, min_pos)
        ys = (emit_slots, emit_mn, i - (old_mn_y >> U32(1)).astype(I32),
              mn_valid_after, mn_y)
        return carry, ys

    init = (
        jnp.full((B, w), 0xFFFFFFFF, U32), jnp.full((B, w), 0xFFFFFFFF, U32),
        jnp.full((B, w), _INV_PS, U32),
        jnp.full((B,), 0xFFFFFFFF, U32), jnp.full((B,), 0xFFFFFFFF, U32),
        jnp.full((B,), _INV_PS, U32), jnp.zeros((B,), I32),
    )
    _, (emit_slots, emit_mn, mn_dist, mn_valid_t, mn_y_t) = jax.lax.scan(
        step, init, xs
    )

    # ---- reassemble the (B, L) emitted mask -------------------------
    emitted = jnp.zeros((B, L), bool)
    iota_L = jnp.arange(L, dtype=I32)
    # ring-slot emissions: slot j of step i is position i - d where
    # d = (i - j) mod w; equivalently for each d, pick slot (i - d) mod w
    for d in range(min(w, L)):
        j_of_i = jnp.mod(iota_L - d, w)  # (L,)
        sel = jnp.take_along_axis(
            emit_slots, j_of_i[:, None, None], axis=2
        )[:, :, 0]  # (L, B)
        if d == 0:
            emitted |= sel.T
        else:
            emitted = emitted.at[:, : L - d].max(sel[d:].T)
    # tracked-min emissions: distance to the emitted copy is in [0, w]
    for d in range(min(w + 1, L)):
        sel = emit_mn & (mn_dist == d)  # (L, B)
        if d == 0:
            emitted |= sel.T
        else:
            emitted = emitted.at[:, : L - d].max(sel[d:].T)

    # final flush (sketch.rs:99) at each read's true end
    rows = jnp.arange(B, dtype=I32)
    last = jnp.maximum(lengths - 1, 0)
    fin_valid = jnp.take_along_axis(mn_valid_t, last[None, :], axis=0)[0]
    fin_valid = fin_valid & (lengths > 0)
    if emit_final is not None:
        fin_valid = fin_valid & emit_final
    fin_y = jnp.take_along_axis(mn_y_t, last[None, :], axis=0)[0]
    fin_pos = (fin_y >> U32(1)).astype(I32)
    emitted = emitted.at[rows, jnp.where(fin_valid, fin_pos, 0)].max(fin_valid)
    return emitted


@functools.partial(jax.jit, static_argnames=("w", "k", "is_hpc"))
def sketch_positions_exact(
    codes: jnp.ndarray,   # (B, L) int32 nt4 codes, padded with 4
    lengths: jnp.ndarray,  # (B,) int32 true lengths
    w: int,
    k: int,
    is_hpc: bool = False,
    emit_final: jnp.ndarray | None = None,
):
    """sketch_positions contract via the exact scan recurrence — valid
    for ANY k (used in production for even k; odd k keeps the cheaper
    characterization)."""
    ks, ps, l_eff = _kmer_info_even(codes, lengths, k, is_hpc)
    emitted = _window_scan(ks, ps, l_eff, lengths, w, k, emit_final)
    # padding slots must stay inert downstream
    emitted = emitted & (ps != U32(_INV_PS))
    return ks, ps, emitted
