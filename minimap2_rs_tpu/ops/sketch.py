"""Batched device sketch kernel (JAX, fully vectorized — no sequential
scan over positions).

This is the data-parallel formulation of the reference's per-base scan
(/root/reference/src/sketch.rs:29-100), derived and fuzz-validated in
oracle/sketch.py: per-position k-mer construction by log-step span
doubling, hash64 on uint32 pairs, window-minimum marking over complete
windows, plus the three exactness rules (completion-step tie handling,
run-end drops, final emission). Everything is masked elementwise work on
(B, L) arrays — XLA fuses it into a handful of elementwise passes.

Inputs are nt4 codes padded with 4 (ambiguous) to a static length; true
lengths are passed separately so the final-emission rule fires at each
read's real end rather than at the padding boundary.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import u64

I32 = jnp.int32
U32 = jnp.uint32


def _shift_right(a: jnp.ndarray, t: int, fill) -> jnp.ndarray:
    """a shifted toward higher indices by t along the last axis."""
    if t == 0:
        return a
    if t >= a.shape[-1]:
        return jnp.full_like(a, fill)
    pad = jnp.full(a.shape[:-1] + (t,), fill, dtype=a.dtype)
    return jnp.concatenate([pad, a[..., :-t]], axis=-1)


def _shift_right_u64(a: u64.U64Pair, t: int, fill: int) -> u64.U64Pair:
    return u64.U64Pair(
        _shift_right(a.hi, t, U32((fill >> 32) & 0xFFFFFFFF)),
        _shift_right(a.lo, t, U32(fill & 0xFFFFFFFF)),
    )


def _shift_left(a: jnp.ndarray, t: int, fill) -> jnp.ndarray:
    if t == 0:
        return a
    if t >= a.shape[-1]:
        return jnp.full_like(a, fill)
    pad = jnp.full(a.shape[:-1] + (t,), fill, dtype=a.dtype)
    return jnp.concatenate([a[..., t:], pad], axis=-1)


def _hash64_u32(key: jnp.ndarray, mask: int) -> jnp.ndarray:
    """hash64 (sketch.rs:4-13) computed entirely in uint32, valid when
    mask < 2^32: every +/<< is followed by & mask, and arithmetic mod
    2^32 then mod 2^(2k) equals arithmetic mod 2^(2k)."""
    m = U32(mask)
    key = (~key + (key << U32(21))) & m
    key = key ^ (key >> U32(24))
    key = (key + (key << U32(3)) + (key << U32(8))) & m
    key = key ^ (key >> U32(14))
    key = (key + (key << U32(2)) + (key << U32(4))) & m
    key = key ^ (key >> U32(28))
    key = (key + (key << U32(31))) & m
    return key


def kmer_keys32(codes: jnp.ndarray, k: int):
    """kmer_keys for 2k <= 31: the whole canonical k-mer fits one uint32
    lane, halving (or better) every sketch-kernel pass vs the u64-pair
    formulation. Same span-doubling recurrences."""
    is_base = codes < 4
    c = jnp.where(is_base, codes, 0).astype(U32)
    fwd = c
    rev = U32(3) ^ c
    s = 1
    while s < k:
        t = min(s, k - s)
        fwd_prev = _shift_right(fwd, t, U32(0))
        rev_prev = _shift_right(rev, t, U32(0))
        fwd = (fwd_prev << U32(2 * t)) | (fwd & U32((1 << (2 * t)) - 1))
        rev = ((rev >> U32(2 * (s - t))) << U32(2 * s)) | rev_prev
        s += t
    mask = U32((1 << (2 * k)) - 1)
    fwd = fwd & mask
    rev = rev & mask
    sym = fwd == rev
    strand = rev < fwd
    canon = jnp.where(strand, rev, fwd)
    return canon, strand, sym


_INV32 = 0xFFFFFFFF  # invalid-key sentinel; real keys < 2^31 when 2k <= 31


def window_fold_min32(kv: jnp.ndarray, idx: jnp.ndarray, w: int):
    """window_fold_min on uint32 comparison keys (non-HPC spans are all
    exactly k, so comparing the bare hashed key preserves the reference's
    (key<<8|span) ordering)."""
    wmin, widx = kv, idx
    span = 1
    while span < w:
        step = min(span, w - span)
        sh = _shift_right(wmin, step, U32(_INV32))
        sh_idx = _shift_right(widx, step, I32(-1))
        better = sh < wmin
        wmin = jnp.where(better, sh, wmin)
        widx = jnp.where(better, sh_idx, widx)
        span += step
    return wmin, widx


def kmer_keys(codes: jnp.ndarray, k: int):
    """Per-position canonical k-mer as uint32 pairs + strand, via span
    doubling:
      fwd_{s+t}[i] = (fwd_s[i-t] << 2t) | (fwd_s[i] & (4^t-1))
      rev_{s+t}[i] = ((rev_s[i] >> 2(s-t)) << 2s) | rev_s[i-t]
    Returns (canon: U64Pair, strand: bool(B,L), sym: bool(B,L))."""
    is_base = codes < 4
    c = jnp.where(is_base, codes, 0).astype(U32)
    fwd = u64.U64Pair(jnp.zeros_like(c), c)
    rev = u64.U64Pair(jnp.zeros_like(c), U32(3) ^ c)
    s = 1
    while s < k:
        t = min(s, k - s)
        fwd_prev = _shift_right_u64(fwd, t, 0)
        rev_prev = _shift_right_u64(rev, t, 0)
        fwd = u64.or_(u64.shl(fwd_prev, 2 * t), u64.and_const(fwd, (1 << (2 * t)) - 1))
        rev = u64.or_(u64.shl(u64.shr(rev, 2 * (s - t)), 2 * s), rev_prev)
        s += t
    mask = (1 << (2 * k)) - 1
    fwd = u64.and_const(fwd, mask)
    rev = u64.and_const(rev, mask)
    sym = u64.eq(fwd, rev)
    strand = u64.lt(rev, fwd)  # z = 1 when rev kmer is canonical
    canon = u64.where(strand, rev, fwd)
    return canon, strand, sym


def window_fold_min(ks: u64.U64Pair, idx: jnp.ndarray, w: int):
    """Windowed (min key, newest tied index) over windows of w ending at
    each position, by log-step folding. Comparator: smaller key wins; on
    ties the larger (newer) index wins — matching the scan's tracked-min
    identity (sketch.rs:84-96)."""
    wmin, widx = ks, idx
    span = 1
    while span < w:
        step = min(span, w - span)
        sh = _shift_right_u64(wmin, step, u64.UMAX)
        sh_idx = _shift_right(widx, step, I32(-1))
        better = u64.lt(sh, wmin)  # strictly smaller older-window key wins
        # ties: wmin (the newer window) keeps priority — newest tie
        wmin = u64.where(better, sh, wmin)
        widx = jnp.where(better, sh_idx, widx)
        span += step
    return wmin, widx


@functools.partial(jax.jit, static_argnames=("w", "k", "is_hpc"))
def sketch_positions(
    codes: jnp.ndarray,  # (B, L) int32 nt4 codes, padded with 4
    lengths: jnp.ndarray,  # (B,) int32 true lengths
    w: int,
    k: int,
    is_hpc: bool = False,
    emit_final: jnp.ndarray | None = None,  # (B,) bool, default all-true
):
    """Per-position minimizer emission.

    Returns (key_span: U64Pair (B,L), pos_strand: (B,L) uint32 packed
    pos<<1|strand, emitted: bool (B,L)). rid is not encoded here — callers
    add it (queries use rid=0; the index builder carries rids alongside).

    emit_final=False suppresses the sequence-end flush (sketch.rs:99) for
    rows that are interior chunks of a longer sequence (the chunked
    index-build path, ops/index_build.py).
    """
    # Even k admits strand-symmetric k-mers, which pause the reference
    # scan's l counter (sketch.rs:67-69); this characterization does not
    # model the pause (see oracle/sketch.py docstring), so even k runs
    # the exact scan recurrence instead (ops/sketch_scan.py — same
    # contract, device-resident, fuzz-verified vs the oracle scan).
    if k % 2 == 0:
        from .sketch_scan import sketch_positions_exact

        return sketch_positions_exact(
            codes, lengths, w, k, is_hpc, emit_final=emit_final
        )
    B, L = codes.shape
    codes = codes.astype(I32)
    is_base = codes < 4
    idx = jnp.broadcast_to(jnp.arange(L, dtype=I32), (B, L))
    in_range = idx < lengths[:, None]
    is_base = is_base & in_range

    last_bad = jax.lax.cummax(jnp.where(~is_base, idx, I32(-1)), axis=1)
    depth = idx - last_bad  # bases since reset (valid positions only)

    # u32 fast path: with 2k+1 <= 32 the whole hashed key fits one lane
    # (sentinel 0xFFFFFFFF stays distinct) and non-HPC spans are all
    # exactly k, so every window/emission comparison runs single-word
    fast32 = (not is_hpc) and (2 * k + 1 <= 32)
    if fast32:
        canon32, strand, sym = kmer_keys32(jnp.where(is_base, codes, 4), k)
    else:
        canon, strand, sym = kmer_keys(jnp.where(is_base, codes, 4), k)
    # l_eff: non-symmetric valid positions since reset. cs is
    # nondecreasing, so cs[last_bad] == running max of cs over bad
    # positions — a cummax instead of a (B, L) take_along_axis gather
    inc = (is_base & ~sym).astype(I32)
    cs = jnp.cumsum(inc, axis=1)
    cs_at_bad = jnp.maximum(
        jax.lax.cummax(jnp.where(~is_base, cs, I32(-1)), axis=1), 0
    )
    l_eff = jnp.where(is_base, cs - cs_at_bad, 0)

    if is_hpc:
        # skip_len[i] = distance to the end of i's homopolymer run
        nxt = _shift_left(codes, 1, I32(4))
        boundary = (codes != nxt) | ~is_base
        INF = I32(2**30)
        bpos = jnp.where(boundary, idx, INF)
        next_boundary = jnp.flip(jax.lax.cummin(jnp.flip(bpos, axis=1), axis=1), axis=1)
        skip_len = jnp.where(is_base, next_boundary - idx + 1, 0)
        css = jnp.cumsum(skip_len, axis=1)
        # css_lo = css[lo-1] with lo-1 = max(idx-k, last_bad); css is
        # nondecreasing so css[max(a,b)] = max(css[a], css[b]): a static
        # shift + a cummax replace the gather (see cs_at_bad note above)
        cand_k = _shift_right(css, k, I32(-1))  # css[idx-k], -1 if OOB
        cand_bad = jax.lax.cummax(jnp.where(~is_base, css, I32(-1)), axis=1)
        css_lo = jnp.maximum(jnp.maximum(cand_k, cand_bad), 0)
        kspan = css - css_lo
    else:
        kspan = jnp.minimum(depth, k)

    valid = is_base & ~sym & (l_eff >= k) & (kspan < 256)
    if fast32:
        key32 = _hash64_u32(canon32, (1 << (2 * k)) - 1)
        ksc = jnp.where(valid, key32, U32(_INV32))

        def K_tail(a, d):  # a[..., :-d]
            return a[..., : a.shape[-1] - d]

        def K_head(a, d):  # a[..., d:]
            return a[..., d:]

        K_eq = lambda a, b: a == b
        K_gt = lambda a, b: a > b
        K_shr1 = lambda a: _shift_right(a, 1, U32(_INV32))
        K_isinv = lambda a: a == U32(_INV32)
        wfold = window_fold_min32
    else:
        key = u64.hash64(canon, (1 << (2 * k)) - 1)
        ksc = u64.or_(
            u64.shl(key, 8),
            u64.U64Pair(jnp.zeros_like(key.hi), kspan.astype(U32)),
        )
        ksc = u64.where(valid, ksc, u64.full_like(ksc, u64.UMAX))

        def K_tail(a, d):
            return u64.U64Pair(a.hi[..., : a.hi.shape[-1] - d], a.lo[..., : a.lo.shape[-1] - d])

        def K_head(a, d):
            return u64.U64Pair(a.hi[..., d:], a.lo[..., d:])

        K_eq = u64.eq
        K_gt = u64.gt
        K_shr1 = lambda a: _shift_right_u64(a, 1, u64.UMAX)
        K_isinv = lambda a: u64.eq(a, u64.full_like(a, u64.UMAX))
        wfold = window_fold_min
    pos_strand = ((idx.astype(U32) << U32(1)) | strand.astype(U32))
    pos_strand = jnp.where(valid, pos_strand, U32(0xFFFFFFFF))

    # window min + newest tied index, width w and w-1
    wmin, widx = wfold(ksc, idx, w)
    if w > 1:
        wmin1, widx1 = wfold(ksc, idx, w - 1)
    else:
        wmin1, widx1 = ksc, idx  # unused when w == 1 (no prev-buffer)
    valid_w = ~K_isinv(wmin)

    complete = l_eff >= (w + k - 1)
    hit = complete & valid_w

    # base rule: emitted[j] iff some complete window [e-w+1, e] covering j
    # has wmin[e] == ks[j]
    emitted = jnp.zeros((B, L), dtype=bool)
    for d in range(w):
        if d == 0:
            emitted |= hit & K_eq(ksc, wmin)
        elif d < L:
            cond = hit[..., d:] & K_eq(K_tail(ksc, d), K_head(wmin, d))
            emitted = emitted.at[..., : L - d].max(cond)

    if w > 1:
        # completion-step rules (oracle/sketch.py): at e with
        # l_eff == w+k-1, m1 = min over [e-w+1, e-1], M its newest tie:
        # ties of m1 except M are emitted; emitted[M] = ks[e] > m1.
        # M lies within w-1 of e, so the "write at M" scatter becomes a
        # bounded loop of shifted masked ORs instead of an XLA scatter.
        compl_e = l_eff == (w + k - 1)
        m1 = K_shr1(wmin1)
        M = _shift_right(widx1, 1, I32(-1))
        m1_valid = compl_e & ~K_isinv(m1)
        for d in range(1, w):
            if d >= L:
                break
            cond = (
                m1_valid[..., d:]
                & K_eq(K_tail(ksc, d), K_head(m1, d))
                & ((idx[..., :-d]) != M[..., d:])
            )
            emitted = emitted.at[..., : L - d].max(cond)
        m_val = K_gt(ksc, m1)  # value assigned to emitted[M]
        set_mask = jnp.zeros((B, L), dtype=bool)
        set_val = jnp.zeros((B, L), dtype=bool)
        for d in range(1, w):  # M[e] = e - d, d in [1, w-1]
            if d >= L:
                break
            src = m1_valid[..., d:] & (M[..., d:] == idx[..., :-d])
            set_mask = set_mask.at[..., : L - d].max(src)
            set_val = set_val.at[..., : L - d].max(src & m_val[..., d:])
        emitted = jnp.where(set_mask, set_val, emitted)

    # run-end drops: newest tie of the window min at each N reset is lost;
    # widx[e] is within w-1 of e — same bounded shifted-OR form
    next_base = _shift_left(is_base, 1, False)
    run_end = is_base & ~next_base & (idx != lengths[:, None] - 1)
    drop_src = run_end & valid_w
    drop_mask = drop_src & (widx == idx)
    for d in range(1, w):
        if d >= L:
            break
        src = drop_src[..., d:] & (widx[..., d:] == idx[..., :-d])
        drop_mask = drop_mask.at[..., : L - d].max(src)
    emitted = emitted & ~drop_mask

    # final emission at each read's true end (sketch.rs:99)
    last = jnp.maximum(lengths - 1, 0)
    rows1 = jnp.arange(B, dtype=I32)
    fin_valid = jnp.take_along_axis(valid_w, last[:, None], axis=1)[:, 0] & (lengths > 0)
    if emit_final is not None:
        fin_valid = fin_valid & emit_final
    fin_idx = jnp.take_along_axis(widx, last[:, None], axis=1)[:, 0]
    emitted = emitted.at[rows1, jnp.where(fin_valid, fin_idx, 0)].max(fin_valid)

    if fast32:
        # materialize the (key<<8 | span) u64 pair the rest of the
        # pipeline consumes (span == k on every valid position)
        ks = u64.U64Pair(
            jnp.where(valid, key32 >> U32(24), U32(0xFFFFFFFF)),
            jnp.where(valid, (key32 << U32(8)) | U32(k), U32(0xFFFFFFFF)),
        )
    else:
        ks = ksc
    return ks, pos_strand, emitted


@functools.partial(jax.jit, static_argnames=("max_out",))
def compact_minimizers(
    ks: u64.U64Pair,
    pos_strand: jnp.ndarray,
    emitted: jnp.ndarray,
    max_out: int,
):
    """Pack emitted minimizers to the front, position-sorted, padded to
    max_out slots. Returns (ks, pos_strand, n_valid, overflow).

    Stable stream compaction via the monotone routing network
    (ops/route.py): ceil(log2 L) masked shift passes instead of a
    full-width lax.sort or argsort + take_along_axis row gathers."""
    from .route import compact_left

    B, L = emitted.shape
    (s_hi, s_lo, s_ps), _ = compact_left((ks.hi, ks.lo, pos_strand), emitted)
    if max_out > L:
        pad = ((0, 0), (0, max_out - L))
        s_hi = jnp.pad(s_hi, pad, constant_values=0xFFFFFFFF)
        s_lo = jnp.pad(s_lo, pad, constant_values=0xFFFFFFFF)
        s_ps = jnp.pad(s_ps, pad, constant_values=0xFFFFFFFF)
    out_ks = u64.U64Pair(s_hi[:, :max_out], s_lo[:, :max_out])
    out_ps = s_ps[:, :max_out]
    n = jnp.sum(emitted, axis=-1).astype(I32)
    valid = jnp.arange(max_out, dtype=I32)[None, :] < jnp.minimum(n, max_out)[:, None]
    out_ks = u64.where(valid, out_ks, u64.full_like(out_ks, u64.UMAX))
    out_ps = jnp.where(valid, out_ps, U32(0xFFFFFFFF))
    return out_ks, out_ps, jnp.minimum(n, max_out), n > max_out
