"""Batched colinear chaining DP on device.

The reference's O(n*h) predecessor scan (/root/reference/src/lchain.rs:74-91)
is sequential in i but parallel in j; here each read runs a lax.scan over
its (padded) anchor array while the <=H predecessor window is scored as one
vectorized block, and reads are vmapped into a (B, A) batch. H equals
max_chain_iter so the window cap is bit-exact; the remaining st-window
constraint (lchain.rs:75) is equivalent to masking dr > max_dist_x because
anchors are rpos-sorted within a (rev,rid) group.

The only reference heuristic not reproduced is the order-dependent
max_chain_skip early-break (lchain.rs:85): it is a pruning that can only
*miss* better predecessors, is dropped by other vectorized chaining
implementations for the same reason, and is quantified against the oracle
in tests (identical results on all test corpora; see
tests/test_device_pipeline.py).

Outputs (f, v, prev) feed the host-side backtracking (oracle/lchain.py) —
pointer chasing over a few hundred elements per read is host work
(SURVEY.md section 7, hard part 5).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
F32 = jnp.float32
_NEG_INF = -(2**30)


class ChainScalars(NamedTuple):
    """Traced chaining parameters (so bw changes — e.g. the rescue pass,
    lchain.rs:321-330 — do not recompile)."""

    max_dist_x: jnp.ndarray  # i32 (already max'd with bw, lchain.rs:63-66)
    max_dist_y: jnp.ndarray  # i32
    bw: jnp.ndarray          # i32
    chn_pen_gap: jnp.ndarray  # f32
    chn_pen_skip: jnp.ndarray  # f32
    half_log2: jnp.ndarray   # (T,) f32: 0.5 * log2(dd + 1), dd < T


@functools.lru_cache(maxsize=8)
def half_log2_table(size: int) -> np.ndarray:
    """0.5 * mg_log2(dd + 1) for dd in [0, size), 0 at dd == 0, built by
    the oracle's own scalar f32 function (lchain.rs:14-15,31). Every
    device backend reads the log term from this table: a device `log`
    may differ from the host's in the last bit, and the penalty is
    truncated to an integer, so one ulp can move a score."""
    from ..oracle.lchain import mg_log2

    tab = np.zeros(size, np.float32)
    for dd in range(1, size):
        tab[dd] = np.float32(0.5) * mg_log2(dd + 1)
    return tab


def _window_scores(
    f_w, grp_w, rpos_w, qpos_w, span_w, j_abs, i,
    grp_i, rpos_i, qpos_i, span_i, p: ChainScalars,
):
    """comput_sc (lchain.rs:17-34) over a predecessor window, masked."""
    dq = qpos_i - qpos_w
    dr = rpos_i - rpos_w
    dd = jnp.abs(dr - dq)
    dg = jnp.minimum(dr, dq)
    ok = (
        (j_abs < i)
        & (grp_w == grp_i)
        & (dq > 0)
        & (dq <= p.max_dist_x)
        & (dq <= p.max_dist_y)
        & (dr != 0)
        & (dr <= p.max_dist_x)  # st-window equivalence (lchain.rs:75)
        & (dd <= p.bw)
    )
    sc = jnp.minimum(span_w, dg)
    lin_pen = p.chn_pen_gap * dd.astype(F32) + p.chn_pen_skip * dg.astype(F32)
    # in-band dd <= bw < table size; out-of-band cells are masked below
    half_log = p.half_log2[jnp.clip(dd, 0, p.half_log2.shape[0] - 1)]
    pen = (lin_pen + half_log).astype(I32)  # f32 truncation
    sc = jnp.where((dd != 0) | (dg > span_w), sc - pen, sc)
    return jnp.where(ok, sc + f_w, _NEG_INF), ok


def _skip_prune_mask(scores, ok, prev_w, off, span_i, max_skip: int):
    """The reference's order-dependent max_chain_skip early-break
    (lchain.rs:79-88), vectorized exactly over one predecessor window.

    The scalar scan walks j newest-first keeping a skip counter: a beat
    (sc > running max) decrements it (floored at 0), a skip (no beat AND
    t[j] == i, where t marks the DP predecessor of every in-band j'
    already scanned) increments it, and the scan breaks past `max_skip`.
    All three ingredients vectorize:

      * beat[j]  — an exclusive running max from the newest side
        (jnp.cummax over the reversed window, seeded with qspan_i);
      * t-marks  — every in-band j' marks prev[j'], and prev[j'] < j'
        always, so a mark is set before the scan reaches it: one scatter
        of the window's prev values (marks landing outside the window or
        on not-scanned positions are unreachable and harmless);
      * the skip counter — maps n -> n+1 (skip), n -> max(n-1, 0)
        (beat), n -> n (else) compose as f(n) = max(n + a, b) with
        (a1,b1) then (a2,b2) = (a1+a2, max(b1+a2, b2)): an associative
        scan over (a, b) pairs gives the counter at every j, and the
        break point is its first crossing of max_skip.

    Returns `scores` with every position older than the break point
    masked to _NEG_INF; positions at/after the break are unchanged (the
    break position itself never beats the running max, so keeping it is
    score-neutral and tie-safe: argmax already prefers the newest j).
    """
    H = scores.shape[0]
    # marks: t[prev[j']] = i for every in-band j' (lchain.rs:86)
    rel = prev_w - off
    in_win = ok & (prev_w >= 0) & (rel >= 0) & (rel < H)
    idx = jnp.where(in_win, rel, H)  # H = out of bounds -> dropped
    marks = jnp.zeros(H, dtype=bool).at[idx].set(True, mode="drop")

    # newest-first order
    s_d = scores[::-1]
    ok_d = ok[::-1]
    mark_d = marks[::-1]
    run_excl = jnp.concatenate(
        [span_i[None], jax.lax.cummax(s_d)[:-1]]
    )
    run_excl = jnp.maximum(run_excl, span_i)
    beat_d = ok_d & (s_d > run_excl)
    skip_d = ok_d & ~beat_d & mark_d

    a = jnp.where(skip_d, I32(1), jnp.where(beat_d, I32(-1), I32(0)))
    b = jnp.where(beat_d, I32(0), I32(_NEG_INF))

    def combine(l, r):  # l happened first (newer j), then r
        return l[0] + r[0], jnp.maximum(l[1] + r[0], r[1])

    A_, B_ = jax.lax.associative_scan(combine, (a, b))
    counter_d = jnp.maximum(A_, B_)  # value for n0 = 0
    crossed = counter_d > I32(max_skip)
    # scanned = everything up to and including the first crossing
    broken_before = jnp.cumsum(crossed.astype(I32)) - crossed.astype(I32)
    scanned_d = broken_before == 0
    return jnp.where(scanned_d[::-1], scores, _NEG_INF)


@functools.partial(jax.jit, static_argnames=("window", "max_chain_skip"))
def chain_dp_batch(
    grp: jnp.ndarray,   # (B, A) uint32 rev<<31|rid (padding 0xFFFFFFFF)
    rpos: jnp.ndarray,  # (B, A) int32
    qpos: jnp.ndarray,  # (B, A) int32
    span: jnp.ndarray,  # (B, A) int32
    p: ChainScalars,
    window: int,
    max_chain_skip: int | None = None,
):
    """Returns (f, prev) of shape (B, A) int32. (The reference's v array
    is only consumed by the backtrack fallback, where it equals the
    maximum f along the chain — recomputed host-side.)

    max_chain_skip=None (default) scores the window exactly; an int
    replicates the reference's order-dependent pruning bit-for-bit
    (_skip_prune_mask) at ~2x the per-step cost."""
    B, A = grp.shape
    H = min(window, A)
    prune = max_chain_skip is not None

    def one_read(grp_r, rpos_r, qpos_r, span_r):
        def step(carry, i):
            f, pv = carry
            off = jnp.clip(i - H, 0, A - H)
            j_abs = off + jnp.arange(H, dtype=I32)
            f_w = jax.lax.dynamic_slice(f, (off,), (H,))
            grp_w = jax.lax.dynamic_slice(grp_r, (off,), (H,))
            rpos_w = jax.lax.dynamic_slice(rpos_r, (off,), (H,))
            qpos_w = jax.lax.dynamic_slice(qpos_r, (off,), (H,))
            span_w = jax.lax.dynamic_slice(span_r, (off,), (H,))
            scores, ok = _window_scores(
                f_w, grp_w, rpos_w, qpos_w, span_w, j_abs, i,
                grp_r[i], rpos_r[i], qpos_r[i], span_r[i], p,
            )
            if prune:
                pv_w = jax.lax.dynamic_slice(pv, (off,), (H,))
                scores = _skip_prune_mask(
                    scores, ok, pv_w, off, span_r[i], max_chain_skip
                )
            # ties pick the largest j (the reference scans j descending and
            # requires strict improvement, lchain.rs:80-84)
            rev_scores = scores[::-1]
            a_rev = jnp.argmax(rev_scores)
            best = rev_scores[a_rev]
            j_best = j_abs[H - 1 - a_rev]
            win = best > span_r[i]
            f_i = jnp.where(win, best, span_r[i])
            prev_i = jnp.where(win, j_best, -1)
            f = f.at[i].set(f_i)
            if prune:
                pv = pv.at[i].set(prev_i)
            return (f, pv), (f_i, prev_i)

        f0 = jnp.zeros(A, dtype=I32)
        pv0 = jnp.full(A, -1, dtype=I32) if prune else f0
        _, (fs, prev) = jax.lax.scan(
            step, (f0, pv0), jnp.arange(A, dtype=I32)
        )
        return fs, prev

    return jax.vmap(one_read)(
        grp, rpos.astype(I32), qpos.astype(I32), span.astype(I32)
    )


def chain_scalars_from_params(p) -> ChainScalars:
    """Build traced scalars from a config.ChainParams, applying the
    max_dist adjustment (lchain.rs:63-66). The log table covers both
    bands (max(bw, bw_long)), so the normal and the bw_long scalars have
    one shape and share compiled programs."""
    return ChainScalars(
        max_dist_x=jnp.int32(max(p.max_dist_x, p.bw)),
        max_dist_y=jnp.int32(max(p.max_dist_y, p.bw)),
        bw=jnp.int32(p.bw),
        chn_pen_gap=jnp.float32(p.chn_pen_gap),
        chn_pen_skip=jnp.float32(p.chn_pen_skip),
        half_log2=jnp.asarray(half_log2_table(max(p.bw, p.bw_long) + 1)),
    )


@functools.partial(jax.jit, static_argnames=("window", "max_chain_skip"))
def chain_dp_aux_batch(
    grp: jnp.ndarray,   # (B, A) uint32 rev<<31|rid (padding 0xFFFFFFFF)
    rpos: jnp.ndarray,  # (B, A) int32
    qpos: jnp.ndarray,  # (B, A) int32
    span: jnp.ndarray,  # (B, A) int32
    p: ChainScalars,
    window: int,
    max_chain_skip: int | None = None,
):
    """Chain DP that additionally accumulates per-chain statistics along
    the prev path, so the default-parameter fast path never backtracks
    (ops/finalize_ops.py):

      cnt    = chain length (the PAF cm field; also the dv n_match,
               because every chain anchor's query-forward position is a
               member of the minimizer stream by construction and chains
               have strictly increasing query positions)
      sq, sr = chain-start query/target positions

    Returns (f, cnt, sq, sr), each (B, A) int32.

    max_chain_skip: as in chain_dp_batch (None = exact window)."""
    B, A = grp.shape
    H = min(window, A)
    prune = max_chain_skip is not None

    def one_read(grp_r, rpos_r, qpos_r, span_r):
        def step(carry, i):
            f, cnt, sq, sr, pv = carry
            off = jnp.clip(i - H, 0, A - H)
            j_abs = off + jnp.arange(H, dtype=I32)
            f_w = jax.lax.dynamic_slice(f, (off,), (H,))
            grp_w = jax.lax.dynamic_slice(grp_r, (off,), (H,))
            rpos_w = jax.lax.dynamic_slice(rpos_r, (off,), (H,))
            qpos_w = jax.lax.dynamic_slice(qpos_r, (off,), (H,))
            span_w = jax.lax.dynamic_slice(span_r, (off,), (H,))
            scores, ok = _window_scores(
                f_w, grp_w, rpos_w, qpos_w, span_w, j_abs, i,
                grp_r[i], rpos_r[i], qpos_r[i], span_r[i], p,
            )
            if prune:
                pv_w = jax.lax.dynamic_slice(pv, (off,), (H,))
                scores = _skip_prune_mask(
                    scores, ok, pv_w, off, span_r[i], max_chain_skip
                )
            rev_scores = scores[::-1]
            a_rev = jnp.argmax(rev_scores)
            best = rev_scores[a_rev]
            jb_rel = H - 1 - a_rev
            win = best > span_r[i]
            f_i = jnp.where(win, best, span_r[i])
            cnt_w = jax.lax.dynamic_slice(cnt, (off,), (H,))
            sq_w = jax.lax.dynamic_slice(sq, (off,), (H,))
            sr_w = jax.lax.dynamic_slice(sr, (off,), (H,))
            cnt_i = jnp.where(win, cnt_w[jb_rel] + 1, 1)
            sq_i = jnp.where(win, sq_w[jb_rel], qpos_r[i])
            sr_i = jnp.where(win, sr_w[jb_rel], rpos_r[i])
            f = f.at[i].set(f_i)
            cnt = cnt.at[i].set(cnt_i)
            sq = sq.at[i].set(sq_i)
            sr = sr.at[i].set(sr_i)
            if prune:
                j_best = j_abs[jb_rel]
                pv = pv.at[i].set(jnp.where(win, j_best, -1))
            return (f, cnt, sq, sr, pv), None

        z = jnp.zeros(A, dtype=I32)
        pv0 = jnp.full(A, -1, dtype=I32) if prune else z
        (f, cnt, sq, sr, _), _ = jax.lax.scan(
            step, (z, z, z, z, pv0), jnp.arange(A, dtype=I32)
        )
        return f, cnt, sq, sr

    return jax.vmap(one_read)(
        grp, rpos.astype(I32), qpos.astype(I32), span.astype(I32)
    )
