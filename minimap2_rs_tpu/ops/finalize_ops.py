"""On-device chain finalization for the default-parameter fast path.

With the reference's default min_cnt >= 2, its backtracking rejects every
candidate chain (the degenerate mg_chain_bk_end walk makes each candidate
a single anchor, lchain.rs:108-125) and the greedy fallback emits exactly
one chain per read: the prev[] path from the highest-scoring anchor
(lchain.rs:161-173). Chain merge and primary/secondary selection are
no-ops on a single chain, so the whole host postprocess collapses to
per-read arithmetic over quantities the chaining kernel accumulates along
each prev path (ops/chain_ops.chain_dp_aux_batch):

    best    = last argmax f      (Rust max_by_key takes the last maximum)
    cm, n_match  from acc        (path length / dv matches, packed)
    qs, ts  from the chain-start positions sq, sr
    qe, te  from the best anchor itself
    dv      from (n_match, st, en) — the reference's two-pointer loop
             (paf.rs:185-188) reduces to an ordered-set intersection
             because chain query positions are strictly monotone and
             minimizer positions strictly increasing
    rescue  coverage thresholds (lchain.rs:321-326)

No backtracking, no pointer chasing: the device returns a few words per
read and the host formats them. Reads that need the general path
(min_cnt <= 1 parameterizations, HPC spans, slot overflow, rescue) are
flagged and fall back to the host pipeline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

I32 = jnp.int32
U32 = jnp.uint32
_NEG = -(2**30)

# output field order (finalize_from_aux); win_ovf flags reads whose
# chain window was truncated below the reference's max_chain_iter while
# a farther in-band predecessor exists (models/mapper.py re-runs them);
# sum_span is the minimizer-stream span total for the dv exponent
# (avg_k, paf.rs:163-166 — equal to n_mini * k when not HPC)
FIELDS = [
    "score", "qs", "qe", "ts", "te", "cm", "grp", "n_match", "st", "n_tot",
    "dv_found", "rescue", "n_anchors", "n_mini", "mini_ovf", "anc_ovf",
    "win_ovf", "sum_span",
]

# Device->host wire format: the 18 logical fields ship as 10 words per
# read (n_match always equals cm,
# finalize_from_aux; 16-bit-bounded counters pack in pairs; the 5 flags
# share n_tot's word). pack runs on device (free, fused); unpack is a
# handful of vectorized NumPy ops on host.
WIRE_WORDS = 10


def wire_packable(A: int, M: int) -> bool:
    """True when every packed half-word is statically < 2^16:
    cm/n_anchors <= A, n_mini/st <= M, n_tot <= M + 2."""
    return A < (1 << 16) and M + 2 < (1 << 16)


def pack_fields_wire(fields: jnp.ndarray) -> jnp.ndarray:
    """(B, 18) int32 field rows -> (B, 10) int32 wire rows (in-jit)."""
    c = {n: fields[:, i] for i, n in enumerate(FIELDS)}
    w16 = lambda hi, lo: (hi << 16) | lo  # halves < 2^16 (wire_packable)
    flags = (
        c["dv_found"] | (c["rescue"] << 1) | (c["mini_ovf"] << 2)
        | (c["anc_ovf"] << 3) | (c["win_ovf"] << 4)
    )
    return jnp.stack(
        [
            c["score"], c["qs"], c["qe"], c["ts"], c["te"], c["grp"],
            w16(c["cm"], c["n_anchors"]), w16(c["n_mini"], c["st"]),
            w16(c["n_tot"], flags), c["sum_span"],
        ],
        axis=1,
    )


def unpack_fields_wire(wire) -> "np.ndarray":
    """Host-side inverse of pack_fields_wire: (B, 10) -> (B, 18) int32."""
    import numpy as np

    w = np.ascontiguousarray(wire, dtype=np.int32)
    u = w.view(np.uint32)
    out = np.empty((w.shape[0], len(FIELDS)), np.int32)
    col = {n: i for i, n in enumerate(FIELDS)}
    for j, name in enumerate(("score", "qs", "qe", "ts", "te", "grp")):
        out[:, col[name]] = w[:, j]
    out[:, col["cm"]] = (u[:, 6] >> 16).astype(np.int32)
    out[:, col["n_match"]] = out[:, col["cm"]]
    out[:, col["n_anchors"]] = (u[:, 6] & 0xFFFF).astype(np.int32)
    out[:, col["n_mini"]] = (u[:, 7] >> 16).astype(np.int32)
    out[:, col["st"]] = (u[:, 7] & 0xFFFF).astype(np.int32)
    out[:, col["n_tot"]] = (u[:, 8] >> 16).astype(np.int32)
    flags = u[:, 8]
    out[:, col["dv_found"]] = (flags & 1).astype(np.int32)
    out[:, col["rescue"]] = ((flags >> 1) & 1).astype(np.int32)
    out[:, col["mini_ovf"]] = ((flags >> 2) & 1).astype(np.int32)
    out[:, col["anc_ovf"]] = ((flags >> 3) & 1).astype(np.int32)
    out[:, col["win_ovf"]] = ((flags >> 4) & 1).astype(np.int32)
    out[:, col["sum_span"]] = w[:, 9]
    return out


def _lower_bound_single(mini_pos: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Per-row lower_bound of one value q (B,) into sorted mini_pos (B, M):
    the count of entries < q. One vectorized (B, M) comparison + row-sum
    instead of a sequential log(M)-step binary search (padding slots hold
    U32-max and never compare below a 24-bit q)."""
    return jnp.sum((mini_pos < q[:, None]).astype(I32), axis=1)


def finalize_from_aux(
    f, cnt, sq, sr,            # (B, A) int32 aux chain outputs
    x_hi, x_lo, y_lo,          # (B, A) uint32 sorted anchors
    n_anchors,                 # (B,) int32
    mini_pos,                  # (B, M) uint32 sorted positions
    n_mini,                    # (B,) int32
    lengths,                   # (B,) int32
    tlens,                     # (n_seq,) int32
    mini_ovf, anc_ovf,         # (B,) bool
    k: int,
    rmq_rescue_size, rmq_rescue_ratio,
    win_ovf=None,              # (B,) bool or None
    spans=None,                # (B, A) int32 anchor spans, or None (== k)
    sum_span=None,             # (B,) int32 minimizer-stream span total
):
    """Returns the packed (B, 18) int32 field array (see FIELDS)."""
    B, A = f.shape
    a_idx = jnp.broadcast_to(jnp.arange(A, dtype=I32), (B, A))
    valid = a_idx < n_anchors[:, None]
    fm = jnp.where(valid, f, _NEG)
    best_i = (A - 1) - jnp.argmax(fm[:, ::-1], axis=1).astype(I32)
    rows = jnp.arange(B, dtype=I32)

    def at_best(arr):
        return arr[rows, best_i]

    score = at_best(fm)
    # every chain anchor's query-forward position is a member of the
    # minimizer stream by construction (it came from that minimizer, and
    # the dv flip recovers the emission position), and chains have
    # strictly increasing positions — so the reference's two-pointer
    # match count (paf.rs:185-188) equals the chain length.
    cm = at_best(cnt)
    n_match = cm
    sq_b = at_best(sq)
    sr_b = at_best(sr)
    grp = jax.lax.bitcast_convert_type(at_best(x_hi), I32)
    rev = (grp >> 31) & 1
    rid = grp & 0x7FFFFFFF
    tlen = tlens[jnp.clip(rid, 0, tlens.shape[0] - 1)]
    qlen = lengths
    qpos_b = jax.lax.bitcast_convert_type(at_best(y_lo), I32)
    rpos_b = jax.lax.bitcast_convert_type(at_best(x_lo), I32)

    # anchor spans: uniformly k unless HPC; the chain-start anchor is
    # recovered by matching (grp, rpos, qpos) == (grp, sr, sq) — chains
    # have strictly increasing positions so the match is unique (up to
    # exact duplicate anchors, which share the span)
    if spans is None:
        span_b = jnp.full((B,), k, I32)
        span_s = span_b
    else:
        span_b = at_best(spans)
        grp_w = jax.lax.bitcast_convert_type(x_hi, I32)
        rpos_w = jax.lax.bitcast_convert_type(x_lo, I32)
        qpos_w = jax.lax.bitcast_convert_type(y_lo, I32)
        m = (
            valid
            & (grp_w == grp[:, None])
            & (rpos_w == sr_b[:, None])
            & (qpos_w == sq_b[:, None])
        )
        span_s = jnp.max(jnp.where(m, spans, 0), axis=1)

    # extents: qpos/rpos strictly increase along a chain, so start/end
    # anchors bound the ranges
    qs = jnp.maximum(sq_b - (span_s - 1), 0)
    qe = qpos_b + 1
    ts = jnp.maximum(sr_b - (span_s - 1), 0)
    te = rpos_b + 1

    qfwd_best = jnp.where(rev == 1, qlen - 1 - (qpos_b + 1 - span_b), qpos_b)
    qfwd_start = jnp.where(rev == 1, qlen - 1 - (sq_b + 1 - span_s), sq_b)
    first = jnp.minimum(qfwd_best, qfwd_start)
    last = jnp.maximum(qfwd_best, qfwd_start)
    first_u = jax.lax.bitcast_convert_type(jnp.clip(first, 0, (1 << 24) - 1), U32)
    st = _lower_bound_single(mini_pos, first_u)
    M = mini_pos.shape[1]
    at_st = jnp.take_along_axis(mini_pos, jnp.minimum(st, M - 1)[:, None], axis=1)[:, 0]
    dv_found = (st < n_mini) & (at_st == first_u)
    last_u = jax.lax.bitcast_convert_type(jnp.clip(last, 0, (1 << 24) - 1), U32)
    en = _lower_bound_single(mini_pos, last_u)
    n_tot = en - st + 1
    r_qs = jnp.where(rev == 1, qlen - qe, qs)
    r_qe = jnp.where(rev == 1, qlen - qs, qe)
    # the border test uses the truncated average span (paf.rs:192-196);
    # exactly k when spans are uniform. Computed with INTEGER division:
    # XLA lowers f32 division to reciprocal-multiply (2775/185 ->
    # 14.999999), flipping the truncation where the reference's
    # correctly-rounded f32 division gives 15.0 exactly. For span <= 255
    # (so quotient <= 255, half-ULP <= 2^-16) and n_mini < 2^16 (true
    # quotient sits >= 2^-16 below the next integer, and at quotients
    # < 256 the half-ULP is 2^-17 < 2^-16) the correctly rounded f32
    # quotient can never reach the next integer, so
    # trunc(f32(sum/n)) == sum // n bit-exactly. n_mini < 2^16 covers
    # the 4x overflow tier (65536-slot bucket x mini_frac 0.22 x 4
    # ~ 57k slots < 2^16); a capacity raise past 2^16 slots would void
    # this proof.
    if sum_span is None:
        sum_span = n_mini * jnp.int32(k)
    kk = sum_span // jnp.maximum(n_mini, 1)
    n_tot = n_tot + ((r_qs > kk) & (ts > kk)).astype(I32)
    n_tot = n_tot + (((qlen - r_qe) > kk) & ((tlen - te) > kk)).astype(I32)

    cov = jnp.maximum(qe - qs, 0)
    uncovered = jnp.maximum(qlen - cov, 0)
    rescue = (uncovered > rmq_rescue_size) | (
        cov.astype(jnp.float32)
        < qlen.astype(jnp.float32) * (jnp.float32(1.0) - rmq_rescue_ratio)
    )

    if win_ovf is None:
        win_ovf = jnp.zeros((B,), bool)
    return jnp.stack(
        [
            score, qs, qe, ts, te, cm, grp, n_match, st, n_tot,
            dv_found.astype(I32), rescue.astype(I32), n_anchors, n_mini,
            mini_ovf.astype(I32), anc_ovf.astype(I32), win_ovf.astype(I32),
            sum_span,
        ],
        axis=1,
    )
