"""Banded alignment/extension kernels (beyond-reference capability).

The reference carries unused alignment helpers (banded Levenshtein,
greedy end extension — /root/reference/src/paf.rs:35-124, dead code per
SURVEY.md 2.13); the BASELINE north star calls for a banded affine-gap
extension DP as the device build's extension stage. These kernels provide
it without changing any default PAF field.

Formulation: the band is a fixed window of W = 2b+1 diagonal offsets
k = j - i + b. Iterating rows i, the affine states map to vector ops:

    diag:   H[i][k] <- H[i-1][k] + sub(i, j)        (same offset)
    del:    F[i][k] <- max(F[i-1][k+1], H[i-1][k+1] - open) - ext
    ins:    E[i][k] <- max_{k'<k}(H0[i][k'] - open - (k-k')*ext)
                     = cummax(H0[i][k'] + ext*k')[k-1] - ext*k - open - ...

The within-row insertion recurrence uses the classic decay-cummax
identity (re-opening a gap out of a cell that itself ended a gap is never
optimal for open >= 0), so each row is branch-free vector work and
batches of pairs run as (B, W) blocks under one fori_loop. A banded
Levenshtein variant matches the reference's banded_edit_distance contract
(paf.rs:35-79) for parity testing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

I32 = jnp.int32
_NEG = -(2**24)  # -inf surrogate safe for int32 adds


def _row_codes(rpad, i, offs, B, W, hi):
    """r codes for columns j = i + (k - b) at row i (1-based); rpad is r
    left-padded by b+1 so rpad[:, i + k] == r[:, j - 1]."""
    idx = jnp.clip(i + offs + (W // 2), 0, hi)
    return jnp.take_along_axis(rpad, jnp.broadcast_to(idx, (B, W)), axis=1)


@functools.partial(jax.jit, static_argnames=("band",))
def banded_edit_batch(q: jnp.ndarray, qlen, r: jnp.ndarray, rlen, band: int):
    """Banded Levenshtein distance per pair (paf.rs:35-79 semantics):
    q, r are (B, N)/(B, Nr) nt4 codes (pad 4); returns (B,) int32
    distances, max(n, m) when the end cell falls outside the band."""
    B, N = q.shape
    Nr = r.shape[1]
    W = 2 * band + 1
    INF = 2**24
    offs = jnp.arange(W, dtype=I32) - band  # (W,)

    rpad = jnp.pad(r, ((0, 0), (band + 1, band + 1)), constant_values=4)
    hi = rpad.shape[1] - 1

    # row 0: dist(0, j) = j for j in [0, band]
    row0 = jnp.where(offs >= 0, offs, INF)[None, :].astype(I32)
    row0 = jnp.where(offs[None, :] <= rlen[:, None], row0, INF)

    def body(i, prev):
        qc = jnp.take_along_axis(
            q, jnp.broadcast_to(jnp.minimum(i - 1, N - 1), (B, 1)), axis=1
        )[:, 0]
        j = i + offs[None, :]  # (1, W) broadcast over B
        rcw = _row_codes(rpad, i, offs[None, :], B, W, hi)
        cost = jnp.where((qc[:, None] == rcw) & (qc[:, None] < 4), 0, 1)
        in_r = (j > 0) & (j <= rlen[:, None])
        diag = jnp.where(in_r, prev + cost, INF)
        up = jnp.concatenate([prev[:, 1:], jnp.full((B, 1), INF, I32)], axis=1) + 1
        dele = jnp.where(j == 0, i, INF)  # first column: i deletions
        cand = jnp.minimum(jnp.minimum(diag, jnp.where(in_r, up, INF)), dele)
        # insertion curr[k-1] + 1: unit-decay cummin
        g = cand - offs[None, :]
        run = jax.lax.cummin(g, axis=1)
        ins = run + offs[None, :]
        curr = jnp.minimum(cand, ins)
        curr = jnp.where(in_r | (j == 0), curr, INF)
        return jnp.where(i <= qlen[:, None], curr, prev)

    final = jax.lax.fori_loop(1, N + 1, body, row0)
    kd = rlen - qlen + band
    in_band = (kd >= 0) & (kd < W)
    got = jnp.take_along_axis(final, jnp.clip(kd, 0, W - 1)[:, None], axis=1)[:, 0]
    worst = jnp.maximum(qlen, rlen)
    out = jnp.where(in_band & (got < INF), got, worst)
    return jnp.where((qlen == 0) | (rlen == 0), worst, out).astype(I32)


@functools.partial(jax.jit, static_argnames=("band",))
def banded_affine_extend(
    q: jnp.ndarray, qlen, r: jnp.ndarray, rlen, band: int,
    match: int = 2, mismatch: int = 4, gap_open: int = 4, gap_ext: int = 2,
):
    """Banded affine-gap extension per pair: starting at the (0, 0)
    corner, the best score over all in-band cells (the minimap2-style
    extension objective). Returns (best_score, best_i, best_j), (B,)
    each, with (0, 0, 0) when no positive-scoring cell exists."""
    B, N = q.shape
    Nr = r.shape[1]
    W = 2 * band + 1
    offs = jnp.arange(W, dtype=I32) - band

    rpad = jnp.pad(r, ((0, 0), (band + 1, band + 1)), constant_values=4)
    hi = rpad.shape[1] - 1

    # row 0: leading insertion run
    H0row = jnp.where(
        offs[None, :] == 0, 0,
        jnp.where(offs[None, :] > 0, -(gap_open + gap_ext * offs[None, :]), _NEG),
    ).astype(I32)
    H0row = jnp.where(offs[None, :] <= rlen[:, None], H0row, _NEG)
    F0 = jnp.full((B, W), _NEG, I32)

    def body(i, carry):
        Hp, Fp, best, bi, bj = carry
        qc = jnp.take_along_axis(
            q, jnp.broadcast_to(jnp.minimum(i - 1, N - 1), (B, 1)), axis=1
        )[:, 0]
        j = i + offs[None, :]
        rcw = _row_codes(rpad, i, offs[None, :], B, W, hi)
        sub = jnp.where((qc[:, None] == rcw) & (qc[:, None] < 4), match, -mismatch)
        in_r = (j > 0) & (j <= rlen[:, None]) & (i <= qlen[:, None])

        F = jnp.maximum(
            jnp.concatenate([Fp[:, 1:], jnp.full((B, 1), _NEG, I32)], axis=1),
            jnp.concatenate([Hp[:, 1:], jnp.full((B, 1), _NEG, I32)], axis=1)
            - gap_open,
        ) - gap_ext
        H0 = jnp.maximum(jnp.where(in_r, Hp + sub, _NEG), jnp.where(in_r, F, _NEG))
        g = H0 + gap_ext * offs[None, :]
        run = jax.lax.cummax(g, axis=1)
        run_prev = jnp.concatenate(
            [jnp.full((B, 1), _NEG, I32), run[:, :-1]], axis=1
        )
        E = run_prev - gap_ext * offs[None, :] - gap_open
        H = jnp.maximum(H0, jnp.where(in_r, E, _NEG))
        H = jnp.where(in_r, H, _NEG)
        rowmax = jnp.max(H, axis=1)
        argk = jnp.argmax(H, axis=1).astype(I32)
        upd = rowmax > best
        best = jnp.where(upd, rowmax, best)
        bi = jnp.where(upd, i, bi)
        bj = jnp.where(upd, i + argk - band, bj)
        return (H, F, best, bi, bj)

    _, _, best, bi, bj = jax.lax.fori_loop(
        1, N + 1, body, (H0row, F0, jnp.zeros(B, I32), jnp.zeros(B, I32), jnp.zeros(B, I32))
    )
    return best, bi, bj
