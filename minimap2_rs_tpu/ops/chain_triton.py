"""The chaining DP as one Pallas kernel lowered through Triton (GPU).

Same contract as ops.chain_ops.chain_dp_batch / chain_dp_aux_batch: the
exact predecessor window of lchain.rs:74-91 (minus the max_chain_skip
heuristic), ties resolved to the largest j, and the same f32 penalty
(the log term read from the host-built table in ChainScalars).

The DP is sequential over anchors and parallel over reads x window. The
lax.scan form pays one set of XLA kernel launches per anchor step; here
the whole anchor loop runs inside one kernel:

- Each program owns one read (the mapper's calls carry hundreds, which
  fill the card) and loops over its anchors i up to its own anchor
  count. Rows past that count are padding: a padding row has no
  admissible predecessor (dq == 0), so its outputs are the no-chain base
  case, written once up front (the padding-tail skip).
- Step i scores its window [max(0, i - H), i) in `chunk`-wide pieces read
  from global memory (served by L1/L2), so a full window costs ~i cells
  at step i, not A (the triangular schedule). A running elementwise
  (best, j) pair per chunk lane keeps the largest j on ties; one
  reduction per step picks the winner.
- Programs run in parallel in no order; inside a program, step i+1 reads
  the f/cnt/sq/sr values step i stored (from other threads), so every
  step ends in a block barrier. Software pipelining is off (num_stages=1) so that no load of
  step i+1 is hoisted above that barrier.

interpret=True runs the kernel through the Pallas interpreter; tests pass
it explicitly on the CPU. It never follows from the backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

I32 = jnp.int32
F32 = jnp.float32
_NEG_INF = -(2**30)


def _kernel(n_ref, scal_ref, pen_ref, tab_ref, grp_ref, rpos_ref, qpos_ref,
            span_ref, *out_refs, A: int, H: int, CH: int, aux: bool,
            interpret: bool):
    T = tab_ref.shape[0]
    base = pl.program_id(0) * A                       # this read's row
    n = n_ref[pl.program_id(0)]
    mdx, mdy, bw = scal_ref[0], scal_ref[1], scal_ref[2]
    pen_gap, pen_skip = pen_ref[0], pen_ref[1]
    lane = jax.lax.iota(I32, CH)
    if aux:
        f_ref, cnt_ref, sq_ref, sr_ref = out_refs
    else:
        f_ref, prev_ref = out_refs

    # padding tail: columns [n, A) hold the base case
    def pad_chunk(k, c):
        j = n + k * CH + lane
        m = j < A
        at = f_ref.at[base + j]
        plgpu.store(at, plgpu.load(span_ref.at[base + j], mask=m, other=0), mask=m)
        if aux:
            plgpu.store(cnt_ref.at[base + j], jnp.ones(CH, I32), mask=m)
            plgpu.store(sq_ref.at[base + j], plgpu.load(qpos_ref.at[base + j], mask=m, other=0), mask=m)
            plgpu.store(sr_ref.at[base + j], plgpu.load(rpos_ref.at[base + j], mask=m, other=0), mask=m)
        else:
            plgpu.store(prev_ref.at[base + j], jnp.full(CH, -1, I32), mask=m)
        return c

    jax.lax.fori_loop(0, (A - n + CH - 1) // CH, pad_chunk, 0)

    def step(i, c):
        oi = base + i
        gi, ri, qi, si = grp_ref[oi], rpos_ref[oi], qpos_ref[oi], span_ref[oi]
        lo = jnp.maximum(i - H, 0)

        def score_chunk(k, acc):
            best, jacc = acc
            j = lo + k * CH + lane
            m = j < i
            ld = lambda ref: plgpu.load(ref.at[base + j], mask=m, other=0)
            gw, rw, qw, sw, fw = ld(grp_ref), ld(rpos_ref), ld(qpos_ref), ld(span_ref), ld(f_ref)
            # comput_sc (lchain.rs:17-34), as in chain_ops._window_scores
            dq = qi - qw
            dr = ri - rw
            dd = jnp.abs(dr - dq)
            dg = jnp.minimum(dr, dq)
            ok = (
                m & (gw == gi) & (dq > 0) & (dq <= mdx) & (dq <= mdy)
                & (dr != 0) & (dr <= mdx) & (dd <= bw)
            )
            half_log = plgpu.load(tab_ref.at[jnp.clip(dd, 0, T - 1)])
            lin = pen_gap * dd.astype(F32) + pen_skip * dg.astype(F32)
            pen = (lin + half_log).astype(I32)
            sc = jnp.minimum(sw, dg)
            sc = jnp.where((dd != 0) | (dg > sw), sc - pen, sc)
            s = jnp.where(ok, sc + fw, _NEG_INF)
            # later chunks hold larger j: >= keeps the largest j on ties
            upd = s >= best
            return jnp.where(upd, s, best), jnp.where(upd, j, jacc)

        init = (jnp.full(CH, _NEG_INF, I32), jnp.full(CH, -1, I32))
        best, jacc = jax.lax.fori_loop(0, (i - lo + CH - 1) // CH, score_chunk, init)
        bmax = jnp.max(best)
        jb = jnp.max(jnp.where(best == bmax, jacc, -1))
        win = bmax > si
        plgpu.store(f_ref.at[oi], jnp.where(win, bmax, si))
        if aux:
            ob = base + jnp.maximum(jb, 0)
            plgpu.store(cnt_ref.at[oi], jnp.where(win, cnt_ref[ob] + 1, 1))
            plgpu.store(sq_ref.at[oi], jnp.where(win, sq_ref[ob], qi))
            plgpu.store(sr_ref.at[oi], jnp.where(win, sr_ref[ob], ri))
        else:
            plgpu.store(prev_ref.at[oi], jnp.where(win, jb, -1))
        if not interpret:
            # step i+1 reads what this step stored (other threads' stores)
            plgpu.debug_barrier()
        return c

    jax.lax.fori_loop(0, n, step, 0)


def launch_config(H: int) -> tuple[int, int]:
    """(chunk, num_warps) for window H. Windows of up to 256 anchors
    score in 64-wide chunks, which keeps the triangular saving of a full
    window; wider windows in 256-wide chunks (the best of seven
    configurations tried on an H100 at 1024 x 256 and 468 x 4480)."""
    return (64, 2) if H <= 256 else (256, 4)


@functools.partial(jax.jit, static_argnames=("window", "aux", "interpret"))
def chain_dp_triton(grp, rpos, qpos, span, p, window: int, *, aux: bool,
                    interpret: bool = False):
    """Chain DP kernel, one read per program. aux=False returns
    (f, prev); aux=True returns (f, cnt, sq, sr), each (B, A) int32
    (chain_ops for the meaning)."""
    B, A = grp.shape
    H = min(window, A)
    CH, NW = launch_config(H)
    grp = jax.lax.bitcast_convert_type(grp, I32)
    # anchors past the last valid one (grp == -1) are padding
    n = jnp.max(jnp.where(grp != -1, jnp.arange(1, A + 1, dtype=I32), 0), axis=1)
    scal = jnp.stack([p.max_dist_x, p.max_dist_y, p.bw]).astype(I32)
    pens = jnp.stack([p.chn_pen_gap, p.chn_pen_skip]).astype(F32)
    flat = lambda x: x.astype(I32).reshape(-1)
    outs = pl.pallas_call(
        functools.partial(_kernel, A=A, H=H, CH=CH, aux=aux,
                          interpret=interpret),
        grid=(B,),
        out_shape=tuple(
            jax.ShapeDtypeStruct((B * A,), I32) for _ in range(4 if aux else 2)
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NW, num_stages=1),
        interpret=interpret,
        name="chain_dp_aux" if aux else "chain_dp",
    )(n, scal, pens, p.half_log2, flat(grp), flat(rpos), flat(qpos), flat(span))
    return tuple(o.reshape(B, A) for o in outs)


def chain_dp_batch_triton(grp, rpos, qpos, span, p, window: int, *,
                          interpret: bool = False):
    """Drop-in for chain_ops.chain_dp_batch: (f, prev), each (B, A)."""
    return chain_dp_triton(grp, rpos, qpos, span, p, window, aux=False,
                           interpret=interpret)


def chain_dp_aux_batch_triton(grp, rpos, qpos, span, p, window: int, *,
                              interpret: bool = False):
    """Drop-in for chain_ops.chain_dp_aux_batch: (f, cnt, sq, sr)."""
    return chain_dp_triton(grp, rpos, qpos, span, p, window, aux=True,
                           interpret=interpret)
