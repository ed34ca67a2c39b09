"""Long-read chain kernel tests: the Triton chain kernel (run through
the Pallas interpreter) must match the lax.scan formulation at long-read
shapes, with full and truncated windows, and the truncated-window fast
path must flag exactly the reads whose full-window DP could differ
(models/mapper.py re-runs those at max_chain_iter)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from minimap2_rs_tpu.config import ChainParams
from minimap2_rs_tpu.models.mapper import DUAL_BAND_MAX_A
from minimap2_rs_tpu.ops.chain_ops import (
    chain_dp_aux_batch,
    chain_dp_batch,
    chain_scalars_from_params,
)
from minimap2_rs_tpu.ops.chain_triton import chain_dp_triton
from minimap2_rs_tpu.ops import u64


def _synthetic_anchors(B, A, seed, genome=200_000, qmax=30_000):
    rng = np.random.default_rng(seed)
    grp = np.full((B, A), 0xFFFFFFFF, dtype=np.uint32)
    rpos = np.zeros((B, A), np.int32)
    qpos = np.zeros((B, A), np.int32)
    span = np.zeros((B, A), np.int32)
    for b in range(B):
        n = int(rng.integers(A // 4, A))
        rp = np.sort(rng.integers(0, genome, size=n))
        qp = np.sort(rng.integers(0, qmax, size=n))
        g = rng.integers(0, 2, size=n).astype(np.uint32) * np.uint32(0x80000000)
        order = np.lexsort((qp, rp, g))
        grp[b, :n] = g[order]
        rpos[b, :n] = rp[order]
        qpos[b, :n] = qp[order]
        span[b, :n] = 15
    return grp, rpos, qpos, span


@pytest.mark.parametrize("window_frac", [1.0, 0.4])
def test_lane_kernels_match_scan(window_frac):
    """Both kernel variants at a single-band (long-read) shape, with the
    kernel's production launch configuration."""
    B, A = 8, 2 * DUAL_BAND_MAX_A
    grp, rpos, qpos, span = _synthetic_anchors(B, A, seed=11)
    cp = ChainParams.defaults_for_k(15)
    scal = chain_scalars_from_params(cp)
    args = (jnp.asarray(grp), jnp.asarray(rpos), jnp.asarray(qpos), jnp.asarray(span))
    window = int(A * window_frac)
    f1, p1 = chain_dp_batch(*args, scal, window)
    f2, p2 = chain_dp_triton(*args, scal, window, aux=False, interpret=True)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    o1 = chain_dp_aux_batch(*args, scal, window)
    o2 = chain_dp_triton(*args, scal, window, aux=True, interpret=True)
    for a, b in zip(o1, o2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_window_truncation_detector_is_exact():
    """win_ovf (x[i] - x[i-H] <= max_dist_x) must cover every read where
    the truncated-window DP differs from the full-window DP."""
    B, A, H = 16, 512, 64
    cp = ChainParams.defaults_for_k(15)
    scal = chain_scalars_from_params(cp)
    # even rows: a colinear prefix, then > H junk anchors (in-band on x
    # but unchainable on q), then a colinear continuation whose only
    # good predecessors sit beyond the truncated window. odd rows:
    # sparse anchors where the window never truncates anything.
    rng = np.random.default_rng(3)
    grp = np.full((B, A), 0, dtype=np.uint32)
    rpos = np.zeros((B, A), np.int32)
    qpos = np.zeros((B, A), np.int32)
    span = np.full((B, A), 15, np.int32)
    n_pre = H // 2
    n_junk = 3 * H
    for b in range(B):
        if b % 2 == 0:
            rp = np.empty(A, np.int64)
            qp = np.empty(A, np.int64)
            rp[:n_pre] = 100 + 10 * np.arange(n_pre)
            qp[:n_pre] = 100 + 10 * np.arange(n_pre)
            j0 = int(rp[n_pre - 1]) + 1
            rp[n_pre : n_pre + n_junk] = j0 + np.arange(n_junk)
            qp[n_pre : n_pre + n_junk] = 25_000 - np.arange(n_junk)
            c0 = int(rp[n_pre + n_junk - 1]) + 10
            ncont = A - n_pre - n_junk
            rp[n_pre + n_junk :] = c0 + 10 * np.arange(ncont)
            qp[n_pre + n_junk :] = (qp[n_pre - 1] + (rp[n_pre + n_junk :] - rp[n_pre - 1]))
        else:
            rp = np.cumsum(rng.integers(150, 250, size=A))
            qp = rp + rng.integers(-3, 4, size=A)
        rpos[b] = rp
        qpos[b] = np.maximum(qp, 1)
    args = (jnp.asarray(grp), jnp.asarray(rpos), jnp.asarray(qpos), jnp.asarray(span))
    f_full, _ = chain_dp_batch(*args, scal, A)
    f_trunc, _ = chain_dp_triton(*args, scal, H, aux=False, interpret=True)

    # the detector, as computed in models/mapper._fused_map_stage_lite
    x_hi = jnp.asarray(grp)
    x_lo = jnp.asarray(rpos).astype(jnp.uint32)
    xa = u64.U64Pair(x_hi, x_lo)
    thr = u64.sub_u32_sat(xa, scal.max_dist_x)
    far = u64.le(
        u64.U64Pair(thr.hi[:, H:], thr.lo[:, H:]),
        u64.U64Pair(x_hi[:, :-H], x_lo[:, :-H]),
    )
    win_ovf = np.asarray(jnp.any(far, axis=1))

    differs = (np.asarray(f_full) != np.asarray(f_trunc)).any(axis=1)
    # every read whose truncated DP differs must be flagged
    assert not (differs & ~win_ovf).any()
    # and the dense rows actually exercise the flag
    assert win_ovf.any() and differs.any()
