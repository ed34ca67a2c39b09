"""Device kernel tests (CPU backend, small static shapes to keep compile
times down): u64 pair arithmetic, device sketch vs the exact oracle,
index lookup, anchor expansion, and chain DP vs the oracle DP."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from minimap2_rs_tpu.config import ChainParams, IndexParams
from minimap2_rs_tpu.oracle.index import build_index
from minimap2_rs_tpu.oracle.lchain import chain_dp_scores
from minimap2_rs_tpu.oracle.seeds import build_anchors, collect_query_minimizers, filter_query_minimizers
from minimap2_rs_tpu.oracle.sketch import hash64, sketch_sequence
from minimap2_rs_tpu.ops import u64
from minimap2_rs_tpu.ops.chain_ops import chain_dp_batch, chain_scalars_from_params
from minimap2_rs_tpu.ops.index_ops import DeviceIndex, index_lookup
from minimap2_rs_tpu.ops.seeds_ops import build_anchors_device, query_occ_filter, sort_minimizers_by_key
from minimap2_rs_tpu.ops.sketch import compact_minimizers, sketch_positions
from minimap2_rs_tpu.utils.packing import nt4_encode
from minimap2_rs_tpu.utils.seqsim import random_genome, simulate_reads

W, K = 5, 11  # small but realistic odd-k config


def _pairs_to_u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def test_u64_pair_ops():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**64, size=50, dtype=np.uint64)
    b = rng.integers(0, 2**64, size=50, dtype=np.uint64)

    def mk(x):
        return u64.U64Pair(
            jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        )

    pa, pb = mk(a), mk(b)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(_pairs_to_u64(*u64.add(pa, pb)), a + b)
    for s in (0, 1, 8, 21, 31, 32, 33, 56, 63):
        np.testing.assert_array_equal(_pairs_to_u64(*u64.shl(pa, s)), a << np.uint64(s))
        np.testing.assert_array_equal(_pairs_to_u64(*u64.shr(pa, s)), a >> np.uint64(s))
    np.testing.assert_array_equal(np.asarray(u64.lt(pa, pb)), a < b)
    np.testing.assert_array_equal(np.asarray(u64.le(pa, pb)), a <= b)
    np.testing.assert_array_equal(np.asarray(u64.eq(pa, pa)), np.ones(50, bool))
    # hash64 on pairs == scalar oracle
    mask = (1 << 30) - 1
    masked = a & np.uint64(mask)
    hp = u64.hash64(mk(masked), mask)
    expect = np.array([hash64(int(v), mask) for v in masked], dtype=np.uint64)
    np.testing.assert_array_equal(_pairs_to_u64(*hp), expect)


def test_device_sketch_matches_oracle():
    rng = np.random.default_rng(3)
    seqs = []
    for _ in range(6):
        n = int(rng.integers(40, 250))
        s = rng.choice(list(b"ACGTN"), size=n, p=[0.24, 0.24, 0.24, 0.24, 0.04])
        seqs.append(bytes(s.astype(np.uint8)))
    # add a tie-heavy sequence
    seqs.append(b"ACGTC" + b"A" * 60 + b"N" + b"TTAGC" * 20)
    L = 256
    B = len(seqs)
    codes = np.full((B, L), 4, dtype=np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = nt4_encode(s)
        lengths[i] = len(s)
    ks, ps, em = sketch_positions(jnp.asarray(codes), jnp.asarray(lengths), W, K, False)
    em = np.asarray(em)
    keys = _pairs_to_u64(ks.hi, ks.lo)
    psn = np.asarray(ps)
    for b, s in enumerate(seqs):
        dev = {(int(keys[b, j]), int(psn[b, j])) for j in np.nonzero(em[b])[0]}
        exact = {(k, r & 0xFFFFFFFF) for k, r in sketch_sequence(s, W, K)}
        assert dev == exact, (b, s)
    # compaction preserves the set, position-ordered
    cks, cps, n_mini, ovf = compact_minimizers(ks, ps, em, 128)
    ckeys = _pairs_to_u64(cks.hi, cks.lo)
    cpsn = np.asarray(cps)
    nm = np.asarray(n_mini)
    assert not np.asarray(ovf).any()
    for b, s in enumerate(seqs):
        comp = {(int(ckeys[b, j]), int(cpsn[b, j])) for j in range(nm[b])}
        exact = {(k, r & 0xFFFFFFFF) for k, r in sketch_sequence(s, W, K)}
        assert comp == exact
        assert list(cpsn[b, : nm[b]] >> 1) == sorted(cpsn[b, : nm[b]] >> 1)


@pytest.fixture(scope="module")
def device_setup():
    genome = random_genome(40_000, seed=7)
    idx = build_index([("r", genome)], IndexParams(w=W, k=K))
    dev = DeviceIndex.from_host(idx.keys, idx.starts, idx.counts, idx.positions)
    return genome, idx, dev


def test_index_lookup_matches_oracle(device_setup):
    genome, idx, dev = device_setup
    rng = np.random.default_rng(5)
    # probe a mix of present and absent keys
    present = idx.keys[rng.integers(0, len(idx.keys), size=40)]
    absent = present + np.uint64(1)
    q = np.concatenate([present, absent])
    qp = u64.U64Pair(
        jnp.asarray((q >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )
    start, count = index_lookup(dev, qp)
    start, count = np.asarray(start), np.asarray(count)
    for i, key in enumerate(q):
        occ = idx.get(int(key))
        if occ is None:
            assert count[i] == 0
        else:
            assert count[i] == occ.shape[0]
            np.testing.assert_array_equal(
                idx.positions[start[i] : start[i] + count[i]], occ
            )


def test_device_anchors_match_oracle(device_setup):
    genome, idx, dev = device_setup
    reads = simulate_reads(genome, 6, read_len=(150, 250), seed=8)
    L, M, A = 256, 128, 256
    B = len(reads)
    codes = np.full((B, L), 4, dtype=np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for i, (_, s, *_r) in enumerate(reads):
        codes[i, : len(s)] = nt4_encode(s)
        lengths[i] = len(s)
    ks, ps, em = sketch_positions(jnp.asarray(codes), jnp.asarray(lengths), W, K, False)
    cks, cps, n_mini, _ = compact_minimizers(ks, ps, em, M)
    sks, sps = sort_minimizers_by_key(cks, cps)
    keep = query_occ_filter(sks, n_mini, 10, 0.01)
    mid_occ = max(idx.calc_mid_occ(2e-4), 10)
    x_hi, x_lo, y_hi, y_lo, n_anchors, ovf = build_anchors_device(
        dev, sks, sps, keep, jnp.asarray(lengths), jnp.int32(mid_occ), A
    )
    assert not np.asarray(ovf).any()
    xs = _pairs_to_u64(x_hi, x_lo)
    ys = _pairs_to_u64(y_hi, y_lo)
    na = np.asarray(n_anchors)
    for b, (_, s, *_r) in enumerate(reads):
        mv = collect_query_minimizers(s, W, K)
        mv = filter_query_minimizers(mv, 10, 0.01)
        expect = build_anchors(idx, mv, len(s), mid_occ)
        got = np.stack([xs[b, : na[b]], ys[b, : na[b]]], axis=1)
        np.testing.assert_array_equal(got, expect)


def test_device_chain_dp_matches_oracle(device_setup):
    genome, idx, dev = device_setup
    reads = simulate_reads(genome, 4, read_len=(150, 250), seed=9)
    cp = ChainParams.defaults_for_k(K)
    scal = chain_scalars_from_params(cp)
    mid_occ = max(idx.calc_mid_occ(2e-4), 10)
    A = 256
    B = len(reads)
    grp = np.full((B, A), 0xFFFFFFFF, dtype=np.uint32)
    rpos = np.zeros((B, A), dtype=np.int32)
    qpos = np.zeros((B, A), dtype=np.int32)
    span = np.zeros((B, A), dtype=np.int32)
    oracle_fvp = []
    for b, (_, s, *_r) in enumerate(reads):
        mv = collect_query_minimizers(s, W, K)
        mv = filter_query_minimizers(mv, 10, 0.01)
        anchors = build_anchors(idx, mv, len(s), mid_occ)
        n = anchors.shape[0]
        assert n <= A
        grp[b, :n] = (anchors[:, 0] >> np.uint64(32)).astype(np.uint32)
        rpos[b, :n] = (anchors[:, 0] & np.uint64(0x7FFFFFFF)).astype(np.int32)
        qpos[b, :n] = (anchors[:, 1] & np.uint64(0x7FFFFFFF)).astype(np.int32)
        span[b, :n] = ((anchors[:, 1] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
        oracle_fvp.append((n, *chain_dp_scores(anchors, cp)))
    f, prev = chain_dp_batch(
        jnp.asarray(grp), jnp.asarray(rpos), jnp.asarray(qpos), jnp.asarray(span),
        scal, A,
    )
    f, prev = np.asarray(f), np.asarray(prev)
    for b, (n, fo, vo, po) in enumerate(oracle_fvp):
        np.testing.assert_array_equal(f[b, :n], fo)
        np.testing.assert_array_equal(prev[b, :n], po)


def test_pallas_chain_matches_scan(device_setup):
    """The Triton chaining kernel (Pallas interpreter) must agree with
    the lax.scan formulation (which itself matches the oracle DP)."""
    import jax.numpy as jnp

    from minimap2_rs_tpu.ops.chain_triton import chain_dp_batch_triton

    genome, idx, dev = device_setup
    reads = simulate_reads(genome, 4, read_len=(150, 250), seed=21)
    cp = ChainParams.defaults_for_k(K)
    scal = chain_scalars_from_params(cp)
    mid_occ = max(idx.calc_mid_occ(2e-4), 10)
    A = 256
    B = len(reads)
    grp = np.full((B, A), 0xFFFFFFFF, dtype=np.uint32)
    rpos = np.zeros((B, A), dtype=np.int32)
    qpos = np.zeros((B, A), dtype=np.int32)
    span = np.zeros((B, A), dtype=np.int32)
    for b, (_, s, *_r) in enumerate(reads):
        mv = collect_query_minimizers(s, W, K)
        mv = filter_query_minimizers(mv, 10, 0.01)
        anchors = build_anchors(idx, mv, len(s), mid_occ)
        n = anchors.shape[0]
        grp[b, :n] = (anchors[:, 0] >> np.uint64(32)).astype(np.uint32)
        rpos[b, :n] = (anchors[:, 0] & np.uint64(0x7FFFFFFF)).astype(np.int32)
        qpos[b, :n] = (anchors[:, 1] & np.uint64(0x7FFFFFFF)).astype(np.int32)
        span[b, :n] = ((anchors[:, 1] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    args = (jnp.asarray(grp), jnp.asarray(rpos), jnp.asarray(qpos), jnp.asarray(span))
    f1, p1 = chain_dp_batch(*args, scal, A)
    f2, p2 = chain_dp_batch_triton(*args, scal, A, interpret=True)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))


def test_pallas_aux_chain_matches_scan(device_setup):
    """The aux-accumulating Triton kernel must match the scan variant."""
    import jax.numpy as jnp

    from minimap2_rs_tpu.ops.chain_ops import chain_dp_aux_batch
    from minimap2_rs_tpu.ops.chain_triton import chain_dp_aux_batch_triton

    genome, idx, dev = device_setup
    reads = simulate_reads(genome, 4, read_len=(150, 250), seed=31)
    cp = ChainParams.defaults_for_k(K)
    scal = chain_scalars_from_params(cp)
    mid_occ = max(idx.calc_mid_occ(2e-4), 10)
    A = 256
    B = len(reads)
    rng = np.random.default_rng(0)
    grp = np.full((B, A), 0xFFFFFFFF, dtype=np.uint32)
    rpos = np.zeros((B, A), dtype=np.int32)
    qpos = np.zeros((B, A), dtype=np.int32)
    span = np.zeros((B, A), dtype=np.int32)
    for b, (_, s, *_r) in enumerate(reads):
        mv = collect_query_minimizers(s, W, K)
        mv = filter_query_minimizers(mv, 10, 0.01)
        anchors = build_anchors(idx, mv, len(s), mid_occ)
        n = anchors.shape[0]
        grp[b, :n] = (anchors[:, 0] >> np.uint64(32)).astype(np.uint32)
        rpos[b, :n] = (anchors[:, 0] & np.uint64(0x7FFFFFFF)).astype(np.int32)
        qpos[b, :n] = (anchors[:, 1] & np.uint64(0x7FFFFFFF)).astype(np.int32)
        span[b, :n] = ((anchors[:, 1] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    args = (
        jnp.asarray(grp), jnp.asarray(rpos), jnp.asarray(qpos),
        jnp.asarray(span),
    )
    o1 = chain_dp_aux_batch(*args, scal, A)
    o2 = chain_dp_aux_batch_triton(*args, scal, A, interpret=True)
    for a, b in zip(o1, o2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("w,k", [(10, 15), (5, 11), (19, 19), (3, 17)])
def test_device_sketch_matches_oracle_wk(w, k):
    """Covers both the u32 fast path (2k+1 <= 32) and the u64 path.
    (Odd k only: the kernel refuses even k — see the next test.)"""
    rng = np.random.default_rng(100 + w * k)
    seqs = []
    for _ in range(5):
        n = int(rng.integers(60, 300))
        s = rng.choice(list(b"ACGTN"), size=n, p=[0.3, 0.25, 0.2, 0.22, 0.03])
        seqs.append(bytes(s.astype(np.uint8)))
    seqs.append(b"AC" * 40 + b"N" + b"GGT" * 30)  # tie/reset heavy
    L = 384
    B = len(seqs)
    codes = np.full((B, L), 4, dtype=np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = nt4_encode(s)
        lengths[i] = len(s)
    ks, ps, em = sketch_positions(jnp.asarray(codes), jnp.asarray(lengths), w, k, False)
    em = np.asarray(em)
    keys = _pairs_to_u64(ks.hi, ks.lo)
    psn = np.asarray(ps)
    for b, s in enumerate(seqs):
        dev = {(int(keys[b, j]), int(psn[b, j])) for j in np.nonzero(em[b])[0]}
        exact = {(kk, r & 0xFFFFFFFF) for kk, r in sketch_sequence(s, w, k)}
        assert dev == exact, (b, w, k)


def test_device_sketch_even_k_dispatches_to_exact_scan():
    """Even k admits strand-symmetric k-mers the characterization does
    not model; sketch_positions routes it to the exact scan recurrence
    (ops/sketch_scan.py) and matches the oracle scan."""
    from minimap2_rs_tpu.oracle.sketch import sketch_sequence
    from minimap2_rs_tpu.utils.packing import nt4_encode
    from minimap2_rs_tpu.utils.seqsim import random_genome

    seq = random_genome(600, seed=12)
    L = -(-len(seq) // 8) * 8
    codes = np.full((1, L), 4, np.int32)
    codes[0, : len(seq)] = nt4_encode(seq)
    lengths = jnp.asarray(np.array([len(seq)], dtype=np.int32))
    ks, ps, em = sketch_positions(jnp.asarray(codes), lengths, 3, 16, False)
    kh, kl, p, e = map(np.asarray, (ks.hi, ks.lo, ps, em))
    sel = np.nonzero(e[0])[0]
    dev = set(
        zip(
            ((kh[0, sel].astype(np.uint64) << np.uint64(32)) | kl[0, sel]).tolist(),
            p[0, sel].tolist(),
        )
    )
    oracle = {(a, b & 0xFFFFFFFF) for a, b in sketch_sequence(seq, 3, 16)}
    assert dev == oracle
