"""Device-resident minimizer index and vectorized lookup.

The flat sorted-array layout (oracle/index.py) maps to HBM as ONE
interleaved (U, 4) uint32 row table [key_hi, key_lo, start, count] plus
an interleaved (P, 2) position table — replacing the reference's
per-bucket HashMap probe (/root/reference/src/index.rs:143-154).

The layouts assume random device-memory gathers cost per gathered row
more than per byte: a classic binary search pays log2(bucket) dependent
round trips. The primary layout is therefore a DIRECT-MAPPED table
making a lookup exactly ONE gather (which layouts the GPU keeps is an
open measurement):

    p     = key & (2^dm_bits - 1)          (LOW bits of the hashed key —
                                            markedly more uniform than its
                                            high bits; the reference
                                            buckets by low bits too,
                                            index.rs:69-72)
    rows  = dm[p]                          one row gather
    hit   = rows.fp == key >> dm_bits  ->  (start, count) in-register

Hashed keys are uniform (the invertible hash64 finalizer), so with
2^p ≈ U/2 buckets the max bucket size is small (Poisson tail);
`plan_direct_layout` widens p until every bucket fits S entries. When
the direct table would exceed the byte cap (huge genomes), lookups fall
back to a two-gather scheme: a prefix lower-bound table into the sorted
(U, 4) kv rows, then S single-row gathers (slice gathers spanning rows
lower to a ~30x slower XLA path; see gather_rows).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import u64
from .u64 import U64Pair

I32 = jnp.int32
U32 = jnp.uint32

_MAX_PREFIX_BITS = 26  # 256 MB table cap; beyond this widen bucket_slots


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceIndex:
    """HBM-resident index tables. Metadata (w/k/seq table) stays host-side
    in the companion OracleIndex."""

    kv: jnp.ndarray      # (U + S, 4) uint32 rows [key_hi, key_lo, start, count]
    # (2, P) uint32 PLANES [rid], [pos<<1|strand]: two contiguous 1-D
    # gathers instead of one (P, 2) row gather — XLA lays a (P, 2) row
    # gather out column-major and re-copies the whole table EVERY call
    # (measured 22.7 ms/call on the 5 Mbp headline; plane gathers need
    # no layout change)
    pos: jnp.ndarray
    prefix: jnp.ndarray  # (2^prefix_bits + 1,) int32 lower bounds by key prefix
    # direct-mapped table (2^dm_bits, dm_entry*dm_slots) u32: row p holds
    # bucket p's entries, dm_entry words each:
    #   dm_entry == 2 (compact): [fp | count << dm_shift, start] — the low
    #     dm_shift key bits are the EXACT remaining key (the prefix is
    #     the row address), so matching is exact; empty slots carry
    #     count == 0 which is already "absent".
    #   dm_entry == 4 (wide): [key_hi, key_lo, start, count]; empty slots
    #     carry key U64-max (no real <=56-bit key matches) and count 0.
    # Empty (0, x) when the byte cap forces the two-gather fallback.
    dm: jnp.ndarray = None
    # compact-entry start plane ((2^dm_bits * dm_slots,) u32): phase 2 of
    # the two-phase probe (None for 4-word layouts / no dm table)
    dm_start: jnp.ndarray = None
    # packed-pos mode: (n_seq + 1,) u32 cumulative sequence lengths for
    # on-device rid/rpos recovery (None for the two-plane layout)
    seq_cum: jnp.ndarray = None
    prefix_shift: int = 0   # static: key >> shift yields the prefix
    bucket_slots: int = 8   # static: rows fetched per fallback lookup
    n_keys: int = 0         # static: number of real (unpadded) key rows
    dm_bits: int = 0        # static: key & (2^bits - 1) yields the dm row
    dm_slots: int = 0       # static: entries per dm row (0 = no dm table)
    dm_entry: int = 4       # static: u32 words per entry (2 or 4)
    dm_fp_bits: int = 0     # static: compact-entry fingerprint width
    # static: pos is ONE (1, P) plane of abs_pos<<1|strand words (the
    # anchor expansion recovers rid/rpos from seq_cum in-register) — one
    # gather row per position instead of two plane gathers
    pos_packed: bool = False
    n_seq: int = 0          # static: sequence count (packed-pos mode)

    def tree_flatten(self):
        return (
            (self.kv, self.pos, self.prefix, self.dm, self.dm_start,
             self.seq_cum),
            (self.prefix_shift, self.bucket_slots, self.n_keys,
             self.dm_bits, self.dm_slots, self.dm_entry, self.dm_fp_bits,
             self.pos_packed, self.n_seq),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, prefix_shift=aux[0], bucket_slots=aux[1],
                   n_keys=aux[2], dm_bits=aux[3], dm_slots=aux[4],
                   dm_entry=aux[5], dm_fp_bits=aux[6], pos_packed=aux[7],
                   n_seq=aux[8])

    # ---- compatibility views over the interleaved tables ---------------
    @property
    def keys_hi(self) -> jnp.ndarray:
        return self.kv[: self.n_keys, 0]

    @property
    def keys_lo(self) -> jnp.ndarray:
        return self.kv[: self.n_keys, 1]

    @property
    def starts(self) -> jnp.ndarray:
        return jax.lax.bitcast_convert_type(self.kv[: self.n_keys, 2], I32)

    @property
    def counts(self) -> jnp.ndarray:
        return jax.lax.bitcast_convert_type(self.kv[: self.n_keys, 3], I32)

    @property
    def pos_hi(self) -> jnp.ndarray:
        return self.pos[0]

    @property
    def pos_lo(self) -> jnp.ndarray:
        return self.pos[1]

    @staticmethod
    def from_host(keys: np.ndarray, starts: np.ndarray, counts: np.ndarray,
                  positions: np.ndarray, key_bits: int = 56,
                  seq_lens=None) -> "DeviceIndex":
        """Build the interleaved tables from host uint64 arrays. key_bits
        bounds the hashed key width (2k). seq_lens (per-sequence target
        lengths, optional) enables the PACKED position plane: one
        abs_pos<<1|strand u32 word per position — halving the expansion's
        gather rows — with rid/rpos recovered in-register from the
        cumulative lengths; requires total length < 2^31 and a small
        sequence count (the recovery is an n_seq-step fused compare
        chain)."""
        kv_np, prefix_np, shift, S = plan_prefix_layout(keys, key_bits)
        dm_np, dm_start_np, dm_p, dm_S, dm_entry, pos_perm = plan_direct_layout(
            keys, starts, counts, key_bits
        )
        if pos_perm is not None:
            # fused layout: the device position planes live in
            # bucket-grouped order (the dm rows' base/offsets address
            # THIS order); the host-side OracleIndex keeps the original
            # key-sorted layout for serialization and the host pipeline
            positions = positions[pos_perm]
        P = positions.shape[0]
        cum = None
        if seq_lens is not None:
            cum = np.zeros(len(seq_lens) + 1, dtype=np.int64)
            np.cumsum(np.asarray(seq_lens, dtype=np.int64), out=cum[1:])
        pos_packed = (
            cum is not None and cum[-1] < (1 << 31) and len(cum) - 1 <= 64
        )
        if pos_packed:
            rid = (positions >> np.uint64(32)).astype(np.int64)
            rps = (positions & np.uint64(0xFFFFFFFF)).astype(np.int64)
            absw = ((cum[rid] + (rps >> 1)) << 1) | (rps & 1)
            pos_np = np.zeros((1, max(P, 1)), dtype=np.uint32)
            pos_np[0, :P] = absw.astype(np.uint32)
        else:
            # np.empty: both planes are fully overwritten below when
            # P >= 1; only the P == 0 sentinel column needs zeroing
            pos_np = np.empty((2, max(P, 1)), dtype=np.uint32)
            if P == 0:
                pos_np[:] = 0
            pos_np[0, :P] = (positions >> np.uint64(32)).astype(np.uint32)
            pos_np[1, :P] = (positions & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        kv_np[: keys.shape[0], 2] = starts.astype(np.uint32)
        kv_np[: keys.shape[0], 3] = counts.astype(np.uint32)
        if dm_S:
            # index_lookup never touches kv/prefix once dm exists; keep
            # only sentinel rows on device (the full kv would cost up to
            # ~1.5x extra HBM on large genomes). n_keys stays the real
            # count for stats; the keys_hi/starts/... views are only
            # meaningful when the fallback tables are resident.
            kv_np = kv_np[:1]
            prefix_np = prefix_np[:2]
        return DeviceIndex(
            kv=jnp.asarray(kv_np),
            pos=jnp.asarray(pos_np),
            prefix=jnp.asarray(prefix_np),
            dm=jnp.asarray(dm_np),
            dm_start=(jnp.asarray(dm_start_np)
                      if dm_start_np is not None else None),
            seq_cum=(jnp.asarray(cum.astype(np.uint32))
                     if pos_packed else None),
            prefix_shift=shift,
            bucket_slots=S,
            n_keys=int(keys.shape[0]),
            dm_bits=dm_p,
            dm_slots=dm_S,
            dm_entry=dm_entry,
            dm_fp_bits=max(0, key_bits - dm_p),
            pos_packed=pos_packed,
            n_seq=(len(cum) - 1 if pos_packed else 0),
        )


def plan_prefix_layout(keys: np.ndarray, key_bits: int):
    """Choose (prefix_bits, bucket_slots) so every prefix bucket fits in
    one bucket_slots-row slice, and build the padded key table + prefix
    lower bounds. Returns (kv[:, :2] filled, prefix, shift, S); caller
    fills columns 2-3. Shared with the sharded index builder."""
    U = int(keys.shape[0])
    # Smallest prefix table whose max bucket fits S<=16 rows: a compact
    # prefix table (cache and DRAM-row locality) + one 16-row wide
    # gather, rather than many buckets with tiny S.
    prefix_bits = max(12, min(int(np.ceil(np.log2(U + 1))), _MAX_PREFIX_BITS, key_bits))
    prefix_bits = min(prefix_bits, _MAX_PREFIX_BITS, key_bits)
    shift = max(0, key_bits - prefix_bits)
    prefixes = (keys >> np.uint64(shift)).astype(np.int64)
    hist = np.bincount(prefixes, minlength=(1 << prefix_bits))
    while hist.max(initial=1) > 16 and prefix_bits < min(_MAX_PREFIX_BITS, key_bits):
        prefix_bits += 1
        shift = max(0, key_bits - prefix_bits)
        prefixes = (keys >> np.uint64(shift)).astype(np.int64)
        hist = np.bincount(prefixes, minlength=(1 << prefix_bits))
    prefix_np = np.zeros((1 << prefix_bits) + 1, dtype=np.int32)
    np.cumsum(hist, out=prefix_np[1:])
    maxb = int(hist.max()) if U else 1
    S = 4
    while S < maxb:
        S *= 2
    kv_np = np.full((U + S, 4), 0xFFFFFFFF, dtype=np.uint32)
    kv_np[:U, 0] = (keys >> np.uint64(32)).astype(np.uint32)
    kv_np[:U, 1] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    kv_np[U:, 3] = 0  # sentinel rows never match, and count 0 is safe
    return kv_np, prefix_np, shift, S


_DM_BYTE_CAP = 1 << 31  # 2 GB: beyond this, fall back to two-gather lookups


def plan_direct_layout(
    keys: np.ndarray, starts: np.ndarray, counts: np.ndarray, key_bits: int,
    byte_cap: int = _DM_BYTE_CAP,
):
    """Direct-mapped table addressed by the LOW p key bits (the
    reference's bucket choice, index.rs:69-72 — hash64's low bits are
    markedly more uniform than its high bits: at 917k keys the same p
    gives max-bucket 16 by low bits vs 36 by high). Smaller tables gather
    faster (cache and DRAM locality), so prefer the compact 2-word
    entry [fp | count << fp_bits, start] whenever the remaining HIGH key
    bits (fp = key >> p, fp_bits = key_bits - p <= 12) and the largest
    occurrence count fit one u32; else 4-word [key_hi, key_lo, start,
    count] entries.

    When the compact entry fits, the single-chip planner upgrades it to
    the FUSED layout (entry sentinel 3): one (2^p, S+1) row [S metas |
    pos_base] per bucket, with the POSITIONS table permuted to
    bucket-grouped order so `start` is derived in-register (base + the
    exclusive prefix sum of the gathered slot counts) — ONE gather row
    per probe instead of meta row + start plane, for lookups bound by the
    number of gathered rows.

    Returns (table, dm_start_or_None, p, S, entry_words, pos_perm):
    pos_perm is the permutation the caller must apply to the positions
    array (None for non-fused layouts); (empty, None, 0, 0, 4, None)
    when over cap."""
    U = int(keys.shape[0])
    if U == 0:
        return np.zeros((0, 4), dtype=np.uint32), None, 0, 0, 4, None
    layout = choose_direct_layout([keys], key_bits, int(counts.max()), byte_cap)
    if layout is None:
        return np.zeros((0, 4), dtype=np.uint32), None, 0, 0, 4, None
    p, S, entry = layout
    if entry == 2:
        dm, pos_perm = fill_direct_table_fused(keys, starts, counts, key_bits, p, S)
        return dm, None, p, S, 3, pos_perm
    dm, dm_start = fill_direct_table(keys, starts, counts, key_bits, p, S, entry)
    return dm, dm_start, p, S, entry, None


def fill_direct_table_fused(
    keys: np.ndarray, starts: np.ndarray, counts: np.ndarray,
    key_bits: int, p: int, S: int,
):
    """Build the fused single-gather table: row p = [meta_0..meta_{S-1},
    base] where meta_s = fp | count << fp_bits (the compact entry) and
    base is bucket p's first position offset in the BUCKET-GROUPED
    positions table. Returns (dm (2^p, S+1) u32, pos_perm int64): the
    caller must reorder its positions array as positions[pos_perm] —
    bucket ascending, keys by ascending full key within a bucket (the
    same rank order that assigns slots), original order within a key."""
    U = int(keys.shape[0])
    fp_bits = key_bits - p
    pref = (keys & np.uint64((1 << p) - 1)).astype(np.int64)
    # keys are sorted by full key, so a stable bucket sort groups each
    # bucket's keys in ascending-key order == the slot rank order
    order = np.argsort(pref, kind="stable")
    sp = pref[order]
    first_sorted = np.searchsorted(sp, sp, side="left")
    rank = np.arange(U, dtype=np.int64) - first_sorted
    cnt_o = counts[order].astype(np.int64)
    out_off = np.zeros(U + 1, dtype=np.int64)
    np.cumsum(cnt_o, out=out_off[1:])
    pos_perm = (
        np.repeat(starts[order].astype(np.int64) - out_off[:-1], cnt_o)
        + np.arange(out_off[-1], dtype=np.int64)
    )
    dm = np.zeros((1 << p, S + 1), dtype=np.uint32)
    fp_o = (keys[order] >> np.uint64(p)).astype(np.uint32)
    dm[sp, rank] = fp_o | (cnt_o.astype(np.uint32) << np.uint32(fp_bits))
    # every key in a bucket writes the same base; absent buckets keep 0
    # (their probes see count == 0, so the garbage start is masked)
    dm[sp, S] = out_off[first_sorted].astype(np.uint32)
    return dm, pos_perm


def choose_direct_layout(
    key_slices: list, key_bits: int, max_count: int,
    byte_cap: int = _DM_BYTE_CAP,
):
    """Pick one (p, S, entry) layout covering every key slice (one per
    shard; a single slice for the unsharded index). byte_cap bounds ONE
    table — each device holds exactly one.

    Selection is pure min-bytes (gather cost grows with table bytes;
    the compact 2-word entry wins exactly when it shrinks the table).

    Returns None when infeasible."""
    sizes = max(max(int(ks.shape[0]) for ks in key_slices), 1)
    cands = []  # (nbytes, p, S, entry)
    best_bytes = None
    p_lo = max(12, int(np.ceil(np.log2(sizes + 1))) - 2)
    p_hi = min(_MAX_PREFIX_BITS, key_bits)
    # first p where 2-word entries become possible (fp_bits <= 12)
    compact_p = key_bits - 12
    for p in range(min(p_lo, key_bits), p_hi + 1):
        maxb = 1
        for ks in key_slices:
            if ks.shape[0]:
                pref = (ks & np.uint64((1 << p) - 1)).astype(np.int64)
                maxb = max(maxb, int(np.bincount(pref, minlength=1 << p).max()))
        S = 4
        while S < maxb:
            S *= 2
        fp_bits = key_bits - p
        # compact entries need fp + count to share one u32
        entry = 2 if (fp_bits <= 12 and max_count < (1 << (32 - fp_bits))) else 4
        nbytes = (1 << p) * S * entry * 4
        cands.append((nbytes, p, S, entry))
        # strictly below the cap (matching the final selection below): a
        # table at exactly the 2 GB boundary is asking for 32-bit edge
        # cases in the transfer path, and counting it as feasible here
        # while filtering it out below would crash min() on empty feas
        if nbytes < byte_cap and (best_bytes is None or nbytes < best_bytes):
            best_bytes = nbytes
        if (
            best_bytes is not None
            and S <= 8
            and nbytes >= 2 * best_bytes
            and (p >= compact_p or compact_p > p_hi)
        ):
            break  # occupancy has bottomed out; larger p only grows the
            # table (and the entry 4->2 halving point is behind us)
    if best_bytes is None:
        return None
    feas = [c for c in cands if c[0] < byte_cap]
    _nb, p, S, entry = min(feas)
    return p, S, entry


def fill_direct_table(
    keys: np.ndarray, starts: np.ndarray, counts: np.ndarray,
    key_bits: int, p: int, S: int, entry: int,
) -> np.ndarray:
    """Build one direct-mapped table at a FORCED (p, S, entry) layout —
    shared by the single-chip planner above and the sharded builder,
    which needs one uniform layout across shards so a single compiled
    program serves every device."""
    U = int(keys.shape[0])
    fp_bits = key_bits - p
    pref = (keys & np.uint64((1 << p) - 1)).astype(np.int64)
    # within-bucket rank (buckets by low bits are not sorted-contiguous)
    order = np.argsort(pref, kind="stable")
    sp = pref[order]
    first_sorted = np.searchsorted(sp, sp, side="left")
    rank = np.empty(U, dtype=np.int64)
    rank[order] = np.arange(U) - first_sorted
    slot = pref * S + rank
    if entry == 2:
        # TWO-PHASE probe layout: the S meta words [fp | count << fp_bits]
        # live in their own (2^p, S) table (the only bytes every probe
        # gathers); the start words live in a flat (2^p * S,) plane
        # fetched by ONE 1-D gather at the hit slot. Halves probe
        # traffic vs packed [meta, start] rows.
        meta = np.zeros(((1 << p) * S,), dtype=np.uint32)
        start_plane = np.zeros(((1 << p) * S,), dtype=np.uint32)
        fp = (keys >> np.uint64(p)).astype(np.uint32)
        meta[slot] = fp | (counts.astype(np.uint32) << np.uint32(fp_bits))
        start_plane[slot] = starts.astype(np.uint32)
        return meta.reshape(1 << p, S), start_plane
    dm = np.full(((1 << p) * S, 4), 0xFFFFFFFF, dtype=np.uint32)
    dm[:, 3] = 0
    dm[slot, 0] = (keys >> np.uint64(32)).astype(np.uint32)
    dm[slot, 1] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    dm[slot, 2] = starts.astype(np.uint32)
    dm[slot, 3] = counts.astype(np.uint32)
    return dm.reshape(1 << p, entry * S), None


def gather_rows(table: jnp.ndarray, base: jnp.ndarray, S: int) -> jnp.ndarray:
    """table (N, C); base any int shape -> (*base.shape, S, C): S
    consecutive rows per query, clamped at the end.

    Deliberately S separate single-row gathers rather than one gather
    whose slice spans S major-dim rows (slice_sizes=(S, C)), which XLA
    has lowered to a much slower path."""
    N = table.shape[0]
    if S == 1:
        return table[jnp.clip(base, 0, N - 1)][..., None, :]
    i = base[..., None] + jnp.arange(S, dtype=I32)
    return table[jnp.clip(i, 0, N - 1)]


@functools.partial(jax.jit)
def index_lookup(idx: DeviceIndex, q: U64Pair):
    """For each query key: (start, count) of its occurrence block, count 0
    when absent (Index::get, index.rs:143-154). ONE row gather on the
    direct-mapped table; two-gather prefix fallback otherwise."""
    if idx.dm is not None and idx.dm_slots and idx.dm_entry == 3:
        # fused single-gather probe: the row carries the S compact metas
        # PLUS the bucket's position base; start = base + the exclusive
        # prefix sum of the earlier slots' counts (slots are rank-dense,
        # so every slot before the hit is a real key of this bucket).
        # Lookups are gather-row bound, so one (S+1)-word row beats the
        # meta-row + start-plane pair (~2x fewer rows).
        S = idx.dm_slots
        fpb = idx.dm_fp_bits
        p = jnp.clip(
            (q.lo & U32((1 << idx.dm_bits) - 1)).astype(I32),
            0, idx.dm.shape[0] - 1,
        )
        row = idx.dm[p]  # (..., S + 1) row gather
        meta = row[..., :S]
        base = row[..., S]
        fpm = U32((1 << fpb) - 1)
        fp = u64.shr(q, idx.dm_bits).lo & fpm
        hit = (meta & fpm) == fp[..., None]
        cnts = meta >> U32(fpb)
        # distinct keys in one bucket have distinct fps: <= 1 real hit
        # (an fp == 0 query can also "hit" empty slots, but those carry
        # count == 0 and sit after every real slot, so argmax finds the
        # real slot first and the count max ignores them)
        slot = jnp.argmax(hit, axis=-1).astype(I32)
        sidx = jax.lax.broadcasted_iota(I32, meta.shape, meta.ndim - 1)
        before = jnp.sum(
            jnp.where(sidx < slot[..., None], cnts, U32(0)), axis=-1
        )
        count = jnp.max(jnp.where(hit, cnts, U32(0)), axis=-1)
        start = jnp.where(count > U32(0), base + before, U32(0))
        return (
            jax.lax.bitcast_convert_type(start, I32),
            jax.lax.bitcast_convert_type(count, I32),
        )
    if idx.dm is not None and idx.dm_slots and idx.dm_entry == 2:
        # two-phase probe: gather the S meta words, find the (unique)
        # hit slot, then ONE 1-D gather for its start word — half the
        # probe bytes of packed [meta, start] rows
        S = idx.dm_slots
        fpb = idx.dm_fp_bits
        p = jnp.clip(
            (q.lo & U32((1 << idx.dm_bits) - 1)).astype(I32),
            0, idx.dm.shape[0] - 1,
        )
        meta = idx.dm[p]  # (..., S) row gather
        fpm = U32((1 << fpb) - 1)
        fp = u64.shr(q, idx.dm_bits).lo & fpm
        hit = (meta & fpm) == fp[..., None]
        # distinct keys in one bucket have distinct fps: <= 1 hit
        slot = jnp.argmax(hit, axis=-1).astype(I32)
        found = jnp.any(hit, axis=-1)
        start = jnp.where(found, idx.dm_start[p * S + slot], U32(0))
        # empty slots carry count == 0, which is already "absent"
        count = jnp.max(jnp.where(hit, meta >> U32(fpb), U32(0)), axis=-1)
        return (
            jax.lax.bitcast_convert_type(start, I32),
            jax.lax.bitcast_convert_type(count, I32),
        )
    if idx.dm is not None and idx.dm_slots:
        S = idx.dm_slots
        p = (q.lo & U32((1 << idx.dm_bits) - 1)).astype(I32)
        wide = gather_rows(idx.dm, p, 1)  # (..., 1, 4*S)
        rows = wide.reshape(*p.shape, S, 4)
    else:
        p = u64.shr(q, idx.prefix_shift).lo.astype(I32)
        p = jnp.clip(p, 0, idx.prefix.shape[0] - 2)
        base = idx.prefix[p]
        S = idx.bucket_slots
        rows = gather_rows(idx.kv, base, S)  # (..., S, 4)
    hit = (rows[..., 0] == q.hi[..., None]) & (rows[..., 1] == q.lo[..., None])
    start = jnp.max(jnp.where(hit, rows[..., 2], U32(0)), axis=-1)
    count = jnp.max(jnp.where(hit, rows[..., 3], U32(0)), axis=-1)
    return (
        jax.lax.bitcast_convert_type(start, I32),
        jax.lax.bitcast_convert_type(count, I32),
    )


def lower_bound_u64pair(
    keys: U64Pair, q: U64Pair, n_keys: int | None = None
) -> jnp.ndarray:
    """Vectorized lower_bound of q (any shape) in sorted `keys` (1-D)."""
    n = keys.hi.shape[0] if n_keys is None else n_keys
    lo = jnp.zeros(q.hi.shape, dtype=I32)
    hi = jnp.full(q.hi.shape, n, dtype=I32)
    steps = max(1, int(np.ceil(np.log2(n + 1))) + 1)

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) >> 1
        kmid = U64Pair(keys.hi[mid], keys.lo[mid])
        go_right = u64.lt(kmid, q)
        return jnp.where(go_right, mid + 1, lo), jnp.where(go_right, hi, mid)

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return lo
