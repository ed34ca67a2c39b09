"""Shared device pipeline stages.

The mapping pipeline (sketch -> minimizer compaction -> occ filter ->
index lookup -> anchor expansion -> chain DP -> on-device finalize) is
composed three ways:

  * the single-chip fused jits in models/mapper.py,
  * the data-parallel mesh step (reads sharded over "dp", index
    replicated) in parallel/pipeline.py, and
  * the hash-range-sharded mesh step, which splits between
    `sketch_to_anchors` and `chain_finalize_lite` to insert the
    all_to_all anchor exchange (parallel/pipeline.py).

Reference analog: the whole align stack /root/reference/src/main.rs:189-230,
distributed per SURVEY.md section 2's parallelism table.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.chain_ops import ChainScalars
from ..ops.index_ops import DeviceIndex
from ..ops.seeds_ops import build_anchors_device, query_occ_filter, sort_minimizers_by_key
from ..ops.sketch import compact_minimizers, sketch_positions

I32 = jnp.int32
U32 = jnp.uint32


def unpack_codes4(codes4: jnp.ndarray) -> jnp.ndarray:
    """(B, L//2) uint8 two-nibble packed nt4 codes -> (B, L) int32
    (the unpack fuses into the device program)."""
    B = codes4.shape[0]
    lo = (codes4 & jnp.uint8(0xF)).astype(I32)
    hi = (codes4 >> 4).astype(I32)
    return jnp.stack([lo, hi], axis=-1).reshape(B, codes4.shape[1] * 2)


def unpack_codes2(codes2: jnp.ndarray, lengths: jnp.ndarray,
                  nex: jnp.ndarray) -> jnp.ndarray:
    """2-bit H2D wire -> (B, L) int32 nt4 codes, bit-identical to the
    4-bit wire: (B, L//4) uint8 rows of 4 codes/byte, positions past
    each read's length masked to the nt4=4 sentinel on device (padding
    ships no bytes and no exceptions), and the rare ambiguous bases
    scattered back to 4 from the flat exception list `nex` (padded with
    the out-of-range B*L sentinel, dropped by the scatter). Halves the
    dominant H2D payload vs the 4-bit wire."""
    B, L4 = codes2.shape
    L = L4 * 4
    parts = [((codes2 >> (2 * s)) & jnp.uint8(3)).astype(I32) for s in range(4)]
    codes = jnp.stack(parts, axis=-1).reshape(B, L)
    idx = jnp.arange(L, dtype=I32)[None, :]
    codes = jnp.where(idx < lengths[:, None], codes, 4)
    flat = codes.reshape(-1).at[nex].set(4, mode="drop")
    return flat.reshape(B, L)


def sketch_compact_filter(
    codes: jnp.ndarray,     # (B, L) int32 nt4 codes
    lengths: jnp.ndarray,   # (B,) int32
    *,
    w: int, k: int, hpc: bool, q_occ_max: int, q_occ_frac: float, M: int,
) -> dict:
    """Index-independent per-read work: sketch, minimizer compaction,
    key sort, query-occurrence filter (seeds.rs:7-36).

    Split from the index lookup so the hash-range-sharded mesh mode can
    run this ONCE on each read's home device and all_gather only the
    compact (B, M) minimizer payloads to the index shards — instead of
    re-sketching the whole dp row on every shard."""
    ks, ps, emitted = sketch_positions(codes, lengths, w, k, hpc)
    cks, cps, n_mini, mini_ovf = compact_minimizers(ks, ps, emitted, M)
    sks, sps = sort_minimizers_by_key(cks, cps)
    keep = query_occ_filter(sks, n_mini, q_occ_max, q_occ_frac)
    return dict(
        sks_hi=sks.hi, sks_lo=sks.lo, sps=sps, keep=keep,
        cps=cps, mini_span=(cks.lo & U32(0xFF)) if hpc else None,
        n_mini=n_mini, mini_ovf=mini_ovf,
    )


def lookup_expand(
    dev_idx: DeviceIndex,
    mini: dict,             # sketch_compact_filter output (or a gather)
    lengths: jnp.ndarray,   # (B,) int32
    mid_occ: jnp.ndarray,   # scalar int32
    A: int,
) -> dict:
    """Index-dependent half: lookup + masked anchor expansion + per-read
    anchor sort (seeds.rs:42-79) against (this shard of) the index."""
    from ..ops.u64 import U64Pair

    x_hi, x_lo, y_hi, y_lo, n_anchors, anc_ovf = build_anchors_device(
        dev_idx, U64Pair(mini["sks_hi"], mini["sks_lo"]), mini["sps"],
        mini["keep"], lengths, mid_occ, A,
    )
    return dict(
        x_hi=x_hi, x_lo=x_lo, y_hi=y_hi, y_lo=y_lo,
        n_anchors=n_anchors, anc_ovf=anc_ovf,
    )


def sketch_to_anchors(
    dev_idx: DeviceIndex,
    codes: jnp.ndarray,     # (B, L) int32 nt4 codes
    lengths: jnp.ndarray,   # (B,) int32
    mid_occ: jnp.ndarray,   # scalar int32
    *,
    w: int, k: int, hpc: bool, q_occ_max: int, q_occ_frac: float,
    M: int, A: int,
) -> dict:
    """Per-read minimizers + anchors against (this shard of) the index.

    Returns a dict of (B, ...) arrays: sorted anchors x_hi/x_lo/y_hi/y_lo
    (padding x_hi = 0xFFFFFFFF), n_anchors, anc_ovf, position-sorted
    minimizer payloads cps (pos<<1|strand), mini_span (low key byte;
    None unless hpc), n_mini, mini_ovf."""
    mini = sketch_compact_filter(
        codes, lengths, w=w, k=k, hpc=hpc,
        q_occ_max=q_occ_max, q_occ_frac=q_occ_frac, M=M,
    )
    anc = lookup_expand(dev_idx, mini, lengths, mid_occ, A)
    anc.update(
        cps=mini["cps"], mini_span=mini["mini_span"],
        n_mini=mini["n_mini"], mini_ovf=mini["mini_ovf"],
    )
    return anc


def chain_finalize_lite(
    anc: dict,               # sketch_to_anchors output (possibly exchanged)
    lengths: jnp.ndarray,    # (B,) int32
    scalars: ChainScalars,
    scalars_wide: ChainScalars,
    tlens: jnp.ndarray,      # (n_seq,) int32
    rmq_rescue_size: jnp.ndarray,
    rmq_rescue_ratio: jnp.ndarray,
    *,
    k: int, hpc: bool, window: int,
    pallas_chain: bool = False,
    flag_window_ovf: bool = False,
    max_chain_skip: int | None = None,
    wide: bool = True,
) -> jnp.ndarray:
    """Chain DP + on-device finalization; returns the (B, 18) int32 PAF
    field rows (ops/finalize_ops.FIELDS).

    wide=True (dual-band) also runs the bw_long band and switches to it
    for reads whose normal-band rescue flag fired (lchain.rs:321-330,
    resolved without a round-trip) — used by the mesh paths and the
    overflow tier. wide=False computes ONLY the `scalars` band (halving
    the dominant DP cost); the caller reads the returned rescue flag and
    re-runs flagged reads through the same executable with the bw_long
    scalars (chain scalars are traced, so no recompile — see
    Mapper._drain_wides_lite).

    The window-truncation flag is computed PER BAND with that band's own
    max_dist_x — the wide row runs at bw_long where a predecessor beyond
    the window cap is far more likely to still be in band."""
    from ..ops.finalize_ops import (
        FIELDS,
        finalize_from_aux,
        pack_fields_wire,
        wire_packable,
    )

    if pallas_chain and max_chain_skip is None:
        from ..ops.chain_triton import chain_dp_aux_batch_triton as _chain_fn
    else:
        from ..ops.chain_ops import chain_dp_aux_batch as _chain_fn
        import functools

        # max_chain_skip=None is the exact window; an int replicates the
        # reference's pruning (lchain.rs:79-88) in the scan kernel
        _chain_fn = functools.partial(_chain_fn, max_chain_skip=max_chain_skip)

    x_hi, x_lo, y_hi, y_lo = anc["x_hi"], anc["x_lo"], anc["y_hi"], anc["y_lo"]
    n_anchors, anc_ovf = anc["n_anchors"], anc["anc_ovf"]
    cps, n_mini, mini_ovf = anc["cps"], anc["n_mini"], anc["mini_ovf"]
    B, A = x_hi.shape
    M = cps.shape[1]
    mini_pos = cps >> U32(1)  # position-sorted; padding stays max
    args = (
        x_hi, x_lo.astype(I32), y_lo.astype(I32),
        (y_hi & U32(0xFF)).astype(I32),
    )

    def _win_ovf_for(mdx):
        # exact truncation detector: with anchors sorted by x, a
        # predecessor farther than `window` slots can pass the reference's
        # max_dist_x gate (lchain.rs:75) only if x[i] - x[i-window] <= mdx
        if not (flag_window_ovf and A > window):
            return None
        from ..ops import u64 as _u64

        xa = _u64.U64Pair(x_hi, x_lo)
        thr = _u64.sub_u32_sat(xa, mdx)
        far = _u64.le(
            _u64.U64Pair(thr.hi[:, window:], thr.lo[:, window:]),
            _u64.U64Pair(x_hi[:, :-window], x_lo[:, :-window]),
        )
        slot = jnp.arange(window, A, dtype=I32)[None, :]
        far = far & (slot < n_anchors[:, None])
        return jnp.any(far, axis=1)

    if hpc:
        spans = (y_hi & U32(0xFF)).astype(I32)
        mslot = jnp.arange(M, dtype=I32)[None, :]
        sum_span = jnp.sum(
            jnp.where(
                mslot < n_mini[:, None], anc["mini_span"].astype(I32), 0
            ),
            axis=1,
        )
    else:
        spans = None
        sum_span = None
    fields = []
    for scal in (scalars, scalars_wide) if wide else (scalars,):
        f, cnt, sq, sr = _chain_fn(*args, scal, window)
        fields.append(finalize_from_aux(
            f, cnt, sq, sr, x_hi, x_lo, y_lo, n_anchors,
            mini_pos, n_mini, lengths, tlens, mini_ovf, anc_ovf,
            k, rmq_rescue_size, rmq_rescue_ratio,
            win_ovf=_win_ovf_for(scal.max_dist_x), spans=spans,
            sum_span=sum_span,
        ))
    # ship the compact wire rows when the counters are statically
    # 16-bit-bounded (always true for the mapper's capacities); the
    # host's _drain_pending unpacks by wire width
    pack = pack_fields_wire if wire_packable(A, M) else (lambda x: x)
    if not wide:
        return pack(fields[0])
    # resolve the rescue switch on device: ship one row per read.
    # The merged row's rescue column carries the NORMAL band's flag (the
    # wide row's own flag is meaningless post-switch), so the host can
    # count device-resolved rescues (models/mapper.py stats, asserted
    # non-vacuous by __graft_entry__.dryrun_multichip).
    ri = FIELDS.index("rescue")
    resc = fields[0][:, ri] != 0
    merged = jnp.where(resc[:, None], fields[1], fields[0])
    return pack(merged.at[:, ri].set(resc.astype(merged.dtype)))
