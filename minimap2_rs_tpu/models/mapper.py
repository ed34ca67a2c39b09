"""The flagship end-to-end mapping model.

Device (one fused jit per length bucket):
    nt4 codes -> sketch_positions -> compact -> key-sort -> occ filter ->
    index lookup -> anchor expansion -> anchor sort -> chaining DP
Host:
    backtracking, chain selection/merge/rescue decision, PAF + dv
    (pointer-chasing over a few hundred elements per read; SURVEY.md
    section 7 hard part 5).

Reads are bucketed by length into static shapes; reads whose minimizer or
anchor population overflows the bucket's padded capacity fall back to the
reference-faithful host pipeline, so output is always complete.

The rescue pass (lchain.rs:321-330) is resolved ON DEVICE for short-read
shapes: the lite path computes both the normal and bw_long bands and
switches rows whose rescue flag fired (models/stages.py), so no separate
re-run call is needed. Output stays bytes end to end (map_reads_paf).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ChainParams, MapParams
from ..oracle.index import OracleIndex
from ..oracle import lchain as olchain
from ..oracle import pipeline as opipeline
from ..oracle.paf import write_paf_many_with_scores
from ..ops.chain_ops import ChainScalars, chain_dp_batch, chain_scalars_from_params
from ..ops.index_ops import DeviceIndex
from ..utils.packing import nt4_encode

I32 = jnp.int32


def _combine64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _dv_from_fields(fields: np.ndarray, col: dict) -> np.ndarray:
    """dv for the whole batch in one vectorized float32 pass (bit-equal
    to the reference's scalar f32 math, paf.rs:156-199)."""
    avg_k = fields[:, col["sum_span"]].astype(np.float32) / np.maximum(
        fields[:, col["n_mini"]], 1
    ).astype(np.float32)
    kf = np.maximum(avg_k, np.float32(1.0))
    frac = fields[:, col["n_match"]].astype(np.float32) / np.maximum(
        fields[:, col["n_tot"]], 1
    ).astype(np.float32)
    return np.where(
        (frac < np.float32(1.0)) & (fields[:, col["dv_found"]] != 0),
        np.float32(1.0) - frac ** (np.float32(1.0) / kf),
        np.float32(0.0),
    )


from .stages import unpack_codes4 as _unpack_codes4  # noqa: E402 (wire format)

# per-batch capacity of the 2-bit wire's ambiguous-base exception list;
# batches with more Ns fall back to the 4-bit wire
_NEX_CAP = 2048

# anchor capacity from which a bucket runs one chain band per call (see
# Mapper._dual_band)
DUAL_BAND_MAX_A = 1024


def _pack_codes4_host(codes: np.ndarray) -> np.ndarray:
    return codes[:, 0::2] | (codes[:, 1::2] << 4)


@functools.partial(
    jax.jit,
    static_argnames=(
        "w", "k", "hpc", "q_occ_max", "q_occ_frac", "M", "A", "window",
        "pallas_chain", "packed", "max_chain_skip",
    ),
)
def _fused_map_stage(
    dev_idx: DeviceIndex,
    codes: jnp.ndarray,
    lengths: jnp.ndarray,
    scalars: ChainScalars,
    mid_occ: jnp.ndarray,
    *,
    w: int,
    k: int,
    hpc: bool,
    q_occ_max: int,
    q_occ_frac: float,
    M: int,
    A: int,
    window: int,
    pallas_chain: bool = False,
    packed: bool = False,
    max_chain_skip: int | None = None,
):
    """The whole per-batch device pipeline as one XLA program.

    max_chain_skip replicates the reference's order-dependent pruning
    exactly (lchain.rs:79-88; scan kernel only — it forces
    pallas_chain=False); default None scores the window exactly."""
    from .stages import sketch_to_anchors

    if packed:
        codes = _unpack_codes4(codes)
    # seeds_ops packs query pos<<1|strand into 23 bits (span<<23 | ps)
    assert codes.shape[-1] <= 1 << 22, "reads longer than 4M bases unsupported"
    anc = sketch_to_anchors(
        dev_idx, codes, lengths, mid_occ,
        w=w, k=k, hpc=hpc, q_occ_max=q_occ_max, q_occ_frac=q_occ_frac,
        M=M, A=A,
    )
    f, prev = _chain_scores(
        anc["x_hi"], anc["x_lo"], anc["y_hi"], anc["y_lo"], scalars, window,
        pallas_chain, max_chain_skip,
    )
    # every output packed into one uint32 buffer (one device->host copy).
    # The dv estimate only needs minimizer positions (+ spans under HPC;
    # otherwise every span is exactly k, sketch.rs:63).
    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.uint32)
    cols = [anc["x_hi"], anc["x_lo"], anc["y_hi"], anc["y_lo"],
            bc(f), bc(prev), anc["cps"]]
    if hpc:
        cols.append(anc["mini_span"])
    cols += [
        bc(anc["n_mini"])[:, None], bc(anc["n_anchors"])[:, None],
        anc["mini_ovf"].astype(jnp.uint32)[:, None],
        anc["anc_ovf"].astype(jnp.uint32)[:, None],
    ]
    return jnp.concatenate(cols, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "w", "k", "hpc", "q_occ_max", "q_occ_frac", "M", "A", "window",
        "pallas_chain", "flag_window_ovf", "wire", "max_chain_skip",
        "wide",
    ),
)
def _fused_map_stage_lite(
    dev_idx: DeviceIndex,
    codes: jnp.ndarray,
    lengths: jnp.ndarray,
    nex: jnp.ndarray,
    scalars: ChainScalars,
    scalars_wide: ChainScalars,
    mid_occ: jnp.ndarray,
    tlens: jnp.ndarray,
    rmq_rescue_size: jnp.ndarray,
    rmq_rescue_ratio: jnp.ndarray,
    *,
    w: int,
    k: int,
    hpc: bool,
    q_occ_max: int,
    q_occ_frac: float,
    M: int,
    A: int,
    window: int,
    pallas_chain: bool = False,
    flag_window_ovf: bool = False,
    wire: str = "none",
    max_chain_skip: int | None = None,
    wide: bool = True,
):
    """Default-parameter fast path: the whole pipeline INCLUDING chain
    finalization on device; output is one compact wire row per read
    (ops/finalize_ops.pack_fields_wire), already switched to the
    bw_long wide-band result for reads whose normal-band rescue flag
    fired. The chain kernel accumulates per-chain statistics along the
    prev path, so no backtracking exists anywhere; computing BOTH bands
    up front costs a few ms of DP and removes the separate rescue
    round-trip (lchain.rs:321-330) entirely.
    Valid when min_cnt >= 2 (the reference backtrack always takes its
    greedy single-chain fallback); HPC spans ride along in y_hi and the
    sum_span field. Stage bodies are shared with the mesh paths
    (models/stages.py, parallel/pipeline.py). wire selects the H2D
    codes format: "2bit" (4 codes/byte + N-exception scatter — the
    default production wire), "4bit" (two nibbles/byte), or "none"
    (raw int32 codes); nex is only read by the 2-bit wire."""
    from .stages import chain_finalize_lite, sketch_to_anchors, unpack_codes2

    if wire == "4bit":
        codes = _unpack_codes4(codes)
    elif wire == "2bit":
        codes = unpack_codes2(codes, lengths, nex)
    assert codes.shape[-1] <= 1 << 22, "reads longer than 4M bases unsupported"
    anc = sketch_to_anchors(
        dev_idx, codes, lengths, mid_occ,
        w=w, k=k, hpc=hpc, q_occ_max=q_occ_max, q_occ_frac=q_occ_frac,
        M=M, A=A,
    )
    return chain_finalize_lite(
        anc, lengths, scalars, scalars_wide, tlens,
        rmq_rescue_size, rmq_rescue_ratio,
        k=k, hpc=hpc, window=window, pallas_chain=pallas_chain,
        flag_window_ovf=flag_window_ovf, max_chain_skip=max_chain_skip,
        wide=wide,
    )


def _chain_skip_cfg(cp) -> int | None:
    """MM2T_SKIP_PRUNE=1 makes the device DP replicate the reference's
    order-dependent max_chain_skip pruning bit-for-bit (lchain.rs:79-88;
    ~2x the per-step cost, scan kernel only). The default (None) scores
    the predecessor window exactly — a superset that can only find equal
    or better chains; drift is bounded in tests/test_chain_skip_prune.py."""
    import os

    return cp.max_chain_skip if os.environ.get("MM2T_SKIP_PRUNE") else None


def _use_pallas_chain() -> bool:
    """One chain-DP implementation per platform: the Triton kernel
    (ops/chain_triton.py) on a GPU, the lax.scan (ops/chain_ops.py) on
    the CPU. Both give identical (f, prev) / (f, cnt, sq, sr)."""
    platform = jax.default_backend()
    if platform not in ("gpu", "cpu"):
        raise NotImplementedError(f"no chain DP for platform {platform!r}")
    return platform == "gpu"


def _chain_scores(x_hi, x_lo, y_hi, y_lo, scalars, window: int,
                  pallas_chain: bool, max_chain_skip: int | None):
    """(f, prev) of the chain DP over sorted anchors. The reference's
    max_chain_skip pruning (MM2T_SKIP_PRUNE) is order-dependent and runs
    in the scan on every platform."""
    args = (x_hi, x_lo.astype(I32), y_lo.astype(I32),
            (y_hi & jnp.uint32(0xFF)).astype(I32), scalars, window)
    if pallas_chain and max_chain_skip is None:
        from ..ops.chain_triton import chain_dp_batch_triton

        return chain_dp_batch_triton(*args)
    return chain_dp_batch(*args, max_chain_skip=max_chain_skip)


@functools.partial(
    jax.jit, static_argnames=("window", "pallas_chain", "max_chain_skip")
)
def _packed_chain_stage(x_hi, x_lo, y_hi, y_lo, scalars, *, window: int,
                        pallas_chain: bool = False,
                        max_chain_skip: int | None = None):
    """Chain DP alone (the rescue re-run, lchain.rs:321-330), packed into
    one transfer buffer [f | prev]."""
    f, prev = _chain_scores(x_hi, x_lo, y_hi, y_lo, scalars, window,
                            pallas_chain, max_chain_skip)
    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.uint32)
    return jnp.concatenate([bc(f), bc(prev)], axis=1)


def _unpack_map_stage(packed: np.ndarray, M: int, A: int, hpc: bool = False) -> dict:
    """Host-side view-unpacking of the fused stage's single buffer."""
    cols = [
        ("x_hi", A, np.uint32), ("x_lo", A, np.uint32),
        ("y_hi", A, np.uint32), ("y_lo", A, np.uint32),
        ("f", A, np.int32), ("prev", A, np.int32),
        ("cps", M, np.uint32),
    ]
    if hpc:
        cols.append(("mini_span", M, np.uint32))
    cols += [
        ("n_mini", 1, np.int32), ("n_anchors", 1, np.int32),
        ("mini_ovf", 1, np.uint32), ("anc_ovf", 1, np.uint32),
    ]
    out = {}
    off = 0
    for name, width, dtype in cols:
        v = packed[:, off : off + width].view(dtype)
        if width == 1:
            v = v[:, 0]
        out[name] = v
        off += width
    out["mini_ovf"] = out["mini_ovf"].astype(bool)
    out["anc_ovf"] = out["anc_ovf"].astype(bool)
    if not hpc:
        out["mini_span"] = None
    return out


@dataclasses.dataclass
class Mapper:
    idx: OracleIndex
    dev_idx: DeviceIndex
    cp: ChainParams
    mp: MapParams
    mid_occ: int
    # length buckets: reads are padded to the smallest bucket >= their
    # length; 1.5x steps in the long-read range cut padded anchor slots
    # (the chain DP cost is ~ slots x window) by ~25% vs pure powers of 2
    buckets: tuple[int, ...] = (
        1024, 2048, 4096, 8192, 12288, 16384, 24576, 32768, 49152, 65536
    )
    # max reads per device call. Calls dispatch asynchronously and drain
    # in order, so many small calls pipeline: while the drain blocks on
    # batch i, batches i+1.. compute, hiding the H2D submit and the host
    # postprocess behind device time. Long-read buckets are capped by
    # slot_target per call regardless.
    batch_size: int = 1024
    # minimizer density is 2/(w+1) ~ 0.18/base and anchors ~0.8x that on
    # non-repetitive genomes (the occ filters drop some); reads that
    # overflow the padded slots are flagged exactly and re-run on device
    # at 4x capacity (then fall back to the host path), so these control
    # speed, not correctness. Measured on 20 kb reads: 0.147 anchors/base
    # mean, so 0.18 keeps a 1.2x margin while cutting the dominant
    # chain-DP cost 28% vs the old 0.25.
    mini_frac: float = 0.22   # minimizer slots per base of bucket
    anchor_frac: float = 0.18  # anchor slots per base of bucket
    slot_target: int = 2 << 20  # anchor slots per device call
    # lite-path chain window cap (slots): anchors within max_dist_x
    # average ~740 slots at w=10 emission density, so 1024 covers typical
    # reads; denser reads are flagged exactly (win_ovf) and re-run wider
    lite_window_cap: int = 1024
    # 2-bit H2D wire (stages.unpack_codes2): halves the pass's largest
    # wire payload; MeshMapper disables it (the mesh programs take the
    # 4-bit wire). Falls back to 4-bit per batch when a batch carries
    # more than _NEX_CAP ambiguous bases.
    wire2: bool = True
    stats: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # the anchor expansion packs query pos<<1|strand into 23 bits
        # (ops/seeds_ops.py); longer buckets would silently wrap coords
        assert max(self.buckets) <= 1 << 22, "buckets must be <= 4M bases"

    def _t(self, key: str, dt: float):
        self.stats[key] = self.stats.get(key, 0.0) + dt

    @classmethod
    def from_oracle_index(cls, idx: OracleIndex, cp: ChainParams, mp: MapParams = MapParams(), **kw) -> "Mapper":
        dev = DeviceIndex.from_host(
            idx.keys, idx.starts, idx.counts, idx.positions, key_bits=2 * idx.k,
            seq_lens=[s.length for s in idx.seq],
        )
        mid_occ = max(idx.calc_mid_occ(mp.frac_top_repetitive), mp.mid_occ_floor)
        return cls(idx=idx, dev_idx=dev, cp=cp, mp=mp, mid_occ=mid_occ, **kw)

    # ------------------------------------------------------------------

    def _device_stage(self, codes, lengths, M, A, scalars: ChainScalars, window: int):
        """The fused device pipeline for one padded batch.

        Queries are ALWAYS sketched non-HPC — the reference hard-codes
        is_hpc=false for query minimizers even against an HPC index
        (seeds.rs:7-11), so anchor spans are uniformly k."""
        return _fused_map_stage(
            self.dev_idx, codes, lengths, scalars, jnp.int32(self.mid_occ),
            w=self.idx.w, k=self.idx.k, hpc=False,
            q_occ_max=self.mp.q_occ_max, q_occ_frac=self.mp.q_occ_frac,
            M=M, A=A, window=window,
            pallas_chain=_use_pallas_chain(), packed=True,
            max_chain_skip=_chain_skip_cfg(self.cp),
        )

    def _lite_eligible(self) -> bool:
        """The on-device finalization path is valid when the reference
        backtrack necessarily takes its greedy single-chain fallback
        (min_cnt >= 2; see ops/finalize_ops.py). MM2T_NO_LITE forces the
        general path."""
        import os

        if os.environ.get("MM2T_NO_LITE"):
            return False
        return self.cp.min_cnt >= 2

    def _ensure_meta(self):
        if not hasattr(self, "_tlens"):
            self._tlens = np.array([s.length for s in self.idx.seq], dtype=np.int32)
            self._tnames = [s.name or "*" for s in self.idx.seq]
            enc = [n.encode() for n in self._tnames]
            self._tname_blob = b"".join(enc)
            self._tname_off = np.zeros(len(enc) + 1, dtype=np.int64)
            np.cumsum([len(n) for n in enc], out=self._tname_off[1:])

    def _device_stage_lite(self, codes, lengths, M, A, scalars: ChainScalars, window: int,
                           wide: bool = True, nex=None, wire: str = "4bit"):
        self._ensure_meta()
        if not hasattr(self, "_tlens_dev"):
            self._tlens_dev = jnp.asarray(self._tlens)
            self._scalars_wide = chain_scalars_from_params(
                dataclasses.replace(self.cp, bw=self.cp.bw_long)
            )
        if nex is None:
            nex = jnp.zeros(1, I32)
        # hpc=False always: the reference sketches queries non-HPC even
        # against an HPC index (seeds.rs:7-11)
        return _fused_map_stage_lite(
            self.dev_idx, codes, lengths, nex, scalars, self._scalars_wide,
            jnp.int32(self.mid_occ),
            self._tlens_dev, jnp.int32(self.cp.rmq_rescue_size),
            jnp.float32(self.cp.rmq_rescue_ratio),
            w=self.idx.w, k=self.idx.k, hpc=False,
            q_occ_max=self.mp.q_occ_max, q_occ_frac=self.mp.q_occ_frac,
            M=M, A=A, window=window, pallas_chain=_use_pallas_chain(),
            flag_window_ovf=window < min(self.cp.max_chain_iter, A),
            wire=wire, max_chain_skip=_chain_skip_cfg(self.cp), wide=wide,
        )

    def _postprocess_lite(self, reads, chunk, fields, results, mode="normal"):
        """Route the device's (B, 18) field rows: clean rows become PAF
        line bytes (stored as zero-copy memoryview slices of the batch
        blob — bytes end-to-end until the output write), overflow rows
        requeue to the 4x tier or fall back to the host pipeline.

        Modes:
          "normal" — merged dual-band rows; overflow to the tier.
          "lazy"   — single-band rows (lane shapes): rescue-flagged
                     clean rows queue for the phase-2.2 wide re-run
                     instead of formatting.
          "wide"   — the phase-2.2 re-run: rows replace phase-1 results;
                     the rescue flag is ignored (rescue was decided by
                     the normal band, lchain.rs:321-326).
          "tier2"  — final: residual overflow to the host pipeline.

        Formatting runs in the native runtime (mm2t_format_lite) when
        built; the Python loop below is the bit-identical fallback."""
        from ..ops.finalize_ops import FIELDS

        self._ensure_meta()
        col = {name: i for i, name in enumerate(FIELDS)}
        requeue = mode != "tier2"
        lazy = mode == "lazy"
        if not os.environ.get("MM2T_NO_NATIVE"):
            from ..runtime.host import native_format_lite

            n = len(chunk)
            fr = np.ascontiguousarray(fields[:n])
            ovf_m = (
                (fr[:, col["mini_ovf"]] != 0)
                | (fr[:, col["anc_ovf"]] != 0)
                | (fr[:, col["win_ovf"]] != 0)
            )
            resc = np.zeros(n, dtype=bool)
            if lazy:
                resc = (fr[:, col["rescue"]] != 0) & ~ovf_m
                if not fr.flags.writeable:
                    fr = fr.copy()
                # suppress the normal-band line; the wide pass replaces it
                fr[resc, col["n_anchors"]] = 0
            elif mode != "wide":
                # dual-band rows: the rescue col carries the normal
                # band's flag post-merge (stages.py) — count the
                # device-resolved wide-band switches
                self.stats["wide_reads"] = self.stats.get(
                    "wide_reads", 0
                ) + int(((fr[:, col["rescue"]] != 0) & ~ovf_m).sum())
            dv_n = _dv_from_fields(fr, col)
            qlens = np.fromiter(
                (len(reads[ri][1]) for ri in chunk), dtype=np.int32, count=n
            )
            out = native_format_lite(
                fr, dv_n, qlens,
                [reads[ri][0].encode() for ri in chunk],
                self._tname_blob, self._tname_off, self._tlens,
                self.mp.mapq, col,
            )
            if out is not None:
                blob, off = out
                bmv = memoryview(blob)
                # plain bools: numpy scalar boxing dominates the loop
                ovf = ovf_m.tolist()
                rescl = resc.tolist()
                offl = off.tolist()
                for bi, ri in enumerate(chunk):
                    a, b = offl[bi], offl[bi + 1]
                    if rescl[bi]:
                        self._wide_queue.append(ri)
                    elif b > a:
                        results[ri] = [bmv[a:b]]
                    elif ovf[bi]:
                        if requeue:
                            self._tier2_queue.append(ri)
                        else:
                            results[ri] = self._host_fallback(reads[ri])
                    else:
                        results[ri] = []
                return
        dv_all = _dv_from_fields(fields, col)
        rows = fields.tolist()
        dv_list = dv_all.tolist()
        tnames, tlens, mapq = self._tnames, self._tlens.tolist(), self.mp.mapq
        for bi, ri in enumerate(chunk):
            qname, qseq = reads[ri]
            row = rows[bi]
            if row[col["mini_ovf"]] or row[col["anc_ovf"]] or row[col["win_ovf"]]:
                if requeue:
                    self._tier2_queue.append(ri)
                else:
                    results[ri] = self._host_fallback(reads[ri])
                continue
            if lazy and row[col["rescue"]]:
                self._wide_queue.append(ri)
                continue
            if row[col["rescue"]] and mode in ("normal", "tier2"):
                self.stats["wide_reads"] = self.stats.get("wide_reads", 0) + 1
            if row[col["n_anchors"]] == 0:
                results[ri] = []
                continue
            qlen = len(qseq)
            qs, qe = row[col["qs"]], row[col["qe"]]
            ts, te = row[col["ts"]], row[col["te"]]
            grp = row[col["grp"]]
            rev = (grp >> 31) & 1
            rid = grp & 0x7FFFFFFF
            strand = "-" if rev else "+"
            wqs, wqe = (qlen - qe, qlen - qs) if rev else (qs, qe)
            s1 = max(row[col["score"]], 0)
            results[ri] = [(
                f"{qname}\t{qlen}\t{wqs}\t{wqe}\t{strand}\t"
                f"{tnames[rid]}\t{tlens[rid]}\t{ts}\t{te}\t"
                f"{max(qe - qs, 0)}\t{max(te - ts, 0)}\t{mapq}\t"
                f"tp:A:P\tcm:i:{row[col['cm']]}\ts1:i:{s1}\ts2:i:0\t"
                f"dv:f:{dv_list[bi]:.4f}\trl:i:0"
            ).encode()]

    def _rescue_stage(self, x_hi, x_lo, y_hi, y_lo, window: int):
        p2 = dataclasses.replace(self.cp, bw=self.cp.bw_long)
        scal2 = chain_scalars_from_params(p2)
        return _packed_chain_stage(
            x_hi, x_lo, y_hi, y_lo, scal2, window=window,
            pallas_chain=_use_pallas_chain(),
            max_chain_skip=_chain_skip_cfg(self.cp),
        )

    # ------------------------------------------------------------------

    def map_reads_paf(self, reads: list[tuple[str, bytes]]) -> bytes:
        """Map reads; returns the PAF output as ONE newline-terminated
        bytes blob in input order — the production API: device field
        rows are formatted to bytes by the native runtime and stay bytes
        (zero-copy memoryview slices) until this single join. All k run
        on device: odd k through the vectorized window-min
        characterization, even k through the exact scan recurrence
        (ops/sketch_scan.py)."""
        # indexed by read position; None = not yet resolved (a list
        # preallocation beats 16k+ dict stores in the drain loop)
        results: list = [None] * len(reads)
        order = sorted(range(len(reads)), key=lambda i: len(reads[i][1]))
        scalars = chain_scalars_from_params(self.cp)

        # group by bucket
        groups: dict[int, list[int]] = {}
        for i in order:
            L = len(reads[i][1])
            if L == 0:
                results[i] = []
                continue
            bucket = next((b for b in self.buckets if L <= b), None)
            if bucket is None:
                # longer than the largest bucket: host path
                results[i] = self._host_fallback(reads[i])
                continue
            groups.setdefault(bucket, []).append(i)

        import time as _time

        lite = self._lite_eligible()

        # phase 1: submit every batch to the device (async dispatch) so
        # device compute and device->host transfers overlap with the host
        # postprocessing of earlier batches. Band policy per bucket
        # (_dual_band): short-read shapes compute BOTH chain bands and
        # resolve the rescue switch (lchain.rs:321-330) on device;
        # long-read shapes run the normal band only and re-run the rare
        # rescue-flagged reads lazily in phase 2.2, where a second band
        # would double the dominant DP cost for every read.
        #
        # Submission runs on a BACKGROUND thread feeding a queue the
        # drain consumes: host packing + H2D dispatch (the native pack
        # releases the GIL) overlap the drain's device waits instead of
        # serializing ahead of them. JAX dispatch is thread-safe;
        # batches still drain in submission order.
        self._rescue_queue: list = []
        self._tier2_queue: list = []
        self._wide_queue: list = []
        import queue as _queue
        import threading as _threading

        q: _queue.Queue = _queue.Queue()
        err: list = []

        def _producer():
            t0 = _time.time()
            try:
                self._submit_groups(reads, groups, scalars, lite, mult=1,
                                    sink=q.put)
            except BaseException as e:  # surfaced after join
                err.append(e)
            finally:
                q.put(None)
                self._t("submit", _time.time() - t0)

        th = _threading.Thread(target=_producer, daemon=True)
        th.start()

        # phase 2: pull + postprocess in submission order. Join the
        # producer even when the drain raises (a drain error must not
        # leave the submitter racing this mapper's state).
        try:
            self._drain_pending(reads, iter(q.get, None), results, lite)
        finally:
            th.join()
        if err:
            raise err[0]

        # phase 2.2: lazy wide band — rescue-flagged lane-shape reads
        # re-run the SAME executable with the bw_long scalars (scalars
        # are traced args, so no recompile)
        t4 = _time.time()
        self._drain_wides_lite(reads, results, lite)
        self._t("wide", _time.time() - t4)

        # phase 2.5: capacity-overflow reads re-run on device at 4x slots
        t4 = _time.time()
        self._drain_tier2(reads, results, scalars, lite)
        self._t("tier2", _time.time() - t4)

        # phase 3: one batched wide-band rescue pass for all queued reads
        # (general path only; the lite path resolved rescue on device)
        t4 = _time.time()
        self._drain_rescues(reads, results)
        self._t("rescue", _time.time() - t4)

        parts = [line for r in results if r for line in r]
        return b"\n".join(parts) + b"\n" if parts else b""

    def map_reads(self, reads: list[tuple[str, bytes]]) -> list[str]:
        """map_reads_paf decoded into a list of PAF line strings (test
        and parity-harness convenience)."""
        blob = self.map_reads_paf(reads)
        return blob.decode().split("\n")[:-1] if blob else []

    def _shapes_for(self, bucket: int, mult: int):
        """Padded capacities and reads-per-call for a length bucket.
        Capacities round up to multiples of 128, which bounds the number
        of compiled shapes; B only sets how much work one device call
        carries (the chain kernel takes any B)."""
        lane = lambda v: max(128, -(-int(v) // 128) * 128)
        M = min(lane(bucket * self.mini_frac * mult), lane(bucket))
        A = lane(bucket * self.anchor_frac * mult)
        window = min(self.cp.max_chain_iter, A)
        B = min(self.batch_size, max(8, self.slot_target // A))
        return M, A, window, B

    @staticmethod
    def _quantize_b(n: int, b_max: int) -> int:
        """Padded batch rows for an n-read chunk: the smallest 1.5x-step
        capacity (128x{1,2,3,4,6,8,...}) >= n, capped at b_max. Padded
        rows are NOT free — the minimizer/anchor sorts and the routed
        expansion scale with the padded B — so a 114-read long-read
        group must not ride a 1280-row program (that exact shape made
        the r4 long-read bench pay ~14x on its dominant stage). The
        1.5x quantization bounds padding waste (<= 1.5x) AND the number
        of distinct compiled shapes (~2 per octave)."""
        if n >= b_max:
            return b_max
        c = 128
        while c < n:
            c2 = c + (c >> 1) if c >= 256 else c * 2
            c = c2 // 128 * 128
        return min(c, b_max)

    @staticmethod
    def _dual_band(A: int) -> bool:
        """Band policy: dual-band (both bw bands in one call, rescue
        resolved on device) when the chain DP is cheap, below
        DUAL_BAND_MAX_A anchor slots. Long-read shapes run the normal
        band only and re-run rescue-flagged reads lazily (phase 2.2).
        Output does not depend on the policy, only the work per call."""
        return A < DUAL_BAND_MAX_A

    def _submit_groups(self, reads, groups, scalars, lite, mult=None,
                       band="auto", sink=None):
        """groups: {bucket: [ri...]} with uniform `mult`, or
        {(bucket, mult): [ri...]} when mult is None.
        band: "auto" applies _dual_band per bucket; "tier2" forces the
        dual-band program and routes residual overflow to the host
        pipeline (the 4x re-runs must neither requeue nor start another
        wide pass); "widepass" is phase 2.2's single-band re-run with
        the bw_long scalars.
        sink: when given, each submitted batch is pushed to sink(entry)
        as soon as it is dispatched (the threaded-submit pipeline) in
        addition to the returned list."""
        pending = []
        for gkey, idxs in groups.items():
            bucket, gmult = gkey if mult is None else (gkey, mult)
            M, A, window, B_max = self._shapes_for(bucket, gmult)
            if band == "tier2":
                wide_prog, mode = True, "tier2"
            elif band == "auto" and self._dual_band(A):
                wide_prog, mode = True, "normal"
            elif band == "widepass":
                wide_prog, mode = False, "wide"
            else:
                wide_prog, mode = False, "lazy"
            if lite and gmult == 1:
                # long-read fast path: the lite stage flags reads whose
                # truncated window loses an in-band predecessor exactly
                # (win_ovf, per band) and they re-run at the full window
                # in the 4x tier
                window = min(window, self.lite_window_cap)
            for c0 in range(0, len(idxs), B_max):
                chunk = idxs[c0 : c0 + B_max]
                # pad the batch dimension to the quantized chunk
                # capacity: full chunks reuse one compiled program per
                # bucket; partial chunks (group tails, the long-read
                # regime, requeues) take the smallest 1.5x-step shape
                # that fits instead of paying B_max padded rows of
                # sort/expand compute.
                # uint8 on the wire (2 or 4 bits per base)
                B = self._quantize_b(len(chunk), B_max)
                lengths = np.zeros(B, dtype=np.int32)
                lengths[: len(chunk)] = [len(reads[ri][1]) for ri in chunk]
                packed4 = None
                wire, nex = "4bit", None
                if not os.environ.get("MM2T_NO_NATIVE"):
                    from ..runtime.host import (
                        native_encode_pack2,
                        native_encode_pack4,
                    )

                    seqs = [reads[ri][1] for ri in chunk]
                    seqs += [b""] * (B - len(chunk))
                    if lite and self.wire2:
                        out2 = native_encode_pack2(seqs, bucket // 4, _NEX_CAP)
                        if out2 is not None:
                            packed4, nex = out2
                            wire = "2bit"
                    if packed4 is None:
                        packed4 = native_encode_pack4(seqs, bucket // 2)
                if packed4 is None:
                    codes = np.full((B, bucket), 4, dtype=np.uint8)
                    # one LUT pass over the whole chunk, then row memcpys
                    # — per-read nt4_encode calls pay numpy dispatch each
                    enc = nt4_encode(b"".join(reads[ri][1] for ri in chunk))
                    off = 0
                    for bi, ri in enumerate(chunk):
                        n = lengths[bi]
                        codes[bi, :n] = enc[off : off + n]
                        off += n
                    packed4 = _pack_codes4_host(codes)
                self.stats["h2d_bytes"] = (
                    self.stats.get("h2d_bytes", 0)
                    + packed4.nbytes + lengths.nbytes
                    + (nex.nbytes if nex is not None else 0)
                )
                d_packed4, d_lengths = self._to_device(packed4, lengths)
                d_nex = jnp.asarray(nex) if nex is not None else None
                if lite:
                    packed = self._device_stage_lite(
                        d_packed4, d_lengths, M, A, scalars, window,
                        wide=wide_prog, nex=d_nex, wire=wire,
                    )
                else:
                    packed = self._device_stage(
                        d_packed4, d_lengths, M, A, scalars, window,
                    )
                # start the device->host copy now so it overlaps the
                # compute of later batches (the drain's np.asarray then
                # finds the bytes already on host)
                try:
                    packed.copy_to_host_async()
                except AttributeError:
                    pass
                entry = (chunk, packed, M, A, window, mode)
                pending.append(entry)
                if sink is not None:
                    sink(entry)
        return pending

    def _drain_wides_lite(self, reads, results, lite):
        """Phase 2.2: lane-shape reads whose normal-band rescue flag
        fired re-run with the wide-band scalars (single band), replacing
        their rows (lchain.rs:321-330 semantics, batched)."""
        queue = self._wide_queue
        self._wide_queue = []
        self.stats["wide_reads"] = self.stats.get("wide_reads", 0) + len(queue)
        if not queue:
            return
        if not hasattr(self, "_scalars_wide"):
            self._scalars_wide = chain_scalars_from_params(
                dataclasses.replace(self.cp, bw=self.cp.bw_long)
            )
        groups: dict[int, list[int]] = {}
        for ri in queue:
            L = len(reads[ri][1])
            bucket = next(b for b in self.buckets if L <= b)
            groups.setdefault(bucket, []).append(ri)
        pending = self._submit_groups(
            reads, groups, self._scalars_wide, lite, mult=1,
            band="widepass",
        )
        self._drain_pending(reads, pending, results, lite)

    def _to_device(self, packed4, lengths):
        """Host batch -> device arrays. MeshMapper overrides this to
        device_put each shard directly onto its home device (the input
        pipeline's analog of feeding ICI-local data), so the executable
        never reshards a replicated array on call."""
        return jnp.asarray(packed4), jnp.asarray(lengths)

    def _drain_pending(self, reads, pending, results, lite):
        import time as _time

        from ..ops.finalize_ops import WIRE_WORDS, unpack_fields_wire

        for chunk, packed, M, A, window, mode in pending:
            t1 = _time.time()
            if lite:
                fields = np.asarray(packed)
                self.stats["d2h_bytes"] = (
                    self.stats.get("d2h_bytes", 0) + fields.nbytes
                )
                if fields.shape[1] == WIRE_WORDS:
                    fields = unpack_fields_wire(fields)
                t2 = _time.time()
                self._postprocess_lite(reads, chunk, fields, results, mode=mode)
            else:
                out = _unpack_map_stage(
                    np.asarray(packed), M, A, hpc=False
                )
                t2 = _time.time()
                self._postprocess(reads, chunk, out, results, window)
            t3 = _time.time()
            self._t("d2h+wait", t2 - t1)
            self._t("post", t3 - t2)

    def _drain_tier2(self, reads, results, scalars, lite):
        """Re-run reads whose minimizer/anchor population overflowed the
        default slots, with 4x capacities; residual overflow goes to the
        reference-faithful host pipeline."""
        queue = self._tier2_queue
        self._tier2_queue = []
        self.stats["tier2_reads"] = self.stats.get("tier2_reads", 0) + len(queue)
        if not queue:
            return
        if len(queue) < 48:
            # not worth a fresh device program (compiles cost ~15 s the
            # first time); the host pipeline handles a handful of reads
            # in milliseconds each
            for ri in queue:
                results[ri] = self._host_fallback(reads[ri])
            return
        groups: dict[int, list[int]] = {}
        for ri in queue:
            L = len(reads[ri][1])
            bucket = next(b for b in self.buckets if L <= b)
            groups.setdefault(bucket, []).append(ri)
        pending = self._submit_groups(reads, groups, scalars, lite, mult=4,
                                      band="tier2")
        self._drain_pending(reads, pending, results, lite)

    # ------------------------------------------------------------------

    def _postprocess(self, reads, chunk, out, results, window):
        """Host: backtrack, select, rescue, PAF. Dispatches to the native
        runtime's consolidated postprocess when available."""
        import os

        if not os.environ.get("MM2T_NO_NATIVE"):
            from ..runtime.host import native_available

            if native_available():
                return self._postprocess_native(reads, chunk, out, results, window)
        return self._postprocess_python(reads, chunk, out, results, window)

    def _postprocess_native(self, reads, chunk, out, results, window):
        """One C call per read: backtrack + merge + select + PAF fields +
        dv; Python only formats the lines."""
        from ..runtime.host import native_postprocess

        self._ensure_meta()
        tlens = self._tlens
        for bi, ri in enumerate(chunk):
            qname, qseq = reads[ri]
            if out["mini_ovf"][bi] or out["anc_ovf"][bi]:
                results[ri] = self._host_fallback(reads[ri])
                continue
            n = int(out["n_anchors"][bi])
            if n == 0:
                results[ri] = []
                continue
            anchors = np.stack(
                [
                    _combine64(out["x_hi"][bi, :n], out["x_lo"][bi, :n]),
                    _combine64(out["y_hi"][bi, :n], out["y_lo"][bi, :n]),
                ],
                axis=1,
            )
            nm = int(out["n_mini"][bi])
            mini_pos = (out["cps"][bi, :nm] >> 1).astype(np.int32)
            if out["mini_span"] is None:  # non-HPC: every span is k
                mini_span = np.full(nm, self.idx.k, dtype=np.int32)
            else:
                mini_span = out["mini_span"][bi, :nm].astype(np.int32)
            res = native_postprocess(
                anchors, out["f"][bi, :n], out["f"][bi, :n],
                out["prev"][bi, :n].astype(np.int64), self.cp, len(qseq),
                self.mp.mask_level, self.mp.pri_ratio, self.mp.best_n,
                mini_pos, mini_span, tlens,
            )
            recs, dv, s1, s2, rescue = res
            if rescue:
                # defer: all rescued reads across all batches re-run the
                # wide-band DP in one batched pass (lchain.rs:321-330)
                self._rescue_queue.append((ri, anchors, mini_pos, mini_span))
                continue
            results[ri] = self._format_lines(qname, len(qseq), recs, dv, s1, s2)

    def _format_lines(self, qname, qlen, recs, dv, s1, s2):
        tlens = self._tlens
        lines = []
        for m in range(recs.shape[0]):
            qs, qe, ts, te, cm, rid, rev, _pri, _sc = recs[m]
            strand = "-" if rev else "+"
            wqs, wqe = (qlen - qe, qlen - qs) if rev else (qs, qe)
            mlen = max(qe - qs, 0)
            blen = max(te - ts, 0)
            tp = "P" if m == 0 else "S"
            lines.append((
                f"{qname}\t{qlen}\t{wqs}\t{wqe}\t{strand}\t"
                f"{self._tnames[rid]}\t{tlens[rid]}\t{ts}\t{te}\t{mlen}\t"
                f"{blen}\t{self.mp.mapq}\ttp:A:{tp}\tcm:i:{cm}\t"
                f"s1:i:{s1}\ts2:i:{s2}\tdv:f:{dv[m]:.4f}\trl:i:0"
            ).encode())
        return lines

    def _drain_rescues(self, reads, results):
        """Batched wide-band re-chaining for all queued rescue reads."""
        from ..runtime.host import native_postprocess

        queue = self._rescue_queue
        self._rescue_queue = []
        if not queue:
            return
        p2 = dataclasses.replace(self.cp, bw=self.cp.bw_long)
        A = max(128, -(-max(a.shape[0] for _, a, _m, _s in queue) // 128) * 128)
        window = min(self.cp.max_chain_iter, A)
        B = self.batch_size
        tlens = self._tlens
        for c0 in range(0, len(queue), B):
            group = queue[c0 : c0 + B]
            x_hi = np.full((B, A), 0xFFFFFFFF, dtype=np.uint32)
            x_lo = np.full((B, A), 0xFFFFFFFF, dtype=np.uint32)
            y_hi = np.full((B, A), 0xFFFFFFFF, dtype=np.uint32)
            y_lo = np.full((B, A), 0xFFFFFFFF, dtype=np.uint32)
            for bi, (_ri, anchors, _mp, _ms) in enumerate(group):
                n = anchors.shape[0]
                x_hi[bi, :n] = (anchors[:, 0] >> np.uint64(32)).astype(np.uint32)
                x_lo[bi, :n] = (anchors[:, 0] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                y_hi[bi, :n] = (anchors[:, 1] >> np.uint64(32)).astype(np.uint32)
                y_lo[bi, :n] = (anchors[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            packed2 = np.asarray(
                self._rescue_stage(
                    jnp.asarray(x_hi), jnp.asarray(x_lo),
                    jnp.asarray(y_hi), jnp.asarray(y_lo), window,
                )
            )
            f2 = packed2[:, :A].view(np.int32)
            prev2 = packed2[:, A : 2 * A].view(np.int32)
            for bi, (ri, anchors, mini_pos, mini_span) in enumerate(group):
                n = anchors.shape[0]
                qname, qseq = reads[ri]
                res = native_postprocess(
                    anchors, f2[bi, :n], f2[bi, :n], prev2[bi, :n].astype(np.int64),
                    p2, len(qseq),
                    self.mp.mask_level, self.mp.pri_ratio, self.mp.best_n,
                    mini_pos, mini_span, tlens,
                )
                recs, dv, s1, s2, _ = res
                results[ri] = self._format_lines(qname, len(qseq), recs, dv, s1, s2)

    def _postprocess_python(self, reads, chunk, out, results, window):
        """Pure-Python fallback postprocess."""
        rescue_rows = []
        per_row: dict[int, tuple] = {}
        for bi, ri in enumerate(chunk):
            qname, qseq = reads[ri]
            if out["mini_ovf"][bi] or out["anc_ovf"][bi]:
                results[ri] = self._host_fallback(reads[ri])
                continue
            n = int(out["n_anchors"][bi])
            anchors = np.stack(
                [
                    _combine64(out["x_hi"][bi, :n], out["x_lo"][bi, :n]),
                    _combine64(out["y_hi"][bi, :n], out["y_lo"][bi, :n]),
                ],
                axis=1,
            )
            f = out["f"][bi, :n].astype(np.int64)
            prev = out["prev"][bi, :n].astype(np.int64)
            chains, scores = self._backtrack(anchors, f, None, prev, self.cp)
            mv = self._mv_list(out, bi)
            if not chains:
                results[ri] = []
                continue
            per_row[bi] = (anchors, chains, scores, mv)
            # rescue decision (lchain.rs:321-326)
            best_cov = olchain.chain_query_coverage(anchors, chains[0])
            uncovered = max(len(qseq) - best_cov, 0)
            if uncovered > self.cp.rmq_rescue_size or np.float32(best_cov) < np.float32(
                len(qseq)
            ) * (np.float32(1.0) - np.float32(self.cp.rmq_rescue_ratio)):
                rescue_rows.append(bi)

        if rescue_rows:
            packed2 = np.asarray(
                self._rescue_stage(
                    jnp.asarray(np.ascontiguousarray(out["x_hi"])),
                    jnp.asarray(np.ascontiguousarray(out["x_lo"])),
                    jnp.asarray(np.ascontiguousarray(out["y_hi"])),
                    jnp.asarray(np.ascontiguousarray(out["y_lo"])), window,
                )
            )
            A = out["x_hi"].shape[1]
            f2 = packed2[:, :A].view(np.int32)
            prev2 = packed2[:, A : 2 * A].view(np.int32)
            p2 = dataclasses.replace(self.cp, bw=self.cp.bw_long)
            for bi in rescue_rows:
                anchors, _, _, mv = per_row[bi]
                n = anchors.shape[0]
                chains, scores = self._backtrack(
                    anchors, f2[bi, :n].astype(np.int64), None,
                    prev2[bi, :n].astype(np.int64), p2,
                )
                per_row[bi] = (anchors, chains, scores, mv)

        for bi, ri in enumerate(chunk):
            if bi not in per_row:
                continue
            qname, qseq = reads[ri]
            anchors, chains, scores, mv = per_row[bi]
            chains_merged = olchain.merge_adjacent_chains_with_gap(
                anchors, chains, self.cp.max_dist_y, self.cp.max_dist_y
            )
            sel, _sc, _pri, s1, s2 = olchain.select_and_filter_chains(
                anchors, chains_merged, scores[: len(chains_merged)],
                self.mp.mask_level, self.mp.pri_ratio, self.mp.best_n,
            )
            results[ri] = [
                l.encode()
                for l in write_paf_many_with_scores(
                    self.idx, anchors, sel, s1, s2, qname, qseq, mv=mv
                )
            ]

    def _mv_list(self, out, bi) -> list[tuple[int, int]]:
        """Device minimizers (position-sorted) as (key_span, rps) pairs for
        the dv estimate — which only reads the span (low 8 bits) and the
        position (paf.rs:158-159), so the key field carries just the
        span."""
        n = int(out["n_mini"][bi])
        spans = out["mini_span"][bi, :n]
        ps = out["cps"][bi, :n]
        return [(int(kk), int(p)) for kk, p in zip(spans, ps)]

    @staticmethod
    def _backtrack(anchors, f, v, prev, cp):
        import os

        if not os.environ.get("MM2T_NO_NATIVE"):
            from ..runtime.host import native_backtrack

            out = native_backtrack(anchors, f, v, prev, cp)
            if out is not None:
                return out
        return olchain.backtrack(anchors, f, v, prev, cp)

    def _host_fallback(self, read) -> list[bytes]:
        qname, qseq = read
        return [
            l.encode()
            for l in opipeline.align_read(
                self.idx, qname, qseq, self.cp, self.mp, mid_occ=self.mid_occ
            )
        ]
