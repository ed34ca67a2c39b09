"""Command-line interface mirroring the reference's subcommands and flags
(/root/reference/src/main.rs:18-90): index / anchors / chain / align.

Extensions over the reference:
- `align` maps ALL query records (the reference maps only the first,
  main.rs:92-103,193); `--first-only` restores reference behavior.
- `--engine {auto,device,host}` selects the device pipeline or the
  reference-faithful host oracle (default auto: device when JAX's first
  device is an accelerator, else host).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .config import ChainParams, IndexParams, MapParams, apply_preset
from .io.fasta import read_fasta, read_fasta_first
from .oracle.index import OracleIndex, build_index
from .oracle.lchain import chain_dp
from .oracle.pipeline import map_reads
from .oracle.seeds import build_anchors, collect_query_minimizers, filter_query_minimizers


def load_index_auto(path: str, w: int, k: int, b: int, flag: int) -> OracleIndex:
    """Dispatch .mmi / native / FASTA (main.rs:135-145)."""
    if path.endswith(".mmi"):
        return OracleIndex.load_from_mmi(path)
    try:
        return OracleIndex.load_from_file(path)
    except Exception:
        records = read_fasta(path)
        return build_index([(n, s) for n, s in records], IndexParams(w=w, k=k, bucket_bits=b, flag=flag))


def _add_wk(p, k_default=15, w_default=10):
    p.add_argument("-w", type=int, default=w_default)
    p.add_argument("-k", type=int, default=k_default)
    p.add_argument("-H", "--hpc", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mm2t", description="minimap2-class long-read mapper in JAX")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("index", help="build a reference index")
    p.add_argument("fasta")
    _add_wk(p)
    p.add_argument("-b", "--bucket-bits", type=int, default=14)
    p.add_argument("-d", "--dump", default=None)
    p.add_argument("--engine", choices=["auto", "native", "device", "host"],
                   default="auto")

    p = sub.add_parser("anchors", help="debug: print anchor stats")
    p.add_argument("ref_fasta")
    p.add_argument("qry_fasta")
    _add_wk(p)
    p.add_argument("--engine", choices=["auto", "device", "host"], default="auto")

    p = sub.add_parser("chain", help="debug: best chain endpoints")
    p.add_argument("ref_fasta")
    p.add_argument("qry_fasta")
    _add_wk(p)
    p.add_argument("-r", dest="bw", type=int, default=5000)
    p.add_argument("--engine", choices=["auto", "device", "host"], default="auto")

    p = sub.add_parser("align", help="map reads, PAF output")
    p.add_argument("ref_fasta")
    p.add_argument("qry_fasta")
    _add_wk(p)
    p.add_argument("-f", dest="frac_top_repetitive", type=float, default=2e-4)
    p.add_argument("-g", dest="max_gap", type=int, default=5000)
    p.add_argument("-r", dest="r", default=None, help="NUM[,NUM] bandwidth (bw[,bw_long])")
    p.add_argument("-n", dest="min_cnt", type=int, default=3)
    p.add_argument("-m", dest="min_chain_score", type=int, default=40)
    p.add_argument("-M", "--mask-level", type=float, default=0.5)
    p.add_argument("-p", "--pri-ratio", type=float, default=0.8)
    p.add_argument("-N", "--best-n", type=int, default=5)
    p.add_argument("-x", dest="preset", default=None)
    p.add_argument("-a", dest="out_sam", action="store_true", help="(ignored; PAF only)")
    p.add_argument("-o", dest="output", default=None)
    p.add_argument("--first-only", action="store_true", help="map only the first query record (reference behavior)")
    p.add_argument("--engine", choices=["auto", "device", "host"], default="auto")
    p.add_argument("--stats", action="store_true", help="print a per-stage timing breakdown to stderr")
    p.add_argument("--trace-dir", default=None, help="write a jax.profiler trace here")
    p.add_argument("--batch-size", type=int, default=1024, help="max reads per device program invocation (small batches pipeline: async dispatch overlaps sync/submit/post with device compute)")
    p.add_argument("--mesh", type=int, default=0, metavar="DP",
                   help="map over a DP-way device mesh (0 = single device; "
                        "requires --engine device and DP*SHARDS devices)")
    p.add_argument("--index-shards", type=int, default=1, metavar="IX",
                   help="hash-range-shard the index over IX mesh devices")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from .utils import compile_cache

    compile_cache.configure()

    if args.command == "index":
        flag = 1 if args.hpc else 0
        records = read_fasta(args.fasta)
        params = IndexParams(w=args.w, k=args.k, bucket_bits=args.bucket_bits, flag=flag)
        engine = args.engine
        if engine == "auto":
            # the threaded C++ build wherever the native library exists
            from .runtime.host import native_available

            engine = "native" if native_available() else _auto_engine()
        if engine == "native":
            from .models.index_builder import build_index_native

            idx = build_index_native(records, params)
        elif engine == "device":
            from .models.index_builder import build_index_device

            idx = build_index_device(records, params)
        else:
            idx = build_index(records, params)
        n_keys, avg_occ, avg_spacing, total_len = idx.stats()
        print(f"kmer size: {args.k}; skip: {args.w}; is_hpc: {1 if args.hpc else 0}; #seq: {idx.n_seq}")
        print(
            f"distinct minimizers: {n_keys} (avg occ {avg_occ:.2f}) "
            f"avg spacing {avg_spacing:.3f} total length {total_len}"
        )
        if args.dump:
            if args.dump.endswith(".mmi"):
                idx.save_to_mmi(args.dump)
            else:
                idx.save_to_file(args.dump)
        return 0

    if args.command == "anchors":
        flag = 1 if args.hpc else 0
        idx = load_index_auto(args.ref_fasta, args.w, args.k, 14, flag)
        _qname, q = read_fasta_first(args.qry_fasta)
        mid_occ = max(idx.calc_mid_occ(2e-4), 10)
        anchors = _anchors_for(idx, q, mid_occ, args.engine)
        print(f"anchors: {anchors.shape[0]}")
        for x, y in anchors[:10]:
            print(f"x=0x{int(x):016x} y=0x{int(y):016x}")
        return 0

    if args.command == "chain":
        flag = 1 if args.hpc else 0
        idx = load_index_auto(args.ref_fasta, args.w, args.k, 14, flag)
        _qname, q = read_fasta_first(args.qry_fasta)
        mid_occ = max(idx.calc_mid_occ(2e-4), 10)
        cp = ChainParams.defaults_for_k(idx.k, bw=args.bw)
        engine = args.engine if args.engine != "auto" else _auto_engine()
        anchors = _anchors_for(idx, q, mid_occ, args.engine)
        if engine == "device":
            chain = _device_chain(anchors, cp)
        else:
            chain = chain_dp(anchors, cp)
        print(f"best_chain_len: {len(chain)}")
        if chain:
            st, en = chain[0], chain[-1]
            print(f"start: x=0x{int(anchors[st,0]):016x} y=0x{int(anchors[st,1]):016x}")
            print(f"end:   x=0x{int(anchors[en,0]):016x} y=0x{int(anchors[en,1]):016x}")
        return 0

    if args.command == "align":
        w, k = args.w, args.k
        if args.preset:
            w, k = apply_preset(args.preset, w, k)
        flag = 1 if args.hpc else 0
        idx = load_index_auto(args.ref_fasta, w, k, 14, flag)
        if args.first_only:
            reads = [read_fasta_first(args.qry_fasta)]
        else:
            reads = read_fasta(args.qry_fasta)
        cp = ChainParams.defaults_for_k(
            idx.k,
            max_dist_x=args.max_gap,
            max_dist_y=args.max_gap,
            min_cnt=args.min_cnt,
            min_chain_score=args.min_chain_score,
        )
        if args.r:
            parts = args.r.split(",")
            overrides = {}
            try:
                overrides["bw"] = int(parts[0])
            except (ValueError, IndexError):
                pass
            if len(parts) > 1:
                try:
                    overrides["bw_long"] = int(parts[1])
                except ValueError:
                    pass
            if overrides:
                import dataclasses

                cp = dataclasses.replace(cp, **overrides)
        mp = MapParams(
            frac_top_repetitive=args.frac_top_repetitive,
            mask_level=args.mask_level,
            pri_ratio=args.pri_ratio,
            best_n=args.best_n,
        )
        engine = args.engine
        if engine == "auto":
            engine = _auto_engine()
        import time

        from .utils.profiling import device_trace, print_stage_stats

        t0 = time.time()
        with device_trace(args.trace_dir):
            if engine == "device" and (args.mesh or args.index_shards > 1):
                from .models.mesh_mapper import make_mesh_mapper

                mapper = make_mesh_mapper(
                    idx, cp, mp, dp=args.mesh or None, ix=args.index_shards,
                    index_sharded=args.index_shards > 1,
                    batch_size=args.batch_size,
                )
                blob = mapper.map_reads_paf(reads)
                stats = dict(mapper.stats)
            elif engine == "device":
                from .models.mapper import Mapper

                mapper = Mapper.from_oracle_index(idx, cp, mp, batch_size=args.batch_size)
                blob = mapper.map_reads_paf(reads)
                stats = dict(mapper.stats)
            else:
                lines = map_reads(idx, reads, cp, mp)
                blob = ("\n".join(lines) + "\n").encode() if lines else b""
                stats = {}
        if args.stats:
            total_bp = sum(len(s) for _, s in reads)
            print_stage_stats(stats, len(reads), total_bp, time.time() - t0)
        # bytes end-to-end: the device engines keep PAF output as one
        # blob (the batched analog of main.rs:189-230's output stage)
        if args.output and args.output != "-":
            with open(args.output, "wb") as f:
                f.write(blob)
        else:
            import sys as _sys

            _sys.stdout.buffer.write(blob)
            _sys.stdout.buffer.flush()
        return 0

    return 1


def _anchors_for(idx: OracleIndex, q: bytes, mid_occ: int, engine: str) -> np.ndarray:
    """Anchors for one query: device pipeline (sketch -> lookup -> routed
    expansion -> sort) or the host oracle. Device output is asserted
    against no silent truncation; overflow falls back to host. Every
    legal k runs on device (even k via the exact scan recurrence,
    ops/sketch_scan.py)."""
    if engine == "auto":
        engine = _auto_engine()
    if engine == "device":
        out = _device_anchors(idx, q, mid_occ)
        if out is not None:
            return out
    mv = collect_query_minimizers(q, idx.w, idx.k)
    mv = filter_query_minimizers(mv, 10, 0.01)
    return build_anchors(idx, mv, len(q), mid_occ)


def _device_anchors(idx: OracleIndex, q: bytes, mid_occ: int) -> np.ndarray | None:
    """(n, 2) uint64 anchors computed on device, or None on capacity
    overflow (debug capacities are generous: M = L, A = 4L)."""
    import functools

    import jax
    import jax.numpy as jnp

    from .models.stages import sketch_to_anchors
    from .ops.index_ops import DeviceIndex
    from .utils.packing import nt4_encode

    lane = lambda v: max(128, -(-int(v) // 128) * 128)
    L = lane(len(q))
    codes = np.full((1, L), 4, dtype=np.int32)
    codes[0, : len(q)] = nt4_encode(q)
    dev_idx = DeviceIndex.from_host(
        idx.keys, idx.starts, idx.counts, idx.positions, key_bits=2 * idx.k
    )
    # one jitted program instead of op-by-op dispatch
    fn = jax.jit(functools.partial(
        sketch_to_anchors,
        w=idx.w, k=idx.k, hpc=False, q_occ_max=10, q_occ_frac=0.01,
        M=L, A=lane(4 * L),
    ))
    anc = fn(
        dev_idx, jnp.asarray(codes),
        jnp.asarray(np.array([len(q)], dtype=np.int32)), jnp.int32(mid_occ),
    )
    if bool(np.asarray(anc["anc_ovf"])[0]) or bool(np.asarray(anc["mini_ovf"])[0]):
        return None
    n = int(np.asarray(anc["n_anchors"])[0])
    x = (np.asarray(anc["x_hi"])[0, :n].astype(np.uint64) << np.uint64(32)) | np.asarray(anc["x_lo"])[0, :n].astype(np.uint64)
    y = (np.asarray(anc["y_hi"])[0, :n].astype(np.uint64) << np.uint64(32)) | np.asarray(anc["y_lo"])[0, :n].astype(np.uint64)
    return np.stack([x, y], axis=1)


def _device_chain(anchors: np.ndarray, cp: ChainParams) -> list[int]:
    """Reference chain_dp (lchain.rs:54-57) with the DP on device: the
    pruned kernel (bit-parity with the scan, tests/test_chain_skip_prune)
    plus the host backtrack; returns the best chain's anchor indices."""
    import jax.numpy as jnp

    from .oracle.lchain import backtrack
    from .ops.chain_ops import chain_dp_batch, chain_scalars_from_params

    n = anchors.shape[0]
    if n == 0:
        return []
    A = max(128, -(-n // 128) * 128)
    grp = np.full((1, A), 0xFFFFFFFF, dtype=np.uint32)
    rpos = np.zeros((1, A), np.int32)
    qpos = np.zeros((1, A), np.int32)
    span = np.zeros((1, A), np.int32)
    grp[0, :n] = (anchors[:, 0] >> np.uint64(32)).astype(np.uint32)
    rpos[0, :n] = (anchors[:, 0] & np.uint64(0xFFFFFFFF)).astype(np.int32)
    qpos[0, :n] = (anchors[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.int32)
    span[0, :n] = ((anchors[:, 1] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    f, prev = chain_dp_batch(
        jnp.asarray(grp), jnp.asarray(rpos), jnp.asarray(qpos),
        jnp.asarray(span), chain_scalars_from_params(cp),
        min(cp.max_chain_iter, A), max_chain_skip=cp.max_chain_skip,
    )
    chains, _scores = backtrack(
        anchors, np.asarray(f)[0, :n], None, np.asarray(prev)[0, :n], cp
    )
    return chains[0] if chains else []


def _auto_engine() -> str:
    """"device" when JAX's first device is an accelerator, else "host".
    A device that fails to initialise raises here: it must not turn into
    a silent host run."""
    import jax

    return "device" if jax.devices()[0].platform != "cpu" else "host"


if __name__ == "__main__":
    sys.exit(main())
