"""Mapping throughput on one GPU, and the chain kernel against the scan.

Sections (one JSON line at the end):
  1. headline - 16,384 simulated 500 bp-1 kb reads (2% error) against a
     5 Mbp genome, through Mapper.map_reads_paf (bytes in, PAF bytes
     out). Metric: aligned read bases per second.
  2. longread - 512 reads of 5-20 kb against the same genome.
  3. chain    - both sets mapped with the Triton chain kernel and with the
     lax.scan chain DP, passes in turns (kernel, scan, scan, kernel, ...);
     the two outputs must be identical bytes. Per-call times of the two
     chain implementations on the anchors of each set come from
     chip_smoke.py's phase f.
  4. index_build - native (host C++) and device index build, bp/s.

Every headline read set is byte-compared with the host oracle on a
sample (every --parity-stride-th read). The JSON names the platform, the
device kind and count, and the card's power limit; the script fails when
JAX's first device is not a GPU.

Usage: python bench.py [--reads N] [--genome-mb MB] [--passes P]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time


@contextlib.contextmanager
def chain_impl(kernel: bool):
    """Map with the Triton kernel (the GPU default) or the lax.scan."""
    from minimap2_rs_tpu.models import mapper as mapper_mod

    saved = mapper_mod._use_pallas_chain
    mapper_mod._use_pallas_chain = lambda: kernel
    try:
        yield
    finally:
        mapper_mod._use_pallas_chain = saved


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=16384)
    ap.add_argument("--longread-n", type=int, default=512)
    ap.add_argument("--genome-mb", type=float, default=5.0)
    ap.add_argument("--parity-stride", type=int, default=16)
    ap.add_argument("--passes", type=int, default=3,
                    help="timed passes per chain implementation")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX's first device is {dev.platform}",
              file=sys.stderr)
        return 2

    from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams
    from minimap2_rs_tpu.models.index_builder import (
        build_index_device,
        build_index_native,
    )
    from minimap2_rs_tpu.models.mapper import Mapper
    from minimap2_rs_tpu.oracle.pipeline import map_reads as oracle_map
    from minimap2_rs_tpu.utils import compile_cache
    from minimap2_rs_tpu.utils.seqsim import random_genome, simulate_reads

    compile_cache.configure()
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(power, file=sys.stderr, flush=True)

    glen = int(args.genome_mb * 1e6)
    genome = random_genome(glen, seed=0)
    idx = build_index_native([("chrB", genome)], IndexParams())
    cp, mp = ChainParams.defaults_for_k(15), MapParams()
    mapper = Mapper.from_oracle_index(idx, cp, mp)
    sets = {
        "headline": [(n, s) for n, s, *_ in simulate_reads(
            genome, args.reads, read_len=(500, 1000), seed=1)],
        "longread": [(n, s) for n, s, *_ in simulate_reads(
            genome, args.longread_n, read_len=(5000, 20000), seed=3)],
    }
    out: dict = {}
    for name, reads in sets.items():
        blobs, times, stats = {}, {True: [], False: []}, {}
        for kernel in (True, False):  # warm-up: compiles every shape
            with chain_impl(kernel):
                blobs[kernel] = mapper.map_reads_paf(reads)
        assert blobs[True] == blobs[False], f"{name}: kernel and scan outputs differ"
        lines = blobs[True].decode().split("\n")[:-1]
        sample = reads[:: args.parity_stride]
        want = {n for n, _ in sample}
        dev_lines = [l for l in lines if l.split("\t", 1)[0] in want]
        assert dev_lines == oracle_map(idx, sample, cp, mp), f"{name}: oracle parity"
        order = [True, False, False, True] * ((args.passes + 1) // 2)
        for kernel in order[: 2 * args.passes]:
            with chain_impl(kernel):
                mapper.stats = {}
                t0 = time.perf_counter()
                mapper.map_reads_paf(reads)
                times[kernel].append(time.perf_counter() - t0)
                stats[kernel] = {k: round(v, 4) for k, v in mapper.stats.items()}
        mapped = {l.split("\t", 1)[0] for l in lines}
        bp = sum(len(s) for n, s in reads if n in mapped)
        out[name] = {
            "reads": len(reads),
            "aligned_bp": bp,
            "kernel_pass_s": [round(t, 4) for t in times[True]],
            "scan_pass_s": [round(t, 4) for t in times[False]],
            "kernel_bp_per_s": round(bp / statistics.median(times[True]), 1),
            "scan_bp_per_s": round(bp / statistics.median(times[False]), 1),
            "parity_reads": len(sample),
            # host-clock seconds per phase of the last pass (Mapper.stats)
            "kernel_pass_stats": stats[True],
            "scan_pass_stats": stats[False],
        }
        print(name, out[name], file=sys.stderr, flush=True)

    recs = [("chrB", genome)]
    for engine, build in (("native", build_index_native),
                          ("device", build_index_device)):
        build(recs, IndexParams())  # warm-up (compile / allocators)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            build(recs, IndexParams())
            ts.append(time.perf_counter() - t0)
        out[f"index_build_{engine}_bp_per_s"] = round(glen / statistics.median(ts), 1)

    print(json.dumps({
        "metric": "aligned_read_bp_per_s",
        "value": out["headline"]["kernel_bp_per_s"],
        "unit": "bp/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "gpu_name_power_limit": power,
        **out,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
