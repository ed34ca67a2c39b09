"""Smoke test of the mapping path on NVIDIA GPUs.

Drives the entry points users call (Mapper.map_reads_paf, MeshMapper, the
CLI's `index`/`align --engine device`) on data generated from seeds, and
compares every output with the reference-faithful host oracle
(minimap2_rs_tpu/oracle/), byte for byte. Every output is an integer or
text, so parity is exact equality; there is no tolerance.

Phases (one GPU, no arguments):
  a  reference  100 Mbp genome, native index build at the default preset
                (k=15, w=10), DeviceIndex bytes
  b  headline   16,384 reads of 500-1000 bp at 2% error, every 16th read
                byte-compared
  c  longread   512 reads of 5-20 kb and 8 chimeras (the lazy bw_long
                pass), 72 byte-compared; then 64 reads with the anchor
                slots cut so the 4x overflow tier runs on device
  d  paths      map-hifi k=19, an HPC index, even k=14, the general path
                (min_cnt=1) and MM2T_SKIP_PRUNE=1, 128 reads each against a
                2 Mbp genome, each compared in full
  e  cli        `index --engine device` and `align --engine device` on a
                5 Mbp FASTA; the device index build against the native one
  f  chain      the chain kernel against the lax.scan at the headline and
                long-read shapes, on anchors of the phase b and c reads

`--four` runs only MeshMapper on four GPUs (dp=4 with a replicated index,
and dp=2 x ix=2 with a hash-range-sharded index) on the phase b data,
compared with a one-GPU Mapper run and with the oracle sample.

Run: python chip_smoke.py [--four]. Exits non-zero when JAX's first device
is not a GPU or when any phase fails; the last line of a passing run is a
JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def report(phase: str, ok: bool, **counts) -> None:
    """One line per phase; a parity failure stops the run."""
    parts = " ".join(f"{k}={v}" for k, v in counts.items())
    log(f"phase {phase}: parity={'ok' if ok else 'FAILED'} {parts}")
    if not ok:
        raise AssertionError(f"phase {phase}: device output differs from the oracle")


def oracle_parity(idx, reads, lines, cp, mp) -> tuple[bool, int]:
    """Device PAF lines restricted to `reads`, against the oracle's."""
    from minimap2_rs_tpu.oracle.pipeline import map_reads as oracle_map

    want = {n for n, _ in reads}
    dev = [l for l in lines if l.split("\t", 1)[0] in want]
    host = oracle_map(idx, reads, cp, mp)
    if dev != host:
        diff = next(
            (f"{d!r} != {h!r}" for d, h in zip(dev, host) if d != h),
            f"line counts {len(dev)} vs {len(host)}",
        )
        log(f"first difference: {diff}")
    return dev == host, len(host)


def _lines(blob: bytes) -> list[str]:
    return blob.decode().split("\n")[:-1] if blob else []


def _sim(genome: bytes, n: int, read_len, seed: int, **kw):
    from minimap2_rs_tpu.utils.seqsim import simulate_reads

    return [(nm, s) for nm, s, *_ in simulate_reads(genome, n, read_len=read_len, seed=seed, **kw)]


@dataclasses.dataclass
class Reference:
    genome: bytes
    idx: object
    mapper: object
    cp: object
    mp: object


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------


def phase_reference(genome_bp: int, seed: int = 0) -> Reference:
    """a: a genome from a seed, indexed by the native build, on device."""
    import jax

    from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams
    from minimap2_rs_tpu.models.index_builder import build_index_native
    from minimap2_rs_tpu.models.mapper import Mapper
    from minimap2_rs_tpu.utils.seqsim import random_genome

    t0 = time.time()
    genome = random_genome(genome_bp, seed=seed)
    t1 = time.time()
    idx = build_index_native([("chrA", genome)], IndexParams())
    t2 = time.time()
    cp, mp = ChainParams.defaults_for_k(15), MapParams()
    mapper = Mapper.from_oracle_index(idx, cp, mp)
    jax.block_until_ready(mapper.dev_idx)
    dev_bytes = sum(int(x.nbytes) for x in jax.tree_util.tree_leaves(mapper.dev_idx))
    report(
        "a_reference", True, genome_bp=len(genome), keys=int(idx.keys.shape[0]),
        positions=int(idx.positions.shape[0]), device_index_bytes=dev_bytes,
        genome_s=round(t1 - t0, 2), native_build_s=round(t2 - t1, 2),
    )
    return Reference(genome, idx, mapper, cp, mp)


def phase_headline(ref: Reference, n_reads: int, stride: int, seed: int = 1):
    """b: short reads through map_reads_paf; every `stride`-th compared."""
    reads = _sim(ref.genome, n_reads, (500, 1000), seed)
    t0 = time.time()
    blob = ref.mapper.map_reads_paf(reads)
    dt = time.time() - t0
    lines = _lines(blob)
    ok, n_cmp = oracle_parity(ref.idx, reads[::stride], lines, ref.cp, ref.mp)
    report("b_headline", ok, reads=len(reads), lines=len(lines),
           compared_reads=len(reads[::stride]), compared_lines=n_cmp,
           first_pass_s=round(dt, 2))
    return reads, lines


def phase_longread(ref: Reference, n_reads: int, n_check: int,
                   n_tier: int, seed: int = 3):
    """c: long reads (lazy wide pass, single-band shapes), then reads
    whose anchors overflow cut-down slots so the 4x tier runs on device."""
    from minimap2_rs_tpu.models.mapper import Mapper

    import numpy as np

    reads = _sim(ref.genome, n_reads, (5000, 20000), seed)
    # chimeras (two segments a tenth of the genome apart): the normal
    # band's best chain covers half the read, so the rescue flag sends
    # them through the lazy bw_long pass (lchain.rs:321-330)
    g, rng = ref.genome, np.random.default_rng(seed)
    for ci in range(n_check // 8):
        a = int(rng.integers(0, len(g) * 8 // 10))
        b = a + len(g) // 10
        reads.append((f"chim{ci}", g[a:a + 3000] + g[b:b + 3000]))
    m = ref.mapper
    m.stats = {}
    lines = _lines(m.map_reads_paf(reads))
    step = max(1, n_reads // n_check)
    check = reads[:n_reads:step] + reads[n_reads:]
    ok, n_cmp = oracle_parity(ref.idx, check, lines, ref.cp, ref.mp)
    wide = m.stats.get("wide_reads", 0)
    report("c_longread", ok and wide > 0, reads=len(reads), lines=len(lines),
           compared_reads=len(check), compared_lines=n_cmp, wide_reads=wide,
           tier2_reads=m.stats.get("tier2_reads", 0))
    tier_reads = _sim(ref.genome, n_tier, (5000, 8000), seed + 1)
    mt = Mapper.from_oracle_index(ref.idx, ref.cp, ref.mp, anchor_frac=0.02)
    t_lines = _lines(mt.map_reads_paf(tier_reads))
    ok, n_cmp = oracle_parity(ref.idx, tier_reads, t_lines, ref.cp, ref.mp)
    tier2 = mt.stats.get("tier2_reads", 0)
    # the device tier runs when at least 48 reads overflow (mapper.py)
    report("c_tier2", ok and tier2 >= min(48, n_tier), reads=len(tier_reads),
           compared_lines=n_cmp, tier2_reads=tier2)
    return reads


def phase_paths(genome_bp: int, n_reads: int, seed: int = 11) -> None:
    """d: the other device paths users reach, each compared in full."""
    from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams
    from minimap2_rs_tpu.models.index_builder import build_index_native
    from minimap2_rs_tpu.models.mapper import Mapper
    from minimap2_rs_tpu.utils.seqsim import random_genome

    g = random_genome(genome_bp, seed=seed)
    mp = MapParams()
    cases = [
        ("hifi_k19", IndexParams(w=10, k=19), ChainParams.defaults_for_k(19),
         dict(read_len=(2000, 4000), error_rate=0.01), None),
        ("hpc", IndexParams(w=10, k=15, flag=1), ChainParams.defaults_for_k(15),
         dict(read_len=(500, 1000)), None),
        ("even_k14", IndexParams(w=10, k=14), ChainParams.defaults_for_k(14),
         dict(read_len=(500, 1000)), None),
        ("general", IndexParams(), ChainParams.defaults_for_k(15, min_cnt=1),
         dict(read_len=(500, 1000)), None),
        ("skip_prune", IndexParams(), ChainParams.defaults_for_k(15),
         dict(read_len=(500, 1000)), "MM2T_SKIP_PRUNE"),
    ]
    for i, (name, ip, cp, rkw, env) in enumerate(cases):
        idx = build_index_native([(f"chr_{name}", g)], ip)
        rl = _sim(g, n_reads, seed=seed + 1 + i, **rkw)
        if env:
            os.environ[env] = "1"
        try:
            lines = _lines(Mapper.from_oracle_index(idx, cp, mp).map_reads_paf(rl))
        finally:
            if env:
                del os.environ[env]
        ok, n_cmp = oracle_parity(idx, rl, lines, cp, mp)
        report(f"d_{name}", ok, reads=len(rl), lines=n_cmp)


def phase_cli(genome_bp: int, n_reads: int, seed: int = 31) -> None:
    """e: the CLI's device index build and device mapping in this
    process, and the device index build against the native one."""
    from minimap2_rs_tpu import cli
    from minimap2_rs_tpu.config import ChainParams, IndexParams, MapParams
    from minimap2_rs_tpu.io.fasta import write_fasta
    from minimap2_rs_tpu.models.index_builder import (
        build_index_device,
        build_index_native,
    )
    from minimap2_rs_tpu.oracle.index import OracleIndex
    from minimap2_rs_tpu.oracle.pipeline import map_reads as oracle_map
    from minimap2_rs_tpu.utils.seqsim import random_genome

    g = random_genome(genome_bp, seed=seed)
    reads = _sim(g, n_reads, (500, 1000), seed + 1)
    with tempfile.TemporaryDirectory() as d:
        ref_fa, reads_fa = os.path.join(d, "ref.fa"), os.path.join(d, "reads.fa")
        mmi, paf = os.path.join(d, "ref.mmi"), os.path.join(d, "out.paf")
        write_fasta(ref_fa, [("chrC", g)])
        write_fasta(reads_fa, reads)
        assert cli.main(["index", ref_fa, "--engine", "device", "-d", mmi]) == 0
        assert cli.main(["align", mmi, reads_fa, "--engine", "device", "-o", paf]) == 0
        with open(paf, "rb") as f:
            got = f.read()
        idx = OracleIndex.load_from_mmi(mmi)
    host = oracle_map(idx, reads, ChainParams.defaults_for_k(15), MapParams())
    want = ("\n".join(host) + "\n").encode() if host else b""
    if got != want:
        log(f"cli PAF differs: {len(got)} vs {len(want)} bytes")
    report("e_cli_align", got == want, reads=len(reads), lines=len(host))
    recs = [("chrC", g)]
    dev = build_index_device(recs, IndexParams())
    nat = build_index_native(recs, IndexParams())
    same = all(
        (getattr(dev, a).shape == getattr(nat, a).shape)
        and bool((getattr(dev, a) == getattr(nat, a)).all())
        for a in ("keys", "starts", "counts", "positions")
    )
    report("e_index_build", same, keys=int(nat.keys.shape[0]),
           positions=int(nat.positions.shape[0]))


def anchors_for(ref: Reference, reads, bucket: int, n_batch: int):
    """Sorted device anchors of the longest reads that fit `bucket`, one
    batch at the mapper's own capacities for that bucket."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from minimap2_rs_tpu.models.stages import sketch_to_anchors
    from minimap2_rs_tpu.utils.packing import nt4_encode

    m = ref.mapper
    M, A, window, B = m._shapes_for(bucket, 1)
    B = min(B, n_batch)
    fit = sorted((s for _, s in reads if len(s) <= bucket), key=len)[-B:]
    codes = np.full((B, bucket), 4, np.int32)
    lengths = np.zeros(B, np.int32)
    for i, s in enumerate(fit):
        codes[i, : len(s)] = nt4_encode(s)
        lengths[i] = len(s)
    fn = jax.jit(lambda c, l: sketch_to_anchors(
        m.dev_idx, c, l, jnp.int32(m.mid_occ), w=m.idx.w, k=m.idx.k,
        hpc=False, q_occ_max=m.mp.q_occ_max, q_occ_frac=m.mp.q_occ_frac,
        M=M, A=A,
    ))
    anc = fn(jnp.asarray(codes), jnp.asarray(lengths))
    args = (anc["x_hi"], anc["x_lo"].astype(jnp.int32),
            anc["y_lo"].astype(jnp.int32),
            (anc["y_hi"] & jnp.uint32(0xFF)).astype(jnp.int32))
    return args, min(window, m.lite_window_cap)


def phase_chain(ref: Reference, shapes, interpret: bool = False) -> dict:
    """f: the chain kernel against the scan on real anchors, both
    variants, equal outputs; per-call times taken in turns (kernel,
    scan, scan, kernel). `shapes`: [(name, reads, bucket, n_batch)]."""
    import jax
    import numpy as np

    from minimap2_rs_tpu.ops.chain_ops import (
        chain_dp_aux_batch,
        chain_dp_batch,
        chain_scalars_from_params,
    )
    from minimap2_rs_tpu.ops.chain_triton import chain_dp_triton

    scal = chain_scalars_from_params(ref.cp)
    times = {}
    for name, reads, bucket, n_batch in shapes:
        args, window = anchors_for(ref, reads, bucket, n_batch)
        kern = lambda aux: chain_dp_triton(*args, scal, window, aux=aux,
                                           interpret=interpret)
        scan = {False: lambda: chain_dp_batch(*args, scal, window),
                True: lambda: chain_dp_aux_batch(*args, scal, window)}
        ok = True
        for aux in (False, True):
            a, b = kern(aux), scan[aux]()
            ok &= all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))

        def timed(fn):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            return time.perf_counter() - t0

        t = {"kernel": [], "scan": []}
        for which in ("kernel", "scan", "scan", "kernel"):
            t[which].append(timed(lambda: kern(True) if which == "kernel" else scan[True]()))
        B, A = args[0].shape
        times[name] = {k: [round(x * 1e3, 3) for x in v] for k, v in t.items()}
        report(f"f_chain_{name}", ok, B=B, A=A, window=window,
               kernel_ms=times[name]["kernel"], scan_ms=times[name]["scan"])
    return times


def phase_four(ref: Reference, reads, stride: int) -> None:
    """MeshMapper on four devices: dp=4 (replicated index) and dp=2 x
    ix=2 (hash-range-sharded index, all_to_all anchor exchange), against
    one-device Mapper output and the oracle sample."""
    from minimap2_rs_tpu.models.mesh_mapper import make_mesh_mapper

    one = ref.mapper.map_reads_paf(reads)
    ok, n_cmp = oracle_parity(ref.idx, reads[::stride], _lines(one), ref.cp, ref.mp)
    report("four_single", ok, reads=len(reads), compared_lines=n_cmp)
    for name, kw in (("dp4", dict(dp=4, ix=1)),
                     ("dp2_ix2", dict(dp=2, ix=2, index_sharded=True))):
        mm = make_mesh_mapper(ref.idx, ref.cp, ref.mp, **kw)
        t0 = time.time()
        blob = mm.map_reads_paf(reads)
        dt = time.time() - t0
        ok, n_cmp = oracle_parity(ref.idx, reads[::stride], _lines(blob), ref.cp, ref.mp)
        report(f"four_{name}", ok and blob == one, reads=len(reads),
               same_as_one_device=blob == one, compared_lines=n_cmp,
               first_pass_s=round(dt, 2))


# ---------------------------------------------------------------------


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU MeshMapper comparison")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is {devs[0].platform}",
              file=sys.stderr)
        return 2
    if args.four and len(devs) != 4:
        print(f"chip_smoke --four: needs 4 GPUs, found {len(devs)}", file=sys.stderr)
        return 2

    from minimap2_rs_tpu.runtime.host import native_available
    from minimap2_rs_tpu.utils import compile_cache

    log(gpu_name_and_power())
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}; "
        f"compile cache {compile_cache.configure()}")
    if not native_available():
        raise RuntimeError("the native host runtime did not build")

    t0 = time.time()
    ref = phase_reference(100_000_000)
    if args.four:
        reads = _sim(ref.genome, 16384, (500, 1000), 1)
        phase_four(ref, reads, stride=16)
    else:
        reads, _ = phase_headline(ref, 16384, stride=16)
        long_reads = phase_longread(ref, 512, n_check=64, n_tier=64)
        phase_paths(2_000_000, 128)
        phase_cli(5_000_000, 256)
        phase_chain(ref, [("headline", reads, 1024, 1024),
                          ("longread", long_reads, 24576, 1024)])
    stats = devs[0].memory_stats() or {}
    log(f"peak_bytes_in_use={stats.get('peak_bytes_in_use', 'not available')} "
        f"total_s={round(time.time() - t0, 1)}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
