"""Multi-host (multi-process) dry-run: the distributed mapping step over
a jax.distributed loopback cluster (SURVEY.md section 4.3's third test
tier; VERDICT r1 item 8).

Spawns N worker processes on this machine, each owning
`--devs-per-proc` virtual CPU devices; the workers form one global JAX
cluster via jax.distributed (coordinator on 127.0.0.1, Gloo CPU
collectives — the DCN analog) and run:

  1. the FULL lite mapping pipeline (sketch -> on-device finalize ->
     (B, 18) PAF field rows) data-parallel over a "dp" axis that SPANS
     processes, index replicated — fields allgathered and asserted
     byte-identical to a local single-device run on every process;
  2. the hash-range-sharded pipeline on a mesh whose "ix" axis spans
     processes (the index sharded ACROSS hosts, the large-genome
     regime): per-shard lookups, cross-process all_to_all anchor
     exchange, chaining on the home device, all_gather of fields;
  3. the collective index stats + repetitive-seed quantile
     (index_stats_psum / calc_mid_occ_psum) across processes, asserted
     equal to the host oracle's values.

Usage:
  python multihost_dryrun.py                 # 2 procs x 4 devices
  python multihost_dryrun.py --procs 2 --devs-per-proc 4
  python multihost_dryrun.py --worker I N PORT   (internal)

The reference is a single-process tool (rayon threads,
/root/reference/src/index.rs:442-452); this is the jax.distributed
scale-out design from SURVEY.md section 2's parallelism table.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys


def _worker(pid: int, nproc: int, port: int, devs: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", devs)
    jax.distributed.initialize(
        f"127.0.0.1:{port}", num_processes=nproc, process_id=pid,
        initialization_timeout=120,
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    assert jax.default_backend() == "cpu"
    assert jax.local_device_count() == devs
    n_dev = jax.device_count()
    assert n_dev == nproc * devs
    say = lambda *a: print(f"[proc {pid}]", *a, flush=True)
    say(f"cluster up: {nproc} processes x {devs} devices = {n_dev}")

    from __graft_entry__ import _tiny_problem
    from minimap2_rs_tpu.models.mapper import _fused_map_stage_lite
    from minimap2_rs_tpu.ops.chain_ops import chain_scalars_from_params
    from minimap2_rs_tpu.ops.index_ops import DeviceIndex
    from minimap2_rs_tpu.parallel.pipeline import (
        calc_mid_occ_psum,
        index_stats_psum,
        make_map_batch_dp_lite,
        make_map_batch_sharded_lite,
    )
    from minimap2_rs_tpu.parallel.sharded_index import ShardedDeviceIndex
    from minimap2_rs_tpu.config import ChainParams

    # identical problem on every process (deterministic seeds)
    n_reads = n_dev * 4
    idx, codes, lengths, cp, statics = _tiny_problem(n_reads=n_reads)
    statics = dict(statics, flag_window_ovf=False)
    mid_occ = np.int32(max(idx.calc_mid_occ(2e-4), 10))
    tlens = np.array([s.length for s in idx.seq], dtype=np.int32)
    rs = np.int32(cp.rmq_rescue_size)
    rr = np.float32(cp.rmq_rescue_ratio)
    # numpy leaves everywhere: in multi-process jit, host (numpy) inputs
    # are treated as replicated global values; process-local jnp arrays
    # would be rejected as non-addressable
    to_np = lambda t: jax.tree.map(np.asarray, t)
    scal = to_np(chain_scalars_from_params(cp))
    scal_w = to_np(chain_scalars_from_params(
        __import__("dataclasses").replace(cp, bw=cp.bw_long)
    ))
    dev_idx = to_np(DeviceIndex.from_host(
        idx.keys, idx.starts, idx.counts, idx.positions, key_bits=2 * idx.k
    ))

    # expected: the same batch through the local single-device fused jit
    # (nex is unread on the default 4-bit wire)
    want = np.asarray(_fused_map_stage_lite(
        dev_idx, codes, lengths, np.zeros(1, np.int32), scal, scal_w,
        mid_occ, tlens, rs, rr, **statics, pallas_chain=False,
    ))

    # ---- 1) dp spans processes, index replicated ----------------------
    mesh_dp = Mesh(np.asarray(jax.devices()), ("dp",))
    shard = NamedSharding(mesh_dp, P("dp"))
    per = n_reads // n_dev
    lo = pid * devs * per
    hi = lo + devs * per
    codes_g = jax.make_array_from_process_local_data(shard, codes[lo:hi])
    lengths_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh_dp, P("dp")), lengths[lo:hi]
    )
    fn_dp = make_map_batch_dp_lite(mesh_dp, statics)
    fields = fn_dp(dev_idx, codes_g, lengths_g, scal, scal_w, mid_occ,
                   tlens, rs, rr)
    got = multihost_utils.process_allgather(fields, tiled=True)
    np.testing.assert_array_equal(got, want)
    say("dp-over-processes lite pipeline: fields match single-device run")

    # ---- 2) index hash-range-sharded ACROSS processes ------------------
    # mesh (ix, dp) with ix as the slow axis: ix=0 is process 0's devices,
    # ix=1 is process 1's -> the all_to_all anchor exchange crosses
    # processes (the "index sharded across hosts" large-genome regime)
    n_ix = nproc
    n_dp = n_dev // n_ix
    mesh_sh = Mesh(np.asarray(jax.devices()).reshape(n_ix, n_dp), ("ix", "dp"))
    sidx = to_np(ShardedDeviceIndex.from_host(
        idx.keys, idx.starts, idx.counts, idx.positions,
        n_shards=n_ix, key_bits=2 * idx.k,
    ))
    # the sharded program chains over n_ix * A exchanged slots
    statics_sh = dict(statics, window=statics["window"] * n_ix)
    n_reads_sh = n_dp * n_ix * 2
    fn_sh = make_map_batch_sharded_lite(mesh_sh, statics_sh)
    shard2 = NamedSharding(mesh_sh, P("dp"))
    per2 = n_reads_sh // n_dp
    # dp shards within each ix replica row; data replicated over ix
    codes2 = codes[:n_reads_sh]
    lengths2 = lengths[:n_reads_sh]
    fields_sh = fn_sh(sidx, codes2, lengths2, scal, scal_w, mid_occ,
                      tlens, rs, rr)
    got_sh = np.asarray(multihost_utils.process_allgather(fields_sh, tiled=True))
    from minimap2_rs_tpu.ops.finalize_ops import (
        FIELDS,
        WIRE_WORDS,
        unpack_fields_wire,
    )

    # reads that overflow the single-device A anchor slots legitimately
    # differ: the sharded path has n_ix * A post-exchange slots (the
    # production MeshMapper re-routes flagged reads; dryrun just skips).
    # (field rows travel packed — unpack to address by name)
    wf = (unpack_fields_wire(want) if want.shape[1] == WIRE_WORDS
          else want)
    ovf = wf[:n_reads_sh, FIELDS.index("anc_ovf")] != 0
    np.testing.assert_array_equal(got_sh[~ovf], want[:n_reads_sh][~ovf])
    assert (~ovf).sum() >= n_reads_sh - 2
    say("cross-process sharded-index pipeline (all_to_all over DCN analog): fields match")

    # ---- 3) collective stats + occ quantile across processes ----------
    nk, npos = index_stats_psum(mesh_sh, sidx)
    assert nk == int(idx.keys.shape[0]), (nk, idx.keys.shape)
    assert npos == int(idx.positions.shape[0])
    assert calc_mid_occ_psum(mesh_sh, sidx, 2e-4) == idx.calc_mid_occ(2e-4)
    say("psum stats + distributed occ quantile match the oracle")

    multihost_utils.sync_global_devices("mm2t_multihost_dryrun_done")
    say("OK")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devs-per-proc", type=int, default=4)
    ap.add_argument("--worker", nargs=3, type=int, metavar=("PID", "NPROC", "PORT"))
    args = ap.parse_args()

    if args.worker:
        pid, nproc, port = args.worker
        _worker(pid, nproc, port, args.devs_per_proc)
        return 0

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(args.procs):
        procs.append(subprocess.Popen([
            sys.executable, os.path.abspath(__file__),
            "--worker", str(pid), str(args.procs), str(port),
            "--devs-per-proc", str(args.devs_per_proc),
        ]))
    rc = 0
    for pid, p in enumerate(procs):
        p.wait()
        if p.returncode != 0:
            print(f"worker {pid} FAILED rc={p.returncode}", flush=True)
            rc = 1
    print("multihost dryrun:", "OK" if rc == 0 else "FAILED", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
