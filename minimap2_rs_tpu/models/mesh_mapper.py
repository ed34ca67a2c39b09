"""Multi-device Mapper: the production mapping path over a jax mesh.

MeshMapper runs the lite (on-device-finalize) pipeline through
parallel/pipeline.py's shard_map programs — reads data-parallel over the
mesh's "dp" axis, the index either replicated or hash-range-sharded over
"ix" with an all_to_all anchor exchange — and reuses Mapper's host
machinery (batching, tier-2 overflow re-runs, host fallback, PAF
formatting) unchanged. Output is byte-identical to the single-device
Mapper and to the host oracle.

This is the distributed analog of the reference's rayon data parallelism
(/root/reference/src/index.rs:442-452,77-108) applied to the whole align
stack (main.rs:189-230), per SURVEY.md section 2's parallelism table.

Non-default parameterizations that are not lite-eligible (min_cnt <= 1)
fall back to the inherited single-device general path — they need host
backtracking anyway, so the mesh would only move the chain scores.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.chain_ops import chain_scalars_from_params
from .mapper import Mapper, _chain_skip_cfg, _use_pallas_chain


@dataclasses.dataclass
class MeshMapper(Mapper):
    """Mapper over a jax.sharding.Mesh with axes ("dp",) or ("dp", "ix").

    index_sharded=True splits the minimizer table into mesh.shape["ix"]
    hash ranges (parallel/sharded_index.py); False replicates the index
    on every device (no communication in the hot path)."""

    mesh: object = None          # jax.sharding.Mesh
    index_sharded: bool = False
    wire2: bool = False          # mesh programs take the 4-bit wire

    def __post_init__(self):
        super().__post_init__()
        assert self.mesh is not None, "MeshMapper requires a mesh"
        assert "dp" in self.mesh.shape, "mesh must have a 'dp' axis"
        self._n_dp = int(self.mesh.shape["dp"])
        self._n_ix = int(self.mesh.shape.get("ix", 1))
        if self.index_sharded:
            assert self._n_ix >= 1, "index_sharded needs an 'ix' mesh axis"

    # ------------------------------------------------------------------

    def _shapes_for(self, bucket: int, mult: int):
        """Batch must split over dp, and each dp row's slice over ix
        (the all_to_all splits the per-row batch dimension)."""
        M, A, window, B = super()._shapes_for(bucket, mult)
        step = self._n_dp * self._n_ix
        B = max(step, B // step * step)
        return M, A, window, B

    def _quantize_b(self, n: int, b_max: int):
        """Chunk capacities must additionally divide over the mesh step
        (dp * ix) for shard_map; quantize to the lcm of the base 128
        unit and the step, falling back to b_max (already
        step-divisible) when that overshoots."""
        from math import gcd

        step = self._n_dp * self._n_ix
        unit = 128 * step // gcd(128, step)
        q = -(-Mapper._quantize_b(n, b_max) // unit) * unit
        return q if q <= b_max else b_max

    def _sharded_index(self):
        if not hasattr(self, "_sidx"):
            from ..parallel.sharded_index import ShardedDeviceIndex

            self._sidx = ShardedDeviceIndex.from_host(
                self.idx.keys, self.idx.starts, self.idx.counts,
                self.idx.positions, n_shards=self._n_ix,
                key_bits=2 * self.idx.k,
            )
        return self._sidx

    def _mesh_index(self):
        """The index placed on the mesh once: replicated on every device,
        or split over "ix" when hash-range-sharded. Left on one device,
        every call would copy it to the mesh again."""
        if not hasattr(self, "_idx_on_mesh"):
            from jax.sharding import NamedSharding, PartitionSpec as P

            if self.index_sharded:
                idx, spec = self._sharded_index(), P("ix")
            else:
                idx, spec = self.dev_idx, P()
            self._idx_on_mesh = jax.device_put(idx, NamedSharding(self.mesh, spec))
        return self._idx_on_mesh

    def _to_device(self, packed4, lengths):
        """Place each read shard directly on its home device: codes and
        lengths are consumed sharded over ('dp',) or ('dp', 'ix') — a
        replicated/committed-to-one-device array would force a serial
        reshard inside every executable call."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        axes = ("dp", "ix") if self.index_sharded and self._n_ix > 1 else "dp"
        s2 = NamedSharding(self.mesh, P(axes, None))
        s1 = NamedSharding(self.mesh, P(axes))
        return (
            jax.device_put(packed4, s2),
            jax.device_put(np.asarray(lengths), s1),
        )

    def _device_stage_lite(self, codes, lengths, M, A, scalars, window,
                           wide: bool = True, nex=None, wire: str = "4bit"):
        from ..parallel.pipeline import (
            make_map_batch_dp_lite,
            make_map_batch_sharded_lite,
        )

        assert wire == "4bit" and nex is None, "mesh path is 4-bit wire"

        self._ensure_meta()
        if not hasattr(self, "_tlens_dev"):
            self._tlens_dev = jnp.asarray(self._tlens)
            self._scalars_wide = chain_scalars_from_params(
                dataclasses.replace(self.cp, bw=self.cp.bw_long)
            )
            self._mesh_fns = {}
        if self.index_sharded and self._n_ix > 1:
            # hash64 spreads occurrences uniformly over the hash-range
            # shards, so each shard needs only ~A/n_ix slots per read;
            # keeping the full A per shard would make the post-exchange
            # chain run at n_ix * A slots — n_ix times the replicated
            # DP cost. A shard whose share overflows flags the read
            # exactly (anc_ovf) and it re-runs through the 4x tier.
            A = max(128, -(-A // self._n_ix // 128) * 128)
        # the sharded mode chains over the exchanged n_ix * A slots;
        # window/truncation-flag semantics apply to that total
        A_total = A * (self._n_ix if self.index_sharded else 1)
        window = min(window, A_total)
        flag_wovf = window < min(self.cp.max_chain_iter, A_total)
        pallas = _use_pallas_chain()
        mcs = _chain_skip_cfg(self.cp)
        key = (
            codes.shape, M, A, window, flag_wovf, pallas,
            self.index_sharded, mcs, wide,
        )
        idx_arg = self._mesh_index()
        args = (
            idx_arg, codes, lengths, scalars, self._scalars_wide,
            jnp.int32(self.mid_occ),
            self._tlens_dev, jnp.int32(self.cp.rmq_rescue_size),
            jnp.float32(self.cp.rmq_rescue_ratio),
        )
        if key not in self._mesh_fns:
            statics = dict(
                w=self.idx.w, k=self.idx.k, hpc=False,
                q_occ_max=self.mp.q_occ_max, q_occ_frac=self.mp.q_occ_frac,
                M=M, A=A, window=window, pallas_chain=pallas,
                flag_window_ovf=flag_wovf, packed=True,
                max_chain_skip=mcs, wide=wide,
            )
            maker = (
                make_map_batch_sharded_lite if self.index_sharded
                else make_map_batch_dp_lite
            )
            if self.index_sharded and self._n_ix > 1:
                # record the exact cross-device payload of this program
                from ..parallel.pipeline import sharded_payload_bytes

                B_row = codes.shape[0] // self._n_dp
                self.stats.setdefault("ici_payload", {}).update(
                    {str(key[0]): sharded_payload_bytes(
                        statics, B_row, self._n_ix)}
                )
            # one jitted shard_map program per static configuration
            self._mesh_fns[key] = maker(self.mesh, statics)
        return self._mesh_fns[key](*args)


def make_mesh_mapper(
    idx, cp, mp=None, *, dp: int | None = None, ix: int = 1,
    index_sharded: bool = False, devices=None, **kw,
) -> MeshMapper:
    """Build a MeshMapper over the available devices: dp x ix mesh
    (dp defaults to n_devices // ix)."""
    from ..config import MapParams
    from ..parallel.mesh import make_mesh

    devices = devices if devices is not None else jax.devices()
    if dp is None:
        dp = max(1, len(devices) // ix)
    mesh = make_mesh(dp=dp, ix=ix, devices=devices[: dp * ix])
    return MeshMapper.from_oracle_index(
        idx, cp, mp if mp is not None else MapParams(),
        mesh=mesh, index_sharded=index_sharded, **kw,
    )
