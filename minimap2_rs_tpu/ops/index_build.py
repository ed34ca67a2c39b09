"""Device-side index construction (SURVEY.md section 7 step 4).

Long sequences are cut into fixed-size chunks with (w+k)-base halos on
both sides; each chunk row runs the vectorized sketch and keeps only
records whose position falls in its owned range. Halo math guarantees the
owned emissions equal the full-sequence scan's:

- a window is complete iff its run depth >= w+k-1, and any run extending
  past the left halo already has local depth >= w+k at owned positions;
- spurious completion-step events from runs that began before the chunk
  land inside the halo, so their tie corrections never touch owned
  records;
- run-end drops whose target is owned always see the terminating N
  within the right halo;
- the sequence-end flush fires only on each sequence's true last chunk
  (emit_final).

The result is a device-resident sorted (key, rid_pos_strand) pair array —
the uniquing-free index layout: lookup is lower/upper bound over the full
pair array, occurrence blocks are contiguous runs (replacing the
reference's bucket sort + HashMap build, /root/reference/src/index.rs:74-109).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import u64
from .sketch import sketch_positions
from .u64 import U64Pair

I32 = jnp.int32
U32 = jnp.uint32


def plan_chunks(seq_lens: list[int], chunk: int, w: int, k: int):
    """Chunking plan: list of (rid, seq_off, own_start, own_len, halo_left,
    content_len, is_last). own region = [own_start, own_start + own_len)
    in sequence coordinates."""
    halo = w + k
    plan = []
    for rid, L in enumerate(seq_lens):
        pos = 0
        while pos < L or (L > 0 and pos == 0):
            own_len = min(chunk, L - pos)
            left = min(halo, pos)
            is_last = pos + own_len >= L
            right = 0 if is_last else min(halo, L - (pos + own_len))
            content = left + own_len + right
            plan.append((rid, pos - left, pos, own_len, left, content, is_last))
            pos += own_len
            if pos >= L:
                break
        if L == 0:
            continue
    return plan


@functools.partial(jax.jit, static_argnames=("w", "k", "is_hpc", "max_out"))
def sketch_chunk_flat(
    codes: jnp.ndarray,     # (B, C) nt4 codes (chunk content incl. halos)
    content: jnp.ndarray,   # (B,) content lengths
    own_start: jnp.ndarray, # (B,) local start of owned range
    own_len: jnp.ndarray,   # (B,) owned length
    seq_off: jnp.ndarray,   # (B,) sequence coordinate of local position 0
    rid: jnp.ndarray,       # (B,) sequence ids
    emit_final: jnp.ndarray,  # (B,) bool
    w: int,
    k: int,
    is_hpc: bool,
    max_out: int,
):
    """Sketch chunk rows, mask to owned positions, convert to global
    coordinates, and compact the WHOLE batch into one flat (max_out,)
    buffer per column via a single payload sort (padding is U32-max and
    sorts to the end). Returns (kh, kl, rh, rl, n_total, overflow); keys
    already have the span byte dropped (index.rs:71)."""
    B, C = codes.shape
    ks, ps, emitted = sketch_positions(codes, content, w, k, is_hpc, emit_final)
    idx = jnp.broadcast_to(jnp.arange(C, dtype=I32), (B, C))
    owned = (idx >= own_start[:, None]) & (idx < (own_start + own_len)[:, None])
    emitted = emitted & owned
    key = u64.shr(ks, 8)  # drop the span byte
    # global position: local pos + seq_off (ps packs pos<<1|strand)
    gpos = ps + (seq_off[:, None].astype(U32) << U32(1))
    rps_hi = jnp.broadcast_to(rid[:, None].astype(U32), (B, C))
    sentinel = U32(0xFFFFFFFF)
    flat = lambda a, m: jnp.where(m, a, sentinel).reshape(-1)
    skey = (~emitted).astype(U32).reshape(-1)
    _, kh, kl, rh, rl = jax.lax.sort(
        (skey, flat(key.hi, emitted), flat(key.lo, emitted),
         flat(rps_hi, emitted), flat(gpos, emitted)),
        dimension=-1, num_keys=1,
    )
    n = jnp.sum(emitted).astype(I32)
    return (
        kh[:max_out], kl[:max_out], rh[:max_out], rl[:max_out],
        n, n > max_out,
    )


def sort_minimizer_pairs(kh, kl, rh, rl):
    """Global 4-key sort of flat minimizer arrays: by hashed key then by
    rid_pos_strand — exactly the order of the reference's per-key
    position sort (index.rs:79,98). Padding (all-ones) lands at the end."""
    return jax.lax.sort((kh, kl, rh, rl), dimension=-1, num_keys=4)


_sort_minimizer_pairs = jax.jit(sort_minimizer_pairs)


def build_sorted_pairs_device(
    records: list[tuple[int, np.ndarray]],  # (rid, nt4 codes)
    w: int,
    k: int,
    is_hpc: bool = False,
    chunk: int = 1 << 18,
    batch_rows: int = 16,
) -> tuple[np.ndarray, np.ndarray]:
    """Sketch all sequences on device, chunked; returns host uint64 arrays
    (keys, rid_pos_strand) globally sorted by (key, value).

    All batches stay on device (async dispatch, no per-batch sync); the
    global sort runs on device and ONE transfer pulls the result."""
    halo = w + k
    C = chunk + 2 * halo
    # minimizer density is ~2/(w+1) ~= 0.18 at w=10; 0.3 is a safe cap
    # for the batch-flat buffer (overflow is detected and raises)
    max_out = int(batch_rows * C * 0.3) // 8 * 8
    plan = plan_chunks([len(c) for _, c in records], chunk, w, k)
    bufs = []
    ns = []
    ovfs = []
    for b0 in range(0, len(plan), batch_rows):
        rows = plan[b0 : b0 + batch_rows]
        B = batch_rows
        codes = np.full((B, C), 4, dtype=np.uint8)
        content = np.zeros(B, dtype=np.int32)
        own_start = np.zeros(B, dtype=np.int32)
        own_len = np.zeros(B, dtype=np.int32)
        seq_off = np.zeros(B, dtype=np.int32)
        rid_arr = np.zeros(B, dtype=np.int32)
        emit_final = np.zeros(B, dtype=bool)
        for bi, (rid, arr_start, own0, olen, left, clen, is_last) in enumerate(rows):
            seq = records[rid][1]
            codes[bi, :clen] = seq[arr_start : arr_start + clen]
            content[bi] = clen
            own_start[bi] = left
            own_len[bi] = olen
            seq_off[bi] = arr_start
            rid_arr[bi] = records[rid][0]
            emit_final[bi] = is_last
        kh, kl, rh, rl, n, ovf = sketch_chunk_flat(
            jnp.asarray(codes), jnp.asarray(content), jnp.asarray(own_start),
            jnp.asarray(own_len), jnp.asarray(seq_off), jnp.asarray(rid_arr),
            jnp.asarray(emit_final), w, k, is_hpc, max_out,
        )
        bufs.append((kh, kl, rh, rl))
        ns.append(n)
        ovfs.append(ovf)
    if not bufs:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint64)
    if bool(np.asarray(jnp.stack(ovfs)).any()):
        raise RuntimeError("minimizer overflow in index chunk; raise max_out")
    total = int(np.asarray(jnp.stack(ns)).sum())
    cat = [jnp.concatenate([b[i] for b in bufs]) for i in range(4)]
    srt = _sort_minimizer_pairs(*cat)
    # transfer only real entries (padding sorted to the end), rounded to
    # 1M-element steps so the slice programs stay cacheable; for k <= 16
    # the key's high word is zero and never shipped
    tpad = min(cat[0].shape[0], -(-max(total, 1) // (1 << 20)) * (1 << 20))
    srt = [a[:tpad] for a in srt]
    if 2 * k > 32:
        kh = np.asarray(srt[0])[:total].astype(np.uint64)
    else:
        kh = 0
    kl, rh, rl = (np.asarray(a)[:total] for a in srt[1:])
    keys = (kh << np.uint64(32)) | kl if 2 * k > 32 else kl.astype(np.uint64)
    rps = (rh.astype(np.uint64) << np.uint64(32)) | rl
    return keys, rps
