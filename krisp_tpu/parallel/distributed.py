"""Multi-device sharded k-mer pipeline (jax.sharding.Mesh + shard_map).

The reference's concurrency story is single-node multiprocessing over files
and byte-range file shards (/root/reference/src/krisp/krisp_fasta/
krisp_fasta.py:86-123, shared.py:133-207, intersectAmplicons.py:131-187 — the
latter disabled for nondeterminism).  The device-mesh equivalent:

  - **sequence parallelism**: each device owns a contiguous slice of the
    genome buffer; a ppermute halo exchange ships the (L-1)-base prefix of
    the next shard left so windows crossing shard boundaries are computed
    exactly once (the device-mesh analog of the reference's 1 kb chunk-flank
    overlap, krisp_vcf.py:1036-1040).
  - **local sort + unique** per device (same kernels as single-chip).
  - **key-range ownership**: shard s owns keys whose leading bits bucket to
    s; rows move to their owner once via a padded all_to_all, so the
    concatenation over shards is the globally sorted table.  Deterministic by
    construction — result order is a pure function of key order, never of
    scheduling (the property whose absence forced the reference to disable
    its parallel merge, intersectAmplicons.py:216-218).
  - **stats reduction**: per-shard valid-key totals and exchange-overflow
    flags psum over the mesh.

The exchange is a padded all_to_all: each shard slices its (locally sorted,
hence bucket-contiguous) table into per-destination runs, pads them to a
2x-mean capacity, and ships each run once; an overflow counter reports when
a skewed key distribution needs a larger capacity.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .. import dna
from ..metrics import GLOBAL as METRICS
from ..ops.encode import encode_ascii, window_validity, pack_windows, sort_perm, num_words
from ..ops.sort import sort_keys, unique_counts


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def mesh_from_env(n_devices: int | None = None,
                  axis: str = "shard") -> Mesh | None:
    """The device-mesh gate shared by all three verticals: explicit
    request via ``n_devices`` or the KRISP_TPU_DEVICES env var, else every
    available device.  None when only one device is usable (callers take
    their single-device path)."""
    import os
    if n_devices is None:
        env = os.environ.get("KRISP_TPU_DEVICES")
        n_devices = int(env) if env else len(jax.devices())
    n = min(int(n_devices), len(jax.devices()))
    if n <= 1:
        return None
    return make_mesh(n, axis)


def _halo_exchange(block, halo: int, axis: str):
    """Append the next shard's first ``halo`` elements to this shard's block.

    The last shard receives an all-invalid halo (zero bytes = NUL sentinel),
    so no window is fabricated past the end of the genome.
    """
    n = jax.lax.psum(1, axis)
    idx = jax.lax.axis_index(axis)
    head = block[:halo]
    # send my head to my left neighbor (shard i receives from i+1)
    perm = [(i, (i - 1) % n) for i in range(n)]
    recv = jax.lax.ppermute(head, axis, perm)
    recv = jnp.where(idx == n - 1, jnp.zeros_like(recv), recv)
    return jnp.concatenate([block, recv])


def _owner_of(w0, valid, n_shards: int, t: int):
    """Monotone range partition of keys onto shards by the top ``t`` bits
    of (MSB-aligned) key word 0: owner = floor(top * n_shards / 2**t).

    Covers every shard count — a plain ``top-bits == shard-id`` mapping
    silently drops rows whose bucket exceeds n_shards - 1 whenever
    n_shards is not a power of two — and reduces to exactly that mapping
    for power-of-two n_shards with t >= log2(n_shards), so the
    1/2/4/8-device byte-equality pins are unchanged.  Monotone in the key
    prefix: equal prefixes (hence equal flanks) always share an owner and
    concatenating shards in order preserves global key order.  Invalid
    rows map to ``n_shards`` (sorted last, never shipped)."""
    top = (w0 >> jnp.uint32(32 - t)).astype(jnp.int32)
    owner = (top * n_shards) >> t
    return jnp.where(valid, owner, n_shards)


def sharded_kmer_step(mesh: Mesh, left: int, mid: int, right: int, bits: int,
                      n_files: int):
    """Build the jitted multi-device step: sharded ASCII buffers -> per-shard
    sorted unique tables (key-range partitioned) + global stats.

    Input shapes (per full array, sharded over axis 0):
      buffers: uint8[n_files, n_shards * chunk]  — one genome per file row,
      sharded along the sequence axis.
    Returns (invalid, words, file_id, counts) each sharded over the mesh
    axis, plus the psum'd total number of valid keys.
    """
    L = left + mid + right
    axis = mesh.axis_names[0]
    n_shards = mesh.devices.size
    perm = sort_perm(left, mid, right)
    code_table = dna.CODE2_TABLE if bits == 2 else dna.CODE4_TABLE
    comp_table = dna.COMP2_TABLE if bits == 2 else dna.COMP4_TABLE
    valid_table = dna.base_validity_table(bits, disallow="Nn")
    t_owner = min(10, L * bits, 32)

    def per_shard(buffers):
        # buffers: uint8[n_files, chunk] local slice
        tables = []
        for f in range(n_files):
            block = _halo_exchange(buffers[f], L - 1, axis)
            codes, valid = encode_ascii(block, code_table, valid_table)
            ok = window_validity(valid, L)
            n_win = ok.shape[0]
            fwd = pack_windows(codes, perm, bits, n_win)
            comp = jnp.take(jnp.asarray(comp_table), codes).astype(jnp.uint32)
            rc = pack_windows(comp, tuple(L - 1 - p for p in perm), bits, n_win)
            words = [jnp.concatenate([a, b]) for a, b in zip(fwd, rc)]
            invalid = (~jnp.concatenate([ok, ok])).astype(jnp.uint32)
            inv_s, words_s, _ = sort_keys(invalid, words)
            u_inv, u_words, u_cnt, _ = unique_counts(inv_s, words_s)
            tables.append((u_inv, u_words, u_cnt))

        # Key-range exchange: every row moves exactly once to the shard that
        # owns its bucket (top key bits), via all_to_all with per-destination
        # padding and an overflow flag (the production transport; the
        # reference's analog — byte-range sharding — was abandoned as
        # nondeterministic, intersectAmplicons.py:216-218).
        inv = jnp.concatenate([t[0] for t in tables])
        words = [jnp.concatenate([t[1][w] for t in tables])
                 for w in range(num_words(L, bits))]
        cnts = jnp.concatenate([t[2] for t in tables])
        fids = jnp.concatenate([jnp.full(tables[f][0].shape[0], f, jnp.uint32)
                                for f in range(n_files)])

        # sort locally so bucket runs are contiguous and ascending
        inv, words, (fids, cnts) = sort_keys(inv, words, (fids, cnts))
        m = inv.shape[0]
        valid = inv == 0
        bucket = _owner_of(words[0], valid, n_shards, t_owner)
        # per-destination run starts/counts in the sorted local table
        count_d = jnp.stack([jnp.sum((bucket == d).astype(jnp.int32))
                             for d in range(n_shards)])
        start_d = jnp.concatenate([jnp.zeros(1, jnp.int32),
                                   jnp.cumsum(count_d)[:-1].astype(jnp.int32)])

        cap = max(2 * (m // max(n_shards, 1)) + 64, 64)
        overflow = jnp.sum((count_d > cap).astype(jnp.int32))

        def send_matrix(x, fill):
            xp = jnp.concatenate([x, jnp.full(cap, fill, x.dtype)])
            rows = []
            for d in range(n_shards):
                row = jax.lax.dynamic_slice(xp, (start_d[d],), (cap,))
                j = jnp.arange(cap, dtype=jnp.int32)
                rows.append(jnp.where(j < count_d[d], row, fill))
            return jnp.stack(rows)

        def exchange(x):
            return jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
                                      tiled=False)

        r_words = [exchange(send_matrix(w, jnp.uint32(0xFFFFFFFF)))
                   .reshape(n_shards * cap) for w in words]
        r_fids = exchange(send_matrix(fids, jnp.uint32(0))) \
            .reshape(n_shards * cap)
        r_cnts = exchange(send_matrix(cnts, jnp.uint32(0))) \
            .reshape(n_shards * cap)
        r_inv = exchange(send_matrix(inv, jnp.uint32(1))) \
            .reshape(n_shards * cap)

        # local sort of the owned range: global order = shard order + local
        l_inv, l_words, (l_fids, l_cnts) = sort_keys(
            r_inv, r_words, (r_fids, r_cnts))
        total_valid = jax.lax.psum(jnp.sum((l_inv == 0).astype(jnp.int32)),
                                   axis)
        overflow = jax.lax.psum(overflow, axis)
        return (l_inv, jnp.stack(l_words), l_fids, l_cnts, total_valid,
                overflow)

    spec = P(None, axis)
    out_specs = (P(axis), P(None, axis), P(axis), P(axis), P(), P())
    fn = shard_map(per_shard, mesh=mesh, in_specs=(spec,),
                   out_specs=out_specs, check_vma=False)
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# Full distributed intersection (krisp_fasta across the whole mesh)
# ---------------------------------------------------------------------------
#
# Key-range ownership does the heavy lifting: a row's owner shard is chosen
# by the TOP BITS OF KEY WORD 0, which are the leading bases of the flank.
# Rows with the same flank therefore always map to the same owner, so every
# flank run — and every full-key duplicate run inside it — is COMPLETE within
# one shard after the exchange.  Survivor marking, duplicate counting, and
# compaction need no cross-shard communication at all; the per-shard scan is
# byte-identical to the single-chip fused path over its owned key range.
# This is the deterministic replacement for the reference's tournament of
# pairwise file merges (intersectAmplicons.py:232-310) whose parallel variant
# was disabled for nondeterminism (intersectAmplicons.py:216-218).

from functools import lru_cache


@lru_cache(maxsize=None)
def sharded_intersect_step(mesh: Mesh, left: int, mid: int, right: int,
                           bits: int, n_files: int, cap: int, exch_cap: int,
                           omit_soft: bool = False):
    """Build the jitted full-pipeline multi-device step.

    Input: uint8[n_files, n_shards * chunk] ASCII buffers, sharded along
    the sequence axis.  Per shard: halo exchange -> window keys in the
    bit-packed KeyLayout (genome id inside the key) -> bucket-contiguity
    sort -> padded all_to_all key-range exchange -> local LSD sort ->
    survivor marking -> capped compaction.

    Returns per call: (words [W, n_shards*cap], counts, group_ids,
    n_keep[n_shards], overflow_total, needed_capacity).  ``overflow_total``
    > 0 means some destination run exceeded ``exch_cap`` and rows were
    dropped — the caller must retry with ``exch_cap >= needed_capacity``.
    """
    from ..ops.encode import window_keys_bits, KeyLayout
    from ..ops.intersect import (SENTINEL, survivor_mark_bits, compact_rows)
    from ..ops.sort import lsd_sort

    L = left + mid + right
    axis = mesh.axis_names[0]
    n_shards = mesh.devices.size
    layout = KeyLayout(left, mid, right, bits, n_files)
    W = layout.n_words
    fword, fshift = layout.file_word_shift()
    bbits = max((n_shards - 1).bit_length(), 1)
    assert layout.flank_bits >= bbits or n_shards == 1, (
        "flank too short to key-range partition across this many devices")
    t_owner = min(10, layout.flank_bits, 32)

    code_table = dna.CODE2_TABLE if bits == 2 else dna.CODE4_TABLE
    comp_table = dna.COMP2_TABLE if bits == 2 else dna.COMP4_TABLE
    valid_table = dna.base_validity_table(bits, disallow="Nn",
                                          omit_soft=omit_soft)

    def per_shard(buffers):
        # 1. window keys for this shard's slice (+ halo), both strands
        oks, wordl = [], []
        for f in range(n_files):
            block = _halo_exchange(buffers[f], L - 1, axis)
            ok, words = window_keys_bits(block, code_table, valid_table,
                                         comp_table, left, mid, right, bits,
                                         n_files)
            words[fword] = words[fword] | (jnp.uint32(f)
                                           << jnp.uint32(fshift))
            oks.append(ok)
            wordl.append(words)
        ok = jnp.concatenate(oks)
        words = [jnp.concatenate([wl[w] for wl in wordl]) for w in range(W)]
        flat = [jnp.where(ok, w, SENTINEL) for w in words]
        inv = (~ok).astype(jnp.uint32)

        # 2. bucket-contiguity sort: stable by (validity, word0) so each
        # destination's rows form one contiguous run (invalid rows last,
        # never shipped)
        ks, ps = lsd_sort([inv, flat[0]], flat[1:])
        inv_s, w0 = ks
        words_s = [w0] + list(ps)
        valid = inv_s == 0
        bucket = _owner_of(w0, valid, n_shards, t_owner)
        count_d = jnp.stack([jnp.sum((bucket == d).astype(jnp.int32))
                             for d in range(n_shards)])
        start_d = jnp.concatenate([jnp.zeros(1, jnp.int32),
                                   jnp.cumsum(count_d)[:-1].astype(jnp.int32)])
        overflow = jnp.sum((count_d > exch_cap).astype(jnp.int32))
        needed = jnp.max(count_d)

        # 3. padded all_to_all: every row moves once to its owner
        def send_matrix(x):
            xp = jnp.concatenate([x, jnp.full(exch_cap, SENTINEL, x.dtype)])
            rows = []
            j = jnp.arange(exch_cap, dtype=jnp.int32)
            for d in range(n_shards):
                row = jax.lax.dynamic_slice(xp, (start_d[d],), (exch_cap,))
                rows.append(jnp.where(
                    j < jnp.minimum(count_d[d], exch_cap), row, SENTINEL))
            return jnp.stack(rows)

        def exchange(x):
            return jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
                                      tiled=False)

        r_words = [exchange(send_matrix(w)).reshape(n_shards * exch_cap)
                   for w in words_s]

        # 4. owner-local sort + the identical single-chip survivor scan
        keys_sorted, _ = lsd_sort(r_words)
        keep, counts, group_id = survivor_mark_bits(keys_sorted, layout,
                                                    n_files)
        (words_c, cnt_c, gid_c), n_keep = compact_rows(
            [jnp.stack(keys_sorted), counts, group_id], keep, cap)

        overflow = jax.lax.psum(overflow, axis)
        needed = jax.lax.pmax(needed, axis)
        # pack everything into one array (one host pull per call):
        # rows 0..W-1 words, W counts, W+1 gids, W+2 tail
        # (tail: [0]=n_keep, [1]=overflow, [2]=needed)
        tail = (jnp.zeros((1, cap), jnp.uint32)
                .at[0, 0].set(n_keep.astype(jnp.uint32))
                .at[0, 1].set(overflow.astype(jnp.uint32))
                .at[0, 2].set(needed.astype(jnp.uint32)))
        return jnp.concatenate([words_c, cnt_c[None].astype(jnp.uint32),
                                gid_c[None].astype(jnp.uint32), tail],
                               axis=0)

    spec = P(None, axis)
    fn = shard_map(per_shard, mesh=mesh, in_specs=(spec,),
                   out_specs=P(None, axis), check_vma=False)
    return jax.jit(fn)


def sharded_intersect_pipeline(mesh: Mesh, stacked: np.ndarray, left: int,
                               mid: int, right: int, bits: int,
                               omit_soft: bool = False, cap: int = 1 << 16):
    """Host driver for the full distributed intersection with auto-retry.

    stacked: uint8[n_files, P] genome buffers; P must be a multiple of the
    mesh size (caller pads).  Retries with a larger exchange capacity when
    a skewed key distribution overflows the padded all_to_all (the analog
    of the single-chip compaction-cap retry loop, engine/pipeline.py), and
    with a larger compaction cap when a shard's survivor set overflows.

    Returns (words_h uint32[n_keep, W], cnt_h, gid_h) — the same row set,
    order, and encoding as the single-chip ``fused_pipeline_bits`` output,
    with globally unique group ids.
    """
    n_files, P = stacked.shape
    n_shards = mesh.devices.size
    assert P % n_shards == 0
    chunk = P // n_shards
    L = left + mid + right
    assert chunk >= L, "per-shard slice shorter than the window length"
    m = 2 * chunk * n_files
    exch_cap = max(2 * (m // n_shards) + 64, 64)

    while True:
        step = sharded_intersect_step(mesh, left, mid, right, bits, n_files,
                                      cap, exch_cap, omit_soft)
        packed = np.asarray(step(stacked))     # one pull
        tails = packed[-1].reshape(n_shards, cap)
        overflow = int(tails[0, 1])
        if overflow > 0:
            METRICS.count("exchange_retry")
            needed = int(tails[0, 2])
            exch_cap = -(-(needed + 64) // 64) * 64
            continue
        nk = tails[:, 0].astype(np.int64)
        if nk.max(initial=0) > cap:
            cap = -(-int(nk.max()) // (1 << 12)) * (1 << 12)
            continue
        break

    from ..ops.encode import KeyLayout
    W = KeyLayout(left, mid, right, bits, n_files).n_words
    return assemble_compacted(packed[:W], packed[W],
                              packed[W + 1].astype(np.int64), nk, cap,
                              n_shards)


def assemble_compacted(words, cnts, gids, nk, cap: int, n_shards: int):
    """Concatenate per-shard compacted survivor rows (shard order = key
    order) with globally unique, order-preserving group ids.  Shared by the
    single-process driver and the multi-process path (which allgathers the
    shards first)."""
    rows_w, rows_c, rows_g = [], [], []
    gid_off = 0
    for s in range(n_shards):
        k = int(nk[s])
        if k == 0:
            continue
        sl = slice(s * cap, s * cap + k)
        rows_w.append(words[:, sl])
        rows_c.append(cnts[sl])
        g = gids[sl].astype(np.int64) + gid_off
        gid_off = int(g[-1]) + 1
        rows_g.append(g)
    if not rows_w:
        W = words.shape[0]
        return (np.zeros((0, W), np.uint32), np.zeros(0, np.uint32),
                np.zeros(0, np.int64))
    return (np.concatenate(rows_w, axis=1).T, np.concatenate(rows_c),
            np.concatenate(rows_g))
