"""Multi-device kstream: the sorted unique (k-mer, count) table built
across a ``jax.sharding.Mesh``.

Layout mirrors the distributed krisp_fasta pipeline (distributed.py): the
genome buffer is sequence-sharded with a (k-1)-base ppermute halo; each
shard extracts/sorts/dedups its windows locally, then a key-range
``all_to_all`` ships every unique row to the shard that owns its leading
key bits.  Ownership is monotone in the key, so cross-shard duplicates of
one k-mer always land on a single owner — the owner merges their counts
with 1-D scans (no gather), and concatenating the shard tables in mesh
order IS the globally sorted stream.  The reference's analog is one GNU
``sort`` process over the whole stream (kstream.py:45-119); its
parallelism caps at one node's cores, this scales with the mesh.

Byte parity with the host string pipeline is pinned at 1/2/4/8 virtual
devices for all three modes by tests/test_kstream_sharded.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from .. import dna
from ..metrics import GLOBAL as METRICS
from ..ops.encode import window_keys_bits
from ..ops.intersect import SENTINEL, _run_heads, _seg_last, dedup_sorted
from ..ops.sort import lsd_sort
from .distributed import _halo_exchange, _owner_of


@lru_cache(maxsize=None)
def _kstream_step(mesh: Mesh, k: int, mode: str, bits: int,
                  omit_soft: bool, chunk: int, exch_cap: int):
    """Jitted per-mesh program: uint8[n*chunk] -> per-shard owned sorted
    unique tables (words, counts, n_unique) + psum'd overflow flag."""
    axis = mesh.axis_names[0]
    n_shards = mesh.devices.size
    code_table = dna.CODE2_TABLE
    comp_table = dna.COMP2_TABLE
    valid_table = dna.base_validity_table(bits, disallow="Nn",
                                          omit_soft=omit_soft)
    t_owner = min(10, k * bits, 32)

    def per_shard(buf):
        from ..kstream_device import mode_keys
        block = _halo_exchange(buf, k - 1, axis)
        ok, words = window_keys_bits(block, code_table, valid_table,
                                     comp_table, k, 0, 0, bits, 1)
        # halo windows give context only; their starts belong to the next
        # shard (same convention as the segmented single-chip path)
        use, okk = mode_keys(ok, words, mode, start_limit=chunk)
        sorted_w, _ = lsd_sort(use)
        words_u, cnt = dedup_sorted(sorted_w, jnp.sum(okk.astype(jnp.int32)))
        words_c, (cnt_c,) = lsd_sort(words_u, [cnt])

        # ---- key-range exchange: every unique row to its owner shard ----
        m = cnt_c.shape[0]
        valid = cnt_c > 0
        bucket = _owner_of(words_c[0], valid, n_shards, t_owner)
        count_d = jnp.stack([jnp.sum((bucket == d).astype(jnp.int32))
                             for d in range(n_shards)])
        start_d = jnp.concatenate(
            [jnp.zeros(1, jnp.int32),
             jnp.cumsum(count_d)[:-1].astype(jnp.int32)])
        cap = exch_cap
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

        r_words = [exchange(send_matrix(w, SENTINEL))
                   .reshape(n_shards * cap) for w in words_c]
        r_cnts = exchange(send_matrix(cnt_c, jnp.uint32(0))) \
            .reshape(n_shards * cap)

        # owner-local: sort by key so equal keys from different source
        # shards are adjacent (valid keys always sort before sentinel
        # rows — the KeyLayout id field is all-ones only in sentinels),
        # then merge their counts: csum diffs between run tails,
        # wrap-safe in uint32
        l_words, (l_cnts,) = lsd_sort(r_words, [r_cnts])
        ok_row = l_cnts > 0
        head = _run_heads(l_words) & ok_row
        tail = jnp.concatenate([head[1:], jnp.ones(1, bool)])
        csum = jnp.cumsum(l_cnts, dtype=jnp.uint32)
        tail_csum = _seg_last(csum, tail)
        run_total = tail_csum - (csum - l_cnts)    # value at head rows
        merged_cnt = jnp.where(head, run_total, jnp.uint32(0))
        m_words = [jnp.where(head, w, SENTINEL) for w in l_words]
        f_words, (f_cnts,) = lsd_sort(m_words, [merged_cnt])
        n_unique = jnp.sum(head.astype(jnp.int32))
        return (jnp.stack(f_words), f_cnts, n_unique[None],
                jax.lax.psum(overflow, axis))

    fn = shard_map(per_shard, mesh=mesh, in_specs=(P(axis),),
                   out_specs=(P(None, axis), P(axis), P(axis), P()),
                   check_vma=False)
    return jax.jit(fn)


def sharded_kstream_table(mesh: Mesh, buf: np.ndarray, k: int, mode: str,
                          omit_soft: bool, bits: int = 2):
    """Run the sharded kstream program over ``buf`` (uint8 genome bytes).

    Returns (words u32[W, rows], counts int64[rows]) — the globally
    sorted unique k-mer table, already concatenated in mesh (= key) order
    — or None when the input is too short to shard (a chunk must cover
    the (k-1)-base halo its left neighbor borrows; callers fall back to
    their single-device path).  Exchange overflow auto-retries with a
    doubled capacity, like the distributed intersection."""
    from ..io.fasta import bucket_size

    n = mesh.devices.size
    if int(buf.size) // k < n:
        return None
    # bucket the chunk so nearby input sizes reuse one compiled program
    # (chunk is a static shape; finer quantum than the single-device
    # bucket_size since padding is paid once per shard)
    chunk = bucket_size(-(-int(buf.size) // n), quantum=1 << 12)
    padded = np.zeros(n * chunk, np.uint8)
    padded[:buf.size] = buf

    # initial per-destination capacity: uniform share + headroom, rounded
    # to a power of two (also a static shape)
    per_shard_rows = chunk * (2 if mode == "complements" else 1)
    cap = 64
    while cap < 2 * (per_shard_rows // n) + 64:
        cap *= 2
    while True:
        step = _kstream_step(mesh, k, mode, bits, omit_soft, chunk, cap)
        words_d, cnts_d, n_uni_d, overflow_d = step(padded)
        if int(overflow_d) == 0:
            break
        METRICS.count("exchange_retry")
        cap *= 2

    n_uni = np.asarray(n_uni_d)          # (n,) unique rows per shard
    words_h = np.asarray(words_d)        # (W, n * rows)
    cnts_h = np.asarray(cnts_d)
    rows = words_h.shape[1] // n
    parts_w, parts_c = [], []
    for d in range(n):
        u = int(n_uni[d])
        parts_w.append(words_h[:, d * rows:d * rows + u])
        parts_c.append(cnts_h[d * rows:d * rows + u])
    return (np.concatenate(parts_w, axis=1),
            np.concatenate(parts_c).astype(np.int64))
