"""Device multi-way intersection — fully gather/scatter-free.

The reference computes the intersection of F sorted k-mer tables by a
tournament of pairwise 2-way sorted merges across worker processes
(/root/reference/src/krisp/krisp_fasta/intersectAmplicons.py:232-310, with
the merge kernel in shared.py:285-347).  The design keeps to the
primitives an accelerator runs at memory speed (single-key sorts, 1-D
scans, elementwise fusions) and away from data-scale random gathers,
scatters and multi-key comparator sorts:

  - multi-word keys sort via LSD passes of the fast single-key sort
    (ops/sort.py:lsd_sort)
  - ONE key layout everywhere (encode.KeyLayout): flank, genome id, and
    mid are bit-packed into a single multi-word integer key, so every sort
    uses only key words as operands (the genome-id field doubles as the
    validity marker).  The fused, sharded, and checkpoint paths all emit
    the same row encoding and share one decode epilogue.
  - per-genome duplicate collapse marks non-head rows with sentinel keys
    instead of compacting (no nonzero/gather); the global sort sweeps all
    sentinels to the tail
  - the survivor test (flank group contains rows from all F genomes) is
    computed with adjacent-row flags + 1-D cumsum + two monotone run
    broadcasts (cummax forward, cummin backward) — zero gathers
  - survivors compact through a small capped nonzero+take (KBs, not GBs)

Deterministic by construction: result order is a pure function of key
order, never of scheduling (the property whose absence forced the reference
to disable its parallel merge, intersectAmplicons.py:216-218).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .sort import lsd_sort, sort_with_rowid

SENTINEL = jnp.uint32(0xFFFFFFFF)
BIG_I32 = jnp.int32(2**31 - 1)


def _run_heads(words):
    neq = jnp.zeros(words[0].shape[0] - 1, bool)
    for w in words:
        neq = neq | (w[1:] != w[:-1])
    return jnp.concatenate([jnp.ones(1, bool), neq])


def _reverse_cummin(x):
    return jax.lax.cummin(x[::-1])[::-1]


def _seg_last(values, last_flag):
    """For every row, the ``values`` entry at the LAST row of its run
    (runs delimited by ``last_flag`` marking tail rows; the final row
    must be a tail).

    One reverse cummin over row INDICES — monotone by construction, so
    ``values`` itself carries no monotonicity requirement (it may be a
    wrapping uint32 prefix sum, see ``survivor_mark_bits``) — plus a
    single take: built-in scans only, no custom associative_scan."""
    n = values.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    tail_idx = _reverse_cummin(jnp.where(last_flag, idx, n - 1))
    return jnp.take(values, tail_idx)


def dedup_sorted(words, n_valid):
    """Collapse duplicate rows of a sorted table without compaction.

    Returns (words_out, counts): head rows keep their key words and get the
    run length as count; duplicate and invalid rows become sentinel rows
    with count 0.  ``n_valid`` = number of non-sentinel rows (they sort to
    the front).  Semantics of the reference's ``simplifyStream``
    (shared.py:210-240): adjacent equal rows merge, multiplicities add.
    """
    n = words[0].shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < n_valid
    head = _run_heads(words) & valid
    rh = jnp.where(head, idx, n)
    nxt = _reverse_cummin(jnp.concatenate([rh[1:], jnp.full(1, n, jnp.int32)]))
    cnt = jnp.where(head, jnp.minimum(nxt, n_valid) - idx, 0)
    words_out = [jnp.where(head, w, SENTINEL) for w in words]
    return words_out, cnt.astype(jnp.uint32)


def compact_rows(arrays, keep, cap: int):
    """Gather ``cap`` surviving rows (tiny) + true survivor count.

    A flat ``nonzero`` over the full table lowers to cumsum + a full-size
    scatter.  Survivors are sparse (bounded by ``cap``), so compact in two
    levels instead: find the blocks that contain any survivor (nonzero at
    n/128 scale — every nonempty block holds >= 1 survivor, so ``cap``
    blocks suffice), gather just those blocks of the ``keep`` mask, and run
    the exact flat compaction on that (cap * 128)-row subset.  Indices map
    back through the block ids, so the output — ascending survivor indices,
    ``n - 1`` in slots past ``n_keep`` — is element-identical to the flat
    version at a tiny fraction of the memory traffic.
    """
    n = keep.shape[0]
    n_keep = jnp.sum(keep.astype(jnp.int32))
    B = 128
    nb = -(-n // B)
    if cap >= nb:
        # blocks would not reduce the problem (large-cap callers, e.g. the
        # prefilter's first stage): flat compaction costs the same and
        # skips the copies
        idx = jnp.nonzero(keep, size=cap, fill_value=n - 1)[0]
        return [jnp.take(a, idx, axis=-1) for a in arrays], n_keep
    if nb * B != n:
        keep = jnp.concatenate(
            [keep, jnp.zeros(nb * B - n, keep.dtype)])
    blk = keep.reshape(nb, B)
    capb = min(cap, nb)
    blk_any = jnp.any(blk, axis=1)
    k_b = jnp.sum(blk_any.astype(jnp.int32))
    bidx = jnp.nonzero(blk_any, size=capb, fill_value=0)[0]
    sub = jnp.take(blk, bidx, axis=0)
    sub = sub & (jnp.arange(capb, dtype=jnp.int32)[:, None] < k_b)
    idx2 = jnp.nonzero(sub.reshape(capb * B), size=cap, fill_value=0)[0]
    gidx = jnp.take(bidx, idx2 // B) * B + (idx2 % B)
    slot = jnp.arange(cap, dtype=jnp.int32)
    idx = jnp.where(slot < n_keep, gidx, n - 1)
    return [jnp.take(a, idx, axis=-1) for a in arrays], n_keep


@partial(jax.jit, static_argnames=("layout", "n_files", "cap"))
def global_intersect_bits(words, counts, layout, n_files: int, cap: int):
    """Global stage over concatenated per-genome KeyLayout tables (the
    checkpoint/out-of-core path): one LSD sort of the packed keys carrying
    the pre-collapsed counts, weighted survivor marking, capped compaction.

    words: uint32[W, n] packed [flank | genome-id | mid] keys (genome id
    already OR'd in; sentinel rows all-ones); counts: uint32[n] with 0 on
    sentinel rows.  Returns (words [W, cap], counts[cap], group_id[cap],
    n_keep) — the same row encoding as ``fused_pipeline_bits``, so the
    decode epilogue is shared.  Replaces the former split-[flank|mid]
    layout global stage (one key layout for every path)."""
    keys_sorted, payloads = lsd_sort(list(words), [counts])
    cnt_s = payloads[0]
    keep, counts_out, group_id = survivor_mark_bits(keys_sorted, layout,
                                                    n_files, weights=cnt_s)
    (words_c, cnt_c, gid_c), n_keep = compact_rows(
        [jnp.stack(keys_sorted), counts_out, group_id], keep, cap)
    return words_c, cnt_c, gid_c, n_keep


def _masked_head(words, n_bits: int):
    """Head flags for runs equal in the leading ``n_bits`` of the packed
    key (word-wise compares + one masked boundary word)."""
    full_words = n_bits // 32
    rem = n_bits % 32
    n = words[0].shape[0]
    neq = jnp.zeros(n - 1, bool)
    for w in range(full_words):
        neq = neq | (words[w][1:] != words[w][:-1])
    if rem:
        mask = jnp.uint32(((1 << rem) - 1) << (32 - rem))
        bw = words[full_words] & mask
        neq = neq | (bw[1:] != bw[:-1])
    return jnp.concatenate([jnp.ones(1, bool), neq])


def survivor_mark_bits(keys_sorted, layout, n_files: int, weights=None):
    """Survivor marking over a sorted bit-packed-key table (KeyLayout).

    Returns (keep, counts, group_id): ``keep`` flags the head row of each
    distinct (flank, file, mid) key whose flank group spans all ``n_files``
    genomes; ``counts`` holds the duplicate multiplicity at head rows;
    ``group_id`` numbers flank runs.  Pure function of the sorted key
    order, so it is identical whether the table is the whole problem
    (fused single-chip path) or one shard's owned key range (the
    distributed path — key-range ownership by flank prefix guarantees
    every flank run is complete within its shard).

    Replaces the reference's 2-way merge survivor logic
    (/root/reference/src/krisp/krisp_fasta/shared.py:285-347) with three
    1-D scans over the globally sorted table.
    """
    n = keys_sorted[0].shape[0]
    fw, fsh = layout.file_word_shift()

    # run boundaries at three granularities of the same sorted table
    head_full = _run_heads(keys_sorted)                       # full key
    head_ff = _masked_head(keys_sorted,
                           layout.file_off + layout.file_bits)  # flank+file
    head_flank = _masked_head(keys_sorted, layout.flank_bits)  # flank group

    file_field = ((keys_sorted[fw] >> jnp.uint32(fsh))
                  & jnp.uint32(layout.file_sentinel))
    valid = file_field != layout.file_sentinel

    # duplicate multiplicities: run length of full-key runs, or (when rows
    # carry pre-collapsed ``weights``, e.g. the checkpoint path's chunked
    # tables) the gather-free segment sum of weights over each run
    idx = jnp.arange(n, dtype=jnp.int32)
    if weights is None:
        rh = jnp.where(head_full, idx, n)
        nxt = _reverse_cummin(jnp.concatenate([rh[1:],
                                               jnp.full(1, n, jnp.int32)]))
        counts = jnp.where(head_full & valid, nxt - idx, 0).astype(jnp.uint32)
    else:
        # Pre-collapsed weights (the checkpoint/out-of-core path): the
        # running sum over a multi-genome table can exceed 2^31 even when
        # the table itself fits on device (weights are duplicate counts),
        # so compute the prefix sum in wrapping uint32 and propagate each
        # run tail's value backwards with a segmented scan — ``_seg_last``
        # tolerates wrapped (non-monotone) sums, and the per-run modular
        # difference end_s - (s - w) is exact for any run multiplicity
        # that fits the uint32 counts output.
        w32 = weights.astype(jnp.uint32)
        s = jnp.cumsum(w32)
        last_full = jnp.concatenate([head_full[1:], jnp.ones(1, bool)])
        end_s = _seg_last(s, last_full)
        counts = jnp.where(head_full & valid, end_s - (s - w32),
                           jnp.uint32(0)).astype(jnp.uint32)

    # survivor test: distinct genomes per flank group == n_files
    x = (head_ff & valid).astype(jnp.int32)
    c = jnp.cumsum(x)
    base = jax.lax.cummax(jnp.where(head_flank, c - x, -1))
    is_last = jnp.concatenate([head_flank[1:], jnp.ones(1, bool)])
    endc = _reverse_cummin(jnp.where(is_last, c, BIG_I32))
    survive = ((endc - base) == n_files) & valid
    group_id = jnp.cumsum(head_flank.astype(jnp.int32)) - 1

    return survive & head_full, counts, group_id


def unpack_genomes(packed, vbits):
    """Device-side inverse of engine.pipeline._pack_genomes_host: 2-bit
    codes + validity bitmap -> canonical ASCII buffers (A/C/G/T for valid
    bases, N for invalid).  The reconstructed buffer has identical
    (code, validity) per base, so every downstream kernel behaves exactly
    as on the raw bytes — but the host->device transfer is 3.75 bits/base
    instead of 8.

    The code -> ASCII map is computed with compares and selects, not a
    4-entry table gather, so it fuses into the unpacking loop."""
    F, nw = packed.shape
    k = jnp.arange(16, dtype=jnp.uint32) * 2
    codes = ((packed[:, :, None] >> k) & jnp.uint32(3)) \
        .astype(jnp.uint8).reshape(F, nw * 16)
    b = jnp.arange(8, dtype=jnp.uint8)
    valid = (((vbits[:, :, None] >> b) & jnp.uint8(1)) == 1) \
        .reshape(F, vbits.shape[1] * 8)
    # A=65 C=67 G=71 T=84: 65 + 2*code, with +2 at code>=2 and +11 at code 3
    ascii_ = (jnp.uint8(65) + (codes << 1)
              + jnp.where(codes >= 2, jnp.uint8(2), jnp.uint8(0))
              + jnp.where(codes == 3, jnp.uint8(11), jnp.uint8(0)))
    return jnp.where(valid, ascii_, jnp.uint8(ord("N")))


def _all_window_keys(buffers, code_table, valid_table, comp_table,
                     left: int, mid: int, right: int, bits: int,
                     n_files: int, omit_soft: bool):
    """Window keys for every genome/strand as sentinel-marked KeyLayout
    words: uint32 list [W] of arrays [F * 2 * n_win] (genome id OR'd in).
    Shared by the fused pipeline and the prefix-prefilter pipeline."""
    from .encode import window_keys_bits, window_keys_tree, KeyLayout

    F, P = buffers.shape
    layout = KeyLayout(left, mid, right, bits, n_files)
    fword, fshift = layout.file_word_shift()

    def per_file(buf, file_idx):
        if bits == 2:
            # log-tree packing: ~5x fewer vector passes than the per-base
            # formulation (bit-identical; tests/test_encode.py)
            ok, words = window_keys_tree(buf, code_table, valid_table,
                                         comp_table, left, mid, right,
                                         n_files)
        else:
            ok, words = window_keys_bits(buf, code_table, valid_table,
                                         comp_table, left, mid, right, bits,
                                         n_files)
        words[fword] = words[fword] | (file_idx << jnp.uint32(fshift))
        return ok, jnp.stack(words)

    with jax.named_scope("window_keys"):
        ok, words = jax.vmap(per_file)(buffers,
                                       jnp.arange(F, dtype=jnp.uint32))
    n_per = ok.shape[1]
    n = F * n_per
    W = layout.n_words
    okf = ok.reshape(n)
    flat = [jnp.where(okf, w, SENTINEL)
            for w in jnp.transpose(words, (1, 0, 2)).reshape(W, n)]
    return flat, layout


@partial(jax.jit, static_argnames=("left", "mid", "right", "bits",
                                   "n_files", "cap_pre", "cap", "omit_soft"))
def fused_pipeline_prefilter(buffers, code_table, valid_table, comp_table,
                             left: int, mid: int, right: int, bits: int,
                             n_files: int, cap_pre: int, cap: int,
                             omit_soft: bool = False):
    """Wide-key (amplicon-class) pipeline with a one-word prefix prefilter.

    A W-word LSD sort carries W-1 operand words per pass — O(W^2)
    traffic for L=100 amplicon keys.  Instead, sort ONE word first: the leading 32-fb flank bits with the
    genome id packed into the low fb bits, carrying only the row id.
    Prefix-level survivor marking (flank-prefix group spans all files) is
    a strict superset of the true survivor set, and any flank group inside
    a surviving prefix group is retained whole — so gathering the
    surviving rows and running the EXACT full-width stage on that (tiny)
    subset reproduces ``fused_pipeline_bits``'s output bit for bit
    (tests/test_prefilter.py).  Degenerate inputs grow ``cap_pre`` toward
    the direct path's cost, never past it.

    Returns the packed single-array format of ``fused_pipeline_packed``
    with n_keep at [-1, 0] and the prefilter survivor count at [-1, 1]
    (caller retries with a larger ``cap_pre``/``cap`` on overflow).
    """
    flat, layout = _all_window_keys(buffers, code_table, valid_table,
                                    comp_table, left, mid, right, bits,
                                    n_files, omit_soft)
    return _prefilter_tail(flat, layout, n_files, cap_pre, cap)


def _prefilter_tail(flat, layout, n_files: int, cap_pre: int, cap: int):
    """Prefix prefilter + exact full-width stage over sentinel-marked
    KeyLayout words (shared by the one-shot and per-genome-pipelined
    entries)."""
    fwd_, fsh = layout.file_word_shift()
    fb = layout.file_bits
    sentinel_f = jnp.uint32(layout.file_sentinel)
    prefix_bits = 32 - fb

    with jax.named_scope("prefilter_sort"):
        field = (flat[fwd_] >> jnp.uint32(fsh)) & sentinel_f
        pk = (flat[0] & jnp.uint32((0xFFFFFFFF >> fb) << fb)) | field
        # (prefix key, row id) packed into one u64: a single carry-free
        # sort pass replaces the key+payload carrying pass
        pk_s, iota_s = sort_with_rowid(pk)

    with jax.named_scope("prefilter_scan"):
        head_pre = _masked_head([pk_s], prefix_bits)
        head_pf = _run_heads([pk_s])
        valid = (pk_s & sentinel_f) != sentinel_f
        x = (head_pf & valid).astype(jnp.int32)
        c = jnp.cumsum(x)
        base = jax.lax.cummax(jnp.where(head_pre, c - x, -1))
        is_last = jnp.concatenate([head_pre[1:], jnp.ones(1, bool)])
        endc = _reverse_cummin(jnp.where(is_last, c, BIG_I32))
        survive = ((endc - base) == n_files) & valid

        (kept,), n_pre = compact_rows([iota_s], survive, cap_pre)
        j = jnp.arange(cap_pre)
        sub = [jnp.where(j < n_pre, jnp.take(w, kept), SENTINEL)
               for w in flat]

    # exact full-width stage on the surviving subset
    words_c, cnt_c, gid_c, n_keep = _global_tail(sub, layout, n_files, cap)
    tail = (jnp.zeros((1, cap), jnp.uint32)
            .at[0, 0].set(n_keep.astype(jnp.uint32))
            .at[0, 1].set(n_pre.astype(jnp.uint32)))
    return jnp.concatenate([words_c, cnt_c[None].astype(jnp.uint32),
                            gid_c[None].astype(jnp.uint32), tail], axis=0)


@partial(jax.jit, static_argnames=("left", "mid", "right", "bits",
                                   "n_files", "cap_pre", "cap"))
def fused_prefilter_global(keys, left: int, mid: int, right: int, bits: int,
                           n_files: int, cap_pre: int, cap: int):
    """Prefilter global stage over per-genome ``extract_keys_packed_in``
    outputs (the wide-key analog of ``fused_global_packed``): host
    pack/upload of genome f+1 overlaps device extraction of genome f, and
    cap retries re-run only this stage with the key tables resident."""
    from .encode import KeyLayout

    layout = KeyLayout(left, mid, right, bits, n_files)
    W = keys[0].shape[0]
    flat = [jnp.concatenate([k[w] for k in keys]) for w in range(W)]
    return _prefilter_tail(flat, layout, n_files, cap_pre, cap)


@partial(jax.jit, static_argnames=("left", "mid", "right", "bits", "cap",
                                   "n_files", "omit_soft"))
def fused_pipeline_packed(buffers, code_table, valid_table, comp_table,
                          left: int, mid: int, right: int, bits: int,
                          n_files: int, cap: int, omit_soft: bool = False):
    """fused_pipeline_bits with all outputs packed into ONE uint32 array
    [W+3, cap]: rows 0..W-1 = key words, W = counts, W+1 = group ids,
    W+2[0] = n_keep.  One device->host transfer instead of four."""
    w, c, g, nk = fused_pipeline_bits(
        buffers, code_table, valid_table, comp_table, left=left, mid=mid,
        right=right, bits=bits, n_files=n_files, cap=cap,
        omit_soft=omit_soft)
    tail = jnp.zeros((1, cap), jnp.uint32).at[0, 0].set(nk.astype(jnp.uint32))
    return jnp.concatenate([w, c[None].astype(jnp.uint32),
                            g[None].astype(jnp.uint32), tail], axis=0)


@partial(jax.jit, static_argnames=("left", "mid", "right", "bits", "cap",
                                   "n_files", "omit_soft"))
def fused_pipeline_bits(buffers, code_table, valid_table, comp_table,
                        left: int, mid: int, right: int, bits: int,
                        n_files: int, cap: int, omit_soft: bool = False):
    """Whole krisp_fasta compute path as ONE device program over minimal
    bit-packed keys.

    buffers: uint8[F, P] sentinel-separated genome buffers.  Window keys
    carry flank, genome id, and mid in one packed integer (KeyLayout), so
    the single global LSD sort uses ONLY key words as operands — the
    minimum possible sort traffic.  Duplicate multiplicities fall out of
    run lengths; the survivor test is three 1-D scans; compaction returns
    ``cap`` rows.
    """
    flat, layout = _all_window_keys(buffers, code_table, valid_table,
                                    comp_table, left, mid, right, bits,
                                    n_files, omit_soft)
    return _global_tail(flat, layout, n_files, cap)


def _global_tail(flat, layout, n_files: int, cap: int):
    """Global sort -> survivor marking -> capped compaction over
    sentinel-marked KeyLayout words (the tail shared by the one-shot fused
    program, the pipelined per-genome path and the prefilter's exact
    stage).  Each stage runs under its own ``jax.named_scope`` so a
    profiler trace attributes device time to it."""
    with jax.named_scope("global_sort"):
        keys_sorted, _ = lsd_sort(flat)
    with jax.named_scope("survivor_scan"):
        keep, counts, group_id = survivor_mark_bits(keys_sorted, layout,
                                                    n_files)
    with jax.named_scope("compaction"):
        (words_c, cnt_c, gid_c), n_keep = compact_rows(
            [jnp.stack(keys_sorted), counts, group_id], keep, cap)
    return words_c, cnt_c, gid_c, n_keep


@partial(jax.jit, static_argnames=("left", "mid", "right", "bits",
                                   "n_files"))
def extract_keys_packed_in(packed_row, vbits_row, code_table, valid_table,
                           comp_table, file_idx, left: int, mid: int,
                           right: int, bits: int, n_files: int):
    """Sentinel-marked KeyLayout words for ONE genome (both strands), with
    the genome-id field OR'd in (``file_idx`` is traced, so every genome
    shares one compiled program).

    The per-genome half of the pipelined fused path: dispatching one of
    these per genome lets the host pack + upload genome f+1 while the
    device extracts genome f.  ``fused_global_packed`` consumes the
    per-genome outputs.

    packed_row/vbits_row: uint32[1, nw] / uint8[1, nv] (one genome of
    engine.pipeline._pack_genomes_host).  Returns uint32[W, 2 * n_win].
    """
    buffers = unpack_genomes(packed_row, vbits_row)
    flat, layout = _all_window_keys(buffers, code_table, valid_table,
                                    comp_table, left, mid, right, bits,
                                    n_files, False)
    fw, fsh = layout.file_word_shift()
    # sentinel rows are all-ones: OR-ing the id in leaves them sentinel
    flat[fw] = flat[fw] | (file_idx.astype(jnp.uint32) << jnp.uint32(fsh))
    return jnp.stack(flat)


@partial(jax.jit, static_argnames=("left", "mid", "right", "bits",
                                   "n_files", "cap"))
def fused_global_packed(keys, left: int, mid: int, right: int, bits: int,
                        n_files: int, cap: int):
    """Global stage over per-genome ``extract_keys_packed_in`` outputs:
    concatenate, sort, survivor-mark, compact — packed into the single
    [W+3, cap] output array of ``fused_pipeline_packed`` (same row
    encoding, one pull).  On compaction overflow the caller re-runs only
    this stage; the per-genome key tables stay resident on device."""
    from .encode import KeyLayout

    layout = KeyLayout(left, mid, right, bits, n_files)
    W = keys[0].shape[0]
    flat = [jnp.concatenate([k[w] for k in keys]) for w in range(W)]
    w, c, g, nk = _global_tail(flat, layout, n_files, cap)
    tail = jnp.zeros((1, cap), jnp.uint32).at[0, 0].set(nk.astype(jnp.uint32))
    return jnp.concatenate([w, c[None].astype(jnp.uint32),
                            g[None].astype(jnp.uint32), tail], axis=0)
