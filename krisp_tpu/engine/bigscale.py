"""Range-partitioned global intersection for GB-scale inputs.

The fused single-device program and the one-shot checkpoint path both
materialize the WHOLE multi-genome key table on device for one global
sort.  At GB scale (5 x 100 Mb genomes = ~1G window keys) that table plus
the sort's operand traffic exceeds HBM.  This module runs the identical
global stage in bounded passes instead:

  - per-genome tables arrive as sorted sub-runs (one per extraction
    chunk, engine/pipeline._genome_table_chunked), so any key range can
    be sliced out of every sub-run with two binary searches — no host
    sort, no shuffle;
  - ranges are chosen on the leading bits of the FLANK field (a
    histogram pass balances rows per range), so a flank group never
    straddles a range and per-range survivor marking is exact — the same
    ownership argument as the distributed path's key ranges
    (parallel/distributed.py);
  - each range runs the stock ``global_intersect_bits`` program (sort +
    weighted survivor marking + capped compaction); every range pads to
    one common size, so all passes share a single compiled program;
  - survivors concatenate in range order == global key order, with group
    ids offset per range, making the result bit-identical to the
    single-pass stage (tests/test_bigscale.py).

This is the sequential-on-one-device analog of sharding: the reference
gets the same effect from external-memory GNU sort chunks
(/root/reference/src/krisp/kstream/kstream.py:45-119) and byte-range file
sharding (shared.py:133-207).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io.fasta import bucket_size
from ..metrics import GLOBAL as METRICS
from ..ops.intersect import global_intersect_bits


#: share of the device's allocatable memory one global pass plans on
GLOBAL_BUDGET_FRACTION = 0.25


def row_budget_for(layout) -> int:
    """Rows per global-stage pass.  KRISP_TPU_GLOBAL_ROWS pins it
    directly; otherwise a device-memory budget (KRISP_TPU_GLOBAL_BYTES, else
    a share of the device's memory limit, 2 GiB where the backend reports
    none) divided by the per-row device footprint (key words + carried
    count)."""
    from ..runtime import device_budget

    rows = int(os.environ.get("KRISP_TPU_GLOBAL_ROWS", 0))
    if rows > 0:
        return rows
    budget = device_budget("KRISP_TPU_GLOBAL_BYTES", GLOBAL_BUDGET_FRACTION,
                           2 << 30)
    return max(budget // (4 * (layout.n_words + 1)), 1 << 16)


def _prefix_ranges(parts, shift, n_buckets, row_budget):
    """Greedy prefix-bucket ranges of at most ``row_budget`` rows (a
    single over-full bucket becomes its own range — it cannot split at
    this prefix width).  Returns list of (lo, hi) bucket intervals."""
    hist = np.zeros(n_buckets, np.int64)
    for words, _counts, offsets in parts:
        hist += np.bincount(words[0] >> shift, minlength=n_buckets)
    ranges = []
    lo = 0
    acc = 0
    for b in range(n_buckets):
        if acc and acc + hist[b] > row_budget:
            ranges.append((lo, b))
            lo, acc = b, 0
        acc += int(hist[b])
    ranges.append((lo, n_buckets))
    return ranges


def _range_bounds(parts, shift, blo, bhi):
    """Per-sub-run row intervals whose flank prefix falls in [blo, bhi):
    two binary searches per sub-run, no data movement."""
    vlo = np.uint32(blo << shift)
    bounds = []
    for words, _counts, offsets in parts:
        w0 = words[0]
        per_part = []
        for s, e in zip(offsets[:-1], offsets[1:]):
            seg = w0[s:e]
            a = s + np.searchsorted(seg, vlo, side="left")
            if bhi << shift > 0xFFFFFFFF:
                b = e
            else:
                b = s + np.searchsorted(seg, np.uint32(bhi << shift),
                                        side="left")
            per_part.append((int(a), int(b)))
        bounds.append(per_part)
    return bounds


def _slice_range(parts, bounds):
    """Materialize the rows selected by ``_range_bounds`` (lazy: called
    one range at a time so peak host memory stays one range, not the
    whole table twice)."""
    out_w, out_c = [], []
    for (words, counts, _offsets), per_part in zip(parts, bounds):
        for a, b in per_part:
            if b > a:
                out_w.append(words[:, a:b])
                out_c.append(counts[a:b])
    if not out_w:
        return None, None
    return np.concatenate(out_w, axis=1), np.concatenate(out_c)


def partitioned_global_intersect(parts, layout, n_files: int,
                                 cap: int = 1 << 16,
                                 row_budget: int | None = None,
                                 stats: dict | None = None):
    """Global stage over per-genome sorted sub-run tables, in bounded
    passes.

    parts: list of (words uint32[W, n], counts uint32[n], offsets
    int64[k+1]) — KeyLayout rows with the genome id OR'd in, no sentinel
    rows, sorted within each offsets-delimited sub-run.

    Returns (words [n_keep, W], counts [n_keep], group_id [n_keep]) in
    global key order — bit-identical to the single-pass stage.
    """
    if row_budget is None:
        row_budget = row_budget_for(layout)
    total = sum(p[0].shape[1] for p in parts)
    if total == 0:
        W = layout.n_words
        return (np.zeros((0, W), np.uint32), np.zeros(0, np.uint32),
                np.zeros(0, np.int64))

    B = min(16, layout.flank_bits)
    shift = 32 - B
    if total <= row_budget:
        ranges = [(0, 1 << B)]
    else:
        ranges = _prefix_ranges(parts, shift, 1 << B, row_budget)
    if stats is not None:
        stats["global_rows"] = total
        stats["global_passes"] = len(ranges)
        stats["row_budget"] = row_budget

    # one padded size for every pass -> one compiled program; bounds are
    # binary searches only, so sizing is free and slices stay lazy
    all_bounds = [_range_bounds(parts, shift, blo, bhi)
                  for blo, bhi in ranges]
    sizes = [sum(b - a for per_part in bounds for a, b in per_part)
             for bounds in all_bounds]
    pad = bucket_size(max(max(sizes), 1))

    out_w, out_c, out_g = [], [], []
    gid_base = 0
    progress = os.environ.get("KRISP_TPU_PROGRESS") == "1"
    for pass_no, bounds in enumerate(all_bounds):
        if progress:
            print(f"[bigscale] global pass {pass_no + 1}/{len(all_bounds)}",
                  file=sys.stderr, flush=True)
        w, c = _slice_range(parts, bounds)
        if w is None:
            continue
        n = w.shape[1]
        W = w.shape[0]
        w_pad = np.full((W, pad), 0xFFFFFFFF, np.uint32)
        w_pad[:, :n] = w
        c_pad = np.zeros(pad, np.uint32)
        c_pad[:n] = c
        while True:
            with METRICS.stage("global_pass", items=n):
                words_d, cnt_d, gid_d, n_keep = global_intersect_bits(
                    tuple(w_pad), c_pad, layout, n_files=n_files, cap=cap)
                n_keep = int(n_keep)
            if n_keep <= cap:
                break
            cap = bucket_size(n_keep, quantum=1 << 16)
        if n_keep:
            out_w.append(np.asarray(words_d)[:, :n_keep].T)
            out_c.append(np.asarray(cnt_d)[:n_keep])
            gids = np.asarray(gid_d)[:n_keep].astype(np.int64)
            out_g.append(gids + gid_base)
            gid_base += int(gids.max()) + 1

    W = layout.n_words
    if not out_w:
        return (np.zeros((0, W), np.uint32), np.zeros(0, np.uint32),
                np.zeros(0, np.int64))
    return (np.concatenate(out_w, axis=0), np.concatenate(out_c),
            np.concatenate(out_g))
