"""Vectorized krisp_vcf scan: device classification + bulk window prefilter.

The reference scans one window at a time through a Python cascade
(/root/reference/src/krisp/krisp_vcf/krisp_vcf.py:680-916) over per-variant
Python dict classification (find_diag_var.py:203-411).  The accelerator-
shaped redesign (SURVEY §7.2.6):

  1. the whole chunk arrives as columnar arrays (native C++ tokenizer,
     csrc/vcfio.cpp) — no per-record Python objects;
  2. classification runs as one batched device kernel over
     [variants x samples x alleles] (ops/vcfclass.py);
  3. the sliding window's composition is replayed exactly with a
     two-pointer over position/indel-delta arrays, and cascade steps 1-3
     (diagnostic count, all-conserved, misplaced) become prefix-sum
     lookups — O(1) per window, typed EXACTLY (the stats counters match
     the host path's, not just the survivor set);
  4. only the rare candidates that pass steps 1-3 materialize window
     objects (device-classified variants with on-demand exact rehydration)
     and run the shared host cascade tail (scan.cascade_tail): conserved
     borders, crRNA edit distance, primer design.

Byte parity with the host engine is pinned by tests/test_fastscan.py and
the golden engine-mode comparison; throughput is measured by
tools/bench_vcf.py.
"""

from __future__ import annotations

import numpy as np

from .classify import ClassifiedVariant
from .device_classify import DeviceClassifiedVariant
from .parser import VcfVariant, SampleData
from .region import VariantWindow
from .scan import cascade_from_ranges, cascade_finish, PendingDesign
from ..thermo.design import run_primer3_batch

# flyweight rejected-window markers: the report layer only reads .type
_TYPE_NAMES = {1: "Undiagnostic", 2: "Unconserved", 3: "Misplaced"}


class _Rejected:
    __slots__ = ("type",)

    def __init__(self, t):
        self.type = t


_REJ = {code: _Rejected(name) for code, name in _TYPE_NAMES.items()}
_REJ_UNCONSERVED = _Rejected("Unconserved")


def _build_samples(col, v):
    alleles = col.alleles[v]
    n_all = len(alleles)
    A = col.ad.shape[2]
    samples = {}
    dp_row, gq_row, ad_row = col.dp[v], col.gq[v], col.ad[v]
    for si, name in enumerate(col.samples):
        dp = int(dp_row[si])
        gq = int(gq_row[si])
        ad = tuple(int(x) for x in ad_row[si, :min(n_all, A)])
        if n_all > A:
            ad = ad + (0,) * (n_all - A)
        samples[name] = SampleData(dp=None if dp < 0 else dp,
                                   gq=None if gq < 0 else gq, ad=ad)
    return samples


class _LazyVariant:
    """parser.VcfVariant work-alike over columnar arrays.

    Everything except the window-geometry field (``pos``) materializes on
    first access: candidate-context variants are touched only by the
    position walks (sequence()/consv_border_n), and the per-sample dict
    (the O(samples) part) only by survivors (exact rehydration /
    missing_samp_ids) — so the ~300 context variants per candidate stay
    O(1) to construct."""

    __slots__ = ("_col", "_row", "pos", "id", "_samples", "_alleles")

    def __init__(self, col, v):
        self._col = col
        self._row = int(v)
        self.pos = int(col.pos[v])
        self.id = "."
        self._samples = None
        self._alleles = None

    def _all(self):
        if self._alleles is None:
            self._alleles = self._col.alleles[self._row]
        return self._alleles

    @property
    def chrom(self):
        return self._col.chroms[int(self._col.chrom_id[self._row])]

    @property
    def ref(self):
        return self._all()[0]

    @property
    def alts(self):
        return tuple(self._all()[1:])

    @property
    def qual(self):
        q = float(self._col.qual[self._row])
        return None if np.isnan(q) else q

    @property
    def mq(self):
        m = float(self._col.mq[self._row])
        return None if np.isnan(m) else m

    @property
    def samples(self):
        if self._samples is None:
            self._samples = _build_samples(self._col, self._row)
        return self._samples

    @property
    def alleles(self):
        return tuple(self._all())

    @property
    def rlen(self):
        return int(self._col.rlen[self._row])

    @property
    def info(self):
        return {"MQ": self.mq}


def _variant_from_columnar(col, v):
    """Reconstruct a parser.VcfVariant from columnar row ``v`` (eager;
    used for the one-time group-membership probe)."""
    alleles = col.alleles[v]
    qual = float(col.qual[v])
    mq = float(col.mq[v])
    return VcfVariant(chrom=col.chroms[int(col.chrom_id[v])],
                      pos=int(col.pos[v]), vid=".", ref=alleles[0],
                      alts=tuple(alleles[1:]),
                      qual=None if np.isnan(qual) else qual,
                      mq=None if np.isnan(mq) else mq,
                      samples=_build_samples(col, v),
                      sample_names=list(col.samples))


def _scan_mesh():
    """Device mesh for the classification batches (None = one device)."""
    from ..parallel.distributed import mesh_from_env
    return mesh_from_env()


def classify_route(col, mesh) -> str:
    """Which classification kernel a scan of ``col`` runs:

    - ``"sharded"``: the variant-parallel mesh kernel (parallel/vcf_shard);
    - ``"numpy"``: no accelerator — the bit-identical numpy mirror, which
      skips XLA-CPU dispatch per batch;
    - ``"small"``: the device kernel over host-packed gate bits with the
      int16 small-pull layout (A <= 15 alleles, S <= 32767 samples);
    - ``"full"``: the device kernel with the full int32 layout."""
    import jax

    if mesh is not None:
        return "sharded"
    if jax.default_backend() == "cpu":
        return "numpy"
    if col.ad.shape[2] <= 15 and len(col.samples) <= 32767:
        return "small"
    return "full"


def _classify_columnar(col, rows, group_names, groups, kw, batch=4096):
    """Device classification of the selected rows, in padded batches
    (stable shapes -> one compile per batch size).

    All batch dispatches are queued before any result is pulled (JAX
    dispatch is async, so host slicing/upload of batch i+1 overlaps device
    compute of batch i), and each batch returns ONE packed array.  The
    single-device accelerator path pulls the SMALL int16
    layout (sample counts + conserved/diagnostic + presence bits,
    ops/vcfclass.pack_outputs_small) and leaves the full allele-count
    matrix on device: the scan's hot path needs only presence, and the
    few candidate rows that need counts are recomputed exactly on the
    host (allele_counts_rows_numpy).  On a multi-device mesh each batch
    is sharded variant-parallel (parallel/vcf_shard.py), bit-identical
    to the single-chip kernel.

    Returns (sample_counts, allele_counts_or_None, conserved,
    diagnostic, present) — ``present`` is the bool (Vr, G, A) mask;
    ``allele_counts`` is None on the small-pull path."""
    from ..ops.vcfclass import classify_batch_packed

    mesh = _scan_mesh()
    route = classify_route(col, mesh)
    numpy_path = route == "numpy"
    small = route == "small"
    if route == "sharded":
        from functools import partial

        from ..parallel.vcf_shard import classify_batch_packed_sharded
        classify_batch_packed = partial(classify_batch_packed_sharded,
                                        mesh, shard="variants")
    elif numpy_path:
        from ..ops.vcfclass import classify_batch_packed_numpy
        classify_batch_packed = classify_batch_packed_numpy

    S = len(col.samples)
    A = col.ad.shape[2]
    G = len(group_names)
    s_index = {s: i for i, s in enumerate(col.samples)}
    group_id = np.full(S, -1, np.int32)
    for gi, g in enumerate(group_names):
        for m in groups[g]:
            if m in s_index:
                group_id[s_index[m]] = gi
    group_sizes = np.array([len(groups[g]) for g in group_names], np.int32)

    Vr = rows.shape[0]
    if small:
        # uploads are ~1 bit/element on this path, so bigger batches cost
        # little in transfer and cut the number of dispatches
        batch = max(batch, 32768)
    pending = []
    for i in range(0, Vr, batch):
        sel = rows[i:i + batch]
        n = sel.shape[0]
        # pad up to a power-of-two bucket (>=256, <=batch) so the many
        # distinct per-chunk row counts of a chunked scan land on a handful
        # of compiled shapes instead of one XLA compile per chunk
        bucket = 256
        while bucket < n:
            bucket *= 2
        pad = min(bucket, batch) - n
        mq = np.nan_to_num(col.mq[sel], nan=-1.0).astype(np.float32)
        qual = np.nan_to_num(col.qual[sel], nan=-1.0).astype(np.float32)
        if pad:
            mq = np.concatenate([mq, np.full(pad, -1, np.float32)])
            qual = np.concatenate([qual, np.full(pad, -1, np.float32)])
        if small:
            # host computes the elementwise masks (bit-identical to the
            # kernel's own), device does the sample-axis reductions —
            # the upload shrinks from (2S + S*A) int32 to (S + S*A) BITS
            # per variant, the measured wall-clock driver of this stage
            from ..ops.vcfclass import (classify_bits_packed_small,
                                        host_gate_counted_bits)
            gate_bits, counted_bits = host_gate_counted_bits(
                col.dp[sel], col.gq[sel], col.ad[sel],
                col.n_alleles[sel], kw["min_reads"],
                kw["min_geno_qual"], kw["min_freq"])
            if pad:
                gate_bits = np.concatenate(
                    [gate_bits,
                     np.zeros((pad, gate_bits.shape[1]), np.uint8)])
                counted_bits = np.concatenate(
                    [counted_bits,
                     np.zeros((pad, counted_bits.shape[1]), np.uint8)])
            pending.append((i, n, classify_bits_packed_small(
                gate_bits, counted_bits, mq, qual, group_id, group_sizes,
                n_groups=G, n_samples=S, n_alleles=A,
                min_samples=kw["min_samples"],
                min_map_qual=kw["min_map_qual"],
                min_var_qual=kw["min_var_qual"],
                min_samp_prop=kw["min_samp_prop"])))
            continue
        dp = col.dp[sel]
        gq = col.gq[sel]
        ad = col.ad[sel]
        n_alleles = col.n_alleles[sel]
        if pad:
            dp = np.concatenate([dp, np.full((pad, S), -1, np.int32)])
            gq = np.concatenate([gq, np.full((pad, S), -1, np.int32)])
            ad = np.concatenate([ad, np.zeros((pad, S, A), np.int32)])
            n_alleles = np.concatenate([n_alleles, np.zeros(pad, np.int32)])
        pending.append((i, n, classify_batch_packed(
            dp, gq, ad, n_alleles, mq, qual, group_id, group_sizes,
            n_groups=G, min_samples=kw["min_samples"],
            min_reads=kw["min_reads"], min_geno_qual=kw["min_geno_qual"],
            min_freq=kw["min_freq"], min_map_qual=kw["min_map_qual"],
            min_var_qual=kw["min_var_qual"],
            min_samp_prop=kw["min_samp_prop"])))

    # ONE device->host pull for the whole row set: concatenate the batch
    # outputs on device (pure data movement, one cheap compile per batch-
    # shape profile) instead of pulling per batch.
    if not pending:
        z = np.zeros((0, G), np.int32)
        return (z, np.zeros((0, G, A), np.int32), z.copy(), z.copy(),
                np.zeros((0, G, A), bool))
    if numpy_path:
        all_h = (pending[0][2] if len(pending) == 1
                 else np.concatenate([p[2] for p in pending], axis=0))
    else:
        import jax.numpy as jnp
        all_d = (pending[0][2] if len(pending) == 1
                 else jnp.concatenate([p[2] for p in pending], axis=0))
        all_h = np.asarray(all_d)

    sc = np.empty((Vr, G), np.int32)
    consv = np.empty((Vr, G), np.int32)
    diag = np.empty((Vr, G), np.int32)
    if small:
        present = np.empty((Vr, G, A), bool)
        ac = None
    else:
        ac = np.empty((Vr, G, A), np.int32)
    row = 0
    for i, n, out_d in pending:
        packed = all_h[row:row + n]
        row += out_d.shape[0]
        sc[i:i + n] = packed[:, :G]
        consv[i:i + n] = packed[:, G:2 * G]
        diag[i:i + n] = packed[:, 2 * G:3 * G]
        if small:
            bits = packed[:, 3 * G:4 * G].astype(np.int32)
            present[i:i + n] = (
                (bits[:, :, None] >> np.arange(A, dtype=np.int32)) & 1
            ).astype(bool)
        else:
            ac[i:i + n] = packed[:, 3 * G:].reshape(n, G, A)
    if not small:
        present = ac > 0
    return sc, ac, consv, diag, present


def _window_types(starts, ends, delta, is_diag, is_consv, span, min_vars):
    """Replay the sliding window exactly and type every (end, step) window.

    starts/ends: python lists of ints (ref coords); delta: list of the
    group's indel length deltas; returns (types int8 list, jstart list):
    0 = empty window (no yield), 1/2/3 = Undiagnostic/Unconserved/Misplaced
    (cascade steps 1-3, exact), 4 = candidate for the host cascade tail.

    The two-pointer IS the reference's deque semantics
    (krisp_vcf.py:171-218): append the new variant, then pop from the front
    while the group-coordinate span exceeds ``span``; j only advances.
    """
    V = len(starts)
    dpre = [0] * (V + 1)
    dsum = [0] * (V + 1)
    usum = [0] * (V + 1)
    for i in range(V):
        dpre[i + 1] = dpre[i] + delta[i]
        dsum[i + 1] = dsum[i] + (1 if is_diag[i] else 0)
        usum[i + 1] = usum[i] + (0 if is_consv[i] else 1)

    from collections import deque

    types = [0] * V
    jstart = [0] * V
    j = 0
    # monotonic deques: window extrema in O(1) per pop (the naive
    # max(ends[j:e+1]) rescan is O(V*w) on dense overlapping indels)
    maxdq: deque = deque()   # indices, ends decreasing
    mindq: deque = deque()   # indices, starts increasing
    for e in range(V):
        ee = ends[e]
        while maxdq and ends[maxdq[-1]] <= ee:
            maxdq.pop()
        maxdq.append(e)
        se = starts[e]
        while mindq and starts[mindq[-1]] >= se:
            mindq.pop()
        mindq.append(e)
        while j <= e:
            length = (ends[maxdq[0]] - starts[mindq[0]] + 1
                      + dpre[e + 1] - dpre[j])
            if length <= span:
                break
            j += 1
            if maxdq[0] < j:
                maxdq.popleft()
            if mindq[0] < j:
                mindq.popleft()
        jstart[e] = j
        if j > e:
            types[e] = 0
            continue
        nd = dsum[e + 1] - dsum[j]
        if nd < min_vars:
            types[e] = 1
        elif usum[e + 1] - usum[j] > 0:
            types[e] = 2
        elif nd == 1 and not is_diag[e]:
            types[e] = 3
        else:
            types[e] = 4
    return types, jstart


def _batch_borders(pos, rlen, delta, consv, b, lim, M, direction):
    """Vectorized replay of region.consv_border_n over many candidates.

    pos (1-based) / rlen / delta (group allele-length delta) / consv
    (bool): per-row arrays for one group.  Per candidate: ``b`` border
    row, ``lim`` nearby-row count, ``M`` max_offset; ``direction`` +1
    walks upstream rows b+1+t, -1 walks downstream rows b-1-t (nearest
    first) — exactly the deque contents the serial walk sees.  Returns
    (ref, group) int64 arrays, elementwise equal to consv_border_n's
    {"ref","group"} results (pinned by tests/test_fastscan.py)."""
    C = b.shape[0]
    if C == 0:
        z = np.zeros(0, np.int64)
        return z, z
    Tmax = max(int(lim.max()), 1)
    V = pos.shape[0]
    t = np.arange(Tmax, dtype=np.int64)
    R = b[:, None] + direction * (1 + t[None, :])
    in_lim = t[None, :] < lim[:, None]
    Rc = np.clip(R, 0, V - 1)

    pos_b = pos[b][:, None]
    posr = pos[Rc]
    # serial branch: distance to the nearby variant's start when the
    # border precedes it, else back from its end
    ref_diff = np.where(pos_b <= posr, posr - pos_b,
                        pos_b - (posr + rlen[Rc] - 1))
    deltas = np.where(in_lim, delta[Rc], 0)
    first = np.clip(b + direction, 0, V - 1)
    init = np.where((lim > 0) & (pos[b] < pos[first]), delta[b], 0)
    off_before = init[:, None] + np.cumsum(deltas, axis=1) - deltas

    cond_a = in_lim & (ref_diff + off_before >= M[:, None])
    cond_b = in_lim & ~consv[Rc]
    stop = cond_a | cond_b
    has = stop.any(axis=1)
    tstar = stop.argmax(axis=1)
    ar = np.arange(C)
    offs = off_before[ar, tstar]
    rd = ref_diff[ar, tstar]
    is_a = cond_a[ar, tstar]
    ref_stop = np.where(is_a, M - offs, rd - 1)
    grp_stop = np.where(is_a, M, rd + offs - 1)

    # walked off the end of the nearby list: final ref_diff and the full
    # delta sum (serial's fall-through return)
    rd_last = np.where(lim > 0,
                       ref_diff[ar, np.maximum(lim - 1, 0)], 0)
    off_final = init + deltas.sum(axis=1)
    ref = np.where(has, ref_stop, rd_last - off_final)
    grp = np.where(has, grp_stop, rd_last)
    return ref.astype(np.int64), grp.astype(np.int64)


def _batch_cascade_ranges(cand, jarr, pos, rlen, delta, consv, *,
                          span_len, offset_right, crrna_len, flank):
    """Cascade steps 4-5 for every candidate of one group at once:
    conserved-overhang and 30 nt primer-flank gates plus the crRNA /
    template reference ranges for survivors.

    Returns (reject bool[C], ranges int64[C, 4]) where ranges rows are
    (start_crrna_ref, end_crrna_ref, start_tmp_ref, end_tmp_ref)."""
    overhang_left = crrna_len - span_len - offset_right
    C = cand.shape[0]
    M_up = np.full(C, offset_right, np.int64)
    M_flank = np.full(C, flank, np.int64)
    V = pos.shape[0]
    lim_up = np.minimum(cand + flank, V) - (cand + 1)
    lim_dn = np.minimum(jarr, flank)

    up_ref, up_grp = _batch_borders(pos, rlen, delta, consv,
                                    cand, lim_up, M_up, +1)
    dn_ref, dn_grp = _batch_borders(pos, rlen, delta, consv,
                                    jarr, lim_dn, overhang_left, -1)
    cu_ref, cu_grp = _batch_borders(pos, rlen, delta, consv,
                                    cand, lim_up, M_flank, +1)
    cd_ref, cd_grp = _batch_borders(pos, rlen, delta, consv,
                                    jarr, lim_dn, M_flank, -1)

    reject = ((up_grp < offset_right) | (dn_grp < overhang_left)
              | (cu_grp - up_grp < 30) | (cd_grp - dn_grp < 30))
    ranges = np.stack([pos[jarr] - 1 - dn_ref,
                       pos[cand] - 1 + up_ref,
                       pos[jarr] - 1 - cd_ref,
                       pos[cand] - 1 + cu_ref], axis=1)
    return reject, ranges


class _LazyRows:
    """Sequence of classified variants over a row-index array,
    constructing elements only on access (the flank context of a
    candidate window is mostly never touched by the cascade tail)."""

    __slots__ = ("_idx", "_dcv")

    def __init__(self, idx, dcv):
        self._idx = idx
        self._dcv = dcv

    def __len__(self):
        return len(self._idx)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._dcv(int(j)) for j in self._idx[i]]
        return self._dcv(int(self._idx[i]))

    def __iter__(self):
        for j in self._idx:
            yield self._dcv(int(j))

    def __reversed__(self):
        for j in self._idx[::-1]:
            yield self._dcv(int(j))


def find_diag_region_fast(col, rows, groups, reference=None, nontarget=None,
                          primer3=False, min_vars=1, min_bases=1,
                          min_samp_prop=0.9, min_samples=5, min_reads=5,
                          min_geno_qual=30, min_map_qual=40, min_var_qual=10,
                          min_freq=0.1, crrna_len=28, tm=(53, 68),
                          gc=(40, 70), amp_size=(80, 300),
                          primer_size=(25, 35), max_sec_tm=40, gc_clamp=1,
                          max_end_gc=4, var_location=(4, 16), force=False,
                          engine="device"):
    """Drop-in fast equivalent of scan.find_diag_region over columnar rows.

    Yields the identical sequence of typed windows (flyweights for
    rejections, full regions for candidates/survivors) in the same
    (variant step x group) order as the host scan.
    """
    rows = np.asarray(rows, np.int64)
    if rows.size == 0:
        return

    offset_left = var_location[0] - 1
    offset_right = crrna_len - var_location[1]
    span = crrna_len - offset_right - offset_left
    flank = amp_size[1]

    classify_kwargs = dict(min_samp_prop=min_samp_prop,
                           min_samples=min_samples, min_reads=min_reads,
                           min_geno_qual=min_geno_qual, min_freq=min_freq,
                           min_map_qual=min_map_qual,
                           min_var_qual=min_var_qual, force=force)

    # group-membership validation on the first record, once
    # (parity: find_diag_var.py:187-201)
    probe = ClassifiedVariant(_variant_from_columnar(col, int(rows[0])),
                              groups, check_groups=True, **classify_kwargs)
    groups = probe.groups
    group_names = list(groups.keys())
    G = len(group_names)

    sc, ac, consv, diag, present = _classify_columnar(
        col, rows, group_names, groups, classify_kwargs)

    pos = col.pos[rows]
    rlen = col.rlen[rows].astype(np.int64)
    starts_np = pos - 1
    ends_np = starts_np + rlen - 1
    alen = col.alen[rows]                          # (Vr, A)
    gl = np.where(present, alen[:, None, :], -1).max(axis=2)
    group_len = np.where(gl < 0, rlen[:, None], gl)
    delta_np = group_len - rlen[:, None]           # (Vr, G)

    is_diag_np = diag >= 0
    is_consv_np = consv >= 0

    from ..io.native_vcf import window_types_native
    types_g = []
    jstart_g = []
    starts = ends = None
    for gi in range(G):
        tj = window_types_native(starts_np, ends_np, delta_np[:, gi],
                                 is_diag_np[:, gi], is_consv_np[:, gi],
                                 span, min_vars)
        if tj is None:  # no native lib: the Python oracle is the fallback
            if starts is None:
                starts = starts_np.tolist()
                ends = ends_np.tolist()
            tj = _window_types(starts, ends, delta_np[:, gi].tolist(),
                               is_diag_np[:, gi].tolist(),
                               is_consv_np[:, gi].tolist(), span, min_vars)
        types_g.append(tj[0])
        jstart_g.append(tj[1])

    # Batched cascade steps 4-5: the four conserved-border walks of every
    # candidate run as numpy matrix passes over the columnar arrays; the
    # per-candidate Python work shrinks to survivors' sequence inference
    # and primer design.  border_g[gi][e] = (rejected, ranges) where
    # ranges = (start_crrna, end_crrna, start_tmp, end_tmp) in ref coords.
    offset_right_n = crrna_len - var_location[1]
    rlen64 = rlen
    border_g: list[dict] = []
    for gi in range(G):
        t_arr = np.asarray(types_g[gi], np.int8)
        cand = np.nonzero(t_arr == 4)[0].astype(np.int64)
        if cand.size == 0:
            border_g.append({})
            continue
        jstarts = jstart_g[gi]
        jarr = np.fromiter((jstarts[int(e)] for e in cand), np.int64,
                           cand.size)
        # group-coordinate window length per candidate (== region_length)
        wmax = int((cand - jarr).max()) + 1
        if wmax <= 256:
            widx = jarr[:, None] + np.arange(wmax, dtype=np.int64)
            wmask = widx <= cand[:, None]
            widc = np.minimum(widx, cand[:, None])
            span_len = (np.where(wmask, ends_np[widc], np.int64(-2**62))
                        .max(axis=1)
                        - np.where(wmask, starts_np[widc], np.int64(2**62))
                        .min(axis=1) + 1
                        + np.where(wmask, delta_np[widc, gi], 0).sum(axis=1))
        else:  # degenerate ultra-dense windows: per-candidate reduction
            span_len = np.fromiter(
                (ends_np[j:e + 1].max() - starts_np[j:e + 1].min() + 1
                 + delta_np[j:e + 1, gi].sum()
                 for e, j in zip(cand, jarr)), np.int64, cand.size)
        reject, ranges = _batch_cascade_ranges(
            cand, jarr, pos, rlen64, delta_np[:, gi].astype(np.int64),
            is_consv_np[:, gi], span_len=span_len,
            offset_right=offset_right_n, crrna_len=crrna_len, flank=flank)
        border_g.append({int(e): (bool(r), rg)
                         for e, r, rg in zip(cand, reject, ranges)})

    # lazy per-row device-classified variant objects (only candidates'
    # context windows materialize)
    alleles_cache = col.alleles
    dcv_cache: dict[int, DeviceClassifiedVariant] = {}

    s_index = {s: si for si, s in enumerate(col.samples)}
    gid_of_sample = np.full(len(col.samples), -1, np.int32)
    for gi2, g2 in enumerate(group_names):
        for m in groups[g2]:
            if m in s_index:
                gid_of_sample[s_index[m]] = gi2

    ac_cache: dict[int, np.ndarray] = {}

    def _ac_row(i: int) -> np.ndarray:
        """Exact allele counts (G, A) for touched row i.  On the
        small-pull device path the count matrix stays on device; the host
        recomputes the row from the columnar arrays with the pinned
        numpy-mirror math (ops/vcfclass.allele_counts_rows_numpy) —
        bit-identical to the kernel's output."""
        if ac is not None:
            return ac[i]
        hit = ac_cache.get(i)
        if hit is None:
            from ..ops.vcfclass import allele_counts_rows_numpy
            r = int(rows[i])
            hit = allele_counts_rows_numpy(
                col.dp[r:r + 1], col.gq[r:r + 1], col.ad[r:r + 1],
                col.n_alleles[r:r + 1], gid_of_sample, G,
                classify_kwargs["min_reads"],
                classify_kwargs["min_geno_qual"],
                classify_kwargs["min_freq"])[0]
            ac_cache[i] = hit
        return hit

    def _dicts_for(i: int):
        alleles = alleles_cache[int(rows[i])]
        ac_i = _ac_row(i)
        sample_counts = {g: int(sc[i, gi])
                         for gi, g in enumerate(group_names)}
        allele_counts = {
            g: {alleles[ai]: int(c)
                for ai, c in enumerate(ac_i[gi]) if c > 0}
            for gi, g in enumerate(group_names)}
        conserved = {g: (None if consv[i, gi] < 0
                         else alleles[consv[i, gi]])
                     for gi, g in enumerate(group_names)}
        diagnostic = {g: (None if diag[i, gi] < 0
                          else alleles[diag[i, gi]])
                      for gi, g in enumerate(group_names)}
        return sample_counts, allele_counts, conserved, diagnostic

    def _missing_for(i):
        # per-group ids of samples failing the DP/GQ gates, straight from
        # the columnar arrays (-1 encodes a missing FORMAT value, which
        # fails both gates, as None does on the host path)
        r = int(rows[i])
        bad = (col.dp[r] < min_reads) | (col.gq[r] < min_geno_qual)
        return {g2: {col.samples[si]
                     for si in np.nonzero(bad & (gid_of_sample == gi2))[0]}
                for gi2, g2 in enumerate(group_names)}

    def dcv(i: int) -> DeviceClassifiedVariant:
        hit = dcv_cache.get(i)
        if hit is None:
            # dict construction deferred: most context variants of a
            # candidate window are never touched by the cascade tail
            hit = DeviceClassifiedVariant(
                _LazyVariant(col, int(rows[i])), groups, classify_kwargs,
                builder=lambda i=i: _dicts_for(i),
                missing_fn=lambda i=i: _missing_for(i))
            dcv_cache[i] = hit
        return hit

    from collections import deque

    # Windows that reach primer design are buffered (in stream order) and
    # designed in batches, fusing the thermodynamic screen rounds of many
    # templates into single numpy passes (design_primers_batch) — the
    # per-window results are bit-identical to serial cascade_tail calls
    # at ANY batch size (batching is composition-invariant, pinned by
    # tests/test_thermo.py).  Rejections pass straight through while
    # nothing is buffered, so the typed stream order is preserved exactly.
    import os as _os
    DESIGN_BATCH = int(_os.environ.get("KRISP_TPU_DESIGN_BATCH", 32))
    buf: list = []
    npending = 0

    def _flush(buf):
        jobs = [x.design_job for x in buf if isinstance(x, PendingDesign)]
        outs = iter(run_primer3_batch(jobs, tm=tm, gc=gc,
                                      amp_size=amp_size,
                                      primer_size=primer_size,
                                      max_sec_tm=max_sec_tm,
                                      gc_clamp=gc_clamp,
                                      max_end_gc=max_end_gc))
        return [cascade_finish(x, next(outs))
                if isinstance(x, PendingDesign) else x for x in buf]

    Vr = rows.shape[0]
    for e in range(Vr):
        for gi, g in enumerate(group_names):
            t = types_g[gi][e]
            if t == 0:
                continue
            if t != 4:
                if buf:
                    buf.append(_REJ[t])
                else:
                    yield _REJ[t]
                continue
            rejected, ranges = border_g[gi][e]
            if rejected:   # batched steps 4-5: overhang / 30nt flank gates
                r = _REJ_UNCONSERVED
                if buf:
                    buf.append(r)
                else:
                    yield r
                continue
            j = jstart_g[gi][e]
            lo = max(j - flank, 0)
            hi = min(e + flank, Vr)
            window = VariantWindow(
                variants=deque(dcv(i) for i in range(j, e + 1)),
                group=g, reference=reference,
                upstream=_LazyRows(np.arange(e + 1, hi), dcv),
                downstream=_LazyRows(np.arange(j - 1, lo - 1, -1), dcv))
            # positions injected straight from the columnar arrays: the
            # frozen cache and the coordinate transform never touch (or
            # construct) context variant objects
            order = np.concatenate([np.arange(j - 1, lo - 1, -1),
                                    np.arange(j, hi)])
            window._frozen = (_LazyRows(order, dcv),
                              starts_np[order], ends_np[order])
            window._coords = (pos[lo:hi], delta_np[lo:hi, gi])
            region = cascade_from_ranges(
                window, groups, reference, int(ranges[0]), int(ranges[1]),
                int(ranges[2]), int(ranges[3]), min_bases=min_bases)
            if isinstance(region, PendingDesign):
                buf.append(region)
                npending += 1
                if npending >= DESIGN_BATCH:
                    yield from _flush(buf)
                    buf = []
                    npending = 0
            elif buf:
                buf.append(region)
            else:
                yield region
    if buf:
        yield from _flush(buf)


def chunk_rows(col, chunk):
    """Row indices (file order) of records overlapping the chunk window —
    the same overlap rule as VcfReader.fetch/pysam."""
    if chunk is None:
        return np.arange(col.n_records, dtype=np.int64)
    cid = None
    for i, c in enumerate(col.chroms):
        if c == chunk["contig"]:
            cid = i
            break
    if cid is None:
        return np.zeros(0, np.int64)
    rec_start = col.pos - 1
    rec_end = rec_start + col.rlen
    mask = col.chrom_id == cid
    if chunk.get("start") is not None:
        mask &= rec_end > chunk["start"]
    if chunk.get("end") is not None:
        mask &= rec_start < chunk["end"]
    return np.nonzero(mask)[0].astype(np.int64)
