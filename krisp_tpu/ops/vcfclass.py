"""Vectorized per-variant, per-group classification (device kernel).

The accelerator path for SURVEY C27/C28: the reference classifies one variant
at a time with Python dict math over samples
(/root/reference/src/krisp/krisp_vcf/find_diag_var.py:203-411); this kernel
evaluates a whole batch of variants × samples at once as masked reductions —
the shape that lets a chip chew through whole-genome VCFs (thousands of
samples) at memory bandwidth.

Alleles are per-variant indices (0 = REF); cross-group set operations become
bitmask algebra.  The '?' zero-coverage pseudo-allele is representable only
when min_reads == 0 (reference semantics: find_diag_var.py:249-251); this
kernel requires min_reads >= 1 and the host engine handles the rest —
asserted by the batch builder.

Exact agreement with the host-side ClassifiedVariant is pinned by
tests/test_vcfclass_device.py over the bundled 10k-variant VCF.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _accumulate(dp, gq, ad, n_alleles, group_id, n_groups: int,
                min_reads, min_geno_qual, min_freq):
    """The sample-axis reductions: (sample_counts[V,G], allele_counts
    [V,G,A]).  Integer sums, so any partition of the sample axis (e.g. a
    sharded cohort with a ``psum``) reproduces them bit-for-bit."""
    gate = (dp >= min_reads) & (gq >= min_geno_qual)          # (V,S)
    member = (group_id[None, :, None]
              == jnp.arange(n_groups, dtype=jnp.int32)[None, None, :])  # (1,S,G)

    sample_counts = jnp.sum((gate[:, :, None] & member).astype(jnp.int32),
                            axis=1)                            # (V,G)

    depth_sum = jnp.sum(ad, axis=2, keepdims=True)             # (V,S,1)
    A = ad.shape[2]
    allele_idx = jnp.arange(A, dtype=jnp.int32)
    keep = ((ad > 0)
            & (ad.astype(jnp.float32)
               >= depth_sum.astype(jnp.float32) * min_freq)
            & (allele_idx[None, None, :] < n_alleles[:, None, None]))
    counted = keep & gate[:, :, None]                          # (V,S,A)

    allele_counts = jnp.sum(
        (counted[:, :, None, :] & member[:, :, :, None]).astype(jnp.int32),
        axis=1)                                                # (V,G,A)
    return sample_counts, allele_counts


def _finalize(sample_counts, allele_counts, mq, qual, group_sizes,
              n_groups: int, min_samples, min_map_qual, min_var_qual,
              min_samp_prop):
    """Per-variant classification from the accumulated counts (no sample
    axis left — pure (V,G[,A]) math)."""
    A = allele_counts.shape[2]
    allele_idx = jnp.arange(A, dtype=jnp.int32)
    present = allele_counts > 0
    n_distinct = jnp.sum(present.astype(jnp.int32), axis=2)    # (V,G)
    single_allele = jnp.argmax(present, axis=2).astype(jnp.int32)

    prop = (sample_counts.astype(jnp.float32)
            / jnp.maximum(group_sizes, 1).astype(jnp.float32)[None, :])
    qual_ok = (mq >= min_map_qual) & (qual >= min_var_qual)    # (V,)
    samp_ok = (sample_counts >= min_samples) & (prop >= min_samp_prop)

    consv_ok = qual_ok[:, None] & (n_distinct == 1) & samp_ok
    conserved = jnp.where(consv_ok, single_allele, -1)

    # diagnostic: all groups must pass sample thresholds; per group, its
    # single allele must appear in no other group
    all_groups_ok = jnp.all(samp_ok, axis=1)                   # (V,)
    mask = jnp.sum(jnp.where(present,
                             jnp.uint32(1) << allele_idx[None, None, :].astype(jnp.uint32),
                             jnp.uint32(0)), axis=2)           # (V,G)
    def union_of_others(g):
        acc = jnp.zeros_like(mask[:, 0])
        for og in range(n_groups):
            if og != g:
                acc = acc | mask[:, og]
        return acc

    others = jnp.stack([union_of_others(g) for g in range(n_groups)], axis=1)
    unique_bits = mask & ~others
    diag_ok = (qual_ok & all_groups_ok)[:, None] & (n_distinct == 1) \
        & (unique_bits != 0)
    diagnostic = jnp.where(diag_ok, single_allele, -1)

    return {"sample_counts": sample_counts,
            "allele_counts": allele_counts,
            "conserved": conserved,
            "diagnostic": diagnostic}


def _classify_impl(dp, gq, ad, n_alleles, mq, qual, group_id, group_sizes,
                   n_groups: int, min_samples=5, min_reads=10,
                   min_geno_qual=40, min_freq=0.1, min_map_qual=30,
                   min_var_qual=10, min_samp_prop=0.9):
    sample_counts, allele_counts = _accumulate(
        dp, gq, ad, n_alleles, group_id, n_groups, min_reads,
        min_geno_qual, min_freq)
    return _finalize(sample_counts, allele_counts, mq, qual, group_sizes,
                     n_groups, min_samples, min_map_qual, min_var_qual,
                     min_samp_prop)


@partial(jax.jit, static_argnames=("n_groups",))
def classify_batch(dp, gq, ad, n_alleles, mq, qual, group_id, group_sizes,
                   n_groups: int, min_samples=5, min_reads=10,
                   min_geno_qual=40, min_freq=0.1, min_map_qual=30,
                   min_var_qual=10, min_samp_prop=0.9):
    """Classify V variants for G groups.

    Shapes: dp,gq int32[V,S] (-1 missing); ad int32[V,S,A]; n_alleles
    int32[V]; mq,qual float32[V]; group_id int32[S] (-1 = unused sample);
    group_sizes int32[G].

    Returns dict of arrays:
      sample_counts int32[V,G], allele_counts int32[V,G,A],
      conserved int32[V,G] (allele index or -1),
      diagnostic int32[V,G] (allele index or -1).
    """
    return _classify_impl(dp, gq, ad, n_alleles, mq, qual, group_id,
                          group_sizes, n_groups, min_samples, min_reads,
                          min_geno_qual, min_freq, min_map_qual,
                          min_var_qual, min_samp_prop)


def pack_outputs(out, V):
    """The packed single-pull layout, [V, G*(A+3)]: columns [0:G) =
    sample_counts, [G:2G) = conserved, [2G:3G) = diagnostic, [3G:) =
    allele_counts reshaped (G-major).  The ONE definition of the layout —
    the single-device and mesh-sharded kernels both emit it, and
    vcf/fastscan.py unpacks by these column ranges."""
    return jnp.concatenate(
        [out["sample_counts"], out["conserved"], out["diagnostic"],
         out["allele_counts"].reshape(V, -1)], axis=1)


def pack_outputs_small(out, V):
    """The SMALL-pull layout, int16 [V, 4G]: columns [0:G) =
    sample_counts, [G:2G) = conserved, [2G:3G) = diagnostic, [3G:4G) =
    per-group allele PRESENCE bitmask (bit a set iff allele_counts > 0).

    The scan's hot path needs only presence (group length / window
    typing) — the full counts are touched for the few candidate-window
    context rows, which the host recomputes exactly
    (``allele_counts_rows_numpy``).  Shrinking the per-variant pull from
    (3G+G*A) x int32 to 4G x int16 cuts the device->host bytes ~6x on
    this workload.  Requires A <= 15 and S <= 32767 (caller falls back
    to the full layout otherwise)."""
    present = out["allele_counts"] > 0
    A = present.shape[2]
    bits = jnp.sum(jnp.where(
        present,
        jnp.int32(1) << jnp.arange(A, dtype=jnp.int32)[None, None, :],
        jnp.int32(0)), axis=2)
    return jnp.concatenate(
        [out["sample_counts"], out["conserved"], out["diagnostic"], bits],
        axis=1).astype(jnp.int16)


def host_gate_counted_bits(dp, gq, ad, n_alleles, min_reads,
                           min_geno_qual, min_freq):
    """Elementwise gate/keep masks computed HOST-side — exactly the numpy
    mirror's math, so bit-identical to the device kernel's — and packed
    to bits for a minimal host->device upload.

    dp/gq/ad are (V,S[,A]) int32 — ~2 kB/variant of host->device upload
    at 100 samples; the masks are 1 bit per element (~50x less), and the
    expensive part — the sample-axis group reductions — stays on device
    (classify_bits_packed_small).  Returns (gate_bits uint8[V, ceil(S/8)],
    counted_bits uint8[V, ceil(S*A/8)])."""
    import numpy as np

    V, S = dp.shape
    A = ad.shape[2]
    f32 = np.float32

    def block(sl):
        gate = (dp[sl] >= min_reads) & (gq[sl] >= min_geno_qual)
        adb = ad[sl]
        depth_sum = np.sum(adb, axis=2, keepdims=True, dtype=np.int32)
        allele_idx = np.arange(A, dtype=np.int32)
        keep = ((adb > 0)
                & (adb.astype(f32) >= depth_sum.astype(f32)
                   * f32(min_freq))
                & (allele_idx[None, None, :]
                   < n_alleles[sl, None, None]))
        counted = keep & gate[:, :, None]
        return (np.packbits(gate, axis=1),
                np.packbits(counted.reshape(gate.shape[0], -1), axis=1))

    # V-axis blocks on a small pool: numpy releases the GIL, the per-row
    # math is independent, and the temporaries stay cache-sized
    import os
    from concurrent.futures import ThreadPoolExecutor

    T = max(1, min(os.cpu_count() or 1, 4, V // 2048))
    if T <= 1:
        return block(slice(0, V))
    bounds = [V * t // T for t in range(T + 1)]
    with ThreadPoolExecutor(max_workers=T) as pool:
        parts = list(pool.map(lambda b: block(slice(*b)),
                              zip(bounds, bounds[1:])))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


@partial(jax.jit, static_argnames=("n_groups", "n_samples", "n_alleles"))
def classify_bits_packed_small(gate_bits, counted_bits, mq, qual, group_id,
                               group_sizes, n_groups: int, n_samples: int,
                               n_alleles: int, min_samples=5,
                               min_map_qual=30, min_var_qual=10,
                               min_samp_prop=0.9):
    """Device classification from host-precomputed gate/keep bitmasks
    (``host_gate_counted_bits``): unpack, reduce over the sample axis,
    finalize, and emit the small-pull int16 layout.  Values equal
    ``classify_batch_packed`` exactly — the bits are the kernel's own
    elementwise masks, the float32 reductions of 0/1 over <= S samples
    are exact integers (S < 2**24, float32 accumulation at
    ``Precision.HIGHEST``, so no backend may round the operands to a
    lower-precision matmul format), and _finalize is shared."""
    V = gate_bits.shape[0]

    def unpack(words, n):
        bits = (words[:, :, None]
                >> (jnp.uint8(7) - jnp.arange(8, dtype=jnp.uint8))) \
            & jnp.uint8(1)
        return bits.reshape(V, -1)[:, :n]

    gate_f = unpack(gate_bits, n_samples).astype(jnp.float32)
    counted_f = unpack(counted_bits, n_samples * n_alleles) \
        .reshape(V, n_samples, n_alleles).astype(jnp.float32)
    member_f = (group_id[:, None]
                == jnp.arange(n_groups, dtype=jnp.int32)[None, :]) \
        .astype(jnp.float32)
    exact = jax.lax.Precision.HIGHEST
    sample_counts = jnp.dot(gate_f, member_f, precision=exact,
                            preferred_element_type=jnp.float32
                            ).astype(jnp.int32)
    allele_counts = jnp.einsum("vsa,sg->vga", counted_f, member_f,
                               precision=exact,
                               preferred_element_type=jnp.float32
                               ).astype(jnp.int32)
    out = _finalize(sample_counts, allele_counts, mq, qual, group_sizes,
                    n_groups, min_samples, min_map_qual, min_var_qual,
                    min_samp_prop)
    return pack_outputs_small(out, V)


def allele_counts_rows_numpy(dp, gq, ad, n_alleles, group_id,
                             n_groups: int, min_reads, min_geno_qual,
                             min_freq):
    """Exact allele_counts for a (small) row subset, host-side: the
    count section of ``classify_batch_packed_numpy`` verbatim, so results
    are bit-identical to the device kernel's allele_counts (which is
    pinned against the mirror by tests/test_vcfclass_device.py).  Used by
    the small-pull scan protocol to rehydrate candidate-window rows
    without a device round-trip.

    dp, gq: int32[R,S]; ad: int32[R,S,A]; returns int32[R, G, A]."""
    import numpy as np

    R, S = dp.shape
    A = ad.shape[2]
    f32 = np.float32
    gate = (dp >= min_reads) & (gq >= min_geno_qual)
    member_f = (group_id[:, None]
                == np.arange(n_groups, dtype=np.int32)[None, :]) \
        .astype(f32)
    depth_sum = np.sum(ad, axis=2, keepdims=True, dtype=np.int32)
    allele_idx = np.arange(A, dtype=np.int32)
    keep = ((ad > 0)
            & (ad.astype(f32) >= depth_sum.astype(f32) * f32(min_freq))
            & (allele_idx[None, None, :] < n_alleles[:, None, None]))
    counted = keep & gate[:, :, None]
    # per-row BLAS dot instead of einsum: this runs once per TOUCHED
    # candidate-context row during the scan, where einsum's path-planning
    # overhead dwarfs the actual (G,S)x(S,A) product
    out = np.empty((R, n_groups, A), np.int32)
    mt = member_f.T
    for r in range(R):
        out[r] = np.dot(mt, counted[r].astype(f32)).astype(np.int32)
    return out


def classify_batch_packed_numpy(dp, gq, ad, n_alleles, mq, qual, group_id,
                                group_sizes, n_groups: int, min_samples=5,
                                min_reads=10, min_geno_qual=40, min_freq=0.1,
                                min_map_qual=30, min_var_qual=10,
                                min_samp_prop=0.9):
    """Pure-numpy mirror of ``classify_batch_packed`` — bit-identical
    output (pinned by tests/test_vcfclass_device.py).

    The scan routes classification here when it has no accelerator: the
    vectorized numpy path skips XLA-CPU dispatch for every batch of a
    long whole-genome scan.  All float math is float32, matching
    the jax kernel's weak-type promotion (NEP 50 gives numpy the same
    f32-scalar semantics); everything else is integer/bool algebra."""
    import numpy as np

    V, S = dp.shape
    A = ad.shape[2]
    f32 = np.float32
    gate = (dp >= min_reads) & (gq >= min_geno_qual)               # (V,S)
    member_f = (group_id[:, None]
                == np.arange(n_groups, dtype=np.int32)[None, :]) \
        .astype(f32)                                               # (S,G)
    # group reductions as matmuls over the sample axis: counts are exact
    # in float32 (0/1 sums far below 2^24) and BLAS keeps peak memory at
    # O(V*S*A) — the naive (V,S,G,A) boolean intermediate is hundreds of
    # MB to GBs per batch on whole-cohort scans (ADVICE r2)
    sample_counts = (gate.astype(f32) @ member_f).astype(np.int32)  # (V,G)

    depth_sum = np.sum(ad, axis=2, keepdims=True, dtype=np.int32)  # (V,S,1)
    allele_idx = np.arange(A, dtype=np.int32)
    keep = ((ad > 0)
            & (ad.astype(f32) >= depth_sum.astype(f32) * f32(min_freq))
            & (allele_idx[None, None, :] < n_alleles[:, None, None]))
    counted = keep & gate[:, :, None]                               # (V,S,A)
    # einsum('vsa,sg->vga') in bounded sample chunks
    allele_counts = np.zeros((V, n_groups, A), np.int32)
    chunk = max(1, (1 << 22) // max(V * A, 1))
    for s0 in range(0, S, chunk):
        c = counted[:, s0:s0 + chunk, :].astype(f32)
        allele_counts += np.einsum(
            "vsa,sg->vga", c, member_f[s0:s0 + chunk],
            optimize=True).astype(np.int32)

    present = allele_counts > 0
    n_distinct = np.sum(present, axis=2, dtype=np.int32)            # (V,G)
    single_allele = np.argmax(present, axis=2).astype(np.int32)

    prop = (sample_counts.astype(f32)
            / np.maximum(group_sizes, 1).astype(f32)[None, :])
    qual_ok = (mq >= f32(min_map_qual)) & (qual >= f32(min_var_qual))
    samp_ok = (sample_counts >= min_samples) & (prop >= f32(min_samp_prop))

    consv_ok = qual_ok[:, None] & (n_distinct == 1) & samp_ok
    conserved = np.where(consv_ok, single_allele, -1).astype(np.int32)

    all_groups_ok = np.all(samp_ok, axis=1)
    mask = np.sum(np.where(present,
                           np.uint32(1) << allele_idx[None, None, :]
                           .astype(np.uint32), np.uint32(0)),
                  axis=2, dtype=np.uint32)                          # (V,G)
    others = np.stack([np.bitwise_or.reduce(
        mask[:, [og for og in range(n_groups) if og != g]], axis=1)
        if n_groups > 1 else np.zeros_like(mask[:, 0])
        for g in range(n_groups)], axis=1)
    unique_bits = mask & ~others
    diag_ok = (qual_ok & all_groups_ok)[:, None] & (n_distinct == 1) \
        & (unique_bits != 0)
    diagnostic = np.where(diag_ok, single_allele, -1).astype(np.int32)

    return np.concatenate(
        [sample_counts, conserved, diagnostic,
         allele_counts.reshape(V, -1)], axis=1)


@partial(jax.jit, static_argnames=("n_groups",))
def classify_batch_packed(dp, gq, ad, n_alleles, mq, qual, group_id,
                          group_sizes, n_groups: int, min_samples=5,
                          min_reads=10, min_geno_qual=40, min_freq=0.1,
                          min_map_qual=30, min_var_qual=10,
                          min_samp_prop=0.9):
    """``classify_batch`` with the four outputs packed (``pack_outputs``)
    into ONE int32 array.

    One device->host transfer per batch instead of four."""
    out = _classify_impl(dp, gq, ad, n_alleles, mq, qual, group_id,
                         group_sizes, n_groups, min_samples, min_reads,
                         min_geno_qual, min_freq, min_map_qual,
                         min_var_qual, min_samp_prop)
    return pack_outputs(out, dp.shape[0])
