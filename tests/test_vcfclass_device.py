"""Device classification kernel vs. the exact host engine on a seeded
cohort VCF — every variant, every group, bit-for-bit agreement."""

import itertools

import numpy as np
from krisp_tpu.ops.vcfclass import classify_batch
from krisp_tpu.vcf.batch import build_batch
from krisp_tpu.vcf.classify import ClassifiedVariant, parse_group_data
from krisp_tpu.vcf.parser import VcfReader

KW = dict(min_samples=3, min_reads=10, min_geno_qual=40, min_freq=0.1,
          min_map_qual=40, min_var_qual=10, min_samp_prop=0.9)

N_CHECK = 1500  # variants to compare (full host pass over 10k is slow-ish)
GROUPS = ["G1", "G2", "G3"]


def test_device_matches_host_engine(synth_vcf):
    meta, _, vcf = synth_vcf
    groups = parse_group_data(meta, groups=GROUPS)
    variants = list(itertools.islice(VcfReader(vcf), N_CHECK))
    arrays, group_names, _ = build_batch(variants, groups)
    out = classify_batch(n_groups=len(group_names), **arrays, **KW)

    sample_counts = np.asarray(out["sample_counts"])
    allele_counts = np.asarray(out["allele_counts"])
    conserved = np.asarray(out["conserved"])
    diagnostic = np.asarray(out["diagnostic"])

    mismatches = []
    for vi, var in enumerate(variants):
        host = ClassifiedVariant(var, groups, **KW)
        for gi, g in enumerate(group_names):
            if host.sample_counts[g] != sample_counts[vi, gi]:
                mismatches.append((var.pos, g, "sample_counts"))
            want_counts = {a: c for a, c in host.allele_counts[g].items()}
            got_counts = {var.alleles[ai]: int(c)
                          for ai, c in enumerate(allele_counts[vi, gi])
                          if c > 0}
            if want_counts != got_counts:
                mismatches.append((var.pos, g, "allele_counts",
                                   want_counts, got_counts))
            want_consv = host.conserved[g]
            got_consv = (None if conserved[vi, gi] < 0
                         else var.alleles[conserved[vi, gi]])
            if want_consv != got_consv:
                mismatches.append((var.pos, g, "conserved",
                                   want_consv, got_consv))
            want_diag = host.diagnostic[g]
            got_diag = (None if diagnostic[vi, gi] < 0
                        else var.alleles[diagnostic[vi, gi]])
            if want_diag != got_diag:
                mismatches.append((var.pos, g, "diagnostic",
                                   want_diag, got_diag))
    assert not mismatches, mismatches[:10]


def test_packed_output_matches_unpacked(synth_vcf):
    """classify_batch_packed is the same kernel with a one-array epilogue:
    unpacking its columns must reproduce classify_batch exactly."""
    from krisp_tpu.ops.vcfclass import classify_batch_packed

    meta, _, vcf = synth_vcf
    groups = parse_group_data(meta, groups=GROUPS)
    variants = list(itertools.islice(VcfReader(vcf), 400))
    arrays, group_names, _ = build_batch(variants, groups)
    G = len(group_names)
    out = classify_batch(n_groups=G, **arrays, **KW)
    packed = np.asarray(classify_batch_packed(n_groups=G, **arrays, **KW))

    V, _, A = arrays["ad"].shape
    assert packed.shape == (V, G * (A + 3))
    np.testing.assert_array_equal(packed[:, :G],
                                  np.asarray(out["sample_counts"]))
    np.testing.assert_array_equal(packed[:, G:2 * G],
                                  np.asarray(out["conserved"]))
    np.testing.assert_array_equal(packed[:, 2 * G:3 * G],
                                  np.asarray(out["diagnostic"]))
    np.testing.assert_array_equal(packed[:, 3 * G:].reshape(V, G, A),
                                  np.asarray(out["allele_counts"]))


def test_numpy_mirror_matches_jax_kernel(synth_vcf):
    """classify_batch_packed_numpy (the scan's path when there is no
    accelerator) is bit-identical to the jax kernel: on a seeded cohort
    slice AND on adversarial random batches (missing data, multiallelics,
    NaN-sentinel quals, empty groups)."""
    from krisp_tpu.ops.vcfclass import (classify_batch_packed,
                                        classify_batch_packed_numpy)

    meta, _, vcf = synth_vcf
    groups = parse_group_data(meta, groups=GROUPS)
    variants = list(itertools.islice(VcfReader(vcf), 400))
    arrays, group_names, _ = build_batch(variants, groups)
    G = len(group_names)
    want = np.asarray(classify_batch_packed(n_groups=G, **arrays, **KW))
    got = classify_batch_packed_numpy(n_groups=G, **arrays, **KW)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)

    rng = np.random.default_rng(11)
    for trial in range(6):
        V = int(rng.integers(1, 80))
        S = int(rng.integers(1, 40))
        A = int(rng.integers(1, 6))
        G = int(rng.integers(1, 5))
        arr = dict(
            dp=rng.integers(-1, 40, (V, S)).astype(np.int32),
            gq=rng.integers(-1, 99, (V, S)).astype(np.int32),
            ad=rng.integers(0, 25, (V, S, A)).astype(np.int32),
            n_alleles=rng.integers(1, A + 1, V).astype(np.int32),
            mq=np.where(rng.random(V) < 0.1, -1.0,
                        rng.uniform(0, 60, V)).astype(np.float32),
            qual=np.where(rng.random(V) < 0.1, -1.0,
                          rng.uniform(0, 100, V)).astype(np.float32),
            group_id=(rng.integers(-1, G, S)).astype(np.int32),
            group_sizes=rng.integers(1, 10, G).astype(np.int32),
        )
        kw = dict(min_samples=int(rng.integers(1, 4)),
                  min_reads=int(rng.integers(1, 12)),
                  min_geno_qual=int(rng.integers(0, 50)),
                  min_freq=float(rng.uniform(0, 0.4)),
                  min_map_qual=int(rng.integers(0, 45)),
                  min_var_qual=int(rng.integers(0, 15)),
                  min_samp_prop=float(rng.uniform(0, 1)))
        want = np.asarray(classify_batch_packed(n_groups=G, **arr, **kw))
        got = classify_batch_packed_numpy(n_groups=G, **arr, **kw)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
