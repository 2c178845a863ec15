"""Sharded VCF classification vs the single-device kernel — bit-identical
packed outputs for both mesh layouts (variant-parallel and cohort/psum) at
1/2/4/8 virtual devices, including sizes that force padding."""

import itertools

import numpy as np
import pytest

from krisp_tpu.ops.vcfclass import classify_batch_packed
from krisp_tpu.parallel.distributed import make_mesh
from krisp_tpu.parallel.vcf_shard import classify_batch_packed_sharded
from krisp_tpu.vcf.batch import build_batch
from krisp_tpu.vcf.classify import parse_group_data
from krisp_tpu.vcf.parser import VcfReader

KW = dict(min_samples=3, min_reads=10, min_geno_qual=40, min_freq=0.1,
          min_map_qual=40, min_var_qual=10, min_samp_prop=0.9)


def _inputs(meta, vcf, n_variants=301):
    """Synthetic cohort slice — 301 variants (not divisible by any mesh
    size) and 20 samples (not divisible by 8), so both shardings exercise
    their padding."""
    groups = parse_group_data(meta, groups=["G1", "G2", "G3"])
    variants = list(itertools.islice(VcfReader(vcf), n_variants))
    arrays, group_names, _ = build_batch(variants, groups)
    return arrays, group_names


@pytest.fixture(scope="module")
def baseline(synth_vcf):
    meta, _, vcf = synth_vcf
    arrays, group_names = _inputs(meta, vcf)
    ref = np.asarray(classify_batch_packed(
        n_groups=len(group_names), **arrays, **KW))
    return arrays, group_names, ref


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
@pytest.mark.parametrize("shard", ["variants", "samples"])
def test_sharded_bit_identical(baseline, n_devices, shard):
    arrays, group_names, ref = baseline
    assert arrays["dp"].shape[0] % 2 == 1  # padding really exercised
    mesh = make_mesh(n_devices)
    out = np.asarray(classify_batch_packed_sharded(
        mesh, n_groups=len(group_names), shard=shard, **arrays, **KW))
    np.testing.assert_array_equal(out, ref)


def test_sample_shard_odd_cohort(baseline):
    """A cohort of 20 over 8 devices pads 4 ghost samples; they must not
    leak into any count."""
    arrays, group_names, ref = baseline
    assert arrays["dp"].shape[1] % 8 != 0
    mesh = make_mesh(8)
    out = np.asarray(classify_batch_packed_sharded(
        mesh, n_groups=len(group_names), shard="samples", **arrays, **KW))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n_devices", ["2", "8"])
def test_fastscan_typed_stream_sharded(n_devices, monkeypatch, synth_vcf):
    """The full device scan (classification -> window prefilter -> cascade
    tail) yields an identical typed-window stream when its batches run
    sharded over a mesh (KRISP_TPU_DEVICES governs _scan_mesh)."""
    from test_fastscan import KWARGS, _digest
    from krisp_tpu.cli.krisp_vcf import parse_reference
    from krisp_tpu.vcf.fastscan import chunk_rows, find_diag_region_fast
    from krisp_tpu.vcf.parser import VcfOffsetIndex

    meta, ref, vcf = synth_vcf
    idx = VcfOffsetIndex(vcf)
    try:
        col = idx.columnar()
        if col is None:
            pytest.skip("native VCF tokenizer unavailable")
        groups = parse_group_data(meta, groups=["G1", "G2", "G3"],
                                  min_samples=3)
        reference = parse_reference(ref)
        chunk = {"contig": idx.contigs[0][0], "start": 150000, "end": 220000}
        rows = chunk_rows(col, chunk)

        def stream():
            return [_digest(r) for r in find_diag_region_fast(
                col, rows, groups, reference, **KWARGS)]

        monkeypatch.setenv("KRISP_TPU_DEVICES", "1")
        single = stream()
        monkeypatch.setenv("KRISP_TPU_DEVICES", n_devices)
        sharded = stream()
        assert sharded == single
        assert len(single) > 0
    finally:
        idx.cleanup()
