"""Native VCF tokenizer vs. the Python parser — identical columnar data."""

import pytest

from krisp_tpu.io.native_vcf import read_columnar, get_lib
from krisp_tpu.vcf.parser import VcfReader

from conftest import SYNTH_VCF_SHAPE


def test_native_vcf_matches_python_parser(synth_vcf):
    if get_lib() is None:
        pytest.skip("native toolchain unavailable")
    vcf = synth_vcf[2]
    col = read_columnar(vcf, max_alleles=8)
    assert col is not None
    reader = VcfReader(vcf)
    assert col.samples == reader.samples
    n_checked = 0
    for v, var in enumerate(reader):
        if v >= 500:
            break
        assert col.chroms[col.chrom_id[v]] == var.chrom
        assert col.pos[v] == var.pos
        assert col.alleles[v] == var.alleles
        assert col.qual[v] == pytest.approx(var.qual)
        assert col.mq[v] == pytest.approx(var.mq)
        for si, name in enumerate(reader.samples):
            data = var.samples[name]
            assert col.dp[v, si] == (-1 if data.dp is None else data.dp)
            assert col.gq[v, si] == (-1 if data.gq is None else data.gq)
            want_ad = [0 if x is None else x for x in data.ad[:8]]
            want_ad += [0] * (8 - len(want_ad))
            assert col.ad[v, si].tolist() == want_ad
        n_checked += 1
    assert n_checked == 500
    assert col.n_records == SYNTH_VCF_SHAPE[0]


def test_columnar_slice_matches_whole_file_rows(tmp_path):
    """Per-contig ranged loads (memory bounded by the contig block) must
    equal the corresponding rows of the whole-file columnar parse."""
    import numpy as np
    from test_vcf_multicontig import synth_inputs
    from krisp_tpu.vcf.parser import VcfOffsetIndex

    _, _, vcf = synth_inputs(tmp_path)
    idx = VcfOffsetIndex(vcf)
    try:
        assert idx.max_alleles == 2
        full = idx.columnar()
        if full is None:
            pytest.skip("native VCF tokenizer unavailable")
        assert full.ad.shape[2] == idx.max_alleles
        row = 0
        for contig, _ in idx.contigs:
            sl = idx.columnar_slice(contig)
            n = idx.n_records(contig)
            assert sl.n_records == n
            assert [sl.chroms[c] for c in sl.chrom_id] == [contig] * n
            assert np.array_equal(sl.pos, full.pos[row:row + n])
            assert np.array_equal(sl.dp, full.dp[row:row + n])
            assert np.array_equal(sl.gq, full.gq[row:row + n])
            assert np.array_equal(sl.ad, full.ad[row:row + n])
            assert sl.alleles == full.alleles[row:row + n]
            assert sl.samples == full.samples
            row += n
        assert row == full.n_records
    finally:
        idx.cleanup()


def test_ranged_read_empty_and_probe(tmp_path, synth_vcf):
    """A ranged parse yielding zero records returns an empty columnar (not
    a crash on NULL vector data), and native_ok probes one record."""
    from krisp_tpu.vcf.parser import VcfOffsetIndex

    if get_lib() is None:
        pytest.skip("native VCF tokenizer unavailable")
    idx = VcfOffsetIndex(synth_vcf[2])
    try:
        assert idx.native_ok() and idx.native_ok()  # cached second call
        huge = 1 << 40
        col = read_columnar(idx.path, 8, start=huge, end=huge + 10)
        assert col is not None and col.n_records == 0
        assert col.ad.shape == (0, len(idx.samples), 8)
    finally:
        idx.cleanup()


def test_contig_range_bounded_by_resuming_contig(tmp_path):
    """A grouped contig followed by the RESUMPTION of an earlier contig
    must not extend its byte range to EOF (B A B layout)."""
    from krisp_tpu.vcf.parser import VcfOffsetIndex

    vcf = tmp_path / "inter.vcf"
    recs = ([("ctgB", p) for p in (10, 20)]
            + [("ctgA", p) for p in (10, 20, 30)]
            + [("ctgB", p) for p in (30, 40)])
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1"]
    for c, p in recs:
        lines.append(f"{c}\t{p}\t.\tA\tG\t50\tPASS\tMQ=60\tGT:AD:DP:GQ"
                     "\t0/0:9,0:9:99")
    vcf.write_text("\n".join(lines) + "\n")
    idx = VcfOffsetIndex(str(vcf))
    try:
        assert idx._grouped["ctgA"] and not idx._grouped["ctgB"]
        start, end = idx._contig_range("ctgA")
        assert start == int(idx._off["ctgA"][0])
        # ends exactly where ctgB resumes, not at EOF
        assert end == int(idx._off["ctgB"][2])
        if get_lib() is not None:
            sl = idx.columnar_slice("ctgA")
            assert sl.n_records == 3
            assert [sl.chroms[c] for c in sl.chrom_id] == ["ctgA"] * 3
            # non-grouped contig falls back to the whole-file load
            slb = idx.columnar_slice("ctgB")
            assert slb.n_records == 7
    finally:
        idx.cleanup()


def test_native_window_types_matches_python_fuzz():
    """kvcf_window_types == fastscan._window_types on random overlapping
    windows, including negative indel deltas and clustered positions."""
    import numpy as np

    from krisp_tpu.io.native_vcf import window_types_native
    from krisp_tpu.vcf.fastscan import _window_types

    if get_lib() is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(11)
    for trial in range(40):
        V = int(rng.integers(1, 400))
        gaps = rng.integers(0, 6, V)          # dense -> overlapping windows
        starts = np.cumsum(gaps).astype(np.int64)
        rlen = rng.integers(1, 9, V).astype(np.int64)
        ends = starts + rlen - 1
        delta = rng.integers(-4, 7, V).astype(np.int64)
        is_diag = rng.random(V) < 0.3
        is_consv = rng.random(V) < 0.85
        span = int(rng.integers(5, 40))
        min_vars = int(rng.integers(1, 3))
        nt, nj = window_types_native(starts, ends, delta, is_diag,
                                     is_consv, span, min_vars)
        pt, pj = _window_types(starts.tolist(), ends.tolist(),
                               delta.tolist(), is_diag.tolist(),
                               is_consv.tolist(), span, min_vars)
        assert nt.tolist() == pt
        assert nj.tolist() == pj


def test_anchored_parallel_parse_equals_ranged(tmp_path, monkeypatch):
    """The threaded anchored parse (kvcf_read_anchored: per-span direct
    writes into preallocated bulk arrays) must be element-identical to the
    sequential ranged parse, through the public columnar() entry — incl.
    an interleaved-contig file where per-thread chrom interning remaps."""
    import numpy as np
    from krisp_tpu.io.native_vcf import read_columnar
    from krisp_tpu.vcf.parser import VcfOffsetIndex

    rng = np.random.default_rng(7)
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\ts2"]
    posc = {"A": 0, "B": 0, "C": 0}
    for i in range(3000):
        c = ("A", "B", "C")[int(rng.integers(0, 3))]
        posc[c] += int(rng.integers(1, 9))
        ref = "ACGT"[i % 4] * int(rng.integers(1, 3))
        alt = "TGCA"[i % 4]
        lines.append(f"{c}\t{posc[c]}\t.\t{ref}\t{alt}\t50\t.\tMQ=40\t"
                     f"GT:DP:GQ:AD\t0:9:40:9,0\t1:9:40:0,9")
    vcf = tmp_path / "interleaved.vcf"
    vcf.write_text("\n".join(lines) + "\n")

    monkeypatch.setattr(VcfOffsetIndex, "_ANCHOR_MIN_ROWS", 100)
    idx = VcfOffsetIndex(str(vcf))
    try:
        anchors = idx._anchor_points(0, -1)
        assert anchors is not None and len(anchors[0]) >= 3
        A = max(idx.max_alleles, 1)
        anchored = read_columnar(idx.path, A, anchors=anchors)
        ranged = read_columnar(idx.path, A)
        assert anchored.samples == ranged.samples
        assert anchored.chroms == ranged.chroms
        for name in ["pos", "qual", "mq", "n_alleles", "chrom_id", "dp",
                     "gq", "ad", "rlen", "alen"]:
            a, b = getattr(anchored, name), getattr(ranged, name)
            assert np.array_equal(a, b, equal_nan=(a.dtype.kind == "f")), \
                name
        for v in (0, 1499, 2999):
            assert list(anchored.alleles[v]) == list(ranged.alleles[v])
    finally:
        idx.cleanup()


def test_anchored_refuses_gzip_and_falls_back(tmp_path):
    """kvcf_read_anchored would re-inflate the prefix per thread on a gz
    handle, so it refuses gzip inputs; read_columnar falls back to the
    sequential ranged parse transparently."""
    import gzip
    import numpy as np
    from krisp_tpu.io.native_vcf import read_columnar

    body = ("##fileformat=VCFv4.2\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\n"
            + "".join(f"c\t{p}\t.\tA\tG\t50\t.\tMQ=40\tGT:DP:GQ:AD\t"
                      f"0:9:40:9,0\n" for p in range(1, 101)))
    gz = tmp_path / "in.vcf.gz"
    gz.write_bytes(gzip.compress(body.encode()))
    col = read_columnar(str(gz), 2,
                        anchors=([0, len(body)], [0, 100]))
    assert col is not None and col.n_records == 100
    assert np.array_equal(col.pos, np.arange(1, 101))
