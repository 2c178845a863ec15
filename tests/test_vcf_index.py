"""VcfOffsetIndex: seek-based chunk fetch equals the streaming fetch.

The index replaces the reference's tabix layer
(/root/reference/src/krisp/krisp_vcf/krisp_vcf.py:1016-1042, 1185-1189) and
round 1's O(chunks x filesize) re-stream per fetch (VERDICT r1 missing #2).
"""

import gzip

import pytest

from krisp_tpu.vcf.parser import VcfReader, VcfOffsetIndex


def digest(var):
    return (var.chrom, var.pos, var.ref, var.alts, var.qual, var.mq,
            tuple((n, s.dp, s.gq, s.ad) for n, s in var.samples.items()))


@pytest.fixture(scope="module")
def vcf_path(synth_vcf):
    return synth_vcf[2]


@pytest.fixture(scope="module")
def index(vcf_path):
    idx = VcfOffsetIndex(vcf_path)
    yield idx
    idx.cleanup()


def test_contigs_match_streaming(index, vcf_path):
    from krisp_tpu.vcf.parser import read_contigs
    assert index.contigs == read_contigs(vcf_path)


@pytest.mark.parametrize("window", [(0, 5000), (49000, 52000),
                                    (99000, 200000), (0, 10 ** 9)])
def test_fetch_equals_streaming_fetch(index, vcf_path, window):
    contig = index.contigs[0][0]
    start, end = window
    got = [digest(v) for v in index.fetch(contig, start, end)]
    want = [digest(v) for v in VcfReader(vcf_path).fetch(contig, start,
                                                         end)]
    assert got == want
    if window == (0, 10 ** 9):
        assert len(got) == index.n_records(contig)


def test_fetch_missing_contig(index):
    assert list(index.fetch("no_such_contig", 0, 100)) == []


def _write_vcf(path, rows):
    head = ("##fileformat=VCFv4.2\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\n")
    body = "".join(
        f"{c}\t{p}\t.\t{ref}\tA\t50\t.\tMQ=40\tGT:DP:GQ:AD\t0/0:20:60:20,0\n"
        for c, p, ref in rows)
    path.write_text(head + body)


def test_interleaved_contigs_fallback(tmp_path):
    """Contigs interleaved in the file (tabix would refuse): the index's
    slow path still returns exactly the right records."""
    p = tmp_path / "inter.vcf"
    rows = [("A", 100, "GG"), ("B", 5, "T"), ("A", 200, "C"), ("B", 50, "T"),
            ("A", 150, "T")]
    _write_vcf(p, rows)
    idx = VcfOffsetIndex(str(p))
    got = [(v.chrom, v.pos) for v in idx.fetch("A", 0, 1000)]
    want = [(v.chrom, v.pos)
            for v in VcfReader(str(p)).fetch("A", 0, 1000)]
    assert got == want == [("A", 100), ("A", 200), ("A", 150)]
    got_b = [(v.chrom, v.pos) for v in idx.fetch("B", 0, 40)]
    assert got_b == [("B", 5)]


def test_long_ref_overlap_before_window(tmp_path):
    """A long-REF record starting before the window but overlapping it must
    be found by the seek path (max_rlen back-off)."""
    p = tmp_path / "span.vcf"
    _write_vcf(p, [("A", 10, "G" * 50), ("A", 100, "C"), ("A", 200, "T")])
    idx = VcfOffsetIndex(str(p))
    got = [v.pos for v in idx.fetch("A", 40, 150)]
    assert got == [10, 100]


def test_plain_text_input_not_copied(tmp_path):
    p = tmp_path / "plain.vcf"
    _write_vcf(p, [("A", 1, "G")])
    idx = VcfOffsetIndex(str(p))
    assert idx.path == str(p)
    idx.cleanup()
    assert p.exists()


def test_gzip_temp_cleanup(tmp_path):
    import os
    p = tmp_path / "z.vcf.gz"
    head = ("##fileformat=VCFv4.2\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\n"
            "A\t1\t.\tG\tA\t50\t.\tMQ=40\tGT:DP:GQ:AD\t0/0:20:60:20,0\n")
    with gzip.open(p, "wt") as fh:
        fh.write(head)
    idx = VcfOffsetIndex(str(p))
    tmp = idx.path
    assert tmp != str(p) and os.path.exists(tmp)
    assert [v.pos for v in idx.fetch("A", 0, 10)] == [1]
    idx.cleanup()
    assert not os.path.exists(tmp)


def test_n_records_in_window_counts(tmp_path):
    """Windowed record-count estimate (engine auto-selection input)."""
    from test_vcf_multicontig import synth_inputs
    from krisp_tpu.vcf.parser import VcfOffsetIndex

    _, _, vcf = synth_inputs(tmp_path)
    idx = VcfOffsetIndex(vcf)
    try:
        n = idx.n_records("ctgA")
        assert idx.n_records_in("ctgA") == n
        assert idx.n_records_in("ctgA", 0, 10**9) == n
        assert idx.n_records_in("missing", 0, 100) == 0
        # records are planted at POS 100,160,...: window [0,100) has none
        # (POS 100 -> 0-based 99 is NOT < 100? it IS: 99 < 100)
        assert idx.n_records_in("ctgA", 0, 100) == 1
        assert idx.n_records_in("ctgA", 0, 99) == 0
        assert idx.n_records_in("ctgA", 99, 160) == 2
        # windows tile the contig -> counts add up
        total = sum(idx.n_records_in("ctgA", s, s + 500)
                    for s in range(0, 9000, 500))
        assert total == n
    finally:
        idx.cleanup()


def _full_state(idx):
    return (idx.samples, idx.max_alleles, idx._file_end, idx._contig_order,
            idx._grouped, idx._max_rlen, idx._max_end, idx._sorted,
            {c: idx._pos[c].tolist() for c in idx._contig_order},
            {c: idx._off[c].tolist() for c in idx._contig_order})


def test_native_index_equals_python_scan(tmp_path, monkeypatch, vcf_path):
    """The kvcf_index C pass must reproduce the Python indexer's state
    field-for-field (gz with decompressed temp copy, plain file, and an
    interleaved-contig layout where grouped=False)."""
    from test_vcf_multicontig import synth_inputs
    import krisp_tpu.io.native_vcf as native_vcf

    _, _, synth_vcf = synth_inputs(tmp_path)
    plain = tmp_path / "interleaved.vcf"
    plain.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\ts2\n"
        "B\t5\t.\tAC\tA\t50\t.\tMQ=40\tGT:DP:GQ:AD\t0:9:40:9,0\t1:9:40:0,9\n"
        "A\t7\t.\tG\tC,T\t50\t.\tMQ=40\tGT:DP:GQ:AD\t0:9:40:9,0,0\t"
        "1:9:40:0,9,0\n"
        "\n"
        "B\t2\t.\tT\t.\t.\t.\t.\tGT:DP:GQ:AD\t0:9:40:9\t0:9:40:9\n")
    for vcf in [vcf_path, str(synth_vcf), str(plain)]:
        assert native_vcf.get_lib() is not None
        nat = VcfOffsetIndex(vcf)
        with monkeypatch.context() as mp:
            mp.setattr(native_vcf, "read_index", lambda *a, **k: None)
            py = VcfOffsetIndex(vcf)
        try:
            assert _full_state(nat) == _full_state(py)
            if nat.path != vcf:  # gz input: decompressed copies byte-equal
                with open(nat.path, "rb") as a, open(py.path, "rb") as b:
                    assert a.read() == b.read()
        finally:
            nat.cleanup()
            py.cleanup()


def test_native_index_crlf_parity(tmp_path, monkeypatch):
    """CRLF line endings: the native pass and the Python scan must agree
    on sample names (no stray carriage returns)."""
    import krisp_tpu.io.native_vcf as native_vcf
    crlf = tmp_path / "crlf.vcf"
    crlf.write_bytes(
        b"##fileformat=VCFv4.2\r\n"
        b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\ts2\r\n"
        b"A\t7\t.\tG\tC\t50\t.\tMQ=40\tGT:DP:GQ:AD\t0:9:40:9,0\t"
        b"1:9:40:0,9\r\n")
    nat = VcfOffsetIndex(str(crlf))
    with monkeypatch.context() as mp:
        mp.setattr(native_vcf, "read_index", lambda *a, **k: None)
        py = VcfOffsetIndex(str(crlf))
    try:
        assert nat.samples == py.samples == ["s1", "s2"]
        assert _full_state(nat) == _full_state(py)
    finally:
        nat.cleanup()
        py.cleanup()


def test_malformed_pos_rejects_loudly(tmp_path):
    """A non-numeric POS must raise (via the Python fallback), never be
    silently indexed as 0 by the native pass."""
    import pytest as _pytest
    bad = tmp_path / "badpos.vcf"
    bad.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\n"
        "A\tXYZ\t.\tG\tC\t50\t.\tMQ=40\tGT\t0\n")
    from krisp_tpu.io.native_vcf import read_index
    assert read_index(str(bad)) is None
    with _pytest.raises(ValueError):
        VcfOffsetIndex(str(bad))


def _full_state_generic(ix):
    return {c: (ix._pos[c].tolist(), ix._off[c].tolist(), ix._sorted[c],
                ix._grouped[c], ix._max_rlen[c], ix._max_end[c])
            for c in ix._contig_order}


def test_index_sidecar_roundtrip(tmp_path, vcf_path):
    """--index: first run writes the sidecar, second run reuses it with
    identical state and fetch results (VERDICT r2 ask #8)."""
    side = tmp_path / "vcf.kidx"
    first = VcfOffsetIndex(vcf_path, sidecar=str(side))
    try:
        assert not first.loaded_from_sidecar
        assert side.exists()
        want_state = _full_state_generic(first)
        contig = first.contigs[0][0]
        want = [v.pos for v in first.fetch(contig, 20_000, 40_000)]
    finally:
        first.cleanup()

    second = VcfOffsetIndex(vcf_path, sidecar=str(side))
    try:
        assert second.loaded_from_sidecar
        assert _full_state_generic(second) == want_state
        assert second.samples == first.samples
        got = [v.pos for v in second.fetch(contig, 20_000, 40_000)]
        assert got == want and len(got) > 0
        # gz input: the decompressed copy persists next to the sidecar
        assert (tmp_path / "vcf.kidx.vcf").exists()
    finally:
        second.cleanup()
    assert (tmp_path / "vcf.kidx.vcf").exists()  # reuse must not delete it


def test_index_sidecar_stale_rebuilds(tmp_path, vcf_path):
    """A touched/changed source invalidates the sidecar."""
    import gzip as _gzip
    import shutil

    src = tmp_path / "v.vcf.gz"
    shutil.copyfile(vcf_path, src)
    side = tmp_path / "v.kidx"
    first = VcfOffsetIndex(str(src), sidecar=str(side))
    first.cleanup()

    with _gzip.open(src, "rb") as fh:
        text = fh.read()
    with _gzip.open(src, "wb") as fh:   # same records, new size/mtime
        fh.write(text)
    second = VcfOffsetIndex(str(src), sidecar=str(side))
    try:
        assert not second.loaded_from_sidecar   # rebuilt, not reused
        assert second.n_records() == first.n_records()
    finally:
        second.cleanup()
