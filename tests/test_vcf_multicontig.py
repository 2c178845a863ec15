"""Multi-contig krisp_vcf end-to-end: synthetic two-contig VCF + reference,
byte parity against the reference implementation run live (oracle via
tools/refstubs).  The bundled fixture is single-contig, so this covers the
contig iteration/chunking paths."""

import gzip
import subprocess
import sys

import numpy as np

from conftest import REPO, ref_pythonpath
GROUPS = {"EU1": ["e1", "e2", "e3"], "NA1": ["n1", "n2", "n3"],
          "NA2": ["m1", "m2", "m3"]}
SAMPLES = [s for ss in GROUPS.values() for s in ss]


def synth_inputs(tmp_path):
    rng = np.random.default_rng(5)
    meta = tmp_path / "meta.csv"
    meta.write_text("sample_id,group\n" + "".join(
        f"{s},{g}\n" for g, ss in GROUPS.items() for s in ss))

    contig_len = 8000
    ref_path = tmp_path / "ref.fasta"
    vcf_path = tmp_path / "vars.vcf.gz"
    ref_chunks = []
    records = []
    for chrom in ["ctgA", "ctgB"]:
        seq = rng.choice(list("ACGT"), size=contig_len)
        ref_chunks.append((chrom, "".join(seq)))
        for i, pos in enumerate(range(100, contig_len - 100, 60)):
            ref_base = seq[pos - 1]
            alt = {"A": "G", "G": "A", "C": "T", "T": "C"}[ref_base]
            diag_group = "EU1" if (i % 10 == 4) else None
            cols = []
            for g, ss in GROUPS.items():
                for _ in ss:
                    if diag_group == g:
                        cols.append(f"1/1:0,50:50:99")
                    else:
                        cols.append(f"0/0:50,0:50:99")
            records.append((chrom, pos, ref_base, alt, cols))
    with open(ref_path, "w") as fh:
        for chrom, seq in ref_chunks:
            fh.write(f">{chrom}\n")
            for i in range(0, len(seq), 70):
                fh.write(seq[i:i + 70] + "\n")
    with gzip.open(vcf_path, "wt") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(SAMPLES) + "\n")
        for chrom, pos, ref, alt, cols in records:
            fh.write(f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t900\tPASS\tMQ=60\t"
                     "GT:AD:DP:GQ\t" + "\t".join(cols) + "\n")
    return str(meta), str(ref_path), str(vcf_path)


def run_cli(module_env, meta, ref, vcf, out_dir, tag):
    csv = f"{out_dir}/{tag}.csv"
    align = f"{out_dir}/{tag}.align.txt"
    proc = subprocess.run(
        [sys.executable, "-m", module_env[0], meta, ref, "--vcf", vcf,
         "--groups", "EU1", "NA1", "NA2", "--out_csv", csv,
         "--out_align", align],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONHASHSEED": "0", "PYTHONPATH": module_env[1],
             "PATH": "/usr/bin:/bin", "COLUMNS": "80"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return open(csv).read(), open(align).read()


def test_multicontig_parity(tmp_path, reference_dir):
    meta, ref, vcf = synth_inputs(tmp_path)
    # reference needs a writable dir + index marker (tests/golden/README.md)
    open(vcf + ".tbi", "w").close()
    ref_csv, ref_align = run_cli(
        ("krisp.krisp_vcf.krisp_vcf",
         ref_pythonpath(reference_dir)),
        meta, ref, vcf, str(tmp_path), "ref")
    our_csv, our_align = run_cli(
        ("krisp_tpu.cli.krisp_vcf", str(REPO)),
        meta, ref, vcf, str(tmp_path), "ours")
    assert our_csv == ref_csv
    assert our_align == ref_align
    # sanity: results found on both contigs
    assert "ctgA:" in our_csv and "ctgB:" in our_csv


def test_chroms_subset_parity(tmp_path, reference_dir):
    """--chroms restricts the scan to named contigs (parity with the
    reference's contig_subset path)."""
    meta, ref, vcf = synth_inputs(tmp_path)
    open(vcf + ".tbi", "w").close()

    def run_with_chroms(module, pythonpath, tag):
        csv = f"{tmp_path}/{tag}.csv"
        proc = subprocess.run(
            [sys.executable, "-m", module, meta, ref, "--vcf", vcf,
             "--groups", "EU1", "NA1", "NA2", "--chroms", "ctgB",
             "--out_csv", csv],
            capture_output=True, text=True, timeout=600,
            env={"PYTHONHASHSEED": "0", "PYTHONPATH": pythonpath,
                 "PATH": "/usr/bin:/bin", "COLUMNS": "80"})
        assert proc.returncode == 0, proc.stderr[-2000:]
        return open(csv).read()

    ref_csv = run_with_chroms(
        "krisp.krisp_vcf.krisp_vcf",
        ref_pythonpath(reference_dir), "refc")
    our_csv = run_with_chroms("krisp_tpu.cli.krisp_vcf", str(REPO), "ourc")
    assert our_csv == ref_csv
    assert "ctgB" in our_csv and "ctgA" not in our_csv


def test_unchunked_index_scan_covers_all_contigs(tmp_path):
    """report_diag_region(index, chunk=None) must stream every contig —
    regression: the host/streaming fallback used to fetch only the first
    contig when no chunk was given."""
    from krisp_tpu.vcf.parser import VcfOffsetIndex
    from krisp_tpu.vcf.report import report_diag_region
    from krisp_tpu.vcf.classify import parse_group_data
    from krisp_tpu.cli.krisp_vcf import parse_reference

    meta, ref, vcf = synth_inputs(tmp_path)
    groups = parse_group_data(meta, groups=["EU1", "NA1", "NA2"])
    reference = parse_reference(ref)
    idx = VcfOffsetIndex(vcf)
    try:
        by_engine = {}
        for engine in ("host", "device"):
            by_engine[engine] = [r["result"] for r in report_diag_region(
                idx, None, groups, reference, False, engine=engine,
                min_samples=3)
                if r["result"] is not None]
    finally:
        idx.cleanup()
    regions = ",".join(r["region_id"] for r in by_engine["host"])
    assert "ctgA:" in regions and "ctgB:" in regions
    # both engines yield the identical unchunked result stream
    assert by_engine["device"] == by_engine["host"]


def test_multicontig_device_engine_cli_parity(tmp_path):
    """--engine device on a multi-contig VCF: byte parity with the host
    engine through the full CLI (the device prefilter scans per contig)."""
    meta, ref, vcf = synth_inputs(tmp_path)

    def run_engine(engine, tag):
        csv = f"{tmp_path}/{tag}.csv"
        proc = subprocess.run(
            [sys.executable, "-m", "krisp_tpu.cli.krisp_vcf", meta, ref,
             "--vcf", vcf, "--groups", "EU1", "NA1", "NA2",
             "--engine", engine, "--out_csv", csv],
            capture_output=True, text=True, timeout=600,
            env={"PYTHONHASHSEED": "0", "PYTHONPATH": str(REPO),
                 "PATH": "/usr/bin:/bin", "COLUMNS": "80"})
        assert proc.returncode == 0, proc.stderr[-2000:]
        return open(csv).read()

    host_csv = run_engine("host", "mc_host")
    device_csv = run_engine("device", "mc_device")
    assert device_csv == host_csv
    assert "ctgA:" in device_csv and "ctgB:" in device_csv
