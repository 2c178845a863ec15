"""Byte-for-byte golden parity for krisp_vcf.

Goldens were produced by running the *reference* krisp_vcf implementation in
this environment, with pysam/Bio/primer3 replaced by stubs backed by
krisp_tpu's own VCF parser and thermodynamic engine (tools/refstubs) — so
this test pins exact parity of classification, windowing, the filter
cascade, coordinate math, CSV schema, and the alignment renderer.

PYTHONHASHSEED=0 on both sides: the reference's ``missing_samp_ids`` column
joins a Python set, whose order depends on the interpreter hash seed (the
reference itself is nondeterministic across runs without it).
"""

import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO

GOLD = Path(__file__).parent / "golden"
DATA = Path(__file__).parent / "data"
REF_FASTA = str(DATA / "test_reference.fasta.gz")


@pytest.fixture(scope="module")
def bundled(reference_dir):
    """The reference's bundled cohort (metadata.csv, variants.vcf.gz), the
    input of every golden here (tests/data holds a reference FASTA
    synthesized to match it, tools/make_test_reference.py)."""
    data = reference_dir / "test_data" / "krisp_vcf"
    return str(data / "metadata.csv"), str(data / "variants.vcf.gz")


def test_vcf_golden_parity(tmp_path, bundled):
    META, VCF = bundled
    csv = tmp_path / "out.csv"
    align = tmp_path / "out.align.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "krisp_tpu.cli.krisp_vcf", META, REF_FASTA,
         "--vcf", VCF, "--groups", "NA1", "NA2", "EU1",
         "--pos", "150000", "260000",
         "--out_csv", str(csv), "--out_align", str(align)],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONHASHSEED": "0", "PYTHONPATH": str(REPO),
             "PATH": "/usr/bin:/bin", "COLUMNS": "80"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert csv.read_text() == (GOLD / "vcf_pos150k_260k.csv").read_text()
    assert align.read_text() == (GOLD / "vcf_pos150k_260k.align.txt").read_text()
    # the live status line shows rejection-reason counts on stderr
    assert "Undiagnostic" in proc.stderr


def test_vcf_multicore_matches_serial(tmp_path, synth_vcf):
    """--cores N must produce the same CSV result set as serial (worker
    logs routed through the parent; failure propagation wired)."""
    meta, ref, vcf = synth_vcf

    def run(cores):
        csv = tmp_path / f"out{cores}.csv"
        log = tmp_path / f"log{cores}.txt"
        proc = subprocess.run(
            [sys.executable, "-m", "krisp_tpu.cli.krisp_vcf", meta, ref,
             "--vcf", vcf, "--groups", "G1", "G2", "G3", "--engine", "host",
             "--pos", "150000", "220000", "--cores", str(cores),
             "--log", str(log), "--out_csv", str(csv)],
            capture_output=True, text=True, timeout=600,
            env={"PYTHONHASHSEED": "0", "PYTHONPATH": str(REPO),
                 "PATH": "/usr/bin:/bin", "COLUMNS": "80"})
        assert proc.returncode == 0, proc.stderr[-2000:]
        lines = csv.read_text().splitlines()
        return lines[0], sorted(lines[1:]), log.read_text()

    h1, serial, _ = run(1)
    h2, parallel, log_text = run(2)
    assert h1 == h2
    assert serial == parallel
    assert "Starting scan of chunk" in log_text  # worker logs reached parent


def test_vcf_device_engine_matches_host(tmp_path, synth_vcf):
    """--engine device (device-batched classification) must reproduce the
    host path byte-for-byte, including rendered alignments."""
    meta, ref, vcf = synth_vcf

    def run(engine):
        csv = tmp_path / f"{engine}.csv"
        align = tmp_path / f"{engine}.align.txt"
        proc = subprocess.run(
            [sys.executable, "-m", "krisp_tpu.cli.krisp_vcf", meta, ref,
             "--vcf", vcf, "--groups", "G1", "G2", "G3",
             "--pos", "150000", "220000", "--engine", engine,
             "--out_csv", str(csv), "--out_align", str(align)],
            capture_output=True, text=True, timeout=600,
            env={"PYTHONHASHSEED": "0", "PYTHONPATH": str(REPO),
                 "PATH": "/usr/bin:/bin", "COLUMNS": "80",
                 "JAX_PLATFORMS": "cpu"})
        assert proc.returncode == 0, proc.stderr[-2000:]
        return csv.read_text(), align.read_text()

    host_csv, host_align = run("host")
    dev_csv, dev_align = run("device")
    assert dev_csv == host_csv
    assert dev_align == host_align
    assert len(host_csv.splitlines()) > 1


def test_vcf_full_file_golden(tmp_path, bundled):
    META, VCF = bundled
    """Whole-file scan (all 10k records, no --pos): the reference's
    default workload shape (krisp_vcf.py:1378-1388)."""
    csv = tmp_path / "out.csv"
    align = tmp_path / "out.align.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "krisp_tpu.cli.krisp_vcf", META, REF_FASTA,
         "--vcf", VCF, "--groups", "NA1", "NA2", "EU1",
         "--out_csv", str(csv), "--out_align", str(align)],
        capture_output=True, text=True, timeout=900,
        env={"PYTHONHASHSEED": "0", "PYTHONPATH": str(REPO),
             "PATH": "/usr/bin:/bin", "COLUMNS": "80"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert csv.read_text() == (GOLD / "vcf_full.csv").read_text()
    assert align.read_text() == (GOLD / "vcf_full.align.txt").read_text()


def test_vcf_stdin_pipe_golden(tmp_path, bundled):
    META, VCF = bundled
    """VCF streamed over stdin (no --vcf: the reference's default source,
    krisp_vcf.py:928-929) must produce the whole-file output byte-for-
    byte — the reference oracle's stdin run equals its file run."""
    import gzip
    csv = tmp_path / "out.csv"
    align = tmp_path / "out.align.txt"
    with gzip.open(VCF, "rb") as fh:
        vcf_text = fh.read()
    proc = subprocess.run(
        [sys.executable, "-m", "krisp_tpu.cli.krisp_vcf", META, REF_FASTA,
         "--groups", "NA1", "NA2", "EU1",
         "--out_csv", str(csv), "--out_align", str(align)],
        input=vcf_text, capture_output=True, timeout=900,
        env={"PYTHONHASHSEED": "0", "PYTHONPATH": str(REPO),
             "PATH": "/usr/bin:/bin", "COLUMNS": "80"})
    assert proc.returncode == 0, proc.stderr[-2000:].decode()
    assert csv.read_text() == (GOLD / "vcf_full.csv").read_text()
    assert align.read_text() == (GOLD / "vcf_full.align.txt").read_text()


def test_vcf_chroms_golden(tmp_path, bundled):
    META, VCF = bundled
    """--chroms contig selection combined with --pos — byte parity
    against the reference oracle."""
    csv = tmp_path / "out.csv"
    align = tmp_path / "out.align.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "krisp_tpu.cli.krisp_vcf", META, REF_FASTA,
         "--vcf", VCF, "--groups", "NA1", "NA2", "EU1",
         "--chroms", "Phyram_PR-102_s0001", "--pos", "260000", "400000",
         "--out_csv", str(csv), "--out_align", str(align)],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONHASHSEED": "0", "PYTHONPATH": str(REPO),
             "PATH": "/usr/bin:/bin", "COLUMNS": "80"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert csv.read_text() == (GOLD / "vcf_chroms_260k_400k.csv").read_text()
    assert align.read_text() == \
        (GOLD / "vcf_chroms_260k_400k.align.txt").read_text()


def test_vcf_custom_knobs_golden(tmp_path, bundled):
    META, VCF = bundled
    """Non-default geometry/quality knobs (README.md:414-417 style) —
    byte parity against the reference oracle."""
    csv = tmp_path / "out.csv"
    align = tmp_path / "out.align.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "krisp_tpu.cli.krisp_vcf", META, REF_FASTA,
         "--vcf", VCF, "--groups", "NA1", "NA2", "EU1",
         "--pos", "150000", "260000", "--amp_size", "50", "120",
         "--gc_clamp", "2", "--min_samples", "4", "--crrna_len", "30",
         "--var_location", "5", "16",
         "--out_csv", str(csv), "--out_align", str(align)],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONHASHSEED": "0", "PYTHONPATH": str(REPO),
             "PATH": "/usr/bin:/bin", "COLUMNS": "80"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert csv.read_text() == (GOLD / "vcf_custom_knobs.csv").read_text()
    assert align.read_text() == (GOLD / "vcf_custom_knobs.align.txt").read_text()
