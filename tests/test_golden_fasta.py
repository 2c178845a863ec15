"""Byte-for-byte golden parity: our krisp_fasta CLI vs. captured reference
outputs (tests/golden/*, generated by running grunwaldlab/krisp on the bundled
test data — see tests/golden/README.md)."""

import glob
from pathlib import Path

import pytest

from krisp_tpu.cli.krisp_fasta import main as krisp_fasta_main

GOLD = Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def genomes(reference_dir):
    """The reference's bundled test genomes: (ingroup, outgroup) paths."""
    data = reference_dir / "test_data" / "krisp_fasta"
    return (sorted(glob.glob(f"{data}/ingroup*.fasta.gz")),
            sorted(glob.glob(f"{data}/outgroup*.fasta.gz")))


def run_cli(tmp_path, args):
    csv = tmp_path / "out.csv"
    align = tmp_path / "out.align.txt"
    krisp_fasta_main(args + ["--out_csv", str(csv), "--out_align", str(align)])
    return csv.read_text(), align.read_text()


def test_spacer_25_1_2(tmp_path, genomes):
    INGROUP, OUTGROUP = genomes
    csv, align = run_cli(tmp_path, INGROUP + ["--outgroup"] + OUTGROUP +
                         ["--conserved-left", "25", "--conserved-right", "2",
                          "--diagnostic", "1"])
    assert csv == (GOLD / "spacer_25_1_2.csv").read_text()
    assert align == (GOLD / "spacer_25_1_2.align.txt").read_text()


def test_spacer_25_1_2_dot(tmp_path, genomes):
    INGROUP, OUTGROUP = genomes
    _, align = run_cli(tmp_path, INGROUP + ["--outgroup"] + OUTGROUP +
                       ["--conserved-left", "25", "--conserved-right", "2",
                        "--diagnostic", "1", "--dot-alignment"])
    assert align == (GOLD / "spacer_25_1_2_dot.align.txt").read_text()


def test_conserved_60mers(tmp_path, genomes):
    INGROUP, OUTGROUP = genomes
    csv, align = run_cli(tmp_path, INGROUP + OUTGROUP +
                         ["--conserved", "30", "--diagnostic", "0"])
    assert csv == (GOLD / "conserved_60.csv").read_text()
    assert align == (GOLD / "conserved_60.align.txt").read_text()


def test_amplicon_100(tmp_path, genomes):
    INGROUP, OUTGROUP = genomes
    csv, align = run_cli(tmp_path, INGROUP + ["--outgroup"] + OUTGROUP +
                         ["--conserved", "30", "--amplicon", "100"])
    assert csv == (GOLD / "amplicon_100.csv").read_text()
    assert align == (GOLD / "amplicon_100.align.txt").read_text()


def test_amplicon_primer3(tmp_path, genomes):
    INGROUP, OUTGROUP = genomes
    """The README's published amplicon+primer3 workload
    (/root/reference/README.md:200-232): 2 revcomp-twin regions, and —
    since r5's selection resolution — the PUBLISHED primer pair with the
    published statistics.  Every published number reproduces except the
    documented LEFT SELF_END_TH carve-out (2.14676 vs 0.0, PARITY.md)."""
    csv, align = run_cli(tmp_path, INGROUP + ["--outgroup"] + OUTGROUP +
                         ["--conserved", "30", "--amplicon", "100",
                          "--primer3", "--dot-alignment"])
    lines = csv.strip().splitlines()
    assert lines[0].startswith("left_seq,diag_seq,right_seq,"
                               "pair_product_size,pair_penalty")
    assert len(lines) == 3  # header + 2 regions
    assert "Forward" in align and "Reverse" in align
    assert "Primer statistics:" in align
    # the published primer rows (README.md:218-220), column for column
    # except SELF_END_TH
    fwd = next(ln for ln in align.splitlines()
               if "CACAAGGACAAGTGCCACTAAACCAG" in ln and "Forward" in ln)
    for v in ("7.74706", "64.24706", "50.0", "4.0"):
        assert v in fwd, (v, fwd)
    rev = next(ln for ln in align.splitlines()
               if "TCGTTCCCATCGACAAGATACTCTC" in ln and "Reverse" in ln)
    for v in ("6.43757", "61.93757", "48.0", "37.5163", "3.2"):
        assert v in rev, (v, rev)
    # the published pair row (README.md:223-225), complete
    pair = next(ln for ln in align.splitlines() if "14.18463" in ln)
    for v in ("94", "84.32116", "22.38359", "62.70608"):
        assert v in pair, (v, pair)


def test_amplicon_primer3_cores(tmp_path, genomes):
    INGROUP, OUTGROUP = genomes
    csv1, _ = run_cli(tmp_path, INGROUP + ["--outgroup"] + OUTGROUP +
                      ["--conserved", "30", "--amplicon", "100", "--primer3"])
    csv2, _ = run_cli(tmp_path, INGROUP + ["--outgroup"] + OUTGROUP +
                      ["--conserved", "30", "--amplicon", "100", "--primer3",
                       "--cores", "2"])
    assert csv1 == csv2
