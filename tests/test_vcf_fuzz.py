"""Differential fuzzing of krisp_vcf against the live reference oracle.

Random VCFs exercising the bug-prone paths SURVEY.md §7.4 calls out: indels
(insertions/deletions), multiallelic sites, missing sample data, low-quality
sites, and near-adjacent variants — full-CLI byte parity per seed.
"""

import gzip
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, ref_pythonpath

GROUPS = {"EU1": ["e1", "e2", "e3", "e4"], "NA1": ["n1", "n2", "n3", "n4"]}
SAMPLES = [s for ss in GROUPS.values() for s in ss]


def synth_fuzz_inputs(tmp_path, seed):
    rng = np.random.default_rng(seed)
    meta = tmp_path / "meta.csv"
    meta.write_text("sample_id,group\n" + "".join(
        f"{s},{g}\n" for g, ss in GROUPS.items() for s in ss))

    contig_len = 6000
    seq = "".join(rng.choice(list("ACGT"), size=contig_len))
    ref_path = tmp_path / "ref.fasta"
    with open(ref_path, "w") as fh:
        fh.write(">ctg1\n")
        for i in range(0, contig_len, 70):
            fh.write(seq[i:i + 70] + "\n")

    def rand_allele(k):
        return "".join(rng.choice(list("ACGT"), size=k))

    records = []
    pos = 60
    while pos < contig_len - 200:
        ref_len = int(rng.choice([1, 1, 1, 2, 3]))  # indel-capable
        ref_allele = seq[pos - 1:pos - 1 + ref_len]
        n_alts = int(rng.choice([1, 1, 1, 2]))
        alts = []
        while len(alts) < n_alts:
            alt_len = int(rng.choice([1, 1, ref_len, ref_len + 1,
                                      max(1, ref_len - 1)]))
            a = rand_allele(alt_len)
            if a != ref_allele and a not in alts:
                alts.append(a)
        qual = int(rng.choice([900, 900, 900, 5]))
        mq = int(rng.choice([60, 60, 60, 10]))
        scenario = rng.random()
        cols = []
        for g, ss in GROUPS.items():
            for _ in ss:
                r = rng.random()
                if r < 0.08:
                    cols.append("./.:.:.:.")          # no data
                elif r < 0.14:
                    ad = ["4"] + ["0"] * n_alts
                    cols.append(f"0/0:{','.join(ad)}:4:99")  # fails DP gate
                elif scenario < 0.35 and g == "EU1":
                    ad = ["0"] * (1 + n_alts)
                    ad[1] = "48"
                    cols.append(f"1/1:{','.join(ad)}:48:99")
                elif scenario < 0.45:
                    # heterozygous-ish mixed depth
                    ad = ["25"] + ["25"] + ["0"] * (n_alts - 1)
                    cols.append(f"0/1:{','.join(ad)}:50:99")
                else:
                    ad = ["50"] + ["0"] * n_alts
                    cols.append(f"0/0:{','.join(ad)}:50:99")
        records.append(("ctg1", pos, ref_allele, ",".join(alts), qual, mq,
                        cols))
        pos += int(rng.integers(25, 90))

    vcf_path = tmp_path / "vars.vcf.gz"
    with gzip.open(vcf_path, "wt") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(SAMPLES) + "\n")
        for chrom, p, ref, alt, qual, mq, cols in records:
            fh.write(f"{chrom}\t{p}\t.\t{ref}\t{alt}\t{qual}\tPASS\t"
                     f"MQ={mq}\tGT:AD:DP:GQ\t" + "\t".join(cols) + "\n")
    return str(meta), str(ref_path), str(vcf_path)


def run_cli(module, pythonpath, meta, ref, vcf, out_dir, tag):
    csv = f"{out_dir}/{tag}.csv"
    align = f"{out_dir}/{tag}.align.txt"
    proc = subprocess.run(
        [sys.executable, "-m", module, meta, ref, "--vcf", vcf,
         "--groups", "EU1", "NA1", "--min_samples", "3",
         "--out_csv", csv, "--out_align", align],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONHASHSEED": "0", "PYTHONPATH": pythonpath,
             "PATH": "/usr/bin:/bin", "COLUMNS": "80"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return open(csv).read(), open(align).read(), proc.stderr


@pytest.mark.parametrize("seed", [11, 12, 13, 14, 15])
def test_fuzz_vcf_parity(tmp_path, seed, reference_dir):
    meta, ref, vcf = synth_fuzz_inputs(tmp_path, seed)
    open(vcf + ".tbi", "w").close()
    ref_csv, ref_align, ref_err = run_cli(
        "krisp.krisp_vcf.krisp_vcf",
        ref_pythonpath(reference_dir),
        meta, ref, vcf, str(tmp_path), "ref")
    our_csv, our_align, our_err = run_cli(
        "krisp_tpu.cli.krisp_vcf", str(REPO),
        meta, ref, vcf, str(tmp_path), "ours")
    assert our_csv == ref_csv
    assert our_align == ref_align


def synth_dense_inputs(tmp_path, seed):
    """Densely packed variants with overlapping reference spans — exercises
    the alignment renderer's overlapping-indel fallback path
    (krisp_vcf.py:1174-1176)."""
    rng = np.random.default_rng(seed)
    meta = tmp_path / "meta.csv"
    meta.write_text("sample_id,group\n" + "".join(
        f"{s},{g}\n" for g, ss in GROUPS.items() for s in ss))
    contig_len = 2500
    seq = "".join(rng.choice(list("ACGT"), size=contig_len))
    (tmp_path / "ref.fasta").write_text(
        ">ctg1\n" + "\n".join(seq[i:i + 70]
                              for i in range(0, contig_len, 70)) + "\n")
    records = []
    pos = 50
    while pos < contig_len - 150:
        ref_len = int(rng.choice([1, 2, 3, 4]))
        ref_allele = seq[pos - 1:pos - 1 + ref_len]
        alt = "".join(rng.choice(list("ACGT"),
                                 size=int(rng.choice([1, 2, ref_len + 2]))))
        if alt == ref_allele:
            alt = alt + "A"
        scenario = rng.random()
        cols = []
        for g, ss in GROUPS.items():
            for _ in ss:
                if scenario < 0.4 and g == "EU1":
                    cols.append("1/1:0,48:48:99")
                else:
                    cols.append("0/0:50,0:50:99")
        records.append(("ctg1", pos, ref_allele, alt, cols))
        pos += int(rng.integers(2, 14))
    vcf_path = tmp_path / "vars.vcf.gz"
    with gzip.open(vcf_path, "wt") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(SAMPLES) + "\n")
        for chrom, p, ref, alt, cols in records:
            fh.write(f"{chrom}\t{p}\t.\t{ref}\t{alt}\t900\tPASS\tMQ=60\t"
                     "GT:AD:DP:GQ\t" + "\t".join(cols) + "\n")
    return str(meta), str(tmp_path / "ref.fasta"), str(vcf_path)


@pytest.mark.parametrize("seed", [700, 701])
def test_dense_overlapping_indels_parity(tmp_path, seed, reference_dir):
    meta, ref, vcf = synth_dense_inputs(tmp_path, seed)
    open(vcf + ".tbi", "w").close()
    ref_csv, ref_align, _ = run_cli(
        "krisp.krisp_vcf.krisp_vcf",
        ref_pythonpath(reference_dir),
        meta, ref, vcf, str(tmp_path), "ref")
    our_csv, our_align, _ = run_cli(
        "krisp_tpu.cli.krisp_vcf", str(REPO),
        meta, ref, vcf, str(tmp_path), "ours")
    assert our_csv == ref_csv
    assert our_align == ref_align


def _random_flags(rng):
    flags = ["--min_samples", str(rng.integers(1, 5))]
    if rng.random() < 0.5:
        flags += ["--min_reads", str(rng.integers(1, 20))]
    if rng.random() < 0.5:
        flags += ["--min_geno_qual", str(rng.integers(10, 60))]
    if rng.random() < 0.4:
        flags += ["--min_freq",
                  str(round(float(rng.uniform(0.05, 0.4)), 2))]
    if rng.random() < 0.4:
        cl = int(rng.integers(20, 36))
        a = int(rng.integers(3, 8))
        b = int(rng.integers(a + 4, cl - 3))
        flags += ["--crrna_len", str(cl), "--var_location", str(a), str(b)]
    if rng.random() < 0.4:
        lo = int(rng.integers(60, 90))
        hi = int(rng.integers(lo + 40, 260))
        flags += ["--amp_size", str(lo), str(hi)]
    if rng.random() < 0.3:
        flags += ["--min_bases", str(rng.integers(1, 3))]
    if rng.random() < 0.3:
        flags += ["--tm", str(rng.integers(45, 55)),
                  str(rng.integers(62, 75))]
    if rng.random() < 0.3:
        s = int(rng.integers(0, 4000))
        flags += ["--pos", str(s), str(s + int(rng.integers(1500, 6000)))]
    if rng.random() < 0.3:
        flags += ["--min_map_qual", str(rng.integers(20, 50))]
    return flags


def _run_cli_flags(module, pythonpath, meta, ref, vcf, out_dir, tag, flags):
    csv = f"{out_dir}/{tag}.csv"
    align = f"{out_dir}/{tag}.align.txt"
    proc = subprocess.run(
        [sys.executable, "-m", module, meta, ref, "--vcf", vcf,
         "--groups", "EU1", "NA1", *flags,
         "--out_csv", csv, "--out_align", align],
        capture_output=True, text=True, timeout=900,
        env={"PYTHONHASHSEED": "0", "PYTHONPATH": pythonpath,
             "PATH": "/usr/bin:/bin", "COLUMNS": "80"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return open(csv).read(), open(align).read()


@pytest.mark.parametrize("seed", [400, 406, 409, 417])
def test_fuzz_vcf_flag_surface(tmp_path, seed, reference_dir):
    """Differential fuzz across the FLAG surface (thresholds, geometry,
    --pos windows), not just defaults — byte parity per (input, flags)
    point.  Seeds picked from a 24-point sweep for flag-set diversity."""
    rng = np.random.default_rng(seed)
    meta, ref, vcf = synth_fuzz_inputs(tmp_path, seed)
    open(vcf + ".tbi", "w").close()
    flags = _random_flags(rng)
    ref_out = _run_cli_flags(
        "krisp.krisp_vcf.krisp_vcf",
        ref_pythonpath(reference_dir),
        meta, ref, vcf, str(tmp_path), "ref", flags)
    our_out = _run_cli_flags(
        "krisp_tpu.cli.krisp_vcf", str(REPO),
        meta, ref, vcf, str(tmp_path), "ours", flags)
    assert our_out == ref_out, flags
