"""Differential fuzzing of krisp_fasta against the live reference CLI
(oracle via tools/refstubs): random genomes with softmasking, N runs, and
IUPAC codes; random geometries; byte parity of CSV and alignment output."""

import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, ref_pythonpath


def synth_genomes(tmp_path, rng, n_files=4, n_seqs=3, size=400):
    paths = []
    shared = ["".join(rng.choice(list("ACGT"), size=90)) for _ in range(2)]
    for f in range(n_files):
        seqs = []
        for s in range(n_seqs):
            chars = rng.choice(list("ACGT") + ["N", "a", "c", "g", "t", "R"],
                               size=size,
                               p=[0.22, 0.22, 0.22, 0.22, 0.02,
                                  0.02, 0.02, 0.02, 0.02, 0.02])
            seqs.append("".join(chars))
        seqs.append(shared[0] + "TT" + shared[1])
        path = tmp_path / f"gen{f}.fasta"
        path.write_text("".join(f">s{i}\n{q}\n" for i, q in enumerate(seqs)))
        paths.append(str(path))
    return paths


def run_cli(module, pythonpath, paths, flags, out_dir, tag):
    csv = f"{out_dir}/{tag}.csv"
    align = f"{out_dir}/{tag}.align.txt"
    cmd = [sys.executable, "-m", module, paths[0], paths[1], "--outgroup",
           *paths[2:], *flags, "--out_csv", csv, "--out_align", align]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env={"PYTHONHASHSEED": "0",
                               "PYTHONPATH": pythonpath,
                               "PATH": "/usr/bin:/bin", "COLUMNS": "80",
                               "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return open(csv).read(), open(align).read()


FLAG_SETS = [
    ["--conserved-left", "20", "--conserved-right", "4", "--diagnostic", "2"],
    ["--conserved", "25", "--diagnostic", "3", "--omit-soft"],
    ["--conserved", "30", "--diagnostic", "0"],
    ["--conserved-left", "18", "--conserved-right", "6", "--diagnostic", "1",
     "--dot-alignment"],
]


FLAG_SETS += [
    # wide-key (amplicon-class) geometries: the prefix-prefilter pipeline
    ["--conserved", "30", "--amplicon", "100"],
    ["--conserved-left", "40", "--conserved-right", "20",
     "--diagnostic", "40", "--dot-alignment"],
]


@pytest.mark.parametrize("seed,flags", [(21, FLAG_SETS[0]), (22, FLAG_SETS[1]),
                                        (23, FLAG_SETS[2]), (24, FLAG_SETS[3]),
                                        (25, FLAG_SETS[4]), (26, FLAG_SETS[5])])
def test_fuzz_fasta_parity(tmp_path, seed, flags, reference_dir):
    rng = np.random.default_rng(seed)
    paths = synth_genomes(tmp_path, rng)
    ref_csv, ref_align = run_cli(
        "krisp.krisp_fasta.krisp_fasta",
        ref_pythonpath(reference_dir),
        paths, flags, str(tmp_path), "ref")
    our_csv, our_align = run_cli(
        "krisp_tpu.cli.krisp_fasta", str(REPO),
        paths, flags, str(tmp_path), "ours")
    assert our_csv == ref_csv
    assert our_align == ref_align
