#!/usr/bin/env python3
"""Scaled krisp_vcf throughput benchmark: 100k records x 100 samples.

Measures variants/s through the full CLI scan for:
  - the reference implementation (grunwaldlab/krisp running on this
    framework's parser/thermo via tools/refstubs; htslib unavailable here)
    on a --pos slice (it is too slow for the full file),
  - krisp_tpu --engine host (same slice + full file),
  - krisp_tpu --engine device (columnar + batched device classification +
    vectorized window prefilter) on the full file.

Also asserts CSV equality across all three on the shared slice.

Usage: python tools/bench_vcf_scaled.py [--records 100000] [--samples 100]
"""

import argparse
import gzip
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / "tools" / ".bench_data"


def synth_scaled(n_records, n_samples, seed=0, n_contigs=1, out_dir=None):
    """Generate (meta, ref_fasta, vcf_gz) under ``out_dir`` (default
    CACHE), reusing if present.

    Scenario mix tuned for realistic scan behavior: mostly conserved
    reference calls, a few percent group-specific fixed differences
    (diagnostic candidates), some low-quality/missing blocks, occasional
    indels and multiallelics.  ``n_contigs`` > 1 splits the records
    across contigs (the GB-scale layout: per-contig columnar slices
    bound scan memory by the contig block).  Planted diagnostic-candidate
    rows are recorded in planted.npz next to the VCF (contig index, pos,
    group) for survivor verification."""
    tag = f"r{n_records}_s{n_samples}_v3_{seed}" \
        + (f"_c{n_contigs}" if n_contigs > 1 else "")
    out = Path(out_dir or CACHE) / tag
    meta = out / "meta.csv"
    ref_fa = out / "ref.fasta"
    vcf = out / "vars.vcf.gz"
    if vcf.exists() and (out / "planted.npz").exists():
        return str(meta), str(ref_fa), str(vcf)
    out.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)
    n_groups = 4
    per = n_samples // n_groups
    groups = {f"G{g+1}": [f"g{g+1}s{i}" for i in range(per)]
              for g in range(n_groups)}
    meta.write_text("sample_id,group\n" + "".join(
        f"{s},{g}\n" for g, ss in groups.items() for s in ss))

    gaps = rng.integers(10, 50, n_records)
    # records split evenly across contigs; positions restart per contig
    per_ctg = -(-n_records // n_contigs)
    ctg_of = np.arange(n_records) // per_ctg
    pos = np.empty(n_records, np.int64)
    ctg_names = []
    ctg_seqs = []
    with open(ref_fa, "w") as fh:
        for c in range(n_contigs):
            sl = slice(c * per_ctg, min((c + 1) * per_ctg, n_records))
            if sl.start >= n_records:
                break
            pos[sl] = np.cumsum(gaps[sl]) + 50
            contig_len = int(pos[sl][-1]) + 500
            seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), contig_len)
            name = "ctg1" if n_contigs == 1 else f"ctg{c + 1}"
            ctg_names.append(name)
            ctg_seqs.append(seq)
            fh.write(f">{name}\n")
            s = seq.tobytes().decode()
            for i in range(0, contig_len, 70):
                fh.write(s[i:i + 70] + "\n")

    # canned sample-column strings per (scenario role, n_alts)
    def col(gt, ad, dp, gq):
        return f"{gt}:{ad}:{dp}:{gq}"

    HOMREF = {1: col("0/0", "50,0", 50, 99), 2: col("0/0", "50,0,0", 50, 99)}
    HOMALT = {1: col("1/1", "0,48", 48, 99), 2: col("1/1", "0,48,0", 48, 99)}
    LOWQ = {1: col("0/0", "4,0", 4, 99), 2: col("0/0", "4,0,0", 4, 99)}
    MISS = "./.:.:.:."
    HET = {1: col("0/1", "25,25", 50, 99), 2: col("0/1", "25,25,0", 50, 99)}

    scen = rng.random(n_records)
    n_alts_arr = np.where(rng.random(n_records) < 0.1, 2, 1)
    ref_len = rng.choice([1, 1, 1, 1, 1, 1, 2, 3], n_records)
    diag_group = rng.integers(0, n_groups, n_records)
    alt_base = {0: "A", 1: "C", 2: "G", 3: "T"}

    # precomputed joined sample blocks per (scenario, n_alts): the join
    # over hundreds of identical columns dominated generation at the
    # GB scale, and every scenario's block is record-independent
    join_homref = {na: "\t".join([HOMREF[na]] * n_samples) for na in (1, 2)}
    join_het = {na: "\t".join([HET[na]] * n_samples) for na in (1, 2)}
    join_lowq = {na: "\t".join([LOWQ[na]] * (n_samples // 2)
                               + [HOMREF[na]]
                               * (n_samples - n_samples // 2))
                 for na in (1, 2)}
    join_miss = "\t".join([MISS] * n_samples)
    join_diag = {(g, na): "\t".join(
        sum(([HOMALT[na] if gi == g else HOMREF[na]] * per
             for gi in range(n_groups)), []))
        for g in range(n_groups) for na in (1, 2)}

    planted = []  # (contig_index, pos, group_index) of diag candidates
    t0 = time.perf_counter()
    with gzip.open(vcf, "wt", compresslevel=1) as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(s for ss in groups.values() for s in ss) + "\n")
        for i in range(n_records):
            c = int(ctg_of[i])
            seq = ctg_seqs[c]
            p = int(pos[i])
            rl = int(ref_len[i])
            ref_allele = seq[p - 1:p - 1 + rl].tobytes().decode()
            na = int(n_alts_arr[i])
            alts = []
            while len(alts) < na:
                a = alt_base[rng.integers(0, 4)] * (1 if rl == 1 else
                                                    int(rng.integers(1, 4)))
                if a != ref_allele and a not in alts:
                    alts.append(a)
            na = len(alts)
            s_val = scen[i]
            if s_val < 0.925:
                joined = join_homref[na]                 # conserved REF
            elif s_val < 0.930:
                # one group fixed ALT: diagnostic candidate (~0.5%, the
                # bundled real VCF's order of magnitude)
                g = int(diag_group[i])
                joined = join_diag[(g, na)]
                planted.append((c, p, g))
            elif s_val < 0.96:
                joined = join_het[na]                    # unconserved
            elif s_val < 0.985:
                joined = join_lowq[na]
            else:
                joined = join_miss                       # no data
            qual = 900 if s_val >= 0.999 or True else 5
            fh.write(f"{ctg_names[c]}\t{p}\t.\t{ref_allele}\t"
                     f"{','.join(alts)}\t{qual}\tPASS\tMQ=60\t"
                     f"GT:AD:DP:GQ\t{joined}\n")
    pl = np.array(planted, np.int64).reshape(-1, 3)
    np.savez(out / "planted.npz", contig=pl[:, 0], pos=pl[:, 1],
             group=pl[:, 2])
    print(f"generated {vcf} in {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)
    return str(meta), str(ref_fa), str(vcf)


def run_cli(module, pythonpath, meta, ref, vcf, out_csv, extra):
    env = {"PYTHONHASHSEED": "0", "PYTHONPATH": pythonpath,
           "PATH": "/usr/bin:/bin", "COLUMNS": "80",
           "HOME": os.environ.get("HOME", "/root")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", module, meta, ref, "--vcf", vcf,
         "--groups", "G1", "G2", "G3", "G4", "--min_samples", "3",
         "--out_csv", out_csv] + extra,
        capture_output=True, text=True, timeout=7200, env=env)
    dt = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", type=int, default=100_000)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--slice-records", type=int, default=10_000,
                    help="records in the --pos slice used for the "
                         "reference oracle and parity check")
    args = ap.parse_args()

    meta, ref_fa, vcf = synth_scaled(args.records, args.samples)
    Path(vcf + ".tbi").touch()  # reference oracle: skip tabix creation
    tmp = CACHE / "out"
    tmp.mkdir(exist_ok=True)

    # slice covering ~slice_records records (avg gap 30)
    slice_hi = args.slice_records * 30 + 50
    n_slice = args.slice_records
    pos_args = ["--pos", "1", str(slice_hi)]

    results = {}

    dt = run_cli("krisp_tpu.cli.krisp_vcf", str(REPO), meta, ref_fa, vcf,
                 str(tmp / "dev_slice.csv"), ["--engine", "device"]
                 + pos_args)
    results["krisp_tpu device (slice, cold)"] = n_slice / dt

    dt = run_cli("krisp_tpu.cli.krisp_vcf", str(REPO), meta, ref_fa, vcf,
                 str(tmp / "host_slice.csv"), ["--engine", "host"]
                 + pos_args)
    results["krisp_tpu host (slice)"] = n_slice / dt

    dt = run_cli("krisp.krisp_vcf.krisp_vcf",
                 f"{REPO}/tools/refstubs:/root/reference/src:{REPO}",
                 meta, ref_fa, vcf, str(tmp / "ref_slice.csv"), pos_args)
    results["reference (slice)"] = n_slice / dt
    ref_vps = results["reference (slice)"]

    # parity on the shared slice
    dev = (tmp / "dev_slice.csv").read_text()
    host = (tmp / "host_slice.csv").read_text()
    refc = (tmp / "ref_slice.csv").read_text()
    assert dev == host, "device CSV != host CSV on slice"
    assert dev == refc, "device CSV != reference CSV on slice"

    dt = run_cli("krisp_tpu.cli.krisp_vcf", str(REPO), meta, ref_fa, vcf,
                 str(tmp / "dev_full.csv"), ["--engine", "device"])
    results["krisp_tpu device (full file)"] = args.records / dt

    for name, vps in results.items():
        print(json.dumps({"metric": "vcf_scan_variants_per_s", "which": name,
                          "value": round(vps, 1),
                          "records": args.records,
                          "samples": args.samples,
                          "vs_reference": round(vps / ref_vps, 2)}))


if __name__ == "__main__":
    main()
