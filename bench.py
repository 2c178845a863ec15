#!/usr/bin/env python3
"""Benchmark: k-mers/s through the device sort+intersect engine, plus the
krisp_vcf and kstream verticals.

Prints ONE JSON line::

  {"metric": "kmers_per_s_sort_intersect", "value": N, "unit": "kmers/s",
   "device": {"platform": ..., "kind": ..., "count": ...}, ...}

Every rate is the best of ``REPS`` timed runs after one warm-up run (the
warm-up compiles; its wall time is reported as ``warmup_s``), with the
spread across runs beside it.  A run that finds no GPU exits non-zero.

Workload: 5 synthetic 4 Mb genomes with planted shared spacer regions,
spacer geometry 25/1/2 (the krisp_fasta README example) — the end-to-end
krisp_fasta path minus rendering: window extraction, both strands, per-genome
sort+unique, 5-way intersection; the same genomes in amplicon mode
(30/40/30); a 100k-record x 100-sample VCF scan; kstream over a 2 Mb FASTA.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).parent
N_FILES = int(os.environ.get("KRISP_BENCH_FILES", 5))
GENOME_SIZE = int(os.environ.get("KRISP_BENCH_GENOME_SIZE", 4_000_000))
REPS = 3
LEFT, MID, RIGHT = 25, 1, 2
L = LEFT + MID + RIGHT


def synth_genomes(tmpdir: Path, size: int, seed: int = 7):
    """Write N_FILES synthetic genomes sharing a few planted regions."""
    tmpdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    planted = ["".join(rng.choice(list("ACGT"), size=L)) for _ in range(3)]
    paths = []
    for f in range(N_FILES):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=size)
        seq = bytearray(seq.tobytes())
        for i, p in enumerate(planted):
            pos = (i + 1) * size // (len(planted) + 1)
            seq[pos:pos + L] = p.encode()
        path = tmpdir / f"genome{f}.fasta"
        with open(path, "w") as fh:
            fh.write(f">synthetic_{f}\n")
            s = seq.decode()
            for i in range(0, len(s), 80):
                fh.write(s[i:i + 80] + "\n")
        paths.append(str(path))
    return paths


AMP_LEFT, AMP_MID, AMP_RIGHT = 30, 40, 30   # amplicon mode: L=100, 7-word keys


def timed_reps(fn, reps=REPS):
    """(warm-up seconds, per-rep seconds) of ``fn()``."""
    t0 = time.perf_counter()
    fn()
    warm = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return warm, times


def _spread_pct(samples):
    """(max-min) as a percentage of the best sample."""
    if len(samples) < 2:
        return 0.0
    return round(100.0 * (max(samples) - min(samples)) / max(samples), 1)


def cell(n_items, warm, times):
    rates = [n_items / t for t in times]
    return {"value": round(max(rates)), "samples": [round(r) for r in rates],
            "spread_pct": _spread_pct(rates), "warmup_s": round(warm, 3)}


def run_ours(paths, left=LEFT, mid=MID, right=RIGHT, genome_size=None):
    """The device pipeline end to end; returns (n_keys, warm-up s, rep s)."""
    from krisp_tpu.engine.pipeline import KmerGeometry, run_pipeline

    genome_size = genome_size or GENOME_SIZE
    geom = KmerGeometry(left, mid, right)
    ingroup, outgroup = paths[:2], paths[2:]
    warm, times = timed_reps(lambda: run_pipeline(ingroup, outgroup, geom))
    n_keys = N_FILES * 2 * (genome_size - geom.total + 1)  # both strands
    return n_keys, warm, times


def vcf_scan(records=100_000, samples=100):
    """Device-engine scan of the scaled synthetic VCF."""
    sys.path.insert(0, str(REPO / "tools"))
    from bench_vcf_scaled import synth_scaled
    from krisp_tpu.cli.krisp_vcf import parse_reference
    from krisp_tpu.thermo.design import clear_screen_memos
    from krisp_tpu.vcf.classify import parse_group_data
    from krisp_tpu.vcf.parser import VcfOffsetIndex
    from krisp_tpu.vcf.report import report_diag_region

    meta, ref_fa, vcf = synth_scaled(records, samples)
    groups = parse_group_data(meta)
    reference = parse_reference(ref_fa)
    idx = VcfOffsetIndex(vcf)
    try:
        def scan():
            clear_screen_memos()   # warm = code paths, not memoized answers
            for _ in report_diag_region(idx, None, groups, reference,
                                        False, engine="device",
                                        min_samples=3):
                pass
        warm, times = timed_reps(scan)
    finally:
        idx.cleanup()
    return cell(records, warm, times)


def kstream_rate(tmpdir: Path, plan_kwargs, subdir, size=2_000_000):
    """kstream fast path (engine=auto) over a 2 Mb FASTA."""
    from krisp_tpu.kstream_device import device_plan
    from krisp_tpu.kstream_fast import run_fast_kstream

    paths = synth_genomes(tmpdir / subdir, size)

    class _Sink:
        def write(self, b):
            return len(b)

    plan = device_plan(**plan_kwargs)
    n = run_fast_kstream(paths[0], plan, _Sink())
    if n is None:
        raise RuntimeError("fast kstream fell back to the string pipeline")
    warm, times = timed_reps(lambda: run_fast_kstream(paths[0], plan,
                                                      _Sink()), reps=5)
    return cell(n, warm, times)


def main():
    import tempfile

    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    import jax

    from krisp_tpu.runtime import setup

    try:
        devices = jax.devices()
    except RuntimeError as exc:
        print(f"bench.py needs a GPU: {exc}", file=sys.stderr)
        return 1
    if devices[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 1
    setup()
    out = {"metric": "kmers_per_s_sort_intersect", "unit": "kmers/s",
           "device": {"platform": devices[0].platform,
                      "kind": devices[0].device_kind,
                      "count": len(devices)}}
    with tempfile.TemporaryDirectory() as td:
        tmpdir = Path(td)
        paths = synth_genomes(tmpdir, GENOME_SIZE)
        spacer = cell(*run_ours(paths))
        out["value"] = spacer["value"]
        out["cells"] = {
            "spacer_kmers_per_s": spacer,
            "amplicon_kmers_per_s": cell(*run_ours(paths, AMP_LEFT, AMP_MID,
                                                   AMP_RIGHT)),
            "vcf_variants_per_s": vcf_scan(),
            "kstream_kmers_per_s": kstream_rate(
                tmpdir, dict(kmers=[28], canonicals=True, disallow="Nn",
                             sort=True), "kstream"),
            # the reference's two-stage extraction shape: split columns
            # with a sort on columns 0 and 2 (native v2 core)
            "kstream_split_kmers_per_s": kstream_rate(
                tmpdir, dict(kmers=[28], complements=True, disallow="Nn",
                             split=[25, -2], sort=True, sortcols=[0, 2]),
                "kstream_split"),
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
