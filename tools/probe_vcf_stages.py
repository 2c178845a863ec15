#!/usr/bin/env python3
"""Stage split of the scaled krisp_vcf device-engine scan (VERDICT r4 #3).

Runs the 100k x 100 synthetic scan under cProfile and aggregates the
flat profile into the pipeline's stage buckets, so PERF.md can carry
a table saying where the host time goes.

Usage: python tools/probe_vcf_stages.py [records] [samples]
"""

from __future__ import annotations

import cProfile
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: bucket -> filename substrings (matched against the flat profile);
#: ordered — first match wins
BUCKETS = [
    ("classify (host masks + device + pull)",
     ["ops/vcfclass", "fastscan.py:157", "jax/", "jaxlib"]),
    ("thermo design (cascade tail)", ["thermo/"]),
    ("window replay + cascade", ["vcf/fastscan", "vcf/region",
                                 "vcf/scan", "io/native_vcf"]),
    ("render/drain + CSV", ["vcf/report", "vcf/printer"]),
    ("parse/index", ["vcf/parser", "io/native"]),
]


def main():
    records = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    samples = int(sys.argv[2]) if len(sys.argv) > 2 else 100

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

    def scan():
        n = 0
        for _ in report_diag_region(idx, None, groups, reference, False,
                                    engine="device", min_samples=3):
            n += 1
        return n

    t0 = time.perf_counter()
    rows = scan()                          # warm (compiles, slice cache)
    print(f"warm-up: {time.perf_counter() - t0:.1f}s, {rows} result rows")
    clear_screen_memos()
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    scan()
    pr.disable()
    wall = time.perf_counter() - t0
    idx.cleanup()

    stats = pstats.Stats(pr)
    agg = {name: 0.0 for name, _ in BUCKETS}
    agg["other"] = 0.0
    total = 0.0
    for (fn_file, _line, _name), (_cc, _nc, tt, _ct, _callers) \
            in stats.stats.items():
        total += tt
        for name, pats in BUCKETS:
            if any(p in fn_file for p in pats):
                agg[name] += tt
                break
        else:
            agg["other"] += tt
    print(f"\nscan wall (profiled): {wall:.2f}s "
          f"-> {records / wall:,.0f} variants/s "
          f"(profiler overhead inflates vs the bench protocol)")
    print(f"{'stage':42s} {'tottime':>8s} {'share':>6s}")
    for name in list(dict(BUCKETS)) + ["other"]:
        print(f"{name:42s} {agg[name]:7.2f}s {100 * agg[name] / total:5.1f}%")


if __name__ == "__main__":
    main()
