#!/usr/bin/env python3
"""VCF-side throughput benchmark: variants/s through the full scan.

Compares:
  - reference implementation (running on this framework's parser + thermo
    engine via tools/refstubs — htslib is unavailable here, so this isolates
    the scan machinery: classification, windowing, cascade)
  - krisp_tpu host engine
  - krisp_tpu --engine device (device-batched classification)

Usage: python tools/bench_vcf.py
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
META = "/root/reference/test_data/krisp_vcf/metadata.csv"
VCF = "/root/reference/test_data/krisp_vcf/variants.vcf.gz"
REF_FASTA = str(REPO / "tests/data/test_reference.fasta.gz")
N_VARIANTS = 10000  # records in the bundled VCF


def run(cmd, env_extra=None):
    env = {"PYTHONHASHSEED": "0", "PATH": "/usr/bin:/bin",
           "COLUMNS": "80", "HOME": os.environ.get("HOME", "/root")}
    env.update(env_extra or {})
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3600,
                          env=env)
    dt = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-2000:]
    return dt


def main():
    import shutil
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        # the reference's tabix bookkeeping needs a writable VCF dir with a
        # pre-existing index marker (see tests/golden/README.md)
        vcf_copy = f"{td}/variants.vcf.gz"
        shutil.copy(VCF, vcf_copy)
        open(vcf_copy + ".tbi", "w").close()
        args = [META, REF_FASTA, "--vcf", VCF,
                "--groups", "NA1", "NA2", "EU1"]
        ref_args = [META, REF_FASTA, "--vcf", vcf_copy,
                    "--groups", "NA1", "NA2", "EU1"]
        t_ref = run([sys.executable, "-m", "krisp.krisp_vcf.krisp_vcf",
                     *ref_args, "--out_csv", f"{td}/ref.csv"],
                    {"PYTHONPATH":
                     f"{REPO}/tools/refstubs:/root/reference/src:{REPO}"})
        t_host = run([sys.executable, "-m", "krisp_tpu.cli.krisp_vcf",
                      *args, "--out_csv", f"{td}/host.csv"],
                     {"PYTHONPATH": str(REPO)})
        t_dev = run([sys.executable, "-m", "krisp_tpu.cli.krisp_vcf",
                     *args, "--engine", "device",
                     "--out_csv", f"{td}/dev.csv"],
                    {"PYTHONPATH": str(REPO)})
        t_cores = run([sys.executable, "-m", "krisp_tpu.cli.krisp_vcf",
                       *args, "--cores", "4",
                       "--out_csv", f"{td}/cores.csv"],
                      {"PYTHONPATH": str(REPO)})
    print(json.dumps({
        "reference_variants_per_s": round(N_VARIANTS / t_ref),
        "krisp_tpu_host_variants_per_s": round(N_VARIANTS / t_host),
        "krisp_tpu_device_variants_per_s": round(N_VARIANTS / t_dev),
        "krisp_tpu_4cores_variants_per_s": round(N_VARIANTS / t_cores),
        "ref_seconds": round(t_ref, 2),
        "host_seconds": round(t_host, 2),
        "device_seconds": round(t_dev, 2),
        "cores4_seconds": round(t_cores, 2),
    }))


if __name__ == "__main__":
    main()
