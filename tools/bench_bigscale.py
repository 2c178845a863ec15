"""GB-scale krisp_fasta benchmark: planted-site genomes through the
staged out-of-core path (engine/bigscale.py).

Generates (or reuses) N genomes of --size bases with known diagnostic
sites (tools/make_bigscale_fasta.py), runs the spacer-search pipeline
through the checkpoint/staged path, verifies the survivor set matches the
plant exactly, and prints one JSON line with throughput + out-of-core
telemetry (extraction chunks, global passes, peak RSS).

    python tools/bench_bigscale.py --size 100000000 [--backend cpu|gpu]
    [--dir /tmp/bigscale]       # genomes + table cache persist here
"""

import argparse
import json
import os
import resource
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=100_000_000)
    ap.add_argument("--dir", default="/tmp/bigscale")
    ap.add_argument("--backend", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--fresh-tables", action="store_true",
                    help="drop the table cache first (measure extraction)")
    args = ap.parse_args()

    if args.backend == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
    tools_dir = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(tools_dir))  # repo root
    sys.path.insert(0, tools_dir)
    # persistent compile cache: this workload builds several large
    # programs
    from krisp_tpu.runtime import setup
    setup()
    from make_bigscale_fasta import make_genomes

    gdir = os.path.join(args.dir, f"genomes_{args.size}")
    marker = os.path.join(gdir, ".complete")
    if not os.path.exists(marker):
        t0 = time.time()
        paths, n_diag = make_genomes(gdir, args.size)
        open(marker, "w").write(f"{n_diag}\n")
        print(f"generated {len(paths)} x {args.size} bases in "
              f"{time.time() - t0:.0f}s", file=sys.stderr)
    else:
        n_diag = int(open(marker).read())
        paths = [os.path.join(gdir, f"{n}.fasta")
                 for n in ("ingroup0", "ingroup1",
                           "outgroup0", "outgroup1", "outgroup2")]

    workdir = os.path.join(args.dir, f"tables_{args.size}_{args.backend}")
    if args.fresh_tables and os.path.isdir(workdir):
        import shutil
        shutil.rmtree(workdir)
    os.makedirs(workdir, exist_ok=True)

    from krisp_tpu.engine import render
    from krisp_tpu.engine.pipeline import KmerGeometry, run_pipeline
    from krisp_tpu.metrics import GLOBAL as METRICS

    geom = KmerGeometry(25, 1, 2)
    t0 = time.time()
    groups = run_pipeline(paths[:2], paths[2:], geom, workdir=workdir)
    rows = [render.render_csv(g) for g in groups]
    wall = time.time() - t0

    assert len(rows) == n_diag, (len(rows), n_diag)
    assert all(r.split(",")[1] == "A" for r in rows), rows[:3]

    # windows per genome = 2 strands * (size - L + 1) per record boundary;
    # records are 10 Mb, so subtract (L-1) per record
    import math
    L = geom.total
    recs = math.ceil(args.size / 10_000_000)
    windows = 2 * 5 * (args.size - recs * (L - 1))
    stages = {n: round(s.seconds, 2) for n, s in METRICS.stages.items()}
    passes = METRICS.stages.get("global_pass")
    print(json.dumps({
        "metric": "bigscale_kmers_per_s",
        "value": int(windows / wall),
        "unit": "kmers/s",
        "genome_bases": args.size,
        "n_genomes": 5,
        "windows": windows,
        "wall_s": round(wall, 1),
        "rows": len(rows),
        "global_passes": passes.calls if passes else 1,
        "global_rows": passes.items if passes else None,
        "backend": args.backend,
        "peak_rss_gb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 2),
        "stages": stages,
    }))


if __name__ == "__main__":
    main()
