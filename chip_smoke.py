#!/usr/bin/env python3
"""End-to-end bring-up check of krisp_fasta, kstream and krisp_vcf on a GPU.

One process drives the card.  Every phase runs a command-line tool through
its ``main(argv)`` on inputs generated from fixed seeds by the repository's
own generators, checks the output against an independent expectation, and
prints one line: the engine or route that ran, the input size, wall and
compile seconds, the device's ``peak_bytes_in_use`` so far, and whether the
output matched.  The last line is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

It is printed only when every phase passed; any failure exits non-zero.

    python chip_smoke.py                 # one card: phases 1-6
    python chip_smoke.py --four          # four cards: --devices 1 vs 4
    python chip_smoke.py --size 2000000  # smaller genomes (quick check)

Phases (one card):
  1. spacer search (25/1/2) over 2 ingroup + 3 outgroup genomes, fused
     device program; rows equal the planted diagnostic sites
  2. the same search through the staged out-of-core path (>= 2 global
     passes); CSV byte-identical to phase 1
  3. amplicon search (30/40/30) with primer design on 4 worker processes;
     rows equal the planted sites that get a primer pair
  4. kstream, k=28 and k=40, device engine vs host engine: equal sha256
  5. krisp_vcf, device engine vs host engine: byte-identical CSV and
     alignment; the device classification kernels equal the numpy mirror
  6. a profiler trace of phase 1's device program: device time and bytes
     moved by window-key extraction and the survivor scan
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

SPACER = (25, 1, 2)
AMPLICON = (30, 40, 30)
N_INGROUP, N_OUTGROUP = 2, 3
SITE_EVERY = 1_000_000      # one planted spacer site per Mb
VCF_SAMPLES = 100

#: published peak device-memory bandwidth, bytes/s, by device_kind
#: substring (NVIDIA's H100 SXM data sheet)
HBM_PEAK = {"H100": 3.35e12}

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


class CompileClock:
    """Sums JAX's tracing, lowering and backend-compile durations (a
    persistent-cache hit counts as its load time)."""

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, event, duration, **_kwargs):
        if event in _COMPILE_EVENTS:
            self.seconds += duration


def _tools_on_path():
    tools = str(REPO / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)


def _sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def _csv_rows(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    return lines[0], [tuple(line.split(",")[:3]) for line in lines[1:]]


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


class Phase:
    """Times one phase and collects the fields of its report line."""

    def __init__(self, name, clock):
        self.name = name
        self.clock = clock
        self.fields = {}
        self.ok = True

    def check(self, cond, what):
        if not cond:
            self.ok = False
            self.fields.setdefault("failed", []).append(what)
        return cond

    @contextlib.contextmanager
    def timed(self):
        from krisp_tpu.metrics import GLOBAL as METRICS
        METRICS.reset()
        c0 = self.clock.seconds
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.fields["wall_s"] = round(time.perf_counter() - t0, 3)
            self.fields["compile_s"] = round(self.clock.seconds - c0, 3)
            self.fields["peak_bytes_in_use"] = _peak_bytes()
            self.fields["stages"] = {n: round(s.seconds, 3) for n, s
                                     in METRICS.stages.items()}

    def line(self) -> str:
        return (f"phase {self.name}: match={self.ok} "
                + json.dumps(self.fields, sort_keys=True))


# ---------------------------------------------------------------- inputs

def make_fasta_inputs(root: Path, size: int, geom, site_every: int):
    """Planted-site genomes; returns (ingroup, outgroup, expected rows)."""
    _tools_on_path()
    from make_bigscale_fasta import expected_rows, make_genomes, \
        planted_windows

    out = root / f"genomes_{'_'.join(map(str, geom))}"
    paths, _ = make_genomes(str(out), size, n_ingroup=N_INGROUP,
                            n_outgroup=N_OUTGROUP, site_every=site_every,
                            geom=geom)
    win, _, diag = planted_windows(size // site_every, geom)
    return (paths[:N_INGROUP], paths[N_INGROUP:],
            expected_rows(geom, win, diag))


def _geom_args(geom):
    left, mid, right = geom
    if left == right:
        return ["--conserved", str(left), "--amplicon", str(left + mid + right)]
    return ["--conserved-left", str(left), "--conserved-right", str(right),
            "--diagnostic", str(mid)]


def run_krisp_fasta(ingroup, outgroup, geom, out_csv, extra=()):
    from krisp_tpu.cli import krisp_fasta
    argv = [*ingroup, "--outgroup", *outgroup, *_geom_args(geom),
            "--devices", "1", "--out_csv", str(out_csv), *extra]
    rc = krisp_fasta.main(argv)
    if rc not in (0, None):
        raise RuntimeError(f"krisp_fasta exited {rc}")


# ---------------------------------------------------------------- phases

def phase_spacer_fused(root, inputs, size, clock):
    """Phase 1: the fused device program; rows == planted sites."""
    from krisp_tpu.engine.pipeline import fused_budget
    from krisp_tpu.metrics import GLOBAL as METRICS

    ingroup, outgroup, expected = inputs
    ph = Phase("1 spacer fused", clock)
    out = root / "spacer_fused.csv"
    with ph.timed():
        run_krisp_fasta(ingroup, outgroup, SPACER, out)
    fused = ("device_pipeline" in METRICS.stages
             and "global_pass" not in METRICS.stages)
    _, rows = _csv_rows(out)
    ph.fields.update(route="fused" if fused else "staged",
                     genomes=len(ingroup) + len(outgroup), bases_each=size,
                     rows=len(rows), expected_rows=len(expected),
                     fused_budget_bytes=fused_budget())
    ph.check(fused, "fused device program ran")
    ph.check(set(rows) == expected and len(rows) == len(expected),
             "rows == planted diagnostic sites")
    return ph, out


def phase_spacer_staged(root, inputs, fused_csv, clock):
    """Phase 2: the staged path over the same inputs, >= 2 global
    passes; CSV byte-identical to the fused run."""
    from krisp_tpu.io.fasta import load_buffer
    from krisp_tpu.metrics import GLOBAL as METRICS

    ingroup, outgroup, _ = inputs
    windows = sum(2 * load_buffer(p).size for p in ingroup + outgroup)
    ph = Phase("2 spacer staged", clock)
    out = root / "spacer_staged.csv"
    workdir = root / "tables"
    old = os.environ.get("KRISP_TPU_GLOBAL_ROWS")
    # a third of the table per pass: the staged path's own budget would
    # hold the whole table in one pass on a large card
    os.environ["KRISP_TPU_GLOBAL_ROWS"] = str(max(windows // 3, 1 << 16))
    try:
        with ph.timed():
            run_krisp_fasta(ingroup, outgroup, SPACER, out,
                            ["--workdir", str(workdir)])
    finally:
        if old is None:
            os.environ.pop("KRISP_TPU_GLOBAL_ROWS", None)
        else:
            os.environ["KRISP_TPU_GLOBAL_ROWS"] = old
    passes = METRICS.stages.get("global_pass")
    n_passes = passes.calls if passes else 0
    ph.fields.update(route="staged", global_passes=n_passes,
                     windows=windows)
    ph.check(n_passes >= 2, ">= 2 global passes")
    ph.check(_sha256(out) == _sha256(fused_csv),
             "CSV byte-identical to phase 1")
    return ph


def _primer_expectation(expected, geom):
    """The planted windows that get a primer pair from the host design
    engine with krisp_fasta's default settings."""
    from krisp_tpu.cli.krisp_fasta import parse_args
    from krisp_tpu.thermo.design import run_primer3

    a = parse_args(["x", "--primer3"])
    p3 = dict(tm=tuple(a.tm), gc=tuple(a.gc), amp_size=tuple(a.amp_size),
              primer_size=tuple(a.primer_size), max_sec_tm=a.max_sec_tm,
              gc_clamp=a.gc_clamp, max_end_gc=a.max_end_gc)
    keep = set()
    for left, mid, right in expected:
        res = run_primer3(left + mid + right, target_start=len(left),
                          target_len=len(mid), **p3)
        if res["PRIMER_PAIR_NUM_RETURNED"] != 0:
            keep.add((left, mid, right))
    return keep


def phase_amplicon(root, size, site_every, clock, cores=4):
    """Phase 3: wide-key prefilter + primer design on worker processes;
    rows == planted sites that get a primer pair."""
    from krisp_tpu.metrics import GLOBAL as METRICS

    ingroup, outgroup, expected = make_fasta_inputs(root, size, AMPLICON,
                                                    site_every)
    ph = Phase("3 amplicon primer3", clock)
    out = root / "amplicon.csv"
    aln = root / "amplicon.aln"
    with ph.timed():
        run_krisp_fasta(ingroup, outgroup, AMPLICON, out,
                        ["--primer3", "--out_align", str(aln),
                         "--cores", str(cores)])
    want = _primer_expectation(expected, AMPLICON)
    header, rows = _csv_rows(out)
    fused = ("device_pipeline" in METRICS.stages
             and "global_pass" not in METRICS.stages)
    ph.fields.update(route="fused prefilter + host thermo",
                     workers=cores, bases_each=size,
                     planted_rows=len(expected), rows=len(rows),
                     expected_rows=len(want))
    ph.check(fused, "fused device program ran")
    ph.check("left_sequence" in header.split(","), "primer columns")
    ph.check(set(rows) == want and len(rows) == len(want),
             "rows == planted sites with a primer pair")
    ph.check(aln.stat().st_size > 0 or not want, "alignment written")
    return ph


def phase_kstream(root, genome, k, clock):
    """Phase 4: kstream device engine vs host engine, equal sha256."""
    from krisp_tpu.cli import kstream
    from krisp_tpu.engine.pipeline import fused_budget
    from krisp_tpu.io.fasta import bucket_size, load_buffer

    ph = Phase(f"4 kstream k={k}", clock)
    digests = {}
    with ph.timed():
        for engine in ("device", "host"):
            out = root / f"kstream_{k}_{engine}.txt"
            t0 = time.perf_counter()
            kstream.main([str(genome), "--kmers", str(k), "--disallow", "Nn",
                          "--canonicals", "--sort", "--engine", engine,
                          "--devices", "1", "--output", str(out)])
            ph.fields[f"{engine}_s"] = round(time.perf_counter() - t0, 3)
            digests[engine] = _sha256(out)
            ph.fields["lines"] = out.stat().st_size // (k + 1)
            out.unlink()
    n = bucket_size(load_buffer(genome).size)
    words = (2 * k + 31) // 32
    est = n * 2 * (words + 1) * 4 * 3
    ph.fields.update(route=("device one-shot" if est <= fused_budget()
                            else "device segmented"),
                     bases=n, sha256=digests["device"][:16])
    ph.check(digests["device"] == digests["host"],
             "device sha256 == host sha256")
    return ph


def make_vcf_inputs(root: Path, records: int, samples: int):
    _tools_on_path()
    from bench_vcf_scaled import synth_scaled
    return synth_scaled(records, samples, out_dir=root / "vcf")


def run_krisp_vcf(meta, ref, vcf, engine, out_csv, out_aln, extra=()):
    from krisp_tpu.cli import krisp_vcf
    krisp_vcf.main([meta, ref, "--vcf", vcf, "--groups", "G1", "G2", "G3",
                    "--min_samples", "3", "--engine", engine,
                    "--devices", "1", "--out_csv", str(out_csv),
                    "--out_align", str(out_aln), *extra])


def _small_layout_numpy(full, n_groups, n_alleles):
    """The int16 small-pull layout (ops/vcfclass.pack_outputs_small)
    derived from the numpy mirror's full layout."""
    import numpy as np
    G, A = n_groups, n_alleles
    ac = full[:, 3 * G:].reshape(-1, G, A)
    bits = np.sum(np.where(ac > 0, 1 << np.arange(A), 0), axis=2)
    return np.concatenate([full[:, :3 * G], bits], axis=1).astype(np.int16)


def classify_exactness(n_variants=32768, n_samples=100, n_alleles=3,
                       n_groups=3, seed=5):
    """Both device classification kernels vs the numpy mirror on one batch
    of random calls; returns (full equal, small equal)."""
    import numpy as np
    from krisp_tpu.ops.vcfclass import (classify_batch_packed,
                                        classify_batch_packed_numpy,
                                        classify_bits_packed_small,
                                        host_gate_counted_bits)

    rng = np.random.default_rng(seed)
    V, S, A, G = n_variants, n_samples, n_alleles, n_groups
    dp = rng.integers(-1, 60, (V, S)).astype(np.int32)
    gq = rng.integers(-1, 99, (V, S)).astype(np.int32)
    ad = rng.integers(0, 40, (V, S, A)).astype(np.int32)
    ad[rng.random((V, S, A)) < 0.5] = 0
    n_al = rng.integers(1, A + 1, V).astype(np.int32)
    mq = rng.uniform(0, 60, V).astype(np.float32)
    qual = rng.uniform(0, 100, V).astype(np.float32)
    group_id = (np.arange(S, dtype=np.int32) % (G + 1)) - 1
    sizes = np.array([(group_id == g).sum() for g in range(G)], np.int32)
    kw = dict(min_samples=3, min_reads=10, min_geno_qual=40, min_freq=0.1,
              min_map_qual=40, min_var_qual=10, min_samp_prop=0.5)
    ref = classify_batch_packed_numpy(dp, gq, ad, n_al, mq, qual, group_id,
                                      sizes, n_groups=G, **kw)
    full = np.asarray(classify_batch_packed(dp, gq, ad, n_al, mq, qual,
                                            group_id, sizes, n_groups=G,
                                            **kw))
    gate, counted = host_gate_counted_bits(dp, gq, ad, n_al, kw["min_reads"],
                                           kw["min_geno_qual"],
                                           kw["min_freq"])
    small = np.asarray(classify_bits_packed_small(
        gate, counted, mq, qual, group_id, sizes, n_groups=G, n_samples=S,
        n_alleles=A, min_samples=kw["min_samples"],
        min_map_qual=kw["min_map_qual"], min_var_qual=kw["min_var_qual"],
        min_samp_prop=kw["min_samp_prop"]))
    return (bool(np.array_equal(full, ref)),
            bool(np.array_equal(small, _small_layout_numpy(ref, G, A))))


def phase_vcf(root, records, samples, clock, pos=None, batch_shape=None):
    """Phase 5: krisp_vcf device vs host engine, byte-identical outputs;
    both device classification kernels exact against the numpy mirror."""
    from krisp_tpu.vcf.fastscan import _scan_mesh, classify_route
    from krisp_tpu.vcf.parser import VcfOffsetIndex

    meta, ref, vcf = make_vcf_inputs(root, records, samples)
    ph = Phase("5 krisp_vcf", clock)
    extra = [] if pos is None else ["--pos", str(pos[0]), str(pos[1])]
    with ph.timed():
        t0 = time.perf_counter()
        run_krisp_vcf(meta, ref, vcf, "device", root / "vcf_device.csv",
                      root / "vcf_device.aln")
        ph.fields["device_full_s"] = round(time.perf_counter() - t0, 3)
        if pos is not None:
            run_krisp_vcf(meta, ref, vcf, "device",
                          root / "vcf_device_slice.csv",
                          root / "vcf_device_slice.aln", extra)
        t0 = time.perf_counter()
        run_krisp_vcf(meta, ref, vcf, "host", root / "vcf_host.csv",
                      root / "vcf_host.aln", extra)
        ph.fields["host_s"] = round(time.perf_counter() - t0, 3)
        full_eq, small_eq = classify_exactness(
            *(batch_shape or (32768, samples)))
    idx = VcfOffsetIndex(vcf)
    try:
        route = classify_route(idx.columnar(), _scan_mesh())
    finally:
        idx.cleanup()
    dev = "vcf_device" if pos is None else "vcf_device_slice"
    rows = sum(1 for _ in open(root / f"{dev}.csv")) - 1
    ph.fields.update(route=f"device classify: {route}", records=records,
                     samples=samples, compared=("full file" if pos is None
                                                else f"--pos {pos[0]} "
                                                f"{pos[1]}"),
                     rows=rows, classify_full_exact=full_eq,
                     classify_small_exact=small_eq)
    ph.check(_sha256(root / f"{dev}.csv") == _sha256(root / "vcf_host.csv"),
             "CSV byte-identical to host engine")
    ph.check(_sha256(root / f"{dev}.aln") == _sha256(root / "vcf_host.aln"),
             "alignment byte-identical to host engine")
    ph.check(rows > 0, "scan found diagnostic regions")
    ph.check(full_eq, "classify_batch_packed == numpy mirror")
    ph.check(small_eq, "classify_bits_packed_small == numpy mirror")
    return ph


# ---------------------------------------------------------------- trace

def _hlo_scopes(compiled_text: str) -> dict:
    """HLO instruction name -> the op_name metadata (named-scope paths) of
    the instruction and of every computation it calls, space-joined: a
    fusion carries the scopes of the operations fused into it."""
    import re
    header = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*->.*\{\s*$")
    assign = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
    comp_ops, instrs, cur = {}, {}, None
    for line in compiled_text.splitlines():
        h = header.match(line)
        if h:
            cur = h.group(1)
            comp_ops[cur] = []
            continue
        m = assign.match(line)
        if not m:
            continue
        op = re.search(r'op_name="([^"]*)"', line)
        calls = re.findall(r"(?:calls|to_apply)=%?([\w.\-]+)", line)
        instrs[m.group(1)] = (op.group(1) if op else "", calls)
        if op and cur is not None:
            comp_ops[cur].append(op.group(1))
    return {name: " ".join([op] + [s for c in calls
                                   for s in comp_ops.get(c, [])])
            for name, (op, calls) in instrs.items()}


def device_op_times(xplane_path):
    """(module, hlo_op) -> summed device nanoseconds, plus the union of
    device-busy nanoseconds and the traced window, from one trace.
    Device events are those carrying ``hlo_module``/``hlo_op`` stats on a
    ``/device:`` plane (on the CPU backend: on any plane)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(str(xplane_path))
    planes = [p for p in pd.planes if p.name.startswith("/device:")]
    if not planes:
        planes = list(pd.planes)
    times, spans = {}, []
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                mod, op = stats.get("hlo_module"), stats.get("hlo_op")
                if not mod or not op:
                    continue
                key = (str(mod), str(op))
                times[key] = times.get(key, 0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    return times, busy, window


def trace_sample(xplane_path, per_line=3) -> str:
    """Plane and line names of a trace with a few events each and their
    stats: what a reader checks before trusting ``device_op_times``."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(str(xplane_path)).planes:
        out.append(f"plane {plane.name}")
        for line in plane.lines:
            events = list(line.events)
            out.append(f"  line {line.name}: {len(events)} events")
            for ev in events[:per_line]:
                out.append(f"    {ev.name} {ev.duration_ns} ns "
                           f"{dict(ev.stats)}")
    return "\n".join(out) + "\n"


def stage_times(times, scopes_by_module):
    """Device ns per pipeline stage.  Window-key extraction is the whole
    ``extract_keys_packed_in`` program; the global program's ops map to
    their named scope (global_sort, survivor_scan, compaction)."""
    out = {}
    for (mod, op), ns in times.items():
        if "extract_keys_packed_in" in mod:
            stage = "window_keys"
        elif "fused_global_packed" in mod:
            scope = scopes_by_module.get("fused_global_packed", {}).get(op,
                                                                         "")
            # a fusion may span scopes: it goes to the one most of its
            # operations came from
            votes = {s: scope.count(s) for s in ("global_sort",
                                                 "survivor_scan",
                                                 "compaction")}
            best = max(votes, key=votes.get)
            stage = best if votes[best] else "global_other"
        else:
            stage = "other"
        out[stage] = out.get(stage, 0) + ns
    return out


def stage_bytes(n_genomes, padded_bases, n_words):
    """Bytes each stage must move at least, from its shapes.

    window_keys: read the 2-bit codes and validity bits of every genome
    (3/8 byte per base) and write both strands' key words.
    survivor_scan: read the sorted key words and write the keep flag,
    count and group id of every row (1 + 4 + 4 bytes)."""
    n_rows = n_genomes * 2 * padded_bases
    return {"window_keys": n_genomes * padded_bases * 3 // 8
            + n_rows * n_words * 4,
            "survivor_scan": n_rows * n_words * 4 + n_rows * 9}


def copy_rate(n_bytes=1 << 30, reps=5):
    """Bytes/s a large elementwise copy (read + write) reaches on the
    device: the practical ceiling the stage shares are read against."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros(n_bytes // 4, jnp.uint32)
    f = jax.jit(lambda a: a ^ jnp.uint32(1))
    f(x).block_until_ready()
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return 2 * n_bytes / best


def hbm_peak(kind: str):
    for key, peak in HBM_PEAK.items():
        if key in kind:
            return peak
    return None


def phase_trace(root, inputs, clock, trace_dir=None, copy_bytes=1 << 30):
    """Phase 6: one profiler trace of phase 1's device program (warm)."""
    import glob

    import jax
    from krisp_tpu.io.fasta import bucket_size, load_buffer
    from krisp_tpu.ops.encode import KeyLayout

    ingroup, outgroup, _ = inputs
    ph = Phase("6 trace", clock)
    tdir = Path(trace_dir) if trace_dir else root / "trace"
    tdir.mkdir(parents=True, exist_ok=True)
    with ph.timed():
        run_krisp_fasta(ingroup, outgroup, SPACER, root / "traced.csv",
                        ["--profile-dir", str(tdir / "xplane")])
    found = sorted(glob.glob(str(tdir / "xplane" / "**" / "*.xplane.pb"),
                             recursive=True))
    if not ph.check(bool(found), "trace written"):
        return ph
    times, busy, window = device_op_times(found[-1])
    scopes = {}
    from krisp_tpu.ops import intersect
    files = len(ingroup) + len(outgroup)
    layout = KeyLayout(*SPACER, 2, files)
    pad = bucket_size(max(load_buffer(p).size for p in ingroup + outgroup))
    n_win = pad - sum(SPACER) + 1
    keys = tuple(jax.ShapeDtypeStruct((layout.n_words, 2 * n_win),
                                      jax.numpy.uint32)
                 for _ in range(files))
    compiled = intersect.fused_global_packed.lower(
        keys, left=SPACER[0], mid=SPACER[1], right=SPACER[2], bits=2,
        n_files=files, cap=1 << 16).compile()
    scopes["fused_global_packed"] = _hlo_scopes(compiled.as_text())
    stages = stage_times(times, scopes)
    need = stage_bytes(files, n_win, layout.n_words)
    peak = hbm_peak(jax.devices()[0].device_kind)
    report = {}
    for stage, ns in sorted(stages.items()):
        entry = {"device_ms": round(ns / 1e6, 3)}
        if stage in need:
            entry["bytes"] = need[stage]
            if ns:
                rate = need[stage] / (ns / 1e9)
                entry["bytes_per_s"] = round(rate)
                entry["share_of_peak"] = (round(rate / peak, 4) if peak
                                          else "not measured")
        report[stage] = entry
    ph.fields.update(route="fused (traced)", stages_device=report,
                     device_busy_ms=round(busy / 1e6, 3),
                     device_window_ms=round(window / 1e6, 3),
                     hbm_peak_bytes_per_s=peak,
                     copy_bytes_per_s=round(copy_rate(copy_bytes)))
    top = sorted(times.items(), key=lambda kv: -kv[1])[:25]
    (tdir / "trace_sample.txt").write_text(trace_sample(found[-1]))
    (tdir / "trace_summary.json").write_text(json.dumps(
        {"stages": report, "top_ops": [[m, o, ns] for (m, o), ns in top],
         "busy_ns": busy, "window_ns": window}, indent=1))
    ph.check("window_keys" in stages and "survivor_scan" in stages,
             "trace attributes extraction and survivor scan")
    return ph


# ---------------------------------------------------------------- four

def _retries(metrics) -> int:
    stat = metrics.stages.get("exchange_retry")
    return stat.calls if stat else 0


def four_cards(root, size, site_every, records, samples, clock):
    """--devices 1 vs --devices 4 for the three CLIs: byte-identical."""
    from krisp_tpu.cli import kstream
    from krisp_tpu.cli import krisp_fasta
    from krisp_tpu.metrics import GLOBAL as METRICS

    from krisp_tpu.cli import krisp_vcf
    from krisp_tpu.parallel.distributed import mesh_from_env
    from krisp_tpu.vcf.fastscan import classify_route
    from krisp_tpu.vcf.parser import VcfOffsetIndex

    ingroup, outgroup, expected = make_fasta_inputs(root, size, SPACER,
                                                    site_every)
    meta, ref, vcf = make_vcf_inputs(root, records, samples)
    phases = []
    for n in (1, 4):
        ph = Phase(f"four devices={n}", clock)
        retries = {}
        with ph.timed():
            out = root / f"spacer_d{n}.csv"
            krisp_fasta.main([*ingroup, "--outgroup", *outgroup,
                              *_geom_args(SPACER), "--devices", str(n),
                              "--out_csv", str(out)])
            sharded = "device_pipeline_sharded" in METRICS.stages
            retries["spacer"] = _retries(METRICS)
            kst = root / f"kstream_d{n}.txt"
            kstream.main([ingroup[0], "--kmers", "28", "--disallow", "Nn",
                          "--canonicals", "--sort", "--engine", "device",
                          "--devices", str(n), "--output", str(kst)])
            retries["kstream"] = _retries(METRICS) - retries["spacer"]
            kstream_mesh = mesh_from_env()
            krisp_vcf.main([meta, ref, "--vcf", vcf, "--groups", "G1", "G2",
                            "G3", "--min_samples", "3", "--engine", "device",
                            "--devices", str(n), "--out_csv",
                            str(root / f"vcf_d{n}.csv"), "--out_align",
                            str(root / f"vcf_d{n}.aln")])
            idx = VcfOffsetIndex(vcf)
            try:
                vcf_route = classify_route(idx.columnar(), mesh_from_env())
            finally:
                idx.cleanup()
        ph.fields.update(route="sharded" if sharded else "single device",
                         kstream_route=("sharded" if kstream_mesh is not None
                                        else "single device"),
                         vcf_route=vcf_route,
                         exchange_retries=retries,
                         spacer_sha=_sha256(out)[:16],
                         kstream_sha=_sha256(kst)[:16],
                         vcf_sha=_sha256(root / f"vcf_d{n}.csv")[:16],
                         aln_sha=_sha256(root / f"vcf_d{n}.aln")[:16])
        kst.unlink()
        if n == 4:
            ph.check(sharded and kstream_mesh is not None
                     and vcf_route == "sharded", "sharded paths ran")
            one = phases[0].fields
            for key in ("spacer_sha", "kstream_sha", "vcf_sha", "aln_sha"):
                ph.check(ph.fields[key] == one[key], f"{key} equal to 1 card")
        _, rows = _csv_rows(out)
        ph.check(set(rows) == expected, "spacer rows == planted sites")
        phases.append(ph)
    return phases


# ---------------------------------------------------------------- main

def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    return proc.stdout.strip()


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="compare --devices 1 with --devices 4 on four cards")
    ap.add_argument("--size", type=int, default=20_000_000,
                    help="bases per genome (default 20 Mb)")
    ap.add_argument("--records", type=int, default=100_000,
                    help="VCF records (default 100,000)")
    ap.add_argument("--trace-dir", default=None,
                    help="keep phase 6's trace and its summary here")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    import jax

    from krisp_tpu.runtime import setup

    try:
        devices = jax.devices()
    except RuntimeError as exc:
        print(f"no GPU: {exc}", file=sys.stderr)
        return 1
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform}", file=sys.stderr)
        return 1
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"need {want} GPUs, JAX found {len(devices)}", file=sys.stderr)
        return 1
    kind = devices[0].device_kind
    if hbm_peak(kind) is None:
        print(f"no bandwidth peak on record for {kind!r}", file=sys.stderr)
        return 1
    setup()
    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x {kind}, cache "
          f"{jax.config.jax_compilation_cache_dir}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        root = Path(td)
        if args.four:
            phases = four_cards(root, args.size, SITE_EVERY, args.records,
                                VCF_SAMPLES, clock)
            for ph in phases:
                print(ph.line(), flush=True)
        else:
            phases = run_one_card(root, args, clock)
    for ph in phases:
        if not ph.ok:
            print(f"FAILED: phase {ph.name}", file=sys.stderr)
            return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": want}}))
    return 0


def run_one_card(root, args, clock):
    """Phases 1-6, each line printed as it completes.  The order puts the
    smallest device footprint first: ``peak_bytes_in_use`` only grows, so
    a phase's reading is its own whenever it exceeds the earlier ones."""
    phases = []

    def done(ph):
        print(ph.line(), flush=True)
        phases.append(ph)
        return ph

    spacer = make_fasta_inputs(root, args.size, SPACER, SITE_EVERY)
    done(phase_vcf(root, args.records, VCF_SAMPLES, clock))
    for k in (28, 40):
        done(phase_kstream(root, spacer[0][0], k, clock))
    ph, fused_csv = phase_spacer_fused(root, spacer, args.size, clock)
    done(ph)
    done(phase_spacer_staged(root, spacer, fused_csv, clock))
    # ten times the spacer's site density: about one planted window in six
    # gets a primer pair, and the check needs a few dozen
    done(phase_amplicon(root, args.size, SITE_EVERY // 10, clock))
    done(phase_trace(root, spacer, clock, args.trace_dir))
    return phases


if __name__ == "__main__":
    sys.exit(main())
