"""Fast (columnar + device + vectorized prefilter) VCF scan vs host scan.

The fast path must reproduce the host scan's typed-window stream EXACTLY —
same types, same order, same survivors — because the stream drives both the
CSV/alignment output and the status-line statistics (VERDICT r1 item 2).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from krisp_tpu.cli.krisp_vcf import parse_reference
from krisp_tpu.vcf.classify import parse_group_data
from krisp_tpu.vcf.parser import VcfOffsetIndex

from test_vcf_fuzz import synth_fuzz_inputs, synth_dense_inputs

REPO = Path(__file__).resolve().parent.parent
GROUPS = ["G1", "G2", "G3"]

KWARGS = dict(min_samples=3, min_samp_prop=0.9, min_reads=10,
              min_geno_qual=40, min_var_qual=10, min_freq=0.1,
              min_map_qual=40, min_bases=1, crrna_len=28,
              var_location=(6, 14), amp_size=(70, 150))


@pytest.fixture(scope="module")
def bundled(synth_vcf):
    meta, ref, vcf = synth_vcf
    idx = VcfOffsetIndex(vcf)
    col = idx.columnar()
    if col is None:
        idx.cleanup()
        pytest.skip("native VCF tokenizer unavailable")
    groups = parse_group_data(meta, groups=GROUPS, min_samples=3)
    reference = parse_reference(ref)
    yield idx, col, groups, reference
    idx.cleanup()


def _digest(r):
    # rejected windows are flyweights in the fast path: only .type is
    # observable by the report layer; survivors carry full identity
    if r.type == "Diagnostic":
        return (r.type, r.group, tuple(r.crrna_range), tuple(r.temp_range),
                "".join(r.crrna_seq), r.min_bases)
    return (r.type,)


def typed_stream_fast(col, rows, groups, reference):
    from krisp_tpu.vcf.fastscan import find_diag_region_fast
    return [_digest(r)
            for r in find_diag_region_fast(col, rows, groups, reference,
                                           **KWARGS)]


def typed_stream_host(idx, chunk, groups, reference):
    from krisp_tpu.vcf.scan import find_diag_region
    variants = idx.fetch(chunk["contig"], chunk["start"], chunk["end"])
    return [_digest(r)
            for r in find_diag_region(variants, groups, reference, **KWARGS)]


@pytest.mark.parametrize("window", [(150000, 220000), (0, 100000),
                                    (220000, 500000)])
def test_typed_stream_equality(bundled, window):
    idx, col, groups, reference = bundled
    from krisp_tpu.vcf.fastscan import chunk_rows
    chunk = {"contig": idx.contigs[0][0], "start": window[0],
             "end": window[1]}
    fast = typed_stream_fast(col, chunk_rows(col, chunk), groups, reference)
    host = typed_stream_host(idx, chunk, groups, reference)
    assert fast == host
    assert len(fast) > 0


def test_report_batches_equal(bundled, tmp_path):
    """report_diag_region's result/stats batch stream: fast == host."""
    from krisp_tpu.vcf.report import report_diag_region

    idx, col, groups, reference = bundled
    chunk = {"contig": idx.contigs[0][0], "start": 150000, "end": 220000}

    def strip(batches):
        return [(b["result"], dict(b["stats"])) for b in batches]

    fast = strip(report_diag_region(idx, chunk, groups, reference, False,
                                    engine="device", **KWARGS))
    host = strip(report_diag_region(idx, chunk, groups, reference, False,
                                    engine="host", **KWARGS))
    assert fast == host


def _run_cli(meta, ref, vcf, out_dir, tag, engine):
    csv = f"{out_dir}/{tag}.csv"
    align = f"{out_dir}/{tag}.align.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "krisp_tpu.cli.krisp_vcf", meta, ref,
         "--vcf", vcf, "--groups", "EU1", "NA1", "--min_samples", "3",
         "--engine", engine, "--out_csv", csv, "--out_align", align],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONHASHSEED": "0", "PYTHONPATH": str(REPO),
             "PATH": "/usr/bin:/bin", "COLUMNS": "80",
             "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return open(csv).read(), open(align).read()


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_fuzz_device_engine_cli_parity(tmp_path, seed):
    """Synthetic indel/multiallelic/missing-data VCFs: --engine device
    (fast path) must byte-match --engine host through the full CLI."""
    meta, ref, vcf = synth_fuzz_inputs(tmp_path, seed)
    host_csv, host_align = _run_cli(meta, ref, vcf, tmp_path, "h", "host")
    dev_csv, dev_align = _run_cli(meta, ref, vcf, tmp_path, "d", "device")
    assert dev_csv == host_csv
    assert dev_align == host_align


@pytest.mark.parametrize("seed", [700])
def test_dense_overlapping_indels_device_parity(tmp_path, seed):
    meta, ref, vcf = synth_dense_inputs(tmp_path, seed)
    host_csv, host_align = _run_cli(meta, ref, vcf, tmp_path, "h", "host")
    dev_csv, dev_align = _run_cli(meta, ref, vcf, tmp_path, "d", "device")
    assert dev_csv == host_csv
    assert dev_align == host_align


def test_window_replay_matches_reference_deques():
    """Property: the two-pointer window bounds equal a direct simulation of
    the reference's deque algorithm on random position/indel data."""
    from krisp_tpu.vcf.fastscan import _window_types

    rng = np.random.default_rng(3)
    for trial in range(20):
        V = 200
        pos = np.cumsum(rng.integers(0, 12, V)) + 1
        rlen = rng.choice([1, 1, 1, 2, 5, 30], V)
        delta = rng.choice([-3, 0, 0, 0, 1, 4], V)
        starts = (pos - 1).tolist()
        ends = (pos - 1 + rlen - 1).tolist()
        span = int(rng.choice([5, 9, 20]))

        # direct deque simulation (krisp_vcf.py:171-218 semantics)
        from collections import deque
        win = deque()
        want = []
        for e in range(V):
            win.append(e)
            while win:
                idx = list(win)
                length = (max(ends[i] for i in idx)
                          - min(starts[i] for i in idx) + 1
                          + sum(delta[i] for i in idx))
                if length <= span:
                    break
                win.popleft()
            want.append(win[0] if win else e + 1)

        _, jstart = _window_types(starts, ends, delta.tolist(),
                                  [False] * V, [True] * V, span, 1)
        assert jstart == want, f"trial {trial}"


def test_engine_auto_resolution(bundled):
    """'auto' picks host below the record threshold, device above it, and
    passes explicit choices through untouched."""
    from krisp_tpu.vcf import report

    idx, _, _, _ = bundled
    assert idx.n_records() < report.AUTO_DEVICE_MIN_RECORDS
    assert report.resolve_engine(idx, {"engine": "auto"}) == "host"
    assert report.resolve_engine(idx, {"engine": "host"}) == "host"
    assert report.resolve_engine(idx, {"engine": "device"}) == "device"
    # plain path (no index) can never take the columnar fast path
    assert report.resolve_engine("x.vcf", {"engine": "auto"}) == "host"

    class Big(type(idx)):
        def __init__(self):
            pass

        def n_records(self, contig=None):
            return report.AUTO_DEVICE_MIN_RECORDS

    assert report.resolve_engine(Big(), {"engine": "auto"}) == "device"


def test_cli_engine_default_is_auto():
    from krisp_tpu.cli.krisp_vcf import parse_args

    args = parse_args(["meta.csv", "ref.fasta", "--vcf", "vars.vcf.gz"])
    assert args.engine == "auto"


def test_uses_device_fast_path(bundled, synth_vcf):
    """The multicore driver consults the same predicate that gates the
    device scan, so device-engine runs never fork per-chunk workers."""
    from krisp_tpu.vcf.report import uses_device_fast_path

    idx, _, _, _ = bundled
    assert uses_device_fast_path(idx, {"engine": "device"})
    assert not uses_device_fast_path(idx, {"engine": "host"})
    assert not uses_device_fast_path(idx, {"engine": "auto"})  # small file
    assert not uses_device_fast_path(idx, {"engine": "device",
                                           "min_reads": 0})
    assert not uses_device_fast_path(synth_vcf[2], {"engine": "device"})


def test_classify_batches_share_compiled_shapes(bundled):
    """Batches pad to power-of-two buckets: nearby row counts (the typical
    per-chunk variation) must reuse one compiled program, not compile per
    distinct count."""
    from unittest import mock

    from krisp_tpu.ops.vcfclass import classify_bits_packed_small
    from krisp_tpu.vcf.fastscan import _classify_columnar

    idx, col, groups, _ = bundled
    kw = dict(min_samples=3, min_samp_prop=0.9, min_reads=10,
              min_geno_qual=40, min_var_qual=10, min_freq=0.1,
              min_map_qual=40)
    names = list(groups.keys())
    base = classify_bits_packed_small._cache_size()
    # pin the jit path: on a CPU-only backend _classify_columnar routes to
    # the numpy mirror (no compiled shapes at all), which this test is
    # specifically not about.  The single-accelerator path selects the
    # bits-upload/small-pull kernel for this file (A <= 15).
    with mock.patch("jax.default_backend", return_value="gpu"):
        r1 = _classify_columnar(col, np.arange(300, dtype=np.int64), names,
                                groups, kw)
        n1 = classify_bits_packed_small._cache_size()
        r2 = _classify_columnar(col, np.arange(280, dtype=np.int64), names,
                                groups, kw)
    assert classify_bits_packed_small._cache_size() == n1 > base
    # padding rows must not leak into results (ac is None on this path)
    for a, b in zip(r1, r2):
        if a is None:
            assert b is None
        else:
            assert np.array_equal(a[:280], b)


def test_classify_routes_to_numpy_mirror_on_cpu(bundled):
    """With no accelerator (default_backend == 'cpu'), _classify_columnar
    must select the bit-identical numpy mirror: the jit kernels' compile
    caches stay untouched and the results still match (ADVICE r2).  The
    accelerator path's small-pull protocol (sc/consv/diag/present) must
    agree with the mirror's full outputs."""
    from unittest import mock

    from krisp_tpu.ops.vcfclass import (classify_batch_packed,
                                        classify_bits_packed_small)
    from krisp_tpu.vcf.fastscan import _classify_columnar

    idx, col, groups, _ = bundled
    kw = dict(min_samples=3, min_samp_prop=0.9, min_reads=10,
              min_geno_qual=40, min_var_qual=10, min_freq=0.1,
              min_map_qual=40)
    names = list(groups.keys())
    rows = np.arange(300, dtype=np.int64)
    with mock.patch("jax.default_backend", return_value="gpu"):
        want = _classify_columnar(col, rows, names, groups, kw)
    base = (classify_batch_packed._cache_size(),
            classify_bits_packed_small._cache_size())
    with mock.patch("jax.default_backend", return_value="cpu"):
        got = _classify_columnar(col, rows, names, groups, kw)
    assert (classify_batch_packed._cache_size(),
            classify_bits_packed_small._cache_size()) == base
    # sc / consv / diag / present identical; ac is device-resident (None)
    # on the small path and full on the mirror path
    for k in (0, 2, 3, 4):
        assert np.array_equal(got[k], want[k]), k
    assert want[1] is None and got[1] is not None
    assert np.array_equal(got[1] > 0, want[4])


def test_small_pull_ac_row_matches_kernel(bundled):
    """The host rehydration of candidate-row allele counts
    (ops/vcfclass.allele_counts_rows_numpy) is bit-identical to the full
    kernel's allele_counts for every row."""
    from krisp_tpu.ops.vcfclass import (allele_counts_rows_numpy,
                                        classify_batch_packed_numpy)

    idx, col, groups, _ = bundled
    names = list(groups.keys())
    G = len(names)
    S = len(col.samples)
    A = col.ad.shape[2]
    s_index = {s: i for i, s in enumerate(col.samples)}
    gid = np.full(S, -1, np.int32)
    for gi, g in enumerate(names):
        for m in groups[g]:
            if m in s_index:
                gid[s_index[m]] = gi
    rows = np.arange(0, 400, 7)
    full = classify_batch_packed_numpy(
        col.dp[rows], col.gq[rows], col.ad[rows], col.n_alleles[rows],
        np.nan_to_num(col.mq[rows], nan=-1.0).astype(np.float32),
        np.nan_to_num(col.qual[rows], nan=-1.0).astype(np.float32),
        gid, np.array([len(groups[g]) for g in names], np.int32),
        n_groups=G, min_samples=3)
    ac_full = full[:, 3 * G:].reshape(rows.size, G, A)
    ac_rows = allele_counts_rows_numpy(
        col.dp[rows], col.gq[rows], col.ad[rows], col.n_alleles[rows],
        gid, G, 10, 40, 0.1)
    assert np.array_equal(ac_rows, ac_full)


def test_classify_route_follows_backend_and_width(bundled):
    """The scan's kernel choice: the mesh when there is one, the numpy
    mirror without an accelerator, the small-pull kernel while alleles and
    samples fit its int16 layout, the full layout past that."""
    import types
    from unittest import mock

    from krisp_tpu.vcf.fastscan import classify_route

    _, col, _, _ = bundled
    wide = types.SimpleNamespace(ad=np.zeros((1, 1, 16), np.int32),
                                 samples=col.samples)
    with mock.patch("jax.default_backend", return_value="cpu"):
        assert classify_route(col, None) == "numpy"
        assert classify_route(col, object()) == "sharded"
    with mock.patch("jax.default_backend", return_value="gpu"):
        assert classify_route(col, None) == "small"
        assert classify_route(wide, None) == "full"
