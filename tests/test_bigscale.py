"""Range-partitioned global stage (engine/bigscale.py): bounded passes
must reproduce the single-pass fused result bit-for-bit.

This is the out-of-core analog of the reference's external-memory sort
(/root/reference/src/krisp/kstream/kstream.py:45-119): GB-scale key
tables never materialize on device at once, yet the survivor set, its
order, and the rendered bytes are identical to the one-shot program.
"""

import numpy as np
import pytest

from krisp_tpu.engine import render
from krisp_tpu.engine.bigscale import (_prefix_ranges, _range_bounds,
                                       _slice_range,
                                       partitioned_global_intersect)
from krisp_tpu.engine.pipeline import KmerGeometry, run_pipeline

def _fused_csv(geom, ingroup, outgroup):
    return [render.render_csv(g) for g in run_pipeline(ingroup, outgroup,
                                                       geom)]


def test_many_passes_match_fused(tmp_path, monkeypatch, planted_fasta):
    """A row budget far below the table size forces dozens of ranges;
    every range runs its own device pass, and the concatenated survivors
    must render byte-identically to the single fused program."""
    INGROUP, OUTGROUP, expected = planted_fasta()
    geom = KmerGeometry(25, 1, 2)
    fused = _fused_csv(geom, INGROUP, OUTGROUP)
    assert {tuple(r.split(",")) for r in fused} == expected
    monkeypatch.setenv("KRISP_TPU_GLOBAL_ROWS", "20000")
    got = [render.render_csv(g)
           for g in run_pipeline(INGROUP, OUTGROUP, geom,
                                 workdir=str(tmp_path))]
    assert got == fused


def test_chunked_extraction_plus_partitioned_global(tmp_path, monkeypatch,
                                                    planted_fasta):
    """Both axes bounded at once: tiny extraction chunks (many sorted
    sub-runs per genome) AND a tiny global row budget (many ranges)."""
    from krisp_tpu.engine import pipeline as P

    INGROUP, OUTGROUP, _ = planted_fasta()
    geom = KmerGeometry(25, 1, 2)
    fused = _fused_csv(geom, INGROUP, OUTGROUP)
    orig = P._cached_parts

    def chunked(paths, geom, bits, omit_soft, workdir, layout):
        return orig(paths, geom, bits, omit_soft, workdir, layout,
                    chunk_size=17_000)
    monkeypatch.setattr(P, "_cached_parts", chunked)
    monkeypatch.setenv("KRISP_TPU_GLOBAL_ROWS", "30000")
    got = [render.render_csv(g)
           for g in run_pipeline(INGROUP, OUTGROUP, geom,
                                 workdir=str(tmp_path))]
    assert got == fused


def test_prefix_ranges_cover_and_bound():
    """Ranges partition the bucket space; no range except a single
    over-full bucket exceeds the budget."""
    rng = np.random.default_rng(7)
    shift = 24
    w0 = rng.integers(0, 1 << 32, size=5000, dtype=np.uint64).astype(
        np.uint32)
    w0.sort()
    parts = [(w0[None, :], np.ones(5000, np.uint32),
              np.array([0, 5000], np.int64))]
    ranges = _prefix_ranges(parts, shift, 1 << 8, row_budget=700)
    # full coverage, in order, no overlap
    assert ranges[0][0] == 0 and ranges[-1][1] == 1 << 8
    for (a, b), (c, d) in zip(ranges[:-1], ranges[1:]):
        assert a < b == c < d
    hist = np.bincount(w0 >> shift, minlength=1 << 8)
    for lo, hi in ranges:
        rows = int(hist[lo:hi].sum())
        assert rows <= 700 or hi - lo == 1  # over-full single bucket


def test_slice_range_rebuilds_every_row():
    """Slicing all ranges out of multi-sub-run tables loses nothing and
    keeps each sub-run's relative order."""
    rng = np.random.default_rng(3)
    runs = []
    offsets = [0]
    for n in (100, 1, 57):
        r = np.sort(rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
                    .astype(np.uint32))
        runs.append(r)
        offsets.append(offsets[-1] + n)
    w0 = np.concatenate(runs)
    words = np.stack([w0, w0 ^ np.uint32(0xDEADBEEF)])
    counts = np.arange(len(w0), dtype=np.uint32)
    parts = [(words, counts, np.array(offsets, np.int64))]
    shift = 28
    got_w, got_c = [], []
    for lo in range(16):
        w, c = _slice_range(parts, _range_bounds(parts, shift, lo, lo + 1))
        if w is not None:
            got_w.append(w)
            got_c.append(c)
    got_c = np.concatenate(got_c)
    assert np.concatenate(got_w, axis=1).shape == words.shape
    assert sorted(got_c.tolist()) == counts.tolist()


def test_empty_parts():
    from krisp_tpu.ops.encode import KeyLayout

    layout = KeyLayout(25, 1, 2, 2, 5)
    W = layout.n_words
    parts = [(np.zeros((W, 0), np.uint32), np.zeros(0, np.uint32),
              np.zeros(1, np.int64))]
    w, c, g = partitioned_global_intersect(parts, layout, n_files=5)
    assert w.shape == (0, W) and c.size == 0 and g.size == 0


def _snapshot(groups):
    return sorted((g.left, g.right,
                   sorted((a.mid, tuple(sorted(a.label_counts.items())))
                          for a in g.amplicons))
                  for g in groups)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_partitioned_equals_fused(seed, tmp_path, monkeypatch):
    """Randomized geometry x genome fuzz: the staged range-partitioned
    path (tiny extraction chunks + tiny global row budget) yields the
    identical FlankGroup set to the single-device fused program."""
    from krisp_tpu.engine import pipeline as P

    rng = np.random.default_rng(4000 + seed)
    left = int(rng.integers(3, 12))
    mid = int(rng.integers(0, 4))
    right = int(rng.integers(2, 10))
    n_files = int(rng.integers(2, 5))
    omit_soft = bool(rng.integers(0, 2))
    geom = KmerGeometry(left, mid, right)
    L = geom.total

    size = int(rng.integers(3000, 6000))
    flanks = [("".join(rng.choice(list("ACGT"), size=left)),
               "".join(rng.choice(list("ACGT"), size=right)))
              for _ in range(4)]
    paths = []
    for f in range(n_files):
        chars = rng.choice(list("ACGTNacgt"), size=size,
                           p=[.22, .22, .22, .22, .04, .02, .02, .02, .02])
        seq = list("".join(chars))
        for i, (fl, fr) in enumerate(flanks):
            pos = (i + 1) * size // (len(flanks) + 2)
            mid_seq = ("A" if f < 2 else "C") * mid
            seq[pos:pos + L] = fl + mid_seq + fr
        path = tmp_path / f"g{seed}_{f}.fasta"
        path.write_text(f">g{f}\n" + "".join(seq) + "\n")
        paths.append(str(path))

    ingroup, outgroup = paths[:2], paths[2:]
    fused = run_pipeline(ingroup, outgroup, geom, omit_soft=omit_soft)

    orig = P._cached_parts

    def chunked(paths, geom, bits, omit_soft, workdir, layout):
        return orig(paths, geom, bits, omit_soft, workdir, layout,
                    chunk_size=int(rng.integers(700, 2000)))
    monkeypatch.setattr(P, "_cached_parts", chunked)
    monkeypatch.setenv("KRISP_TPU_GLOBAL_ROWS",
                       str(int(rng.integers(500, 3000))))
    staged = run_pipeline(ingroup, outgroup, geom, omit_soft=omit_soft,
                          workdir=str(tmp_path / f"wd{seed}"))
    assert _snapshot(staged) == _snapshot(fused)
    assert fused, "fuzz case produced no groups (planted regions missing)"
