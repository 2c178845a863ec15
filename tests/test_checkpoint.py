"""Checkpoint/resume: cached tables must reproduce the fused-path result."""

from krisp_tpu.engine.pipeline import KmerGeometry, run_pipeline
from krisp_tpu.engine import render
from krisp_tpu.engine.checkpoint import TableCache


def test_workdir_checkpoint_roundtrip(tmp_path, planted_fasta):
    INGROUP, OUTGROUP, expected = planted_fasta()
    geom = KmerGeometry(25, 1, 2)
    fused = [render.render_csv(g)
             for g in run_pipeline(INGROUP, OUTGROUP, geom)]
    assert {tuple(r.split(",")) for r in fused} == expected
    # first run populates the cache
    first = [render.render_csv(g)
             for g in run_pipeline(INGROUP, OUTGROUP, geom,
                                   workdir=str(tmp_path))]
    assert first == fused
    cache = TableCache(str(tmp_path))
    assert len(cache.manifest()) == 5
    # second run resumes from cached tables — same result
    second = [render.render_csv(g)
              for g in run_pipeline(INGROUP, OUTGROUP, geom,
                                    workdir=str(tmp_path))]
    assert second == fused


def test_chunked_out_of_core_matches_fused(tmp_path, monkeypatch,
                                           planted_fasta):
    """Tiny chunk size forces many device chunks per genome; results must
    match the one-shot fused path exactly."""
    from krisp_tpu.engine import pipeline as P

    INGROUP, OUTGROUP, _ = planted_fasta()
    geom = KmerGeometry(25, 1, 2)
    fused = [render.render_csv(g)
             for g in run_pipeline(INGROUP, OUTGROUP, geom)]

    orig = P._cached_parts

    def chunked(paths, geom, bits, omit_soft, workdir, layout):
        return orig(paths, geom, bits, omit_soft, workdir, layout,
                    chunk_size=17_000)  # ~6 chunks per 101kb genome
    monkeypatch.setattr(P, "_cached_parts", chunked)
    got = [render.render_csv(g)
           for g in run_pipeline(INGROUP, OUTGROUP, geom,
                                 workdir=str(tmp_path))]
    assert got == fused
