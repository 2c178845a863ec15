"""Checks that only a GPU can answer: the device-lowered sorts and the
float32 classification matmuls at real widths, against numpy.

Marked ``gpu``; they skip on any other backend.  Run them on the card, in
a process of their own: ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/``."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.mark.parametrize("n_words,payload", [(2, False), (3, False),
                                             (7, True)])
def test_lsd_sort_uint64_digits(gpu, n_words, payload):
    """u64-fused LSD passes (key-only, key-value and the wide row-id path)
    order multi-word keys exactly as numpy's lexsort does."""
    import jax
    from krisp_tpu.ops.sort import lsd_sort

    rng = np.random.default_rng(n_words)
    n = 1 << 22
    keys = [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(n_words)]
    keys[0][: n // 2] = keys[0][n // 2:]        # force deep ties
    pay = [np.arange(n, dtype=np.uint32)] if payload else []
    got_k, got_p = jax.jit(lsd_sort)(keys, pay)
    order = np.lexsort(keys[::-1])          # stable
    for g, k in zip(got_k, keys):
        np.testing.assert_array_equal(np.asarray(g), k[order])
    for g, p in zip(got_p, pay):
        np.testing.assert_array_equal(np.asarray(g), p[order])


def test_classify_kernels_exact(gpu):
    """Both VCF classification kernels equal the numpy mirror bit for bit
    at V=32,768 x S=100 (float32 matmuls pinned to HIGHEST precision)."""
    import sys

    from conftest import REPO
    sys.path.insert(0, str(REPO))
    import chip_smoke

    assert chip_smoke.classify_exactness(32768, 100) == (True, True)


def test_kstream_long_k_device_engine(gpu, tmp_path):
    """k > 64 (seven key words with counts carried) on the device engine,
    against the exact string pipeline."""
    from test_kstream import string_pipeline
    from krisp_tpu.cli import kstream

    rng = np.random.default_rng(9)
    body = "".join(rng.choice(list("ACGTN"), p=[.24, .24, .24, .24, .04],
                              size=20_000))
    text = f">a\n{body}\n>b\n{body[:5000]}\n"
    fasta = tmp_path / "in.fa"
    fasta.write_text(text)
    flags = ["--kmers", "100", "--disallow", "Nn", "--sort", "--canonicals"]
    out = tmp_path / "out.txt"
    kstream.main([str(fasta), *flags, "--engine", "device", "--devices", "1",
                  "--output", str(out)])
    assert out.read_text().splitlines() == string_pipeline(flags, text,
                                                           tmp_path)


def test_amplicon_staged_matches_fused(gpu, tmp_path, planted_fasta,
                                       monkeypatch):
    """Wide keys (30/40/30) through the staged path's key-value sorts."""
    from krisp_tpu.engine import render
    from krisp_tpu.engine.pipeline import KmerGeometry, run_pipeline

    ingroup, outgroup, expected = planted_fasta((30, 40, 30))
    geom = KmerGeometry(30, 40, 30)
    fused = [render.render_csv(g) for g in run_pipeline(ingroup, outgroup,
                                                        geom)]
    monkeypatch.setenv("KRISP_TPU_GLOBAL_ROWS", "200000")
    staged = [render.render_csv(g) for g in run_pipeline(
        ingroup, outgroup, geom, workdir=str(tmp_path / "wd"))]
    assert staged == fused
    assert {tuple(r.split(",")) for r in fused} == expected
