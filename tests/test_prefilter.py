"""Prefix-prefilter pipeline == direct full-width pipeline, bit for bit.

The prefilter (ops/intersect.fused_pipeline_prefilter) sorts one
prefix|file word and runs the exact wide-key stage on the prefix-surviving
subset — output must equal fused_pipeline_bits on every input, including
degenerate low-complexity genomes where the prefilter keeps almost
everything (VERDICT r1 item 6: amplicon-mode perf).
"""

import numpy as np
import pytest

from krisp_tpu import dna
from krisp_tpu.ops.intersect import (fused_pipeline_bits,
                                     fused_pipeline_prefilter)

CODE = np.asarray(dna.CODE2_TABLE)
COMP = np.asarray(dna.COMP2_TABLE)
VALID = np.asarray(dna.base_validity_table(2, disallow="Nn"))


def run_both(buffers, left, mid, right, n_files, cap_pre=1 << 12,
             cap=1 << 12):
    w, c, g, nk = fused_pipeline_bits(
        buffers, CODE, VALID, COMP, left=left, mid=mid, right=right,
        bits=2, n_files=n_files, cap=cap)
    nk = int(nk)
    packed = np.asarray(fused_pipeline_prefilter(
        buffers, CODE, VALID, COMP, left=left, mid=mid, right=right,
        bits=2, n_files=n_files, cap_pre=cap_pre, cap=cap))
    nk_p = int(packed[-1, 0])
    n_pre = int(packed[-1, 1])
    assert n_pre <= cap_pre, "grow cap_pre for this test input"
    W = w.shape[0]
    return ((np.asarray(w)[:, :nk], np.asarray(c)[:nk], np.asarray(g)[:nk]),
            (packed[:W, :nk_p], packed[W, :nk_p], packed[W + 1, :nk_p]),
            nk, nk_p)


@pytest.mark.parametrize("seed", range(6))
def test_prefilter_matches_direct_amplicon(seed):
    rng = np.random.default_rng(seed)
    left, mid, right, F = 30, 40, 30, 3
    n = 4096
    buffers = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(F, n),
                         p=[0.24, 0.24, 0.24, 0.24, 0.04])
    # plant shared amplicons so survivors exist
    for i in range(3):
        pos = 200 + i * 900
        block = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=100)
        for f in range(F):
            buffers[f, pos:pos + 100] = block
    direct, pre, nk, nk_p = run_both(buffers, left, mid, right, F)
    assert nk == nk_p > 0
    np.testing.assert_array_equal(direct[0], pre[0])   # key words
    np.testing.assert_array_equal(direct[1], pre[1])   # counts
    # group ids: same grouping structure (absolute values may differ —
    # they number flank runs of differently sized tables)
    assert np.array_equal(np.diff(direct[2].astype(np.int64)) != 0,
                          np.diff(pre[2].astype(np.int64)) != 0)


def test_prefilter_degenerate_low_complexity():
    """AT-repeat genomes: nearly every prefix survives; results must still
    be exact (cap_pre sized to the worst case here)."""
    rng = np.random.default_rng(99)
    left, mid, right, F = 30, 40, 30, 2
    n = 2048
    pat = np.frombuffer(b"ATATATAT", np.uint8)
    buffers = np.tile(pat, (F, n // 8))
    # sprinkle noise so not literally everything is identical
    for f in range(F):
        idx = rng.integers(0, n, 40)
        buffers[f, idx] = np.frombuffer(b"CG", np.uint8)[
            rng.integers(0, 2, 40)]
    direct, pre, nk, nk_p = run_both(buffers, left, mid, right, F,
                                     cap_pre=2 * 2 * n, cap=2 * 2 * n)
    assert nk == nk_p
    np.testing.assert_array_equal(direct[0], pre[0])
    np.testing.assert_array_equal(direct[1], pre[1])
    assert np.array_equal(np.diff(direct[2].astype(np.int64)) != 0,
                          np.diff(pre[2].astype(np.int64)) != 0)


def test_prefilter_no_survivors():
    rng = np.random.default_rng(5)
    left, mid, right, F = 30, 40, 30, 2
    buffers = np.stack([
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=2048),
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=2048)])
    direct, pre, nk, nk_p = run_both(buffers, left, mid, right, F)
    assert nk == nk_p == 0


def test_prefilter_cap_overflow_reporting():
    """When cap_pre is too small, the survivor count is reported so the
    caller can retry."""
    left, mid, right, F = 30, 40, 30, 2
    pat = np.frombuffer(b"ACGTACGTACGTACGT", np.uint8)
    buffers = np.tile(pat, (F, 2048 // 16))
    packed = np.asarray(fused_pipeline_prefilter(
        buffers, CODE, VALID, COMP, left=left, mid=mid, right=right,
        bits=2, n_files=F, cap_pre=64, cap=64))
    assert int(packed[-1, 1]) > 64  # overflow signalled


def test_per_genome_pipelined_stages_match_oneshot():
    """The pipelined per-genome path (extract_keys_packed_in per genome,
    then one global stage) must reproduce the one-shot fused programs bit
    for bit, for both the wide-key prefilter and the spacer global stage.
    run_pipeline routes every bits==2 run through this split so the host
    pack/upload of genome f+1 overlaps device extraction of genome f."""
    from krisp_tpu.engine.pipeline import _pack_genomes_host
    from krisp_tpu.ops.intersect import (extract_keys_packed_in,
                                         fused_global_packed,
                                         fused_pipeline_packed,
                                         fused_prefilter_global)

    rng = np.random.default_rng(17)
    F, n = 3, 4096          # n % 16 == 0 (host pack granularity)
    buffers = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(F, n),
                         p=[0.24, 0.24, 0.24, 0.24, 0.04])
    block = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=100)
    for f in range(F):
        buffers[f, 500:600] = block

    keys = []
    for f in range(F):
        pk, vb = _pack_genomes_host(buffers[f:f + 1], omit_soft=False)
        keys.append(extract_keys_packed_in(
            pk, vb, CODE, VALID, COMP, np.uint32(f), left=30, mid=40,
            right=30, bits=2, n_files=F))
    keys = tuple(keys)

    one = np.asarray(fused_pipeline_prefilter(
        buffers, CODE, VALID, COMP, left=30, mid=40, right=30, bits=2,
        n_files=F, cap_pre=1 << 12, cap=1 << 12))
    pipelined = np.asarray(fused_prefilter_global(
        keys, left=30, mid=40, right=30, bits=2, n_files=F,
        cap_pre=1 << 12, cap=1 << 12))
    assert int(one[-1, 0]) > 0
    np.testing.assert_array_equal(one, pipelined)

    # spacer geometry over the same genomes (25/1/2 -> 1-word keys)
    keys_sp = tuple(extract_keys_packed_in(
        *_pack_genomes_host(buffers[f:f + 1], omit_soft=False), CODE, VALID,
        COMP, np.uint32(f), left=25, mid=1, right=2, bits=2, n_files=F)
        for f in range(F))
    one_sp = np.asarray(fused_pipeline_packed(
        buffers, CODE, VALID, COMP, left=25, mid=1, right=2, bits=2,
        n_files=F, cap=1 << 12))
    pip_sp = np.asarray(fused_global_packed(
        keys_sp, left=25, mid=1, right=2, bits=2, n_files=F, cap=1 << 12))
    assert int(one_sp[-1, 0]) > 0
    np.testing.assert_array_equal(one_sp, pip_sp)


def test_per_genome_pipelined_prefilter_overflow_reporting():
    """cap_pre overflow must surface through the pipelined global stage so
    run_pipeline's retry loop (which re-runs ONLY this stage) sees it."""
    from krisp_tpu.engine.pipeline import _pack_genomes_host
    from krisp_tpu.ops.intersect import (extract_keys_packed_in,
                                         fused_prefilter_global)

    F = 2
    pat = np.frombuffer(b"ACGTACGTACGTACGT", np.uint8)
    buffers = np.tile(pat, (F, 2048 // 16))
    keys = tuple(extract_keys_packed_in(
        *_pack_genomes_host(buffers[f:f + 1], omit_soft=False), CODE, VALID,
        COMP, np.uint32(f), left=30, mid=40, right=30, bits=2, n_files=F)
        for f in range(F))
    packed = np.asarray(fused_prefilter_global(
        keys, left=30, mid=40, right=30, bits=2, n_files=F,
        cap_pre=64, cap=64))
    assert int(packed[-1, 1]) > 64


def test_run_pipeline_amplicon_uses_prefilter_and_matches_golden(
        tmp_path, planted_fasta):
    """CLI-level: amplicon mode through run_pipeline (prefilter-gated)
    yields exactly the planted diagnostic windows, both strands."""
    from krisp_tpu.cli.krisp_fasta import main as krisp_fasta_main

    ingroup, outgroup, expected = planted_fasta((30, 40, 30))
    csv = tmp_path / "out.csv"
    krisp_fasta_main(ingroup + ["--outgroup"] + outgroup +
                     ["--conserved", "30", "--amplicon", "100",
                      "--out_csv", str(csv)])
    lines = csv.read_text().splitlines()
    assert lines[0] == "left_seq,diag_seq,right_seq"
    assert {tuple(r.split(",")) for r in lines[1:]} == expected
    assert len(lines) - 1 == len(expected) > 0
