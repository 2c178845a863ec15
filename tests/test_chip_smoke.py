"""chip_smoke.py's phases at a tiny size on the CPU backend.

The script's ``main()`` refuses to run without a GPU; the phase functions
it drives are backend-agnostic, so their control flow, expectations and
trace reduction are checked here on small inputs."""

import json
import sys

import numpy as np
import pytest

from conftest import REPO

sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402

SIZE, SITE_EVERY = 200_000, 50_000


@pytest.fixture(scope="module")
def clock():
    import jax
    c = cs.CompileClock()
    jax.monitoring.register_event_duration_secs_listener(c)
    yield c
    jax.monitoring.unregister_event_duration_listener(c)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("smoke")


@pytest.fixture(scope="module")
def spacer(root):
    return cs.make_fasta_inputs(root, SIZE, cs.SPACER, SITE_EVERY)


@pytest.fixture(scope="module")
def fused(root, spacer, clock):
    return cs.phase_spacer_fused(root, spacer, SIZE, clock)


def _ok(ph):
    assert ph.ok, ph.line()
    assert json.loads(ph.line().split(": match=True ", 1)[1]) \
        == json.loads(json.dumps(ph.fields))
    return ph.fields


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_phase_spacer_fused(fused, spacer):
    ph, _ = fused
    f = _ok(ph)
    assert f["route"] == "fused"
    assert f["rows"] == f["expected_rows"] == len(spacer[2]) > 0
    assert f["compile_s"] >= 0 and f["wall_s"] > 0


def test_phase_spacer_staged(root, spacer, fused, clock):
    f = _ok(cs.phase_spacer_staged(root, spacer, fused[1], clock))
    assert f["global_passes"] >= 2


def test_phase_amplicon(root, clock):
    f = _ok(cs.phase_amplicon(root, SIZE, SITE_EVERY // 5, clock, cores=2))
    assert f["planted_rows"] > f["expected_rows"] >= 0


@pytest.mark.parametrize("k", [28, 40])
def test_phase_kstream(root, spacer, clock, k):
    f = _ok(cs.phase_kstream(root, spacer[0][0], k, clock))
    assert f["lines"] > 0


def test_phase_vcf(root, clock):
    f = _ok(cs.phase_vcf(root, 3000, 20, clock, pos=(1, 40_000),
                         batch_shape=(1024, 20)))
    assert f["route"] == "device classify: numpy"   # CPU backend
    assert f["classify_full_exact"] and f["classify_small_exact"]


def test_phase_trace(root, spacer, fused, clock, tmp_path):
    f = _ok(cs.phase_trace(root, spacer, clock, tmp_path,
                           copy_bytes=1 << 22))
    stages = f["stages_device"]
    assert stages["window_keys"]["device_ms"] > 0
    assert stages["survivor_scan"]["bytes"] > 0
    assert f["copy_bytes_per_s"] > 0
    assert (tmp_path / "trace_summary.json").is_file()


def test_four_devices_match_one(root, clock):
    phases = cs.four_cards(root, SIZE, SITE_EVERY, 2000, 20, clock)
    one, four = (_ok(ph) for ph in phases)
    assert four["route"] == four["kstream_route"] == "sharded"
    assert four["vcf_route"] == "sharded"
    for key in ("spacer_sha", "kstream_sha", "vcf_sha", "aln_sha"):
        assert one[key] == four[key]


def test_hlo_scopes_follow_fusion_calls():
    text = """HloModule m
%fused_computation.1 (p: u32[8]) -> u32[8] {
  %p = u32[8] parameter(0)
  ROOT %c = u32[8] cumsum(%p), metadata={op_name="jit(f)/survivor_scan/cumsum"}
}
ENTRY %main (x: u32[8]) -> u32[8] {
  %x = u32[8] parameter(0)
  %sort.3 = u32[8] sort(%x), metadata={op_name="jit(f)/global_sort/sort"}
  ROOT %loop_fusion = u32[8] fusion(%sort.3), kind=kLoop, calls=%fused_computation.1
}
"""
    scopes = cs._hlo_scopes(text)
    assert "global_sort" in scopes["sort.3"]
    assert "survivor_scan" in scopes["loop_fusion"]
    stages = cs.stage_times({("jit_fused_global_packed", "sort.3"): 5,
                             ("jit_fused_global_packed", "loop_fusion"): 3,
                             ("jit_extract_keys_packed_in", "x"): 2,
                             ("jit_other", "y"): 1},
                            {"fused_global_packed": scopes})
    assert stages == {"global_sort": 5, "survivor_scan": 3,
                      "window_keys": 2, "other": 1}


def test_stage_bytes_from_shapes():
    got = cs.stage_bytes(n_genomes=5, padded_bases=1000, n_words=2)
    rows = 5 * 2 * 1000
    assert got["window_keys"] == 5 * 1000 * 3 // 8 + rows * 2 * 4
    assert got["survivor_scan"] == rows * 2 * 4 + rows * 9


def test_small_layout_matches_kernel_layout():
    """The numpy-side small layout equals ops/vcfclass.pack_outputs_small
    applied to the same counts."""
    import jax.numpy as jnp
    from krisp_tpu.ops.vcfclass import pack_outputs_small

    rng = np.random.default_rng(2)
    V, G, A = 7, 3, 4
    ac = rng.integers(0, 3, (V, G, A)).astype(np.int32)
    sc = rng.integers(0, 9, (V, G)).astype(np.int32)
    cons = rng.integers(-1, A, (V, G)).astype(np.int32)
    diag = rng.integers(-1, A, (V, G)).astype(np.int32)
    full = np.concatenate([sc, cons, diag, ac.reshape(V, -1)], axis=1)
    want = np.asarray(pack_outputs_small(
        {"sample_counts": jnp.asarray(sc), "conserved": jnp.asarray(cons),
         "diagnostic": jnp.asarray(diag), "allele_counts": jnp.asarray(ac)},
        V))
    np.testing.assert_array_equal(cs._small_layout_numpy(full, G, A), want)


def test_hbm_peak_table():
    assert cs.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    assert cs.hbm_peak("cpu") is None
