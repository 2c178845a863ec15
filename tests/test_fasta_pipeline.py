"""krisp_fasta engine: geometry solving and the choice between the fused
one-shot device program and the staged out-of-core path."""

import pytest

from krisp_tpu.engine.pipeline import solve_geometry


def test_geometry_solver():
    g = solve_geometry(amplicon=100, diagnostic=40)
    assert (g.left, g.mid, g.right) == (30, 40, 30)
    g = solve_geometry(amplicon=100, conserved=30)
    assert (g.left, g.mid, g.right) == (30, 40, 30)
    g = solve_geometry(diagnostic=1, conserved_left=25, conserved_right=2)
    assert (g.left, g.mid, g.right) == (25, 1, 2)
    with pytest.raises(ValueError):
        solve_geometry(diagnostic=1)


class _Device:
    """Stands in for ``jax.devices()[0]`` with a given memory limit."""

    def __init__(self, bytes_limit):
        self.bytes_limit = bytes_limit

    def memory_stats(self):
        if self.bytes_limit is None:
            return None
        return {"bytes_limit": self.bytes_limit, "bytes_in_use": 0}


@pytest.mark.parametrize("limit,fits", [(80 << 30, True), (1 << 20, False)])
def test_fused_budget_routes_by_device_memory(limit, fits, monkeypatch,
                                              planted_fasta):
    """The fused-vs-staged cutover follows the device's memory limit: a
    large card runs the fused program, a small one the staged path — with
    identical rows either way."""
    import jax

    from krisp_tpu.engine import render
    from krisp_tpu.engine.pipeline import KmerGeometry, run_pipeline
    from krisp_tpu.metrics import GLOBAL as METRICS

    ingroup, outgroup, expected = planted_fasta()
    monkeypatch.delenv("KRISP_TPU_HBM_BUDGET", raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [_Device(limit)])
    METRICS.reset()
    groups = run_pipeline(ingroup, outgroup, KmerGeometry(25, 1, 2))
    assert {tuple(render.render_csv(g).split(",")) for g in groups} \
        == expected
    assert ("global_pass" not in METRICS.stages) == fits
    assert ("device_pipeline" in METRICS.stages) == fits


def test_fused_estimate_scales_with_padded_bases():
    import numpy as np

    from krisp_tpu.engine.pipeline import (FUSED_BYTES_PER_BASE,
                                           fused_bytes_estimate)
    from krisp_tpu.io.fasta import bucket_size

    bufs = [np.zeros(100_000, np.uint8), np.zeros(70_000, np.uint8)]
    assert fused_bytes_estimate(bufs) == FUSED_BYTES_PER_BASE * (
        bucket_size(100_000) + bucket_size(70_000))
