"""Runtime setup: where the compile cache lives, device-derived memory
budgets, and worker processes kept off the accelerator."""

import multiprocessing as mp
import os

import jax
import pytest

from krisp_tpu import runtime


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_from_env(monkeypatch, tmp_path, restore_cache_dir):
    target = tmp_path / "jaxcache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert runtime.cache_dir() == str(target)
    assert runtime.setup() == str(target)
    assert jax.config.jax_compilation_cache_dir == str(target)
    assert target.is_dir()


def test_cache_dir_defaults_into_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(runtime.REPO_ROOT / ".jax_cache")
    assert runtime.cache_dir() == want
    assert runtime.setup() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert (runtime.REPO_ROOT / "krisp_tpu" / "runtime.py").is_file()


class _Device:
    def __init__(self, stats):
        self.stats = stats

    def memory_stats(self):
        return self.stats


@pytest.mark.parametrize("stats,want", [
    ({"bytes_limit": 60 << 30, "bytes_in_use": 0}, 30 << 30),
    (None, 8 << 30),                 # CPU backend: no statistics
    ({"bytes_in_use": 0}, 8 << 30),  # statistics without a limit
])
def test_device_budget_from_memory_stats(stats, want, monkeypatch):
    monkeypatch.delenv("KRISP_TPU_TEST_BUDGET", raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [_Device(stats)])
    assert runtime.device_budget("KRISP_TPU_TEST_BUDGET", 0.5,
                                 8 << 30) == want


def test_device_budget_env_pin_wins(monkeypatch):
    monkeypatch.setenv("KRISP_TPU_TEST_BUDGET", "12345")
    monkeypatch.setattr(jax, "devices", lambda *a: [_Device(
        {"bytes_limit": 60 << 30})])
    assert runtime.device_budget("KRISP_TPU_TEST_BUDGET", 0.5, 1) == 12345


def test_staged_pass_rows_follow_device(monkeypatch):
    from krisp_tpu.engine.bigscale import GLOBAL_BUDGET_FRACTION, \
        row_budget_for
    from krisp_tpu.ops.encode import KeyLayout

    layout = KeyLayout(25, 1, 2, 2, 5)
    for var in ("KRISP_TPU_GLOBAL_ROWS", "KRISP_TPU_GLOBAL_BYTES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [_Device(
        {"bytes_limit": 64 << 30})])
    per_row = 4 * (layout.n_words + 1)
    assert row_budget_for(layout) == int((64 << 30)
                                         * GLOBAL_BUDGET_FRACTION) // per_row
    monkeypatch.setattr(jax, "devices", lambda *a: [_Device(None)])
    assert row_budget_for(layout) == (2 << 30) // per_row
    monkeypatch.setenv("KRISP_TPU_GLOBAL_ROWS", "777")
    assert row_budget_for(layout) == 777


@pytest.mark.parametrize("before", [None, "cuda"])
def test_cpu_only_children(before, monkeypatch):
    """Spawned workers see JAX_PLATFORMS=cpu; the parent's value is back
    afterwards."""
    if before is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", before)
    ctx = mp.get_context("spawn")
    with runtime.cpu_only_children():
        pool = ctx.Pool(1)
    with pool:
        seen = pool.apply(os.getenv, ("JAX_PLATFORMS",))
    assert seen == "cpu"
    assert os.environ.get("JAX_PLATFORMS") == before
