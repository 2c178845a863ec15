"""Test harness config: a deterministic 8-device virtual CPU mesh, so the
sharding tests run without accelerator hardware and every compile stays on
the CPU backend.  ``JAX_PLATFORMS=cuda`` instead selects the GPU, for the
tests marked ``gpu`` (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``);
everything else expects the CPU mesh."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Default the engine to the single-device fused path so legacy tests pin it;
# distributed tests opt into the mesh explicitly via run_pipeline(n_devices=N).
os.environ.setdefault("KRISP_TPU_DEVICES", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

#: the seeded cohort VCF the VCF tests share: records, samples (four groups
#: of five, G1..G4) — tools/bench_vcf_scaled.synth_scaled
SYNTH_VCF_SHAPE = (10_000, 20)


@pytest.fixture(scope="session")
def synth_vcf(tmp_path_factory):
    """(metadata.csv, reference.fasta, variants.vcf.gz) of a seeded cohort
    with planted group-specific fixed differences, low-quality and missing
    blocks, indels and multiallelic sites."""
    sys.path.insert(0, str(REPO / "tools"))
    from bench_vcf_scaled import synth_scaled
    return synth_scaled(*SYNTH_VCF_SHAPE,
                        out_dir=tmp_path_factory.mktemp("synth_vcf"))


@pytest.fixture(scope="session")
def planted_fasta(tmp_path_factory):
    """Factory: (ingroup paths, outgroup paths, expected CSV row triples)
    for 2 ingroup + 3 outgroup genomes with planted diagnostic sites
    (tools/make_bigscale_fasta.make_genomes), cached per geometry."""
    sys.path.insert(0, str(REPO / "tools"))
    from make_bigscale_fasta import (expected_rows, make_genomes,
                                     planted_windows)
    made = {}

    def make(geom=(25, 1, 2), size=100_000, site_every=10_000):
        key = (tuple(geom), size, site_every)
        if key not in made:
            out = tmp_path_factory.mktemp("planted")
            paths, _ = make_genomes(str(out), size, site_every=site_every,
                                    geom=geom)
            win, _, diag = planted_windows(size // site_every, geom)
            made[key] = (paths[:2], paths[2:],
                         expected_rows(geom, win, diag))
        return made[key]

    return make


#: names the grunwaldlab/krisp reference checkout (its src/ and test_data/)
#: for the tests that run the reference itself or read its bundled data
REFERENCE_ENV = "KRISP_REFERENCE_DIR"


@pytest.fixture(scope="session")
def reference_dir():
    """The reference checkout; the test skips when it is not available."""
    root = os.environ.get(REFERENCE_ENV)
    if not root or not (Path(root) / "src" / "krisp").is_dir():
        pytest.skip(f"needs the grunwaldlab/krisp reference checkout "
                    f"(set {REFERENCE_ENV})")
    return Path(root)


def ref_pythonpath(reference_dir) -> str:
    """PYTHONPATH that runs the reference CLI on this repo's stand-ins for
    its native dependencies (tools/refstubs)."""
    return f"{REPO}/tools/refstubs:{reference_dir}/src:{REPO}"
