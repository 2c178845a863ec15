"""kstream parity tests: our KStream vs. the reference implementation run
directly (the reference kstream module is pure stdlib, so it can serve as a
live oracle), and the fast-path engines vs. our exact string pipeline
(KStream), which those reference comparisons pin."""

import subprocess
import sys

import pytest

from conftest import REPO
from krisp_tpu.kstream import KStream, external_sort, sort_key_for_cols


def run_reference(reference_dir, args, stdin_text):
    proc = subprocess.run(
        [sys.executable, "-m", "krisp.kstream.kstream", *args],
        input=stdin_text, capture_output=True, text=True,
        env={"PYTHONPATH": f"{reference_dir}/src", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def string_pipeline(args, stdin_text, tmp_path):
    """The exact string pipeline's output lines for ``args``."""
    oracle_dir = tmp_path / "oracle"
    oracle_dir.mkdir(exist_ok=True)
    return run_ours(args, stdin_text, oracle_dir)


def _cli_env(**extra):
    return {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
            "JAX_PLATFORMS": "cpu", **extra}


def run_ours(args, stdin_text, tmp_path):
    fasta = tmp_path / "in.fa"
    fasta.write_text(stdin_text)
    from krisp_tpu.cli.kstream import parse_args
    from krisp_tpu.kstream import KStream
    a = parse_args([str(fasta), *args])
    ks = KStream(kmers=a.kmers, complements=a.complements,
                 canonicals=a.canonicals, allow=a.allow, disallow=a.disallow,
                 omitsoft=a.omit_softmask, mapsoft=a.map_softmask,
                 expandiupac=a.expand_iupac, split=a.split,
                 parallel=a.parallel, sort=a.sort, sortnp=a.sort_np,
                 sortmem=a.sort_mem, sortcols=a.sort_cols)
    return list(ks(str(fasta)))


FASTA = """>seq1
ACGTACGTNNGGCCAacgtRYK
ACGTTT
>seq2
GGGCCCAAATTT
"""

RNA = """>r1
ACGUACGUACGU
"""

CASES = [
    ["--kmers", "6"],
    ["--kmers", "6", "--sort"],
    ["--kmers", "6", "--disallow", "Nn", "--sort"],
    ["--kmers", "6", "--disallow", "Nn", "--sort", "--canonicals"],
    ["--kmers", "6", "--complements"],
    ["--kmers", "5", "--omit-softmask"],
    ["--kmers", "5", "--map-softmask"],
    ["--kmers", "4", "--expand-iupac", "--sort"],
    ["--kmers", "8", "--split", "3", "-2", "--sort", "--sort-cols", "0", "2"],
    ["--kmers", "3", "7"],
    [],
]


@pytest.mark.parametrize("args", CASES, ids=[" ".join(c) or "plain" for c in CASES])
def test_kstream_matches_reference(args, tmp_path, reference_dir):
    assert run_ours(args, FASTA, tmp_path) == \
        run_reference(reference_dir, args, FASTA)


def test_kstream_rna_roundtrip(tmp_path, reference_dir):
    args = ["--kmers", "4", "--canonicals", "--sort"]
    assert run_ours(args, RNA, tmp_path) == \
        run_reference(reference_dir, args, RNA)


def test_external_sort_spills_to_disk():
    import random
    rng = random.Random(0)
    lines = ["".join(rng.choice("ACGT") for _ in range(8)) for _ in range(5000)]
    got = list(external_sort(iter(lines), chunk_lines=512))
    assert got == sorted(lines)


def test_sort_cols_matches_gnu_sort():
    import random
    rng = random.Random(1)
    lines = [",".join("".join(rng.choice("ACGT") for _ in range(4))
                      for _ in range(3)) for _ in range(500)]
    proc = subprocess.run(["sort", "-t,", "-k1,1", "-k3,3"],
                          input="\n".join(lines) + "\n", capture_output=True,
                          text=True, env={"LC_ALL": "C"})
    want = proc.stdout.splitlines()
    got = sorted(lines, key=sort_key_for_cols([0, 2]))
    assert got == want


def test_write_matches_reference(tmp_path, reference_dir):
    """KStream.write: file contents + returned count parity."""
    fasta = tmp_path / "in.fa"
    fasta.write_text(FASTA)
    ours = tmp_path / "ours.txt"
    ks = KStream(kmers=6, disallow="Nn", sort=True, complements=True)
    count = ks.write(str(ours), str(fasta))

    import subprocess, sys
    script = (
        f"import sys; sys.path.insert(0, {str(reference_dir / 'src')!r})\n"
        "from krisp.kstream.kstream import kstream\n"
        f"ks = kstream({str(fasta)!r}, kmers=6, disallow='Nn', sort=True,"
        " complements=True)\n"
        f"print(ks.write({str(tmp_path / 'ref.txt')!r}))\n")
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert count == int(proc.stdout.strip())
    assert ours.read_text() == (tmp_path / "ref.txt").read_text()


@pytest.mark.parametrize("flags", [
    ["--kmers", "9", "--disallow", "Nn", "--sort"],
    ["--kmers", "9", "--disallow", "Nn", "--sort", "--complements"],
    ["--kmers", "9", "--disallow", "Nn", "--sort", "--canonicals"],
    ["--kmers", "6", "--disallow", "Nn", "--sort", "--map-softmask"],
    ["--kmers", "6", "--disallow", "Nn", "--sort", "--omit-softmask"],
])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_device_fast_path_matches_reference(flags, engine, tmp_path):
    """Both fast-path engines in the kstream CLI emit byte-identical
    output to the string pipeline."""
    fasta = tmp_path / "in.fa"
    fasta.write_text(">a\nACGTNACGGTTACA\nacgtACGT\n>b\nGGGTTTACACGTN\n")
    out = tmp_path / "ours.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "krisp_tpu.cli.kstream", str(fasta), *flags,
         "--engine", engine, "--output", str(out)],
        capture_output=True, text=True,
        env=_cli_env())
    assert proc.returncode == 0, proc.stderr
    want = string_pipeline(flags, fasta.read_text(), tmp_path)
    assert out.read_text().splitlines() == want


@pytest.mark.parametrize("k,body", [
    # k=15: 2 spare bits in the single key word -> embedded counts with
    # the all-ones overflow marker exercised (one 15-mer repeated 5x)
    (15, ("ACGTACGTACGTACG" + "N") * 5 + "\nGGGTTTACACGTNAAACCCGGGTTTAC\n"),
    # k=16: zero spare bits -> the legacy words+count row layout
    (16, "ACGTACGTACGTACGTTTGGGTTTACACGTNA\nacgtACGTacgtACGTAC\n"),
])
def test_device_path_count_layouts(k, body, tmp_path):
    """Byte parity across the embedded-count and legacy pull layouts."""
    fasta = tmp_path / "in.fa"
    fasta.write_text(f">a\n{body}\n")
    flags = ["--kmers", str(k), "--disallow", "Nn", "--sort"]
    out = tmp_path / "ours.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "krisp_tpu.cli.kstream", str(fasta), *flags,
         "--output", str(out)],
        capture_output=True, text=True,
        env=_cli_env())
    assert proc.returncode == 0, proc.stderr
    want = string_pipeline(flags, fasta.read_text(), tmp_path)
    assert out.read_text().splitlines() == want


def fuzz_kstream_point(seed, tmp_path):
    """One randomized kstream parity point: random FASTA + random eligible
    flag set, byte parity against the exact string pipeline through the
    device fast path.  Random k sweeps the word-count/spare-bit space of the
    embedded-count pull layout.  Shared with tools/fuzz_campaign.py."""
    import numpy as np
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 40))
    mode = rng.choice(["plain", "complements", "canonicals"])
    soft = rng.choice(["none", "omit", "map"])
    n_rec = int(rng.integers(1, 4))
    body = []
    for r in range(n_rec):
        n = int(rng.integers(k, 400))
        # ACGT-heavy with N runs and lowercase patches
        s = rng.choice(list("ACGT"), size=n, p=[.3, .3, .2, .2])
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, n))
            s[p:p + int(rng.integers(1, 5))] = "N"
        if soft != "none":
            p = int(rng.integers(0, n))
            q = p + int(rng.integers(1, 30))
            s[p:q] = [c.lower() for c in s[p:q]]
        body.append(f">r{r}\n" + "".join(s))
    fasta = tmp_path / "in.fa"
    fasta.write_text("\n".join(body) + "\n")
    flags = ["--kmers", str(k), "--disallow", "Nn", "--sort"]
    if mode == "complements":
        flags.append("--complements")
    elif mode == "canonicals":
        flags.append("--canonicals")
    if soft == "omit":
        flags.append("--omit-softmask")
    elif soft == "map":
        flags.append("--map-softmask")
    # v2 shape space (r5): split columns / sort columns / unsorted /
    # allow — all still byte-compared against the string pipeline
    shape = int(rng.integers(0, 4))
    if shape == 1:
        n_cuts = int(rng.integers(1, 3))
        cuts = [int(rng.integers(-k - 1, k + 2)) for _ in range(n_cuts)]
        flags += ["--split", *map(str, cuts)]
        if rng.integers(0, 2):
            cols = rng.integers(0, n_cuts + 2,
                                size=int(rng.integers(1, 3)))
            flags += ["--sort-cols", *map(str, cols)]
    elif shape == 2:
        flags.remove("--sort")           # unsorted: window-order output
    elif shape == 3 and mode != "complements":
        # allow-filtered (non-closed sets are complements-ineligible on
        # the fast path; either way the string pipelines must agree)
        flags = [f for f in flags if f not in ("Nn", "--disallow")]
        flags += ["--allow", str(rng.choice(["ACGT", "AC", "ACG"]))]
    out = tmp_path / "ours.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "krisp_tpu.cli.kstream", str(fasta), *flags,
         "--output", str(out)],
        capture_output=True, text=True,
        env=_cli_env())
    assert proc.returncode == 0, proc.stderr
    want = string_pipeline(flags, fasta.read_text(), tmp_path)
    assert out.read_text().splitlines() == want


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_device_path_vs_reference(seed, tmp_path):
    fuzz_kstream_point(seed, tmp_path)


@pytest.mark.parametrize("flags", [
    ["--kmers", "9", "--disallow", "Nn", "--sort"],
    ["--kmers", "9", "--disallow", "Nn", "--sort", "--complements"],
    ["--kmers", "9", "--disallow", "Nn", "--sort", "--canonicals"],
    ["--kmers", "15", "--disallow", "Nn", "--sort"],
])
def test_segmented_device_path_parity(flags, tmp_path):
    """A tiny KRISP_TPU_HBM_BUDGET forces the segmented run-merge path;
    output stays byte-identical, including counts of k-mers recurring
    across segment boundaries."""
    import numpy as np
    rng = np.random.default_rng(3)
    # low-complexity body so many k-mers recur in distant segments
    body = "".join(rng.choice(list("ACGT"), p=[.4, .4, .1, .1])
                   for _ in range(3000))
    body = body[:500] + body[:300] + body[500:]   # explicit repeats
    fasta = tmp_path / "in.fa"
    fasta.write_text(f">a\n{body}\n>b\n{body[1000:1400]}\n")
    out = tmp_path / "ours.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "krisp_tpu.cli.kstream", str(fasta), *flags,
         "--output", str(out)],
        capture_output=True, text=True,
        # ~5 segments for this input
        env=_cli_env(KRISP_TPU_HBM_BUDGET="100000"))
    assert proc.returncode == 0, proc.stderr
    want = string_pipeline(flags, fasta.read_text(), tmp_path)
    assert out.read_text().splitlines() == want


def test_segmented_matches_oneshot_directly(tmp_path):
    """Library-level: segmented output bytes == one-shot output bytes."""
    import io
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    from krisp_tpu import kstream_device as kd
    rng = np.random.default_rng(11)
    body = "".join(rng.choice(list("ACGTN")) for _ in range(5000))
    fasta = tmp_path / "in.fa"
    fasta.write_text(f">a\n{body}\n")
    plan = kd.device_plan(kmers=12, canonicals=True, disallow="Nn",
                          sort=True)
    one = io.BytesIO()
    n1 = kd.run_device_kstream(str(fasta), plan, one)
    from krisp_tpu.io.fasta import load_buffer
    buf = load_buffer(str(fasta))
    seg = io.BytesIO()
    n2 = kd._run_segmented(buf, plan, seg, budget=60000)
    assert n1 == n2
    assert one.getvalue() == seg.getvalue()


def test_device_path_no_valid_windows(tmp_path):
    """Records shorter than k produce an empty (not crashing) stream."""
    import io
    import jax
    jax.config.update("jax_platforms", "cpu")
    from krisp_tpu.kstream_device import device_plan, run_device_kstream
    fasta = tmp_path / "in.fa"
    fasta.write_text(">a\nACG\n")
    plan = device_plan(kmers=9, disallow="Nn", sort=True)
    buf = io.BytesIO()
    assert run_device_kstream(str(fasta), plan, buf) == 0
    assert buf.getvalue() == b""


def test_device_overflow_marker_counts(tmp_path):
    """A 15-mer repeated past the 2-bit embed capacity round-trips its
    exact multiplicity through the overflow side channel."""
    import io
    import jax
    jax.config.update("jax_platforms", "cpu")
    from krisp_tpu.kstream_device import device_plan, run_device_kstream
    reps = 7  # > emb_max (3) for k=15
    fasta = tmp_path / "in.fa"
    fasta.write_text(">a\n" + ("ACGTACGTACGTACG" + "N") * reps + "\n")
    plan = device_plan(kmers=15, disallow="Nn", sort=True)
    buf = io.BytesIO()
    n = run_device_kstream(str(fasta), plan, buf)
    lines = buf.getvalue().decode().splitlines()
    assert n == reps
    assert lines == ["ACGTACGTACGTACG"] * reps


def test_device_path_falls_back_on_iupac(tmp_path):
    fasta = tmp_path / "in.fa"
    fasta.write_text(">a\nACGTRACGGTTACA\n")  # R forces the host path
    out = tmp_path / "ours.txt"
    flags = ["--kmers", "5", "--disallow", "Nn", "--sort"]
    proc = subprocess.run(
        [sys.executable, "-m", "krisp_tpu.cli.kstream", str(fasta), *flags,
         "--output", str(out)],
        capture_output=True, text=True,
        env=_cli_env())
    assert proc.returncode == 0, proc.stderr
    want = string_pipeline(flags, fasta.read_text(), tmp_path)
    assert out.read_text().splitlines() == want


def test_parallel_mode_matches_reference(tmp_path, reference_dir):
    """--parallel 2 output parity (ordered imap; reference converges after
    sort, and unsorted parallel output is order-insensitive as a multiset)."""
    args = ["--kmers", "6", "--disallow", "Nn", "--sort", "--parallel", "2"]
    assert run_ours(args, FASTA, tmp_path) == \
        run_reference(reference_dir, args, FASTA)
    args2 = ["--kmers", "5", "--parallel", "2"]
    assert sorted(run_ours(args2, FASTA, tmp_path)) == \
        sorted(run_reference(reference_dir, args2, FASTA))


def test_parse_memory_spec():
    from krisp_tpu.kstream import parse_memory_spec
    assert parse_memory_spec(None) is None
    assert parse_memory_spec("") is None
    assert parse_memory_spec("100b") == 100
    assert parse_memory_spec("2K") == 2048
    assert parse_memory_spec("2") == 2048          # bare = KiB (GNU sort)
    assert parse_memory_spec("1M") == 1 << 20
    assert parse_memory_spec("1.5G") == int(1.5 * (1 << 30))
    import os
    total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert parse_memory_spec("50%") == int(total * 0.5)


def test_external_sort_honors_mem_budget(tmp_path, monkeypatch):
    """A tiny --sort-mem budget forces many small spill chunks; output is
    still totally sorted and identical to the unbounded path."""
    import random

    import krisp_tpu.kstream as ks

    rng = random.Random(3)
    lines = ["".join(rng.choice("ACGT") for _ in range(12))
             for _ in range(4000)]
    spills = []
    real_tmp = ks.tempfile.TemporaryFile

    def counting_tmp(*a, **k):
        spills.append(1)
        return real_tmp(*a, **k)

    monkeypatch.setattr(ks.tempfile, "TemporaryFile", counting_tmp)
    got = list(ks.external_sort(iter(lines), mem="4K"))
    assert got == sorted(lines)
    # 4 KiB budget over ~76-byte lines => ~54 lines per chunk => many spills
    assert len(spills) > 20


def test_cli_sort_mem_bounds_host_engine(tmp_path, monkeypatch):
    """--sort-mem smaller than the host-engine estimate steers an eligible
    job off the host fast path; output bytes are unchanged."""
    from krisp_tpu import kstream_fast

    fasta = tmp_path / "in.fa"
    fasta.write_text(FASTA)
    args = ["--kmers", "8", "--sort"]
    oracle_dir = tmp_path / "a"
    oracle_dir.mkdir()
    want = run_ours(args, FASTA, oracle_dir)

    taken = []
    real = kstream_fast.run_vec_kstream
    monkeypatch.setattr(kstream_fast, "run_vec_kstream",
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    import krisp_tpu.cli.kstream as cli
    out = tmp_path / "o.txt"
    monkeypatch.setenv("KRISP_TPU_KSTREAM_ENGINE", "auto")
    cli.main([str(fasta), "--kmers", "8", "--sort", "--sort-mem", "1b",
              "--output", str(out)])
    assert taken == []                      # budget excluded the host engine
    assert out.read_text().splitlines() == want
