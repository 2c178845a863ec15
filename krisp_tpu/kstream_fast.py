"""kstream engine selector: host-vectorized vs device fast path.

Both engines emit byte-identical sorted k-mer streams (each pinned against
the exact string pipeline); they differ in where the work runs:

- ``host`` (kstream_vec.py): numpy/native u64-key pipeline, k <= 64.  No
  accelerator round-trip: sorted-unique k-mer content is ~2 bits/base of
  incompressible data, all of which the device engine must pull back over
  the host link.
- ``device`` (kstream_device.py): packed-key device pipeline with
  mesh-sharded and disk-spill segmented modes; the engine for keys past
  the native core (k > 64) and inputs past host RAM.

``auto`` picks host for eligible jobs that fit the host-memory budget and
falls back to device otherwise.  KRISP_TPU_KSTREAM_ENGINE overrides.
"""

from __future__ import annotations

import os

from .io.fasta import load_buffer
from .kstream_device import DevicePlan, run_device_kstream
from .kstream_vec import run_vec_kstream, vec_eligible


def _mem_available() -> int:
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30


def host_bytes_estimate(n_bases: int, plan: DevicePlan) -> int:
    """Peak host-engine footprint, whichever of its two cores runs: the
    numpy path (u32 codes + u64 keys per strand + u64 temp + validity/raw
    bytes + slab-bounded decode) or the native core (keys + radix scratch
    per strand; decoded text streams out in bounded slabs).  v2 shapes
    run native-only (u64 keys to k=32, two-word beyond)."""
    strands = 2 if plan.mode == "complements" else 1
    key_bytes = 8 if plan.k <= 32 else 16
    native_peak = n_bases * strands * 2 * key_bytes + n_bases
    if plan.v2:
        return native_peak + (1 << 26)   # no numpy mirror for v2 shapes
    numpy_peak = n_bases * (4 + 8 * strands + 8 + 2)
    return max(numpy_peak, native_peak) + (1 << 26)


def run_fast_kstream(path, plan: DevicePlan, out_stream, engine: str = "auto",
                     mem=None, threads=None):
    """Run the plan on the selected engine.  Returns the emitted line
    count, or None when the input content requires the exact string
    pipeline (IUPAC/RNA/case probe — identical for both engines).

    ``mem``: a GNU ``sort -S``-style spec (the CLI's --sort-mem).  When
    given it caps the host engine's memory budget, steering jobs past the
    cap onto the device engine's spill-segmented path — the device analog
    of bounding GNU sort's buffer.  ``threads``: the CLI's --sort-np (host
    native-core team size; mirrors GNU sort --parallel,
    reference kstream.py:66-74)."""
    engine = os.environ.get("KRISP_TPU_KSTREAM_ENGINE", engine)
    if engine not in ("auto", "host", "device"):
        raise ValueError(f"unknown kstream engine {engine!r}")

    if engine in ("auto", "host") and vec_eligible(plan):
        buf = load_buffer(path)
        budget = int(os.environ.get("KRISP_TPU_HOST_BUDGET",
                                    max(_mem_available() // 2, 1 << 30)))
        if mem is not None:
            from .kstream import parse_memory_spec
            budget = min(budget, parse_memory_spec(mem))
        if engine == "host" or host_bytes_estimate(buf.size, plan) <= budget:
            return run_vec_kstream(path, plan, out_stream, buf=buf,
                                   threads=threads)
    if engine == "host" or plan.host_only:
        # host-only shapes (split/sortcols/unsorted/allow) never route to
        # the device program; over-budget or forced-device jobs take the
        # bounded string pipeline instead
        return None

    from .runtime import setup
    setup()
    return run_device_kstream(path, plan, out_stream)
