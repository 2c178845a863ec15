"""Device-accelerated kstream fast path.

The reference's published kstream workloads (README.md:294-312) are
"extract all k-mers, filter, sort" over large FASTA — the exact shape of
the device engine.  This module routes eligible configurations through the
packed-key pipeline: windows -> (optional revcomp/canonical) -> device LSD
sort -> run-length counts -> vectorized text decode, emitting the identical
byte stream the string pipeline produces.

Eligibility (``device_plan`` + a content probe): one k-mer length;
plain, complements, or canonicals; N exclusion via ``--disallow Nn`` or
an ACGT-subset ``--allow``; softmask policies; DNA input whose residues
are ACGT/N (lowercase only under a softmask policy or an allow filter).
The DEVICE program itself runs the sorted single-column shapes; the
split/sort-cols/unsorted/allow shapes are host-native-core only
(``DevicePlan.host_only`` — kstream_vec.py's v2 entry).  Everything
else returns None and the caller falls back to the exact string
pipeline (krisp_tpu.kstream).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import dna
from .io.fasta import load_buffer, bucket_size


@dataclass
class DevicePlan:
    k: int
    mode: str            # "plain" | "complements" | "canonicals"
    omit_soft: bool
    map_soft: bool
    #: --allow set (uppercase ACGT subset), or None; rides the validity
    #: table on the host native core (kstream_vec.native_validity)
    allow: str | None = None
    #: --split column sizes (reference clamped front/back walk,
    #: kstream.py:805-832); None = single whole-kmer column
    split: tuple | None = None
    #: --sort-cols indices (0-based, into the OUTPUT column order)
    sortcols: tuple | None = None
    #: False = emit in window order (unsorted jobs skip the sort phase)
    sort: bool = True

    @property
    def v2(self) -> bool:
        """Shapes that need the native v2 entry (split/sortcols/unsorted);
        these run on the host native core only — no numpy mirror, no
        device program."""
        return (not self.sort) or self.split is not None

    @property
    def host_only(self) -> bool:
        """Shapes outside the device engine's coverage."""
        return self.v2 or self.allow is not None


_COMP_BASE = {"A": "T", "T": "A", "C": "G", "G": "C"}


def device_plan(kmers=None, complements=False, canonicals=False, allow=None,
                disallow=None, omitsoft=False, mapsoft=False,
                expandiupac=False, split=None, sort=False, sortcols=None):
    """Return a DevicePlan when the configuration is fast-path eligible.

    Coverage (anything else returns None and the exact string pipeline
    runs): one k-mer length; plain/complements/canonicals; N exclusion via
    ``--disallow Nn`` or an ACGT-subset ``--allow``; softmask policies;
    sorted or unsorted; ``--split`` columns with ``--sort-cols``;
    ``--expand-iupac`` (an identity on the ACGT-only content the probe
    admits — N windows are excluded by the gates above, so there is
    nothing to expand)."""
    if kmers is None:
        return None
    klist = kmers if isinstance(kmers, (list, tuple)) else [kmers]
    if len(klist) != 1 or klist[0] > 512 or klist[0] < 1:
        return None
    k = klist[0]
    # N exclusion: required so no valid window can carry an uncodeable N
    nn_disallow = disallow is not None and set(disallow) == {"N", "n"}
    if allow is not None:
        if not allow or not set(allow) <= set("ACGT"):
            return None
        if complements and any(_COMP_BASE[b] not in allow for b in allow):
            # the reference filters fwd and revcomp INDEPENDENTLY after
            # adding complements (kstream.py:203-235 order); per-window
            # validity models that only for complement-closed sets
            return None
        if not nn_disallow and disallow is not None:
            return None          # other disallow sets: string pipeline
    elif not nn_disallow:
        return None
    mode = ("canonicals" if canonicals
            else "complements" if complements else "plain")
    split_t = None
    if split is not None:
        split_t = (split,) if isinstance(split, int) else tuple(split)
    sortcols_t = None
    if sort and sortcols and split_t is not None:
        if any(c < 0 for c in sortcols):
            return None          # negative indices: string-pipeline quirk
        sortcols_t = tuple(sortcols)
    if (split_t is not None or not sort) and k > 64:
        return None              # v2 shapes live in the <=64 native core
    return DevicePlan(k=k, mode=mode, omit_soft=omitsoft,
                      map_soft=mapsoft, allow=allow, split=split_t,
                      sortcols=sortcols_t, sort=bool(sort))


def content_ok(buf, plan: DevicePlan) -> bool:
    """Content probe shared by the device and host-vectorized engines:
    they cover ACGT/N input (case per softmask policy — or under --allow,
    where lowercase windows are dropped by validity); anything else (IUPAC
    residues, RNA, lowercase that would pass through unchanged) falls back
    to the exact string pipeline."""
    present = np.zeros(256, bool)
    present[buf] = True
    allowed = np.zeros(256, bool)
    for b in "ACGTN":
        allowed[ord(b)] = True
    allowed[0] = True
    if plan.omit_soft or plan.map_soft or plan.allow is not None:
        for b in "acgtn":
            allowed[ord(b)] = True
    return not present[~allowed].any()


def run_device_kstream(path, plan: DevicePlan, out_stream):
    """Execute the plan; writes sorted k-mer lines to ``out_stream``
    (binary).  Returns line count, or None when the input content forces a
    fallback to the host pipeline (IUPAC residues, RNA, lowercase without a
    softmask policy)."""
    if plan.host_only:
        return None          # split/sortcols/unsorted/allow: host engine
    k = plan.k
    buf = load_buffer(path)
    if not content_ok(buf, plan):
        return None

    padded = np.zeros(bucket_size(buf.size), np.uint8)
    padded[:buf.size] = buf

    bits = 2
    # Device-memory guard: the one-shot program materializes the full
    # window table (fwd+rc rows x key words + counts, double-buffered
    # through the LSD sort).  Past the budget, switch to the segmented
    # path: device-sorted unique runs spilled to disk, merged on the host
    # (the external-sort architecture with device-accelerated run
    # generation).
    from .engine.pipeline import fused_budget
    _w = (2 * k + 31) // 32
    est_bytes = int(padded.size) * 2 * (_w + 1) * 4 * 3
    budget = fused_budget()

    from .parallel.distributed import mesh_from_env
    mesh = mesh_from_env()
    if mesh is not None and est_bytes // mesh.devices.size <= budget:
        try:
            n = _run_sharded(buf, plan, out_stream, mesh)
        except Exception as exc:        # device OOM -> single-device paths
            if ("RESOURCE_EXHAUSTED" not in str(exc)
                    and "Out of memory" not in str(exc)):
                raise
            n = None
        if n is not None:
            return n

    if est_bytes > budget:
        return _run_segmented(buf, plan, out_stream, budget)
    mode = plan.mode
    spare, embed = _embed_params(k, bits)
    stage = _build_stage(k, mode, bits, plan.omit_soft)

    import os
    import time
    timing = os.environ.get("KRISP_TPU_TIMING")
    t0 = time.perf_counter()
    try:
        pulled = _run_stage(stage, padded, embed, spare)
    except Exception as exc:            # device OOM etc. -> host fallback
        if "RESOURCE_EXHAUSTED" in str(exc) or "Out of memory" in str(exc):
            return None
        raise
    words_h, reps, n_unique, sub_nbytes, cap = pulled
    t1 = time.perf_counter()

    chars = _decode_chars(words_h, n_unique, k, bits, newline=True)
    t3 = time.perf_counter()

    if (reps == 1).all():
        out_stream.write(chars.tobytes())
    else:
        out_stream.write(np.repeat(chars, reps, axis=0).tobytes())
    if timing:
        import sys as _sys
        print(f"kstream-device: stage+pull {t1-t0:.3f}s "
              f"({sub_nbytes/1e6:.1f} MB, cap {cap} of {n_unique} unique)  "
              f"decode {t3-t1:.3f}s  "
              f"expand+write {time.perf_counter()-t3:.3f}s",
              file=_sys.stderr)
    return int(reps.sum())


def _embed_params(k, bits):
    """(spare bits in the last key word, whether counts embed there)."""
    n_words = (bits * k + 31) // 32
    spare = 32 * n_words - bits * k
    return spare, spare >= 2


def mode_keys(ok, words, mode, start_limit=None):
    """fwd/rc split + per-mode key selection + sentinel masking, shared by
    the one-shot stage, the segmented path, and the mesh-sharded path
    (parallel/kstream_shard.py) so the mode semantics cannot drift.

    ``ok``/``words`` are window_keys_bits outputs (forward rows then
    reverse complements).  ``start_limit`` masks windows whose START index
    is past it (segment/shard overlap tails give context only).
    Returns (keys list with invalid rows sentinel-marked, validity mask)."""
    import jax.numpy as jnp
    from .ops.intersect import SENTINEL

    n_win = ok.shape[0] // 2
    fwd = [w[:n_win] for w in words]
    rc = [w[n_win:] for w in words]
    okw = ok[:n_win]
    if start_limit is not None:
        okw = okw & (jnp.arange(n_win) < start_limit)
    if mode == "plain":
        use, okk = fwd, okw
    elif mode == "complements":
        use = [jnp.concatenate([a, b]) for a, b in zip(fwd, rc)]
        okk = jnp.concatenate([okw, okw])
    else:  # canonicals: lexicographic min of fwd/rc keys
        less = jnp.zeros(n_win, bool)
        decided = jnp.zeros(n_win, bool)
        for a, b in zip(fwd, rc):
            less = jnp.where(~decided & (a != b), a < b, less)
            decided = decided | (a != b)
        use = [jnp.where(less | ~decided, a, b) for a, b in zip(fwd, rc)]
        okk = okw
    return [jnp.where(okk, w, SENTINEL) for w in use], okk


def _build_stage(k, mode, bits, omit_soft, start_limit=None):
    """Jitted device program: windows -> mode keys -> sort -> dedup ->
    compaction, counts embedded in the spare key bits when possible.

    ``start_limit``: only windows STARTING at buffer index < start_limit
    are counted — the segmented path gives each segment an overlap tail of
    k-1 bases for context while the tail's window starts belong to the
    next segment.

    Count embedding: valid keys occupy the top bits*k bits of the word
    row, so the last word keeps ``spare`` zero low bits.  Small
    multiplicities ride there for free, shrinking the device->host pull
    from W+1 to W u32 rows per unique k-mer.  The all-ones value is an
    overflow marker:
    those rows' exact counts come from a second (rare) pull of the count
    row."""
    import jax
    import jax.numpy as jnp
    from .ops.encode import window_keys_bits
    from .ops.sort import lsd_sort
    from .ops.intersect import SENTINEL, dedup_sorted

    code_table = dna.CODE2_TABLE
    comp_table = dna.COMP2_TABLE
    valid_table = dna.base_validity_table(bits, disallow="Nn",
                                          omit_soft=omit_soft)
    spare, embed = _embed_params(k, bits)
    emb_max = jnp.uint32((1 << spare) - 1) if embed else None

    @jax.jit
    def stage(buffer):
        ok, words = window_keys_bits(buffer, code_table, valid_table,
                                     comp_table, k, 0, 0, bits, 1)
        use, okk = mode_keys(ok, words, mode, start_limit)
        sorted_w, _ = lsd_sort(use)
        words_out, cnt = dedup_sorted(sorted_w,
                                      jnp.sum(okk.astype(jnp.int32)))
        # duplicate rows were sentinel-marked by dedup_sorted; one more
        # sort sweeps them to the tail (heads keep their relative order:
        # they are already strictly increasing), so the unique table is a
        # PREFIX and the host pulls cap rows of packed words instead of
        # the full window count of decoded text
        words_c, (cnt_c,) = lsd_sort(words_out, [cnt])
        n_unique = jnp.sum((cnt > 0).astype(jnp.int32))
        if embed:
            cnt_u = cnt_c.astype(jnp.uint32)
            last = words_c[-1] | jnp.minimum(cnt_u, emb_max)
            packed = jnp.stack(list(words_c[:-1]) + [last])
            n_over = jnp.sum(((cnt_u >= emb_max) & (cnt_u > 0))
                             .astype(jnp.int32))
        else:
            packed = jnp.concatenate([jnp.stack(words_c), cnt_c[None]],
                                     axis=0)
            n_over = jnp.int32(0)
        stats = jnp.stack([n_unique, n_over])
        return packed, cnt_c, stats

    return stage


def _run_stage(stage, padded, embed, spare):
    """Dispatch + pull one stage run.  Returns (words_h rows, reps int64,
    n_unique, pulled bytes, cap)."""
    packed_d, cnt_d, stats_d = stage(padded)
    stats = np.asarray(stats_d)         # one tiny pull syncs the program
    n_unique, n_over = int(stats[0]), int(stats[1])
    cap = 1
    while cap < max(n_unique, 1):
        cap *= 2
    cap = min(cap, packed_d.shape[1])
    sub = np.asarray(packed_d[:, :cap])
    if embed:
        words_h = sub
        mask = np.uint32((1 << spare) - 1)
        reps = (sub[-1][:n_unique] & mask).astype(np.int64)
        if n_over:
            # rare: some count saturated the spare bits; pull exact counts
            exact = np.asarray(cnt_d[:cap])[:n_unique].astype(np.int64)
            reps = np.where(reps == int(mask), exact, reps)
    else:
        words_h = sub[:-1]
        reps = sub[-1][:n_unique].astype(np.int64)
    return words_h, reps, n_unique, sub.nbytes, cap


def _decode_chars(words_h, n_unique, k, bits, newline):
    """Vectorized text decode of the unique key table."""
    from .ops.encode import KeyLayout

    layout = KeyLayout(k, 0, 0, bits, 1)
    off_flank, _ = layout.base_offsets()
    chars = np.empty((n_unique, k + (1 if newline else 0)), np.uint8)
    for i, off in enumerate(off_flank):
        w, bit = off // 32, off % 32
        sh = np.uint32(32 - bit - bits)
        chars[:, i] = dna.DECODE2[(words_h[w][:n_unique] >> sh) & 3]
    if newline:
        chars[:, k] = ord("\n")
    return chars


def _run_sharded(buf, plan: DevicePlan, out_stream, mesh):
    """Multi-device run: sequence-sharded extraction + key-range-owned
    sorted unique tables (parallel/kstream_shard.py), decoded and emitted
    in mesh (= global key) order — byte-identical to the one-shot path.
    Returns None when the input is too short to shard (the caller takes
    its single-device path)."""
    from .parallel.kstream_shard import sharded_kstream_table

    k = plan.k
    sharded = sharded_kstream_table(mesh, buf, k, plan.mode,
                                    plan.omit_soft)
    if sharded is None:
        return None
    words, cnts = sharded
    n_unique = words.shape[1]
    chars = _decode_chars(list(words), n_unique, k, 2, newline=True)
    if n_unique and (cnts == 1).all():
        out_stream.write(chars.tobytes())
    elif n_unique:
        out_stream.write(np.repeat(chars, cnts, axis=0).tobytes())
    return int(cnts.sum())


def _run_segmented(buf, plan: DevicePlan, out_stream, budget):
    """Inputs past the HBM budget: fixed-size segments (k-1 overlap for
    window context) each sorted/deduped on device, unique (k-mer, count)
    runs spilled to disk, then one host merge summing counts of k-mers
    that recur across segments.  Byte-identical to the one-shot path."""
    import heapq
    import itertools
    import tempfile

    k = plan.k
    bits = 2
    n_words = (bits * k + 31) // 32
    per_window = 2 * (n_words + 1) * 4 * 3
    S = max(int(budget) // per_window, max(k, 4096))
    if buf.size <= S:                    # only one segment: not actually
        S = buf.size                     # over budget; still correct
    P = bucket_size(S + k - 1)
    spare, embed = _embed_params(k, bits)
    stage = _build_stage(k, plan.mode, bits, plan.omit_soft, start_limit=S)

    runs = []
    with tempfile.TemporaryDirectory(prefix="kstream_seg_") as td:
        for si, off in enumerate(range(0, int(buf.size), S)):
            seg = buf[off:off + S + k - 1]
            padded = np.zeros(P, np.uint8)
            padded[:seg.size] = seg
            words_h, reps, n_unique, _, _ = _run_stage(stage, padded,
                                                       embed, spare)
            if n_unique == 0:
                continue
            chars = _decode_chars(words_h, n_unique, k, bits, newline=False)
            txt = f"{td}/run{si}.kmers"
            cnt = f"{td}/run{si}.npy"
            with open(txt, "wb") as fh:
                fh.write(chars.tobytes())
            np.save(cnt, reps)
            runs.append((txt, cnt))

        def run_iter(txt_path, cnt_path):
            counts = np.load(cnt_path)
            with open(txt_path, "rb") as fh:
                i = 0
                while True:
                    block = fh.read(k * 65536)
                    if not block:
                        break
                    for j in range(0, len(block), k):
                        yield block[j:j + k], int(counts[i])
                        i += 1

        total = 0
        merged = heapq.merge(*(run_iter(t, c) for t, c in runs),
                             key=lambda t: t[0])
        for kmer, grp in itertools.groupby(merged, key=lambda t: t[0]):
            n = sum(c for _, c in grp)
            total += n
            line = kmer + b"\n"
            while n > 0:                 # bounded expansion buffers
                m = min(n, 65536)
                out_stream.write(line * m)
                n -= m
    return total
