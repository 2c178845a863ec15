"""Host kstream engine: bit-packed u64 keys, no accelerator.

Covers the same plan shapes as the device fast path (one k-mer length,
plain/complements/canonicals, ``--disallow Nn``, softmask policies, sort)
for k <= 64: one uint64 key up to k=32, a two-word (lo, hi) pair for
33..64 (native core only).  The cores share the tables and the output
format byte-for-byte:

- native (default; csrc/kstreamcore.cpp via ctypes): rolling-window pack,
  thread-parallel LSD radix sort, 16-bit-LUT text decode — one C++ call
  per file.
- numpy fallback: window packing as a log-tree of shift/or combines,
  reverse complement as a 2-bit-group bit reversal, quicksort, run-length
  counting, LUT16 decode with overlapping u64 stores.

Neither has per-k-mer Python (the reference's hot loop,
/root/reference/src/krisp/kstream/kstream.py:617-642, is per-character);
KRISP_TPU_KSTREAM_HOST=numpy forces the fallback (the fuzz parity test
pins the two against each other).

Why this exists next to the device engine (kstream_device.py): the k-mer
*content* pulled back from the device is information-dense (2 bits/base of
sorted-random keys — incompressible), so on hosts with a slow accelerator
link the transfer alone can cost more than computing everything locally.
The engine selector (run_fast_kstream) picks sides; output bytes are
identical either way (pinned by
tests/test_kstream_vec.py against the exact string pipeline).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from . import dna
from .io.fasta import load_buffer
from .kstream_device import DevicePlan, content_ok

def _build_lut16() -> np.ndarray:
    """u16 (8 packed bases, MSB-first) -> 8 ASCII chars viewed as one u64.

    One gather per 8 bases turns decode into a handful of vector passes;
    the 512 KB table stays cache-resident.
    """
    v = np.arange(65536, dtype=np.uint32)
    chars = np.empty((65536, 8), np.uint8)
    for j in range(8):
        chars[:, j] = dna.DECODE2[(v >> (14 - 2 * j)) & 3]
    return chars.reshape(-1).view(np.uint64)


_LUT16 = _build_lut16()

#: rows written per output slab (bounds peak memory of decode + repeat)
_SLAB = 1 << 20


def vec_eligible(plan: DevicePlan) -> bool:
    """Host fast path: k <= 32 always (single-u64 numpy or native core);
    33..64 when the native two-word core is available.  The v2 shapes
    (split/sortcols/unsorted) have no numpy mirror — native core only."""
    if plan.v2:
        lib = _load_core()
        return (plan.k <= 64 and lib is not None
                and not getattr(lib, "_no_v2", False))
    return plan.k <= 32 or (plan.k <= 64 and _load_core() is not None)


def native_validity(plan: DevicePlan) -> np.ndarray:
    """Per-byte window validity composing the softmask policy with the
    --allow/--disallow gates in the reference's parser order (mapsoft runs
    BEFORE the allow test, kstream.py:203-235): uppercase ACGT valid iff
    in the allow set (or no set); lowercase dropped under omit-softmask,
    allow-tested as uppercase under map-softmask, and — with neither
    policy — valid only without an allow set (where the content probe
    already excluded it, since it would print unchanged).  N is never
    valid in the 2-bit alphabet (plans guarantee its exclusion)."""
    valid = np.zeros(256, np.bool_)
    allow = plan.allow
    for b in "ACGT":
        ok = allow is None or b in allow
        valid[ord(b)] = ok
        if plan.omit_soft:
            continue
        if plan.map_soft or allow is None:
            valid[ord(b.lower())] = ok
    return valid


def _pack_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """uint32 codes (0..3) -> uint64 keys of every length-k window.

    Log-tree: level s packs 2**s bases starting at each index; k's binary
    decomposition stitches the final key.  O(log k) vector passes, no
    per-window work.  Keys are right-aligned (low 2k bits); numeric order
    equals lexicographic base order because the 2-bit code ranks match
    ASCII order (dna.py).
    """
    n = codes.size
    n_win = n - k + 1
    arrs = {1: codes}
    s = 1
    while 2 * s <= k:
        prev = arrs[s]
        if 4 * s <= 32:                       # still fits uint32
            nxt = (prev[: prev.size - s] << np.uint32(2 * s)) | prev[s:]
        else:
            a = prev[: prev.size - s].astype(np.uint64)
            nxt = (a << np.uint64(2 * s)) | prev[s:]
        arrs[2 * s] = nxt
        s *= 2
    key = np.zeros(n_win, np.uint64)
    off = 0
    for p in sorted(arrs, reverse=True):
        if off + p <= k and (k >> (p.bit_length() - 1)) & 1:
            part = arrs[p][off:off + n_win]
            sh = np.uint64(2 * (k - off - p))
            key |= part.astype(np.uint64) << sh
            off += p
    return key


def _revcomp_keys(fwd: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement key of every window, straight from its forward
    key: complement is a lanewise NOT (3-c in each 2-bit field), base
    order reversal is a 2-bit-group bit reversal (pair swap, nibble swap,
    byte swap), realigned to the low 2k bits.  ~8 vector ops instead of a
    second pack tree."""
    x = ~fwd
    m2 = np.uint64(0x3333333333333333)
    x = ((x & m2) << np.uint64(2)) | ((x >> np.uint64(2)) & m2)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    x = ((x & m4) << np.uint64(4)) | ((x >> np.uint64(4)) & m4)
    return x.byteswap() >> np.uint64(64 - 2 * k)


def _window_ok(valid: np.ndarray, k: int) -> np.ndarray:
    bad = (~valid).astype(np.int32)
    csum = np.concatenate([np.zeros(1, np.int32), np.cumsum(bad,
                                                            dtype=np.int32)])
    return (csum[k:] - csum[:valid.size - k + 1]) == 0


def _decode_rows(uniq: np.ndarray, k: int) -> np.ndarray:
    """Sorted unique keys -> contiguous `<kmer>\\n` text rows (n, k+1).

    Each 8-char LUT gather is stored straight into the output at row
    stride k+1 as an (unaligned) u64 — no post-hoc slicing copy.  When
    8*ceil(k/8) > k+1 an 8-byte store spills a few bytes into the next
    row; storing chunks in DESCENDING order makes the next row's earlier
    chunks (and the newline column, written last) overwrite every spilled
    byte."""
    shift = np.uint64(64 - 2 * k)
    kk = uniq << shift
    n = kk.size
    W = k + 1
    flat = np.empty(n * W + 8, np.uint8)
    for j in range((k + 7) // 8 - 1, -1, -1):
        dst = np.ndarray(shape=(n,), dtype=np.uint64, buffer=flat.data,
                         offset=8 * j, strides=(W,))
        dst[:] = _LUT16[(kk >> np.uint64(48 - 16 * j)).astype(np.uint16)]
    nl = np.ndarray(shape=(n,), dtype=np.uint8, buffer=flat.data, offset=k,
                    strides=(W,))
    nl[:] = ord("\n")
    return flat[:n * W].reshape(n, W)


def _build_keys(codes: np.ndarray, okw: np.ndarray, k: int,
                mode: str) -> np.ndarray:
    """Pack + strand-select + validity-compact the window keys, sharded
    over buffer segments (k-1 overlap) on a thread pool.  Segment results
    are concatenated in arbitrary strand order — the caller sorts."""
    from concurrent.futures import ThreadPoolExecutor

    n_win = okw.size
    T = _n_threads(n_win)

    def work(lo, hi):
        fwd = _pack_keys(codes[lo:hi + k - 1], k)
        ok = okw[lo:hi]
        if mode == "plain":
            return [fwd[ok]]
        rc = _revcomp_keys(fwd, k)
        if mode == "canonicals":
            return [np.minimum(fwd, rc)[ok]]
        return [fwd[ok], rc[ok]]

    if T == 1:
        parts = work(0, n_win)
    else:
        bounds = [i * n_win // T for i in range(T + 1)]
        parts = []
        with ThreadPoolExecutor(max_workers=T) as pool:
            for segs in pool.map(lambda b: work(*b),
                                 zip(bounds, bounds[1:])):
                parts.extend(segs)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _n_threads(n_items: int) -> int:
    import os
    return max(1, min(os.cpu_count() or 1, 4, n_items // 262_144))


def _emit(out_stream, uniq: np.ndarray, counts: np.ndarray, k: int) -> None:
    """Decode sorted unique keys to `<kmer>\\n` rows, repeated per count,
    written in bounded slabs.  Slab decodes run on a small thread pool
    (numpy releases the GIL); writes stay in key order."""
    from concurrent.futures import ThreadPoolExecutor

    plain = bool((counts == 1).all())
    slabs = [slice(lo, min(lo + _SLAB, uniq.size))
             for lo in range(0, uniq.size, _SLAB)]
    with ThreadPoolExecutor(max_workers=_n_threads(uniq.size)) as pool:
        for sl, body in zip(slabs, pool.map(
                lambda sl: _decode_rows(uniq[sl], k), slabs)):
            if plain:
                out_stream.write(body.reshape(-1))
            else:
                out_stream.write(np.repeat(body, counts[sl],
                                           axis=0).reshape(-1))


_CORE = None
_MODE_ID = {"plain": 0, "complements": 1, "canonicals": 2}
_WRITE_FN = ctypes.CFUNCTYPE(ctypes.c_int64,
                             ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64)


def _load_core():
    """Build/load the native engine core (csrc/kstreamcore.cpp); None when
    unavailable (the numpy path below is the complete fallback)."""
    global _CORE
    if _CORE is None:
        from .nativebuild import load_native
        lib = load_native("kstreamcore.cpp",
                          Path(__file__).parent / "_native"
                          / "libkstreamcore.so",
                          extra_flags=["-pthread"])
        if lib is not None:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            args = [u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                    u8p, u8p, u8p, ctypes.c_int, _WRITE_FN]
            lib.kstream_core_run.restype = ctypes.c_int64
            lib.kstream_core_run.argtypes = args
            lib.kstream_core_run_w2.restype = ctypes.c_int64
            lib.kstream_core_run_w2.argtypes = args
            lib.kstream_core_run_multi.restype = ctypes.c_int64
            lib.kstream_core_run_multi.argtypes = [
                args[0], ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int, ctypes.c_int] + args[4:]
            i32p = ctypes.POINTER(ctypes.c_int32)
            try:
                lib.kstream_core_run_v2.restype = ctypes.c_int64
                lib.kstream_core_run_v2.argtypes = [
                    u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int,                   # do_sort
                    i32p, i32p, ctypes.c_int,       # col_src col_len n_cols
                    i32p, ctypes.c_int,             # col_dst permute
                    u8p, u8p, u8p, ctypes.c_int, _WRITE_FN]
            except AttributeError:
                # a prebuilt binary predating the v2 entry (installed
                # package without csrc/): classic shapes keep working,
                # v2 shapes fall back to the string pipeline
                lib._no_v2 = True
        _CORE = lib if lib is not None else False
    return _CORE or None


def split_columns(k: int, spec):
    """Output columns (offset, length) of a k-mer under the reference's
    split walk (kstream.py:805-832 / our KStream._split_one): positive
    sizes consume from the front, negative from the back, sizes clamp to
    what remains; output order is [front parts..., middle, back parts in
    ENCOUNTER order]."""
    front, back = 0, k
    pos, neg = [], []
    for size in spec:
        cur = back - front
        if size >= 0:
            take = min(size, cur)
            pos.append((front, take))
            front += take
        else:
            take = min(-size, cur)
            neg.append((back - take, take))
            back -= take
    return pos + [(front, back - front)] + neg


def v2_layout(k: int, split, sortcols, do_sort):
    """(col_src, col_len, col_dst, permute) int32 arrays for the native v2
    entry.  The sort-key layout is [sort columns (deduped, in order) |
    remaining columns in output order] — numerically equal to GNU sort's
    `-t, -kC,C...` + whole-line last-resort order over the fixed-width
    lines (see csrc/kstreamcore.cpp)."""
    cols = split_columns(k, split) if split else [(0, k)]
    n_cols = len(cols)
    keyc: list = []
    if do_sort and sortcols:
        for c in sortcols:
            if 0 <= c < n_cols and c not in keyc:
                keyc.append(c)
    order = keyc + [c for c in range(n_cols) if c not in keyc]
    dst = [0] * n_cols
    off = 0
    for c in order:
        dst[c] = off
        off += cols[c][1]
    src = np.ascontiguousarray([c[0] for c in cols], np.int32)
    length = np.ascontiguousarray([c[1] for c in cols], np.int32)
    dst_a = np.ascontiguousarray(dst, np.int32)
    permute = int(do_sort and any(dst_a != src))
    return src, length, dst_a, permute


def _run_native_v2(buf: np.ndarray, plan: DevicePlan, out_stream,
                   threads=None):
    """Native execution of the v2 shapes (split/sortcols/unsorted); the
    string pipeline remains the fallback (None) when the core is missing
    or declines."""
    lib = _load_core()
    if lib is None or getattr(lib, "_no_v2", False):
        return None
    k = plan.k
    col_src, col_len, col_dst, permute = v2_layout(
        k, plan.split, plan.sortcols, plan.sort)
    code = np.ascontiguousarray(dna.CODE2_TABLE, np.uint8)
    valid = np.ascontiguousarray(native_validity(plan).astype(np.uint8))
    decode = np.ascontiguousarray(dna.DECODE2[:4], np.uint8)
    buf = np.ascontiguousarray(buf)
    T = _core_threads(buf.size - k + 1, threads)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    cb_error: list = []

    @_WRITE_FN
    def write_cb(data, length):
        try:
            out_stream.write(memoryview(ctypes.cast(
                data, ctypes.POINTER(ctypes.c_uint8 * length)).contents))
            return length
        except BaseException as exc:  # never unwind through C
            cb_error.append(exc)
            return -1

    n_keys = lib.kstream_core_run_v2(
        buf.ctypes.data_as(u8p), buf.size, k, _MODE_ID[plan.mode],
        int(plan.sort),
        col_src.ctypes.data_as(i32p), col_len.ctypes.data_as(i32p),
        col_src.size, col_dst.ctypes.data_as(i32p), permute,
        code.ctypes.data_as(u8p), valid.ctypes.data_as(u8p),
        decode.ctypes.data_as(u8p), T, write_cb)
    if cb_error:
        raise cb_error[0]
    if n_keys < 0:
        return None
    return int(n_keys)


def _core_threads(n_items: int, threads=None) -> int:
    """Native-core team size: the caller's --sort-np when given (the
    reference forwards it to GNU sort --parallel, kstream.py:66-74), else
    a cache-friendly heuristic; always floored by the work available."""
    if threads is not None and threads > 0:
        return max(1, min(int(threads), max(1, n_items // 4096)))
    return max(1, min(os.cpu_count() or 1, 4, n_items // 65536))


def _run_native(buf: np.ndarray, plan: DevicePlan, out_stream,
                threads=None):
    """One native call: rolling pack -> parallel radix sort -> text decode
    (csrc/kstreamcore.cpp), output streamed back through a write callback
    in bounded slabs (peak memory = keys + radix scratch + one slab).
    Same tables, same output bytes as the numpy path (fuzzed equal by
    tests/test_kstream_vec.py).  Returns the line count, or None to fall
    back to numpy."""
    lib = _load_core()
    if lib is None:
        return None
    k = plan.k
    code = np.ascontiguousarray(dna.CODE2_TABLE, np.uint8)
    valid = np.ascontiguousarray(native_validity(plan).astype(np.uint8))
    decode = np.ascontiguousarray(dna.DECODE2[:4], np.uint8)
    buf = np.ascontiguousarray(buf)
    n_win = buf.size - k + 1
    T = _core_threads(n_win, threads)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cb_error: list = []

    @_WRITE_FN
    def write_cb(data, length):
        try:
            out_stream.write(memoryview(ctypes.cast(
                data, ctypes.POINTER(ctypes.c_uint8 * length)).contents))
            return length
        except BaseException as exc:  # never unwind through C
            cb_error.append(exc)
            return -1

    fn = lib.kstream_core_run if k <= 32 else lib.kstream_core_run_w2
    n_keys = fn(
        buf.ctypes.data_as(u8p), buf.size, k, _MODE_ID[plan.mode],
        code.ctypes.data_as(u8p), valid.ctypes.data_as(u8p),
        decode.ctypes.data_as(u8p), T, write_cb)
    if cb_error:
        raise cb_error[0]
    if n_keys < 0:            # native allocation failure
        return None
    return int(n_keys)


def run_vec_kstream(path, plan: DevicePlan, out_stream,
                    buf: np.ndarray | None = None, threads=None):
    """Execute the plan on the host; writes sorted k-mer lines to
    ``out_stream`` (binary).  Returns the line count, or None when the
    input content requires the exact string pipeline (same probe as the
    device path).  ``threads``: the CLI's --sort-np when set (native-core
    team size; the numpy path keeps its own heuristic pool)."""
    if not vec_eligible(plan):
        return None
    k = plan.k
    if buf is None:
        buf = load_buffer(path)
    if not content_ok(buf, plan):
        return None
    if buf.size < k:
        return 0

    if plan.v2:
        # split/sortcols/unsorted: native v2 entry only (no numpy mirror)
        return _run_native_v2(buf, plan, out_stream, threads)
    if k > 32:
        # two-word native core only; no numpy mirror for 33..64
        return _run_native(buf, plan, out_stream, threads)
    if os.environ.get("KRISP_TPU_KSTREAM_HOST", "native") != "numpy":
        n = _run_native(buf, plan, out_stream, threads)
        if n is not None:
            return n

    valid_table = native_validity(plan)
    # Invalid bytes keep their raw 255 code: it stays inside its own
    # 2-bit-aligned lane through every shift/or, so it only corrupts keys
    # of windows that contain the invalid base — exactly the windows the
    # validity mask drops.  No cleanup pass needed.
    raw = dna.CODE2_TABLE[buf]
    valid = valid_table[buf]
    okw = _window_ok(valid, k)

    keys = _build_keys(raw.astype(np.uint32), okw, k, plan.mode)
    del raw, valid, okw

    total = keys.size
    if total == 0:
        return 0
    keys.sort()
    change = np.empty(total, bool)
    change[0] = True
    np.not_equal(keys[1:], keys[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    counts = np.diff(np.append(starts, total))
    _emit(out_stream, keys[starts], counts, k)
    return int(total)


def run_multi_k_kstream(path, ks, mode, omit_soft, map_soft, out_stream,
                        buf: np.ndarray | None = None, mem=None,
                        threads=None):
    """Multi-k sorted stream through the native core: per-k sorted aligned
    key arrays merged lexicographically (a shorter k-mer that prefixes a
    longer one sorts first, matching LC_ALL=C line order).  Returns the
    line count, or None when ineligible (no native core, content probe,
    or host-memory budget) — the caller falls back to the exact string
    pipeline.  ``mem`` (GNU sort -S grammar, the CLI's --sort-mem) caps
    the budget the same way run_fast_kstream does; ``threads`` is the
    CLI's --sort-np."""
    lib = _load_core()
    if lib is None or not ks or any(k < 1 or k > 64 for k in ks):
        return None
    if len(set(ks)) != len(ks):
        return None            # duplicate lengths: exact pipeline handles
    probe = DevicePlan(k=max(ks), mode=mode, omit_soft=omit_soft,
                      map_soft=map_soft)
    if buf is None:
        buf = load_buffer(path)
    if not content_ok(buf, probe):
        return None
    strands = 2 if mode == "complements" else 1
    est = buf.size * strands * 32 * len(ks) + (1 << 26)
    from .kstream_fast import _mem_available
    budget = int(os.environ.get("KRISP_TPU_HOST_BUDGET",
                                max(_mem_available() // 2, 1 << 30)))
    if mem is not None:
        from .kstream import parse_memory_spec
        budget = min(budget, parse_memory_spec(mem))
    if est > budget:
        return None
    code = np.ascontiguousarray(dna.CODE2_TABLE, np.uint8)
    valid = np.ascontiguousarray(
        dna.base_validity_table(2, disallow="Nn",
                                omit_soft=omit_soft), np.uint8)
    decode = np.ascontiguousarray(dna.DECODE2[:4], np.uint8)
    buf = np.ascontiguousarray(buf)
    ks_arr = np.ascontiguousarray(sorted(ks), np.int32)
    T = _core_threads(buf.size, threads)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cb_error: list = []

    @_WRITE_FN
    def write_cb(data, length):
        try:
            out_stream.write(memoryview(ctypes.cast(
                data, ctypes.POINTER(ctypes.c_uint8 * length)).contents))
            return length
        except BaseException as exc:  # never unwind through C
            cb_error.append(exc)
            return -1

    n_keys = lib.kstream_core_run_multi(
        buf.ctypes.data_as(u8p), buf.size, 
        ks_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(ks), _MODE_ID[mode],
        code.ctypes.data_as(u8p), valid.ctypes.data_as(u8p),
        decode.ctypes.data_as(u8p), T, write_cb)
    if cb_error:
        raise cb_error[0]
    if n_keys < 0:
        return None
    return int(n_keys)
