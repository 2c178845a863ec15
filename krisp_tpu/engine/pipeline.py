"""End-to-end k-mer intersection pipeline (the krisp_fasta engine).

Host orchestration of the device kernels:

  FASTA -> uint8 buffers -> [ONE fused device program: per-genome window
  keys -> LSD sort -> duplicate collapse; global (flank, genome) sort ->
  survivor marking -> capped compaction] -> host decode of the (small)
  survivor set -> FlankGroup objects.

This replaces the reference's four file-based stages
(/root/reference/src/krisp/krisp_fasta/krisp_fasta.py:237-290: per-file
extract+GNU-sort, tournament merge, ingroup filter, parallel render) with a
single device dispatch and a host epilogue; no temp files, no subprocesses.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .. import dna
from ..io.fasta import load_buffer, bucket_size, simple_name
from ..metrics import GLOBAL as METRICS
from ..ops.encode import KeyLayout, window_keys_bits
from ..ops.sort import lsd_sort
from ..ops.intersect import SENTINEL, dedup_sorted
from .groups import FlankGroup, KmerAmplicon


@dataclass
class KmerGeometry:
    left: int      # conserved flank length on the left
    mid: int       # diagnostic region length
    right: int     # conserved flank length on the right

    @property
    def total(self) -> int:
        return self.left + self.mid + self.right


def solve_geometry(amplicon=None, diagnostic=None, conserved=None,
                   conserved_left=None, conserved_right=None) -> KmerGeometry:
    """Derive (left, mid, right) from any sufficient flag subset
    (parity: krisp_fasta.py:178-213)."""
    if amplicon is not None:
        if diagnostic is not None:
            conserved = (amplicon - diagnostic) // 2
            return KmerGeometry(conserved, diagnostic, conserved)
        if conserved is not None:
            return KmerGeometry(conserved, amplicon - 2 * conserved, conserved)
        if conserved_left is not None and conserved_right is not None:
            return KmerGeometry(conserved_left,
                                amplicon - conserved_left - conserved_right,
                                conserved_right)
        raise ValueError("Could not deduce input parameters")
    if diagnostic is not None:
        if conserved is not None:
            return KmerGeometry(conserved, diagnostic, conserved)
        if conserved_left is not None and conserved_right is not None:
            return KmerGeometry(conserved_left, diagnostic, conserved_right)
    raise ValueError("Could not deduce input parameters")


def detect_bits(buffers) -> int:
    """Choose a common per-base encoding width for a set of genome buffers."""
    return max(dna.choose_bits(buf) for buf in buffers)


def _pack_genomes_host(stacked: np.ndarray, omit_soft: bool):
    """2-bit code pack + validity bitmap (host side, bits == 2 only).

    The softmask/disallow policy folds into the bitmap here, so the device
    reconstructs a canonical A/C/G/T/N buffer with identical per-base
    (code, validity) — at 3.75 bits/base of host->device upload instead
    of 8."""
    code_np = np.asarray(dna.CODE2_TABLE, np.uint8)
    valid_np = np.asarray(dna.base_validity_table(2, disallow="Nn",
                                                  omit_soft=omit_soft))
    F, P = stacked.shape
    c = (code_np[stacked] & 3).reshape(F, P // 4, 4)
    # pack 4 bases/byte in uint8 space (no wide temporaries), then view the
    # little-endian byte stream as uint32: base k lands at bit 2k — the
    # layout ops.intersect.unpack_genomes expects
    byte = (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
            | (c[:, :, 3] << 6))
    packed = np.ascontiguousarray(byte).view(np.uint32).reshape(F, P // 16)
    valid = valid_np[stacked].astype(bool)
    vbits = np.packbits(valid, axis=1, bitorder="little")
    return packed, vbits


def _encoding_tables(bits: int, omit_soft: bool):
    code_table = dna.CODE2_TABLE if bits == 2 else dna.CODE4_TABLE
    comp_table = dna.COMP2_TABLE if bits == 2 else dna.COMP4_TABLE
    valid_table = dna.base_validity_table(bits, disallow="Nn",
                                          omit_soft=omit_soft)
    return code_table, valid_table, comp_table


def genome_unique_table(buffer: np.ndarray, geom: KmerGeometry, bits: int,
                        omit_soft: bool, n_files: int = 1):
    """Device stage for one genome: sorted, duplicate-collapsed k-mer table
    in the bit-packed KeyLayout (genome-id field zero; the global stage
    ORs it in).  One key layout serves every path — the fused, sharded,
    and checkpoint engines all speak KeyLayout rows.

    Matches ``extractSortedKmers`` semantics (krisp_fasta.py:16-66): k-mers
    of the full amplicon length, 'N'/'n' disallowed, both strands added
    (complements=True, NOT canonicalized), soft-masked k-mers dropped
    (--omit-soft) or uppercased (default), sorted by (left, right) flank.
    The genome-id field doubles as the validity marker, so every geometry
    is sentinel-unambiguous (valid rows always sort before sentinels).

    Returns (words uint32[W, n], counts uint32[n]); rows with count 0 are
    sentinel (duplicate or masked) rows.
    """
    code_table, valid_table, comp_table = _encoding_tables(bits, omit_soft)
    ok, words = window_keys_bits(buffer, code_table, valid_table, comp_table,
                                 geom.left, geom.mid, geom.right, bits,
                                 n_files)
    n_valid = jnp.sum(ok.astype(jnp.int32))
    flat = [jnp.where(ok, w, SENTINEL) for w in words]
    sorted_w, _ = lsd_sort(flat)
    words_out, cnt = dedup_sorted(sorted_w, n_valid)
    return jnp.stack(words_out), cnt


def _genome_table_chunked(path, geom, bits, omit_soft, chunk_size,
                          n_files=1):
    """Per-genome table computed in bounded device chunks (out-of-core
    path for genomes larger than the HBM budget).

    Chunk i owns window starts [i*C, (i+1)*C) and reads the buffer slice
    [i*C, (i+1)*C + L - 1) — exact coverage, no double counting (the same
    halo-overlap scheme as the device mesh, parallel/distributed.py).
    Duplicate k-mers recurring across chunks stay as separate rows with
    partial counts; the global intersection's label merge sums them.
    """
    buf = load_buffer(path)
    L = geom.total
    word_parts, cnt_parts = [], []

    def collect(item):
        words = np.asarray(item[0])
        counts = np.asarray(item[1])
        # drop rows whose window start falls beyond this chunk's range (the
        # padding past the chunk is sentinel, so only real dups remain)
        mask = counts > 0
        word_parts.append(words[:, mask])
        cnt_parts.append(counts[mask])

    # double buffering: JAX dispatch is async, so launching chunk i+1
    # before materializing chunk i overlaps its upload+compute with the
    # previous chunk's pull and host-side filtering
    pending = None
    start = 0
    while start < buf.size:
        end = min(start + chunk_size, buf.size)
        piece = buf[start:min(end + L - 1, buf.size)]
        if piece.size < L:
            break  # no window can start in this tail
        padded = np.zeros(bucket_size(piece.size), np.uint8)
        padded[:piece.size] = piece
        launched = genome_unique_table(padded, geom, bits, omit_soft,
                                       n_files)
        if pending is not None:
            collect(pending)
        pending = launched
        start = end
    if pending is not None:
        collect(pending)
    # sorted sub-run offsets: one per chunk (the range-partitioned global
    # stage slices any key range out of each run by binary search)
    lens = [w.shape[1] for w in word_parts]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return (np.concatenate(word_parts, axis=1),
            np.concatenate(cnt_parts), offsets)


def _cached_parts(paths, geom, bits, omit_soft, workdir, layout,
                  chunk_size=None):
    """Per-genome unique tables via the TableCache (checkpoint/resume
    path): load hits, compute+store misses.  Returns a list of
    (words [W, n] uint32, counts uint32[n], offsets int64[k+1]) per
    genome — KeyLayout rows with the genome-id field OR'd in, sorted
    within each offsets-delimited sub-run — the input format of the
    range-partitioned global stage (engine/bigscale.py)."""
    import os as _os

    from .checkpoint import TableCache

    if chunk_size is None:
        chunk_size = int(_os.environ.get("KRISP_TPU_CHUNK_BASES", 64 << 20))
    n_files = len(paths)
    fword, fshift = layout.file_word_shift()
    cache = TableCache(workdir)
    parts = []
    for file_idx, path in enumerate(paths):
        hit = cache.load(path, geom, bits, omit_soft, n_files)
        if hit is None:
            with METRICS.stage("extract+sort"):
                words, counts, offsets = _genome_table_chunked(
                    path, geom, bits, omit_soft, chunk_size, n_files)
            cache.store(path, geom, bits, omit_soft, words, counts,
                        offsets, n_files)
        else:
            words, counts, offsets = hit
        # OR the genome id into the key: the id field is zero in every
        # stored row and identical across a table, so sub-run sort order
        # is untouched
        words = words.copy()
        words[fword] |= np.uint32(file_idx << fshift)
        parts.append((words, counts, offsets))
    return parts


#: device bytes per padded base that the fused one-shot program holds at
#: its peak (both strands' window keys plus the sort's operands).  Peaks
#: measured on an H100: ~70 at the 25/1/2 spacer geometry, ~104 at the
#: 30/40/30 amplicon geometry (5 x 20 Mb genomes)
FUSED_BYTES_PER_BASE = 112

#: share of the device's allocatable memory the fused program may plan on
FUSED_BUDGET_FRACTION = 0.5


def fused_bytes_estimate(buffers) -> int:
    """Peak device bytes the fused one-shot program needs for ``buffers``."""
    return FUSED_BYTES_PER_BASE * sum(bucket_size(b.size) for b in buffers)


def fused_budget() -> int:
    """Device bytes the fused program may use before the staged path takes
    over: KRISP_TPU_HBM_BUDGET, else a share of the device's memory limit
    (8 GiB where the backend reports none)."""
    from ..runtime import device_budget
    return device_budget("KRISP_TPU_HBM_BUDGET", FUSED_BUDGET_FRACTION,
                         8 << 30)


def _mesh_for_run(layout, n_devices):
    """Pick a device mesh for the fused path: explicit request via
    ``n_devices`` or the KRISP_TPU_DEVICES env var, else every available
    device.  Returns None (single-device fused program) when only one
    device is usable or the flank is too short to key-range partition."""
    import os
    devs = jax.devices()
    if n_devices is None:
        env = os.environ.get("KRISP_TPU_DEVICES")
        n_devices = int(env) if env else len(devs)
    n = min(int(n_devices), len(devs))
    if n <= 1:
        return None
    bbits = max((n - 1).bit_length(), 1)
    if layout.flank_bits < bbits:
        return None
    from ..parallel.distributed import make_mesh
    return make_mesh(n)


def run_pipeline(files, outgroup, geom: KmerGeometry, omit_soft: bool = False,
                 ingroup_filter: bool | None = None,
                 workdir: str | None = None, n_devices: int | None = None):
    """Run the full intersection for ingroup ``files`` + ``outgroup`` files.

    Returns a list of FlankGroup in deterministic sorted-key order.
    ``ingroup_filter`` defaults to the reference's gate: apply the
    ingroup-unique-column filter iff there is a diagnostic region
    (krisp_fasta.py:264-272) — note the reference applies it whenever
    mid > 0, with an empty ingroup set meaning "no filtering"
    (filterAlignments.py:31-40 skips when the ingroup set is empty, and
    the rendering ingroup is only set when outgroups exist).
    """
    all_files = list(files) + list(outgroup)
    tags = [simple_name(f) for f in all_files]
    ingroup_tags = frozenset(simple_name(f) for f in files)
    has_outgroup = len(outgroup) > 0

    if ingroup_filter is None:
        ingroup_filter = geom.mid > 0 and has_outgroup

    def _decode_and_group(words_h, cnt_h, gid_h, n_keep):
        # shared KeyLayout decode: every device path (fused, prefilter,
        # checkpoint, sharded) emits the same (n, W) survivor row encoding
        off_flank, off_mid = layout.base_offsets()
        flank_dec = dna.decode_bits(words_h, off_flank, bits)
        mid_dec = (dna.decode_bits(words_h, off_mid, bits) if geom.mid > 0
                   else [""] * n_keep)
        fid_h = dna.extract_bit_field(words_h, layout.file_off,
                                      layout.file_bits)
        return _group_epilogue(n_keep, gid_h, mid_dec, flank_dec, fid_h,
                               cnt_h, geom, tags, ingroup_tags,
                               has_outgroup, ingroup_filter)

    with METRICS.stage("read_fasta"):
        buffers = [load_buffer(path) for path in all_files]
    bits = detect_bits(buffers)
    layout = KeyLayout(geom.left, geom.mid, geom.right, bits,
                       len(all_files))

    # Device-memory guard: the fused one-shot program materializes every
    # genome's window table at once.  Past the budget, fall back to the
    # per-genome staged path (one genome's table on device at a time,
    # cached in a temp workdir) — the same results at reduced peak memory.
    if workdir is None and fused_bytes_estimate(buffers) > fused_budget():
        import tempfile
        workdir = tempfile.mkdtemp(prefix="krisp_tpu_tables_")

    cap = 1 << 16
    if workdir is not None:
        # Checkpoint/resume path: per-genome KeyLayout tables cached on
        # disk keyed by content+geometry; the global stage re-runs over
        # them in bounded range-partitioned passes (engine/bigscale.py),
        # so GB-scale inputs never materialize a whole-table device sort.
        from .bigscale import partitioned_global_intersect
        parts = _cached_parts(all_files, geom, bits, omit_soft, workdir,
                              layout)
        with METRICS.stage("intersect"):
            words_h, cnt_h, gid_h = partitioned_global_intersect(
                parts, layout, n_files=len(all_files), cap=cap)
        n_keep = words_h.shape[0]
    else:
        # One fused device program over minimal bit-packed keys; only
        # ``cap`` compacted survivor rows cross back, packed into a single
        # array (one transfer).  Overflow re-runs with a larger cap
        # (deterministic result, so this is safe).
        from ..ops.intersect import fused_pipeline_packed

        mesh = _mesh_for_run(layout, n_devices)
        if mesh is not None:
            # Full distributed intersection over the device mesh:
            # sequence-parallel slices + halo, key-range all_to_all, local
            # survivor scan per owned range — identical rows to the fused
            # single-device program (tests/test_distributed.py pins 1/2/4/8
            # device equality down to the rendered CSV bytes).
            from ..parallel.distributed import sharded_intersect_pipeline
            n_sh = mesh.devices.size
            chunk = max(-(-max(b.size for b in buffers) // n_sh), geom.total)
            chunk = -(-chunk // 1024) * 1024
            stacked = np.zeros((len(buffers), n_sh * chunk), np.uint8)
            for i, buf in enumerate(buffers):
                stacked[i, :buf.size] = buf
            with METRICS.stage("device_pipeline_sharded",
                               items=2 * len(buffers) * n_sh * chunk):
                words_h, cnt_h, gid_h = sharded_intersect_pipeline(
                    mesh, stacked, geom.left, geom.mid, geom.right, bits,
                    omit_soft=omit_soft)
            return _decode_and_group(words_h, cnt_h, gid_h,
                                     words_h.shape[0])
        pad = bucket_size(max(b.size for b in buffers))
        stacked = np.zeros((len(buffers), pad), np.uint8)
        for i, buf in enumerate(buffers):
            stacked[i, :buf.size] = buf
        code_table, valid_table, comp_table = _encoding_tables(bits, omit_soft)

        # wide keys (amplicon-class geometries): route through the one-word
        # prefix prefilter — a W-word LSD sort carries O(W^2) operand
        # traffic, while the prefilter sorts one word and runs the exact
        # full-width stage on the (tiny) prefix-surviving subset
        if bits == 2:
            # compact upload: 2-bit codes + validity bitmap (the softmask
            # policy folds into the bitmap; device tables are policy-free)
            code_table, valid_table, comp_table = _encoding_tables(2, False)

        use_prefilter = layout.n_words > 2 and layout.flank_bits >= 32
        if use_prefilter:
            from ..ops.intersect import (fused_pipeline_prefilter,
                                         fused_prefilter_global,
                                         extract_keys_packed_in)
            cap_pre = 1 << 16
            with METRICS.stage("device_pipeline",
                               items=2 * len(buffers)
                               * (pad - geom.total + 1)):
                if bits == 2:
                    # pipelined per-genome extraction (see the spacer branch
                    # below); the prefilter global stage retries alone
                    keys = []
                    for f in range(len(all_files)):
                        pk1, vb1 = _pack_genomes_host(stacked[f:f + 1],
                                                      omit_soft)
                        keys.append(extract_keys_packed_in(
                            jax.device_put(pk1), jax.device_put(vb1),
                            code_table, valid_table, comp_table,
                            np.uint32(f), left=geom.left, mid=geom.mid,
                            right=geom.right, bits=bits,
                            n_files=len(all_files)))
                    keys = tuple(keys)
                while True:
                    if bits == 2:
                        packed = np.asarray(fused_prefilter_global(
                            keys, left=geom.left, mid=geom.mid,
                            right=geom.right, bits=bits,
                            n_files=len(all_files), cap_pre=cap_pre,
                            cap=cap))
                    else:
                        packed = np.asarray(fused_pipeline_prefilter(
                            stacked, code_table, valid_table, comp_table,
                            left=geom.left, mid=geom.mid, right=geom.right,
                            bits=bits, n_files=len(all_files),
                            cap_pre=cap_pre, cap=cap, omit_soft=omit_soft))
                    n_keep = int(packed[-1, 0])
                    n_pre = int(packed[-1, 1])
                    if n_pre > cap_pre:
                        cap_pre = bucket_size(n_pre, quantum=1 << 18)
                        continue
                    if n_keep > cap:
                        cap = bucket_size(n_keep, quantum=1 << 16)
                        continue
                    break
            W = layout.n_words
            return _decode_and_group(packed[:W, :n_keep].T,
                                     packed[W, :n_keep],
                                     packed[W + 1, :n_keep].astype(np.int64),
                                     n_keep)
        if bits == 2:
            # pipelined per-genome path: JAX dispatch is async, so the host
            # packs + uploads genome f+1 while the device extracts genome
            # f's keys.  On compaction overflow only the global stage
            # re-runs; the per-genome key tables stay resident on device.
            from ..ops.intersect import (extract_keys_packed_in,
                                         fused_global_packed)
            with METRICS.stage("device_pipeline",
                               items=2 * len(buffers)
                               * (pad - geom.total + 1)):
                keys = []
                for f in range(len(all_files)):
                    pk1, vb1 = _pack_genomes_host(stacked[f:f + 1],
                                                  omit_soft)
                    keys.append(extract_keys_packed_in(
                        jax.device_put(pk1), jax.device_put(vb1),
                        code_table, valid_table, comp_table, np.uint32(f),
                        left=geom.left, mid=geom.mid, right=geom.right,
                        bits=bits, n_files=len(all_files)))
                keys = tuple(keys)
                while True:
                    packed = np.asarray(fused_global_packed(
                        keys, left=geom.left, mid=geom.mid,
                        right=geom.right, bits=bits,
                        n_files=len(all_files), cap=cap))
                    n_keep = int(packed[-1, 0])
                    if n_keep <= cap:
                        break
                    cap = bucket_size(n_keep, quantum=1 << 16)
        else:
            while True:
                with METRICS.stage("device_pipeline",
                                   items=2 * len(buffers)
                                   * (pad - geom.total + 1)):
                    packed = np.asarray(fused_pipeline_packed(
                        stacked, code_table, valid_table, comp_table,
                        left=geom.left, mid=geom.mid, right=geom.right,
                        bits=bits, n_files=len(all_files), cap=cap,
                        omit_soft=omit_soft))
                    n_keep = int(packed[-1, 0])
                if n_keep <= cap:
                    break
                cap = bucket_size(n_keep, quantum=1 << 16)
        W = layout.n_words
        words_h = packed[:W, :n_keep].T
        cnt_h = packed[W, :n_keep]
        gid_h = packed[W + 1, :n_keep].astype(np.int64)

    return _decode_and_group(words_h, cnt_h, gid_h, n_keep)


def _group_epilogue(n_keep, gid_h, mid_dec, flank_dec, fid_h, cnt_h, geom,
                    tags, ingroup_tags, has_outgroup, ingroup_filter):
    """Host epilogue shared by the fused, checkpoint, and sharded paths:
    decode survivor rows into FlankGroup objects + the ingroup filter."""
    with METRICS.stage("decode+group"):
        render_ingroup = frozenset(ingroup_tags) if has_outgroup else None

        # rows arrive (flank, file, mid-within-file); rebuild each group in
        # mid order so amplicon insertion order matches the reference's
        # sorted-file stream
        groups: list[FlankGroup] = []
        by_gid: dict[int, list] = {}
        order: list[int] = []
        for row_i in range(n_keep):
            g = int(gid_h[row_i])
            if g not in by_gid:
                by_gid[g] = []
                order.append(g)
            by_gid[g].append(row_i)
        for g in order:
            rows = sorted(by_gid[g], key=lambda i: (mid_dec[i], i))
            flank = flank_dec[rows[0]]
            left = flank[:geom.left]
            right = flank[geom.left:]
            grp = FlankGroup(left=left, right=right, ingroup=render_ingroup)
            for i in rows:
                grp.add(KmerAmplicon(left=left, mid=mid_dec[i], right=right,
                                     label_counts={tags[int(fid_h[i])]:
                                                   int(cnt_h[i])}))
            groups.append(grp)

    if ingroup_filter:
        # Diagnostic ingroup-unique-column filter on the survivor set
        # (parity: filterAlignments.py:4-40 over Amplicon.py:495-521).
        groups = [g for g in groups if g.ingroup_unique_columns()]
    return groups
