"""Device sort + run-length (unique/count) kernels for packed k-mer keys.

Replaces the reference's external-memory GNU sort subprocess
(/root/reference/src/krisp/kstream/kstream.py:45-119) and its generator-level
duplicate merging (krisp_fasta/shared.py:210-240) with one on-device sort of
multi-word integer keys followed by vectorized run detection.

Every multi-word sort here is a sequence of single-key ``jax.lax.sort``
passes.  XLA hands one-operand and key-value sorts on the GPU to CUB's
radix sort; sorts with more operands take its generic comparator sort.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _pack64(hi, lo):
    """Fuse two u32 words into one u64 (unsigned compare of the u64 ==
    lexicographic compare of the (hi, lo) pair).  x64 mode is enabled only
    for the scope that creates 64-bit values — the arrays crossing the jit
    boundary stay u32."""
    with jax.enable_x64(True):
        return ((hi.astype(jnp.uint64) << jnp.uint64(32))
                | lo.astype(jnp.uint64))


def _unpack64(k):
    with jax.enable_x64(True):
        return ((k >> jnp.uint64(32)).astype(jnp.uint32),
                (k & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32))


def _group64(keys):
    """Pair adjacent u32 key words (most-significant first) into u64 sort
    operands; an odd trailing word stays u32.  Lexicographic order over
    the groups equals lexicographic order over the words, and the group
    count — hence the LSD pass count and the carried-operand traffic — is
    halved."""
    groups, meta = [], []
    i = 0
    while i < len(keys):
        if i + 1 < len(keys):
            groups.append(_pack64(keys[i], keys[i + 1]))
            meta.append(2)
            i += 2
        else:
            groups.append(keys[i])
            meta.append(1)
            i += 1
    return groups, meta


def _ungroup64(groups, meta):
    keys = []
    for g, m in zip(groups, meta):
        if m == 2:
            hi, lo = _unpack64(g)
            keys.extend([hi, lo])
        else:
            keys.append(g)
    return keys


def lsd_sort(keys, payloads=()):
    """Stable lexicographic sort by multi-word keys via LSD passes.

    A least-significant-first sequence of stable single-key sorts computes
    the lexicographic order of a multi-key comparator sort — the radix-sort
    idea with XLA's sort as the per-digit primitive — while each pass stays
    a single-key sort, the form XLA lowers to its fastest routine.  Adjacent
    u32 word pairs fuse into u64 digits (_group64), halving both the pass
    count and the carried-operand traffic; a 60-bit spacer key sorts in
    ONE pass with nothing carried.

    keys: list of uint32 arrays, most-significant first.  Returns
    (keys_sorted list, payloads_sorted list).

    For wide keys (many words), payloads are replaced by a row-id during
    the passes and gathered by it at the end.
    """
    W, P = len(keys), len(payloads)
    if W == 0:
        return [], list(payloads)

    groups, meta = _group64(list(keys))
    G = len(groups)

    if G == 1 and P == 0:
        # key-only single-digit sort: equal keys are indistinguishable, so
        # stability is semantically void, and an unstable sort lets XLA
        # skip the iota tiebreaker operand it adds to stable sorts
        out = jax.lax.sort(tuple(groups), num_keys=1, is_stable=False)
        return _ungroup64(list(out), meta), []

    def passes(arrays, n_keys):
        for k in range(n_keys - 1, -1, -1):
            ops = (arrays[k], *arrays[:k], *arrays[k + 1:])
            out = jax.lax.sort(ops, num_keys=1, is_stable=True)
            arrays = list(out[1:k + 1]) + [out[0]] + list(out[k + 1:])
        return arrays

    if G + P <= 4 or P == 0:
        arrays = passes(groups + list(payloads), G)
        return _ungroup64(arrays[:G], meta), arrays[G:]

    # wide path: carry a row id, then gather the payloads by it.  (Sorting
    # by the inverse permutation instead trips XLA's GPU permutation-sort
    # rewrite, which emits an ill-typed scatter for uint32 row ids.)
    n = keys[0].shape[0]
    iota = jnp.arange(n, dtype=jnp.uint32)
    arrays = passes(groups + [iota], G)
    src = arrays[G]              # src[j] = original index of sorted row j
    sorted_payloads = [jnp.take(p, src, axis=0) for p in payloads]
    return _ungroup64(arrays[:G], meta), sorted_payloads


def sort_with_rowid(key_word):
    """Stable sort of one u32 key word, returning (key_sorted, row_ids).

    The (key, row-id) pair packs into one u64 whose unsigned order equals
    the stable order of the key alone (row ids are unique and increasing
    in input order), so the whole thing is a single carry-free sort pass.
    """
    n = key_word.shape[0]
    iota = jnp.arange(n, dtype=jnp.uint32)
    k = _pack64(key_word, iota)
    s = jax.lax.sort((k,), num_keys=1, is_stable=False)[0]
    return _unpack64(s)


def sort_keys(invalid, words, payloads=()):
    """Lexicographic sort by (invalid, *words); payloads carried along.

    ``invalid`` leads so masked/padding rows sort after all real keys.
    Returns (invalid_sorted, words_sorted list, payloads_sorted list).
    """
    keys_sorted, payloads_sorted = lsd_sort([invalid, *words], payloads)
    return keys_sorted[0], keys_sorted[1:], payloads_sorted


def run_heads(invalid, words):
    """Boolean head-of-run flags for a sorted table (first row of each
    distinct valid key)."""
    neq = jnp.zeros(invalid.shape[0] - 1, bool)
    for w in words:
        neq = neq | (w[1:] != w[:-1])
    head = jnp.concatenate([jnp.ones(1, bool), neq])
    return head & (invalid == 0)


@partial(jax.jit)
def unique_counts(invalid, words):
    """Collapse a sorted key table into (unique keys, multiplicities).

    Output arrays are padded to the input size; ``u_invalid`` is the ONLY
    marker of tail padding — tail rows keep the real key words of the
    duplicate/invalid rows that were swept there, so consumers must mask by
    ``u_invalid`` (or slice to ``n_unique``), never by sentinel key values.
    Mirrors the semantics of the
    reference's ``simplifyStream`` (shared.py:210-240): adjacent equal rows
    merge and their label multiplicities add (here: occurrence counts per
    genome).

    Gather-free: a full-size ``nonzero`` + ``take`` compaction lowers to a
    scatter and a data-scale random gather.  Instead, one more stable LSD
    sort led by a non-head flag sweeps duplicate and invalid rows to the tail
    in place; head rows are strictly increasing, so their order — hence
    the unique prefix — is identical.  (The flag leads as its own key word
    rather than overwriting dup keys with all-ones sentinels: a fully
    occupied layout makes an all-T k-mer bit-equal to the sentinel, which
    would misplace it.)
    """
    n = invalid.shape[0]
    n_valid = jnp.sum((invalid == 0).astype(jnp.int32))
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < n_valid
    head = run_heads(invalid, words)
    n_unique = jnp.sum(head.astype(jnp.int32))
    # run length at head rows via reverse cummin of next-head positions
    rh = jnp.where(head, idx, n)
    nxt = jax.lax.cummin(jnp.concatenate(
        [rh[1:], jnp.full(1, n, jnp.int32)])[::-1])[::-1]
    cnt = jnp.where(head & valid,
                    jnp.minimum(nxt, n_valid) - idx, 0).astype(jnp.uint32)
    nonhead = (~head).astype(jnp.uint32)
    keys_u, (counts,) = lsd_sort([nonhead, *words], [cnt])
    u_invalid = (idx >= n_unique).astype(jnp.uint32)
    return u_invalid, keys_u[1:], counts, n_unique


@partial(jax.jit, static_argnames=("bits",))
def build_sorted_unique(invalid, words, bits: int):
    """Fused per-genome stage: sort raw window keys, then unique+count.

    This is the device replacement for the reference's per-file
    ``extractSortedKmers`` (krisp_fasta/krisp_fasta.py:16-66): one sorted,
    duplicate-merged k-mer table per genome.
    """
    inv_s, words_s, _ = sort_keys(invalid, words)
    return unique_counts(inv_s, words_s)
