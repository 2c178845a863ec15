"""Device kernels: ASCII -> codes, k-mer window extraction as packed keys.

Replaces the reference's per-character Python hot loop
(/root/reference/src/krisp/kstream/kstream.py:617-642, the ``_kmers`` sliding
window) and its string-level complement pass (kstream.py:644-694) with
vectorized XLA ops over the whole genome buffer at once.

Design: a genome is one uint8 ASCII buffer with a single invalid sentinel byte
between FASTA records (so no window spans two records — parity with the
reference, which k-merizes per record: kstream.py:556-583).  Each window of
length L becomes a fixed-width key: bases permuted into the ``[left|right|mid]``
sort layout and packed 16 (2-bit) or 8 (4-bit) bases per uint32 word,
most-significant-first.  Unsigned lexicographic comparison of the word tuple
then equals ``LC_ALL=C sort -t, -k1,1 -k3,3`` plus GNU sort's whole-line
tiebreak (which, for fixed-geometry rows, reduces to the mid column) — the
exact effective ordering of the reference's sorted k-mer tables
(kstream.py:45-119).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def sort_perm(left: int, mid: int, right: int) -> tuple[int, ...]:
    """Base-index permutation implementing the [left|right|mid] key layout."""
    L = left + mid + right
    return tuple(range(left)) + tuple(range(left + mid, L)) + tuple(range(left, left + mid))


def num_words(n_bases: int, bits: int) -> int:
    return math.ceil(n_bases * bits / 32) if n_bases > 0 else 0


def encode_ascii(ascii_u8, code_table, valid_table):
    """Map an ASCII uint8 buffer to (codes uint32, valid bool) on device."""
    codes = jnp.take(jnp.asarray(code_table), ascii_u8).astype(jnp.uint32)
    valid = jnp.take(jnp.asarray(valid_table), ascii_u8)
    return jnp.where(valid, codes, 0), valid


def window_validity(valid, L: int):
    """valid[i] per base -> ok[i] per window start (all L bases valid)."""
    n = valid.shape[0]
    n_win = n - L + 1
    bad = (~valid).astype(jnp.int32)
    csum = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(bad)])
    return (csum[L:] - csum[:n_win]) == 0


def pack_windows(codes, perm: tuple[int, ...], bits: int, n_win: int):
    """Pack every window into key words under a base permutation.

    codes: uint32[N] (one per base).  Returns list of uint32[n_win] word
    arrays, most-significant word first.  Each word is a weighted sum of
    statically-shifted slices of ``codes`` — pure VPU work that XLA fuses.
    """
    per_word = 32 // bits
    words = []
    for w in range(num_words(len(perm), bits)):
        part = perm[w * per_word:(w + 1) * per_word]
        acc = jnp.zeros((n_win,), jnp.uint32)
        for j, off in enumerate(part):
            sh = np.uint32(32 - bits * (j + 1))
            acc = acc | (jax.lax.dynamic_slice(codes, (off,), (n_win,)) << sh)
        words.append(acc)
    return words


class KeyLayout:
    """Bit-level plan for the packed [flank | genome-id | mid] sort key.

    Every row's entire identity — flank pair, source genome, and mid
    sequence — lives in one minimal multi-word integer key, so the global
    (flank, genome, mid) order needs ONLY key words as sort operands: the
    fewest possible LSD passes with nothing carried.  The genome-id field
    doubles as the validity marker (all-ones = sentinel), which also makes
    sentinel rows unambiguous for every geometry.

    Field placement never straddles a word: the genome field is padded to
    fit inside one word, and base fields are bits-aligned by construction
    (32 % bits == 0).
    """

    def __init__(self, left: int, mid: int, right: int, bits: int,
                 n_files: int):
        self.left, self.mid, self.right, self.bits = left, mid, right, bits
        self.flank_bits = (left + right) * bits
        fb = max(bits, (max(n_files, 1)).bit_length())  # sentinel > any id
        fb = -(-fb // bits) * bits                      # bits-aligned
        self.file_bits = fb
        fo = self.flank_bits
        if fo % 32 + fb > 32:
            fo = (fo // 32 + 1) * 32
        self.file_off = fo
        self.mid_off = fo + fb
        self.total_bits = self.mid_off + mid * bits
        self.n_words = -(-self.total_bits // 32)
        self.file_sentinel = (1 << fb) - 1

    def base_offsets(self):
        """(flank base bit-offsets, mid base bit-offsets) in layout order:
        left bases, right bases | mid bases."""
        b = self.bits
        flank = [i * b for i in range(self.left + self.right)]
        mid = [self.mid_off + i * b for i in range(self.mid)]
        return flank, mid

    def file_word_shift(self):
        w = self.file_off // 32
        sh = 32 - (self.file_off % 32) - self.file_bits
        return w, sh

    # hashable so a KeyLayout can be a jit static argument
    def _key(self):
        return (self.left, self.mid, self.right, self.bits, self.file_bits)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return (isinstance(other, KeyLayout)
                and self._key() == other._key())


def pack_windows_at(codes, perm, offsets, bits: int, n_win: int,
                    n_words: int):
    """Pack window bases into key words at explicit bit offsets.

    codes: uint32[N]; perm: base index within the window per field slot;
    offsets: absolute bit offset per slot.  Returns n_words uint32 arrays.
    """
    import collections
    per_word = collections.defaultdict(list)
    for p, off in zip(perm, offsets):
        per_word[off // 32].append((p, off % 32))
    words = []
    for w in range(n_words):
        acc = jnp.zeros((n_win,), jnp.uint32)
        for p, bit in per_word.get(w, []):
            sh = np.uint32(32 - bit - bits)
            acc = acc | (jax.lax.dynamic_slice(codes, (p,), (n_win,)) << sh)
        words.append(acc)
    return words


@partial(jax.jit, static_argnames=("left", "mid", "right", "bits",
                                   "n_files"))
def window_keys_bits(ascii_u8, code_table, valid_table, comp_table,
                     left: int, mid: int, right: int, bits: int,
                     n_files: int):
    """Window extraction directly into the bit-packed KeyLayout.

    Returns (ok bool[n], words list) with forward strand rows first, then
    reverse complements (n = 2 * n_win).  The genome-id field is left zero;
    the caller ORs it in.
    """
    L = left + mid + right
    layout = KeyLayout(left, mid, right, bits, n_files)
    codes, valid = encode_ascii(ascii_u8, code_table, valid_table)
    ok = window_validity(valid, L)
    n_win = ok.shape[0]

    perm_flank = tuple(range(left)) + tuple(range(left + mid, L))
    perm_mid = tuple(range(left, left + mid))
    off_flank, off_mid = layout.base_offsets()
    perm = perm_flank + tuple(perm_mid)
    offs = off_flank + off_mid

    comp_codes = jnp.take(jnp.asarray(comp_table), codes).astype(jnp.uint32)
    fwd = pack_windows_at(codes, perm, offs, bits, n_win, layout.n_words)
    rc = pack_windows_at(comp_codes, tuple(L - 1 - p for p in perm), offs,
                         bits, n_win, layout.n_words)
    words = [jnp.concatenate([a, b]) for a, b in zip(fwd, rc)]
    return jnp.concatenate([ok, ok]), words


def _word_runs(perm, offs, bits: int):
    """Group a word's base slots into maximal contiguous runs.

    Returns {word: [(p0, bit0, m)]}: m bases starting at window position
    p0, landing at bit offset bit0 within the word, with window position
    and bit offset advancing in lockstep — the unit the tree composition
    packs with one slice per binary-decomposition part."""
    import collections
    runs = collections.defaultdict(list)
    cur = None  # (word, p0, bit0, m)
    for off, p in sorted(zip(offs, perm)):
        w, b = off // 32, off % 32
        if (cur is not None and cur[0] == w and p == cur[1] + cur[3]
                and b == cur[2] + bits * cur[3]):
            cur = (w, cur[1], cur[2], cur[3] + 1)
        else:
            if cur is not None:
                runs[cur[0]].append(cur[1:])
            cur = (w, p, b, 1)
    if cur is not None:
        runs[cur[0]].append(cur[1:])
    return runs


def _tree_ladder(codes_u32, max_m: int):
    """Doubling pack arrays: arrs[s][i] = s bases starting at i, packed
    into the low 2s bits (s a power of two, up to 16 = one full u32)."""
    arrs = {1: codes_u32}
    s = 1
    while 2 * s <= min(max_m, 16):
        prev = arrs[s]
        arrs[2 * s] = ((prev[: prev.shape[0] - s] << jnp.uint32(2 * s))
                       | prev[s:])
        s *= 2
    return arrs


@partial(jax.jit, static_argnames=("left", "mid", "right", "n_files"))
def window_keys_tree(ascii_u8, code_table, valid_table, comp_table,
                     left: int, mid: int, right: int, n_files: int):
    """window_keys_bits for the 2-bit path via log-tree packing.

    The per-base formulation (pack_windows_at) does L shift-or passes per
    strand; doubling ladders over the code buffer pack 2^s bases per
    element, so each layout word composes from O(log) slices of the
    ladders — fewer vector passes at spacer geometry.  The reverse
    complement reuses a ladder over the flipped complement buffer: the
    window-i slice of that ladder is a flip of a statically-offset slice.
    Bit-identical to window_keys_bits (tests/test_encode.py).
    """
    bits = 2
    L = left + mid + right
    layout = KeyLayout(left, mid, right, bits, n_files)
    codes, valid = encode_ascii(ascii_u8, code_table, valid_table)
    ok = window_validity(valid, L)
    n_win = ok.shape[0]

    perm_flank = tuple(range(left)) + tuple(range(left + mid, L))
    perm_mid = tuple(range(left, left + mid))
    off_flank, off_mid = layout.base_offsets()
    runs = _word_runs(perm_flank + perm_mid, off_flank + off_mid, bits)
    max_m = max((r[2] for rs in runs.values() for r in rs), default=1)

    comp_codes = jnp.take(jnp.asarray(comp_table), codes).astype(jnp.uint32)
    fwd_arrs = _tree_ladder(codes, max_m)
    rc_arrs = _tree_ladder(comp_codes[::-1], max_m)

    def compose(arrs, p0, bit0, m, flip):
        acc = None
        consumed = 0
        a = 16
        while consumed < m:
            if a <= m - consumed:
                sl = jax.lax.dynamic_slice(arrs[a], (p0 + consumed,),
                                           (n_win,))
                if flip:
                    sl = sl[::-1]
                sh = np.uint32(32 - bit0 - bits * (consumed + a))
                part = sl << sh
                acc = part if acc is None else acc | part
                consumed += a
            else:
                a //= 2
        return acc

    def build(arrs, flip):
        words = []
        for w in range(layout.n_words):
            acc = jnp.zeros((n_win,), jnp.uint32)
            for p0, bit0, m in runs.get(w, []):
                acc = acc | compose(arrs, p0, bit0, m, flip)
            words.append(acc)
        return words

    fwd = build(fwd_arrs, False)
    rc = build(rc_arrs, True)
    words = [jnp.concatenate([a, b]) for a, b in zip(fwd, rc)]
    return jnp.concatenate([ok, ok]), words


@partial(jax.jit, static_argnames=("left", "mid", "right", "bits", "add_revcomp"))
def kmer_keys(ascii_u8, code_table, valid_table, comp_table,
              left: int, mid: int, right: int, bits: int,
              add_revcomp: bool = True):
    """Full window-extraction kernel: ASCII buffer -> packed sorted-layout keys.

    Returns (invalid_flag uint32[n], words list of uint32[n]) where n is
    2 * n_win when ``add_revcomp`` (forward strand rows first, then reverse
    complements — the reference emits fwd,rc interleaved per window
    (kstream.py:661-677) but order is irrelevant pre-sort).

    invalid_flag is 0 for real keys and 1 for masked ones; it is used as the
    leading sort key so padding sorts after every valid key.
    """
    L = left + mid + right
    codes, valid = encode_ascii(ascii_u8, code_table, valid_table)
    ok = window_validity(valid, L)
    n_win = ok.shape[0]
    perm = sort_perm(left, mid, right)

    fwd = pack_windows(codes, perm, bits, n_win)
    if add_revcomp:
        comp_codes = jnp.take(jnp.asarray(comp_table), codes).astype(jnp.uint32)
        perm_rc = tuple(L - 1 - p for p in perm)
        rc = pack_windows(comp_codes, perm_rc, bits, n_win)
        words = [jnp.concatenate([f, r]) for f, r in zip(fwd, rc)]
        okall = jnp.concatenate([ok, ok])
    else:
        words = fwd
        okall = ok
    invalid = (~okall).astype(jnp.uint32)
    return invalid, words
