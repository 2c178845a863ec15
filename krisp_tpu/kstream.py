"""kstream: composable k-mer stream extraction/filtering pipeline + library.

Capability parity with the reference's published ``kstream`` tool
(/root/reference/src/krisp/kstream/kstream.py:122-832 for the class,
:835-956 for the CLI).  Same transform chain, same fixed application order
(kstream.py:203-235):

    kmerize -> omit-soft | map-soft -> complements -> allow -> disallow ->
    expand-iupac -> canonicals -> split

plus RNA round-trip (detect U, process as DNA, emit back as RNA,
kstream.py:481-615) and FASTA/raw-line autodetection.

The reference shells out to GNU ``sort`` for ordering; this implementation is
self-contained: an in-memory sort for streams that fit, spilling to a
temp-file chunk merge (heapq) otherwise.  Ordering is byte-order (C collation)
on the whole line, or on selected ','-separated columns with whole-line
tiebreak — exactly GNU ``LC_ALL=C sort [-t, -kN,N...]`` semantics including
the last-resort comparison.

Fixed-geometry ACGT workloads should use the device engine
(krisp_tpu.engine) instead; this module is the flexible string-level tool.
"""

from __future__ import annotations

import heapq
import itertools
import multiprocessing
import os
import tempfile

from .dna import COMPLEMENT, IUPAC_EXPAND
from .io.fasta import open_maybe_compressed

_DEFAULT_CHUNK_LINES = 2_000_000
#: approximate per-line Python overhead (str header + list slot) used when
#: converting a --sort-mem byte budget into a spill threshold
_LINE_OVERHEAD = 64

_MEM_SUFFIX = {"b": 1, "K": 1024, "k": 1024, "M": 1024 ** 2,
               "m": 1024 ** 2, "G": 1024 ** 3, "g": 1024 ** 3,
               "T": 1024 ** 4, "t": 1024 ** 4}


def parse_memory_spec(spec):
    """GNU ``sort -S`` size grammar -> bytes (kstream.py:54-56 defers to
    it): ``N%`` of physical memory, ``b``/``K``/``M``/``G``/``T``
    suffixes, bare number = KiB.  None/"" -> None (automatic chunking)."""
    if spec is None:
        return None
    spec = str(spec).strip()
    if not spec:
        return None
    if spec.endswith("%"):
        pct = float(spec[:-1])
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return max(int(total * pct / 100.0), 1)
    if spec[-1] in _MEM_SUFFIX:
        return max(int(float(spec[:-1]) * _MEM_SUFFIX[spec[-1]]), 1)
    return max(int(float(spec) * 1024), 1)


def sort_key_for_cols(cols):
    """Key function reproducing ``LC_ALL=C sort -t, -kC,C...`` + whole-line
    last-resort comparison."""
    if not cols:
        return lambda line: line
    def key(line):
        fields = line.split(",")
        parts = []
        for c in cols:
            parts.append(fields[c] if c < len(fields) else "")
        parts.append(line)
        return tuple(parts)
    return key


def _take_chunk(lines, chunk_lines, mem_bytes):
    """Next in-memory chunk: capped at ``chunk_lines`` and, when a
    ``--sort-mem`` budget is given, at ``mem_bytes`` of estimated line
    storage (string bytes + per-line overhead)."""
    if mem_bytes is None:
        return list(itertools.islice(lines, chunk_lines))
    buf, used = [], 0
    for line in lines:
        buf.append(line)
        used += len(line) + _LINE_OVERHEAD
        if used >= mem_bytes or len(buf) >= chunk_lines:
            break
    return buf


def external_sort(lines, cols=None, chunk_lines=_DEFAULT_CHUNK_LINES,
                  workdir=None, mem=None):
    """Sort an iterable of str lines; spills to disk beyond chunk_lines
    or beyond the ``mem`` budget (a GNU ``sort -S``-style spec)."""
    key = sort_key_for_cols(cols)
    mem_bytes = parse_memory_spec(mem)
    lines = iter(lines)
    buf = _take_chunk(lines, chunk_lines, mem_bytes)
    head = list(itertools.islice(lines, 1))
    if not head:
        yield from sorted(buf, key=key)
        return
    lines = itertools.chain(head, lines)
    files = []
    while buf:
        buf.sort(key=key)
        f = tempfile.TemporaryFile("w+t", dir=workdir)
        f.writelines(l + "\n" for l in buf)
        f.seek(0)
        files.append(f)
        buf = _take_chunk(lines, chunk_lines, mem_bytes)
    streams = [(line.rstrip("\n") for line in f) for f in files]
    yield from heapq.merge(*streams, key=key)
    for f in files:
        f.close()


class KStream:
    """Configurable k-mer stream parser; callable, iterable, writable."""

    def __init__(self, sequences=None, kmers=None, complements=False,
                 canonicals=False, allow=None, disallow=None, omitsoft=False,
                 mapsoft=False, expandiupac=False, split=None, sort=False,
                 sortmem=None, sortcols=None, sortnp=1, parallel=1):
        if omitsoft and mapsoft:
            raise ValueError("can't omit and map soft masked nucleotides")
        if complements and canonicals:
            raise ValueError("canonicals conflicts with complements")
        self.kmers = ([kmers] if isinstance(kmers, int) else
                      list(kmers) if kmers is not None else None)
        self.split_spec = ([split] if isinstance(split, int) else
                           list(split) if split is not None else None)
        self.allow = set(allow) if allow is not None else None
        self.disallow = set(disallow) if disallow is not None else None
        self.omitsoft = omitsoft
        self.mapsoft = mapsoft
        self.complements = complements
        self.canonicals = canonicals
        self.expandiupac = expandiupac
        self.sort = sort
        self.sortcols = sortcols
        self.sortmem = sortmem  # GNU `sort -S` spec bounding spill chunks
        self.sortnp = sortnp
        self.parallel = parallel
        self.sequences = sequences

    # -- input handling -----------------------------------------------------

    def _input_sequences(self, sequences):
        if isinstance(sequences, str):
            return self._read_lines(sequences)
        return iter(sequences)

    @staticmethod
    def _read_lines(path):
        handle = open_maybe_compressed(path)
        for raw in handle:
            if isinstance(raw, bytes):
                raw = raw.decode()
            yield raw

    @staticmethod
    def _detect_fasta(lines):
        """Peek at the first line only (parity: kstream.py:510-537)."""
        it = iter(lines)
        try:
            first = next(it)
        except StopIteration:
            return False, iter(())
        return (">" in first), itertools.chain([first], it)

    @staticmethod
    def _parse_fasta(lines):
        seq = ""
        for line in lines:
            line = line.strip()
            if line.startswith(">"):
                if seq:
                    yield seq
                seq = ""
            else:
                seq += line
        if seq:
            yield seq

    @staticmethod
    def _parse_raw(lines):
        for line in lines:
            yield line.strip()

    @staticmethod
    def _detect_rna(seqs):
        """Scan until the first T or U decides (parity: kstream.py:481-508)."""
        seen = []
        is_rna = None
        for s in seqs:
            seen.append(s)
            if "T" in s or "t" in s:
                is_rna = False
                break
            if "U" in s or "u" in s:
                is_rna = True
                break
        return is_rna, itertools.chain(seen, seqs)

    # -- transforms ---------------------------------------------------------

    def _kmerize(self, seqs):
        klens = self.kmers
        for s in seqs:
            for k in klens:
                for i in range(len(s) - k + 1):
                    yield s[i:i + k]

    @staticmethod
    def _revcomp(s):
        return "".join(COMPLEMENT[b] for b in reversed(s))

    def _transform(self, seqs):
        """Apply the configured chain in the reference's fixed order."""
        if self.kmers is not None:
            seqs = self._kmerize(seqs)
        if self.omitsoft:
            seqs = (s for s in seqs if s.isupper())
        if self.mapsoft:
            seqs = (s.upper() for s in seqs)
        if self.complements:
            def add_rc(stream):
                for s in stream:
                    yield s
                    yield self._revcomp(s)
            seqs = add_rc(seqs)
        if self.allow is not None:
            seqs = (s for s in seqs if set(s).issubset(self.allow))
        if self.disallow is not None:
            seqs = (s for s in seqs if set(s).isdisjoint(self.disallow))
        if self.expandiupac:
            seqs = self._expand_iupac(seqs)
        if self.canonicals:
            seqs = (min(s, self._revcomp(s)) for s in seqs)
        if self.split_spec is not None:
            seqs = (self._split_one(s) for s in seqs)
        return seqs

    @staticmethod
    def _expand_iupac(seqs):
        for s in seqs:
            spots = [(i, IUPAC_EXPAND[b]) for i, b in enumerate(s)
                     if b in IUPAC_EXPAND]
            if not spots:
                yield s
                continue
            chars = list(s)
            for combo in itertools.product(*(opts for _, opts in spots)):
                for (i, _), b in zip(spots, combo):
                    chars[i] = b
                yield "".join(chars)

    def _split_one(self, s):
        pos_parts, neg_parts = [], []
        for size in self.split_spec:
            if size >= 0:
                pos_parts.append(s[:size])
                s = s[size:]
            else:
                neg_parts.append(s[size:])
                s = s[:size]
        return ",".join(pos_parts + [s] + neg_parts)

    # -- execution ----------------------------------------------------------

    def _one_seq(self, seq):
        return list(self._transform((seq,)))

    def __call__(self, sequences):
        lines = self._input_sequences(sequences)
        is_fasta, lines = self._detect_fasta(lines)
        seqs = self._parse_fasta(lines) if is_fasta else self._parse_raw(lines)
        is_rna, seqs = self._detect_rna(seqs)
        if is_rna:
            seqs = (s.replace("U", "T").replace("u", "t") for s in seqs)

        if self.parallel == 1:
            out = self._transform(seqs)
        else:
            def parallel_stream():
                from .runtime import cpu_only_children

                # spawn: fork is unsafe once JAX (multithreaded) loaded
                ctx = multiprocessing.get_context("spawn")
                with cpu_only_children():
                    pool = ctx.Pool(self.parallel)
                with pool:
                    for chunk in pool.imap(self._one_seq, seqs, chunksize=4):
                        yield from chunk
            out = parallel_stream()

        if self.sort:
            out = external_sort(out, cols=self.sortcols, mem=self.sortmem)
        if is_rna:
            out = (s.replace("T", "U").replace("t", "u") for s in out)
        yield from out

    def __iter__(self):
        return iter(self.__call__(self.sequences))

    def write(self, filename, sequences=None):
        """Write the processed stream to a file; returns the line count.

        Parity note: the reference writes then sorts the file in place
        (kstream.py:250-325) — here the sort happens in-stream, which yields
        the identical final file since sorting commutes with the T<->U
        re-mapping (both orderings rank A<C<G<T(=U))."""
        if sequences is None:
            sequences = self.sequences
        count = 0
        with open(filename, "w") as fout:
            for s in self.__call__(sequences):
                print(s, file=fout)
                count += 1
        return count
