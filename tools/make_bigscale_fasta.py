"""Synthesize GB-scale krisp_fasta inputs with planted diagnostic sites.

Builds N_INGROUP + N_OUTGROUP genomes of --size bases each: independent
uniform-random sequence, except at planted 28-base sites (one per
--site-every bases, at fixed offsets so every genome agrees) where all
genomes share the same left(25)/right(2) flanks.  Half the sites give the
ingroup mid base 'A' and the outgroup 'C' (diagnostic under the reference
semantics: ingroup allele set disjoint from the outgroup's,
/root/reference/src/krisp/krisp_fasta/Amplicon.py:495-521); the other half
use 'G' everywhere (shared but non-diagnostic, so the ingroup filter must
drop them).  Expected spacer-search output = 1 row per diagnostic site:
both strands are added un-canonicalized, but with the asymmetric 25/1/2
geometry a diagnostic window's reverse complement carries the complemented
mid base inside its LEFT flank, so the ingroup and outgroup revcomp flank
pairs differ and the twin never survives the all-files intersection (the
README's revcomp pairs appear only in the symmetric 30/40/30 geometry,
README.md:231-232).  Non-diagnostic sites survive intersection on both
strands and must be dropped by the ingroup filter.

Other geometries (``geom=(left, mid, right)``, e.g. the amplicon 30/40/30)
plant a random mid of ``mid`` bases per site: the ingroup's and the
outgroup's differ at every column at diagnostic sites, and all genomes
share one mid at the others.  With symmetric flanks both strands of a
diagnostic site survive (``expected_rows``).

Usage: python tools/make_bigscale_fasta.py OUTDIR --size 100000000
"""

import argparse
import os

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
GEOM = (25, 1, 2)  # spacer-search geometry: left, mid, right
L = sum(GEOM)


def write_fasta(path: str, seq: np.ndarray, record_bases: int = 10_000_000,
                width: int = 80):
    """Wrap a uint8 base array into 80-column FASTA records, vectorized."""
    with open(path, "wb") as fh:
        for r, start in enumerate(range(0, seq.size, record_bases)):
            chunk = seq[start:start + record_bases]
            pad = (-chunk.size) % width
            grid = np.concatenate([chunk, np.zeros(pad, np.uint8)])
            grid = grid.reshape(-1, width)
            lines = np.full((grid.shape[0], width + 1), ord("\n"), np.uint8)
            lines[:, :width] = grid
            body = lines.reshape(-1)
            if pad:  # drop the zero padding from the final line
                body = np.concatenate(
                    [body[:-(pad + 1)], np.frombuffer(b"\n", np.uint8)])
            fh.write(b">rec%d len=%d\n" % (r, chunk.size))
            body.tofile(fh)


def planted_windows(n_sites: int, geom=GEOM, seed: int = 20260819):
    """The planted site windows of ``make_genomes``: (ingroup, outgroup)
    uint8 arrays [n_sites, sum(geom)] and the diagnostic-site mask.  The
    spacer geometry's flanks are the first draw of the genome stream
    (``make_genomes``); other geometries draw from a stream of their
    own."""
    left, mid, right = geom
    diagnostic = np.arange(n_sites) % 2 == 0
    if tuple(geom) == GEOM:
        rng = np.random.default_rng(seed)
        win = BASES[rng.integers(0, 4, size=(n_sites, L))]
        out = win.copy()
        win[:, left] = np.where(diagnostic, ord("A"), ord("G"))
        out[:, left] = np.where(diagnostic, ord("C"), ord("G"))
        return win, out, diagnostic
    rng = np.random.default_rng([seed, left, mid, right])
    length = left + mid + right
    win = BASES[rng.integers(0, 4, size=(n_sites, length))]
    out = win.copy()
    # outgroup mid: every base shifted to another letter at diagnostic sites
    codes = rng.integers(0, 4, size=(n_sites, mid))
    shift = np.where(diagnostic[:, None], 1 + codes % 3, 0)
    lut = {int(b): i for i, b in enumerate(BASES)}
    mid_in = np.vectorize(lut.get)(win[:, left:left + mid])
    out[:, left:left + mid] = BASES[(mid_in + shift) % 4]
    return win, out, diagnostic


def expected_rows(geom, win, diagnostic) -> set:
    """CSV (left, diag, right) triples the planted diagnostic sites yield:
    the forward window, and for symmetric flanks its reverse complement."""
    left, mid, right = geom
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rows = set()
    for w in win[diagnostic]:
        s = w.tobytes()
        rows.add((s[:left].decode(), s[left:left + mid].decode(),
                  s[left + mid:].decode()))
        if left == right:
            r = s.translate(comp)[::-1]
            rows.add((r[:left].decode(), r[left:left + mid].decode(),
                      r[left + mid:].decode()))
    return rows


def make_genomes(outdir: str, size: int, n_ingroup: int = 2,
                 n_outgroup: int = 3, site_every: int = 1_000_000,
                 seed: int = 20260819, geom=GEOM):
    """Write the genomes; returns (paths, number of diagnostic sites)."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_sites = size // site_every
    length = sum(geom)
    # one shared flank per site, fixed across genomes (the first draw of
    # this stream, which planted_windows repeats for the spacer geometry)
    rng.integers(0, 4, size=(n_sites, L))
    site_pos = (np.arange(n_sites) * site_every
                + rng.integers(length, site_every - length, size=n_sites))
    win_in, win_out, diagnostic = planted_windows(n_sites, geom, seed)
    paths = []
    for g in range(n_ingroup + n_outgroup):
        ingroup = g < n_ingroup
        seq = BASES[rng.integers(0, 4, size=size)]
        for s in range(n_sites):
            window = win_in[s] if ingroup else win_out[s]
            seq[site_pos[s]:site_pos[s] + length] = window
        name = (f"ingroup{g}" if ingroup else f"outgroup{g - n_ingroup}")
        path = os.path.join(outdir, f"{name}.fasta")
        write_fasta(path, seq)
        paths.append(path)
    return paths, int(diagnostic.sum())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--size", type=int, default=100_000_000)
    ap.add_argument("--site-every", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=20260819)
    args = ap.parse_args()
    paths, n_diag = make_genomes(args.outdir, args.size,
                                 site_every=args.site_every, seed=args.seed)
    print(f"{len(paths)} genomes x {args.size} bases, "
          f"{n_diag} diagnostic sites -> expect {n_diag} CSV rows")
    for p in paths:
        print(" ", p)


if __name__ == "__main__":
    main()
