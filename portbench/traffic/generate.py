"""The one generator of the benchmark's inputs.

It draws reads from a configuration's sample model, from the seed alone:

* distinct barcodes of ``bc_len`` bases for the ``cells`` and the
  ``ambient_barcodes``; cell sizes lognormal with ``cell_size_sigma``, the
  ambient barcodes sharing ``ambient_read_share`` of the reads evenly;
* molecules (barcode, UMI, gene), one for every ``reads_per_molecule``
  reads, the gene drawn from a Zipf law of ``gene_zipf_exponent`` over
  ``genes`` ids;
* each read a uniformly drawn molecule, so reads come unsorted, and with
  probability ``barcode_error_rate`` one barcode base substituted.

Everything is drawn in a few vectorised numpy calls, and the same seed gives
the same reads wherever numpy's generators are the same.
"""

from __future__ import annotations

import os

import numpy as np

U64 = np.uint64


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of ``stream`` for ``seed``; any integer seed works."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


def _distinct_words(rng: np.random.Generator, k: int, bases: int) -> np.ndarray:
    space = 4**bases
    if k > space // 2:
        raise ValueError(f"{k} distinct {bases}-mers asked of a space of {space}")
    words = np.zeros(0, dtype=U64)
    while len(words) < k:
        more = rng.integers(0, space, size=2 * k, dtype=U64)
        words = np.unique(np.concatenate([words, more]))
    return rng.permutation(words)[:k]


def sample(cfg: dict, n: int, seed: int) -> dict[str, np.ndarray]:
    """``n`` reads of ``cfg``'s sample: ``barcode``, ``umi`` and ``index``
    (the gene id) as uint64 arrays in read order."""
    rng = rng_for(seed)
    bc_len, umi_len = cfg["bc_len"], cfg["umi_len"]
    n_cells, n_amb = cfg["cells"], cfg["ambient_barcodes"]
    barcodes = _distinct_words(rng, n_cells + n_amb, bc_len)
    share = cfg["ambient_read_share"]
    w_cells = rng.lognormal(0.0, cfg["cell_size_sigma"], n_cells)
    weights = np.concatenate([w_cells * ((1 - share) / w_cells.sum()),
                              np.full(n_amb, share / max(n_amb, 1))])
    genes = cfg["genes"]
    gene_w = 1.0 / np.arange(1, genes + 1) ** cfg["gene_zipf_exponent"]
    gene_ids = rng.permutation(genes).astype(U64)

    # molecules: each barcode's and each gene's number from one multinomial,
    # the genes dealt to the molecules in a random order
    n_mol = max(1, int(round(n / cfg["reads_per_molecule"])))
    mol_bc = np.repeat(barcodes, rng.multinomial(n_mol, weights / weights.sum()))
    mol_umi = rng.integers(0, 4**umi_len, size=n_mol, dtype=U64)
    mol_gene = rng.permutation(np.repeat(gene_ids, rng.multinomial(n_mol, gene_w / gene_w.sum())))
    mol = rng.integers(0, n_mol, size=n)
    barcode, umi, index = mol_bc[mol], mol_umi[mol], mol_gene[mol]
    err = np.flatnonzero(rng.random(n) < cfg["barcode_error_rate"])
    pos = rng.integers(0, bc_len, size=err.size).astype(U64)
    delta = rng.integers(1, 4, size=err.size).astype(U64)
    barcode[err] ^= delta << (U64(2) * pos)
    return {"barcode": barcode, "umi": umi, "index": index}


#: the four ASCII letters of every byte of a packed word, as one uint32
_QUAD = np.array(
    [np.frombuffer(bytes(b"ACGT"[(q >> (2 * m)) & 3] for m in range(4)), dtype="<u4")[0]
     for q in range(256)],
    dtype="<u4",
)


def ascii_rows(words: np.ndarray, length: int) -> np.ndarray:
    """``(N,)`` packed words → ``(N, length)`` upper-case ASCII rows (base
    ``i`` at bits ``2i``), four bases a table lookup."""
    nbytes = -(-length // 4)
    quads = _QUAD[np.ascontiguousarray(words, dtype="<u8").view(np.uint8).reshape(-1, 8)[:, :nbytes]]
    return np.ascontiguousarray(quads.view(np.uint8).reshape(len(words), 4 * nbytes)[:, :length])


def structured(reads: dict[str, np.ndarray], lo: int = 0, hi: int | None = None) -> np.ndarray:
    """Reads ``lo:hi`` as 24-byte records ``<barcode, umi, index>`` (u64 LE)."""
    hi = len(reads["barcode"]) if hi is None else hi
    out = np.empty(hi - lo, dtype=[("barcode", "<u8"), ("umi", "<u8"), ("index", "<u8")])
    for field in ("barcode", "umi", "index"):
        out[field] = reads[field][lo:hi]
    return out


def write_file(path: str, header: bytes, records: np.ndarray) -> None:
    """An IBU file: ``header`` then the records, synced to the disk so that
    write-back does not run into the measured window."""
    with open(path, "wb") as f:
        f.write(header)
        records.tofile(f)
        f.flush()
        os.fsync(f.fileno())
