"""The benchmark's corpora: a frozen copy of the port's spectrum generator.

``make_clustered_spectra`` draws from one ``numpy.random.Generator`` in the
order of ``falcon_tpu_torch/simulate.py::make_clustered_spectra``, so with a
fixed ``cluster_size`` it gives that function's spectra exactly (values,
titles, labels and file order); ``portbench/tests`` holds it there.  It keeps
the spectra as flat arrays instead of ``Spectrum`` objects, and adds:

- cluster sizes given as a list (``cluster_sizes``), for the power law of
  ``power_law_sizes``, drawn from a seed of the traffic file's own, so every
  run seed clusters the same multiset of sizes;
- ``quantize`` and ``write_mgf``: each value is rounded to a fixed number
  of decimals and written with exactly those digits, so the file holds the
  values the reference reads, and the writer formats all peaks at once.

Nothing here imports the program.
"""

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

# Decimals written to the MGF file for each value.
MZ_DECIMALS = 5
INTENSITY_DECIMALS = 6
PEPMASS_DECIMALS = 7
RT_DECIMALS = 4


@dataclass
class Corpus:
    """Spectra as flat arrays, in file order.

    Peaks of spectrum ``i`` are ``mz[offsets[i]:offsets[i + 1]]``, sorted by
    m/z.  ``group``, ``member`` and ``scan`` rebuild each title
    (``title``); ``truth`` is the ground-truth class of each spectrum
    (noise spectra get their own)."""

    offsets: np.ndarray       # int64 (n + 1,)
    mz: np.ndarray            # float64 (n_peaks,)
    intensity: np.ndarray     # float64 (n_peaks,)
    precursor_mz: np.ndarray  # float64 (n,)
    charge: np.ndarray        # int64 (n,)
    rt: np.ndarray            # float64 (n,)
    truth: np.ndarray         # int64 (n,)
    is_noise: np.ndarray      # bool (n,)
    group: np.ndarray         # int64 (n,): cluster id, or noise index
    member: np.ndarray        # int64 (n,): member index, -1 for noise
    scan: np.ndarray          # int64 (n,): generation order

    def __len__(self) -> int:
        return len(self.precursor_mz)

    def title(self, i: int) -> str:
        return _title(int(self.group[i]), int(self.member[i]),
                      int(self.scan[i]))


def _title(group: int, member: int, scan: int) -> str:
    """The port's spectrum titles (noise spectra have member -1)."""
    if member < 0:
        return f"noise{group}_scan{scan}"
    return f"cluster{group}_member{member}_scan{scan}"


def power_law_sizes(total: int, exponent: float, smallest: int,
                    largest: int, seed: int) -> np.ndarray:
    """Cluster sizes with P(s) proportional to s^-exponent on
    smallest..largest, drawn until ``total`` spectra are placed; the last
    size is cut so that they sum to ``total`` exactly (and raised to
    ``smallest`` by taking from the largest, if the cut leaves less)."""
    rng = np.random.default_rng(seed)
    support = np.arange(smallest, largest + 1)
    p = support.astype(np.float64) ** -exponent
    p /= p.sum()
    sizes = []
    placed = 0
    while placed < total:
        draw = rng.choice(support, size=4096, p=p)
        for s in draw.tolist():
            sizes.append(min(s, total - placed))
            placed += sizes[-1]
            if placed >= total:
                break
    sizes = np.asarray(sizes, np.int64)
    if sizes[-1] < smallest:
        short = smallest - sizes[-1]
        sizes[-1] = smallest
        sizes[int(np.argmax(sizes[:-1]))] -= short
    return sizes


def make_clustered_spectra(
    n_clusters: int = 50,
    cluster_size: Union[int, Sequence[int]] = 10,
    n_noise: int = 100,
    n_peaks: Tuple[int, int] = (20, 50),
    mz_range: Tuple[float, float] = (101.0, 1495.0),
    precursor_mz_range: Tuple[float, float] = (400.0, 1200.0),
    charges: Tuple[int, ...] = (2, 3),
    mz_jitter: float = 0.01,
    intensity_jitter: float = 0.15,
    dropout: float = 0.1,
    rt_range: Tuple[float, float] = (0.0, 3600.0),
    precursor_classes: Optional[int] = None,
    seed: int = 42,
    structure_seed: Optional[int] = None,
) -> Corpus:
    """Clustered spectra with ground truth, drawn as the port's generator
    draws them.  ``cluster_size`` is one size for every cluster or a list
    of ``n_clusters`` sizes.  With ``structure_seed`` the corpus's shape
    (the precursor classes' m/z, each cluster's and noise spectrum's class
    and charge) comes from that seed, and only the spectra themselves from
    ``seed``, so that every seed gives the same precursor bands."""
    rng = np.random.default_rng(seed)
    srng = (rng if structure_seed is None
            else np.random.default_rng(structure_seed))
    sizes = (np.full(n_clusters, int(cluster_size), np.int64)
             if np.isscalar(cluster_size)
             else np.asarray(cluster_size, np.int64))
    if len(sizes) != n_clusters:
        raise ValueError(f"{len(sizes)} cluster sizes for {n_clusters} "
                         f"clusters")
    charges_arr = np.asarray(charges)
    # The port's draws in cheaper spellings that take the same values from
    # the stream: ``uniform(size=k)`` is ``random(k)``, ``normal(0, s)`` is
    # ``s * standard_normal()``, ``choice(a)`` is ``a[integers(0, len(a))]``.
    random, standard_normal, integers = (rng.random, rng.standard_normal,
                                         rng.integers)
    lognormal = rng.lognormal
    shape_integers = srng.integers
    if precursor_classes is not None:
        class_mzs = srng.uniform(*precursor_mz_range, precursor_classes)

        def draw_precursor():
            base = float(class_mzs[shape_integers(0, precursor_classes)])
            return base * (1.0 + 4e-6 * standard_normal())
    else:
        def draw_precursor():
            return float(srng.uniform(*precursor_mz_range))

    span = mz_range[1] - mz_range[0]

    def random_template():
        k = int(integers(n_peaks[0], n_peaks[1] + 1))
        random(k)  # the port draws k uniform m/z here and discards them
        mz = np.sort(mz_range[0] + np.cumsum(rng.uniform(1.0, span / k, k)))
        mz = np.clip(mz, *mz_range)
        intensity = lognormal(0.0, 1.0, k) + 0.05
        return mz, intensity

    n = int(sizes.sum()) + n_noise
    mz_parts, int_parts = [], []
    counts, pmz, charge, rt = [], [], [], []
    count_nonzero = np.count_nonzero
    for c in range(n_clusters):
        t_mz, t_int = random_template()
        precursor = draw_precursor()
        z = int(charges_arr[shape_integers(0, len(charges_arr))])
        t_rt = float(rng.uniform(*rt_range))
        k = len(t_mz)
        size = int(sizes[c])
        for _ in range(size):
            keep = random(k) >= dropout
            n_keep = count_nonzero(keep)
            if n_keep < 8:
                keep[:] = True
                n_keep = k
            mz_parts.append(t_mz[keep]
                            + mz_jitter * standard_normal(n_keep))
            int_parts.append(t_int[keep]
                             * lognormal(0.0, intensity_jitter, n_keep))
            counts.append(n_keep)
            pmz.append(precursor * (1.0 + 2e-6 * standard_normal()))
            rt.append(t_rt + 5.0 * standard_normal())
        charge.extend([z] * size)
    for i in range(n_noise):
        t_mz, t_int = random_template()
        mz_parts.append(t_mz)
        int_parts.append(t_int)
        counts.append(len(t_mz))
        pmz.append(draw_precursor())
        charge.append(int(charges_arr[shape_integers(0, len(charges_arr))]))
        rt.append(float(rng.uniform(*rt_range)))
    n_clustered = n - n_noise
    cluster_of = np.repeat(np.arange(n_clusters), sizes)
    member_of = (np.arange(n_clustered)
                 - np.repeat(np.cumsum(sizes) - sizes, sizes))
    group = np.concatenate([cluster_of, np.arange(n_noise)])
    member = np.concatenate([member_of, np.full(n_noise, -1, np.int64)])
    truth = np.concatenate([cluster_of, n_clusters + np.arange(n_noise)])
    counts = np.asarray(counts, np.int64)
    pmz = np.asarray(pmz, np.float64)
    charge = np.asarray(charge, np.int64)
    rt = np.asarray(rt, np.float64)
    order = rng.permutation(n)

    mz_gen = np.concatenate(mz_parts) if mz_parts else np.zeros(0)
    int_gen = np.concatenate(int_parts) if int_parts else np.zeros(0)
    off_gen = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=off_gen[1:])
    # Each spectrum's peaks sorted by m/z (jitter may swap neighbours),
    # then the spectra in file order.
    seg = np.repeat(np.arange(n), counts)
    by_mz = np.lexsort((mz_gen, seg))
    mz_gen, int_gen = mz_gen[by_mz], int_gen[by_mz]
    new_counts = counts[order]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(new_counts, out=offsets[1:])
    take = (np.repeat(off_gen[order] - offsets[:-1], new_counts)
            + np.arange(offsets[-1]))
    return Corpus(
        offsets=offsets, mz=mz_gen[take], intensity=int_gen[take],
        precursor_mz=pmz[order], charge=charge[order], rt=rt[order],
        truth=truth[order], is_noise=member[order] < 0, group=group[order],
        member=member[order], scan=order.astype(np.int64))


def from_traffic(params: Dict, seed: int) -> Corpus:
    """The corpus a traffic file describes, drawn from ``seed``.

    Keys: ``precursor_classes`` and ``n_noise``; either ``n_clusters`` with
    ``cluster_size``, or ``cluster_sizes`` as ``{"law": "power",
    "exponent", "min", "max", "total", "seed"}``; optionally any other
    argument of :func:`make_clustered_spectra` (``n_peaks``, ``mz_range``,
    ``charges``, ...)."""
    params = dict(params)
    for note in ("why", "source", "assumed"):
        params.pop(note, None)
    law = params.pop("cluster_sizes", None)
    if law is not None:
        if law.get("law") != "power":
            raise ValueError(f"unknown cluster size law {law!r}")
        sizes = power_law_sizes(law["total"], law["exponent"], law["min"],
                                law["max"], law["seed"])
        params["n_clusters"] = len(sizes)
        params["cluster_size"] = sizes
    for key in ("n_peaks", "mz_range", "precursor_mz_range", "charges",
                "rt_range"):
        if key in params:
            params[key] = tuple(params[key])
    return make_clustered_spectra(seed=seed, **params)


def quantize(corpus: Corpus) -> Corpus:
    """The corpus with every value rounded to the decimals the MGF file
    holds: each value becomes the double nearest to its written decimal,
    which is what a correctly rounded parser reads back."""
    def q(x, d):
        return np.round(x * 10.0 ** d) / 10.0 ** d
    return Corpus(
        offsets=corpus.offsets, mz=q(corpus.mz, MZ_DECIMALS),
        intensity=q(corpus.intensity, INTENSITY_DECIMALS),
        precursor_mz=q(corpus.precursor_mz, PEPMASS_DECIMALS),
        charge=corpus.charge, rt=q(corpus.rt, RT_DECIMALS),
        truth=corpus.truth, is_noise=corpus.is_noise, group=corpus.group,
        member=corpus.member, scan=corpus.scan)


def _fixed_point(x: np.ndarray, decimals: int) -> np.ndarray:
    """``x`` written with ``decimals`` decimals (a leading ``-`` where
    negative) as a right-aligned (len(x), width) uint8 matrix, padded on
    the left with zero bytes."""
    k = np.round(x * 10.0 ** decimals).astype(np.int64)
    neg = k < 0
    k = np.abs(k)
    ip = k // 10 ** decimals
    int_digits = np.ones(len(k), np.int64)
    while True:
        more = ip >= 10 ** int_digits
        if not more.any():
            break
        int_digits += more
    width_int = int(int_digits.max(initial=1)) + int(neg.any())
    width = width_int + 1 + decimals
    out = np.zeros((len(k), width), np.uint8)
    rest = k.copy()
    for col in range(width - 1, width_int, -1):
        out[:, col] = 48 + rest % 10
        rest //= 10
    out[:, width_int] = ord(".")
    for pos in range(width_int):
        col = width_int - 1 - pos
        digit = np.where(pos < int_digits, 48 + rest % 10, 0)
        out[:, col] = np.where(neg & (pos == int_digits), ord("-"), digit)
        rest //= 10
    return out


def write_mgf(path: str, corpus: Corpus) -> int:
    """Write ``corpus`` (already :func:`quantize`-d) as an MGF file; returns
    the bytes written.  Each spectrum has TITLE, PEPMASS, CHARGE and
    RTINSECONDS lines, then one ``m/z intensity`` line a peak."""
    n_peaks = len(corpus.mz)
    lines = np.concatenate(
        [_fixed_point(corpus.mz, MZ_DECIMALS),
         np.full((n_peaks, 1), ord(" "), np.uint8),
         _fixed_point(corpus.intensity, INTENSITY_DECIMALS),
         np.full((n_peaks, 1), ord("\n"), np.uint8)], axis=1)
    real = lines != 0
    peak_bytes = lines[real].tobytes()
    del lines
    line_end = np.concatenate([[0], np.cumsum(real.sum(axis=1))])
    starts = line_end[corpus.offsets].tolist()
    # A quantized value prints its own decimals exactly with a fixed
    # format: it is the double nearest to that decimal.
    parts = []
    for i, (g, m, s, pmz, z, rt) in enumerate(zip(
            corpus.group.tolist(), corpus.member.tolist(),
            corpus.scan.tolist(), corpus.precursor_mz.tolist(),
            corpus.charge.tolist(), corpus.rt.tolist())):
        parts.append(
            f"BEGIN IONS\nTITLE={_title(g, m, s)}\n"
            f"PEPMASS={pmz:.{PEPMASS_DECIMALS}f}"
            f"\nCHARGE={z}+\nRTINSECONDS={rt:.{RT_DECIMALS}f}\n".encode())
        parts.append(peak_bytes[starts[i]:starts[i + 1]])
        parts.append(b"END IONS\n\n")
    data = b"".join(parts)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
