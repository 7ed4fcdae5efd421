"""Synthetic MS/MS spectrum generation for tests and benchmarks.

The reference ships no test data (SURVEY.md §4: "There are no tests"), so
this module generates realistic clustered inputs with known ground truth:
template spectra (random peak sets) are replicated with m/z jitter within
the fragment tolerance, intensity noise, and peak dropout, and mixed with
unrelated noise spectra.  Ground-truth cluster ids are returned so cluster
purity/completeness can be measured (BASELINE.json metric).
"""

import os
from typing import List, Optional, Tuple

import numpy as np

from .ms_io.containers import Spectrum
from .ms_io import mgf_io

PROTON = 1.0072766

# Bump when make_adversarial_spectra's behavior changes: benchmark
# corpus caches key on it (bench.py).
ADVERSARIAL_GEN_VERSION = 1


def make_clustered_spectra(
    n_clusters: int = 50,
    cluster_size: int = 10,
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
) -> Tuple[List[Spectrum], np.ndarray]:
    """Generate clustered spectra with ground-truth labels.

    Returns (spectra, labels); noise spectra get unique labels after the
    cluster ids.  ``precursor_classes`` concentrates precursor m/z around
    that many discrete mass classes (as tryptic peptide masses cluster in
    practice), producing realistically sized precursor-tolerance buckets;
    None draws precursors uniformly.
    """
    rng = np.random.default_rng(seed)
    if precursor_classes is not None:
        class_mzs = rng.uniform(*precursor_mz_range, precursor_classes)

        def draw_precursor():
            # Within +-8 ppm of a mass class (inside the 20 ppm default).
            base = float(rng.choice(class_mzs))
            return base * (1.0 + rng.normal(0, 4e-6))
    else:
        def draw_precursor():
            return float(rng.uniform(*precursor_mz_range))
    spectra: List[Spectrum] = []
    labels: List[int] = []
    scan = 0

    def random_template():
        k = int(rng.integers(n_peaks[0], n_peaks[1] + 1))
        mz = np.sort(rng.uniform(mz_range[0], mz_range[1], k))
        # Enforce minimal peak spacing (1 Da) so fragment-tolerance matching
        # is unambiguous, as for real peptide fragments.
        mz = np.sort(mz_range[0] + np.cumsum(
            rng.uniform(1.0, (mz_range[1] - mz_range[0]) / k, k)
        ))
        mz = np.clip(mz, *mz_range)
        intensity = rng.lognormal(0.0, 1.0, k).astype(np.float64) + 0.05
        return mz, intensity

    for c in range(n_clusters):
        template_mz, template_int = random_template()
        precursor_mz = draw_precursor()
        charge = int(rng.choice(charges))
        rt = float(rng.uniform(*rt_range))
        for m in range(cluster_size):
            keep = rng.uniform(size=len(template_mz)) >= dropout
            if keep.sum() < 8:
                keep[:] = True
            mz = template_mz[keep] + rng.normal(0, mz_jitter, keep.sum())
            intensity = template_int[keep] * rng.lognormal(
                0.0, intensity_jitter, keep.sum()
            )
            # Precursor m/z within a few ppm of the template's.
            pmz = precursor_mz * (1.0 + rng.normal(0, 2e-6))
            spectra.append(
                Spectrum(
                    f"cluster{c}_member{m}_scan{scan}",
                    pmz,
                    charge,
                    np.sort(mz),
                    intensity[np.argsort(mz)],
                    rt + float(rng.normal(0, 5.0)),
                )
            )
            labels.append(c)
            scan += 1

    for i in range(n_noise):
        mz, intensity = random_template()
        spectra.append(
            Spectrum(
                f"noise{i}_scan{scan}",
                draw_precursor(),
                int(rng.choice(charges)),
                mz,
                intensity,
                float(rng.uniform(*rt_range)),
            )
        )
        labels.append(n_clusters + i)
        scan += 1

    order = rng.permutation(len(spectra))
    return [spectra[i] for i in order], np.asarray(labels)[order]


def make_adversarial_spectra(
    n_clusters: int = 50,
    cluster_size: int = 10,
    n_noise: int = 100,
    n_peaks: Tuple[int, int] = (20, 50),
    mz_range: Tuple[float, float] = (101.0, 1495.0),
    precursor_mz_range: Tuple[float, float] = (400.0, 1200.0),
    charges: Tuple[int, ...] = (2, 3),
    mz_jitter: float = 0.01,
    intensity_jitter: float = 0.15,
    dropout: float = 0.1,
    rt_range: Tuple[float, float] = (0.0, 3600.0),
    precursor_classes: int = 25,
    backbone_fraction: float = 0.5,
    chimera_fraction: float = 0.15,
    charge_error_rate: float = 0.03,
    near_duplicate_fraction: float = 0.2,
    near_duplicate_swap: float = 0.08,
    seed: int = 42,
) -> Tuple[List[Spectrum], np.ndarray]:
    """Adversarial clustered corpus — quality metrics CAN fail on it.

    The easy generator above yields purity 1.00 for every measured
    configuration (its classes share no fragments), so purity carries no
    signal there (round-3 verdict: "a quality corpus that can fail").
    This generator stresses purity and completeness three ways:

    - **Shared fragment backbones**: clusters are grouped into precursor
      classes (same 20 ppm window); every template in a class draws
      ``backbone_fraction`` of its peaks from the class's shared
      backbone pool (same m/z positions, per-template intensities), so
      cross-cluster cosine similarity is structurally high and eps-graph
      edges ACROSS ground-truth classes become possible.
    - **Chimeric spectra**: a ``chimera_fraction`` of each cluster's
      members mix the cluster's template with another template from the
      same precursor class (65/35 intensity split).  Ground truth keeps
      the dominant template's label.
    - **Charge-assignment errors**: each member's reported charge is
      wrong with probability ``charge_error_rate``; per-charge
      partitioning then strands it in another bucket (a completeness
      hit no eps can recover, as with real charge-state
      misassignments).
    - **Near-duplicate twin classes**: a ``near_duplicate_fraction`` of
      clusters are twins of another cluster in the same precursor
      class — the template copied with ``near_duplicate_swap`` of its
      peaks replaced (the isobaric-variant / small-modification case).
      Twin cosine is ~``1 - near_duplicate_swap`` > ``1 - eps`` at the
      default eps, so ANY eps-0.1 clustering merges some twins: purity
      < 1.00 by construction, and differences between clustering
      methods become measurable.

    Backbone peaks carry CLASS-level intensities (lightly jittered per
    template), as shared fragment series do in practice.

    Returns (spectra, labels) like :func:`make_clustered_spectra`.
    """
    rng = np.random.default_rng(seed)
    class_mzs = rng.uniform(*precursor_mz_range, precursor_classes)

    def spaced_peaks(k: int) -> np.ndarray:
        mz = np.sort(mz_range[0] + np.cumsum(
            rng.uniform(1.0, (mz_range[1] - mz_range[0]) / k, k)
        ))
        return np.clip(mz, *mz_range)

    # Per-class shared backbone pools (positions only; intensities are
    # per-template so backbone overlap is partial, like shared peptide
    # fragment series).
    backbone_pool_size = max(n_peaks[1], 60)
    backbones = [spaced_peaks(backbone_pool_size)
                 for _ in range(precursor_classes)]
    # Class-level backbone intensity patterns (shared fragment series).
    backbone_ints = [rng.lognormal(0.0, 1.0, backbone_pool_size) + 0.05
                     for _ in range(precursor_classes)]

    templates = []
    for c in range(n_clusters):
        klass = c % precursor_classes
        prior_twins = [i for i, t in enumerate(templates)
                       if t[0] == klass]
        if prior_twins and rng.uniform() < near_duplicate_fraction:
            # Twin of an existing template in the class: swap a small
            # fraction of its peaks (isobaric variant / modification).
            base = templates[int(rng.choice(prior_twins))]
            mz = base[1].copy()
            intensity = base[2].copy()
            n_swap = max(1, int(round(near_duplicate_swap * len(mz))))
            swap_at = rng.choice(len(mz), n_swap, replace=False)
            mz[swap_at] = rng.uniform(mz_range[0], mz_range[1], n_swap)
            o = np.argsort(mz)
            mz, intensity = mz[o], intensity[o]
            twin_charge = base[4]  # same bucket as the base, or the
            # twin confusion never reaches the clustering stage
        else:
            twin_charge = None
            k = int(rng.integers(n_peaks[0], n_peaks[1] + 1))
            n_bb = min(int(round(backbone_fraction * k)),
                       backbone_pool_size)
            bb_at = rng.choice(backbone_pool_size, n_bb, replace=False)
            bb = backbones[klass][bb_at]
            bb_int = backbone_ints[klass][bb_at] * rng.lognormal(
                0.0, 0.3, n_bb)
            unique = spaced_peaks(max(k - n_bb, 1))
            mz = np.concatenate([bb, unique])
            intensity = np.concatenate([
                bb_int, rng.lognormal(0.0, 1.0, len(unique)) + 0.05,
            ])
            o = np.argsort(mz)
            mz, intensity = mz[o], intensity[o]
        pmz = float(class_mzs[klass]) * (1.0 + rng.normal(0, 4e-6))
        charge = (int(rng.choice(charges)) if twin_charge is None
                  else twin_charge)
        rt = float(rng.uniform(*rt_range))
        templates.append((klass, mz, intensity, pmz, charge, rt))

    def wrong_charge(true_charge: int) -> int:
        others = [z for z in charges if z != true_charge]
        return int(rng.choice(others)) if others else true_charge + 1

    spectra: List[Spectrum] = []
    labels: List[int] = []
    scan = 0
    for c, (klass, t_mz, t_int, t_pmz, t_charge, t_rt) in enumerate(
            templates):
        same_class = [i for i, t in enumerate(templates)
                      if t[0] == klass and i != c]
        for m in range(cluster_size):
            mz, intensity = t_mz, t_int
            ident = f"cluster{c}_member{m}_scan{scan}"
            if same_class and rng.uniform() < chimera_fraction:
                other = templates[int(rng.choice(same_class))]
                mz = np.concatenate([t_mz, other[1]])
                intensity = np.concatenate(
                    [t_int * 0.65, other[2] * 0.35])
                o = np.argsort(mz)
                mz, intensity = mz[o], intensity[o]
                ident = f"cluster{c}_member{m}_chimera_scan{scan}"
            keep = rng.uniform(size=len(mz)) >= dropout
            if keep.sum() < 8:
                keep[:] = True
            jmz = mz[keep] + rng.normal(0, mz_jitter, keep.sum())
            jint = intensity[keep] * rng.lognormal(
                0.0, intensity_jitter, keep.sum())
            charge = t_charge
            if rng.uniform() < charge_error_rate:
                charge = wrong_charge(t_charge)
            o = np.argsort(jmz)
            spectra.append(Spectrum(
                ident,
                t_pmz * (1.0 + rng.normal(0, 2e-6)),
                charge,
                jmz[o], jint[o],
                t_rt + float(rng.normal(0, 5.0)),
            ))
            labels.append(c)
            scan += 1

    for i in range(n_noise):
        klass = int(rng.integers(precursor_classes))
        k = int(rng.integers(n_peaks[0], n_peaks[1] + 1))
        n_bb = min(int(round(backbone_fraction * k)), backbone_pool_size)
        bb = rng.choice(backbones[klass], n_bb, replace=False)
        mz = np.sort(np.concatenate(
            [bb, spaced_peaks(max(k - n_bb, 1))]))
        spectra.append(Spectrum(
            f"noise{i}_scan{scan}",
            float(class_mzs[klass]) * (1.0 + rng.normal(0, 4e-6)),
            int(rng.choice(charges)),
            mz, rng.lognormal(0.0, 1.0, len(mz)) + 0.05,
            float(rng.uniform(*rt_range)),
        ))
        labels.append(n_clusters + i)
        scan += 1

    order = rng.permutation(len(spectra))
    return [spectra[i] for i in order], np.asarray(labels)[order]


def write_mgf(path: str, spectra: List[Spectrum]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    mgf_io.write_spectra(path, spectra)
    return path


def write_mzml(path: str, spectra: List[Spectrum],
               zlib_compress: bool = True) -> str:
    """Write spectra as a minimal mzML 1.1 document.

    Emits the subset of mzML the first-party reader consumes
    (``ms_io/mzml_io.py``): MS2 spectra with 64-bit m/z / 32-bit
    intensity binary arrays (optionally zlib), selected-ion m/z, charge
    state, and scan start time in seconds.  Used for multi-file mzML
    test/bench inputs (BASELINE.json config #2).
    """
    import base64
    import zlib as zlib_mod

    def b64(arr: np.ndarray) -> str:
        raw = arr.tobytes()
        if zlib_compress:
            raw = zlib_mod.compress(raw)
        return base64.b64encode(raw).decode()

    comp = (
        '<cvParam accession="MS:1000574" name="zlib compression"/>'
        if zlib_compress
        else '<cvParam accession="MS:1000576" name="no compression"/>'
    )
    chunks = [
        '<?xml version="1.0" encoding="utf-8"?>',
        '<mzML xmlns="http://psi.hupo.org/ms/mzml" version="1.1.0">',
        f'<run id="r"><spectrumList count="{len(spectra)}">',
    ]
    for i, spec in enumerate(spectra):
        charge = (
            f'<cvParam accession="MS:1000041" name="charge state" '
            f'value="{spec.precursor_charge}"/>'
            if spec.precursor_charge is not None
            else ""
        )
        chunks.append(
            f'<spectrum index="{i}" id="{spec.identifier}" '
            f'defaultArrayLength="{len(spec.mz)}">\n'
            '<cvParam accession="MS:1000511" name="ms level" value="2"/>\n'
            "<scanList count=\"1\"><scan>\n"
            '<cvParam accession="MS:1000016" name="scan start time" '
            f'value="{spec.retention_time}" unitName="second"/>\n'
            "</scan></scanList>\n"
            "<precursorList count=\"1\"><precursor>"
            "<selectedIonList count=\"1\"><selectedIon>\n"
            '<cvParam accession="MS:1000744" name="selected ion m/z" '
            f'value="{spec.precursor_mz}"/>\n'
            f"{charge}\n"
            "</selectedIon></selectedIonList></precursor></precursorList>\n"
            "<binaryDataArrayList count=\"2\">\n"
            "<binaryDataArray>\n"
            '<cvParam accession="MS:1000523" name="64-bit float"/>\n'
            f"{comp}\n"
            '<cvParam accession="MS:1000514" name="m/z array"/>\n'
            f"<binary>{b64(np.asarray(spec.mz, np.float64))}</binary>\n"
            "</binaryDataArray>\n"
            "<binaryDataArray>\n"
            '<cvParam accession="MS:1000521" name="32-bit float"/>\n'
            f"{comp}\n"
            '<cvParam accession="MS:1000515" name="intensity array"/>\n'
            f"<binary>{b64(np.asarray(spec.intensity, np.float32))}"
            "</binary>\n"
            "</binaryDataArray>\n"
            "</binaryDataArrayList>\n"
            "</spectrum>"
        )
    chunks.append("</spectrumList></run></mzML>")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(chunks))
    return path
