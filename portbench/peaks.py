"""The card's memory bandwidth and the byte counts of the matching launches.

Bandwidth: NVIDIA's H100 SXM data sheet (HBM3, at the 700 W limit).

The byte counts are the least any implementation of a launch must move:
each input byte read once (the spectra the launch scores, its offsets or
id lists) and each output written once, whatever the kernel reads again.
They depend only on what the launch is asked, never on how it computes, so
a share of the bound stays under 100% for any kernel.
"""

HBM_BYTES_PER_S = 3.35e12

SPECTRUM_BYTES_PER_PEAK = 8  # a float32 m/z and a float32 intensity


def grouped_bytes(n_rows: int, n_peaks: int, n_intervals: int,
                  n_pairs: int, with_matches: bool) -> int:
    """K4: every upper-triangle pair of many intervals of ``n_rows``
    spectra: the spectra, the interval offsets, one score (and match
    count) a pair."""
    out = n_pairs * (8 if with_matches else 4)
    return (n_rows * n_peaks * SPECTRUM_BYTES_PER_PEAK
            + (n_intervals + 1) * 8 + out)


def pair_list_bytes(n_spectra_read: int, n_peaks: int, n_rows: int,
                    k: int, with_matches: bool) -> int:
    """Pair lists: the distinct spectra the lists reach (queries with a
    valid slot and the pool rows they name), the (n_rows, k) int64 ids,
    one score (and match count) a slot."""
    return (n_spectra_read * n_peaks * SPECTRUM_BYTES_PER_PEAK
            + n_rows * k * 8 + n_rows * k * (8 if with_matches else 4))


def panel_bytes(n_spectra_read: int, n_peaks: int, n_pairs: int,
                with_matches: bool) -> int:
    """K1: a panel of row spectra against column spectra: the distinct
    spectra read, one score (and match count) a scored pair."""
    return (n_spectra_read * n_peaks * SPECTRUM_BYTES_PER_PEAK
            + n_pairs * (8 if with_matches else 4))
