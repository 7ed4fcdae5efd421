"""Spectra a second through whole passes (``cli.main``, MGF to CSV) under
falcon's published DBSCAN clustering: the spectra of all the window's
passes over the window's seconds on the host clock, the quotient the
end-to-end ``spectra_per_s`` takes.  Per layer in the DBSCAN cell, whose
rate has no end-to-end bound."""


def read(run):
    if not run.passes or run.window_s <= 0:
        return None
    return run.spectra / run.window_s
