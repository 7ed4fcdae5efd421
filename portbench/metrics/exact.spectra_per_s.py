"""Spectra a second through whole passes (``cli.main``, MGF to CSV) on the
exact backend: the spectra of all the window's passes over the window's
seconds on the host clock, as the end-to-end ``spectra_per_s`` is taken.
Per layer in the exact cell, whose runs spread too widely for an end-to-end
bound."""


def read(run):
    if not run.passes or run.window_s <= 0:
        return None
    return run.spectra / run.window_s
