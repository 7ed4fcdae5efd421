from .spectrum import (  # noqa: F401
    get_dim,
    process_spectrum,
    ProcessedSpectrum,
)
