from .containers import Spectrum  # noqa: F401
from . import ms_io  # noqa: F401
