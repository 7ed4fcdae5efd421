from .store import ChargeDataset, SpectrumStore, ShardWriter  # noqa: F401
