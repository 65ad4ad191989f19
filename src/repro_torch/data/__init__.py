"""Synthetic training data and the deterministic pipeline (copies of
``repro/data``)."""
from repro_torch.data.synthetic import BigramLM, SyntheticCLIP  # noqa: F401
from repro_torch.data.pipeline import DeterministicBatcher, PrefetchIterator  # noqa: F401
