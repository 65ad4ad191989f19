"""Synthetic training data (copies of ``repro/data``)."""
from repro_torch.data.synthetic import BigramLM, SyntheticCLIP  # noqa: F401
