"""Synthetic training data and the deterministic pipeline (copies of
``repro/data``)."""
from repro_torch.data.synthetic import BigramLM, SyntheticCLIP, SyntheticSeq2Seq  # noqa: F401
from repro_torch.data.pipeline import DeterministicBatcher, PrefetchIterator  # noqa: F401
