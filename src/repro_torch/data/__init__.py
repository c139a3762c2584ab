"""Synthetic data: the JAX package's numpy token stream as torch tensors."""
from repro_torch.data.pipeline import SyntheticLM, make_batch  # noqa: F401
