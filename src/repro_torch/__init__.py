"""PyTorch/CUDA port of the NOMA-MEC split-inference planner.

Mirrors the layout of the JAX package ``repro`` and imports nothing from it.
Plain tensor code is PyTorch; the NOMA interference kernels are CUDA C++
for Hopper (kernels/csrc/), built at first use. Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device  # noqa: F401
