"""Hand-written Hopper kernels (csrc/), their wrappers and plain twins."""
from repro_torch.kernels.cells import CellLayout, build_cell_layout  # noqa: F401
