"""Architecture configs: the registry of the ten archs (data only)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCHS,
    SHAPES,
    SUBQUADRATIC,
    ArchConfig,
    all_names,
    get,
    shape_applicable,
)
import repro_torch.configs.archs  # noqa: F401,E402  (registers the 10 archs)
