"""The served LMs: dense and hybrid families, block kinds attn and rec."""
from repro_torch.models.blocks import StageSpec, stages_for  # noqa: F401
from repro_torch.models.model import Model  # noqa: F401
