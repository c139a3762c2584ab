"""The served LMs: dense, moe, hybrid, ssm, vlm and audio families; block
kinds attn (optionally MoE), cross, enc, dec, rec, mlstm and slstm."""
from repro_torch.models.blocks import StageSpec, stages_for  # noqa: F401
from repro_torch.models.model import Model  # noqa: F401
