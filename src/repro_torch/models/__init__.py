"""The served LMs: dense, moe, hybrid and ssm families; block kinds attn
(optionally MoE), rec, mlstm and slstm."""
from repro_torch.models.blocks import StageSpec, stages_for  # noqa: F401
from repro_torch.models.model import Model  # noqa: F401
