"""Model primitives: norms, RoPE, MLPs, embeddings, parameter descriptors.

Every parameter is described by a ParamDef. It is stored in the dtype the
JAX package uses it in: the JAX package stores float32 and casts at each
use, to COMPUTE_DTYPE (bf16) for matmul weights, embeddings and the conv,
and keeps float32 for norms and the RG-LRU gates. Rounding to bf16 is
deterministic, so storing the cast gives the same numbers at half the
memory.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple            # logical axis names, len == len(shape)
    init: str = "normal"   # normal | zeros | ones
    scale: float = 0.02
    dtype: torch.dtype = COMPUTE_DTYPE   # storage dtype


def _leaves(defs: dict, prefix: tuple = ()):
    for k, d in defs.items():
        if isinstance(d, dict):
            yield from _leaves(d, prefix + (k,))
        else:
            yield prefix + (k,), d


def init_params(defs: dict, generator: torch.Generator, n_stack: int = 0) -> dict:
    """A nested dict of tensors for a nested dict of ParamDefs, drawn from
    ``generator`` (on its device) in float32 and stored in each def's dtype.
    With n_stack > 0 a leading layers dimension of that size is added to
    every leaf."""
    device = generator.device
    out: dict = {}
    for path, d in _leaves(defs):
        shape = (n_stack, *d.shape) if n_stack else d.shape
        if d.init == "zeros":
            arr = torch.zeros(shape, dtype=d.dtype, device=device)
        elif d.init == "ones":
            arr = torch.ones(shape, dtype=d.dtype, device=device)
        else:
            arr = torch.randn(shape, generator=generator, device=device).mul_(d.scale)
            arr = arr.to(d.dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


class Params(nn.Module):
    """A nested dict of ParamDefs as a module: sub-dicts become child Params,
    leaves frozen nn.Parameters allocated (uninitialised) on ``device``.
    load_() fills them from a nested dict of tensors, casting to each
    leaf's storage dtype; tree() gives the nested dict of parameters."""

    def __init__(self, defs: dict, device):
        super().__init__()
        self.defs = defs
        for k, d in defs.items():
            if isinstance(d, dict):
                self.add_module(k, Params(d, device))
            else:
                t = torch.empty(d.shape, dtype=d.dtype, device=device)
                self.register_parameter(k, nn.Parameter(t, requires_grad=False))

    @torch.no_grad()
    def load_(self, tree: dict) -> "Params":
        for k, v in tree.items():
            if isinstance(v, dict):
                getattr(self, k).load_(v)
            else:
                dst = self._parameters[k]
                if tuple(v.shape) != tuple(dst.shape):
                    raise ValueError(f"{k}: shape {tuple(v.shape)}, expected "
                                     f"{tuple(dst.shape)}")
                dst.copy_(v)
        return self

    def tree(self) -> dict:
        out: dict = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


# ---------------------------------------------------------------------------
def rms_norm(x, w, eps: float = 1e-5):
    """Gemma's RMSNorm with a (1 + w) gain, in float32."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int. Rotary embedding with
    the two halves split (not interleaved); the frequencies are
    exp(-i * (log(theta) / half)) in float32, as the JAX package builds
    them."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    # a fill, not a copy from the host: a CUDA graph may capture this
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32, device=x.device))
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=x.device)
                     * (log_theta / half))
    ang = positions[..., None].float() * freq            # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def mlp_apply(p: dict, x, act: str):
    """SwiGLU (w1/w3/w2) or GELU (w1/w2) MLP. GELU is the tanh form, the
    JAX default."""
    if act == "swiglu":
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    else:
        h = F.gelu(x @ p["w1"], approximate="tanh")
    return h @ p["w2"]


def mlp_defs(d_model: int, d_ff: int, act: str) -> dict:
    defs = {
        "w1": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w2": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }
    if act == "swiglu":
        defs["w3"] = ParamDef((d_model, d_ff), ("embed", "mlp"))
    return defs


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def embed_lookup(table, tokens):
    return F.embedding(tokens, table).to(COMPUTE_DTYPE)


def logits_out(x, table, vocab: int):
    """Project to the (padded) vocab in float32; mask the padding rows to
    -1e30."""
    logits = (x @ table.to(COMPUTE_DTYPE).T).float()
    vp = table.shape[0]
    if vp != vocab:
        mask = torch.arange(vp, device=x.device) < vocab
        logits = torch.where(mask, logits, -1e30)
    return logits
