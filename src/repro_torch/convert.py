"""State carried across from the JAX reference.

Turns the reference's objects, given as numpy arrays plus constants, into
the port's: a NetworkEnv, a ModelProfile, EccWeights and a PlanState, so a
plan made by the reference can warm-start the port's replan. Constants may
be any object with the fields of RadioConstants / ComputeConstants (the
reference's dataclasses qualify) or a dict. No JAX here: callers convert
their arrays with np.asarray first. to_numpy goes the other way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import (
    ComputeConstants,
    EccWeights,
    ModelProfile,
    NetworkEnv,
    RadioConstants,
)
from repro_torch.device import resolve_device
from repro_torch.planning.engine import PlanState

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float32,
           np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int32,
           np.dtype(np.bool_): torch.bool}


def tensor(x, device=None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor on ``device``: floats become
    float32 and integers int32, the reference's dtypes."""
    a = np.array(x)     # a writable copy: arrays from JAX are read-only
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {a.dtype}")
    return torch.from_numpy(a).to(device=resolve_device(device),
                                  dtype=_DTYPES[a.dtype])


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(v, device) for v in x)
    return None if x is None else tensor(x, device)


def constants(cls, src):
    """``cls`` (RadioConstants or ComputeConstants) from None (defaults), a
    dict, or any object carrying the same field names."""
    if src is None:
        return cls()
    if isinstance(src, dict):
        return cls(**src)
    return cls(**{f.name: float(getattr(src, f.name)) for f in dataclasses.fields(cls)})


def env_from_numpy(g_up, g_dn, ap, radio=None, comp=None, device=None) -> NetworkEnv:
    return NetworkEnv(g_up=tensor(g_up, device), g_dn=tensor(g_dn, device),
                      ap=tensor(ap, device),
                      radio=constants(RadioConstants, radio),
                      comp=constants(ComputeConstants, comp))


def profile_from_numpy(fl, w, m_down, name: str = "model", device=None) -> ModelProfile:
    return ModelProfile(fl=tensor(fl, device), w=tensor(w, device),
                        m_down=tensor(m_down, device), name=name)


def weights_from_numpy(w_T, w_E, device=None) -> EccWeights:
    return EccWeights(w_T=tensor(w_T, device), w_E=tensor(w_E, device))


def plan_state_from_numpy(norms: dict, moms=None, opt_steps=None, gains=None,
                          device=None) -> PlanState:
    """The warm-start payload of a reference PlanState: norms is the dict of
    stacked per-split optima, moms the (m1, m2) pair of such dicts, opt_steps
    the per-split optimizer steps and gains the planned epoch's g_up."""
    return PlanState(
        plan=None, norms=_tree(dict(norms), device),
        moms=_tree(None if moms is None else tuple(dict(m) for m in moms), device),
        opt_steps=_tree(opt_steps, device), gains=_tree(gains, device))


def to_numpy(x):
    """Tensors (alone, or in dicts, tuples, lists and dataclasses) to numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_numpy(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return x
