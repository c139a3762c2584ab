"""Core datatypes for the ECC / Li-GD NOMA split-inference planner.

Plain frozen dataclasses holding float32 tensors on one device. Units:
  gains          -- linear power gains |h|^2 (dimensionless, includes path loss)
  powers         -- Watts
  bandwidth      -- Hz
  workloads f    -- FLOPs
  data sizes w,m -- bits
  compute c      -- FLOP/s
  energy coeff   -- xi * c^2 = Joules per FLOP (DVFS-style E ~ xi c^2 f)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

Tensor = torch.Tensor

# ln(2), shared by every rate computation (bit/s = Hz * ln(1+SINR)/LOG2).
LOG2 = 0.6931471805599453


def tree_map(fn, x):
    """fn on every tensor of x: dicts, lists, tuples, named tuples and
    dataclasses are rebuilt around the results; anything else (floats,
    ints, None) passes through."""
    if isinstance(x, Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, list):
        return [tree_map(fn, v) for v in x]
    if hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, tuple):
        return tuple(tree_map(fn, v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: tree_map(fn, getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


class TreeDef:
    """The structure of a flattened tree (tree_flatten): node kinds, types,
    field names and dict keys, with a leaf kind at each leaf. ``str`` gives a
    stable, readable form (what a snapshot's meta.json records as
    ``treedef``): ``*`` a tensor, ``int`` a Python int (a counter such as
    ScenarioState.epoch), ``None`` a None; ``Name(field=..)`` a NamedTuple
    or dataclass,
    ``{'key': ..}`` a dict (keys sorted), ``(..)`` a tuple, ``[..]`` a list.
    Two TreeDefs are equal when their strings are."""

    def __init__(self, kind: str, node_type=None, keys: tuple = (), children: tuple = ()):
        self.kind, self.node_type, self.keys, self.children = kind, node_type, keys, children

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_kinds())

    def leaf_kinds(self) -> list[str]:
        """The kind of each leaf in flatten order: "tensor" or "int"."""
        if self.kind in ("tensor", "int"):
            return [self.kind]
        return [k for c in self.children for k in c.leaf_kinds()]

    def __str__(self) -> str:
        if self.kind == "tensor":
            return "*"
        if self.kind == "int":
            return "int"
        if self.kind == "none":
            return "None"
        inner = [str(c) for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in zip(self.keys, inner)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(inner) + "]"
        if self.kind == "tuple":
            return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"
        fields = ", ".join(f"{k}={c}" for k, c in zip(self.keys, inner))
        return f"{self.node_type.__name__}({fields})"

    __repr__ = __str__

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and str(self) == str(other)


def tree_flatten(tree) -> tuple[list, TreeDef]:
    """(leaves, treedef) of a tree of dicts, lists, tuples, NamedTuples and
    dataclasses over tensors, Python ints and None. Leaves come in a fixed
    order: fields in declaration order, dict keys sorted. Anything else
    (a bool or a float included) raises TypeError."""
    leaves: list = []

    def rec(x) -> TreeDef:
        if isinstance(x, Tensor):
            leaves.append(x)
            return TreeDef("tensor")
        if x is None:
            return TreeDef("none")
        if type(x) is int:
            leaves.append(x)
            return TreeDef("int")
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return TreeDef("dict", dict, keys, tuple(rec(x[k]) for k in keys))
        if hasattr(x, "_fields"):
            return TreeDef("named", type(x), tuple(x._fields), tuple(rec(v) for v in x))
        if isinstance(x, (tuple, list)):
            kind = "list" if isinstance(x, list) else "tuple"
            return TreeDef(kind, type(x), (), tuple(rec(v) for v in x))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = tuple(f.name for f in dataclasses.fields(x))
            return TreeDef("dataclass", type(x), names,
                           tuple(rec(getattr(x, n)) for n in names))
        raise TypeError(f"tree_flatten: unsupported node {type(x).__name__}")

    treedef = rec(tree)
    return leaves, treedef


def tree_unflatten(treedef: TreeDef, leaves):
    """The tree of ``treedef`` with ``leaves`` (in flatten order) at its
    leaves. An int leaf given as a 0-d array or tensor becomes a Python int
    again."""
    it = iter(leaves)

    def rec(td: TreeDef):
        if td.kind == "tensor":
            return next(it)
        if td.kind == "int":
            v = next(it)
            return int(v.item() if hasattr(v, "item") else v)
        if td.kind == "none":
            return None
        kids = [rec(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.keys, kids))
        if td.kind == "named":
            return td.node_type(*kids)
        if td.kind == "dataclass":
            return td.node_type(**dict(zip(td.keys, kids)))
        return td.node_type(kids)

    tree = rec(treedef)
    if next(it, None) is not None:
        raise ValueError(f"tree_unflatten: more leaves than {treedef.num_leaves}")
    return tree


def host_copies(tensors) -> list[Tensor]:
    """CPU copies of ``tensors``, never views of them: CUDA tensors are
    copied into pinned host memory without blocking and waited for once
    (one sync for the lot), CPU tensors cloned."""
    out = []
    for x in tensors:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
        buf.copy_(x.detach(), non_blocking=x.is_cuda)
        out.append(buf)
    if any(x.is_cuda for x in tensors):
        torch.cuda.current_stream().synchronize()
    return out


@dataclasses.dataclass(frozen=True)
class RadioConstants:
    """Paper Sec. VI.A constants (configurable)."""

    bandwidth_up_hz: float = 10e6
    bandwidth_dn_hz: float = 10e6
    noise_psd_w_per_hz: float = 10 ** ((-174.0 - 30.0) / 10.0)  # -174 dBm/Hz
    p_up_min_w: float = 1e-3          # 0 dBm
    p_up_max_w: float = 0.3162        # 25 dBm (paper)
    p_dn_min_w: float = 0.1
    p_dn_max_w: float = 10.0
    beta_min: float = 1e-3            # numerical floor for relaxed subchannel share
    path_loss_exp: float = 5.0        # paper
    cell_radius_m: float = 250.0


@dataclasses.dataclass(frozen=True)
class ComputeConstants:
    """Device / edge compute + energy model constants."""

    c_device: float = 2.5e10          # FLOP/s of the mobile device
    c_min_edge: float = 2.5e10        # FLOP/s of one minimum edge compute unit
    r_min: float = 1.0
    r_max: float = 16.0
    lam_exponent: float = 0.85        # lambda(r) = r^0.85 (multicore nonlinearity)
    xi_device: float = 1.3e-31        # J/FLOP = xi * c^2  (~2 W mobile SoC)
    xi_edge: float = 4.0e-33          # quadratic in allocated speed (paper eq. 16)
    phi_device: float = 1.0           # paper's cycles/bit factor, folded to 1
    phi_edge: float = 1.0


@dataclasses.dataclass(frozen=True)
class NetworkEnv:
    """A realization of the NOMA radio network.

    Shapes: U users, N APs, M subchannels.
      g_up[u, n, m]  uplink |h|^2 from user u to AP n on subchannel m
      g_dn[n, u, m]  downlink |h|^2 from AP n to user u on subchannel m
      ap[u]          nearest-AP association (int32)
    A fleet of B same-shape environments (planning.stack_envs) leads every
    tensor with B; the shape properties read the trailing dims, and radio /
    comp stay shared constants.
    """

    g_up: Tensor
    g_dn: Tensor
    ap: Tensor
    radio: RadioConstants = RadioConstants()
    comp: ComputeConstants = ComputeConstants()

    @property
    def n_users(self) -> int:
        return self.g_up.shape[-3]

    @property
    def n_aps(self) -> int:
        return self.g_up.shape[-2]

    @property
    def n_sub(self) -> int:
        return self.g_up.shape[-1]

    @property
    def fleet(self) -> int | None:
        """B for a fleet, None for one environment."""
        return self.g_up.shape[0] if self.g_up.ndim == 4 else None

    @property
    def device(self) -> torch.device:
        return self.g_up.device

    @property
    def noise_up(self) -> float:
        return self.radio.noise_psd_w_per_hz * self.radio.bandwidth_up_hz / self.n_sub

    @property
    def noise_dn(self) -> float:
        return self.radio.noise_psd_w_per_hz * self.radio.bandwidth_dn_hz / self.n_sub

    def _own(self, g_unm: Tensor) -> Tensor:
        idx = self.ap.long()[..., None, None].expand(*self.ap.shape, 1, g_unm.shape[-1])
        return torch.gather(g_unm, -2, idx).squeeze(-2)

    def own_gain_up(self) -> Tensor:  # ([B,] U, M)
        return self._own(self.g_up)

    def own_gain_dn(self) -> Tensor:  # ([B,] U, M)
        return self._own(self.g_dn.transpose(-3, -2))

    def same_cell(self) -> Tensor:  # ([B,] U, U) bool
        return self.ap[..., :, None] == self.ap[..., None, :]

    def to(self, device) -> "NetworkEnv":
        return dataclasses.replace(self, g_up=self.g_up.to(device),
                                   g_dn=self.g_dn.to(device),
                                   ap=self.ap.to(device))


class ProfileShapeError(ValueError):
    """A measured (or otherwise substituted) profile does not match the
    static profile's layer structure."""


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Per-layer profile of an inference model (device-side units).

    fl[d]       FLOPs of layer d (d = 0..F-1)
    w[s]        bits of the activation produced by layer s (s = 0 is the raw
                input, so splitting at s=0 means full offload; w[F] = 0)
    m_down[s]   bits of the final result sent back down when split at s
                (0 when s == F: nothing was offloaded)
    """

    fl: Tensor
    w: Tensor
    m_down: Tensor
    name: str = "model"

    @property
    def n_layers(self) -> int:
        return self.fl.shape[0]

    def validate_like(self, other: "ModelProfile") -> "ModelProfile":
        """Check that ``other`` is drop-in compatible with this profile:
        same layer count, same shapes and dtypes, and the same name. Returns
        ``other``; raises ProfileShapeError naming the offending field."""
        if other.n_layers != self.n_layers:
            raise ProfileShapeError(
                f"measured profile has {other.n_layers} layers but the "
                f"static profile '{self.name}' has {self.n_layers}; build "
                "measured profiles with ModelProfile.like")
        for field in ("fl", "w", "m_down"):
            a, b = getattr(self, field), getattr(other, field)
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise ProfileShapeError(
                    f"measured profile field '{field}' is "
                    f"{tuple(b.shape)}/{b.dtype} but the static profile "
                    f"'{self.name}' expects {tuple(a.shape)}/{a.dtype}")
        if other.name != self.name:
            raise ProfileShapeError(
                f"measured profile is named {other.name!r} but the static "
                f"profile is {self.name!r}; build measured profiles with "
                "ModelProfile.like, which preserves it")
        return other

    def like(self, fl, w, m_down) -> "ModelProfile":
        """A profile with this profile's name and layer structure but new
        per-layer tables, cast to the static tables' dtypes and device."""
        def cast(x, ref):
            return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
        made = ModelProfile(fl=cast(fl, self.fl), w=cast(w, self.w),
                            m_down=cast(m_down, self.m_down), name=self.name)
        return self.validate_like(made)

    def prefix_flops(self) -> Tensor:
        """device-side FLOPs for split s = 0..F  (shape F+1)."""
        return torch.cat([self.fl.new_zeros(1), torch.cumsum(self.fl, 0)])

    def suffix_flops(self) -> Tensor:
        """edge-side FLOPs for split s = 0..F  (shape F+1)."""
        return torch.sum(self.fl) - self.prefix_flops()

    def to(self, device) -> "ModelProfile":
        return dataclasses.replace(self, fl=self.fl.to(device),
                                   w=self.w.to(device),
                                   m_down=self.m_down.to(device))


@dataclasses.dataclass(frozen=True)
class EccWeights:
    """Per-user tradeoff weights (omega_T + omega_E = 1)."""

    w_T: Tensor  # (U,)
    w_E: Tensor  # (U,)

    def to(self, device) -> "EccWeights":
        return EccWeights(w_T=self.w_T.to(device), w_E=self.w_E.to(device))


@dataclasses.dataclass(frozen=True)
class GdConfig:
    step_size: float = 5e-3
    eps: float = 1e-5
    max_iters: int = 400
    # "adam" is the beyond-paper optimizer upgrade; "sgd" is paper-faithful.
    optimizer: str = "sgd"
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    # First stopping rule (Table I line 6): "pgd" tests the projected-gradient
    # residual ||x - P(x - step_size*g)|| / step_size < eps; "raw" is the
    # paper-parity ||g|| < eps.
    stop_rule: str = "pgd"
    # SINR backend of the solver's utility: "einsum" (plain tensor algebra)
    # or "kernel" (the hand-written NOMA kernels, kernels/noma_rates.py).
    sinr_backend: str = "einsum"


@dataclasses.dataclass(frozen=True)
class GdVars:
    """The continuous relaxation optimized by (Li-)GD."""

    beta_up: Tensor  # (U, M) in simplex rows
    beta_dn: Tensor  # (U, M)
    p_up: Tensor     # (U,) Watts
    p_dn: Tensor     # (U,) Watts
    r: Tensor        # (U,) edge compute units


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Final discrete plan produced by the planner."""

    s: Tensor            # () int32 chosen split layer in 0..F
    sub_up: Tensor       # (U,) int32 chosen uplink subchannel
    sub_dn: Tensor       # (U,) int32
    p_up: Tensor         # (U,)
    p_dn: Tensor         # (U,)
    r: Tensor            # (U,)
    utility: Tensor      # () utility at the chosen plan (relaxed)
    per_layer_utility: Tensor  # (F+1,)
    iters: Tensor        # (F+1,) GD iterations spent per split point
    rounding_violations: Tensor  # () users whose 0.5-rounding broke (18.e)


def make_weights(n_users: int, w_T: float = 0.5, device=None) -> EccWeights:
    t = torch.full((n_users,), float(w_T), dtype=torch.float32,
                   device=resolve_device(device))
    return EccWeights(w_T=t, w_E=1.0 - t)


def lam(r: Tensor, comp: ComputeConstants) -> Tensor:
    """Multicore speedup lambda(r): monotone, concave (paper Sec III.A.2)."""
    return torch.pow(r, comp.lam_exponent)
