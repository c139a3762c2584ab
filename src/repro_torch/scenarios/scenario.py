"""Time-evolving NOMA network scenarios: the environment generator feeding
the online PlannerEngine.

A Scenario composes three processes, all with static shapes so every
epoch's NetworkEnv fits the same warm-start state:

  * Gauss-Markov (AR(1)) Rayleigh fading   -- scenarios.fading
  * random-waypoint user mobility          -- scenarios.mobility
  * Poisson slot-replacement churn         -- scenarios.churn

`step` advances one re-planning epoch and `env` emits its NetworkEnv;
`episode` rolls a whole correlated sequence. Epoch 0's env is distributed
like core.channel.make_env (uniform positions, Exp(1) fading).

`init_many` / `step_many` / `env_many` are the fleet variants: B
realizations of one ScenarioConfig evolving in parallel (tensors lead with
B), feeding PlannerEngine.plan_many / replan_many. step_many optionally
takes a per-member fading rho, so one fleet can sweep correlation levels.

Randomness is counter-based: the draws of an op come from a torch.Generator
on the scenario's device seeded by (seed, epoch) alone -- init is counter
0, the step into epoch t is counter t -- so a member's epoch-t draws depend
only on its seed and t, and member i of a fleet op equals the single op on
seeds[i]. Passing a torch.Generator instead of a seed draws from it as it
stands. Each op splits into the draws (`*_draws`) and a deterministic core
(`*_from`) that takes them as tensors and works on a fleet as on one
member. The epoch is a Python int (the counter), shared by a fleet that
steps together, so seeding needs no read of the device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple, Sequence

import torch

from repro_torch.core.types import ComputeConstants, NetworkEnv, RadioConstants
from repro_torch.device import resolve_device
from repro_torch.scenarios import churn, fading, mobility

Tensor = torch.Tensor
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Knobs of a time-evolving deployment. fading_rho overrides the
    Jakes-derived correlation when set; speed_mps=0 freezes mobility and
    arrival_rate_hz=0 disables churn."""

    n_users: int = 12
    n_aps: int = 3
    n_sub: int = 4
    epoch_dt_s: float = 0.1
    doppler_hz: float = 5.0
    fading_rho: float | None = None
    speed_mps: float = 1.4
    arrival_rate_hz: float = 0.0
    cluster_frac: float = 0.0
    n_clusters: int = 1
    cluster_radius_m: float = 30.0
    radio: RadioConstants = RadioConstants()
    comp: ComputeConstants = ComputeConstants()
    name: str = "custom"

    @property
    def rho(self) -> float:
        if self.fading_rho is not None:
            return float(self.fading_rho)
        return fading.jakes_rho(self.doppler_hz, self.epoch_dt_s)

    @property
    def side_m(self) -> float:
        return self.radio.cell_radius_m * max(1.0, self.n_aps**0.5)


class ScenarioState(NamedTuple):
    mob: mobility.MobilityState
    ap_pos: Tensor   # ([B,] N, 2) fixed for the episode
    h_up: Tensor     # ([B,] U, N, M) complex64
    h_dn: Tensor     # ([B,] U, N, M) complex64
    epoch: int       # epochs stepped since init (the draws' counter)


def _splitmix(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, counter: int) -> int:
    """The generator seed of (seed, counter): two rounds of splitmix64, cut
    to 63 bits."""
    return _splitmix(_splitmix(int(seed) & _MASK64) ^ int(counter)) >> 1


def _stack(trees: list):
    """Draw dicts (of tensors and tuples of tensors) stacked member-wise."""
    first = trees[0]
    if isinstance(first, Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return tuple(_stack(list(ts)) for ts in zip(*trees))


class Scenario:
    """device: None resolves to the card and raises without CUDA; pass
    device='cpu' for the CPU."""

    def __init__(self, cfg: ScenarioConfig, device=None):
        self._cfg = cfg
        self.device = resolve_device(device)

    @property
    def cfg(self) -> ScenarioConfig:
        """Read-only: build a new Scenario for new parameters."""
        return self._cfg

    def generator(self, seed: int | torch.Generator, counter: int) -> torch.Generator:
        """The generator of (seed, counter) on the scenario's device; a
        generator passed as the seed is returned as it is."""
        if isinstance(seed, torch.Generator):
            return seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold_in(seed, counter))
        return gen

    # -- state ------------------------------------------------------------
    def init_draws(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        shape = (cfg.n_users, cfg.n_aps, cfg.n_sub)
        return {
            "ap_pos": torch.rand((cfg.n_aps, 2), generator=gen, device=gen.device),
            "pos": mobility.position_draws(gen, cfg.n_users, cfg.cluster_frac,
                                           cfg.n_clusters),
            "waypoint": torch.rand((cfg.n_users, 2), generator=gen, device=gen.device),
            "h_up": fading.normal_pair(gen, shape),
            "h_dn": fading.normal_pair(gen, shape),
        }

    def init_from(self, draws: dict) -> ScenarioState:
        cfg = self.cfg
        pos = mobility.positions_from(draws["pos"], cfg.side_m, cfg.cluster_frac,
                                      cfg.cluster_radius_m)
        return ScenarioState(
            mob=mobility.MobilityState(pos=pos, waypoint=draws["waypoint"] * cfg.side_m),
            ap_pos=draws["ap_pos"] * cfg.side_m,
            h_up=fading.coeffs_from(*draws["h_up"]),
            h_dn=fading.coeffs_from(*draws["h_dn"]),
            epoch=0)

    def init(self, seed: int | torch.Generator) -> ScenarioState:
        return self.init_from(self.init_draws(self.generator(seed, 0)))

    def step_draws(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        shape = (cfg.n_users, cfg.n_aps, cfg.n_sub)
        draws = {"waypoint": torch.rand((cfg.n_users, 2), generator=gen, device=gen.device),
                 "h_up": fading.normal_pair(gen, shape),
                 "h_dn": fading.normal_pair(gen, shape)}
        if cfg.arrival_rate_hz > 0.0:
            draws["mask"] = torch.rand((cfg.n_users,), generator=gen, device=gen.device)
            draws["churn"] = churn.churn_draws(gen, (cfg.n_users, 2), shape)
        return draws

    def step_from(self, draws: dict, state: ScenarioState, rho=None) -> ScenarioState:
        """Advance one epoch given its draws. rho overrides the config's
        fading correlation: a float, or a (B,) tensor, one per member."""
        cfg = self.cfg
        mob = mobility.waypoint_step_from(state.mob, draws["waypoint"], cfg.speed_mps,
                                          cfg.epoch_dt_s, cfg.side_m)
        rho = cfg.rho if rho is None else rho
        if isinstance(rho, Tensor) and rho.ndim == 1:
            rho = rho.reshape(-1, 1, 1, 1)
        h_up = fading.gauss_markov_from(state.h_up, fading.coeffs_from(*draws["h_up"]), rho)
        h_dn = fading.gauss_markov_from(state.h_dn, fading.coeffs_from(*draws["h_dn"]), rho)
        if cfg.arrival_rate_hz > 0.0:
            mask = churn.mask_from(draws["mask"], cfg.n_users, cfg.arrival_rate_hz,
                                   cfg.epoch_dt_s)
            mob, h_up, h_dn = churn.apply_churn_from(draws["churn"], mask, mob, h_up, h_dn,
                                                     cfg.side_m)
        return ScenarioState(mob=mob, ap_pos=state.ap_pos, h_up=h_up, h_dn=h_dn,
                             epoch=state.epoch + 1)

    def step(self, seed: int | torch.Generator, state: ScenarioState,
             rho: float | None = None) -> ScenarioState:
        """Advance one epoch, drawing from (seed, state.epoch + 1)."""
        gen = self.generator(seed, state.epoch + 1)
        return self.step_from(self.step_draws(gen), state, rho)

    # -- realization ------------------------------------------------------
    def env(self, state: ScenarioState) -> NetworkEnv:
        """The NetworkEnv of the current epoch: path loss from positions x
        Gauss-Markov fading power, nearest-AP association. A fleet state
        gives a fleet env (tensors lead with B; radio/comp shared)."""
        cfg = self.cfg
        d = torch.linalg.vector_norm(
            state.mob.pos[..., :, None, :] - state.ap_pos[..., None, :, :], dim=-1)
        path = torch.clamp_min(d, 1.0) ** (-cfg.radio.path_loss_exp)   # (U, N)
        g_up = path[..., None] * fading.power_gain(state.h_up)
        g_dn = (path[..., None] * fading.power_gain(state.h_dn)).transpose(-3, -2)
        ap = torch.argmax(path, dim=-1).to(torch.int32)
        return NetworkEnv(g_up=g_up.contiguous(), g_dn=g_dn.contiguous(), ap=ap,
                          radio=cfg.radio, comp=cfg.comp)

    # -- fleets -----------------------------------------------------------
    def init_many(self, seeds: Sequence[int]) -> ScenarioState:
        """B realizations, member i from seeds[i]; tensors lead with B."""
        seeds = list(seeds)
        if not seeds:
            raise ValueError("init_many needs at least one seed")
        return self.init_from(_stack([self.init_draws(self.generator(s, 0)) for s in seeds]))

    def step_many(self, seeds: Sequence[int], states: ScenarioState,
                  rho: Tensor | Sequence[float] | None = None) -> ScenarioState:
        """Advance every member one epoch, member i drawing from
        (seeds[i], epoch + 1). rho: optional (B,) per-member correlation."""
        seeds = list(seeds)
        b = states.h_up.shape[0]
        if states.h_up.ndim != 4 or len(seeds) != b:
            raise ValueError(f"step_many takes a fleet state and one seed per member; got "
                             f"h_up {tuple(states.h_up.shape)} and {len(seeds)} seeds")
        draws = _stack([self.step_draws(self.generator(s, states.epoch + 1)) for s in seeds])
        if rho is not None:
            rho = torch.as_tensor(rho, dtype=torch.float32, device=self.device)
            if tuple(rho.shape) != (b,):
                raise ValueError(f"rho must have one value per member, ({b},); got "
                                 f"{tuple(rho.shape)}")
        return self.step_from(draws, states, rho)

    def env_many(self, states: ScenarioState) -> NetworkEnv:
        """The stacked NetworkEnv of the fleet, ready for
        PlannerEngine.plan_many / replan_many."""
        if states.h_up.ndim != 4:
            raise ValueError(f"env_many takes a fleet state; got h_up "
                             f"{tuple(states.h_up.shape)} -- use env() for one scenario")
        return self.env(states)

    def episode(self, seed: int, n_epochs: int) -> Iterator[NetworkEnv]:
        """Yield n_epochs correlated NetworkEnv realizations."""
        state = self.init(seed)
        for t in range(n_epochs):
            yield self.env(state)
            if t + 1 < n_epochs:
                state = self.step(seed, state)

    def episode_list(self, seed: int, n_epochs: int) -> list[NetworkEnv]:
        return list(self.episode(seed, n_epochs))
