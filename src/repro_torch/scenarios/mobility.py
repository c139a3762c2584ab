"""User mobility: random-waypoint motion inside the square service area.

Each user moves toward a private waypoint at the scenario speed; on arrival
(within one epoch's travel distance) a fresh waypoint is drawn. Positions
drive the large-scale path loss, so mobility couples into the planner through
slowly-drifting channel gains and occasional nearest-AP handovers.

Draws come from a torch.Generator; each ``*_from`` core takes them as
tensors (unit uniforms in [0, 1), standard normals, cluster indices) and
works with any leading fleet dims.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class MobilityState(NamedTuple):
    pos: Tensor       # ([B,] U, 2) current positions, meters
    waypoint: Tensor  # ([B,] U, 2) targets


def position_draws(gen: torch.Generator, n_users: int, cluster_frac: float = 0.0,
                   n_clusters: int = 1) -> dict:
    """The draws behind init_positions: unit uniforms, and with clusters
    their centers (unit), each user's cluster and standard-normal offsets."""
    dev = gen.device
    draws = {"uniform": torch.rand((n_users, 2), generator=gen, device=dev)}
    if cluster_frac > 0.0:
        draws["centers"] = torch.rand((n_clusters, 2), generator=gen, device=dev)
        draws["which"] = torch.randint(0, n_clusters, (n_users,), generator=gen, device=dev)
        draws["offsets"] = torch.randn((n_users, 2), generator=gen, device=dev)
    return draws


def positions_from(draws: dict, side_m: float, cluster_frac: float = 0.0,
                   cluster_radius_m: float = 30.0) -> Tensor:
    """Uniform positions, with the first cluster_frac of the users packed
    around hotspot centers (Gaussian blobs clipped to the area)."""
    uniform = draws["uniform"] * side_m
    if cluster_frac <= 0.0:
        return uniform
    n_users = uniform.shape[-2]
    centers = draws["centers"] * side_m
    which = draws["which"].long()
    picked = torch.gather(centers, -2, which[..., None].expand(*which.shape, 2))
    clustered = torch.clamp(picked + draws["offsets"] * cluster_radius_m, 0.0, side_m)
    in_cluster = (torch.arange(n_users, device=uniform.device)
                  < cluster_frac * n_users)[:, None]
    return torch.where(in_cluster, clustered, uniform)


def init_positions(gen: torch.Generator, n_users: int, side_m: float,
                   cluster_frac: float = 0.0, n_clusters: int = 1,
                   cluster_radius_m: float = 30.0) -> Tensor:
    return positions_from(position_draws(gen, n_users, cluster_frac, n_clusters),
                          side_m, cluster_frac, cluster_radius_m)


def init_state(gen: torch.Generator, pos: Tensor, side_m: float) -> MobilityState:
    wp = torch.rand(pos.shape, generator=gen, device=gen.device)
    return MobilityState(pos=pos, waypoint=wp * side_m)


def waypoint_step_from(state: MobilityState, fresh_unit: Tensor, speed_mps: float,
                       dt_s: float, side_m: float) -> MobilityState:
    """Advance every user by speed*dt toward its waypoint; a user that
    arrives takes fresh_unit * side_m as its next waypoint."""
    delta = state.waypoint - state.pos
    dist = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    travel = speed_mps * dt_s
    step = torch.where(dist > 1e-9, delta / torch.clamp_min(dist, 1e-9), 0.0) * travel
    arrived = (dist[..., 0] <= travel)[..., None]
    new_pos = torch.where(arrived, state.waypoint, state.pos + step)
    new_wp = torch.where(arrived, fresh_unit * side_m, state.waypoint)
    return MobilityState(pos=new_pos, waypoint=new_wp)


def waypoint_step(gen: torch.Generator, state: MobilityState, speed_mps: float,
                  dt_s: float, side_m: float) -> MobilityState:
    """speed == 0 degenerates to a static scenario."""
    fresh = torch.rand(state.waypoint.shape, generator=gen, device=gen.device)
    return waypoint_step_from(state, fresh, speed_mps, dt_s, side_m)
