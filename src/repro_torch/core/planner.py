"""Planner facade: turns (network env, model profile, QoS weights) into a
discrete SplitPlan with a single call, and runs the paper's comparison.

A thin wrapper over li_gd.solve for one environment, on the env's device.
Code that plans repeatedly (online re-planning across a time-correlated
scenario, or fleets) uses planning.PlannerEngine, which owns the warm-start
state.
"""
from __future__ import annotations

from repro_torch.core import baselines, li_gd, profiles
from repro_torch.core.types import (
    EccWeights,
    GdConfig,
    ModelProfile,
    NetworkEnv,
    SplitPlan,
    make_weights,
)


def _weights(env: NetworkEnv, weights: EccWeights | None) -> EccWeights:
    if weights is None:
        return make_weights(env.n_users, device=env.device)
    return weights.to(env.device)


def plan(env: NetworkEnv, prof: ModelProfile, weights: EccWeights | None = None,
         cfg: GdConfig = GdConfig(), method: str = "li_gd",
         rounding: str = "best") -> SplitPlan:
    """method: 'li_gd' (paper), 'gd' (cold-start baseline).
    rounding: 'best' (best-of argmax/greedy, beyond-paper), 'greedy',
    or 'paper' (0.5-rule with argmax repair)."""
    return li_gd.solve(env, prof.to(env.device), _weights(env, weights), cfg,
                       method=method, rounding=rounding)


def plan_for_arch(env: NetworkEnv, arch_cfg, seq: int, batch: int = 1,
                  weights: EccWeights | None = None,
                  cfg: GdConfig = GdConfig()) -> SplitPlan:
    """Plan a split for one of the LM architectures (configs/)."""
    prof = profiles.from_arch_config(arch_cfg, seq=seq, batch=batch)
    return plan(env, prof, weights, cfg)


def compare_all(env: NetworkEnv, prof: ModelProfile,
                weights: EccWeights | None = None,
                cfg: GdConfig = GdConfig()) -> dict:
    """Run ECC-NOMA and every baseline; returns {name: Outcome} in the
    reference's order. The ECC-NOMA plan runs cfg.sinr_backend; its
    evaluation and Edge-Only run the module-level backend."""
    weights = _weights(env, weights)
    prof = prof.to(env.device)
    p = plan(env, prof, weights, cfg)
    return {
        "ecc_noma": baselines.evaluate_plan(env, prof, p, weights),
        "ecc_oma": baselines.ecc_oma(env, prof, weights, cfg),
        "device_only": baselines.device_only(env, prof),
        "edge_only": baselines.edge_only(env, prof),
        "neurosurgeon": baselines.neurosurgeon(env, prof),
        "dnn_surgery": baselines.dnn_surgery(env, prof),
    }
