"""The slice as a whole: PlannerEngine.plan and a warm replan in both
packages on the same envs, a reference plan carried across to warm-start
the port (also at U=200, N=16, M=40), the device policy, and the rule that
the port never imports JAX or the JAX package.

The JAX engine runs sinr_backend="einsum" (interpret-mode Pallas inside a
whole GD loop is too slow for the suite); the port runs "kernel", which on
the CPU is its plain twins. As test_engine_pallas_backend_matches_einsum_plan
does for the reference's own backends: s and the subchannels exactly,
powers and compute units to rtol 1e-3 / atol 1e-4, the utility to rtol 1e-4,
and the per-split iteration counts exactly (float32 sums in another order
have not moved a stopping step on these envs; a change that does shows up
here).

Run as a script, the file prints per-split iteration counts and warm
choices of plan + warm replan at U=200 for the JAX einsum path and the
port's einsum and kernel paths:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_engine.py
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import GdConfig  # noqa: E402
from repro_torch.core import profiles as tprof  # noqa: E402
from repro_torch.core.types import ProfileShapeError  # noqa: E402
from repro_torch.planning import PlannerEngine, WarmStateShapeError  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(optimizer="adam", max_iters=60)


def _jax():
    jax = pytest.importorskip("jax")
    from repro.core import make_env
    from repro.core import profiles as jprof
    from repro.core.types import GdConfig as JGdConfig
    from repro.planning import PlannerEngine as JEngine
    return jax, make_env, jprof, JGdConfig, JEngine


def _pair(u, n, m, seed):
    """A JAX env, a correlated next epoch (gains x exp(0.05 * N(0,1))), and
    the port's copies of both."""
    jax, make_env, *_ = _jax()
    from repro_torch import convert
    jenv = make_env(jax.random.PRNGKey(seed), u, n, m)
    rng = np.random.default_rng(seed)
    g_up = (np.asarray(jenv.g_up) * np.exp(0.05 * rng.standard_normal(jenv.g_up.shape))
            ).astype(np.float32)
    g_dn = (np.asarray(jenv.g_dn) * np.exp(0.05 * rng.standard_normal(jenv.g_dn.shape))
            ).astype(np.float32)
    jenv2 = dataclasses.replace(jenv, g_up=jax.numpy.asarray(g_up),
                                g_dn=jax.numpy.asarray(g_dn))
    ap = np.asarray(jenv.ap)
    t1 = convert.env_from_numpy(np.asarray(jenv.g_up), np.asarray(jenv.g_dn), ap,
                                jenv.radio, jenv.comp, device="cpu")
    t2 = convert.env_from_numpy(g_up, g_dn, ap, jenv.radio, jenv.comp, device="cpu")
    return jenv, jenv2, t1, t2


def _assert_same_plan(tstate, jstate):
    tp, jp = tstate.plan, jstate.plan
    assert int(tp.s) == int(jp.s)
    np.testing.assert_array_equal(tp.sub_up.numpy(), np.asarray(jp.sub_up))
    np.testing.assert_array_equal(tp.sub_dn.numpy(), np.asarray(jp.sub_dn))
    for field in ("p_up", "p_dn", "r"):
        np.testing.assert_allclose(getattr(tp, field).numpy(),
                                   np.asarray(getattr(jp, field)), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(tp.utility), float(jp.utility), rtol=1e-4)
    assert tp.iters.tolist() == np.asarray(jp.iters).tolist()
    assert int(tstate.total_iters) == int(jstate.total_iters)


@pytest.mark.parametrize("u,n,m,seed", [(16, 3, 8, 0), (20, 4, 6, 2)])
def test_plan_and_warm_replan_match_reference(u, n, m, seed):
    _, _, jprof, JGdConfig, JEngine = _jax()
    jenv, jenv2, t1, t2 = _pair(u, n, m, seed)
    je = JEngine(jprof.nin(), cfg=JGdConfig(**CFG), sinr_backend="einsum")
    te = PlannerEngine(tprof.nin(), cfg=GdConfig(**CFG), sinr_backend="kernel",
                       device="cpu")
    js, ts = je.plan(jenv), te.plan(t1)
    _assert_same_plan(ts, js)
    assert ts.warm_rho is None
    js2, ts2 = je.replan(js, jenv2), te.replan(ts, t2)
    _assert_same_plan(ts2, js2)
    np.testing.assert_allclose(float(ts2.warm_rho), float(js2.warm_rho), rtol=1e-5)
    assert float(ts2.warm_rho) > te.warm_rho_min     # the warm gate was open
    assert ts2.opt_steps.tolist() == np.asarray(js2.opt_steps).tolist()


def _port_state(js):
    """A reference PlanState carried across with convert."""
    from repro_torch import convert
    return convert.plan_state_from_numpy(
        {k: np.asarray(v) for k, v in js.norms.items()},
        moms=tuple({k: np.asarray(v) for k, v in mm.items()} for mm in js.moms),
        opt_steps=np.asarray(js.opt_steps), gains=np.asarray(js.gains), device="cpu")


def test_reference_plan_warm_starts_the_port():
    """A plan made by the JAX engine, carried across with convert, warm-starts
    the port's replan to the reference's own replan."""
    _, _, jprof, JGdConfig, JEngine = _jax()
    jenv, jenv2, _, t2 = _pair(16, 3, 8, 0)
    je = JEngine(jprof.nin(), cfg=JGdConfig(**CFG))
    js = je.plan(jenv)
    te = PlannerEngine(tprof.nin(), cfg=GdConfig(**CFG), sinr_backend="kernel",
                       device="cpu")
    _assert_same_plan(te.replan(_port_state(js), t2), je.replan(js, jenv2))


def test_warm_replan_tracks_reference_at_moderate_size():
    """U=200, N=16, M=40. At this size a split's stopping step hangs on the
    float32 summation order: on one cold env the JAX einsum path and the
    port's einsum and kernel paths stop some splits up to 167 steps apart
    (this file run as a script prints them). So every split runs a fixed 20
    steps (eps=0), and the warm path itself is held to the reference's:
    from the reference's own plan state, the same rho estimate, the same
    warm-or-carry choice per split (opt_steps), the Adam state resumed, and
    the same s, subchannels and plan."""
    _, _, jprof, JGdConfig, JEngine = _jax()
    jenv, jenv2, _, t2 = _pair(200, 16, 40, 0)
    cfg = dict(optimizer="adam", max_iters=20, eps=0.0)
    je = JEngine(jprof.nin(), cfg=JGdConfig(**cfg), sinr_backend="einsum")
    js = je.plan(jenv)
    te = PlannerEngine(tprof.nin(), cfg=GdConfig(**cfg), sinr_backend="kernel",
                       device="cpu")
    ts2, js2 = te.replan(_port_state(js), t2), je.replan(js, jenv2)
    _assert_same_plan(ts2, js2)
    np.testing.assert_allclose(float(ts2.warm_rho), float(js2.warm_rho), rtol=1e-5)
    assert ts2.opt_steps.tolist() == np.asarray(js2.opt_steps).tolist()
    used_warm = ts2.opt_steps > ts2.plan.iters
    assert 0 < int(used_warm.sum()) < len(used_warm)     # both choices made


def test_engine_device_none_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device=None resolves to the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PlannerEngine(tprof.nin())


def test_engine_validates_its_inputs():
    from repro_torch.core import make_env
    eng = PlannerEngine(tprof.nin(), cfg=GdConfig(max_iters=3), device="cpu")
    env = make_env(6, 2, 4, seed=0, device="cpu")
    with pytest.raises(ValueError, match="sinr_backend"):
        PlannerEngine(tprof.nin(), sinr_backend="pallas", device="cpu")
    with pytest.raises(KeyError):
        PlannerEngine(tprof.nin(), method="newton", device="cpu")
    with pytest.raises(ValueError, match="warm_rho_min"):
        PlannerEngine(tprof.nin(), warm_rho_min=2.0, device="cpu")
    with pytest.raises(ProfileShapeError):
        eng.plan(env, prof=tprof.vgg16())
    state = eng.plan(env, prof=eng.prof.like(eng.prof.fl * 1.5, eng.prof.w, eng.prof.m_down))
    assert state.plan.iters.shape == (eng.prof.n_layers + 1,)
    with pytest.raises(WarmStateShapeError, match="static"):
        eng.replan(state, make_env(7, 2, 4, seed=0, device="cpu"))
    cold = eng.replan(None, env)
    assert cold.warm_rho is None
    bare = dataclasses.replace(state, moms=None, opt_steps=None, gains=None)
    warm = eng.replan(bare, env)
    assert float(warm.warm_rho) == pytest.approx(1.0)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert {"scenario.py", "fading.py", "mobility.py", "churn.py", "presets.py"} <= {
        f.name for f in files if f.parent.name == "scenarios"}
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"the port imports JAX or the JAX package: {bad}"


def _readings(u=200, n=16, m=50, max_iters=200):
    """Per-split GD iterations and warm choices of plan + warm replan, for
    the JAX einsum path and the port's einsum and kernel paths."""
    _, _, jprof, JGdConfig, JEngine = _jax()
    jenv, jenv2, t1, t2 = _pair(u, n, m, 0)
    cfg = dict(optimizer="adam", max_iters=max_iters)
    runs = (("jax einsum", JEngine(jprof.nin(), cfg=JGdConfig(**cfg),
                                   sinr_backend="einsum"), jenv, jenv2),
            *((f"port {b}", PlannerEngine(tprof.nin(), cfg=GdConfig(**cfg),
                                          sinr_backend=b, device="cpu"), t1, t2)
              for b in ("einsum", "kernel")))
    for name, eng, e1, e2 in runs:
        s1 = eng.plan(e1)
        s2 = eng.replan(s1, e2)
        for call, st in (("plan", s1), ("replan", s2)):
            iters = np.asarray(st.plan.iters)
            warm = (np.asarray(st.opt_steps) > iters).astype(int)
            print(f"{name:11s} {call:6s} s*={int(st.plan.s)} "
                  f"total={int(st.total_iters)} iters={iters.tolist()} "
                  f"used_warm={warm.tolist()} utility={float(st.plan.utility):.7g}")


if __name__ == "__main__":
    _readings()
