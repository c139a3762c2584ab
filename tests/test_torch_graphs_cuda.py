"""The engine's CUDA graphs (planning.programs) on the card.

Marked `cuda`: each test asks for the `cuda` fixture, which skips when no
card is present. Run on the card with

    python -m pytest -q --noconftest -m cuda tests/test_torch_graphs_cuda.py

* plan / replan / plan_many / replan_many through the engine's graphs equal
  the eager path (programs.solve_state / resolve_state without a runner:
  li_gd.gd_loop + assemble_plan) on the same inputs to the bit, leaf for
  leaf, on the call that captures and on calls that only replay: the same
  kernels run in the same order;
* the launch and step counters across replays equal the eager path's;
* the replayed GD steps make no blocking sync; a replayed call's only ones
  are the per-chunk reads of the stop flags;
* a capture that fails raises: nothing runs the eager step in its place
  (in a process of its own).
"""
import collections
import gc
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import GdConfig, li_gd, make_env, profiles  # noqa: E402
from repro_torch.core.types import tree_flatten  # noqa: E402
from repro_torch.kernels import noma_rates as nr  # noqa: E402
from repro_torch.planning import PlannerEngine, compile_log, programs, stack_envs  # noqa: E402

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]
SYNC = "called a synchronizing CUDA operation"    # set_sync_debug_mode's warning
CFG = dict(step_size=1e-2, eps=1e-4, max_iters=60, optimizer="adam")
U, N, M = 40, 4, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _engine(dev, backend="kernel"):
    return PlannerEngine(profiles.nin(), cfg=GdConfig(**CFG), sinr_backend=backend, device=dev)


def _eager(eng, kind, env, prev=None):
    args = eng.program_args(kind, env, prev=prev)
    if kind.startswith("plan"):
        return programs.solve_state(*args, eng.cfg, eng.method, eng.rounding)
    return programs.resolve_state(*args, eng.cfg, eng.rounding, eng.warm_rho_min,
                                  eng.warm_moment_decay)


def _counted(fn):
    """fn()'s result and the NOMA launches and GD steps / host reads it made."""
    torch.cuda.synchronize()
    nr.reset_launches()
    li_gd.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(nr.LAUNCHES), dict(li_gd.COUNTS)


def _bit_equal(got, want):
    lg, tg = tree_flatten(got)
    lw, tw = tree_flatten(want)
    assert str(tg) == str(tw)
    bad = [i for i, (x, y) in enumerate(zip(lg, lw))
           if x.dtype != y.dtype or not torch.equal(x, y)]
    assert not bad, f"leaves {bad} of {tg} differ"


def _envs(dev, many, n=3):
    envs = [make_env(U, N, M, seed=s, device=dev) for s in range(2 * n)]
    if many:
        return [stack_envs(envs[i:i + 2]) for i in range(0, 2 * n, 2)]
    return envs[:n]


@pytest.mark.parametrize("many", (False, True))
@pytest.mark.parametrize("backend", ("kernel", "einsum"))
def test_graphs_equal_the_eager_path(cuda, many, backend):
    """A plan then two replans (fleets of 2 for the *_many kinds): each call
    equals the eager path on its inputs, its launches and steps equal the
    eager path's, and only the first call of a kind builds."""
    eng = _engine(cuda, backend)
    plan_kind, replan_kind = ("plan_many", "replan_many") if many else ("plan", "replan")
    prev, held = None, []
    for i, env in enumerate(_envs(cuda, many)):
        kind = plan_kind if prev is None else replan_kind
        with compile_log() as log:
            got, g_launch, g_count = _counted(
                lambda: getattr(eng, kind)(env) if prev is None
                else getattr(eng, kind)(prev, env))
        want, w_launch, w_count = _counted(lambda: _eager(eng, kind, env, prev))
        _bit_equal(got, want)
        assert g_launch == w_launch and g_count == w_count
        if backend == "kernel":
            assert all(v > 0 for v in g_launch.values())
        assert log == ([kind] if i < 2 else [])
        held.append((got, want))
        prev = got
    for got, want in held:       # no later call moved a returned state
        _bit_equal(got, want)
    assert eng.cache_size() == 2
    progs = list(eng._cache.values())
    splits = profiles.nin().n_layers + 1
    assert [p.graph_count for p in progs] == [splits + 1] * 2


def test_replayed_steps_make_no_blocking_sync(cuda, monkeypatch):
    """A replayed call's blocking syncs (set_sync_debug_mode("warn")): none
    inside Program.advance (the replayed GD steps), and outside it the
    per-chunk reads of the stop flags, one a chunk."""
    eng = _engine(cuda)
    envs = _envs(cuda, False)
    prev = eng.plan(envs[0])
    prev = eng.replan(prev, envs[1])
    advance, depth = programs.Program.advance, [0]

    def counted(self, step, n):
        depth[0] += 1
        try:
            return advance(self, step, n)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(programs.Program, "advance", counted)
    inside, outside = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC in str(message):      # not the mode's one-time prototype notice
            (inside if depth[0] else outside).append(f"{filename}:{lineno}")

    gc.collect()          # destroying dead engines' graphs syncs: not in the window
    torch.cuda.synchronize()
    li_gd.reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.replan(prev, envs[2])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert inside == []
    assert len(outside) == li_gd.COUNTS["host_reads"] > 0, collections.Counter(outside)
    gd_file = Path(li_gd.__file__).name
    assert all(Path(w.rsplit(":", 1)[0]).name == gd_file for w in outside), \
        collections.Counter(outside)


# A capture that fails leaves PyTorch's CUDA generator marked as capturing,
# so the process's later random draws on the card fail: the case runs in a
# process of its own.
FAILING_CAPTURE = """
import sys
from repro_torch.core import GdConfig, channel, make_env, profiles
from repro_torch.planning import PlannerEngine

rates = channel.user_rates


def reading(*a, **k):
    out = rates(*a, **k)
    float(out[0].sum())            # a host read: legal eagerly, not in a capture
    return out


channel.user_rates = reading
eng = PlannerEngine(profiles.nin(), cfg=GdConfig(optimizer="adam", max_iters=60),
                    sinr_backend="kernel")
env = make_env(40, 4, 16, seed=0)
try:
    eng.plan(env)
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0])
    sys.exit(0)
print("planned without raising")
sys.exit(1)
"""


def test_a_failed_capture_raises(cuda):
    """The call raises; nothing runs the step eagerly in its place."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", FAILING_CAPTURE], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0 and "raised:" in proc.stdout, proc.stdout + proc.stderr
