"""The compiled serve steps and the loop's epoch as CUDA graphs, on the card.

Marked `cuda`: each test asks for the `cuda` fixture, which skips when no
card is present. Run on the card with

    python -m pytest -q --noconftest -m cuda tests/test_torch_serve_steps_cuda.py

* jit_prefill, jit_decode_step and jit_masked_decode_step on a reduced
  model of each family (random weights from a seed; the vision and audio
  families with every xgate at 0.5 and a frontend) equal the eager steps
  (Model.prefill, Model.decode_step, and slot_where over it) to the bit,
  logits and caches leaf for leaf, over a prefill replayed and 8 decode and
  8 masked steps (the first of each captures, the rest replay); each
  replay's kernel launches, flash_attention launches by shape and MoE
  dropped-slot counts equal the eager step's, and the kernels on the
  device trace of a replay of each program (torch.profiler) equal the
  eager step's launches;
* a replayed serve step makes no blocking sync in its program call;
* the loop's online_epoch program equals the eager epoch to the bit on a
  hardened loop, and its program calls make no blocking sync;
* a DecodeBatcher admits prompts of three lengths into its live caches
  (three graphs, one program) and steps them as the eager batcher does;
* a serve step whose capture fails raises (in a process of its own).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, graphs  # noqa: E402
from repro_torch.core import GdConfig, channel, profiles  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import noma_rates as nr  # noqa: E402
from repro_torch.kernels import rg_lru as rl  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.online import slot_where  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["qwen1.5-0.5b", "recurrentgemma-9b", "deepseek-moe-16b", "xlstm-125m",
            "whisper-small", "llama-3.2-vision-11b"]
B, S, MAX_LEN, STEPS = 3, 16, 40, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _model(name, dev):
    model = Model(configs.get(name).reduced(), device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    for key, p in model.named_parameters():
        if key.endswith("xgate"):
            p.data.fill_(0.5)
    return model


def _batch(model, dev, seed=0):
    cfg = model.cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev,
                                     dtype=torch.int32)}
    if cfg.family in ("vlm", "audio"):
        batch["frontend"] = torch.randn((B, cfg.frontend_tokens, cfg.d_model), generator=g,
                                        device=dev)
    toks = [torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device=dev,
                          dtype=torch.int32) for _ in range(2 * STEPS)]
    return batch, toks


def _counted(fn):
    """fn()'s result and its launches: the kernels', flash's by shape, and
    the MoE dropped-slot counts (host ints)."""
    torch.cuda.synchronize()
    for reset in (nr.reset_launches, fa.reset_launches, rl.reset_launches):
        reset()
    with moe.drop_log() as drops:
        out = fn()
    torch.cuda.synchronize()
    launched = ({**nr.LAUNCHES, **fa.LAUNCHES, **rl.LAUNCHES}, dict(fa.SHAPES),
                [int(d) for d in drops])
    return out, launched


def _traced(fn):
    """fn()'s result and _counted's launches, with the kernels the device
    trace of the call holds in place of the kernels' counters."""
    (out, launched), seen = graphs.traced_launches(lambda: _counted(fn))
    assert seen == launched[0], (seen, launched[0])
    return out, launched


def _equal_trees(got, want, what):
    bad = graphs.differing(got, want)
    assert not bad, (what, bad)


@pytest.mark.parametrize("name", FAMILIES)
def test_replayed_serve_steps_equal_the_eager_steps(cuda, name):
    model = _model(name, cuda)
    batch, toks = _batch(model, cuda)
    (want_log, want), launched = _counted(lambda: model.prefill(batch, MAX_LEN))
    pre, _ = serve.jit_prefill(model, None, MAX_LEN)
    log1, c1 = pre(None, batch)                          # eager, then captured
    (log2, caches), replayed = _traced(lambda: pre(None, batch))
    assert pre.program.graph_count == 1
    assert replayed == launched, (replayed, launched)
    for log, c in ((log1, c1), (log2, caches)):
        assert torch.equal(log, want_log)
        _equal_trees(c, want, (name, "prefill"))
    del c1
    dec, _, _ = serve.jit_decode_step(model, None, B, MAX_LEN)
    for k in range(STEPS):
        (want_log, want), launched = _counted(lambda: model.decode_step(want, toks[k]))
        (log, caches), replayed = (_traced if k == 1 else _counted)(
            lambda: dec(None, caches, toks[k]))
        assert replayed == launched, (name, k, replayed, launched)
        assert torch.equal(log, want_log), (name, "decode", k)
    _equal_trees(caches, want, (name, "decode"))
    masked, _, _ = serve.jit_masked_decode_step(model, None, B, MAX_LEN)
    for k in range(STEPS):
        active = torch.tensor([True, k % 2 == 0, k < 4], device=cuda)
        tok = toks[STEPS + k]

        def eager():
            logits, new = model.decode_step(want, torch.where(active[:, None], tok, 0))
            return logits, slot_where(active, new, want)
        (want_log, want), launched = _counted(eager)
        (log, caches), replayed = (_traced if k == 1 else _counted)(
            lambda: masked(None, caches, tok, active))
        assert replayed == launched, (name, k, replayed, launched)
        assert torch.equal(log, want_log), (name, "masked", k)
        _equal_trees(caches, want, (name, "masked", k))
    assert dec.program.graph_count == masked.program.graph_count == 1


def _syncs(fn) -> int:
    """The blocking syncs fn() makes (set_sync_debug_mode("warn"))."""
    torch.cuda.synchronize()
    _, inside, outside = graphs.blocking_syncs(fn)
    return inside + sum(outside.values())


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "deepseek-moe-16b"])
def test_replayed_serve_steps_make_no_blocking_sync(cuda, name):
    model = _model(name, cuda)
    batch, toks = _batch(model, cuda)
    pre, _ = serve.jit_prefill(model, None, MAX_LEN)
    dec, _, _ = serve.jit_decode_step(model, None, B, MAX_LEN)
    masked, _, _ = serve.jit_masked_decode_step(model, None, B, MAX_LEN)
    active = torch.tensor([True, False, True], device=cuda)
    _, caches = pre(None, batch)
    _, caches = dec(None, caches, toks[0])
    _, caches = masked(None, caches, toks[1], active)
    state = {"caches": caches}

    def replays():
        pre(None, batch)
        for k in range(4):
            _, state["caches"] = dec(None, state["caches"], toks[2 + k])
            _, state["caches"] = masked(None, state["caches"], toks[6 + k], active)
    assert _syncs(replays) == 0


def _loop(dev):
    from repro_torch.faults import FaultConfig, LadderConfig
    from repro_torch.online import OnlineLoop, ServiceConfig, StreamConfig
    from repro_torch.planning import PlannerEngine
    from repro_torch.scenarios import Scenario, ScenarioConfig
    eng = PlannerEngine(profiles.nin(), cfg=GdConfig(step_size=3e-2, eps=1e-4, max_iters=40,
                                                     optimizer="adam"), sinr_backend="kernel")
    return OnlineLoop(Scenario(ScenarioConfig(n_users=48, n_aps=4, n_sub=16, fading_rho=0.95,
                                              arrival_rate_hz=2.0)),
                      eng, StreamConfig(arrival_rate_hz=3.0, epoch_dt_s=0.02, deadline_s=0.2),
                      ServiceConfig(edge_capacity=4, queue_depth=16, load_gain=4.0,
                                    replan_every=3, max_work_epochs=200),
                      faults=FaultConfig(link_outage_rate=0.2, ap_outage_rate=0.05,
                                         telemetry_drop_rate=0.1, service_spike_rate=0.02),
                      degrade=LadderConfig())


def test_replayed_epoch_equals_the_eager_epoch(cuda):
    """Ten hardened epochs through the online_epoch graph against the
    eager epoch: every state and EpochOut tensor to the bit (NaN where
    NaN), the same NOMA launches an epoch (the third epoch's read off the
    device trace); the program calls make no blocking sync."""
    from repro_torch.planning import programs
    prev = channel.set_sinr_backend("kernel")
    syncs = 0
    try:
        prog, eager = _loop(cuda), _loop(cuda)
        eager.epoch_program = eager.epoch_program.eager()
        prog.reset(1)
        eager.reset(1)
        calls = ((graphs.Compiled, "__call__"), (programs.Program, "advance"))
        for t in range(10):
            count = _traced if t == 2 else _counted
            ((out, _), inside, _), la = count(
                lambda: graphs.blocking_syncs(prog.step_epoch, calls))
            syncs += inside
            (want_out, _), lb = _counted(eager.step_epoch)
            assert la == lb, (t, la, lb)
            bad = graphs.differing(
                (prog._sc, prog._st, prog._bt, prog._qs, prog._tel, prog._fs, out),
                (eager._sc, eager._st, eager._bt, eager._qs, eager._tel, eager._fs, want_out))
            assert not bad, (t, bad)
    finally:
        channel.set_sinr_backend(prev)
    assert prog.epoch_program.graph_count == 1
    assert syncs == 0


def test_batcher_admits_prompts_of_several_lengths(cuda):
    """A DecodeBatcher on the card: three prompt lengths admitted into its
    live caches (one admission program, three graphs; the fourth
    admission replays), then masked steps; logits and caches to the bit
    against the eager batcher (Model.prefill and slot_update, decode_step
    and slot_where)."""
    from repro_torch.online import DecodeBatcher, slot_update
    model = _model("recurrentgemma-9b", cuda)
    batch, toks = _batch(model, cuda)
    lens = [S, S - 4, S - 8, S]
    prompts = [batch["tokens"][i % B:i % B + 1, :lens[i]] for i in range(4)]
    actives = [torch.tensor([True, k % 2 == 0, True, k < 2], device=cuda) for k in range(4)]
    steps = [torch.cat([toks[k], toks[k][:1]]) for k in range(4)]
    db = DecodeBatcher(model, None, capacity=4, max_len=MAX_LEN)
    got = [db.admit(i, p) for i, p in enumerate(prompts)]
    got += [db.step(tok, active) for tok, active in zip(steps, actives)]
    assert db.programs[0].graph_count == 3 and db.programs[1].graph_count == 1
    caches, want = model.make_caches(4, MAX_LEN), []
    for i, p in enumerate(prompts):
        logits, one = model.prefill({"tokens": p}, MAX_LEN)
        caches = slot_update(caches, i, one)
        want.append(logits[0])
    for tok, active in zip(steps, actives):
        logits, new = model.decode_step(caches, torch.where(active[:, None], tok, 0))
        caches = slot_where(active, new, caches)
        want.append(logits)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    _equal_trees(db.caches, caches, "batcher")


# A capture that fails leaves PyTorch's CUDA generator marked as capturing,
# so the process's later random draws on the card fail: the case runs in a
# process of its own.
FAILING_CAPTURE = """
import sys
import torch
from repro_torch import configs
from repro_torch.models import Model, attention
from repro_torch.runtime import serve

single = attention._single_pass


def reading(*a, **k):
    out = single(*a, **k)
    float(out.float().sum())       # a host read: legal eagerly, not in a capture
    return out


attention._single_pass = reading
dev = torch.device("cuda")
model = Model(configs.get("qwen1.5-0.5b").reduced(), device=dev).init(
    torch.Generator(device=dev).manual_seed(0))
tokens = torch.zeros((2, 8), dtype=torch.int32, device=dev)
_, caches = model.prefill({"tokens": tokens}, 16)
dec, _, _ = serve.jit_decode_step(model, None, 2, 16)
try:
    dec(None, caches, tokens[:, :1])
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0])
    sys.exit(0)
print("stepped without raising")
sys.exit(1)
"""


def test_a_failed_serve_capture_raises(cuda):
    """The step raises; nothing runs it eagerly in its place."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", FAILING_CAPTURE], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "raised:" in proc.stdout, proc.stdout + proc.stderr
