"""Training the MoE family in the port against the JAX package on the CPU:
reduced deepseek-moe-16b (a dense first layer, then MoE: top-2 of 8 and a
shared expert) and reduced llama4-scout-17b-a16e (top-1 of 8 in every
layer), both at the launcher's capacity 2.0.

  * one float32 train step from the JAX TrainState (test_torch_train.py's
    step_case and check_f32_case: loss, the aux loss, every gradient and
    moment leaf within 1e-5 of its largest value, the updated params within
    adamw_bound);
  * the bf16 training forward within the JAX package's own bound for two
    paths of one bf16 MoE model: 0.05 * max(1, max |logits|) for top-2,
    three times that for top-1 routing (tests/test_torch_moe.py: a bf16 ulp
    of the residual stream flips a router choice at a near-tie);
  * the dispatch's backward (a token's k slot gradients gathered and added
    in ascending expert order, no atomics) equal to autograd's own backward
    of the index_put it replaces, to the bit for top-2 (two terms: the same
    sum in either order);
  * a training forward under remat logs each MoE layer's dropped slots once
    (the recompute in the backward does not log them again);
  * launch.train --reduced --device cpu for both archs, resumed bit-equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import (  # noqa: E402
    bf16_logits_check,
    check_f32_case,
    jx,  # noqa: F401  (the fixture)
    launch_resume_check,
    step_case,
)

from repro_torch import configs  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.runtime import train as t_train  # noqa: E402

ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e"]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_step_f32_matches_the_reference(jx, arch):  # noqa: F811
    check_f32_case(jx, step_case(jx, "float32", arch), arch)


@pytest.mark.parametrize("arch,bound", [(ARCHS[0], 0.05), (ARCHS[1], 0.15)])
def test_moe_training_forward_bf16_within_the_reference_bound(jx, arch, bound):  # noqa: F811
    bf16_logits_check(jx, arch, bound)


@pytest.mark.parametrize("capacity", [2.0, 0.5])
def test_dispatch_backward_equals_the_index_put_backward(capacity):
    """_experts_sorted's dispatch gradient against the same layer with the
    dispatch written as autograd's index_put (float32, top-2 of 8, 96
    tokens; at capacity 0.5 slots drop and get no gradient)."""
    cfg = configs.get(ARCHS[0]).reduced()
    rng = np.random.default_rng(7)
    n, d = 96, cfg.d_model
    xt0 = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    p = {k: torch.from_numpy((0.1 * rng.standard_normal(s)).astype(np.float32))
         for k, s in (("w1", (8, d, 64)), ("w3", (8, d, 64)), ("w2", (8, 64, d)))}
    logits = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    gates, idx = moe._top_k(torch.softmax(logits, -1), cfg.top_k)
    dy = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))

    def plain(xt, tok, dest, keep, at, rows):
        buf = torch.zeros((rows + 1, xt.shape[1]), dtype=xt.dtype)
        return buf.index_put((dest,), xt[tok])

    grads = []
    for dispatch in (moe._Dispatch.apply, plain):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(moe, "COMPUTE_DTYPE", torch.float32)
            mp.setattr(moe._Dispatch, "apply", staticmethod(dispatch))
            xt = xt0.clone().requires_grad_(True)
            y = moe._experts_sorted(p, xt, gates, idx, cfg, capacity)
            grads.append(torch.autograd.grad(y, xt, dy)[0])
    assert torch.equal(grads[0], grads[1])
    assert float(grads[0].abs().max()) > 0


@pytest.mark.parametrize("remat", [True, False])
def test_moe_drop_log_counts_a_training_forward_once(remat):
    """loss_and_grads of reduced deepseek-moe-16b at capacity 0.5 (slots
    drop) inside drop_log: one count a MoE layer, with remat as without,
    and the same counts as a forward with no grad."""
    cfg = configs.get(ARCHS[0]).reduced()
    model = Model(cfg, device="cpu", trainable=True, remat=remat, moe_capacity=0.5)
    t_train.init_state(model, torch.Generator().manual_seed(0))
    batch = make_batch(0, 0, 2, 32, cfg.vocab_size, device="cpu")
    n_moe = sum(spec.n_layers for spec in model.stages if spec.moe)
    with moe.drop_log() as trained:
        t_train.loss_and_grads(model, batch)
    with moe.drop_log() as served, torch.no_grad():
        model.train_logits(batch)
    assert len(trained) == len(served) == n_moe
    assert [int(x) for x in trained] == [int(x) for x in served]
    assert sum(int(x) for x in trained) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_launch_train_resumes(tmp_path, arch):
    launch_resume_check(tmp_path, arch)
