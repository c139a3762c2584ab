"""Training the hybrid family (reduced recurrentgemma-9b: rec, rec, attn,
window 64) in the port against the JAX package on the CPU, and the RG-LRU
gradient.

  * the rg_lru backward (its plain twin, reached through ops.rg_lru's
    autograd Function) against jax.vjp of the model's associative scan
    repro.models.recurrent._rglru_scan, on numpy inputs from a seed, with
    and without h0, at ragged S and W: each of dlog_a, db and dh0 within
    1e-5 of its float32 summation bound (the same reverse recurrence on
    |dh|; for dlog_a times a_t and the forward's bound on h_{t-1}, the
    recurrence on |b| and |h0|; for dh0 times a_0: the magnitudes of the
    terms each gradient adds up; the scan sums them in another order);
  * one float32 train step from the JAX TrainState (test_torch_train.py's
    step_case and check_f32_case: loss, aux, every gradient and moment leaf
    within 1e-5 of its largest value, the updated params within
    adamw_bound);
  * the bf16 training forward within the JAX package's own bound for two
    paths of one bf16 model, 0.05 * max(1, max |logits|), and the loss
    within 0.05 * max(1, |loss|);
  * launch.train --reduced --device cpu, resumed bit-equal.
The CUDA kernel runs only on the card (test_torch_kernels_cuda.py and
chip_smoke.py hold it to this twin, bit for bit)."""
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

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rg_lru as rl  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = 1e-5


def _bound(log_a, xb, h0, dh):
    """The float32 summation bound of each gradient element: lam on |dh|,
    and h_{t-1} as the forward's bound (the recurrence on |b| and |h0|)."""
    a = np.exp(log_a)
    h = np.zeros_like(xb)
    acc = np.zeros_like(xb[:, 0]) if h0 is None else np.abs(h0)
    for t in range(xb.shape[1]):
        acc = a[:, t] * acc + np.abs(xb[:, t])
        h[:, t] = acc
    lam = np.zeros_like(dh)
    acc = np.zeros_like(dh[:, 0])
    for t in range(dh.shape[1] - 1, -1, -1):
        acc = (a[:, t + 1] if t + 1 < dh.shape[1] else 0) * acc + np.abs(dh[:, t])
        lam[:, t] = acc
    h_prev = np.concatenate([np.zeros_like(h[:, :1]) if h0 is None else np.abs(h0)[:, None],
                             h[:, :-1]], axis=1)
    return lam * a * np.abs(h_prev), lam, a[:, 0] * lam[:, 0]


@pytest.mark.parametrize("b,s,w,with_h0", [(2, 37, 13, False), (2, 37, 13, True),
                                           (1, 100, 40, True), (3, 64, 32, False)])
def test_rg_lru_gradient_matches_the_reference_scan(jx, b, s, w, with_h0):  # noqa: F811
    jax, jnp = jx["jax"], jx["jnp"]
    from repro.models import recurrent as jrec
    rng = np.random.default_rng(100 * s + w)
    log_a = (-8.0 * rng.random((b, s, w))).astype(np.float32)
    xb = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((b, s, w)).astype(np.float32)

    @jax.jit
    def ref(x, la, h, g):
        if h is None:
            out, vjp = jax.vjp(lambda x_, la_: jrec._rglru_scan(x_, la_, None), x, la)
            return (out, *vjp(g), None)
        out, vjp = jax.vjp(jrec._rglru_scan, x, la, h)
        return (out, *vjp(g))

    h_j, want_db, want_dla, want_dh0 = ref(jnp.asarray(xb), jnp.asarray(log_a),
                                           None if h0 is None else jnp.asarray(h0),
                                           jnp.asarray(dh))

    ins = [torch.from_numpy(x).requires_grad_(True) for x in (log_a, xb)]
    if with_h0:
        ins.append(torch.from_numpy(h0).requires_grad_(True))
    h = ops.rg_lru(*ins)
    assert h.grad_fn is not None and type(h.grad_fn).__name__ == "_RgLruBackward"
    got = torch.autograd.grad(h, ins, torch.from_numpy(dh))
    # the autograd Function's backward is the twin itself
    direct = rl.rg_lru_bwd(ins[0].detach(), h.detach(), None if h0 is None else ins[2].detach(),
                           torch.from_numpy(dh))
    for x, y in zip(got, direct):
        assert torch.equal(x, y)
    assert (direct[2] is None) == (h0 is None)

    s_la, s_db, s_h0 = _bound(log_a, xb, h0, dh)
    for name, g, want, scale in (("dlog_a", got[0], want_dla, s_la), ("db", got[1], want_db, s_db),
                                 ("dh0", got[2] if with_h0 else None, want_dh0, s_h0)):
        if want is None:
            continue
        err = np.abs(g.numpy() - np.asarray(want)) / np.maximum(scale, 1e-30)
        assert err.max() <= TOL, f"{name}: worst {err.max():.3e} of the summation bound"
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_j), rtol=1e-5, atol=1e-5)


def test_rg_lru_serving_call_saves_nothing():
    """Without grad (serving) ops.rg_lru is the forward alone: no graph."""
    la = -torch.rand(2, 8, 4)
    x = torch.randn(2, 8, 4, requires_grad=True)
    with torch.no_grad():
        assert ops.rg_lru(la, x).grad_fn is None
    assert ops.rg_lru(la, x.detach()).grad_fn is None


def test_rg_lru_bwd_wrapper_refuses_bad_arguments():
    la = torch.zeros((2, 8, 16))
    with pytest.raises(TypeError, match="float32"):
        rl.rg_lru_bwd(la.double(), la, None, la)
    with pytest.raises(ValueError, match="shape"):
        rl.rg_lru_bwd(la, la[:, :4], None, la)
    with pytest.raises(ValueError, match="shape"):
        rl.rg_lru_bwd(la, la, torch.zeros((2, 8)), la)
    with pytest.raises(ValueError, match="contiguous"):
        rl.rg_lru_bwd(la, la, None, la.transpose(1, 2).contiguous().transpose(1, 2))


def test_rg_lru_bwd_ring_fits_shared_memory():
    """The backward's ring (kStages tiles of kSteps x kChannels floats of
    log_a, h and g, one 8-byte mbarrier a stage) fits the 48 KiB a block
    gets as static shared memory; one warp a block."""
    import re
    from pathlib import Path
    src = (Path(rl.__file__).parent / "csrc" / "rg_lru_bwd.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    ring = const["kStages"] * (3 * const["kSteps"] * const["kChannels"] * 4 + 8)
    assert ring <= 48 * 1024 and const["kChannels"] == 32


def test_hybrid_train_step_f32_matches_the_reference(jx):  # noqa: F811
    check_f32_case(jx, step_case(jx, "float32", ARCH), ARCH)


def test_hybrid_training_forward_bf16_within_the_reference_bound(jx):  # noqa: F811
    bf16_logits_check(jx, ARCH)


def test_hybrid_launch_train_resumes(tmp_path):
    launch_resume_check(tmp_path, ARCH)
