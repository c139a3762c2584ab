"""The gradient of the port's flash attention on the CPU (the backward
kernel's plain twin flash_attention_bwd_plain, and the autograd op
ops.flash_attention that a training step runs) against jax.grad of the JAX
package's attention core, _chunked_mha, and of a whole attention layer
through attn_apply, on the same inputs, in float32 (COMPUTE_DTYPE set to
float32 in both packages, as tests/test_torch_models.py does).

Inputs are drawn with numpy from a seed. Each gradient element is held to
its own scale, the sum of the magnitudes of its terms
(flash_attention.flash_attention_bwd_scale), within 1e-5: the same float32
math, summed in other orders (the JAX core sums over key chunks with an
online softmax; the twin in one pass from the forward's log-sum-exp). A
layer's gradients (x and every parameter) are held within 1e-5 of each
leaf's largest magnitude. The CUDA kernel runs only on the card
(test_torch_kernels_cuda.py and chip_smoke.py phase 15 hold it to this
twin)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as t_attention  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402

TOL = 1e-5


@pytest.fixture
def jx(monkeypatch):
    """The JAX attention module with COMPUTE_DTYPE float32 in both packages."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    import repro.models.attention as jattn
    import repro.models.layers as jlayers
    from repro import configs as jconfigs
    monkeypatch.setattr(jattn, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(jlayers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_attention, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)
    return dict(jax=jax, jnp=jnp, attn=jattn, configs=jconfigs)


def _heads_first(x):
    """(B, S, n, hd) -> (B*n, S, hd) contiguous."""
    b, s, n, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * n, s, hd).contiguous()


@pytest.mark.parametrize(
    "b,sq,sk,kv,g,hd,causal,window,kv_len",
    [
        (2, 40, 40, 2, 1, 32, True, 0, None),      # causal, G = 1
        (1, 45, 45, 2, 4, 64, True, 0, None),      # GQA G = 4, ragged
        (1, 70, 70, 1, 2, 32, True, 24, None),     # local window
        (2, 50, 70, 2, 2, 32, False, 0, None),     # bidirectional, Sq != Sk
        (1, 30, 60, 1, 4, 32, True, 0, None),      # causal, Sq < Sk
        (1, 40, 64, 2, 2, 32, False, 0, 50),       # kv_len < Sk
        (1, 40, 40, 1, 4, 128, True, 0, None),     # hd 128, G = 4 (the dense archs)
    ],
)
def test_flash_backward_matches_jax_grad_of_the_core(jx, b, sq, sk, kv, g, hd, causal, window,
                                                      kv_len):
    jax, jnp = jx["jax"], jx["jnp"]
    rng = np.random.default_rng(sq * 7 + sk)
    h = kv * g
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    dout = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    q_pos = jnp.broadcast_to(jnp.arange(sq, dtype=jnp.int32)[None], (b, sq))
    k_pos = jnp.broadcast_to(jnp.arange(sk, dtype=jnp.int32)[None], (b, sk))
    valid = None if kv_len is None else jnp.full((b,), kv_len, jnp.int32)

    def core(q_, k_, v_):
        return jx["attn"]._chunked_mha(q_.reshape(b, sq, kv, g, hd), k_, v_, q_pos, k_pos, valid,
                                       causal=causal, window=window, chunk=16)

    out_j, vjp = jax.vjp(core, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(dout).reshape(b, sq, kv, g, hd))]

    # the twin in the kernel's layout, from the forward twin's out and lse
    qf, kf, vf, dof = (_heads_first(torch.from_numpy(x)) for x in (q, k, v, dout))
    out, lse = fa.flash_attention_plain(qf, kf, vf, g, causal, window, kv_len, return_lse=True)
    np.testing.assert_allclose(
        out.view(b, h, sq, hd).permute(0, 2, 1, 3).numpy(),
        np.asarray(out_j).reshape(b, sq, h, hd), atol=1e-5, rtol=1e-5)
    got = fa.flash_attention_bwd(qf, kf, vf, out, lse, dof, g, causal, window, kv_len)
    scales = fa.flash_attention_bwd_scale(qf, kf, vf, out, lse, dof, g, causal, window, kv_len)
    for name, x, s_, w in zip(("dq", "dk", "dv"), got, scales, want):
        n = w.shape[2]
        w_f = _heads_first(torch.from_numpy(np.array(w.reshape(b, -1, n, hd))))
        err = ((x - w_f).abs() / s_.clamp_min(1e-30)).max()
        assert float(err) <= TOL, f"{name}: {float(err):.3e} of its terms' magnitude"

    if kv_len is None:   # the autograd op in the models' layout
        qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
        o = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
        o.backward(torch.from_numpy(dout))
        for name, x, s_, w in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), scales,
                                  want):
            err = ((_heads_first(x) - _heads_first(torch.from_numpy(
                np.array(w.reshape(x.shape))))).abs() / s_.clamp_min(1e-30)).max()
            assert float(err) <= TOL, f"autograd {name}: {float(err):.3e}"


def test_attention_layer_gradients_match_jax_grad(jx):
    """A whole attention layer of the reduced qwen1.5-0.5b (QKV bias, RoPE,
    G = 1, causal) and of a GQA variant, through attn_apply in both
    packages: the gradient of sum(out * cot) in x and in every parameter."""
    jax, jnp = jx["jax"], jx["jnp"]
    import dataclasses
    for n_kv in (4, 2):
        jcfg = dataclasses.replace(jx["configs"].get("qwen1.5-0.5b").reduced(), n_kv_heads=n_kv)
        cfg = dataclasses.replace(configs.get("qwen1.5-0.5b").reduced(), n_kv_heads=n_kv)
        rng = np.random.default_rng(n_kv)
        defs = jx["attn"].attn_defs(jcfg)
        params = {k: (0.05 * rng.standard_normal(d.shape)).astype(np.float32)
                  for k, d in defs.items()}
        x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
        cot = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(40, dtype=np.int32)[None], (2, 40))

        def jloss(p, x_):
            out, _ = jx["attn"].attn_apply(p, x_, jcfg, jnp.asarray(pos))
            return jnp.sum(out * cot)

        jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params),
                                                     jnp.asarray(x))
        tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        out, _ = t_attention.attn_apply(tp, tx, cfg, torch.from_numpy(pos.copy()))
        (out * torch.from_numpy(cot)).sum().backward()
        pairs = [("x", tx.grad, jg_x)] + [(k, tp[k].grad, jg_p[k]) for k in params]
        for name, got, want in pairs:
            want = np.asarray(want)
            err = float(np.abs(got.numpy() - want).max()) / float(np.abs(want).max())
            assert err <= TOL, f"KV={n_kv} d/d{name}: {err:.3e} of the leaf's largest value"
