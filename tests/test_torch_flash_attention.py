"""The port's flash attention on the CPU (its plain twin, and the ops
wrapper in the models' layout) against the JAX package: the Pallas kernel
in interpret mode and the naive oracle repro.kernels.ref.flash_attention_ref.

Inputs are drawn with numpy from a seed and handed to both. Each output
element is held to its own scale, sum_k p_k |v_k| (the twin run on |v|, in
float32): within 1e-5 of it in float32, where only the order of the sums
and the online softmax's running max differ; within 1e-2 in bf16, where
the output rounds at 2^-8 of it and p is rounded to bf16 before the AV
product. The CUDA kernel runs only on the card (test_torch_kernels_cuda.py
and chip_smoke.py hold it against this twin there)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOLS = {"float32": 1e-5, "bfloat16": 1e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, sq, sk, h, kv, hd, dtype):
    """(B, S, heads, hd) numpy float32 arrays already rounded to dtype."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]
    return [torch.from_numpy(a).to(TDT[dtype]).float().numpy() for a in arrs]


def _heads_first(x, dtype):
    """(B, S, n, hd) numpy -> (B*n, S, hd) torch tensor of dtype."""
    b, s, n, hd = x.shape
    return torch.from_numpy(x.transpose(0, 2, 1, 3).reshape(b * n, s, hd).copy()).to(TDT[dtype])


def _check(got, want, scale, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / np.maximum(scale, 1e-30)
    assert err.max() <= tol, f"{what}: worst {err.max():.3e} of the element's scale > {tol}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,sq,sk,h,kv,hd,causal,window",
    [
        (1, 32, 32, 4, 4, 32, True, 0),        # G = 1
        (2, 40, 40, 4, 2, 32, True, 0),        # G = 2, S not a multiple of 16
        (2, 45, 45, 8, 2, 64, True, 0),        # G = 4, MQA-like group, ragged
        (1, 50, 70, 4, 1, 32, False, 0),       # bidirectional, Sq != Sk
        (1, 70, 70, 4, 2, 32, True, 24),       # local window
        (1, 9, 70, 4, 4, 32, True, 0),         # short q against long kv
    ],
)
def test_flash_attention_matches_pallas_and_oracle(dtype, b, sq, sk, h, kv, hd, causal, window):
    q, k, v = _inputs(sq * 31 + sk, b, sq, sk, h, kv, hd, dtype)
    j = lambda x: jnp.asarray(x, JDT[dtype])  # noqa: E731
    want_pallas = jops.flash_attention(j(q), j(k), j(v), causal=causal, window=window,
                                       block_q=16, block_k=16, interpret=True)
    got_ops = ops.flash_attention(*(torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v)),
                                  causal=causal, window=window)
    g = h // kv
    qf, kf, vf = _heads_first(q, dtype), _heads_first(k, dtype), _heads_first(v, dtype)
    got_plain = fa.flash_attention_plain(qf, kf, vf, g, causal, window)
    want_ref = jref.flash_attention_ref(j(qf.float().numpy()), j(kf.float().numpy()),
                                        j(vf.float().numpy()), group=g, causal=causal,
                                        window=window)
    scale = fa.flash_attention_plain(qf.float(), kf.float(), vf.float().abs(), g, causal,
                                     window).numpy()
    tol = TOLS[dtype]

    def bhsd(x):
        return np.asarray(x, np.float32).transpose(0, 2, 1, 3).reshape(scale.shape)
    _check(bhsd(got_ops.float()), bhsd(want_pallas), scale, tol, "ops vs Pallas interpret")
    _check(got_plain.float(), want_ref, scale, tol, "plain twin vs oracle")
    _check(got_plain.float(), bhsd(want_pallas), scale, tol, "plain twin vs Pallas")
    assert got_ops.dtype == TDT[dtype] and got_plain.dtype == TDT[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kv_len_mask(dtype, causal):
    """Keys at and past kv_len are masked (the Pallas kernel's padded keys):
    the kernel entry points called directly, at block multiples."""
    q, k, v = _inputs(7, 1, 48, 64, 4, 2, 32, dtype)
    qf, kf, vf = (_heads_first(x, dtype) for x in (q, k, v))
    j = lambda x: jnp.asarray(x.float().numpy(), JDT[dtype])  # noqa: E731
    kv_len = 37
    want_pallas = jfa.flash_attention_kernel(j(qf), j(kf), j(vf), group=2, causal=causal,
                                             block_q=16, block_k=16, kv_len=kv_len,
                                             interpret=True)
    want_ref = jref.flash_attention_ref(j(qf), j(kf), j(vf), group=2, causal=causal,
                                        kv_len=kv_len)
    got = fa.flash_attention(qf, kf, vf, group=2, causal=causal, kv_len=kv_len)
    scale = fa.flash_attention_plain(qf.float(), kf.float(), vf.float().abs(), 2, causal,
                                     kv_len=kv_len).numpy()
    _check(got.float(), want_pallas, scale, TOLS[dtype], "wrapper vs Pallas interpret")
    _check(got.float(), want_ref, scale, TOLS[dtype], "wrapper vs oracle")
    _check(ref.flash_attention_ref(qf, kf, vf, 2, causal, kv_len=kv_len).float(), want_ref,
           scale, TOLS[dtype], "port oracle vs JAX oracle")


def test_flash_attention_wrapper_refuses_bad_arguments():
    q = torch.zeros((4, 8, 32))
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(q, q[:1], q[:1], group=3)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(torch.zeros((4, 8, 48)), torch.zeros((1, 8, 48)),
                           torch.zeros((1, 8, 48)), group=4)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q[:1].half(), q[:1].half(), group=4)
    with pytest.raises(ValueError, match="kv_len"):
        fa.flash_attention(q, q[:1], q[:1], group=4, kv_len=9)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(q, q[:2], q[:2], group=4)


def test_flash_attention_smem_budget():
    """The block table's shared memory fits what a Hopper block may opt in
    to (227 KB) at every head_dim and dtype the kernel takes."""
    for hd in fa.HEAD_DIMS:
        for dt in fa.DTYPES:
            assert fa.smem_bytes(hd, dt) <= 232448, (hd, dt)
    # bf16: 1 KB alignment slack, Q (128 x 256), 2 stages of K and V
    # (64 x 256 each), three mbarriers
    assert fa.smem_bytes(256, torch.bfloat16) == 1024 + 2 * 256 * (128 + 4 * 64) + 24 == 197656
    # head dims under 64 are staged 64 wide (one 128-byte swizzled row)
    assert fa.smem_bytes(32, torch.bfloat16) == fa.smem_bytes(64, torch.bfloat16)
    assert fa.smem_bytes(256, torch.float32) == 214528


def test_flash_attention_bwd_smem_budget():
    """The backward's two kernels (dK/dV, dQ) fit what a Hopper block may
    opt in to at every head_dim and dtype; bwd_smem_bytes mirrors the
    source's layouts (chip_smoke.py holds it to the kernels' own numbers)."""
    for hd in fa.HEAD_DIMS:
        for dt in fa.DTYPES:
            dkdv, dq = fa.bwd_smem_bytes(hd, dt)
            assert 0 < dq <= dkdv <= 232448, (hd, dt)
    # wgmma path at hd 64: 1 KB slack, K and V (128 x 64 each), 3 stages of
    # Q and dO (64 x 64 each), in dK/dV each stage's 64 LSE and 64 D
    # values, seven mbarriers
    assert fa.bwd_smem_bytes(64, torch.bfloat16) == (
        1024 + 2 * 2 * 128 * 64 + 3 * 2 * 2 * 64 * 64 + 3 * 512 + 56, 83000) == (84536, 83000)
    assert fa.bwd_smem_bytes(128, torch.bfloat16) == (166456, 164920)
    # head dims under 64 are staged 64 wide; hd 256 keeps the mma.sync kernels
    assert fa.bwd_smem_bytes(32, torch.bfloat16) == fa.bwd_smem_bytes(64, torch.bfloat16)
    assert fa.bwd_smem_bytes(256, torch.bfloat16) == (135680, 135680)
