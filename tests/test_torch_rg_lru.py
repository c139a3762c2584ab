"""The port's RG-LRU recurrence on the CPU (its plain twin, the ops
wrapper, and its own log-depth oracle) against the JAX package: the Pallas
kernel in interpret mode, the oracle repro.kernels.ref.rg_lru_ref, and the
model's associative scan repro.models.recurrent._rglru_scan (which folds h0
into b[:, 0] and sums in another order).

Inputs are drawn with numpy from a seed and handed to both. Each element is
held to 1e-5 of its float32 summation bound: the twin run on (log_a, |b|,
|h0|), the sum of the magnitudes of the terms h_t adds up. The CUDA kernel
runs only on the card (test_torch_kernels_cuda.py and chip_smoke.py hold it
against this twin there)."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rg_lru as rl  # noqa: E402

TOL = 1e-5


def _check(got, want, scale, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / np.maximum(scale, 1e-30)
    assert err.max() <= TOL, f"{what}: worst {err.max():.3e} of the summation bound"


@pytest.mark.parametrize(
    "b,s,w,bs,bw,with_h0",
    [
        (1, 32, 64, 8, 32, False),
        (2, 40, 96, 16, 32, True),     # S not a multiple of the Pallas block
        (3, 128, 128, 64, 128, True),
        (2, 16, 200, 16, 128, False),  # W not a multiple of the Pallas block
    ],
)
def test_rg_lru_matches_pallas_oracle_and_scan(b, s, w, bs, bw, with_h0):
    rng = np.random.default_rng(s * 1000 + w)
    log_a = -np.abs(rng.standard_normal((b, s, w))).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    got_plain = rl.rg_lru_plain(t(log_a), t(x), t(h0)).numpy()
    got_ops = ops.rg_lru(t(log_a), t(x), t(h0)).numpy()
    got_ref = ref.rg_lru_ref(t(log_a), t(x), t(h0)).numpy()
    scale = rl.rg_lru_plain(t(log_a), t(np.abs(x)),
                            None if h0 is None else t(np.abs(h0))).numpy()
    want_pallas = jops.rg_lru(j(log_a), j(x), j(h0), interpret=True, block_s=bs, block_w=bw)
    want_ref = jref.rg_lru_ref(j(log_a), j(x), j(h0))
    want_scan = jrec._rglru_scan(j(x), j(log_a), j(h0))
    np.testing.assert_array_equal(got_ops, got_plain)
    _check(got_plain, want_pallas, scale, "plain twin vs Pallas interpret")
    _check(got_plain, want_ref, scale, "plain twin vs JAX oracle")
    _check(got_plain, want_scan, scale, "plain twin vs the model's associative scan")
    _check(got_ref, want_ref, scale, "port oracle vs JAX oracle")


def test_rg_lru_wrapper_refuses_bad_arguments():
    la = torch.zeros((2, 8, 16))
    with pytest.raises(TypeError, match="float32"):
        rl.rg_lru(la.double(), la.double())
    with pytest.raises(ValueError, match="shape"):
        rl.rg_lru(la, la[:, :4])
    with pytest.raises(ValueError, match="shape"):
        rl.rg_lru(la, la, torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        rl.rg_lru(la.transpose(1, 2).contiguous().transpose(1, 2), la)


def test_rg_lru_ring_fits_shared_memory():
    """The ring declared in csrc/rg_lru.cu (kStages tiles of kSteps x
    kChannels floats of log_a and of b, one 8-byte mbarrier a stage; the
    kernel's only stage and tile choice) fits the 48 KiB a block gets as
    static shared memory, under the H100's 227 KB (232,448 bytes) a block;
    at the served (4, 3072, 4096) its one-warp blocks number at least two
    for each of the 132 SMs."""
    src = (Path(rl.__file__).parent / "csrc" / "rg_lru.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    stages, steps, channels = const["kStages"], const["kSteps"], const["kChannels"]
    ring = stages * (2 * steps * channels * 4 + 8)
    assert ring <= 48 * 1024 <= 232448
    assert channels == 32  # one warp a block, one thread a channel
    assert -(-4096 // channels) * 4 >= 2 * 132


@pytest.mark.parametrize("w,ptrs,tma", [
    (4096, (0, 1 << 20), True),
    (20, (256, 512), True),     # under one channel tile: the box is zero-filled
    (30, (0, 0), False),        # W * 4 bytes is no multiple of 16
    (201, (0, 0), False),
    (64, (0, 4), False),        # b off a 16-byte boundary
])
def test_rg_lru_fills_the_ring_by_tma_only_where_a_tensor_map_is_legal(w, ptrs, tma):
    assert rl.uses_tma(w, *ptrs) is tma
