"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: each test asks for the `cuda` fixture, which skips when no
card is present, so on a CPU-only machine these tests skip. Run them on the
card (the repo's conftest imports JAX, which that machine lacks) with

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Shapes cover ragged U/M/N, block_u != block_v, one AP, and CellLayout
schedules. The kernel and its twin sum the same float32 terms in another
order: each element's error is held to 1e-5 of the sum of the magnitudes
of its terms (the twin on absolute weights), never of the largest output,
under which a far user's rows would hide."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import GdConfig, channel, make_env, profiles  # noqa: E402
from repro_torch.kernels import build_cell_layout, ops  # noqa: E402
from repro_torch.kernels import noma_rates as nr  # noqa: E402
from repro_torch.planning import PlannerEngine  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _close(got, want, scale, tol=TOL):
    got, want = got.detach(), want.detach()
    assert got.device == want.device
    assert bool(((got - want).abs() <= tol * scale).all())


def _inputs(u, n, m, seed, dev):
    env = make_env(u, n, m, seed=seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    e = torch.empty((u, m), device=dev).exponential_(generator=g)
    beta = e / e.sum(1, keepdim=True)
    p = 1e-3 + 0.3 * torch.rand(u, device=dev, generator=g)
    cot = torch.randn((2, u, m), device=dev, generator=g)
    return env, beta, p, cot


@pytest.mark.parametrize("u,n,m,bu,bv", [(37, 5, 45, 8, 16), (64, 1, 32, 16, 16),
                                         (101, 7, 70, 3, 5), (300, 16, 250, 64, 32)])
@pytest.mark.parametrize("uplink", [True, False])
def test_kernels_match_plain_twins(cuda, u, n, m, bu, bv, uplink):
    env, beta, p, cot = _inputs(u, n, m, u, cuda)
    layout = build_cell_layout(env, block_u=bu, block_v=bv)
    for used, fwd, bwd in (
            (env, nr.dense_csr(-(-u // bu), -(-u // bv), cuda),
             nr.dense_csr(-(-u // bv), -(-u // bu), cuda)),
            (layout.env, (layout.fwd_row_ptr, layout.fwd_col),
             (layout.bwd_row_ptr, layout.bwd_col))):
        own, g_raw, ap = ops._inputs(used, uplink)
        w = (beta * p[:, None] * own).contiguous()
        for args in ((own, own, w, ap, ap, *fwd, bu, bv, uplink),
                     (own, own, cot[0], ap, ap, *bwd, bv, bu, not uplink)):
            before = nr.LAUNCHES["noma_cell_intra"]
            _close(nr.noma_cell_intra(*args), nr.noma_cell_intra_plain(*args),
                   nr.noma_cell_intra_plain(own, own, args[2].abs(), *args[3:]))
            assert nr.LAUNCHES["noma_cell_intra"] == before + 1
    own, g_raw, ap = ops._inputs(env, uplink)
    tab = torch.randn((n, m), device=cuda)
    _close(nr.noma_per_ap(ap, cot[1], g_raw, uplink),
           nr.noma_per_ap_plain(ap, cot[1], g_raw, uplink),
           nr.noma_per_ap_plain(ap, cot[1].abs(), g_raw, uplink))
    _close(nr.noma_ap_contract(ap, tab, g_raw, uplink),
           nr.noma_ap_contract_plain(ap, tab, g_raw, uplink),
           nr.noma_ap_contract_plain(ap, tab.abs(), g_raw, uplink))


@pytest.mark.parametrize("uplink", [True, False])
@pytest.mark.parametrize("with_layout", [False, True])
def test_rates_and_grads_on_the_card_match_the_cpu(cuda, uplink, with_layout):
    env, beta, p, cot = _inputs(90, 6, 40, 3, cuda)
    if not uplink:
        p = p * 30
    fn = channel.uplink_rates if uplink else channel.downlink_rates
    cpu = torch.device("cpu")
    res = {}
    for dev in (cuda, cpu):
        e = env.to(dev)
        lay = build_cell_layout(e) if with_layout else None
        b = beta.to(dev).requires_grad_(True)
        q = p.to(dev).requires_grad_(True)
        r = fn(e, b, q, backend="kernel", layout=lay)
        res[dev.type] = (r.detach(), *torch.autograd.grad((r * cot[0].to(dev)).sum(), [b, q]))
    rates, g_beta, g_p = res["cpu"]
    # rows of (U, M) tensors at their largest magnitude; the power gradient
    # at the magnitude of its terms through tx = beta * p
    scales = (rates.abs().amax(1, keepdim=True), g_beta.abs().amax(1, keepdim=True),
              g_p.abs() + (g_beta.abs() * beta.cpu()).sum(1) / p.cpu())
    for a, b, scale in zip(res["cuda"], res["cpu"], scales):
        _close(a.cpu(), b, scale, 1e-4)
    ref = fn(env, beta, p, backend="einsum")
    _close(res["cuda"][0], ref, ref.abs().amax(1, keepdim=True), 1e-4)


def test_wrappers_refuse_bad_cuda_arguments(cuda):
    own = torch.rand(6, 5, device=cuda)
    ap = torch.zeros(6, dtype=torch.int32, device=cuda)
    row_ptr, col = nr.dense_csr(2, 2, cuda)
    with pytest.raises(ValueError, match="expected cuda"):
        nr.noma_cell_intra(own, own.cpu(), own, ap, ap, row_ptr, col, 4, 4)
    with pytest.raises(TypeError, match="float32"):
        nr.noma_per_ap(ap, own.double(), torch.rand(6, 2, 5, device=cuda).double())


def test_engine_plan_on_the_card(cuda):
    env = make_env(48, 4, 16, seed=5, device=cuda)
    eng = PlannerEngine(profiles.nin(), cfg=GdConfig(optimizer="adam", max_iters=40),
                        sinr_backend="kernel")
    nr.reset_launches()
    state = eng.plan(env)
    assert all(v > 0 for v in nr.LAUNCHES.values())
    plan = state.plan
    assert plan.sub_up.device == cuda and bool(torch.isfinite(plan.utility))
    cpu = PlannerEngine(profiles.nin(), cfg=GdConfig(optimizer="adam", max_iters=40),
                        sinr_backend="kernel", device="cpu").plan(env.to("cpu"))
    np.testing.assert_allclose(float(plan.utility), float(cpu.plan.utility), rtol=1e-3)
