"""The port's NOMA kernel path on the CPU (its plain twins) against the JAX
package: the ops run in Pallas interpret mode, the oracles in
repro.kernels.ref, and the host-side CellLayout tile lists.

Forward values and gradients agree to 1e-5 (float32, sums in another
order), each element held to its own scale: the sum of the magnitudes of
the terms it sums (the float32 summation bound), never the largest output,
under which a far user's rows would hide. The kernels themselves run only on the card: tests marked `cuda`
(test_torch_kernels_cuda.py) and chip_smoke.py hold them against these
plain twins there."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import make_env as jmake_env  # noqa: E402
from repro.kernels import build_cell_layout as jbuild_layout  # noqa: E402
from repro.kernels import noma_rates as jnr  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.cells import cell_tiles as jcell_tiles  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import build_cell_layout, ops  # noqa: E402
from repro_torch.kernels import noma_rates as nr  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.cells import cell_tiles, tile_csr  # noqa: E402

TOL = 1e-5


def _close(got, want, scale=None, tol=TOL):
    """|got - want| <= tol * scale element by element. scale defaults to
    |want|, which is the summation bound wherever every term is >= 0."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want) if scale is None else np.asarray(scale)
    assert got.shape == want.shape
    bad = np.abs(got - want) > tol * scale
    assert not bad.any(), (f"{bad.sum()} elements off; worst "
                           f"{np.max(np.abs(got - want) / np.maximum(scale, 1e-38)):.3e}")


def _row_scale(want):
    """The largest magnitude in each user's row (a (U, M) gradient)."""
    return np.max(np.abs(np.asarray(want)), axis=-1, keepdims=True)


def _power_scale(g_p, g_beta, beta, p):
    """Scale of a per-user power gradient whose power also enters through
    tx = beta * p: |g_p| + sum_m |g_beta| * beta / p (its terms have both
    signs, so |g_p| alone can sit below the rounding of its sum)."""
    g_p, g_beta = np.asarray(g_p), np.asarray(g_beta)
    return np.abs(g_p) + np.sum(np.abs(g_beta) * beta, axis=-1) / p


def _skewed_ap(u, n, skew):
    """natural (nearest AP), one giant cell with empty cells, one cell."""
    if skew == "giant":
        ap = np.zeros(u, np.int32)
        ap[:: max(u // 3, 1)] = n - 1
        return ap
    if skew == "one_cell":
        return np.full(u, n // 2, np.int32)
    return None


def _case(u, n, m, seed, skew="natural"):
    jenv = jmake_env(jax.random.PRNGKey(seed), n_users=u, n_aps=n, n_sub=m)
    ap = _skewed_ap(u, n, skew)
    if ap is not None:
        jenv = dataclasses.replace(jenv, ap=jnp.asarray(ap))
    tenv = convert.env_from_numpy(np.asarray(jenv.g_up), np.asarray(jenv.g_dn),
                                  np.asarray(jenv.ap), jenv.radio, jenv.comp,
                                  device="cpu")
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.ones(m), size=u).astype(np.float32)
    p = rng.uniform(1e-3, 0.3, size=u).astype(np.float32)
    cot = rng.standard_normal((2, u, m)).astype(np.float32)
    return jenv, tenv, beta, p, cot


# (u, n, m, skew, layout, block_u, block_v): U/M/N not divisible by the
# blocks, block_u != block_v, N = 1, and layouts over skewed, giant (with
# empty cells) and single cells.
CASES = [
    (20, 3, 6, "natural", False, 4, 8),
    (9, 1, 12, "natural", False, 4, 4),
    (13, 5, 7, "natural", True, 4, 4),
    (20, 3, 6, "giant", True, 4, 8),
    (12, 4, 5, "one_cell", True, 8, 4),
]


@pytest.mark.parametrize("link", ["up", "dn"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}-{c[3]}"
                         f"-{'layout' if c[4] else 'dense'}-{c[5]}x{c[6]}")
def test_pairwise_ops_and_grads_match_interpret_pallas(case, link):
    """noma_pairwise_up/dn forward and the gradient of a weighted sum of
    both outputs w.r.t. tx, against the JAX ops run with interpret=True."""
    u, n, m, skew, with_layout, bu, bv = case
    jenv, tenv, beta, p, cot = _case(u, n, m, seed=u + n, skew=skew)
    tx = beta * p[:, None]
    jl = jbuild_layout(jenv, block_u=bu, block_v=bv) if with_layout else None
    tl = build_cell_layout(tenv, block_u=bu, block_v=bv) if with_layout else None
    jfn = jops.noma_pairwise_up if link == "up" else jops.noma_pairwise_dn
    tfn = ops.noma_pairwise_up if link == "up" else ops.noma_pairwise_dn

    def jloss(x):
        i, o = jfn(jenv, x, interpret=True, block_u=bu, block_v=bv, block_m=8,
                   block_n=2, layout=jl)
        return jnp.sum(i * cot[0]) + jnp.sum(o * cot[1]), (i, o)

    (_, (ji, jo)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(tx))
    xt = torch.tensor(tx, requires_grad=True)
    ti, to = tfn(tenv, xt, block_u=bu, block_v=bv, layout=tl)
    (tg,) = torch.autograd.grad((ti * torch.tensor(cot[0])).sum()
                                + (to * torch.tensor(cot[1])).sum(), [xt],
                                retain_graph=True)
    # Both outputs are linear in tx with coefficients >= 0, so the gradient
    # for |cot| sums the magnitudes of the gradient's terms.
    (tg_abs,) = torch.autograd.grad((ti * torch.tensor(np.abs(cot[0]))).sum()
                                    + (to * torch.tensor(np.abs(cot[1]))).sum(), [xt])
    _close(ti.detach(), ji)
    _close(to.detach(), jo)
    _close(tg, jg, tg_abs)
    if n == 1:
        assert not to.detach().any()   # one AP: no other cell, inter exactly 0


@pytest.mark.parametrize("link", ["up", "dn"])
@pytest.mark.parametrize("with_layout", [False, True])
def test_rate_wrappers_and_grads_match_interpret_pallas(link, with_layout):
    jenv, tenv, beta, p, cot = _case(14, 3, 6, seed=3, skew="natural")
    if link == "dn":
        p = p * 30.0
    jl = jbuild_layout(jenv, block_u=4, block_v=4) if with_layout else None
    tl = build_cell_layout(tenv, block_u=4, block_v=4) if with_layout else None
    jfn = jops.noma_uplink_rates if link == "up" else jops.noma_downlink_rates
    tfn = ops.noma_uplink_rates if link == "up" else ops.noma_downlink_rates

    def jloss(b, q):
        r = jfn(jenv, b, q, interpret=True, block_u=4, block_v=4, block_m=8,
                block_n=2, layout=jl)
        return jnp.sum(r * cot[0]), r

    (_, jr), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(beta), jnp.asarray(p))
    bt = torch.tensor(beta, requires_grad=True)
    pt = torch.tensor(p, requires_grad=True)
    tr = tfn(tenv, bt, pt, layout=tl)
    tg = torch.autograd.grad((tr * torch.tensor(cot[0])).sum(), [bt, pt])
    _close(tr.detach(), jr)
    _close(tg[0], jg[0], _row_scale(jg[0]))
    _close(tg[1], jg[1], _power_scale(jg[1], jg[0], beta, p))


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("uplink", [True, False])
def test_pairwise_kernel_composition_both_sic_orders(descending, uplink):
    """noma_pairwise_kernel / noma_pairwise_bwd_kernel for the full
    (SIC order x link) matrix, against the JAX compositions in interpret
    mode, with block_u != block_v and ragged U, M."""
    u, n, m = 15, 4, 7
    jenv, tenv, beta, p, cot = _case(u, n, m, seed=11)
    own = np.asarray(jenv.own_gain_up() if uplink else jenv.own_gain_dn(), np.float32)
    g_raw = np.asarray(jenv.g_up if uplink else jenv.g_dn, np.float32)
    ap = np.asarray(jenv.ap)
    tx = (beta * p[:, None]).astype(np.float32)
    w_intra = tx * own
    j_fwd = jnr.noma_pairwise_kernel(
        own, own, w_intra, tx, g_raw, ap, ap, descending=descending, uplink=uplink,
        block_u=4, block_v=8, block_m=8, block_n=2, interpret=True)
    j_bwd = jnr.noma_pairwise_bwd_kernel(
        own, own, g_raw, ap, ap, cot[0], cot[1], descending=descending,
        uplink=uplink, block_u=4, block_v=8, block_m=8, block_n=2, interpret=True)
    t = {k: torch.tensor(v) for k, v in dict(own=own, g=g_raw, ap=ap, tx=tx,
                                             wi=w_intra, c0=cot[0], c1=cot[1]).items()}
    t_fwd = nr.noma_pairwise_kernel(t["own"], t["own"], t["wi"], t["tx"], t["g"],
                                    t["ap"], t["ap"], descending=descending,
                                    uplink=uplink, block_u=4, block_v=8)
    t_bwd = nr.noma_pairwise_bwd_kernel(t["own"], t["own"], t["g"], t["ap"], t["ap"],
                                        t["c0"], t["c1"], descending=descending,
                                        uplink=uplink, block_u=4, block_v=8)
    t_abs = nr.noma_pairwise_bwd_kernel(t["own"], t["own"], t["g"], t["ap"], t["ap"],
                                        t["c0"].abs(), t["c1"].abs(), descending=descending,
                                        uplink=uplink, block_u=4, block_v=8)
    for a, b in zip(t_fwd, j_fwd):
        _close(a, b)
    for a, b, scale in zip(t_bwd, j_bwd, t_abs):
        _close(a, b, scale)


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("uplink", [True, False])
def test_plain_twins_match_reference_oracles(descending, uplink):
    """The port's plain twins and its own ref oracles against
    repro.kernels.ref: gather-free, pairwise (gathered) and cell-block."""
    u, n, m = 17, 4, 5
    jenv, tenv, beta, p, _ = _case(u, n, m, seed=5)
    own = np.asarray(jenv.own_gain_up() if uplink else jenv.own_gain_dn(), np.float32)
    g_raw = np.asarray(jenv.g_up if uplink else jenv.g_dn, np.float32)
    ap = np.asarray(jenv.ap)
    tx = (beta * p[:, None]).astype(np.float32)
    want = jref.noma_pairwise_gather_free_ref(own, own, tx * own, tx, g_raw, ap,
                                              descending=descending, uplink=uplink)
    T = torch.tensor
    got = ref.noma_pairwise_gather_free_ref(T(own), T(own), T(tx * own), T(tx),
                                            T(g_raw), T(ap), descending, uplink)
    twin = nr.noma_pairwise_kernel(T(own), T(own), T(tx * own), T(tx), T(g_raw),
                                   T(ap), T(ap), descending=descending, uplink=uplink,
                                   block_u=4, block_v=4)
    for a, b, c in zip(got, twin, want):
        _close(a, b)
        _close(b, c)
    # the gathered oracle: g_vu[v, u] = gain of v at u's AP
    g_vu = (g_raw[:, ap, :] if uplink else np.transpose(g_raw[ap, :, :], (1, 0, 2)))
    same = ap[:, None] == ap[None, :]
    want2 = jref.noma_pairwise_ref(own, own, tx * own, tx, g_vu, same, descending)
    if uplink:  # the gathered form is the uplink's; downlink inter differs in kind
        got2 = ref.noma_pairwise_ref(T(own), T(own), T(tx * own), T(tx), T(g_vu),
                                     T(same), descending)
        for a, b in zip(got2, want2):
            _close(a, b)
    # cell-block oracle over a layout's tiles, in the sorted domain
    tl = build_cell_layout(tenv, block_u=4, block_v=4)
    perm = tl.perm.numpy()
    s_own = own[perm]
    s_g = np.ascontiguousarray(g_raw[perm] if uplink else g_raw[:, perm])
    s_tx = tx[perm]
    s_ap = ap[perm]
    want3 = jref.noma_cell_block_ref(s_own, s_own, s_tx * s_own, s_tx, s_g, s_ap,
                                     tl.tile_u.numpy(), tl.tile_v.numpy(), 4, 4,
                                     descending, uplink)
    got3 = ref.noma_cell_block_ref(T(s_own), T(s_own), T(s_tx * s_own), T(s_tx), T(s_g),
                                   T(s_ap), tl.tile_u, tl.tile_v, 4, 4, descending, uplink)
    twin3 = nr.noma_pairwise_kernel(T(s_own), T(s_own), T(s_tx * s_own), T(s_tx), T(s_g),
                                    T(s_ap), T(s_ap), descending=descending,
                                    uplink=uplink, block_u=4, block_v=4,
                                    csr=(tl.fwd_row_ptr, tl.fwd_col))
    for a, b, c in zip(got3, twin3, want3):
        _close(a, c)
        _close(b, c)


@pytest.mark.parametrize("ap,bu,bv", [
    ([0, 0, 0, 0, 1, 1, 1, 1], 4, 4),
    ([0] * 16, 4, 4),
    ([0, 0, 0, 1, 1, 1], 4, 4),
    ([0] * 7 + [1] * 3 + [2] * 8 + [3] * 1, 4, 4),
    ([0] * 5 + [2] * 9 + [3] * 4, 4, 8),
    ([1] * 3 + [4] * 10 + [5] * 2, 16, 16),
])
def test_cell_tiles_equal_reference_and_csr(ap, bu, bv):
    """The tile lists equal the reference's exactly (empty cells included);
    the CSR forms list the same tiles per receiver block."""
    ap = np.asarray(ap, np.int32)
    u = len(ap)
    bu, bv = min(bu, u), min(bv, u)
    mine, theirs = cell_tiles(ap, bu, bv), jcell_tiles(ap, bu, bv)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    tu, tv, tbv, tbu = mine
    for tile_r, tile_s, n_blocks in ((tu, tv, -(-u // bu)), (tbv, tbu, -(-u // bv))):
        row_ptr, col = tile_csr(tile_r, tile_s, n_blocks)
        assert row_ptr[0] == 0 and row_ptr[-1] == len(tile_r)
        rebuilt = [(b, int(c)) for b in range(n_blocks)
                   for c in col[row_ptr[b]:row_ptr[b + 1]]]
        assert rebuilt == list(zip(tile_r.tolist(), tile_s.tolist()))


def test_layout_matches_reference_layout():
    """build_cell_layout: same permutation, sorted env and tiles as the
    reference's; the dense schedule is its CSR form."""
    jenv, tenv, *_ = _case(19, 4, 5, seed=9)
    jl, tl = jbuild_layout(jenv, block_u=4, block_v=8), build_cell_layout(tenv, 4, 8)
    for field in ("perm", "inv", "tile_u", "tile_v", "bwd_tile_v", "bwd_tile_u"):
        np.testing.assert_array_equal(getattr(tl, field).numpy(),
                                      np.asarray(getattr(jl, field)))
    for field in ("g_up", "g_dn", "ap"):
        np.testing.assert_array_equal(getattr(tl.env, field).numpy(),
                                      np.asarray(getattr(jl.env, field)))
    assert (tl.n_tiles, tl.block_u, tl.block_v) == (jl.n_tiles, jl.block_u, jl.block_v)
    assert tl.dense_n_tiles() == jl.dense_n_tiles() == jnr.dense_tile_count(19, 19, 4, 8)
    row_ptr, col = nr.dense_csr(3, 4, torch.device("cpu"))
    assert row_ptr.tolist() == [0, 4, 8, 12] and col.tolist() == [0, 1, 2, 3] * 3


def test_layout_for_wrong_user_count_is_refused():
    _, tenv, beta, p, _ = _case(12, 3, 4, seed=1)
    _, tenv2, *_ = _case(10, 3, 4, seed=1)
    layout = build_cell_layout(tenv, block_u=4, block_v=4)
    with pytest.raises(ValueError, match="built for U="):
        ops.noma_pairwise_up(tenv2, torch.tensor(beta[:10] * p[:10, None]), layout=layout)


def test_wrappers_check_their_arguments():
    own = torch.rand(6, 5)
    ap = torch.zeros(6, dtype=torch.int32)
    row_ptr, col = nr.dense_csr(2, 2, torch.device("cpu"))
    with pytest.raises(TypeError, match="ap_r must be torch.int32"):
        nr.noma_cell_intra(own, own, own, ap.long(), ap, row_ptr, col, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        nr.noma_cell_intra(own, own, torch.rand(5, 6).T, ap, ap, row_ptr, col, 4, 4)
    with pytest.raises(ValueError, match="row_ptr must have shape"):
        nr.noma_cell_intra(own, own, own, ap, ap, row_ptr, col, 2, 4)
    with pytest.raises(ValueError, match="block_r"):
        nr.noma_cell_intra(own, own, own, ap, ap, *nr.dense_csr(1, 2, own.device), 65, 4)
    with pytest.raises(ValueError, match="shared memory"):
        nr.noma_cell_intra(own, own, own, ap, ap, row_ptr, col, 4, 1000)
    with pytest.raises(ValueError, match="g_raw must have shape"):
        nr.noma_per_ap(ap, own, torch.rand(5, 2, 5), uplink=True)
    with pytest.raises(ValueError, match="nm_table must have shape"):
        nr.noma_ap_contract(ap, torch.rand(3, 5), torch.rand(2, 6, 5), uplink=False)
    # the block table stays inside the card's limits
    assert nr.intra_smem_bytes(nr.BLOCK_V) <= nr.SMEM_LIMIT_BYTES
    assert nr.BLOCK_U <= nr.MAX_BLOCK_ROWS


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("u,n,m,skew", [(20, 3, 6, "natural"), (20, 3, 6, "giant"),
                                        (12, 4, 5, "one_cell"), (9, 1, 12, "natural"),
                                        (40, 6, 35, "giant")])
def test_dense_intra_twin_matches_interpret_pallas(u, n, m, skew, descending):
    """noma_cell_intra_dense (its plain twin on the CPU) against the JAX
    package's noma_cell_intra_kernel on its dense grid in interpret mode,
    in the forward role (w = tx * own) and the backward role (cotangent,
    comparison flipped), on natural, giant (with empty) and single cells."""
    jenv, tenv, beta, p, cot = _case(u, n, m, seed=u + 7, skew=skew)
    own = np.asarray(jenv.own_gain_up(), np.float32)
    ap = np.asarray(jenv.ap, np.int32)
    tx = (beta * p[:, None]).astype(np.float32)
    for w, desc in ((tx * own, descending), (cot[0], not descending)):
        want = jnr.noma_cell_intra_kernel(own, own, w, ap, ap, descending=desc, block_r=4,
                                          block_s=8, block_m=8, interpret=True)
        T = torch.tensor
        got = nr.noma_cell_intra_dense(T(own), T(own), T(w), T(ap), T(ap), n, desc)
        scale = nr.noma_cell_intra_dense_plain(T(own), T(own), T(np.abs(w)), T(ap), T(ap),
                                               n, desc)
        _close(got, want, scale)


def test_dense_intra_wrapper_checks_its_arguments():
    own = torch.rand(6, 5)
    ap = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_aps"):
        nr.noma_cell_intra_dense(own, own, own, ap, ap, 0)
    with pytest.raises(TypeError, match="ap_s must be torch.int32"):
        nr.noma_cell_intra_dense(own, own, own, ap, ap.long(), 1)
    with pytest.raises(ValueError, match="w_s must have shape"):
        nr.noma_cell_intra_dense(own, own, own[:5], ap, ap, 1)
    with pytest.raises(ValueError, match="contiguous"):
        nr.noma_cell_intra_dense(torch.rand(5, 6).T, own, own, ap, ap, 1)
    # no receivers or no senders: an empty result / zeros
    assert nr.noma_cell_intra_dense(own[:0], own, own, ap[:0], ap, 1).shape == (0, 5)
    assert not nr.noma_cell_intra_dense(own, own[:0], own[:0], ap, ap[:0], 1).any()


def test_dense_intra_block_table_and_grid():
    """The dense kernel's static shared memory stays under the 48 KiB a
    block gets without opting in; its grid, (m blocks, n_aps x slots),
    gives every cell enough chunk slots for a cell DENSE_SKEW times the
    mean, never more than the users could fill, and at least one."""
    assert nr.DENSE_CHUNK == nr.WARPS * nr.DENSE_ROWS == 32
    assert nr.DENSE_WINDOW == nr.WARPS * 8 * nr.LANES == 2048
    assert nr.intra_dense_smem_bytes() == 24736 <= nr.SMEM_LIMIT_BYTES
    # the planner's shape: 3 x 1250 / (16 x 32) -> 8 slots a cell (a grid
    # of 8 m blocks x 128)
    assert nr.dense_chunks_per_cell(1250, 16) == 8
    # never more slots than a cell holding every user could fill
    assert nr.dense_chunks_per_cell(40, 1) == 2
    assert nr.dense_chunks_per_cell(5, 16) == 1 and nr.dense_chunks_per_cell(0, 4) == 1
    for u, n in ((1250, 16), (300, 16), (37, 1), (20000, 64)):
        slots = nr.dense_chunks_per_cell(u, n)
        assert slots * nr.DENSE_CHUNK >= min(u, nr.DENSE_SKEW * u / n)


def test_dense_schedule_routes_through_the_dense_kernel(monkeypatch):
    """Without a CellLayout the composition calls the dense per-cell intra
    entry point (with N taken from the gain's shape), with one it calls the
    CSR tile-list kernel."""
    calls = []
    real_dense, real_csr = nr.noma_cell_intra_dense, nr.noma_cell_intra
    monkeypatch.setattr(nr, "noma_cell_intra_dense",
                        lambda *a: calls.append(("dense", a[5])) or real_dense(*a))
    monkeypatch.setattr(nr, "noma_cell_intra",
                        lambda *a: calls.append(("csr", None)) or real_csr(*a))
    _, tenv, beta, p, _ = _case(13, 5, 7, seed=2)
    tx = torch.tensor(beta * p[:, None], requires_grad=True)
    for link, n_aps in (("up", 5), ("dn", 5)):
        fn = ops.noma_pairwise_up if link == "up" else ops.noma_pairwise_dn
        intra, _ = fn(tenv, tx)
        intra.sum().backward()
        assert calls == [("dense", n_aps), ("dense", n_aps)]
        calls.clear()
        intra, _ = fn(tenv, tx, block_u=4, block_v=4,
                      layout=build_cell_layout(tenv, block_u=4, block_v=4))
        intra.sum().backward()
        assert calls == [("csr", None), ("csr", None)]
        calls.clear()


def _per_ap_blocks(w, n, m):
    """Thread blocks of one per_ap launch."""
    return nr.per_ap_geometry(w)[0] * -(-n // nr.PER_AP_GROUP) * -(-m // nr.LANES)


@pytest.mark.parametrize("w", [1, 12, 63, 64, 65, 200, 511, 513, 1003, 1250, 4099, 20000,
                               99991])
def test_per_ap_w_split_covers_every_w_once(w):
    """The blocks of a per_ap cluster, rank r taking the w range
    [r * w_chunk, min(W, (r + 1) * w_chunk)), cover [0, W) exactly once in
    rank order with no empty range; the cluster stays within the portable
    size and the C entry point's checks."""
    split, chunk = nr.per_ap_geometry(w)
    ranges = [(r * chunk, min(w, (r + 1) * chunk)) for r in range(split)]
    assert 1 <= split <= nr.PER_AP_MAX_SPLIT and split * chunk >= w
    assert all(lo < hi for lo, hi in ranges)
    assert [i for lo, hi in ranges for i in range(lo, hi)] == list(range(w))


def test_per_ap_grid_fills_the_card_at_the_planner_shape():
    """At U=1250, N=16, M=250 the split gives at least two blocks for each
    of the H100's 132 SMs; the serve planner's tiny env (12 users, 3 APs, 4
    subchannels) takes one block a cluster."""
    assert nr.per_ap_geometry(1250) == (8, 157)
    assert _per_ap_blocks(1250, 16, 250) == 512 >= 2 * 132
    assert nr.per_ap_geometry(12) == (1, 12) and _per_ap_blocks(12, 3, 4) == 2


def test_segment_table_matches_reference():
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((11, 4)).astype(np.float32)
    ap = rng.integers(0, 3, size=11).astype(np.int32)
    want = jnr._segment_table(jnp.asarray(vals), jnp.asarray(ap), 5)
    _close(nr.segment_table(torch.tensor(vals), torch.tensor(ap), 5), want,
           nr.segment_table(torch.tensor(np.abs(vals)), torch.tensor(ap), 5))
