"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: each test asks for the `cuda` fixture, which skips when no
card is present, so on a CPU-only machine these tests skip. Run them on the
card (the repo's conftest imports JAX, which that machine lacks) with

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Shapes cover ragged U/M/N, block_u != block_v, one AP, and CellLayout
schedules. Fleet launches (a leading member dim) are held member by member
to single launches on each member with torch.equal: the launch geometry
depends on (U, N, M) alone, so the bits must be the same. The kernel and its twin sum the same float32 terms in another
order: each element's error is held to 1e-5 of the sum of the magnitudes
of its terms (the twin on absolute weights), never of the largest output,
under which a far user's rows would hide.

flash_attention: each output element within 1e-2 (bf16) or 1e-5 (float32)
of sum_k p_k |v_k| (the twin on |v|): the bf16 output rounds at 2^-8 of it
and p is rounded to bf16 before the AV product; in float32 only the order
of the sums differs. flash_attention_bwd: each gradient element within 1e-2
(bf16) or 1e-5 (float32) of the sum of the magnitudes of its terms
(flash_attention_bwd_scale): P and dS are rounded to bf16 before the
products in both, the gradients to bf16 at the end; two launches on the
same inputs give the same bits (no atomics). rg_lru: within 1e-5 of the twin on (log_a, |b|, |h0|),
the float32 summation bound of the recurrence. The reduced model on the
card against itself on the CPU: within 1e-2 of each position's largest
logit (bf16 matmuls with other summation orders); so are the reduced
vision and audio models, with a frontend."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core import GdConfig, channel, make_env, make_weights, profiles  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import build_cell_layout, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import noma_rates as nr  # noqa: E402
from repro_torch.kernels import rg_lru as rl  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.core import li_gd  # noqa: E402
from repro_torch.planning import PlannerEngine, stack_envs  # noqa: E402
from repro_torch.runtime.serve import make_split_serve  # noqa: E402

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
    with pytest.raises(ValueError, match="n_aps"):
        nr.noma_cell_intra_dense(own, own, own, ap, ap, 0)
    q = torch.randn((2, 4, 64), device=cuda, dtype=torch.bfloat16)
    shifted = q.view(-1)[2:258].view(1, 4, 64)   # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_attention(shifted, q[:1], q[:1], group=1)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,sq,sk,h,kv,hd,causal,window,kv_len",
    [
        (1, 64, 64, 4, 4, 32, True, 0, None),
        (2, 100, 100, 4, 1, 64, True, 0, None),       # ragged, MQA
        (1, 77, 130, 8, 2, 64, False, 0, 111),        # bidirectional, Sq != Sk, kv_len
        (2, 200, 200, 4, 2, 32, True, 48, None),      # local window
        (1, 129, 129, 16, 1, 256, True, 64, None),    # the served model's head shape
        (1, 70, 70, 2, 1, 128, False, 0, None),
    ],
)
def test_flash_attention_matches_plain_twin(cuda, dtype, b, sq, sk, h, kv, hd, causal,
                                            window, kv_len):
    g = torch.Generator(device=cuda).manual_seed(sq * 7 + hd)
    q = torch.randn((b * h, sq, hd), device=cuda, generator=g).to(dtype)
    k = torch.randn((b * kv, sk, hd), device=cuda, generator=g).to(dtype)
    v = torch.randn((b * kv, sk, hd), device=cuda, generator=g).to(dtype)
    args = dict(group=h // kv, causal=causal, window=window, kv_len=kv_len)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, **args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, **args)
    scale = fa.flash_attention_plain(q, k, v.abs(), **args).float()
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    _close(got.float(), want.float(), scale, 1e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize(
    "b,sq,sk,h,kv,hd,causal,window,kv_len",
    [
        (1, 200, 200, 4, 4, 32, True, 0, None),       # G = 1, ragged against 128 / 64
        (2, 130, 130, 8, 2, 64, True, 100, None),     # G = 4, window edge inside a key block
        (1, 77, 300, 16, 1, 128, False, 0, 250),      # G = 16, kv_len < Sk, Sq != Sk
        (1, 300, 300, 16, 1, 256, True, 200, None),   # the served head shape, window
        (2, 129, 129, 4, 1, 256, False, 0, 100),      # bidirectional, kv_len < Sk
        (1, 64, 190, 4, 4, 64, True, 0, 150),         # causal with Sq < Sk, kv_len
        (1, 1, 70, 2, 2, 128, False, 0, None),        # one query row
        (1, 257, 257, 2, 1, 32, True, 64, None),      # window of exactly one key block
    ],
)
def test_flash_attention_bf16_tensor_core_shapes(cuda, b, sq, sk, h, kv, hd, causal, window,
                                                 kv_len):
    """The bf16 (wgmma + TMA) path at every head_dim, with ragged Sq / Sk,
    window and kv_len edges inside key blocks, and G = 1, 4, 16."""
    g = torch.Generator(device=cuda).manual_seed(sq * 13 + sk + hd)
    q = torch.randn((b * h, sq, hd), device=cuda, generator=g).bfloat16()
    k = torch.randn((b * kv, sk, hd), device=cuda, generator=g).bfloat16()
    v = torch.randn((b * kv, sk, hd), device=cuda, generator=g).bfloat16()
    args = dict(group=h // kv, causal=causal, window=window, kv_len=kv_len)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, **args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, **args)
    scale = fa.flash_attention_plain(q, k, v.abs(), **args).float()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    _close(got.float(), want.float(), scale, 1e-2)


def test_flash_attention_at_the_moe_served_shape(cuda):
    """deepseek-moe-16b's prefill attention: B = 4, H = KV = 16 (G = 1),
    hd 128, S = 3072, full causal."""
    b, s, h, hd = 4, 3072, 16, 128
    g = torch.Generator(device=cuda).manual_seed(20)
    q, k, v = (torch.randn((b * h, s, hd), device=cuda, generator=g).bfloat16()
               for _ in range(3))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, 1, True, 0)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, 1, True, 0)
    scale = fa.flash_attention_plain(q, k, v.abs(), 1, True, 0).float()
    _close(got.float(), want.float(), scale, 1e-2)


def test_flash_attention_at_the_flat_per_rank_shape(cuda):
    """recurrentgemma-9b's prefill on one rank of a model axis of 2, the
    flat layout: its 16 query heads split 8 a rank, the one KV head
    repeated a query head (G = 1), hd 256, window 2048, B = 4, S = 3072."""
    rows, s, hd, window = 4 * 8, 3072, 256, 2048
    g = torch.Generator(device=cuda).manual_seed(27)
    q, k, v = (torch.randn((rows, s, hd), device=cuda, generator=g).bfloat16()
               for _ in range(3))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, 1, True, window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, 1, True, window)
    scale = fa.flash_attention_plain(q, k, v.abs(), 1, True, window).float()
    _close(got.float(), want.float(), scale, 1e-2)


def test_flash_attention_at_the_vlm_per_rank_cross_shape(cuda):
    """llama-3.2-vision-11b's cross attention on one rank of a model axis of
    2, the grouped layout: 16 of its 32 query heads over 4 of its 8 KV heads
    (G = 4), hd 128, 3072 queries over 1601 image tokens, no mask, B = 4."""
    b, h, kv, sq, sk, hd = 4, 16, 4, 3072, 1601, 128
    g = torch.Generator(device=cuda).manual_seed(28)
    q = torch.randn((b * h, sq, hd), device=cuda, generator=g).bfloat16()
    k, v = (torch.randn((b * kv, sk, hd), device=cuda, generator=g).bfloat16()
            for _ in range(2))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, h // kv, False, 0)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, h // kv, False, 0)
    scale = fa.flash_attention_plain(q, k, v.abs(), h // kv, False, 0).float()
    _close(got.float(), want.float(), scale, 1e-2)


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", [
    (4, 3072, 3072, 32, 8, 128, True),    # llama-3.2-vision-11b self-attention
    (4, 3072, 1601, 32, 8, 128, False),   # its cross-attention: Sq > Sk, 1 key in the last block
    (4, 1500, 1500, 12, 12, 64, False),   # whisper-small's encoder, hd 64
    (4, 448, 448, 12, 12, 64, True),      # its decoder self-attention: 3.5 query blocks
    (4, 448, 1500, 12, 12, 64, False),    # its decoder cross-attention
    # the serving entry point's shapes (no frontend, a continuation pass one token longer)
    (4, 3072, 3072, 32, 8, 128, False),   # a vlm cross block over its own input
    (4, 3073, 3073, 32, 8, 128, False),   # the same, continuation: 1 query in the last block
    (4, 3073, 3073, 32, 8, 128, True),    # vlm self-attention, continuation
    (4, 448, 448, 12, 12, 64, False),     # whisper's split: enc blocks and dec cross over 448
    (4, 449, 449, 12, 12, 64, False),     # the same, continuation
    (4, 449, 449, 12, 12, 64, True),      # whisper decoder self-attention, continuation
    # the prefills' (8 tokens short of the served length)
    (4, 3064, 3064, 32, 8, 128, True),    # vlm self-attention
    (4, 3064, 1601, 32, 8, 128, False),   # vlm cross-attention
    (4, 440, 440, 12, 12, 64, True),      # whisper decoder self-attention
    (4, 440, 1500, 12, 12, 64, False),    # whisper decoder cross-attention
])
def test_flash_attention_at_the_vlm_and_audio_served_shapes(cuda, b, sq, sk, h, kv, hd, causal):
    g = torch.Generator(device=cuda).manual_seed(sq + sk + hd)
    q = torch.randn((b * h, sq, hd), device=cuda, generator=g).bfloat16()
    k, v = (torch.randn((b * kv, sk, hd), device=cuda, generator=g).bfloat16() for _ in range(2))
    args = (h // kv, causal, 0)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, *args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, *args)
    scale = fa.flash_attention_plain(q, k, v.abs(), *args).float()
    assert bool(torch.isfinite(got).all())
    _close(got.float(), want.float(), scale, 1e-2)


@pytest.mark.parametrize("name,want_flash", [("llama-3.2-vision-11b", 4), ("whisper-small", 6)])
def test_vlm_and_audio_forward_on_the_card_counts_launches(cuda, name, want_flash):
    """The reduced models with a frontend (xgate 0.5): one flash launch per
    attention of a forward (vlm: 2 attn + 2 cross; whisper: 2 enc + 2 dec
    self + 2 dec cross), split logits bit-equal at every split, and the
    card's logits within 1e-2 of each position's largest on the CPU's."""
    cfg = configs.get(name).reduced()
    model = Model(cfg, device=cuda).init(torch.Generator(device=cuda).manual_seed(1))
    for spec, layers in zip(model.stages, model.stage_layers):
        for blk in layers if spec.kind == "cross" else ():
            blk.p.xgate.fill_(0.5)
    batch = make_batch(0, 0, 2, 96, cfg.vocab_size,
                       frontend_shape=(cfg.frontend_tokens, cfg.d_model), device=cuda)
    tokens, frontend = batch["tokens"], batch["frontend"]
    fa.reset_launches()
    full, _, _ = model(tokens, frontend)
    assert fa.LAUNCHES["flash_attention"] == want_flash
    if cfg.family == "vlm":
        for s in range(sum(sp.n_layers for sp in model.stages) + 1):
            progs = make_split_serve(model, s)
            assert torch.equal(progs.edge_fn(progs.device_fn(tokens, frontend), frontend), full)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want, _, _ = cpu(tokens.cpu(), frontend.cpu())
    _close(full.cpu(), want, want.abs().amax(-1, keepdim=True), 1e-2)


def test_moe_layer_on_the_card_sorted_equals_dense_and_repeats(cuda):
    """One deepseek-moe-16b MoE layer at reduced width on the card: sorted
    equal to dense at capacity E (nothing drops; tests/test_models.py's
    atol 0.03, rtol 0.05), and two sorted calls bit-equal (the combine adds
    each token's contributions in a fixed order, no atomics)."""
    from repro_torch.models import moe
    from repro_torch.models.layers import init_params
    cfg = configs.get("deepseek-moe-16b").reduced()
    g = torch.Generator(device=cuda).manual_seed(0)
    p = init_params(moe.moe_defs(cfg), g)
    x = (0.1 * torch.randn((2, 512, cfg.d_model), device=cuda, generator=g)).bfloat16()
    with moe.drop_log() as drops:
        y_s, aux_s = moe.moe_apply(p, x, cfg, impl="sorted", capacity_factor=cfg.n_experts)
    y_d, aux_d = moe.moe_apply(p, x, cfg, impl="dense")
    assert int(drops[0]) == 0
    np.testing.assert_allclose(y_s.float().cpu().numpy(), y_d.float().cpu().numpy(),
                               atol=0.03, rtol=0.05)
    np.testing.assert_allclose(float(aux_s), float(aux_d), rtol=1e-5)
    assert torch.equal(moe.moe_apply(p, x, cfg)[0], moe.moe_apply(p, x, cfg)[0])


def _skewed_ap(ap, n, skew):
    """natural (nearest AP); giant: half the users in cell 0 and cell n-1
    empty; empty: cells 1 and 3 emptied into cell 0."""
    ap = ap.clone()
    if skew == "giant":
        ap[: ap.shape[0] // 2] = 0
        ap[ap == n - 1] = 0
    elif skew == "empty":
        ap[(ap == 1) | (ap == 3)] = 0
    return ap.to(torch.int32).contiguous()


@pytest.mark.parametrize("u,n,m,skew", [(300, 16, 250, "natural"), (200, 5, 45, "giant"),
                                        (37, 1, 33, "natural"), (150, 6, 70, "empty"),
                                        (1250, 16, 250, "giant")])
@pytest.mark.parametrize("descending", [True, False])
def test_dense_intra_matches_twin_and_csr_kernel(cuda, u, n, m, skew, descending):
    """The per-cell dense intra kernel against its plain twin and against
    the CSR kernel on the dense tile list, in the forward role (w = tx *
    own) and the backward role (a cotangent, comparison flipped)."""
    env, beta, p, cot = _inputs(u, n, m, u + n, cuda)
    own, _, _ = ops._inputs(env, True)
    ap = _skewed_ap(env.ap, n, skew)
    w = (beta * p[:, None] * own).contiguous()
    csr = nr.dense_csr(-(-u // 16), -(-u // 16), cuda)
    for w_s, desc in ((w, descending), (cot[0], not descending)):
        args = (own, own, w_s, ap, ap)
        before = nr.LAUNCHES["noma_cell_intra"]
        got = nr.noma_cell_intra_dense(*args, n, desc)
        torch.cuda.synchronize()
        assert nr.LAUNCHES["noma_cell_intra"] == before + 1
        scale = nr.noma_cell_intra_dense_plain(own, own, w_s.abs(), ap, ap, n, desc)
        _close(got, nr.noma_cell_intra_dense_plain(*args, n, desc), scale)
        _close(got, nr.noma_cell_intra(*args, *csr, 16, 16, desc), scale)


def test_dense_intra_with_distinct_receivers_and_senders(cuda):
    """R != S, both past one compaction window (2048 ids), with independent
    gains and AP ids (one cell left empty)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    r, s, m, n = 2200, 2100, 40, 7
    own_r = torch.rand((r, m), device=cuda, generator=g)
    own_s = torch.rand((s, m), device=cuda, generator=g)
    w_s = torch.randn((s, m), device=cuda, generator=g)
    ap_r = torch.randint(0, n - 1, (r,), device=cuda, generator=g).to(torch.int32)
    ap_s = torch.randint(0, n - 1, (s,), device=cuda, generator=g).to(torch.int32)
    for desc in (True, False):
        args = (own_r, own_s, w_s, ap_r, ap_s, n, desc)
        scale = nr.noma_cell_intra_dense_plain(own_r, own_s, w_s.abs(), ap_r, ap_s, n, desc)
        _close(nr.noma_cell_intra_dense(*args), nr.noma_cell_intra_dense_plain(*args), scale)


@pytest.mark.parametrize("b,s,w,with_h0", [(1, 32, 64, False), (2, 45, 96, True),
                                           (3, 128, 128, True), (2, 17, 200, False)])
def test_rg_lru_matches_plain_twin(cuda, b, s, w, with_h0):
    g = torch.Generator(device=cuda).manual_seed(s + w)
    log_a = -torch.rand((b, s, w), device=cuda, generator=g) * 2
    x = torch.randn((b, s, w), device=cuda, generator=g)
    h0 = torch.randn((b, w), device=cuda, generator=g) if with_h0 else None
    before = rl.LAUNCHES["rg_lru"]
    got = rl.rg_lru(log_a, x, h0)
    torch.cuda.synchronize()
    assert rl.LAUNCHES["rg_lru"] == before + 1
    scale = rl.rg_lru_plain(log_a, x.abs(), None if h0 is None else h0.abs())
    _close(got, rl.rg_lru_plain(log_a, x, h0), scale, 1e-5)


# per_ap's w split: (W, N, M) with W not a multiple of the w chunk (W=1003
# in 8 blocks of 126 w, W=500 in 8 of 63; W=300 is 5 blocks of exactly 60),
# W smaller than one block's least chunk (W=40 < PER_AP_MIN_W), the serve
# planner's tiny env, one AP (an exact zero), 1,000-byte rows (M=250),
# M < 32, and more output tiles (65,625) than a grid's y extent holds.
PER_AP_SHAPES = [(300, 5, 45), (1003, 7, 70), (40, 3, 20), (12, 3, 4), (70, 1, 33),
                 (500, 16, 250), (200, 4, 7), (3, 2, 2_100_000)]


@pytest.mark.parametrize("w,n,m", PER_AP_SHAPES)
@pytest.mark.parametrize("uplink", [True, False])
def test_per_ap_split_matches_plain_twin(cuda, w, n, m, uplink):
    g = torch.Generator(device=cuda).manual_seed(w + n + m)
    ap = torch.randint(0, n, (w,), device=cuda, generator=g).to(torch.int32)
    wgt = torch.randn((w, m), device=cuda, generator=g)
    shape = (w, n, m) if uplink else (n, w, m)
    g_raw = torch.rand(shape, device=cuda, generator=g) * 10.0 ** (
        -4 * torch.rand(shape, device=cuda, generator=g))
    before = nr.LAUNCHES["noma_per_ap"]
    got = nr.noma_per_ap(ap, wgt, g_raw, uplink)
    torch.cuda.synchronize()
    assert nr.LAUNCHES["noma_per_ap"] == before + 1
    if n == 1:
        assert not got.any()
    _close(got, nr.noma_per_ap_plain(ap, wgt, g_raw, uplink),
           nr.noma_per_ap_plain(ap, wgt.abs(), g_raw, uplink))
    assert torch.equal(nr.noma_per_ap(ap, wgt, g_raw, uplink), got)


@pytest.mark.parametrize("b,s,w,with_h0,tma", [
    (2, 45, 96, True, True),      # S not a multiple of the ring's 32 steps
    (3, 1, 64, False, True),      # S = 1
    (1, 100, 30, True, False),    # W % 4 != 0: cp.async; B = 1
    (2, 77, 201, False, False),   # W % 4 != 0, a ragged channel tile
    (2, 70, 20, True, True),      # W under one 32-channel tile, TMA
    (1, 33, 6, False, False),     # W under one tile, cp.async
    (4, 160, 4096, True, True),   # the served width
])
def test_rg_lru_is_bit_equal_to_plain_twin(cuda, b, s, w, with_h0, tma):
    g = torch.Generator(device=cuda).manual_seed(3 * s + w)
    log_a = -8.0 * torch.rand((b, s, w), device=cuda, generator=g)
    x = torch.randn((b, s, w), device=cuda, generator=g)
    h0 = torch.randn((b, w), device=cuda, generator=g) if with_h0 else None
    assert rl.uses_tma(w, log_a.data_ptr(), x.data_ptr()) == tma
    got = rl.rg_lru(log_a, x, h0)
    torch.cuda.synchronize()
    assert torch.equal(got, rl.rg_lru_plain(log_a, x, h0))


def test_rg_lru_takes_cp_async_for_misaligned_operands(cuda):
    """An operand off a 16-byte boundary cannot back a tensor map: the
    wrapper fills the ring by cp.async, with the same bits."""
    g = torch.Generator(device=cuda).manual_seed(8)
    flat = torch.randn(2 * 40 * 64 + 1, device=cuda, generator=g)
    log_a = -torch.rand((2, 40, 64), device=cuda, generator=g)
    x = flat[1:].view(2, 40, 64)
    assert not rl.uses_tma(64, log_a.data_ptr(), x.data_ptr())
    assert torch.equal(rl.rg_lru(log_a, x), rl.rg_lru_plain(log_a, x))


def test_attention_and_rg_lru_wrappers_refuse_bad_cuda_arguments(cuda):
    q = torch.randn((4, 16, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q[:1], q[:1], group=4)
    q = torch.randn((4, 16, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q[:1], q[:1], group=4)
    la = torch.zeros((2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="shape"):
        rl.rg_lru(la, la, torch.zeros((2, 8), device=cuda))


def test_split_serve_on_the_card_is_bit_equal_and_counts_launches(cuda):
    cfg = configs.get("recurrentgemma-9b").reduced()
    model = Model(cfg, device=cuda).init(torch.Generator(device=cuda).manual_seed(1))
    tokens = make_batch(0, 0, 2, 96, cfg.vocab_size, device=cuda)["tokens"]
    fa.reset_launches()
    rl.reset_launches()
    full, _, _ = model(tokens)
    assert fa.LAUNCHES["flash_attention"] == 1 and rl.LAUNCHES["rg_lru"] == 2
    for s in range(cfg.n_layers + 1):
        progs = make_split_serve(model, s)
        assert torch.equal(progs.edge_fn(progs.device_fn(tokens)), full)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want, _, _ = cpu(tokens.cpu())
    _close(full.cpu(), want, want.abs().amax(-1, keepdim=True), 1e-2)


# (B, U, N, M): ragged U/M, one AP, the planner's N and M, B up to 4.
FLEET_SHAPES = [(3, 37, 5, 45), (2, 64, 1, 32), (4, 300, 16, 250), (3, 101, 7, 70)]


@pytest.mark.parametrize("b,u,n,m", FLEET_SHAPES)
@pytest.mark.parametrize("uplink", [True, False])
def test_fleet_launch_members_bit_equal_single_launches(cuda, b, u, n, m, uplink):
    """One launch of each kernel over a fleet, counted once, against a
    single launch on each member (torch.equal) and the plain twin."""
    fleet = stack_envs([make_env(u, n, m, seed=u + i, device=cuda) for i in range(b)])
    own, g_raw, ap = ops._inputs(fleet, uplink)
    g = torch.Generator(device=cuda).manual_seed(b + u)
    tx = torch.rand((b, u, m), device=cuda, generator=g) * 0.3
    cot = torch.randn((2, b, u, m), device=cuda, generator=g)
    w_in = (tx * own).contiguous() if uplink else tx
    calls = {
        "intra fwd": (nr.noma_cell_intra_dense, nr.noma_cell_intra_dense_plain,
                      (own, own, w_in, ap, ap), (n, uplink), 2),
        "intra bwd": (nr.noma_cell_intra_dense, nr.noma_cell_intra_dense_plain,
                      (own, own, cot[0].contiguous(), ap, ap), (n, not uplink), 2),
        "per_ap": (nr.noma_per_ap, nr.noma_per_ap_plain,
                   (ap, tx if uplink else cot[1].contiguous(), g_raw), (uplink,), 1),
        "contract": (nr.noma_ap_contract, nr.noma_ap_contract_plain,
                     (ap, nr.segment_table(cot[1] if uplink else tx, ap, n).contiguous(),
                      g_raw), (uplink,), 1),
    }
    for name, (kernel, plain, tensors, rest, w_pos) in calls.items():
        before = dict(nr.LAUNCHES)
        got = kernel(*tensors, *rest)
        torch.cuda.synchronize()
        assert sum(nr.LAUNCHES.values()) == sum(before.values()) + 1, name
        abs_tensors = tuple(t.abs() if i == w_pos else t for i, t in enumerate(tensors))
        _close(got, plain(*tensors, *rest), plain(*abs_tensors, *rest))
        for i in range(b):
            one = kernel(*(t[i] for t in tensors), *rest)
            assert torch.equal(got[i], one), (name, i)
    too_many = 65536                                 # grid z holds 65,535
    with pytest.raises(ValueError, match="fleet members"):
        nr.noma_per_ap(torch.zeros((too_many, 2), dtype=torch.int32, device=cuda),
                       torch.zeros((too_many, 2, 3), device=cuda),
                       torch.zeros((too_many, 2, 2, 3), device=cuda))


def test_plan_many_on_the_card(cuda):
    """plan_many over 3 envs on the card: 6 / 3 / 3 launches a fleet GD step
    whatever B, each member's utility near its single plan's."""
    envs = [make_env(48, 4, 16, seed=s, device=cuda) for s in range(3)]
    cfg = GdConfig(optimizer="adam", max_iters=40)
    eng = PlannerEngine(profiles.nin(), cfg=cfg, sinr_backend="kernel")
    nr.reset_launches()
    li_gd.reset_counts()
    state = eng.plan_many(envs)
    steps, splits = li_gd.COUNTS["steps"], profiles.nin().n_layers + 1
    n_evals = steps + splits + 2
    assert nr.LAUNCHES == {"noma_cell_intra": 4 * steps + 2 * n_evals,
                           "noma_per_ap": 2 * steps + n_evals,
                           "noma_ap_contract": 2 * steps + n_evals}
    assert state.plan.s.shape == (3,) and bool(torch.isfinite(state.plan.utility).all())
    for i, env in enumerate(envs):
        one = eng.plan(env)
        np.testing.assert_allclose(float(state.plan.utility[i]), float(one.plan.utility),
                                   rtol=1e-3)


def test_compare_all_on_the_card(cuda):
    """The comparison arms on the card: the OMA arms and Device-Only launch
    no NOMA kernel; Edge-Only and ECC-NOMA's evaluation launch one forward
    evaluation each (2 intra, 1 per_ap, 1 contract) under the kernel
    backend; s agrees with the CPU run of the same env."""
    from repro_torch.core import baselines, planner
    env = make_env(48, 4, 16, seed=5, device=cuda)
    prof = profiles.nin()
    w = make_weights(env.n_users, device=cuda)
    prev = channel.set_sinr_backend("kernel")
    try:
        for arm, fn in (("device_only", baselines.device_only),
                        ("neurosurgeon", baselines.neurosurgeon),
                        ("dnn_surgery", baselines.dnn_surgery),
                        ("ecc_oma", lambda e, p: baselines.ecc_oma(e, p, w)),
                        ("edge_only", baselines.edge_only)):
            nr.reset_launches()
            out = fn(env, prof)
            torch.cuda.synchronize()
            want = {"noma_cell_intra": 2, "noma_per_ap": 1, "noma_ap_contract": 1} \
                if arm == "edge_only" else {k: 0 for k in nr.LAUNCHES}
            assert dict(nr.LAUNCHES) == want, arm
            assert out.T.device == cuda and bool(torch.isfinite(out.T).all()), arm
        res = planner.compare_all(env, prof, w, GdConfig(max_iters=40, sinr_backend="kernel"))
        cpu = planner.compare_all(env.to("cpu"), prof, w.to("cpu"),
                                  GdConfig(max_iters=40, sinr_backend="kernel"))
    finally:
        channel.set_sinr_backend(prev)
    for arm in res:
        assert torch.equal(res[arm].s.cpu(), cpu[arm].s), arm


@pytest.mark.parametrize("u,n,m,dead", [(300, 16, 250, 3), (90, 4, 40, 0)])
@pytest.mark.parametrize("uplink", [True, False])
def test_kernels_on_fault_masked_gains(cuda, u, n, m, dead, uplink):
    """The online loop's fault injection on the kernels' inputs: one AP
    blacked out (its gains exactly 0) and about a fifth of the users faded
    by 1e-6. Each kernel on the operands the main path gives it, forward
    and backward, against its twin; the dead cell's intra terms are exactly
    0 (the SIC order is strict, so an all-zero cell has no pair), and its
    users' rates sit at the 1e-9 floor."""
    from repro_torch.faults import FaultConfig, apply_env_faults, injectors
    env, beta, p, cot = _inputs(u, n, m, u + dead, cuda)
    g = torch.Generator(device=cuda).manual_seed(u)
    faded = torch.rand(u, device=cuda, generator=g) < 0.2
    rates = FaultConfig(link_outage_rate=0.2, ap_outage_rate=0.05).rates(cuda)
    draw = injectors.FaultDraw(link_down=faded, ap_down=torch.arange(n, device=cuda) == dead,
                               tel_drop=torch.tensor(False, device=cuda),
                               tel_spike=torch.tensor(False, device=cuda),
                               svc_mult=torch.ones(u, device=cuda))
    menv = apply_env_faults(env, draw, rates)
    in_dead = menv.ap == dead
    assert bool(in_dead.any())
    own, g_raw, ap = ops._inputs(menv, uplink)
    tx = (beta * p[:, None]).contiguous()
    w_fwd = (tx * own).contiguous() if uplink else tx
    for w, desc in ((w_fwd, uplink), (cot[0], not uplink)):
        got = nr.noma_cell_intra_dense(own, own, w, ap, ap, n, desc)
        _close(got, nr.noma_cell_intra_dense_plain(own, own, w, ap, ap, n, desc),
               nr.noma_cell_intra_dense_plain(own, own, w.abs(), ap, ap, n, desc))
        assert bool((got[in_dead] == 0).all())
    for w, per_ap in ((tx, uplink), (cot[1].contiguous(), not uplink)):
        if per_ap:
            _close(nr.noma_per_ap(ap, w, g_raw, uplink), nr.noma_per_ap_plain(ap, w, g_raw, uplink),
                   nr.noma_per_ap_plain(ap, w.abs(), g_raw, uplink))
        else:
            tab = nr.segment_table(w, ap, n)
            _close(nr.noma_ap_contract(ap, tab, g_raw, uplink),
                   nr.noma_ap_contract_plain(ap, tab, g_raw, uplink),
                   nr.noma_ap_contract_plain(ap, nr.segment_table(w.abs(), ap, n), g_raw, uplink))
    r = (channel.uplink_rates if uplink else channel.downlink_rates)(menv, beta, p,
                                                                     backend="kernel")
    r = torch.clamp_min(r.sum(-1), 1e-9)
    assert bool(torch.isfinite(r).all()) and bool((r[in_dead] == r.new_tensor(1e-9)).all())


def test_online_loop_on_the_card(cuda):
    """A hardened OnlineLoop with the chaos mix on the card (U=48): each
    epoch launches the service model's two rate evaluations (2 / 1 / 1)
    plus a fallback's and a replan's, every served plan is finite, and the
    epoch's draws live on the card."""
    from repro_torch.faults import FaultConfig, LadderConfig
    from repro_torch.online import OnlineLoop, ServiceConfig, StreamConfig
    from repro_torch.online import loop as looplib
    from repro_torch.scenarios import Scenario, ScenarioConfig
    eng = PlannerEngine(profiles.nin(), cfg=GdConfig(step_size=3e-2, eps=1e-4, max_iters=40,
                                                     optimizer="adam"), sinr_backend="kernel")
    loop = OnlineLoop(Scenario(ScenarioConfig(n_users=48, n_aps=4, n_sub=16, fading_rho=0.95)),
                      eng, StreamConfig(arrival_rate_hz=3.0, epoch_dt_s=0.02, deadline_s=0.2),
                      ServiceConfig(edge_capacity=4, queue_depth=16, load_gain=4.0,
                                    replan_every=3, max_work_epochs=200),
                      faults=FaultConfig(link_outage_rate=0.2, ap_outage_rate=0.05,
                                         telemetry_drop_rate=0.1, service_spike_rate=0.02),
                      degrade=LadderConfig())
    prev = channel.set_sinr_backend("kernel")
    try:
        loop.reset(1)
        assert loop.epoch_draws(0)["fault"]["link_fail"].device == cuda
        for _ in range(8):
            nr.reset_launches()
            fb = looplib.COUNTS["fallback_plans"]
            loop.step_epoch()
            torch.cuda.synchronize()
            evals = 1 + looplib.COUNTS["fallback_plans"] - fb
            if not loop.server.last_replanned:
                assert dict(nr.LAUNCHES) == {"noma_cell_intra": 2 * evals,
                                             "noma_per_ap": evals, "noma_ap_contract": evals}
            assert bool(torch.isfinite(loop._plan.utility))
    finally:
        channel.set_sinr_backend(prev)
    m = loop.metrics()
    assert m["epochs"] == 8 and m["offered"] >= m["completed"]


# -- the flash backward ---------------------------------------------------------------
def _bwd_inputs(cuda, bh, g, sq, sk, hd, causal, window, kv_len, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((bh, sq, hd), device=cuda, generator=gen).to(dtype)
    k, v = (torch.randn((bh // g, sk, hd), device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    dout = torch.randn((bh, sq, hd), device=cuda, generator=gen).to(dtype)
    out, lse = fa.flash_attention(q, k, v, g, causal, window, kv_len, return_lse=True)
    return q, k, v, out, lse, dout


def _check_bwd(cuda, bh, g, sq, sk, hd, causal, window, kv_len, dtype, seed):
    args = (g, causal, window, kv_len)
    q, k, v, out, lse, dout = _bwd_inputs(cuda, bh, g, sq, sk, hd, causal, window, kv_len,
                                          dtype, seed)
    assert torch.equal(out, fa.flash_attention(q, k, v, *args))   # the lse switch moves nothing
    before = fa.LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, *args)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, *args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bwd"] == before + 2
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, *args)
    scales = fa.flash_attention_bwd_scale(q, k, v, out, lse, dout, *args)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for x, y, w, sc in zip(got, again, want, scales):
        assert x.dtype == dtype and bool(torch.isfinite(x).all())
        assert torch.equal(x, y)
        _close(x.float(), w.float(), sc, tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "bh,g,sq,sk,hd,causal,window,kv_len",
    [
        (8, 1, 300, 300, 64, True, 100, None),     # local window, G = 1
        (8, 4, 200, 200, 64, False, 0, None),      # bidirectional, G = 4
        (8, 4, 257, 257, 128, True, 0, None),      # causal, G = 4, ragged
        (4, 2, 100, 150, 32, True, 0, None),       # Sq < Sk, causal
        (4, 2, 150, 100, 32, False, 0, None),      # Sq > Sk, bidirectional
        (4, 1, 200, 200, 64, True, 0, 170),        # kv_len < Sk
        (4, 4, 130, 200, 256, False, 0, 150),      # hd 256, kv_len < Sk
        (4, 2, 300, 300, 256, True, 77, None),     # hd 256, window
        # the edges of the wgmma kernels' 128-row blocks and 64-row tiles
        (16, 4, 2048, 2048, 128, True, 0, None),   # phi3-medium-14b's layout, G = 4
        (24, 6, 2048, 2048, 128, True, 0, None),   # qwen2-1.5b's and internlm2-20b's, G = 6
        (8, 2, 1000, 257, 128, False, 0, None),    # partial key block and query tile
        (8, 2, 257, 1000, 64, True, 0, None),      # the same, causal, Sq < Sk
        (8, 2, 500, 500, 128, True, 37, None),     # a window edge inside a 64-key tile
        (8, 4, 300, 320, 128, False, 0, 250),      # kv_len < Sk at hd 128
        (32, 16, 300, 300, 64, True, 0, None),     # G = 16
    ],
)
def test_flash_attention_bwd_matches_plain_twin(cuda, dtype, bh, g, sq, sk, hd, causal, window,
                                                kv_len):
    _check_bwd(cuda, bh, g, sq, sk, hd, causal, window, kv_len, dtype, sq + sk + hd)


def test_flash_attention_bwd_at_the_qwen_train_shape(cuda):
    """qwen1.5-0.5b's training attention: 8 x 16 query head rows, S = 2048,
    hd 64, G = 1, causal, bf16."""
    _check_bwd(cuda, 128, 1, 2048, 2048, 64, True, 0, None, torch.bfloat16, 23)


def test_train_step_on_the_card_counts_launches(cuda):
    """The reduced qwen1.5-0.5b's train step on the card: per step 2 flash
    forwards a layer (the forward, and its recomputation under remat) and
    one backward call; the loss finite and within 0.05 * max(1, |loss|) of
    the same step on the CPU (plain twins) from the same parameters."""
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import train as t_train
    cfg = configs.get("qwen1.5-0.5b").reduced()
    batch = make_batch(0, 0, 4, 64, cfg.vocab_size, device="cpu")
    card = Model(cfg, device=cuda, trainable=True)
    states = [t_train.init_state(card, torch.Generator(device=cuda).manual_seed(0))]
    host = Model(cfg, device="cpu", trainable=True).load_params_(_to_cpu(card.param_tree()))
    states.append(t_train.TrainState(host.param_tree(), adamw_init(host.param_tree()),
                                     torch.zeros((), dtype=torch.int32)))
    losses = []
    for model, state in zip((card, host), states):
        step = t_train.make_train_step(model, base_lr=3e-3, total_steps=30, seq_chunk=32)
        fa.reset_launches()
        _, met = step(state, {k: v.to(model.device) for k, v in batch.items()})
        if model is card:
            torch.cuda.synchronize()
            assert fa.LAUNCHES == {"flash_attention": 2 * cfg.n_layers,
                                   "flash_attention_bwd": cfg.n_layers}
        losses.append(float(met["loss"]))
    assert np.isfinite(losses[0])
    assert abs(losses[0] - losses[1]) <= 0.05 * max(1.0, abs(losses[1]))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu()


@pytest.mark.parametrize("b,s,w,with_h0,tma", [
    (2, 45, 96, True, True),      # S not a multiple of the ring's 32 steps
    (3, 1, 64, True, True),       # S = 1: step 0 reads h0
    (1, 100, 30, True, False),    # W % 4 != 0: cp.async; B = 1
    (2, 77, 201, False, False),   # W % 4 != 0, a ragged channel tile
    (2, 70, 20, True, True),      # W under one 32-channel tile, TMA
    (2, 3072, 4096, False, True),  # the hybrid train step's shape
    (2, 3072, 4096, True, True),
])
def test_rg_lru_bwd_is_bit_equal_to_plain_twin(cuda, b, s, w, with_h0, tma):
    """The RG-LRU backward against its twin, to the bit, and two launches
    on the same inputs bit-equal (no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(5 * s + w)
    log_a = -8.0 * torch.rand((b, s, w), device=cuda, generator=g)
    x = torch.randn((b, s, w), device=cuda, generator=g)
    h0 = torch.randn((b, w), device=cuda, generator=g) if with_h0 else None
    dh = torch.randn((b, s, w), device=cuda, generator=g)
    h = rl.rg_lru(log_a, x, h0)
    assert rl.uses_tma(w, log_a.data_ptr(), h.data_ptr(), dh.data_ptr()) == tma
    before = rl.LAUNCHES["rg_lru_bwd"]
    got = rl.rg_lru_bwd(log_a, h, h0, dh)
    again = rl.rg_lru_bwd(log_a, h, h0, dh)
    torch.cuda.synchronize()
    assert rl.LAUNCHES["rg_lru_bwd"] == before + 2
    want = rl.rg_lru_bwd_plain(log_a, h, h0, dh)
    assert (got[2] is None) == (h0 is None)
    for x_, y_, z_ in zip(got, again, want):
        if z_ is not None:
            assert torch.equal(x_, z_) and torch.equal(x_, y_)


def test_rg_lru_bwd_takes_cp_async_for_misaligned_operands(cuda):
    """dh off a 16-byte boundary (a view into a larger gradient): the ring
    is filled by cp.async, with the twin's bits."""
    g = torch.Generator(device=cuda).manual_seed(9)
    log_a = -torch.rand((2, 40, 64), device=cuda, generator=g)
    x = torch.randn((2, 40, 64), device=cuda, generator=g)
    h0 = torch.randn((2, 64), device=cuda, generator=g)
    dh = torch.randn(2 * 40 * 64 + 1, device=cuda, generator=g)[1:].view(2, 40, 64)
    h = rl.rg_lru(log_a, x, h0)
    assert not rl.uses_tma(64, log_a.data_ptr(), h.data_ptr(), dh.data_ptr())
    for a, b in zip(rl.rg_lru_bwd(log_a, h, h0, dh), rl.rg_lru_bwd_plain(log_a, h, h0, dh)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,n_rec", [("recurrentgemma-9b", 2), ("deepseek-moe-16b", 0)])
def test_hybrid_and_moe_gradient_passes_are_bit_equal(cuda, name, n_rec):
    """Two gradient passes of the reduced model from one state and batch on
    the card give the same bits in every leaf (the RG-LRU backward, the
    MoE dispatch's backward, the embedding's); with remat, 2 rg_lru
    forwards and 1 backward a recurrent layer a pass."""
    from repro_torch.core.types import tree_flatten
    from repro_torch.runtime import train as t_train
    cfg = configs.get(name).reduced()
    model = Model(cfg, device=cuda, trainable=True, moe_capacity=2.0)
    t_train.init_state(model, torch.Generator(device=cuda).manual_seed(0))
    batch = make_batch(0, 0, 4, 64, cfg.vocab_size, device=cuda)
    passes = []
    for _ in range(2):
        rl.reset_launches()
        passes.append(t_train.loss_and_grads(model, batch, seq_chunk=32))
        torch.cuda.synchronize()
        assert rl.LAUNCHES == {"rg_lru": 2 * n_rec, "rg_lru_bwd": n_rec}
    assert torch.equal(passes[0][0], passes[1][0])
    for a, b in zip(tree_flatten(passes[0][2])[0], tree_flatten(passes[1][2])[0], strict=True):
        assert torch.equal(a, b)
