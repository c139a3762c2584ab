"""Tensor-parallel serving on the CPU: runtime/serve.py's jit_prefill,
jit_decode_step and jit_masked_decode_step on ("data", "model") meshes of
gloo ranks (models/tp.py), against the JAX package's unsharded
Model(cfg, tp_size=M) (GSPMD preserves values, so the unsharded program is
the reference, as tests/test_torch_train_dp.py argues for the data axis).

Two reduced models, their parameters the reference's Model.init(PRNGKey(0))
carried to every rank by convert.model_params_from_numpy (each rank cuts
its shard): recurrentgemma-9b (rec, rec, attn; one KV head, so the flat
layout, K / V projections split inside the head or replicated, split
RG-LRU channels, a prompt of 96 over the 64-slot window, so the ring roll
runs) and qwen1.5-0.5b (four KV heads: grouped on 2 ranks, flat with Hp = 6
on 3). Meshes (1, 2), (1, 3) and (2, 2). On (1, 3) the vocab 512, d_ff 256,
RG-LRU width 128, wk and the 64-slot window are replicated and the heads
padded; the qwen cache of 108 slots splits its sequence over 3 ranks, the
recurrentgemma window over 2.

Each mesh's ranks start once for the module (launch.mesh.spawn, a file://
rendezvous under the module's temporary directory) and run both models in
float32 (COMPUTE_DTYPE float32 in both packages, stored weights widened)
and in bf16: a prefill of 4 x 96, 4 decode steps and 2 masked steps with
slot 1 idle. The JAX references run in this process meanwhile.

Bounds: float32 logits within 1e-5 * max(1, max |logits|) of each row, and
every cache leaf, reassembled whole from the ranks' shards, within 1e-5 *
max(1, max |leaf|); bf16 logits within the JAX package's 0.05 * max(1, max
|logits|). Every rank's parameter and cache leaves have exactly the local
shape that tree_shardings / cache_shardings assign.
"""
import importlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, convert  # noqa: E402
from repro_torch.core.types import tree_flatten, tree_map  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import tp as ttp  # noqa: E402

ARCHS = ("recurrentgemma-9b", "qwen1.5-0.5b")
MESHES = ((1, 2), (1, 3), (2, 2))
B, S, MAX_LEN, DECODE, MASKED = 4, 96, 108, 4, 2
ACTIVE = [True, False, True, True]
F32_TOL, BF16_TOL = 1e-5, 0.05
MODEL_MODULES = ("layers", "attention", "recurrent", "model")


def _inputs(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
             for _ in range(DECODE + MASKED)]
    return toks, steps


def _port_f32() -> None:
    for name in MODEL_MODULES:
        mod = importlib.import_module(f"repro_torch.models.{name}")
        if hasattr(mod, "COMPUTE_DTYPE"):
            mod.COMPUTE_DTYPE = torch.float32


def _shapes(tree):
    return [tuple(x.shape) for x in tree_flatten(tree)[0]]


def serve_rank(rank: int, shape: tuple, trees: dict, tmp: str) -> None:
    """One rank of a ``shape`` mesh: for each dtype and arch, the model on
    the mesh with the reference's parameters, then the serve steps on this
    rank's rows. Writes its logits, final caches and leaf shapes to
    tmp/rank<r>.pt."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.runtime import serve
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = {"coord": ttp.mesh_coord(mesh)}
    for f32 in (False, True):
        if f32:
            _port_f32()
        for arch in ARCHS:
            cfg = configs.get(arch).reduced()
            model = Model(cfg, device="cpu", mesh=mesh)
            if f32:
                model = model.float()
            convert.model_params_from_numpy(model, trees[arch, shape[1]])
            toks, steps = _inputs(cfg)
            rows = lambda a: model.local_rows(torch.from_numpy(a))   # noqa: E731
            pre, _ = serve.jit_prefill(model, mesh, MAX_LEN)
            log, caches = pre(None, {"tokens": rows(toks)})
            logits = [log]
            dec, _, _ = serve.jit_decode_step(model, mesh, B, MAX_LEN)
            for k in range(DECODE):
                log, caches = dec(None, caches, rows(steps[k]))
                logits.append(log)
            masked, _, _ = serve.jit_masked_decode_step(model, mesh, B, MAX_LEN)
            for k in range(DECODE, DECODE + MASKED):
                log, caches = masked(None, caches, rows(steps[k]), torch.tensor(ACTIVE))
                logits.append(log)
            out[f32, arch] = dict(
                logits=[x.clone() for x in logits],
                caches=tree_map(lambda x: x.float().numpy(), caches),
                layout=(model.cfg.attn_layout, model.cfg.heads_padded),
                params=_shapes(model.param_tree()), cache_shapes=_shapes(caches))
    torch.save(out, f"{tmp}/rank{rank}.pt")


def _reference(jx, arch: str, m: int, f32: bool):
    """The JAX package's unsharded Model(cfg, tp_size=m): prefill, decode
    and masked steps on the test's inputs. Returns (logits, final caches)."""
    jax, jnp = jx["jax"], jx["jnp"]
    from repro.launch.mesh import make_mesh
    from repro.runtime import serve as jserve
    jm = jx["Model"](jx["configs"].get(arch).reduced(), remat=False, tp_size=m)
    params = jax.tree.map(jnp.asarray, jx["trees"][arch, m])
    mesh = make_mesh((1, 1), ("data", "model"))
    toks, steps = _inputs(jm.cfg)
    log, c = jserve.jit_prefill(jm, mesh, MAX_LEN)[0](params, {"tokens": jnp.asarray(toks)})
    logits = [log]
    dec = jserve.jit_decode_step(jm, mesh, B, MAX_LEN)[0]
    for k in range(DECODE):
        log, c = dec(params, c, jnp.asarray(steps[k]))
        logits.append(log)
    masked = jserve.jit_masked_decode_step(jm, mesh, B, MAX_LEN)[0]
    for k in range(DECODE, DECODE + MASKED):
        log, c = masked(params, c, jnp.asarray(steps[k]), jnp.asarray(ACTIVE))
        logits.append(log)
    return ([np.asarray(x, np.float32) for x in logits],
            jax.tree.map(lambda x: np.asarray(x, np.float32), c), jm)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import Model as JModel
    jx = dict(jax=jax, jnp=jnp, configs=jconfigs, Model=JModel)
    tms = sorted({m for _, m in MESHES})
    jx["trees"] = trees = {
        (arch, m): jax.tree.map(np.asarray, JModel(jconfigs.get(arch).reduced(), tp_size=m)
                                .init(jax.random.PRNGKey(0)))
        for arch in ARCHS for m in tms}
    tmp = tmp_path_factory.mktemp("tp_serve")
    failed = []

    def ranks():
        for shape in MESHES:
            d = tmp / "x".join(map(str, shape))
            d.mkdir()
            try:
                tmesh.spawn(serve_rank, shape[0] * shape[1], (shape, trees, str(d)),
                            init_method=f"file://{d / 'rendezvous'}", device="cpu")
            except Exception as e:  # surfaced below
                failed.append(e)
    thread = threading.Thread(target=ranks)
    thread.start()
    refs = {}
    for f32 in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if f32:
                for name in ("attention", "layers", "recurrent"):
                    mp.setattr(importlib.import_module(f"repro.models.{name}"),
                               "COMPUTE_DTYPE", jnp.float32)
            for arch in ARCHS:
                for m in tms:
                    refs[f32, arch, m] = _reference(jx, arch, m, f32)
    thread.join(timeout=240)
    assert not thread.is_alive(), "the ranks did not finish in 240 s"
    if failed:
        raise failed[0]
    got = {shape: [torch.load(tmp / "x".join(map(str, shape)) / f"rank{r}.pt",
                              weights_only=False) for r in range(shape[0] * shape[1])]
           for shape in MESHES}
    return dict(jax=jax, refs=refs, ranks=got)


def _rows(coord: dict, shape: tuple) -> slice:
    n = B // shape[0]
    return slice(coord["data"] * n, (coord["data"] + 1) * n)


def _check_logits(case, shape, arch, f32):
    want, _, _ = case["refs"][f32, arch, shape[1]]
    worst = 0.0
    for rk in case["ranks"][shape]:
        rows = _rows(rk["coord"], shape)
        got = rk[f32, arch]["logits"]
        assert len(got) == len(want)
        for k, (g, w) in enumerate(zip(got, want)):
            g, w = g.float().numpy(), w[rows]
            if k >= 1 + DECODE:            # a masked step: the idle slot is garbage
                keep = np.asarray(ACTIVE)[rows]
                g, w = g[keep], w[keep]
            assert g.shape == w.shape, (arch, shape, k)
            err = np.abs(g - w)
            if f32:
                scale = np.maximum(np.abs(w).max(-1, keepdims=True), 1.0)
                worst = max(worst, float((err / scale).max()))
                assert worst <= F32_TOL, (arch, shape, k, worst)
            else:
                bound = BF16_TOL * max(1.0, float(np.abs(w).max()))
                worst = max(worst, float(err.max()) / bound)
                assert float(err.max()) <= bound, (arch, shape, k, float(err.max()), bound)
    return worst


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_float32_logits_match_the_unsharded_reference(case, shape, arch):
    worst = _check_logits(case, shape, arch, True)
    print(f"{arch} on {shape}: float32 logits within {worst:.2e} of each row's scale")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_bf16_logits_match_the_unsharded_reference(case, shape, arch):
    worst = _check_logits(case, shape, arch, False)
    print(f"{arch} on {shape}: bf16 logits at {worst:.3f} of the 0.05 bound")


def _sizes(shape):
    return {"data": shape[0], "model": shape[1]}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_float32_caches_reassembled_match_the_reference(case, shape, arch):
    """Every cache leaf after the last masked step, put together whole from
    the ranks' shards at the slices cache_shardings assigns them."""
    from repro_torch.runtime import sharding
    jax = case["jax"]
    _, want, jm = case["refs"][True, arch, shape[1]]
    want_np = {"stages": want["stages"], "pos": want["pos"]}
    sizes = _sizes(shape)
    shard = sharding.cache_shardings(sizes, want_np, jm.cfg)
    whole = jax.tree.map(lambda x: np.full(x.shape, np.nan, np.float32), want_np)
    for rk in case["ranks"][shape]:
        sharding.map_shardings(
            lambda sh, dst, src: dst.__setitem__(
                sharding.local_slice(dst.shape, sh.spec, sizes, rk["coord"]), src),
            shard, whole, rk[True, arch]["caches"])
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_np),
                            jax.tree.leaves(whole), strict=True):
        assert not np.isnan(g).any(), path
        err = float(np.abs(g - w).max())
        assert err <= F32_TOL * max(1.0, float(np.abs(w).max())), (arch, shape, path, err)


@pytest.mark.parametrize("shape", MESHES)
def test_each_rank_holds_its_placements_shard(case, shape):
    """Every parameter leaf's local shape is its tree_shardings spec's on the
    whole leaf, every cache leaf's its cache_shardings spec's; the layout is
    the reference's Model(cfg, tp_size=M)'s."""
    from repro_torch.models import Model
    from repro_torch.runtime import sharding
    sizes = _sizes(shape)
    for arch in ARCHS:
        ref_cfg = case["refs"][True, arch, shape[1]][2].cfg
        model = Model(configs.get(arch).reduced(), device="meta", tp_size=shape[1])
        params = [sharding.local_shape(tuple(x.shape), sh.spec, sizes) for sh, x in zip(
            sharding.sharding_leaves(sharding.tree_shardings(sizes, model.specs(),
                                                             model.param_shapes())),
            tree_flatten(model.param_shapes())[0], strict=True)]
        whole = model._make_caches(B, MAX_LEN, "meta")
        caches = [sharding.local_shape(tuple(x.shape), sh.spec, sizes) for sh, x in zip(
            sharding.sharding_leaves(sharding.cache_shardings(sizes, whole, model.cfg)),
            tree_flatten(whole)[0], strict=True)]
        for rk in case["ranks"][shape]:
            got = rk[True, arch]
            assert got["layout"] == (ref_cfg.attn_layout, ref_cfg.heads_padded)
            assert got["params"] == params, (arch, shape)
            assert got["cache_shapes"] == caches, (arch, shape)
