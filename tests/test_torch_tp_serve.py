"""Tensor-parallel serving on the CPU: runtime/serve.py's jit_prefill,
jit_decode_step and jit_masked_decode_step on ("data", "model") meshes of
gloo ranks (models/tp.py), against the JAX package's unsharded
Model(cfg, tp_size=M) (GSPMD preserves values, so the unsharded program is
the reference, as tests/test_torch_train_dp.py argues for the data axis).
This file holds the machinery (run_case and the checks), which
tests/test_torch_tp_moe_xlstm.py and tests/test_torch_tp_vlm_audio.py
reuse for the other families.

Two reduced models here, their parameters the reference's
Model.init(PRNGKey(0)) (jitted) carried to every rank by
convert.model_params_from_numpy (each rank cuts its shard):
recurrentgemma-9b (rec, rec, attn; one KV head, so the flat layout, K / V
projections split inside the head or replicated, split RG-LRU channels, a
prompt of 96 over the 64-slot window, so the ring roll runs) and
qwen1.5-0.5b (four KV heads: grouped on 2 ranks, flat with Hp = 6 on 3).
Meshes (1, 2), (1, 3) and (2, 2). On (1, 3) the vocab 512, d_ff 256,
RG-LRU width 128, wk and the 64-slot window are replicated and the heads
padded; the qwen cache of 108 slots splits its sequence over 3 ranks, the
recurrentgemma window over 2.

Each mesh's ranks start once for the module (launch.mesh.spawn, a file://
rendezvous under the module's temporary directory; a thread a mesh) and
run every case in float32 (COMPUTE_DTYPE float32 in both packages, stored
weights widened) and in bf16: a prefill of 4 x 96, 4 decode steps and 2
masked steps with slot 1 idle. The JAX references run in this process
meanwhile, each compiled once (a case whose layout is the same at every M
shares one).

Bounds: float32 logits within 1e-5 * max(1, max |logits|) of each row, and
every cache leaf, reassembled whole from the ranks' shards, within 1e-5 *
max(1, max |leaf|); bf16 logits within the JAX package's 0.05 * max(1, max
|logits|), tripled for top-1 routing as tests/test_models.py triples it.
Every rank's parameter and cache leaves have exactly the local shape that
tree_shardings / cache_shardings assign. A bf16 MoE case routes as the
reference did (Pinned: a bf16 near-tie of the router flips a choice
between the packages, the unsharded port as well, ROADMAP.md section 3).
"""
import dataclasses
import importlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, convert  # noqa: E402
from repro_torch.core.types import tree_flatten, tree_map  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import tp as ttp  # noqa: E402

B, S, MAX_LEN, DECODE, MASKED = 4, 96, 108, 4, 2
SF = 16                                    # the reduced configs' frontend tokens
ACTIVE = [True, False, True, True]
PIN_WAIT_S = 200.0
F32_TOL, BF16_TOL = 1e-5, 0.05
MODEL_MODULES = ("layers", "attention", "recurrent", "model", "moe", "xlstm")
REF_MODULES = ("attention", "blocks", "layers", "model", "moe", "recurrent", "xlstm")

def pairs(meshes: dict) -> list:
    return [(shape, name) for shape, names in meshes.items() for name in names]


def case_cfg(cfgs, cases: dict, name: str):
    """The reduced config of a case in either package (``cfgs``: its
    configs module)."""
    arch, over = cases[name]
    return dataclasses.replace(cfgs.get(arch).reduced(), **over)


def inputs(cfg, seed: int = 0):
    """The prompt (B, S), the decode tokens (B, 1) each, and the frontend
    (B, SF, D) of a vlm or audio config (else None)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
             for _ in range(DECODE + MASKED)]
    front = None
    if cfg.family in ("vlm", "audio"):
        front = rng.standard_normal((B, SF, cfg.d_model)).astype(np.float32)
    return toks, steps, front


def _shapes(tree):
    return [tuple(x.shape) for x in tree_flatten(tree)[0]]


class Pinned:
    """Within a with-block, each moe._router call of this rank takes the
    reference's expert choices for its rows (``pins``: each call's list of
    (N, k) arrays over the whole batch, a layer each, consumed in order),
    the gates being
    its own router probabilities at them, normalized as the router does;
    ``flips`` counts the (token, layer) choices it would have made
    otherwise."""

    def __init__(self, pins: list, block: int):
        self.pins = [layer for call in pins for layer in call]
        self.block, self.flips = block, 0

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe._router

        def router(p, xt, cfg):
            gates, idx, aux = self.orig(p, xt, cfg)
            n = xt.shape[0]
            pin = torch.from_numpy(self.pins.pop(0)[self.block * n:(self.block + 1) * n]).to(idx)
            self.flips += int((torch.sort(idx, -1)[0] != torch.sort(pin, -1)[0]).any(-1).sum())
            probs = torch.softmax((xt @ p["router"].to(moe.COMPUTE_DTYPE)).float(), -1)
            g = probs.gather(1, pin)
            return g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9), pin, aux

        moe._router = router
        return self

    def __exit__(self, *exc):
        self.moe._router = self.orig


def _wait_for(path: str):
    """The routes a reference wrote to ``path`` (polled for PIN_WAIT_S)."""
    import os
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > PIN_WAIT_S:
            raise TimeoutError(f"no reference routes at {path} after {PIN_WAIT_S} s")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def serve_rank(rank: int, shape: tuple, cases: dict, names: tuple, trees: dict,
               tmp: str, pins: dict) -> None:
    """One rank of a ``shape`` mesh: for each dtype and case, the model on
    the mesh with the reference's parameters, then the serve steps on this
    rank's rows; a bf16 MoE case routes as the reference did (Pinned; the
    reference's routes read from the file ``pins`` names for it). Writes its
    logits, final caches, dropped slots, flipped choices and leaf shapes to
    tmp/rank<r>.pt."""
    import contextlib

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model, moe
    from repro_torch.runtime import serve
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = {"coord": ttp.mesh_coord(mesh)}
    for f32 in (True, False):
        for name in names:
            cfg = case_cfg(configs, cases, name)
            model = Model(cfg, device="cpu", mesh=mesh)
            with pytest.MonkeyPatch.context() as mp:
                if f32:
                    for mod in MODEL_MODULES:
                        mp.setattr(importlib.import_module(f"repro_torch.models.{mod}"),
                                   "COMPUTE_DTYPE", torch.float32)
                    model = model.float()
                convert.model_params_from_numpy(model, trees[name, shape[1]])
                pin = (Pinned(_wait_for(pins[name, shape[1]]), out["coord"]["data"])
                       if not f32 and (name, shape[1]) in pins else contextlib.nullcontext())
                with pin:
                    out[f32, name] = _serve(model, mesh, cfg, moe)
            out[f32, name]["flips"] = getattr(pin, "flips", 0)
    torch.save(out, f"{tmp}/rank{rank}.pt")


def _serve(model, mesh, cfg, moe) -> dict:
    """The prefill, decode and masked steps on this rank's rows."""
    from repro_torch.runtime import serve
    toks, steps, front = inputs(cfg)
    rows = lambda a: model.local_rows(torch.from_numpy(a))   # noqa: E731
    batch = {"tokens": rows(toks)}
    if front is not None:
        batch["frontend"] = rows(front)
    drops, logits = [], []
    pre, _ = serve.jit_prefill(model, mesh, MAX_LEN)
    dec, _, _ = serve.jit_decode_step(model, mesh, B, MAX_LEN)
    masked, _, _ = serve.jit_masked_decode_step(model, mesh, B, MAX_LEN)
    for k in range(-1, DECODE + MASKED):
        with moe.drop_log() as log:
            if k < 0:
                out, caches = pre(None, batch)
            elif k < DECODE:
                out, caches = dec(None, caches, rows(steps[k]))
            else:
                out, caches = masked(None, caches, rows(steps[k]), torch.tensor(ACTIVE))
        drops.append([int(d) for d in log])
        logits.append(out.clone())
    return dict(logits=logits, drops=drops,
                caches=tree_map(lambda x: x.float().numpy(), caches),
                layout=(model.cfg.attn_layout, model.cfg.heads_padded),
                params=_shapes(model.param_tree()), cache_shapes=_shapes(caches))


def _dropped(idx: np.ndarray, cfg) -> int:
    """The slots the reference's sorted dispatch drops for its router's
    choices idx (N, k) at the default capacity factor: each expert's slots
    past its capacity."""
    from repro_torch.models.moe import capacity
    counts = np.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    return int(np.maximum(counts - capacity(idx.shape[0], cfg, 1.25), 0).sum())


def reference(jx, cases: dict, name: str, m: int):
    """The JAX package's unsharded Model(cfg, tp_size=m): prefill, decode
    and masked steps on the test's inputs. Returns (logits, final caches,
    the model, each call's dropped slots by MoE layer, each call's routes
    by MoE layer)."""
    jax, jnp = jx["jax"], jx["jnp"]
    from repro.launch.mesh import make_mesh
    from repro.models import moe as jmoe
    from repro.runtime import serve as jserve
    jm = jx["Model"](case_cfg(jx["configs"], cases, name), remat=False, tp_size=m)
    params = jax.tree.map(jnp.asarray, jx["trees"][name, m])
    mesh = make_mesh((1, 1), ("data", "model"))
    toks, steps, front = inputs(jm.cfg)
    seen: list = []
    router = jmoe._router

    def routed(p, xt, cfg):
        gates, idx, aux = router(p, xt, cfg)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx, ordered=True)
        return gates, idx, aux

    routes = []

    def call(fn, *args):
        out = jax.block_until_ready(fn(*args))
        jax.effects_barrier()
        routes.append(list(seen))
        seen.clear()
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "_router", routed)
        batch = {"tokens": jnp.asarray(toks)}
        if front is not None:
            batch["frontend"] = jnp.asarray(front)
        log, c = call(jserve.jit_prefill(jm, mesh, MAX_LEN)[0], params, batch)
        logits = [log]
        dec = jserve.jit_decode_step(jm, mesh, B, MAX_LEN)[0]
        masked = jserve.jit_masked_decode_step(jm, mesh, B, MAX_LEN)[0]
        for k in range(DECODE + MASKED):
            if k < DECODE:
                log, c = call(dec, params, c, jnp.asarray(steps[k]))
            else:
                log, c = call(masked, params, c, jnp.asarray(steps[k]), jnp.asarray(ACTIVE))
            logits.append(log)
    drops = [[_dropped(i, jm.cfg) for i in layers] for layers in routes]
    return ([np.asarray(x, np.float32) for x in logits],
            jax.tree.map(lambda x: np.asarray(x, np.float32), c), jm, drops, routes)


def run_case(tmp_path_factory, cases: dict, meshes: dict, edit=None) -> dict:
    """The module's fixture: every mesh's ranks (a thread each spawns them)
    and, meanwhile, each reference once (a case whose layout is the same at
    every M shares one), the bf16 MoE references first: their routes go to
    a file that the ranks' bf16 runs wait for. ``edit(jx, jm, tree)``
    changes the reference's parameters before both packages get them."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import Model as JModel
    jx = dict(jax=jax, jnp=jnp, configs=jconfigs, Model=JModel)
    wanted = sorted({(name, shape[1]) for shape, name in pairs(meshes)})
    trees = {}
    for name, m in wanted:
        jm = JModel(case_cfg(jconfigs, cases, name), tp_size=m)
        tree = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
        trees[name, m] = tree if edit is None else edit(jx, jm, tree)
    jx["trees"] = trees
    tmp = tmp_path_factory.mktemp("tp_serve")
    pins = {(name, m): str(tmp / f"routes {name} {m}.pt") for name, m in wanted
            if case_cfg(jconfigs, cases, name).family == "moe"}
    failed = []

    def ranks(shape, names):
        d = tmp / "x".join(map(str, shape))
        d.mkdir()
        try:
            tmesh.spawn(serve_rank, shape[0] * shape[1],
                        (shape, cases, names, trees, str(d), pins),
                        init_method=f"file://{d / 'rendezvous'}", device="cpu")
        except Exception as e:  # surfaced below
            failed.append(e)
    t0 = time.monotonic()
    threads = [threading.Thread(target=ranks, args=item) for item in meshes.items()]
    for t in threads:
        t.start()
    refs, done = {}, {}
    order = sorted(wanted, key=lambda nm: nm not in pins)
    for f32 in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if f32:
                for mod in REF_MODULES:
                    mp.setattr(importlib.import_module(f"repro.models.{mod}"),
                               "COMPUTE_DTYPE", jnp.float32)
            for name, m in order:
                layout = JModel(case_cfg(jconfigs, cases, name), tp_size=m).cfg
                key = (f32, name, layout.attn_layout, layout.heads_padded)
                if key not in done:
                    done[key] = reference(jx, cases, name, m)
                refs[f32, name, m] = done[key]
                if not f32 and (name, m) in pins:
                    torch.save(done[key][4], pins[name, m] + ".part")
                    (tmp / f"routes {name} {m}.pt.part").rename(pins[name, m])
    t_refs = time.monotonic() - t0
    for t in threads:
        t.join(timeout=240)
        assert not t.is_alive(), "the ranks did not finish in 240 s"
    if failed:
        raise failed[0]
    got = {shape: [torch.load(tmp / "x".join(map(str, shape)) / f"rank{r}.pt",
                              weights_only=False) for r in range(shape[0] * shape[1])]
           for shape in meshes}
    print(f"references {t_refs:.1f} s, ranks {time.monotonic() - t0:.1f} s")
    return dict(jax=jax, refs=refs, ranks=got, cases=cases)


def _rows(coord: dict, shape: tuple) -> slice:
    n = B // shape[0]
    return slice(coord["data"] * n, (coord["data"] + 1) * n)


def check_logits(case, shape, name, f32) -> float:
    want, _, jm = case["refs"][f32, name, shape[1]][:3]
    top1 = jm.cfg.family == "moe" and jm.cfg.top_k == 1
    worst = 0.0
    for rk in case["ranks"][shape]:
        rows = _rows(rk["coord"], shape)
        got = rk[f32, name]["logits"]
        assert len(got) == len(want)
        for k, (g, w) in enumerate(zip(got, want)):
            g, w = g.float().numpy(), w[rows]
            if k >= 1 + DECODE:            # a masked step: the idle slot is garbage
                keep = np.asarray(ACTIVE)[rows]
                g, w = g[keep], w[keep]
            assert g.shape == w.shape, (name, shape, k)
            err = np.abs(g - w)
            if f32:
                scale = np.maximum(np.abs(w).max(-1, keepdims=True), 1.0)
                worst = max(worst, float((err / scale).max()))
                assert worst <= F32_TOL, (name, shape, k, worst)
            else:
                bound = BF16_TOL * max(1.0, float(np.abs(w).max())) * (3.0 if top1 else 1.0)
                worst = max(worst, float(err.max()) / bound)
                assert float(err.max()) <= bound, (name, shape, k, float(err.max()), bound)
    return worst


def check_caches(case, shape, name) -> None:
    """Every cache leaf after the last masked step, put together whole from
    the ranks' shards at the slices cache_shardings assigns them."""
    from repro_torch.runtime import sharding
    jax = case["jax"]
    _, want, jm = case["refs"][True, name, shape[1]][:3]
    sizes = {"data": shape[0], "model": shape[1]}
    shard = sharding.cache_shardings(sizes, want, jm.cfg)
    whole = jax.tree.map(lambda x: np.full(x.shape, np.nan, np.float32), want)
    for rk in case["ranks"][shape]:
        sharding.map_shardings(
            lambda sh, dst, src: dst.__setitem__(
                sharding.local_slice(dst.shape, sh.spec, sizes, rk["coord"]), src),
            shard, whole, rk[True, name]["caches"])
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(whole), strict=True):
        assert not np.isnan(g).any(), path
        err = float(np.abs(g - w).max())
        assert err <= F32_TOL * max(1.0, float(np.abs(w).max())), (name, shape, path, err)


def check_placements(case, shape, name) -> None:
    """Every parameter leaf's local shape is its tree_shardings spec's on the
    whole leaf, every cache leaf's its cache_shardings spec's; the layout is
    the reference's Model(cfg, tp_size=M)'s."""
    from repro_torch.models import Model
    from repro_torch.runtime import sharding
    sizes = {"data": shape[0], "model": shape[1]}
    ref_cfg = case["refs"][True, name, shape[1]][2].cfg
    model = Model(case_cfg(configs, case["cases"], name), device="meta", tp_size=shape[1])
    params = [sharding.local_shape(tuple(x.shape), sh.spec, sizes) for sh, x in zip(
        sharding.sharding_leaves(sharding.tree_shardings(sizes, model.specs(),
                                                         model.param_shapes())),
        tree_flatten(model.param_shapes())[0], strict=True)]
    whole = model._make_caches(B, MAX_LEN, "meta")
    caches = [sharding.local_shape(tuple(x.shape), sh.spec, sizes) for sh, x in zip(
        sharding.sharding_leaves(sharding.cache_shardings(sizes, whole, model.cfg)),
        tree_flatten(whole)[0], strict=True)]
    for rk in case["ranks"][shape]:
        got = rk[True, name]
        assert got["layout"] == (ref_cfg.attn_layout, ref_cfg.heads_padded)
        assert got["params"] == params, (name, shape)
        assert got["cache_shapes"] == caches, (name, shape)
    return params


ARCHS = ("recurrentgemma-9b", "qwen1.5-0.5b")
MESHES = ((1, 2), (1, 3), (2, 2))
CASES = {arch: (arch, {}) for arch in ARCHS}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return run_case(tmp_path_factory, CASES, {shape: ARCHS for shape in MESHES})


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_float32_logits_match_the_unsharded_reference(case, shape, arch):
    worst = check_logits(case, shape, arch, True)
    print(f"{arch} on {shape}: float32 logits within {worst:.2e} of each row's scale")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_bf16_logits_match_the_unsharded_reference(case, shape, arch):
    worst = check_logits(case, shape, arch, False)
    print(f"{arch} on {shape}: bf16 logits at {worst:.3f} of the 0.05 bound")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_float32_caches_reassembled_match_the_reference(case, shape, arch):
    check_caches(case, shape, arch)


@pytest.mark.parametrize("shape", MESHES)
def test_each_rank_holds_its_placements_shard(case, shape):
    for arch in ARCHS:
        check_placements(case, shape, arch)
