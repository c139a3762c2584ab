"""Tensor-parallel training of the MoE and xLSTM families on the CPU:
runtime.train.jit_train_step on ("data", "model") meshes of gloo ranks,
the model built on the mesh (Model(cfg, mesh=, trainable=True): each rank
its float32 shard), against the JAX package's unsharded make_train_step on
Model(cfg, tp_size=M), with the bounds of tests/test_torch_tp_train.py.
This file holds the machinery (run_train_case and the checks), which
tests/test_torch_tp_train_vlm_audio.py reuses for the vision and audio
families.

  * deepseek-moe-16b reduced (8 experts top-2, a shared expert, a dense
    first layer, four KV heads) on (1, 2): grouped attention, the experts
    split (each rank 4 whole experts; the tokens and the gates enter the
    rank's experts, the router reads the tokens as they are and stays
    WHOLE); on (1, 3): the flat layout with Hp 6 and every MoE leaf whole
    (the MoE issues no collective); on (2, 2): the experts split and the
    batch in two row blocks sharing one capacity and one aux loss (the
    router's statistics summed over the blocks, moe._batch_aux);
  * xlstm-125m reduced (mLSTM, sLSTM, mLSTM) on (1, 2), its 4 heads split
    (wi / wf / r_zifo SPLIT on heads), and on (1, 3), every leaf whole;
  * xlstm-125m with head_dim 48 (a test variant, dataclasses.replace in
    both packages) on (1, 3): the projections (192, 768) split while the
    4 heads do not, the split that cuts heads: each gathered projection
    enters again and the whole wi / wf / r_zifo get per-rank partial
    gradients (PARTIAL), summed by the train step.

Both packages train at the capacity factor 1.25, where slots drop. Each
MoE layer's dropped slots, logged once a layer on every rank around the
gradient pass (moe.drop_log: the remat recompute logs none), equal the
reference's, read off its router's choices in a forward at the same
params and batch (a jax.debug.callback). In bf16 a near-tie of the
router flips a choice between the packages (ROADMAP.md section 3), so the
bf16 MoE case routes as the reference did (TrainPinned: its choices
pinned on every rank, in the forward and again in the remat recompute,
the gates the port's own) and counts the flips.

Both packages start from the same state: the reference's
Model.init(PRNGKey(0)) parameters (edited by a case's ``edit``), moments
drawn from a numpy seed and step counters at 100, carried to every rank by
convert.train_state_from_numpy (each rank cuts its shard: experts on dim
0, heads, columns). Bounds: in float32 compute the loss (and the MoE aux
loss) and the global norm within 1e-5 relative; every gradient leaf,
reassembled whole from the ranks' shards, within 1e-5 of its largest
|value| (a one-element leaf, a cross block's xgate, of its block's
largest: test_torch_train.block_scaled_leafwise); after each of 2 steps
every moment leaf within 1e-5 the same way and every parameter within
tests/test_torch_train_dp.py's summed adamw_bound. In bf16, one step on
(1, 2): its loss and every gradient leaf within 0.05 of the largest
magnitude of the reference's first gradient pass. Every rank's parameter
has exactly the local shape its placement assigns. On (2, 2) ZeRO-1 on
and off are bit-equal. On (1, 1) the step on the mesh is bit-equal to
make_train_step without one (a case of each family). No step
on any mesh raises torch's warning that a c10d collective has no autograd
kernel. On (2, 2) tp.TP.rows_sum's backward is the sum of the ranks'
vector-Jacobian products. launch/train.py --mesh 1x2 --reduced for each
arch: 3 steps, and 2 steps resumed for a third, their final checkpoints
bit-equal, equal to the ranks' shards put together and restored on no
mesh.

Each mesh's ranks start once for the module (launch.mesh.spawn, a thread a
mesh); the JAX references run in this process meanwhile, each compiled
once (a case whose layout is the same at every M shares one).
"""
import contextlib
import importlib
import shutil
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp_serve import _dropped, _wait_for, case_cfg, pairs  # noqa: E402
from test_torch_tp_train import NO_AUTOGRAD, START, STEPS, _carried, _detached, _f32  # noqa: E402
from test_torch_train import block_scaled_leafwise  # noqa: E402
from test_torch_train_dp import _params_within_bound  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.core.types import tree_flatten, tree_unflatten  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402

BATCH, SEQ = 4, 32
CAPACITY = 1.25                   # the default capacity factor, where slots drop
LAUNCH = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "32", "--log-every", "1",
          "--ckpt-every", "100", "--mesh", "1x2"]
REF_MODULES = ("attention", "blocks", "layers", "model", "moe", "recurrent", "xlstm")

# case name -> (arch, config overrides)
CASES = {
    "deepseek-moe-16b": ("deepseek-moe-16b", {}),
    "xlstm-125m": ("xlstm-125m", {}),
    "xlstm-125m hd48": ("xlstm-125m", {"head_dim": 48}),
}
MESHES = {
    (1, 2): ("deepseek-moe-16b", "xlstm-125m"),
    (1, 3): ("deepseek-moe-16b", "xlstm-125m", "xlstm-125m hd48"),
    (2, 2): ("deepseek-moe-16b",),
}
PAIRS = pairs(MESHES)
BF16 = ("deepseek-moe-16b", "xlstm-125m")          # one bf16 step each on (1, 2)
ZERO1 = ("deepseek-moe-16b",)                      # ZeRO-1 on and off on (2, 2)
LAUNCHED = ("deepseek-moe-16b", "xlstm-125m")      # launch/train.py --mesh 1x2


def batches(cfg, n: int = 2) -> list:
    """The compared steps' batches, with the launcher's frontend."""
    fs = launch_train.frontend_shape(cfg, SEQ)
    return [make_batch(0, s, BATCH, SEQ, cfg.vocab_size, fs, device="cpu") for s in STEPS[:n]]


class TrainPinned:
    """Within a with-block, each moe._router call takes the reference's
    expert choices for this rank's rows (``layers``: one forward's (N, k)
    arrays over the whole batch, a MoE layer each; ``block``: this rank's
    row block), the gates being its own router probabilities at them,
    normalised as the router does. A gradient pass under remat calls the
    routers of its n MoE layers in order, then again in reverse order in
    the backward's recompute: call c of each 2n takes layer c, or 2n-1-c.
    ``flips`` counts the (token, layer) choices a forward would have made
    otherwise."""

    def __init__(self, layers: list, block: int):
        self.layers, self.block, self.calls, self.flips = layers, block, 0, 0

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe._router
        n = len(self.layers)

        def router(p, xt, cfg):
            gates, idx, aux = self.orig(p, xt, cfg)
            c = self.calls % (2 * n)
            self.calls += 1
            rows = xt.shape[0]
            pin = torch.from_numpy(self.layers[c if c < n else 2 * n - 1 - c]
                                   [self.block * rows:(self.block + 1) * rows]).to(idx)
            if c < n:
                self.flips += int((torch.sort(idx, -1)[0] != torch.sort(pin, -1)[0])
                                  .any(-1).sum())
            probs = torch.softmax((xt @ p["router"].to(moe.COMPUTE_DTYPE)).float(), -1)
            g = probs.gather(1, pin)
            return g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9), pin, aux

        moe._router = router
        return self

    def __exit__(self, *exc):
        self.moe._router = self.orig


def train_steps(mesh, cfg, carried, n_steps: int, zero1s=(False,)) -> dict:
    """On this rank: the loss, aux, dropped slots and gradients (its shards)
    at the carried state, then n_steps of jit_train_step for each zero1,
    the state gathered whole (convert.train_state_whole) after each step."""
    from repro_torch.models import moe
    from repro_torch.runtime import train as rt
    out: dict = {}
    for zero1 in zero1s:
        model = Model(cfg, device="cpu", trainable=True, mesh=mesh, moe_capacity=CAPACITY)
        state = convert.train_state_from_numpy(model, *carried)
        bs = batches(cfg, n_steps)
        if not zero1:
            with moe.drop_log() as log:
                nll, aux, g = rt._dp_loss_and_grads(model, rt._DataParallel(mesh), bs[0], 1, 0)
            out.update(nll=float(nll), aux=float(aux), drops=[int(d) for d in log],
                       grads=_detached(tree_flatten(g)[0]), slices=model.param_slices(),
                       kinds=model.grad_kinds(),
                       shapes=[tuple(p.shape) for p in tree_flatten(model.param_tree())[0]])
        step = rt.jit_train_step(model, mesh, zero1=zero1)[0](
            {k: v.shape for k, v in bs[0].items()})
        reads = []
        for b in bs:
            state, met = step(state, b)
            whole = convert.train_state_whole(model, state)
            reads.append(dict(params=_detached(tree_flatten(whole.params)[0]),
                              m=_detached(tree_flatten(whole.opt.m)[0]),
                              v=_detached(tree_flatten(whole.opt.v)[0]),
                              metrics={k: float(x) for k, x in met.items()},
                              step=int(state.step)))
        out[f"zero1={zero1}"] = reads
    return out


def set_xgates(model, value: float = 0.5) -> None:
    """Every cross block's xgate to ``value`` (the init's 0 gives its
    weights no gradient)."""
    with torch.no_grad():
        for layers in model.stage_layers:
            for blk in layers:
                if "xgate" in blk.p.tree():
                    blk.p.tree()["xgate"].fill_(value)


def one_device(mesh, cfgs: dict) -> dict:
    """On a (1, 1) mesh: 2 steps of each config (bf16) on the mesh against
    make_train_step on a model without one, from the same init (xgates at
    0.5): are the params, moments and metrics bit-equal?"""
    from repro_torch.runtime import train as rt
    out = {}
    for name, cfg in cfgs.items():
        runs = []
        for on_mesh in (False, True):
            model = Model(cfg, device="cpu", trainable=True, mesh=mesh if on_mesh else None,
                          moe_capacity=CAPACITY)
            state = rt.init_state(model, torch.Generator().manual_seed(0))
            set_xgates(model)
            state = state._replace(step=torch.tensor(START, dtype=torch.int32))
            bs = batches(cfg)
            step = (rt.jit_train_step(model, mesh)[0]({k: v.shape for k, v in bs[0].items()})
                    if on_mesh else rt.make_train_step(model))
            mets = []
            for b in bs:
                state, met = step(state, b)
                mets.append({k: float(x) for k, x in met.items()})
            runs.append((_detached(tree_flatten(state)[0]), mets))
        (a, ma), (b, mb) = runs
        out[name] = ma == mb and all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
    return out


def rows_sum_check(mesh) -> float:
    """tp.TP.rows_sum on this rank (a batch split into row blocks over
    "data"): its value, and its input gradient against the gradient of the
    same function of every block's input taken in one process (the sum of
    the ranks' vector-Jacobian products): the worst |difference|."""
    from repro_torch.models import tp as ttp
    tp = ttp.TP.on_mesh(mesh, {})
    n, blk = tp.rows
    gen = torch.Generator().manual_seed(9)
    xs = torch.randn(n, 5, generator=gen, dtype=torch.float64)   # each block's input
    w = torch.randn(5, generator=gen, dtype=torch.float64)
    x = xs.clone().requires_grad_(True)
    (torch.sin(x.sum(0)) * w).sum().backward()
    mine = xs[blk].clone().requires_grad_(True)
    total = tp.rows_sum(mine)
    (torch.sin(total) * w).sum().backward()
    return max(float((total.detach() - xs.sum(0)).abs().max()),
               float((mine.grad - x.grad[blk]).abs().max()))


def launch_runs(tmp: str, mesh, arch: str) -> dict:
    """launch/train.py --arch ``arch`` --mesh 1x2 under this group: 3 steps
    into tmp/<arch>/a; 2 steps into tmp/<arch>/b and a restart that trains
    the third. This rank's final state of run a as its shards, and where
    they sit."""
    argv = LAUNCH + ["--arch", arch]
    base = f"{tmp}/{arch}"
    full = launch_train.main(argv + ["--steps", "3", "--ckpt-dir", f"{base}/a"])
    first = launch_train.main(argv + ["--steps", "2", "--ckpt-dir", f"{base}/b"])
    again = launch_train.main(argv + ["--steps", "1", "--ckpt-dir", f"{base}/b"])
    model = Model(configs.get(arch).reduced(), device="meta", trainable=True, mesh=mesh)
    st = full["state"]
    return dict(losses=(full["losses"], first["losses"], again["start"], again["losses"]),
                shards=[_detached(tree_flatten(t)[0]) for t in (st.params, st.opt.m,
                                                                 st.opt.v)],
                slices=model.param_slices())


def train_rank(rank: int, shape: tuple, spec: dict, carried: dict, tmp: str) -> None:
    """One rank of a ``shape`` mesh: what the module's tests read, written to
    tmp/rank<r>.pt. ``spec``: the module's cases, meshes, bf16 cases,
    ZeRO-1 cases and launched archs, and where each bf16 MoE case's
    reference routes are written."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import tp as ttp
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    coord = ttp.mesh_coord(mesh)
    out = {"coord": coord}
    cases = spec["cases"]
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=NO_AUTOGRAD)
        if shape == (1, 1):
            out["one"] = one_device(mesh, {name: case_cfg(configs, cases, name)
                                           for name in spec["one"]})
        else:
            if shape == (1, 2):
                out["launch"] = {arch: launch_runs(tmp, mesh, arch) for arch in spec["launch"]}
            if shape[0] > 1:
                out["rows_sum"] = rows_sum_check(mesh)
            for f32 in ((True, False) if shape == (1, 2) else (True,)):
                for name in spec["meshes"][shape]:
                    if not f32 and name not in spec["bf16"]:
                        continue
                    cfg = case_cfg(configs, cases, name)
                    pinned = spec["pins"].get(name) if not f32 else None
                    with pytest.MonkeyPatch.context() as mp:
                        if f32:
                            _f32(mp, "repro_torch.models", torch.float32)
                        pin = (TrainPinned(_wait_for(pinned), coord["data"]) if pinned
                               else contextlib.nullcontext())
                        with pin:
                            out[f32, name] = train_steps(
                                mesh, cfg, carried[name, shape[1]], 2 if f32 else 1,
                                (False, True) if shape[0] > 1 and name in spec["zero1"]
                                else (False,))
                        out[f32, name]["flips"] = getattr(pin, "flips", 0)
    torch.save(out, f"{tmp}/rank{rank}.pt")


def reference(jx, jm, carried, n_steps: int) -> list:
    """n_steps of the reference's make_train_step from ``carried`` on the
    test's batches (with the launcher's frontend), each with the loss, aux
    and gradients at its starting params; with n_steps 0, the loss, aux and
    gradients of the first batch alone (no step compiled)."""
    jax, jnp, jtrain = jx["jax"], jx["jnp"], jx["train"]
    from repro.optim.adamw import AdamWState
    train_step = jtrain.make_train_step(jm)

    def grads_of(st, b):
        (_, (loss, aux)), grads = jax.value_and_grad(
            lambda p: jtrain.loss_fn(jm, p, b), has_aux=True)(st.params)
        return loss, aux, grads

    @jax.jit
    def step_and_grads(st, b):
        return train_step(st, b), grads_of(st, b)

    params, m, v, opt_step, step = jax.tree.map(jnp.asarray, carried)
    st = jtrain.TrainState(params=params, opt=AdamWState(step=opt_step, m=m, v=v), step=step)
    fs = launch_train.frontend_shape(jm.cfg, SEQ)
    batches = [jx["make_batch"](0, s, BATCH, SEQ, jm.cfg.vocab_size, fs) for s in STEPS]
    if not n_steps:
        loss, aux, grads = jax.jit(grads_of)(st, batches[0])
        return [dict(grads=grads, loss=float(loss), aux=float(aux))]
    refs = []
    for b in batches[:n_steps]:
        before = st
        (st, met), (loss, aux, grads) = step_and_grads(st, b)
        refs.append(dict(before=before, state=st, grads=grads, loss=float(loss),
                         aux=float(aux), metrics={k: float(x) for k, x in met.items()}))
    return refs


def reference_routes(jx, jm, params) -> list:
    """The reference router's choices (N, k) by MoE layer in a forward of
    the first compared batch at ``params`` (a jax.debug.callback)."""
    jax, jnp = jx["jax"], jx["jnp"]
    from repro.models import moe as jmoe
    seen: list = []
    router = jmoe._router

    def routed(p, xt, cfg):
        gates, idx, aux = router(p, xt, cfg)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx, ordered=True)
        return gates, idx, aux

    fs = launch_train.frontend_shape(jm.cfg, SEQ)
    batch = jx["make_batch"](0, STEPS[0], BATCH, SEQ, jm.cfg.vocab_size, fs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "_router", routed)
        jax.block_until_ready(jax.jit(lambda p, b: jm.train_logits(p, b)[0])(
            jax.tree.map(jnp.asarray, params), batch))
        jax.effects_barrier()
    return list(seen)


def run_train_case(tmp_path_factory, cases: dict, meshes: dict, bf16: tuple, zero1: tuple,
                   launched: tuple, edit=None) -> dict:
    """The module's fixture: every mesh's ranks (a thread each spawns them,
    (1, 1) included) and, meanwhile, the references: the bf16 MoE cases'
    routes first (their ranks wait for them), then each case's steps (a
    case whose layout is the same at every M shares one), each MoE case's
    routes and drops. ``edit(jx, jm, tree)`` changes the reference's init
    parameters before both packages get them."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.data import make_batch as jmake_batch
    from repro.models import Model as JModel
    from repro.runtime import train as jtrain
    jx = dict(jax=jax, jnp=jnp, train=jtrain, make_batch=jmake_batch)
    wanted = sorted({(name, shape[1]) for shape, name in pairs(meshes)})

    def jmodel(name, m):
        return JModel(case_cfg(jconfigs, cases, name), remat=True, moe_capacity=CAPACITY,
                      tp_size=m)
    carried, inits = {}, {}
    for name, m in wanted:      # a layout that is the same at every M shares one
        jm = jmodel(name, m)
        key = (name, jm.cfg.attn_layout, jm.cfg.heads_padded)
        if key not in inits:
            params, mom, v, t0, t1 = _carried(jax, jm)
            if edit is not None:
                params = jax.tree.map(np.asarray, edit(jx, jm, params))
            inits[key] = (params, mom, v, t0, t1)
        carried[name, m] = inits[key]
    moe = {name for name, _ in wanted if case_cfg(jconfigs, cases, name).family == "moe"}
    tmp = tmp_path_factory.mktemp("tp_train")
    pins = {name: str(tmp / f"routes {name}.pt") for name in moe if name in bf16}
    # (1, 1): a case of each family (the head_dim-48 variant takes xlstm's
    # path at M = 1)
    one = tuple({case_cfg(jconfigs, cases, n).family: n for n in reversed(cases)}.values())
    spec = dict(cases=cases, meshes=meshes, bf16=bf16, zero1=zero1, launch=launched,
                one=one, pins=pins)
    failed = []

    def ranks(shape):
        d = tmp / "x".join(map(str, shape))
        d.mkdir()
        try:
            tmesh.spawn(train_rank, shape[0] * shape[1], (shape, spec, carried, str(d)),
                        init_method=f"file://{d / 'rendezvous'}", device="cpu")
        except Exception as e:  # surfaced below
            failed.append(e)
    t0 = time.monotonic()
    shapes = ((1, 1),) + tuple(meshes)
    threads = [threading.Thread(target=ranks, args=(shape,)) for shape in shapes]
    for t in threads:
        t.start()
    refs, routes, done = {}, {}, {}
    for f32 in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if f32:
                for mod in REF_MODULES:
                    mp.setattr(importlib.import_module(f"repro.models.{mod}"),
                               "COMPUTE_DTYPE", jnp.float32)
            for name, m in sorted(wanted, key=lambda nm: nm[0] not in pins):
                if not f32 and (name not in bf16 or m != 2):
                    continue
                jm = jmodel(name, m)
                key = (f32, name, jm.cfg.attn_layout, jm.cfg.heads_padded)
                if name in moe:
                    routes[f32, name, m] = reference_routes(jx, jm, carried[name, m][0])
                    if not f32 and name in pins:
                        torch.save(routes[f32, name, m], pins[name] + ".part")
                        (tmp / f"routes {name}.pt.part").rename(pins[name])
                if key not in done:     # bf16: the gradients of one pass
                    done[key] = reference(jx, jm, carried[name, m], 2 if f32 else 0)
                refs[f32, name, m] = done[key]
    t_refs = time.monotonic() - t0
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "the ranks did not finish in 300 s"
    if failed:
        raise failed[0]
    got = {shape: [torch.load(tmp / "x".join(map(str, shape)) / f"rank{r}.pt",
                              weights_only=False) for r in range(shape[0] * shape[1])]
           for shape in shapes}
    print(f"references {t_refs:.1f} s, ranks {time.monotonic() - t0:.1f} s")
    return dict(jax=jax, jcfgs=jconfigs, refs=refs, routes=routes, ranks=got, tmp=tmp,
                cases=cases, spec=spec)


def _port_model(case, name: str, m: int):
    return Model(case_cfg(configs, case["cases"], name), device="meta", trainable=True,
                 tp_size=m)


def _port_tree(case, name: str, m: int, leaves: list):
    """Whole leaves (in tree_flatten order) as the tree of the unsharded
    port model of the same layout."""
    return tree_unflatten(tree_flatten(_port_model(case, name, m).param_tree())[1], leaves)


def _assembled(case, shape, f32: bool, name: str):
    """The gradient reassembled whole from every rank's shard (each written
    at the slice its placement assigns); no element left unwritten."""
    model = _port_model(case, name, shape[1])
    leaves = [torch.full(tuple(x.shape), float("nan"))
              for x in tree_flatten(model.param_shapes())[0]]
    for rk in case["ranks"][shape]:
        for whole, g, cut in zip(leaves, rk[f32, name]["grads"], rk[f32, name]["slices"],
                                 strict=True):
            whole[cut] = g
    assert not any(bool(torch.isnan(x).any()) for x in leaves)
    return _port_tree(case, name, shape[1], leaves)


def check_grads(case, shape, name) -> float:
    """float32: the loss and the aux loss on every rank within 1e-5 of the
    reference's, and every gradient leaf reassembled whole within 1e-5 of
    its largest value."""
    ref = case["refs"][True, name, shape[1]][0]
    worst = block_scaled_leafwise(case["jax"], ref["grads"], _assembled(case, shape, True, name),
                                  1e-5, f"{name} {shape} gradient")
    for rk in case["ranks"][shape]:
        np.testing.assert_allclose(rk[True, name]["nll"], ref["loss"], rtol=1e-5)
        assert abs(rk[True, name]["aux"] - ref["aux"]) <= 1e-5 * max(1.0, abs(ref["aux"]))
    return worst


def check_steps(case, shape, name) -> None:
    """Two steps: the loss, aux, global norm and learning rate, the moments
    and the parameters (gathered whole) against the reference's, on every
    rank."""
    jax, refs = case["jax"], case["refs"][True, name, shape[1]]
    for rk in case["ranks"][shape]:
        for i, (ref, got) in enumerate(zip(refs, rk[True, name]["zero1=False"], strict=True)):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-5)
            assert abs(got["metrics"]["aux"] - ref["metrics"]["aux"]) <= \
                1e-5 * max(1.0, abs(ref["metrics"]["aux"]))
            assert got["metrics"]["lr"] == pytest.approx(ref["metrics"]["lr"], rel=1e-6)
            assert got["step"] == START + 1 + i
            for part in ("m", "v"):
                block_scaled_leafwise(jax, getattr(ref["state"].opt, part),
                                      _port_tree(case, name, shape[1], got[part]), 1e-5,
                                      f"{name} {shape} step {i} {part}")
            _params_within_bound(jax, refs[:i + 1],
                                 _port_tree(case, name, shape[1], got["params"]),
                                 f"{name} {shape} step {i}")


def check_bf16(case, name) -> float:
    """bf16 on (1, 2): the loss and every gradient leaf within 0.05 of the
    largest magnitude (the JAX package's bound for two paths of one bf16
    model)."""
    ref = case["refs"][False, name, 2][0]
    worst = block_scaled_leafwise(case["jax"], ref["grads"], _assembled(case, (1, 2), False, name),
                                  0.05, f"{name} bf16 gradient")
    for rk in case["ranks"][1, 2]:
        loss = rk[False, name]["zero1=False"][0]["metrics"]["loss"]
        assert abs(loss - ref["loss"]) <= 0.05 * max(1.0, abs(ref["loss"]))
    return worst


def check_placements(case, shape, name) -> None:
    """Every rank's parameter leaves have exactly the local shapes that
    tree_shardings assigns the whole leaves of the unsharded model."""
    from repro_torch.runtime import sharding
    sizes = {"data": shape[0], "model": shape[1]}
    model = _port_model(case, name, shape[1])
    whole = model.param_shapes()
    want = [sharding.local_shape(tuple(x.shape), sh.spec, sizes) for sh, x in zip(
        sharding.sharding_leaves(sharding.tree_shardings(sizes, model.specs(), whole)),
        tree_flatten(whole)[0], strict=True)]
    for rk in case["ranks"][shape]:
        assert rk[True, name]["shapes"] == want, (name, shape)


def check_drops(case, shape, name) -> None:
    """Each MoE layer's dropped slots on every rank equal the reference's for
    its router's choices at the same params (float32 routing freely; bf16
    routed as the reference did, its other choices counted)."""
    for f32 in (True, False) if shape == (1, 2) and name in case["spec"]["bf16"] else (True,):
        jm_cfg = case_cfg(case["jcfgs"], case["cases"], name)
        want = [_dropped(i, jm_cfg) for i in case["routes"][f32, name, shape[1]]]
        for rk in case["ranks"][shape]:
            assert rk[f32, name]["drops"] == want, (name, shape, f32)
            if f32:
                assert rk[f32, name]["flips"] == 0
        assert sum(want) > 0, "no slot dropped: the capacity is not exercised"


def check_zero1(case, name) -> None:
    for rk in case["ranks"][2, 2]:
        off, on = rk[True, name]["zero1=False"], rk[True, name]["zero1=True"]
        for a, b in zip(off, on, strict=True):
            assert a["metrics"] == b["metrics"]
            for part in ("params", "m", "v"):
                assert all(torch.equal(x, y) for x, y in zip(a[part], b[part],
                                                              strict=True)), (name, part)


def check_launch(case, arch: str, tmp_path) -> None:
    """--mesh 1x2 --arch ``arch``: the run of 3 steps and the run of 2
    resumed for a third log the same losses and leave the same final
    checkpoint, every leaf bit-equal; that checkpoint holds whole tensors
    equal to the ranks' shards put together, restores on no mesh with every
    leaf bit-equal, and the entry point on one device resumes from it."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.runtime import train as rt
    ranks = case["ranks"][1, 2]
    (full, first, start, again) = ranks[0]["launch"][arch]["losses"]
    assert start == 2 and again == {2: full[2]}
    assert [first[s] for s in range(2)] == [full[s] for s in range(2)]
    model = Model(configs.get(arch).reduced(), device="cpu", trainable=True)
    like = rt.init_state(model, torch.Generator().manual_seed(0))
    base = case["tmp"] / "1x2" / arch
    a, label = load_checkpoint(str(base / "a"), like, device="cpu")
    b, _ = load_checkpoint(str(base / "b"), like, step=label, device="cpu")
    assert label == 3 and int(a.step) == 3
    assert all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0],
                                                  strict=True))
    for k, tree in enumerate((a.params, a.opt.m, a.opt.v)):
        for rk in ranks:
            for whole, shard, cut in zip(tree_flatten(tree)[0], rk["launch"][arch]["shards"][k],
                                         rk["launch"][arch]["slices"], strict=True):
                assert torch.equal(whole[cut], shard)
    shutil.copytree(base / "a", tmp_path / "a")
    more = launch_train.main(LAUNCH[:-2] + ["--arch", arch, "--steps", "1", "--ckpt-dir",
                                            str(tmp_path / "a")])
    assert more["start"] == 3 and int(more["state"].step) == 4
    assert np.isfinite(more["losses"][3])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return run_train_case(tmp_path_factory, CASES, MESHES, BF16, ZERO1, LAUNCHED)


@pytest.mark.parametrize("shape,name", PAIRS)
def test_float32_gradients_match_the_unsharded_reference(case, shape, name):
    worst = check_grads(case, shape, name)
    print(f"{name} on {shape}: float32 gradients within {worst:.2e} of each leaf's largest "
          "value")


@pytest.mark.parametrize("shape,name", PAIRS)
def test_float32_steps_match_the_unsharded_reference(case, shape, name):
    check_steps(case, shape, name)


@pytest.mark.parametrize("name", BF16)
def test_bf16_step_on_two_ranks_within_the_reference_bound(case, name):
    worst = check_bf16(case, name)
    flips = [rk[False, name]["flips"] for rk in case["ranks"][1, 2]]
    print(f"{name} bf16 on (1, 2): gradients within {worst:.3e} of each leaf's largest value; "
          f"router choices that differ from the reference's, by rank: {flips}")


@pytest.mark.parametrize("shape,name", PAIRS)
def test_each_rank_holds_its_placements_shard(case, shape, name):
    check_placements(case, shape, name)


@pytest.mark.parametrize("shape", [s for s, names in MESHES.items() if "deepseek-moe-16b" in names])
def test_dropped_slots_equal_the_references(case, shape):
    check_drops(case, shape, "deepseek-moe-16b")


def test_zero1_on_and_off_are_bit_equal_on_two_by_two(case):
    for name in ZERO1:
        check_zero1(case, name)


def test_a_one_device_mesh_is_bit_equal_and_no_step_warns(case):
    """On (1, 1) every case's steps on the mesh equal make_train_step's to
    the bit; every mesh's ranks ran their steps with the missing-autograd
    warning turned into an error (a rank that raised would have failed the
    fixture)."""
    (rk,) = case["ranks"][1, 1]
    assert rk["one"] == {name: True for name in case["spec"]["one"]}
    assert set(rk["one"]) == {"deepseek-moe-16b", "xlstm-125m"}
    assert all(len(case["ranks"][shape]) == shape[0] * shape[1] for shape in MESHES)


def test_rows_sum_backward_is_the_sum_of_the_ranks_vjps(case):
    for rk in case["ranks"][2, 2]:
        assert rk["rows_sum"] <= 1e-12


def test_the_router_is_whole_and_the_cut_heads_gates_partial(case):
    """The kinds each rank's train step read: deepseek's router WHOLE on
    every mesh and its experts SPLIT where they split; xlstm's wi / wf /
    r_zifo SPLIT with the heads (1, 2), PARTIAL where the heads are cut
    (hd48 on (1, 3)), WHOLE where nothing splits (1, 3)."""
    from repro_torch.models.model import PARTIAL, SPLIT, WHOLE

    def kinds(shape, name, leaf):
        model = _port_model(case, name, shape[1])
        names = _leaf_names(model.param_tree())
        got = {case["ranks"][shape][r][True, name]["kinds"][i]
               for r in range(len(case["ranks"][shape]))
               for i, n in enumerate(names) if n.endswith(leaf)}
        assert len(got) == 1, (shape, name, leaf, got)
        return got.pop()

    for shape in ((1, 2), (1, 3), (2, 2)):
        assert kinds(shape, "deepseek-moe-16b", ".moe.router") == WHOLE
    assert kinds((1, 2), "deepseek-moe-16b", ".moe.w1") == SPLIT
    assert kinds((1, 3), "deepseek-moe-16b", ".moe.w1") == WHOLE
    for leaf in (".mlstm.wi", ".mlstm.wf", ".slstm.r_zifo"):
        assert kinds((1, 2), "xlstm-125m", leaf) == SPLIT
        assert kinds((1, 3), "xlstm-125m", leaf) == WHOLE
        assert kinds((1, 3), "xlstm-125m hd48", leaf) == PARTIAL


@pytest.mark.parametrize("arch", LAUNCHED)
def test_launch_on_a_model_axis_resumes_and_restores_on_no_mesh(case, arch, tmp_path):
    check_launch(case, arch, tmp_path)


def _leaf_names(tree, prefix: str = "") -> list:
    """Each leaf's dotted path, in tree_flatten order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}.{i}")]
    return [prefix]
