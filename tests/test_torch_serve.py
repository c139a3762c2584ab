"""The port's split serving against itself and the JAX package.

  * make_split_serve at every split point of the reduced recurrentgemma
    (3 layers: rec, rec, attn) equals Model.forward to the bit: both run
    the same functions on the same shapes in the same order;
  * at one split point the port's device and edge halves agree with the
    JAX package's make_split_serve halves, on the same parameters, within
    the bf16 model tolerance of test_torch_models.py (2e-2 of each
    position's largest magnitude; the edge halves are fed the same JAX
    activation);
  * transfer_seconds equals the JAX package's exactly, and
    planned_transfer_seconds within 1e-5 relative (float32 rates) on one
    plan handed to both;
  * make_batch's tokens equal the JAX package's exactly;
  * the serving entry point runs end to end on the CPU;
  * the MoE and xLSTM families (reduced deepseek-moe-16b,
    llama4-scout-17b-a16e and xlstm-125m): split serving at every split
    equal to the forward to the bit, the MoE options reaching both halves,
    and the entry point on the CPU for deepseek-moe-16b and xlstm-125m
    (the MoE model built at capacity 4.0, as the JAX driver builds it)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import profiles  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.runtime.serve import (  # noqa: E402
    make_split_serve,
    planned_transfer_seconds,
    transfer_seconds,
)

MODEL_TOL = 2e-2


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import make_env as jmake_env
    from repro.core import profiles as jprofiles
    from repro.data import make_batch as jmake_batch
    from repro.models import Model as JModel
    from repro.runtime import serve as jserve
    return dict(jax=jax, jnp=jnp, configs=jconfigs, make_env=jmake_env,
                profiles=jprofiles, make_batch=jmake_batch, Model=JModel, serve=jserve)


def _rel_check(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    row = np.abs(want).max(axis=-1, keepdims=True)
    worst = float((np.abs(got - want) / np.maximum(row, 1e-30)).max())
    assert worst <= MODEL_TOL, f"{what}: worst {worst:.3e} of the position's max"


def test_split_serve_equals_forward_at_every_split():
    cfg = configs.get("recurrentgemma-9b").reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    tokens = make_batch(0, 0, 2, 96, cfg.vocab_size, device="cpu")["tokens"]
    full, _, _ = model(tokens)
    for s in range(cfg.n_layers + 1):
        progs = make_split_serve(model, s)
        act = progs.device_fn(tokens)
        assert act.dtype == torch.bfloat16 and act.shape == (2, 96, cfg.d_model)
        assert torch.equal(progs.edge_fn(act), full), s
        assert progs.split_layer == s and progs.act_bytes_per_token == 2 * cfg.d_model
    with pytest.raises(ValueError):
        make_split_serve(model, cfg.n_layers + 1)


def test_split_halves_match_the_reference(jx):
    jcfg = jx["configs"].get("recurrentgemma-9b").reduced()
    jm = jx["Model"](jcfg, remat=False)
    params = jm.init(jx["jax"].random.PRNGKey(0))
    model = convert.model_params_from_numpy(
        Model(configs.get("recurrentgemma-9b").reduced(), device="cpu"),
        jx["jax"].tree.map(np.asarray, params))
    tokens = make_batch(2, 0, 2, 80, jcfg.vocab_size, device="cpu")["tokens"]
    s = 2     # device: rec, rec; edge: attn
    jprogs = jx["serve"].make_split_serve(jm, params, s)
    progs = make_split_serve(model, s)
    j_act = jprogs.device_fn(jx["jnp"].asarray(tokens.numpy()))
    _rel_check(progs.device_fn(tokens).float(), j_act, "device half")
    j_act_t = torch.from_numpy(np.asarray(j_act, np.float32)).to(torch.bfloat16)
    _rel_check(progs.edge_fn(j_act_t), jprogs.edge_fn(j_act), "edge half")
    assert progs.act_bytes_per_token == jprogs.act_bytes_per_token


def test_transfer_seconds_match_the_reference(jx):
    jserve, jnp = jx["serve"], jx["jnp"]
    for n, d, r in ((4 * 64, 128, 3.09e6), (12288, 4096, 1e9), (1, 1, 0.0)):
        assert transfer_seconds(n, d, r) == jserve.transfer_seconds(n, d, r)
    jenv = jx["make_env"](jx["jax"].random.PRNGKey(0), n_users=12, n_aps=3, n_sub=4)
    env = convert.env_from_numpy(np.asarray(jenv.g_up), np.asarray(jenv.g_dn),
                                 np.asarray(jenv.ap), jenv.radio, jenv.comp, device="cpu")
    jcfg = jx["configs"].get("recurrentgemma-9b").reduced()
    jprof = jx["profiles"].from_arch_config(jcfg, seq=48)
    prof = profiles.from_arch_config(configs.get("recurrentgemma-9b").reduced(), seq=48)
    np.testing.assert_array_equal(prof.w.numpy(), np.asarray(jprof.w))
    rng = np.random.default_rng(0)
    sub_up = rng.integers(0, 4, 12).astype(np.int32)
    p_up = rng.uniform(1e-3, 0.3, 12).astype(np.float32)
    for s in (0, 2, 3):
        jplan = types.SimpleNamespace(sub_up=jnp.asarray(sub_up), p_up=jnp.asarray(p_up),
                                      s=jnp.asarray(s, jnp.int32))
        plan = types.SimpleNamespace(sub_up=torch.from_numpy(sub_up),
                                     p_up=torch.from_numpy(p_up),
                                     s=torch.tensor(s, dtype=torch.int32))
        want = np.asarray(jserve.planned_transfer_seconds(jenv, jprof, jplan))
        got = planned_transfer_seconds(env, prof, plan).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_make_batch_equals_the_reference(jx):
    for seed, step, b, s, v in ((0, 0, 4, 64, 512), (7, 3, 2, 33, 256000)):
        got = make_batch(seed, step, b, s, v, device="cpu")
        want = jx["make_batch"](seed, step, b, s, v)
        for k in ("tokens", "targets"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_serve_entry_point_runs_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "recurrentgemma-9b", "--reduced", "--device", "cpu",
                             "--requests", "2", "--seq", "48", "--new-tokens", "2"])
    printed = capsys.readouterr().out
    assert "[plan] split layer s*=" in printed and "[serve] generated 2" in printed
    assert 0 <= out["split"] <= 3
    assert out["new_tokens"].shape == (2, 2)
    assert int(out["new_tokens"].min()) >= 0 and int(out["new_tokens"].max()) < 512
    assert out["link_s"] > 0 and out["device_s"] >= 0 and out["edge_s"] >= 0


def test_entry_points_default_to_the_card():
    """device=None means the card: without CUDA the model, the batch and
    the serving driver raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    cfg = configs.get("recurrentgemma-9b").reduced()
    for call in (lambda: Model(cfg), lambda: make_batch(0, 0, 1, 8, 512),
                 lambda: launch_serve.main(["--arch", "recurrentgemma-9b", "--reduced"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "llama4-scout-17b-a16e", "xlstm-125m"])
def test_split_serve_of_the_new_families_equals_forward_at_every_split(name):
    """At capacity 0.5 half the MoE slots drop; both halves run the model's
    capacity (the drop counts of the split and the unsplit passes equal)."""
    cfg = configs.get(name).reduced()
    model = Model(cfg, device="cpu", moe_capacity=0.5).init(torch.Generator().manual_seed(4))
    s_len = 256 if cfg.family == "ssm" else 64
    tokens = make_batch(0, 0, 2, s_len, cfg.vocab_size, device="cpu")["tokens"]
    with moe.drop_log() as full_drops:
        full, _, _ = model(tokens)
    for s in range(cfg.n_layers + 1):
        progs = make_split_serve(model, s)
        with moe.drop_log() as drops:
            logits = progs.edge_fn(progs.device_fn(tokens))
        assert torch.equal(logits, full), (name, s)
        assert [int(d) for d in drops] == [int(d) for d in full_drops], (name, s)
    assert len(full_drops) == sum(sp.n_layers for sp in model.stages if sp.moe)
    if full_drops:
        assert sum(int(d) for d in full_drops) > 0


@pytest.mark.parametrize("name,seq", [("deepseek-moe-16b", 48), ("xlstm-125m", 256)])
def test_serve_entry_point_runs_the_new_families_on_the_cpu(name, seq, capsys, monkeypatch):
    built = []
    monkeypatch.setattr(launch_serve, "Model",
                        lambda *a, **k: built.append(k) or Model(*a, **k))
    out = launch_serve.main(["--arch", name, "--reduced", "--device", "cpu",
                             "--requests", "2", "--seq", str(seq), "--new-tokens", "1"])
    printed = capsys.readouterr().out
    assert "[plan] split layer s*=" in printed and "[serve] generated 1" in printed
    assert built[0]["moe_capacity"] == 4.0
    n_layers = configs.get(name).reduced().n_layers
    assert 0 <= out["split"] <= n_layers
    assert out["new_tokens"].shape == (2, 1)
    assert 0 <= int(out["new_tokens"].min()) and int(out["new_tokens"].max()) < 512
