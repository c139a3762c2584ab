"""Tensor-parallel serving of the MoE and xLSTM families on the CPU: the
serve steps on ("data", "model") meshes of gloo ranks against the JAX
package's unsharded Model(cfg, tp_size=M), with the machinery and bounds
of tests/test_torch_tp_serve.py, at the default capacity factor 1.25,
where slots drop.

  * deepseek-moe-16b (8 experts top-2, one shared, a dense first layer,
    four KV heads) on (1, 2), (1, 3) and (2, 2): grouped attention and the
    experts split at M = 2; at M = 3 the flat layout splits the attention
    while every MoE leaf stays whole (8 experts, moe_d_ff 64) and the MoE
    layers issue no collective; on (2, 2) the batch's row blocks share one
    capacity;
  * llama4-scout-17b-a16e (top-1, a shared expert, one KV head: flat) on
    (1, 2);
  * xlstm-125m (mLSTM, sLSTM) on (1, 2), heads split and the states split
    on hd, and on (1, 3), everything whole;
  * xlstm-125m with head_dim 48 (a test variant, dataclasses.replace in
    both packages) on (1, 3): the projections (192) split over 3 while the
    4 heads do not, the split that cuts heads, as xlstm-125m's own widths
    do at M = 3 (768 over 192-wide heads); the states split on hd (48).

The MoE layers' dropped slots, logged once a layer and call on each rank
(moe.drop_log), equal the reference's, read off its router's choices (a
jax.debug.callback) at the whole batch's capacity. In bf16 a near-tie of
the router flips a choice between the two packages (the unsharded port as
well: ROADMAP.md section 3), and a flip at the prefill moves which slots
drop, so a whole token's MoE output and KV entries; a bf16 MoE case routes
as the reference did (Pinned: its choices pinned on every rank, the gates
the port's own), as chip_smoke.py's phase 13.1 pins them, and the flips
are counted.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp_serve import (  # noqa: E402
    case_cfg,
    check_caches,
    check_logits,
    check_placements,
    pairs,
    run_case,
)

from repro_torch import configs  # noqa: E402
from repro_torch.core.types import tree_flatten  # noqa: E402

# case name -> (arch, config overrides)
CASES = {
    "deepseek-moe-16b": ("deepseek-moe-16b", {}),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", {}),
    "xlstm-125m": ("xlstm-125m", {}),
    "xlstm-125m hd48": ("xlstm-125m", {"head_dim": 48}),
}
MESHES = {
    (1, 2): ("deepseek-moe-16b", "llama4-scout-17b-a16e", "xlstm-125m"),
    (1, 3): ("deepseek-moe-16b", "xlstm-125m", "xlstm-125m hd48"),
    (2, 2): ("deepseek-moe-16b",),
}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return run_case(tmp_path_factory, CASES, MESHES)


PAIRS = pairs(MESHES)
MOE_PAIRS = [(shape, name) for shape, name in PAIRS if CASES[name][0] != "xlstm-125m"]


@pytest.mark.parametrize("shape,name", PAIRS)
def test_float32_logits_match_the_unsharded_reference(case, shape, name):
    worst = check_logits(case, shape, name, True)
    print(f"{name} on {shape}: float32 logits within {worst:.2e} of each row's scale")


@pytest.mark.parametrize("shape,name", PAIRS)
def test_bf16_logits_match_the_unsharded_reference(case, shape, name):
    worst = check_logits(case, shape, name, False)
    print(f"{name} on {shape}: bf16 logits at {worst:.3f} of the bound")


@pytest.mark.parametrize("shape,name", PAIRS)
def test_float32_caches_reassembled_match_the_reference(case, shape, name):
    check_caches(case, shape, name)


@pytest.mark.parametrize("shape,name", PAIRS)
def test_each_rank_holds_its_placements_shard(case, shape, name):
    check_placements(case, shape, name)


@pytest.mark.parametrize("shape,name", MOE_PAIRS)
def test_dropped_slots_equal_the_references(case, shape, name):
    """Each call's dropped slots by MoE layer, on every rank, equal the
    reference's: in float32, routing freely; in bf16, routing as the
    reference did (its choices pinned), the choices it would have made
    otherwise counted and printed. The prefill drops some."""
    for f32 in (True, False):
        want = case["refs"][f32, name, shape[1]][3]
        for rk in case["ranks"][shape]:
            assert rk[f32, name]["drops"] == want, (name, shape, f32)
        assert sum(want[0]) > 0, "the prefill dropped no slot: the capacity is not exercised"
    flips = [rk[False, name]["flips"] for rk in case["ranks"][shape]]
    assert all(rk[True, name]["flips"] == 0 for rk in case["ranks"][shape])
    print(f"{name} on {shape}: bf16 (token, layer) choices that differ from the reference's, "
          f"by rank: {flips}")


def test_expert_and_head_splits_follow_each_leafs_placement(case):
    """At M = 2 deepseek's experts split (each rank holds 4 whole experts)
    and xlstm's heads; at M = 3 deepseek's MoE leaves and xlstm's stay
    whole, and the head-cutting variant splits its projections and states
    but not its heads."""
    def local(shape, name, path):
        model = case_cfg(configs, CASES, name)
        from repro_torch.models import Model
        m = Model(model, device="meta", tp_size=shape[1])
        ranks = case["ranks"][shape]
        flat = tree_flatten(m.param_shapes())[0]
        keys = _paths(m.param_shapes())
        i = keys.index(path)
        return ranks[0][True, name]["params"][i], tuple(flat[i].shape)

    assert local((1, 2), "deepseek-moe-16b", "stages.1.0.moe.w1") == ((4, 128, 64), (8, 128, 64))
    assert local((1, 3), "deepseek-moe-16b", "stages.1.0.moe.w1") == ((8, 128, 64), (8, 128, 64))
    assert local((1, 2), "xlstm-125m", "stages.0.0.mlstm.wi") == ((128, 2), (128, 4))
    assert local((1, 3), "xlstm-125m", "stages.0.0.mlstm.wq") == ((128, 128), (128, 128))
    assert local((1, 3), "xlstm-125m hd48", "stages.0.0.mlstm.wq") == ((128, 64), (128, 192))
    assert local((1, 3), "xlstm-125m hd48", "stages.0.0.mlstm.wi") == ((128, 4), (128, 4))


def _paths(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]
