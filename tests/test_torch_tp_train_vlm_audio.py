"""Tensor-parallel training of the vision and audio families on the CPU:
runtime.train.jit_train_step on ("data", "model") meshes of gloo ranks
against the JAX package's unsharded make_train_step on Model(cfg,
tp_size=M), with the machinery and bounds of
tests/test_torch_tp_train_moe_xlstm.py.

  * llama-3.2-vision-11b reduced (attn, cross, attn, cross over a 16-token
    frontend, one KV head: the flat layout) on (1, 2) (Hp 4, K / V split
    inside the head and gathered, in the self and the cross attention) and
    (1, 3) (Hp 6, wk / wv replicated: per-rank partial gradients, PARTIAL);
  * whisper-small reduced (a 2-layer bidirectional encoder over as many
    frames as tokens, then 2 decoder blocks of causal self attention,
    cross attention over the encoder's output and an MLP; four KV heads:
    grouped on 2 ranks, flat with Hp 6 on 3) on (1, 2) and (1, 3). The
    encoder's output enters the decoder's cross attentions once a forward
    (Model.forward), so each rank's encoder backward runs on the ranks'
    partial cotangents summed.

The reference initialises every xgate to zero, where a cross block adds
nothing and its weights get no gradient; both packages start from the
same edited tree (tests/test_torch_tp_vlm_audio.py's _edit: xgate 0.5 and
-0.7 by layer, the LayerNorm weights and biases random). Each rank takes
its rows of the frontend with its rows of the tokens. One bf16 step of
each on (1, 2); the (1, 1) mesh bit-equal to make_train_step (xgates at
0.5); launch/train.py --mesh 1x2 for both archs.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp_serve import pairs  # noqa: E402
from test_torch_tp_train_moe_xlstm import (  # noqa: E402
    check_bf16,
    check_grads,
    check_launch,
    check_placements,
    check_steps,
    run_train_case,
)
from test_torch_tp_vlm_audio import _edit  # noqa: E402

CASES = {"llama-3.2-vision-11b": ("llama-3.2-vision-11b", {}),
         "whisper-small": ("whisper-small", {})}
MESHES = {(1, 2): tuple(CASES), (1, 3): tuple(CASES)}
PAIRS = pairs(MESHES)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return run_train_case(tmp_path_factory, CASES, MESHES, tuple(CASES), (), tuple(CASES),
                          edit=_edit)


@pytest.mark.parametrize("shape,name", PAIRS)
def test_float32_gradients_match_the_unsharded_reference(case, shape, name):
    worst = check_grads(case, shape, name)
    print(f"{name} on {shape}: float32 gradients within {worst:.2e} of each leaf's largest "
          "value")


@pytest.mark.parametrize("shape,name", PAIRS)
def test_float32_steps_match_the_unsharded_reference(case, shape, name):
    check_steps(case, shape, name)


@pytest.mark.parametrize("name", tuple(CASES))
def test_bf16_step_on_two_ranks_within_the_reference_bound(case, name):
    worst = check_bf16(case, name)
    print(f"{name} bf16 on (1, 2): gradients within {worst:.3e} of each leaf's largest value")


@pytest.mark.parametrize("shape,name", PAIRS)
def test_each_rank_holds_its_placements_shard(case, shape, name):
    check_placements(case, shape, name)


def test_a_one_device_mesh_is_bit_equal_and_no_step_warns(case):
    (rk,) = case["ranks"][1, 1]
    assert rk["one"] == {name: True for name in CASES}
    assert all(len(case["ranks"][shape]) == shape[0] * shape[1] for shape in MESHES)


def test_every_leaf_trains_and_the_replicated_cross_kv_is_partial(case):
    """No gradient leaf, reassembled whole, is zero (the cross attention
    and, for whisper, the encoder train through the decoder's cross
    attention; a rank's shard of the padded heads' wq / wo is zero on 3
    ranks); the flat layout's replicated wk / wv on 3 ranks are PARTIAL in
    the self and the cross attention, split on 2 (the vlm's K / V inside
    its one head)."""
    from test_torch_tp_train_moe_xlstm import _assembled, _leaf_names, _port_model

    from repro_torch.core.types import tree_flatten
    from repro_torch.models.model import PARTIAL, SPLIT
    for shape in MESHES:
        for name in CASES:
            zero = [i for i, g in enumerate(tree_flatten(_assembled(case, shape, True, name))[0])
                    if not float(g.abs().max()) > 0]
            assert not zero, (shape, name, zero)
    names = _leaf_names(_port_model(case, "llama-3.2-vision-11b", 3).param_tree())
    for shape, want in (((1, 2), SPLIT), ((1, 3), PARTIAL)):
        kinds = case["ranks"][shape][0][True, "llama-3.2-vision-11b"]["kinds"]
        for attn in (".attn.", ".xattn."):
            got = {kinds[i] for i, n in enumerate(names)
                   if attn in n and n.rsplit(".", 1)[1] in ("wk", "wv")}
            assert got == {want}, (shape, attn, got)


@pytest.mark.parametrize("arch", tuple(CASES))
def test_launch_on_a_model_axis_resumes_and_restores_on_no_mesh(case, arch, tmp_path):
    check_launch(case, arch, tmp_path)
