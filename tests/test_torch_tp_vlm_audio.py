"""Tensor-parallel serving of the vision and audio families on the CPU:
the serve steps on ("data", "model") meshes of gloo ranks against the JAX
package's unsharded Model(cfg, tp_size=M), with the machinery and bounds of
tests/test_torch_tp_moe_xlstm.py.

  * llama-3.2-vision-11b reduced (self layers and a cross block every 2
    layers over a 16-token frontend, one KV head: the flat layout, its
    cross attention's K / V repeated once a padded query head) on (1, 2)
    (Hp 4) and (1, 3) (Hp 6);
  * whisper-small reduced (a 2-layer bidirectional encoder over 16 frames,
    whose output every rank holds whole over "model", then decoder blocks
    of causal self attention, cross attention over the encoder's output
    and an MLP; four KV heads: grouped on 2 ranks, flat with Hp 6 on 3) on
    (1, 2) and (1, 3).

The reference initialises every xgate to zero, where a cross block adds
nothing; both packages get the same edited tree, as
tests/test_torch_vlm_audio.py edits it: xgate 0.5 and -0.7 by layer, and
random LayerNorm weights and biases (1 + 0.1 N(0, 1) and 0.1 N(0, 1)).
Each rank passes its rows of the frontend with its rows of the tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp_serve import (  # noqa: E402
    check_caches,
    check_logits,
    check_placements,
    pairs,
    run_case,
)

GATES = (0.5, -0.7)
CASES = {"llama-3.2-vision-11b": ("llama-3.2-vision-11b", {}),
         "whisper-small": ("whisper-small", {})}
MESHES = {(1, 2): tuple(CASES), (1, 3): tuple(CASES)}
PAIRS = pairs(MESHES)


def _edit(jx, jm, tree):
    """xgate set to GATES by layer, the LayerNorm weights and biases (and
    the biases of every norm) drawn at random."""
    jax = jx["jax"]
    rng = np.random.default_rng(1)
    audio = jm.cfg.family == "audio"

    def edit(path, a):
        key = path[-1].key
        if key == "xgate":
            return np.asarray(GATES[:a.shape[0]], np.float32).reshape(a.shape)
        if key.endswith("_b"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if key.endswith("_w") and audio:
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.array(a)
    return jax.tree_util.tree_map_with_path(edit, tree)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return run_case(tmp_path_factory, CASES, MESHES, edit=_edit)


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
    """The decoder's KV caches, "pos", and the "frontend" / "enc_out" the
    prefill wrote (each rank's rows, whole over "model")."""
    check_caches(case, shape, name)


@pytest.mark.parametrize("shape,name", PAIRS)
def test_each_rank_holds_its_placements_shard(case, shape, name):
    check_placements(case, shape, name)


@pytest.mark.parametrize("name", tuple(CASES))
def test_the_flat_layout_pads_the_cross_attentions_heads(case, name):
    """On 3 ranks both models take the flat layout with Hp 6 (the padded
    heads' wq / wo in every self and cross attention); on 2 the vlm pads
    none (Hp 4) and whisper stays grouped (heads_padded 0)."""
    layouts = {m: case["ranks"][(1, m)][0][True, name]["layout"] for m in (2, 3)}
    assert layouts[3] == ("flat", 6)
    assert layouts[2] == (("flat", 4) if name == "llama-3.2-vision-11b" else ("grouped", 0))
