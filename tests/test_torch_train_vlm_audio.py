"""Training the vision and audio families in the port against the JAX
package on the CPU: reduced llama-3.2-vision-11b (attn, cross, attn, cross,
G = 4, over 16 image tokens) and whisper-small (2 enc + 2 dec blocks,
LayerNorm, over as many frames as tokens), each batch with the launcher's
frontend. The reference initialises every xgate to zero, where a cross
block adds nothing and its weights get no gradient: both packages start
from the same edited tree (test_torch_train.edited_params: xgate 0.5 and
-0.7 by layer, whisper's LayerNorm weights and biases random), so the cross
attention's gradients and the encoder's, which reach it through the
decoder's cross attention, are what is compared.

  * one float32 train step from the JAX TrainState (test_torch_train.py's
    step_case and check_f32_case: loss, every gradient and moment leaf
    within 1e-5 of its largest value, an xgate's within 1e-5 of its block's
    largest, the updated params within adamw_bound);
  * the bf16 training forward within the JAX package's own bound for two
    paths of one bf16 model, 0.05 * max(1, max |logits|), and the loss
    within 0.05 * max(1, |loss|);
  * launch.train --reduced --device cpu, resumed bit-equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import (  # noqa: E402
    bf16_logits_check,
    check_f32_case,
    jx,  # noqa: F401  (the fixture)
    launch_resume_check,
    step_case,
)

from repro_torch.core.types import tree_flatten  # noqa: E402

ARCHS = ["llama-3.2-vision-11b", "whisper-small"]


@pytest.mark.parametrize("arch", ARCHS)
def test_vlm_audio_train_step_f32_matches_the_reference(jx, arch):  # noqa: F811
    case = step_case(jx, "float32", arch)
    check_f32_case(jx, case, arch)
    # the cross attention and (audio) the encoder train: no zero gradient leaf
    zero = [i for i, g in enumerate(tree_flatten(case["grads"])[0])
            if not float(np.abs(g.numpy()).max()) > 0]
    assert not zero, zero


@pytest.mark.parametrize("arch", ARCHS)
def test_vlm_audio_training_forward_bf16_within_the_reference_bound(jx, arch):  # noqa: F811
    bf16_logits_check(jx, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_vlm_audio_launch_train_resumes(tmp_path, arch):
    launch_resume_check(tmp_path, arch)
