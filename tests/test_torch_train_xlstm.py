"""Training the ssm family (reduced xlstm-125m: mLSTM, sLSTM, mLSTM; d 128,
4 heads of 32) in the port against the JAX package on the CPU. The mLSTM
chunk scan and the sLSTM loop over time train through autograd, with
float32 masters; neither package has a kernel for them.

  * one float32 train step from the JAX TrainState (test_torch_train.py's
    step_case and check_f32_case: loss, every gradient and moment leaf
    within 1e-5 of its largest value, the updated params within
    adamw_bound), at 32 tokens (one chunk) and at 512 (two chunks of 256:
    the state carried across a chunk boundary);
  * the bf16 training forward within the JAX package's own bound for two
    paths of one bf16 model, 0.05 * max(1, max |logits|), and the loss
    within 0.05 * max(1, |loss|);
  * launch.train --reduced --device cpu, resumed bit-equal."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import (  # noqa: E402
    bf16_logits_check,
    check_f32_case,
    jx,  # noqa: F401  (the fixture)
    launch_resume_check,
    step_case,
)

ARCH = "xlstm-125m"


@pytest.mark.parametrize("batch,seq", [(4, 32), (1, 512)])
def test_xlstm_train_step_f32_matches_the_reference(jx, batch, seq):  # noqa: F811
    check_f32_case(jx, step_case(jx, "float32", ARCH, batch=batch, seq=seq), ARCH)


def test_xlstm_training_forward_bf16_within_the_reference_bound(jx):  # noqa: F811
    bf16_logits_check(jx, ARCH)


def test_xlstm_launch_train_resumes(tmp_path):
    launch_resume_check(tmp_path, ARCH)
