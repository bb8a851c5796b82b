"""The plain references against the program at small sizes on the CPU
(the references import nothing of the program; these tests import both),
and the lower-precision control that the check has to fail."""

import pytest
import torch

from perfbench.reference import mvit, recipe, x3d
from perfbench.reference.common import CONTROL_DTYPE
from perfbench.tests.bench_copy import TINY_MVIT, TRAIN_TINY

X3D_SMALL = {"input_clip_length": 4, "input_crop_size": 64, "model_num_class": 400}
MVIT_SMALL = dict(spatial_size=64, temporal_size=4, embed_dim_mul=[[1, 2.0], [3, 2.0], [14, 2.0]],
                  atten_head_mul=[[1, 2.0], [3, 2.0], [14, 2.0]],
                  pool_q_stride_size=[[1, 1, 2, 2], [3, 1, 2, 2], [14, 1, 2, 2]],
                  pool_kv_stride_adaptive=[1, 8, 8], pool_kvq_kernel=[3, 3, 3], depth=16,
                  head_num_classes=400)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _program(factory, model, weights):
    from pytorchvideo_tpu_torch.models import hub

    m = getattr(hub, factory)(device="cpu", **model)
    m.load_state_dict(weights, strict=True)
    return m.eval()


@pytest.mark.parametrize("family, factory, model", [
    (x3d, "x3d_s", X3D_SMALL), (mvit, "mvit_base_16x4", MVIT_SMALL)])
def test_reference_matches_the_program_in_float32(family, factory, model):
    weights = family.make_weights(model, 2 ** 31 + 11, "cpu")
    program = _program(factory, model, weights)
    x = torch.randn((2, 3) + family.architecture(model)["clip"], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, ref = program(x), family.forward(weights, x, model)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("family, model", [(x3d, X3D_SMALL), (mvit, MVIT_SMALL)])
def test_the_control_reads_far_above_bfloat16(family, model):
    """The reference at the control's precision lies far further from the
    f32 reference than the bf16 deploy form's error seen on the card."""
    weights = family.make_weights(model, 2 ** 31 + 12, "cpu")
    x = torch.randn((2, 3) + family.architecture(model)["clip"], generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = family.forward(weights, x, model)
        low = family.forward(weights, x, model, CONTROL_DTYPE)
    assert ((low - ref).abs().amax(1) / ref.abs().amax(1)).max() > 0.05


def test_weights_are_the_seeds_and_only_the_seeds():
    a = x3d.make_weights(X3D_SMALL, 2 ** 31 + 5, "cpu")
    b = x3d.make_weights(X3D_SMALL, 2 ** 31 + 5, "cpu")
    c = x3d.make_weights(X3D_SMALL, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.conv.conv_t.weight"], c["blocks.0.conv.conv_t.weight"])


def test_the_reference_step_matches_the_programs_eager_step_in_float32():
    """Five f32 updates of the app's eager step (MixUp/CutMix, the head's
    dropout, loss, clip, AdamW, the LR) against the plain recipe, same
    weights, batches, draws and masks."""
    from pytorchvideo_tpu_torch.train import VideoClassificationTrainApp, get_preset

    model_cfg, numbers = TINY_MVIT["model"], TRAIN_TINY["recipe_numbers"]
    assert model_cfg["head_dropout_rate"] > 0
    weights = mvit.make_weights(model_cfg, 2 ** 31 + 21, "cpu")
    g = torch.Generator().manual_seed(3)
    clip = mvit.architecture(model_cfg)["clip"]
    batches = [(torch.randn((4, 3) + clip, generator=g), torch.randint(0, 10, (4,), generator=g))
               for _ in range(5)]
    schedule = numbers["schedule"]
    cfg = get_preset("classification_mvit_16x4", **{
        "model.num_classes": 10, "trainer.clip_grad_norm": numbers["clip_grad_norm"],
        "trainer.log_every_n_steps": 1, "trainer.max_epochs": 1, "optim.lr": schedule["lr"],
        "optim.weight_decay": numbers["weight_decay"], "mix.label_smoothing": 0.1})

    class Data:
        def train_dataloader(self, n):
            for video, labels in batches[:n]:
                yield {"video": video, "label": labels}

    app = VideoClassificationTrainApp(cfg, model=_program("mvit_base_16x4", model_cfg, weights),
                                      datamodule=Data(), steps_per_epoch=5, device="cpu", seed=77)
    app.setup()
    torch.manual_seed(2 ** 31 + 40)  # the generator the program's dropout draws from
    losses = app.train()
    forward = lambda w, v, c, masks: mvit.forward(w, v, model_cfg, c, dropout=masks)
    ref = recipe.train(forward, weights, batches, numbers, 10, 77, 5, gradient_steps=(1, 4),
                       dropout_seed=2 ** 31 + 40)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    # Leaves whose gradient is nought to rounding (a key's bias under the
    # softmax) move under Adam by round-off alone: the check leaves them out
    # by the same rule.
    leaves = recipe.reached(ref["grads"][1])
    assert len(leaves) > 0.9 * len(ref["grads"][1])
    for name, p in app.state.model.named_parameters():
        if name in leaves:
            assert torch.allclose(p.detach(), ref["params"][name], rtol=1e-4, atol=1e-6), name
    # Another mask seed moves the losses: the masks are compared, not ignored.
    other = recipe.train(forward, weights, batches, numbers, 10, 77, 5, dropout_seed=5)
    assert other["losses"] != pytest.approx(ref["losses"], rel=1e-5)
