"""The program's recorder (utils/profiling.py): spans, counters and device
marks, and where the program opens them.

On the CPU: a span off is the shared no-op; under ``torch.profiler`` the
app's eager ``train()`` and the served transforms show their spans in the
trace, nested as the code nests; ``recording()`` keeps spans with parents,
step ids and self times; the counters count. On the card (marked ``cuda``,
skipped without one): the compiled forward's and the captured step's
counters and ``launches_per_replay``, the train step's four device parts
against an event pair around the replay, and the same losses and
gradients with and without ``recording()``. The file imports no JAX, so
on a machine with a card it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_profiling.py
"""

import json
import threading

import pytest
import torch

from pytorchvideo_tpu_torch.utils import profiling

TINY_MVIT = dict(spatial_size=32, temporal_size=4, depth=3, num_heads=1, patch_embed_dim=16,
                 embed_dim_mul=[[1, 2.0]], atten_head_mul=[[1, 2.0]],
                 pool_q_stride_size=[[1, 1, 2, 2]], pool_kv_stride_adaptive=[1, 2, 2],
                 pool_kvq_kernel=[3, 3, 3], head_num_classes=7)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Clips:
    """``train_dataloader(n)``: n seeded batches of (B, 3, 4, 32, 32) clips
    on ``device``."""

    def __init__(self, device, batch=2, classes=7):
        self.device, self.batch, self.classes = device, batch, classes

    def train_dataloader(self, n):
        g = torch.Generator().manual_seed(0)
        for _ in range(n):
            yield {"video": torch.randn(self.batch, 3, 4, 32, 32, generator=g).to(self.device),
                   "label": torch.randint(0, self.classes, (self.batch,), generator=g)
                   .to(self.device)}


def _app(model, device, steps=2, **overrides):
    from pytorchvideo_tpu_torch.train import VideoClassificationTrainApp, get_preset

    cfg = get_preset("classification_mvit_16x4", **{
        "model.num_classes": 7, "trainer.max_epochs": 1, "trainer.log_every_n_steps": 1,
        "trainer.precise_bn_batches": 0, "trainer.checkpoint_dir": None,
        "trainer.log_dir": None, **overrides})
    app = VideoClassificationTrainApp(cfg, model=model, datamodule=_Clips(device),
                                      steps_per_epoch=steps, device=device)
    app.setup()
    return app


def _tiny_mvit(device):
    from pytorchvideo_tpu_torch.models import hub

    torch.manual_seed(3)
    return hub.mvit_base_16x4(device=device, **TINY_MVIT)


def _profiled(fn, tmp_path):
    """The program's ``pvt.`` ranges of a CPU trace of ``fn()``:
    [(name, start us, end us, thread)] by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
                  for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("pvt."))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner[3] == outer[3]


def test_a_span_off_is_the_shared_no_op_and_records_nothing():
    span = profiling.annotate("pvt.test.off")
    assert span is profiling.NOOP and profiling.annotate("pvt.test.other") is span
    with span as entered:
        assert entered is None
    with profiling.recording() as spans:
        pass
    assert list(spans) == [] and spans.parts == []


def test_the_eager_app_shows_its_spans_in_the_profiler_nested(tmp_path):
    app = _app(_tiny_mvit("cpu"), "cpu", steps=2)
    found = _profiled(app.train, tmp_path)
    names = [f[0] for f in found]
    for name in ("pvt.train.batch", "pvt.train.step", "pvt.train.prepare",
                 "pvt.train.scalars", "pvt.train.update", "pvt.train.log",
                 "pvt.transform.MixVideo"):
        assert names.count(name) == 2, (name, names)
    by_name = lambda n: [f for f in found if f[0] == n]
    steps, batches, logs = by_name("pvt.train.step"), by_name("pvt.train.batch"), \
        by_name("pvt.train.log")
    for i, step in enumerate(steps):
        for part in ("pvt.train.prepare", "pvt.train.scalars", "pvt.train.update"):
            assert _inside(by_name(part)[i], step)
        assert _inside(by_name("pvt.transform.MixVideo")[i], by_name("pvt.train.prepare")[i])
        # The batch goes to the device before the step, the loss comes back after.
        assert batches[i][2] <= step[1] and step[2] <= logs[i][1]
        assert not any(_inside(b, step) for b in batches + logs)
    mixes = by_name("pvt.transform.MixUp") + by_name("pvt.transform.CutMix")
    assert len(mixes) == 2 and all(any(_inside(m, v) for v in by_name("pvt.transform.MixVideo"))
                                   for m in mixes)


def test_the_served_transforms_show_in_the_profiler_around_an_eager_deploy_forward(tmp_path):
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form
    from pytorchvideo_tpu_torch.models.x3d import create_x3d
    from pytorchvideo_tpu_torch.transforms import Div255, Normalize
    from pytorchvideo_tpu_torch.transforms.functional import thwc_to_cthw

    torch.manual_seed(5)
    model = create_x3d(input_clip_length=4, input_crop_size=32, model_num_class=7,
                       device="cpu").eval()
    deploy = convert_to_deployable_form(model, None)
    frames = torch.randint(0, 256, (1, 4, 32, 32, 3), dtype=torch.uint8)
    transforms = [Div255(), Normalize([0.45] * 3, [0.225] * 3)]

    def request():
        x = frames
        for t in transforms:
            x = t(x)
        with torch.no_grad():
            return deploy(thwc_to_cthw(x))

    found = _profiled(request, tmp_path)
    assert [f[0] for f in found] == ["pvt.transform.Div255", "pvt.transform.Normalize",
                                     "pvt.transform.thwc_to_cthw"]
    assert found[0][2] <= found[1][1] <= found[1][2] <= found[2][1]


def test_recording_keeps_spans_with_parents_steps_and_self_times():
    with profiling.recording() as spans:
        with profiling.annotate("pvt.test.step", step=41):
            with profiling.annotate("pvt.test.a"):
                with profiling.annotate("pvt.test.a.inner"):
                    sum(range(1000))
            with profiling.annotate("pvt.test.b"):
                pass
        with profiling.annotate("pvt.test.request"):
            with profiling.annotate("pvt.test.part"):
                pass
        with profiling.annotate("pvt.test.request"):
            pass

        def on_a_thread():
            with profiling.annotate("pvt.test.thread"):
                pass

        worker = threading.Thread(target=on_a_thread)
        with profiling.annotate("pvt.test.outer"):
            worker.start()
            worker.join(timeout=10)
        assert not worker.is_alive()
    assert profiling.annotate("pvt.test.after") is profiling.NOOP
    by_name = {}
    for i, span in enumerate(spans):
        by_name.setdefault(span.name, []).append(i)
    step, a, inner, b = (by_name[n][0] for n in ("pvt.test.step", "pvt.test.a",
                                                 "pvt.test.a.inner", "pvt.test.b"))
    assert spans[step].parent is None and spans[a].parent == step
    assert spans[inner].parent == a and spans[b].parent == step
    assert {spans[i].step for i in (step, a, inner, b)} == {41}
    # A root with no step opens a request of its own; its children share it.
    first, second = by_name["pvt.test.request"]
    part = by_name["pvt.test.part"][0]
    assert spans[part].parent == first and spans[part].step == spans[first].step
    assert spans[first].step < 0 and spans[second].step < 0
    assert spans[first].step != spans[second].step
    # Self time: the duration less the children's.
    assert spans[step].self_ns == spans[step].ns - spans[a].ns - spans[b].ns
    assert spans[a].self_ns == spans[a].ns - spans[inner].ns
    assert spans[inner].self_ns == spans[inner].ns > 0
    # Another thread has its own nesting: its span is a root, though the
    # main thread's "outer" was open.
    (thread,) = by_name["pvt.test.thread"]
    assert spans[thread].parent is None and spans[thread].step < 0
    assert spans.parts == []  # no device marks on the CPU


def test_recording_under_the_profiler_does_both(tmp_path):
    def closed():
        with profiling.annotate("pvt.test.both"):
            pass

    with profiling.recording() as spans:
        found = _profiled(closed, tmp_path)
    assert [s.name for s in spans] == ["pvt.test.both"] and spans[0].ns >= 0
    assert [f[0] for f in found] == ["pvt.test.both"]


def test_counters_count_and_the_cpu_app_counts_its_updates_and_host_reads():
    before = dict(profiling.counters)
    profiling.count("test.things")
    profiling.count("test.things", 4)
    assert profiling.counters["test.things"] == before.get("test.things", 0) + 5
    app = _app(_tiny_mvit("cpu"), "cpu", steps=3, **{"trainer.log_every_n_steps": 2})
    eager, reads = (profiling.counters[k] for k in ("train.eager_updates", "train.host_reads"))
    app.train()
    assert profiling.counters["train.eager_updates"] == eager + 3
    assert profiling.counters["train.host_reads"] == reads + 2  # steps 0 and 2 log
    assert profiling.counters["train.replays"] == before.get("train.replays", 0)


def test_device_marks_on_the_cpu_are_never_recorded_or_read():
    from pytorchvideo_tpu_torch.train.train_loop import TRAIN_MARKS

    app = _app(_tiny_mvit("cpu"), "cpu", steps=1)
    assert app._train_step.marks.names == TRAIN_MARKS
    with profiling.recording() as spans:
        app.train()
    assert not app._train_step.marks.recorded() and spans.parts == []
    steps = [s for s in spans if s.name == "pvt.train.step"]
    assert len(steps) == 1 and steps[0].step == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graph capture and device marks have no CPU mode")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield torch.device("cuda")


def _moved(before):
    return {k: v - before.get(k, 0) for k, v in profiling.counters.items()
            if v != before.get(k, 0)}


@pytest.mark.cuda
def test_compiled_forward_counts_its_capture_replays_and_launches(cuda):
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form
    from pytorchvideo_tpu_torch.models import hub

    x = torch.rand(1, 3, 13, 160, 160, device=cuda)
    before = dict(profiling.counters)
    compiled = convert_to_deployable_form(hub.x3d_s(device=cuda).eval(), example_input=x)
    assert _moved(before).get("serve.captures") == 1
    # X3D-S: every stride-1 conv_b on #1, 22 a forward.
    assert compiled.launches_per_replay == {"depthwise3x3x3_bn_swish": 22}
    assert compiled.capture_s > 0
    before = dict(profiling.counters)
    with profiling.recording() as spans:
        for _ in range(5):
            compiled(x.bfloat16())
    torch.cuda.synchronize()
    assert _moved(before) == {"serve.replays": 5}
    calls = [s for s in spans if s.name == "pvt.serve.call"]
    assert len(calls) == 5 and len({s.step for s in calls}) == 5
    for name in ("pvt.serve.copy_in", "pvt.serve.replay", "pvt.serve.clone"):
        parts = [s for s in spans if s.name == name]
        assert len(parts) == 5 and all(spans[s.parent].name == "pvt.serve.call" for s in parts)


@pytest.mark.cuda
def test_captured_step_counts_warm_ups_capture_replays_and_a_recapture(cuda):
    from pytorchvideo_tpu_torch.train.compiled_step import WARMUP_STEPS

    app = _app(_tiny_mvit(cuda), cuda, steps=6, **{"trainer.compute_dtype": "bfloat16",
                                                    "trainer.log_every_n_steps": 10 ** 9})
    before = dict(profiling.counters)
    app.train()
    torch.cuda.synchronize()
    moved = _moved(before)
    assert WARMUP_STEPS == 2
    assert (moved.get("train.eager_updates"), moved.get("train.captures"),
            moved.get("train.replays")) == (2, 1, 4)
    (step,) = app._captured_steps.values()
    assert step.capture_s > 0
    # The tiny MViT's 3 blocks: the packed attention twice a block (grid and
    # cls), its backward as often, a conv pool for q, k and v and the pool's
    # dx and dw each.
    assert step.launches_per_replay["pooled_attention_packed"] == 6
    assert step.launches_per_replay["pooled_attention_packed_bwd"] == 6
    assert step.launches_per_replay["token_pool_dw"] == step.launches_per_replay["token_pool_dx"]
    # A batch of another signature captures a graph of its own.
    app.datamodule = _Clips(cuda, batch=4)
    before = dict(profiling.counters)
    app.train()
    torch.cuda.synchronize()
    assert _moved(before).get("train.captures") == 1 and len(app._captured_steps) == 2


@pytest.mark.cuda
def test_a_replayed_steps_four_parts_sum_to_the_replay(cuda):
    from pytorchvideo_tpu_torch.train.train_loop import TRAIN_MARKS

    app = _app(_tiny_mvit(cuda), cuda, steps=4, **{"trainer.compute_dtype": "bfloat16",
                                                    "trainer.log_every_n_steps": 10 ** 9})
    app.train()  # two warm-up updates, the capture, a replay
    (step,) = app._captured_steps.values()
    with profiling.recording() as spans:
        app.steps_per_epoch = 3
        app.train()
    assert [k for k, _ in spans.parts] == [4, 5, 6]
    for _, parts in spans.parts:
        assert list(parts) == list(TRAIN_MARKS[1:]) and all(v > 0 for v in parts.values())
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step.graph.replay()
        end.record()
        end.synchronize()
        around = start.elapsed_time(end)
        parts = step.step.marks.parts()
        assert all(v > 0 for v in parts.values())
        assert abs(sum(parts.values()) - around) <= 0.05 * around, (parts, around)


@pytest.mark.cuda
def test_recording_leaves_the_losses_and_gradients_bitwise_alone(cuda):
    import copy

    from pytorchvideo_tpu_torch.models.x3d import create_x3d
    from pytorchvideo_tpu_torch.train import VideoClassificationTrainApp, get_preset

    torch.manual_seed(34)
    model = create_x3d(input_clip_length=4, input_crop_size=32, model_num_class=7,
                       dropout_rate=0.0, device=cuda)
    results = []
    for record, m in ((False, model), (True, copy.deepcopy(model))):
        cfg = get_preset("classification_x3d_xs", **{
            "model.num_classes": 7, "trainer.max_epochs": 1, "trainer.precise_bn_batches": 0,
            "trainer.checkpoint_dir": None, "trainer.log_dir": None})
        app = VideoClassificationTrainApp(cfg, model=m, datamodule=_Clips(cuda, batch=4),
                                          steps_per_epoch=1)
        app.setup()
        losses, grads = [], []
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
            for batch in _Clips(cuda, batch=4).train_dataloader(6):
                with profiling.recording() if record else profiling.NOOP:
                    app.state, metrics = app._step(app._device_batch(batch))
                losses.append(metrics["loss"].item())
                grads.append({n: p.grad.clone() for n, p in app.model.named_parameters()})
        results.append((losses, grads))
    (plain_losses, plain_grads), (losses, grads) = results
    assert losses == plain_losses
    for got, ref in zip(grads, plain_grads):
        for n in ref:
            assert torch.equal(got[n], ref[n]), n
