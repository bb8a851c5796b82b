"""Training steps of a classification recipe, the app's captured step.

The program's ``VideoClassificationTrainApp`` trains the configuration's
model on the recipe named in the traffic file (``recipe``), with the
stated numbers of ``recipe_numbers`` put over it, in the configuration's
compute dtype, from a datamodule the benchmark hands it: ``pool`` seeded
batches of ``batch`` normalised NCTHW clips with labels, resident on the
card, yielded in turn. Each step is the app's (MixUp/CutMix, forward with
the head's dropout, loss, backward, clip, AdamW, the LR): its first two are
eager updates, the third captures the update in a CUDA graph and replays
it, every later one replays it.

Set-up seeds the device's default generator (the head's dropout masks)
and drives the app through its first ``checked_steps`` steps, one
``train()`` call each, on rows that all differ: two eager updates, the
capture, then replays on batches the capture never saw. It keeps each
step's loss, the gradient as the optimizer got it at each of
``gradient_steps`` (from AdamW's first moment before and after that
update), and the parameters after the last. The plain reference follows
the same steps from the same weights, batches, mix draws, masks and LR,
and the check compares them leaf by leaf once the window has closed.
``warmup_steps`` more replays end set-up. The window runs replays until
``--seconds`` have passed, and closes when the card has finished every
step enqueued.
"""

from __future__ import annotations

import time

import torch

from perfbench.harness.session import WINDOW
from perfbench.reference import recipe as plain
from perfbench.reference.common import exact_float32


class PoolData:
    """A datamodule over resident batches: ``train_dataloader(n)`` yields
    ``n`` of them in turn, or, with a ``deadline`` set, as many as are
    asked for before it, keeping the host's clock at each (``times``)."""

    def __init__(self, batches):
        self.batches, self.next, self.deadline, self.served = batches, 0, None, 0
        self.times = []

    def train_dataloader(self, n):
        count = 0
        while (count < n) if self.deadline is None else (time.perf_counter() < self.deadline):
            if self.deadline is not None:
                self.times.append(time.perf_counter())
            batch = self.batches[self.next % len(self.batches)]
            self.next += 1
            count += 1
            self.served += 1
            yield {"video": batch[0], "label": batch[1]}


def _overrides(run) -> dict:
    numbers = run.traffic["recipe_numbers"]
    schedule = numbers["schedule"]
    return {
        "optim.lr": schedule["lr"], "optim.weight_decay": numbers["weight_decay"],
        "optim.zero_weight_decay_1d_param": True, "optim.bn_weight_decay": 0.0,
        "lr_scheduler.lr": schedule["lr"], "lr_scheduler.max_iters": schedule["max_epochs"],
        "lr_scheduler.warmup_iters": schedule["warmup_epochs"],
        "lr_scheduler.warmup_start_lr": schedule["warmup_start_lr"],
        "lr_scheduler.cosine_end_lr": schedule["cosine_end_lr"],
        "lr_scheduler.cosine_after_warmup": schedule["cosine_after_warmup"],
        "mix.enabled": True, "mix.mixup_alpha": numbers["mixup_alpha"],
        "mix.cutmix_alpha": numbers["cutmix_alpha"], "mix.cutmix_prob": numbers["cutmix_prob"],
        "mix.label_smoothing": numbers["label_smoothing"],
        "trainer.clip_grad_norm": numbers["clip_grad_norm"],
        "trainer.compute_dtype": run.config["dtype"], "trainer.max_epochs": 1,
        "trainer.log_every_n_steps": 1, "trainer.precise_bn_batches": 0,
        "trainer.checkpoint_dir": None, "trainer.log_dir": None,
        "data.batch_size": run.traffic["batch"],
        "model.num_classes": run.reference.architecture(run.model)["num_classes"],
    }


def batches(run):
    """The pool of seeded batches: frames drawn as uint8, normalised as
    served, NCTHW float32 on the card; labels uniform over the classes."""
    dev, traffic = run.device.device, run.traffic
    arch = run.reference.architecture(run.model)
    norm = run.config["normalize"]
    mean = torch.tensor(norm["mean"], device=dev)
    std = torch.tensor(norm["std"], device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(int(run.seed) + 2)
    out = []
    for _ in range(traffic["pool"]):
        frames = torch.randint(0, 256, (traffic["batch"],) + tuple(arch["clip"]) + (3,),
                               generator=g, device=dev, dtype=torch.uint8)
        video = ((frames.float() / 255.0 - mean) / std).permute(0, 4, 1, 2, 3).contiguous()
        labels = torch.randint(0, arch["num_classes"], (traffic["batch"],), generator=g,
                               device=dev)
        out.append((video, labels))
    return out


def setup(run) -> None:
    from pytorchvideo_tpu_torch.models import hub
    from pytorchvideo_tpu_torch.train import VideoClassificationTrainApp, get_preset

    dev, traffic = run.device, run.traffic
    run.note(f"set-up: {time.perf_counter() - run.t0:.3f} s at the program's import")
    weights = run.reference.make_weights(run.model, run.seed, dev.device)
    model = getattr(hub, run.config["program"])(device=dev.device, **run.model)
    model.load_state_dict(weights, strict=True)
    cfg = get_preset(traffic["recipe"], **_overrides(run))
    data = PoolData(batches(run))
    app = VideoClassificationTrainApp(cfg, model=model, datamodule=data,
                                      steps_per_epoch=traffic["steps_per_epoch"],
                                      device=dev.device, seed=run.seed)
    app.setup()  # the LR schedule at traffic["steps_per_epoch"] steps an epoch
    run.note(f"set-up: {time.perf_counter() - run.t0:.3f} s with the app and its data")
    optimizer = app.state.optimizer
    beta1 = optimizer.param_groups[0]["betas"][0]
    named = list(app.state.model.named_parameters())

    def moments():
        # A leaf the optimizer holds no moment for has had no gradient: zero.
        return {n: optimizer.state[p]["exp_avg"].float().clone()
                if "exp_avg" in optimizer.state.get(p, {}) else torch.zeros_like(p, dtype=torch.float32)
                for n, p in named}

    dev.default_generator().manual_seed(dropout_seed(run))
    losses, grads = [], {}
    app.steps_per_epoch = 1
    for step in range(1, traffic["checked_steps"] + 1):
        before = moments() if step in traffic["gradient_steps"] else None
        losses += app.train()
        if before is not None:
            # AdamW's first moment: m_s = beta1 m_(s-1) + (1 - beta1) g_s.
            grads[step] = {n: (m - beta1 * before[n]) / (1.0 - beta1)
                           for n, m in moments().items()}
    params = {n: p.detach().float().clone() for n, p in named}
    run.note(f"set-up: {time.perf_counter() - run.t0:.3f} s with the checked steps")
    # A logged step reads its loss back to the host: from here on only the
    # first step of each train() call logs.
    app.cfg.trainer.log_every_n_steps = 10 ** 9
    app.steps_per_epoch = traffic["warmup_steps"]
    app.train()
    dev.sync()
    run.program.update(app=app, data=data, weights=weights, losses=losses, grads=grads,
                       params=params)
    run.setup_s = time.perf_counter() - run.t0


def dropout_seed(run) -> int:
    """The seed of the device's default generator at the first checked step,
    from which the program's step draws its dropout masks."""
    return int(run.seed) + 3


def _steps(run, deadline=None, count=None) -> int:
    app, data = run.program["app"], run.program["data"]
    served = data.served
    data.deadline = deadline
    app.steps_per_epoch = count or 1
    app.train()
    data.deadline = None
    return data.served - served


def measure(run) -> None:
    start = time.perf_counter()
    steps = _steps(run, deadline=start + run.seconds)
    run.device.sync()
    end = time.perf_counter()
    run.attempted = steps
    run.window.update(seconds=end - start, steps=steps, clips=steps * run.traffic["batch"])
    run.note(f"window: {steps} steps, {steps * run.traffic['batch']} clips in {end - start!r} s")
    # Steps handed to the program in each fifth of the window: whether the
    # rate moves within a run, or only between runs.
    times = run.program["data"].times
    fifth = run.seconds / 5
    run.note("window: steps a fifth " + " ".join(
        str(sum(start + i * fifth <= t < start + (i + 1) * fifth for t in times)) for i in range(5)))


def trace(run) -> None:
    from perfbench.harness import trace as tr

    def sub_window():
        with torch.autograd.profiler.record_function(WINDOW):
            _steps(run, count=run.traffic["traced_steps"])
            run.device.sync()

    run.device.sync()
    run.events = tr.profile_events(sub_window, run.device.activities())


def release(run) -> None:
    run.program.pop("app", None)
    run.program.pop("data", None)
    run.device.free()


def reference_steps(run, control=None) -> dict:
    """The plain reference's ``checked_steps`` updates from the run's
    weights, batches, draws and masks."""
    traffic = run.traffic
    pool = batches(run)
    steps = [pool[i % len(pool)] for i in range(traffic["checked_steps"])]
    forward = lambda w, video, c, masks: run.reference.forward(w, video, run.model, c,
                                                               dropout=masks)
    with exact_float32():
        return plain.train(forward, run.program["weights"], steps, traffic["recipe_numbers"],
                           run.reference.architecture(run.model)["num_classes"], run.seed,
                           traffic["steps_per_epoch"], control,
                           gradient_steps=traffic["gradient_steps"],
                           dropout_seed=dropout_seed(run))


def numbers(run, program: dict, reference: dict) -> dict:
    """name -> the number compared: the worst step's loss gap (relative);
    over the leaves each reference gradient reaches (``recipe.reached``),
    the worst leaf's gap of the gradient's norm at each of
    ``gradient_steps``, and of the norm of the parameters' change over the
    checked steps; each against the larger of the leaf's reference norm and
    the median leaf's (``grad_gap``, ``update_gap``), and against the leaf's
    own (``grad_gap_leaf``, ``update_gap_leaf``)."""
    weights = run.program["weights"]
    loss = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"]))
    out = {"loss_gap": loss}
    change_ref = {k: reference["params"][k] - weights[k] for k in reference["params"]}
    change = {k: program["params"][k] - weights[k] for k in change_ref}
    first = min(reference["grads"])
    for own, suffix in ((False, ""), (True, "_leaf")):
        worst = (0.0, None, None)
        for step, ref_grad in sorted(reference["grads"].items()):
            gap, leaf = plain.leaf_gap(program["grads"][step], ref_grad, plain.reached(ref_grad),
                                       own=own)
            if not gap <= worst[0]:
                worst = (gap, leaf, step)
        delta, delta_leaf = plain.leaf_gap(change, change_ref,
                                           plain.reached(reference["grads"][first]), own=own)
        run.note(f"worst{suffix}: gradient {worst[1]} at step {worst[2]}, change {delta_leaf}")
        out[f"grad_gap{suffix}"], out[f"update_gap{suffix}"] = worst[0], delta
    run.note(f"{len(plain.reached(reference['grads'][first]))} of {len(change_ref)} leaves "
             f"reached at step {first}")
    return out


def check(run) -> None:
    limits = run.config["limits"]["train_steps"]
    ref = reference_steps(run)
    got = numbers(run, {k: run.program[k] for k in ("losses", "grads", "params")}, ref)
    run.note(f"losses: program {run.program['losses']}, reference {ref['losses']}")
    for name, value in got.items():
        run.checks[name] = (value, limits[name])


def control(run, dtype) -> dict:
    """The check's numbers with the reference at ``dtype`` put in the
    program's place. No program runs."""
    run.program["weights"] = run.reference.make_weights(run.model, run.seed, run.device.device)
    ref = reference_steps(run)
    low = reference_steps(run, control=dtype)
    return numbers(run, low, ref)
