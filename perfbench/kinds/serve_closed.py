"""Closed-loop serving of clip batches.

One client sends a request, waits for its logits on the host, and sends
the next, for the whole window. A request is a batch of ``batch`` clips of
uint8 frames (B, T, H, W, 3), already decoded, in pinned host memory; the
client cycles through a pool of ``pool`` distinct seeded requests, in the
same order for every seed. The served path is the program's: the frames
copied to the card, ``Div255``, ``Normalize(mean, std)`` and
``thwc_to_cthw`` there, a cast to the configuration's dtype, the compiled
deploy form (``convert_to_deployable_form`` then ``CompiledForward``:
BN folded, the kernels, one CUDA graph), and the logits copied to the host.
A request's latency runs from its hand-over to its logits on the host.

Traffic parameters (traffic/<name>.json): ``batch``, ``pool``,
``warmup_requests`` (served in set-up), ``traced_requests`` (the profiled
sub-window of a ``--trace 1`` run), ``host_samples`` (host-clock samples of
one compiled call, card synchronised before each; 0: none),
``unit_forwards`` (eager forwards profiled for the rooflines),
``check_requests`` (pool entries whose every answer in the window is held
against the reference) and ``check_block`` (clips per reference call).
"""

from __future__ import annotations

import random
import time

import torch

from perfbench.harness.session import WINDOW
from perfbench.reference.common import exact_float32


def _clip(run):
    return tuple(run.reference.architecture(run.model)["clip"])


def inputs(run):
    """The seeded weights (the reference's leaves) and the pool of requests,
    uint8 frames in pinned host memory, made on the card."""
    dev, traffic = run.device, run.traffic
    weights = run.reference.make_weights(run.model, run.seed, dev.device)
    generator = torch.Generator(device=dev.device)
    generator.manual_seed(int(run.seed) + 2)
    shape = (traffic["batch"],) + _clip(run) + (3,)
    requests = []
    for _ in range(traffic["pool"]):
        frames = torch.randint(0, 256, shape, generator=generator, device=dev.device,
                               dtype=torch.uint8)
        host = dev.pinned(torch.empty(shape, dtype=torch.uint8))
        host.copy_(frames)
        requests.append(host)
    return weights, requests


def setup(run) -> None:
    from pytorchvideo_tpu_torch.accelerate import convert_to_deployable_form
    from pytorchvideo_tpu_torch.models import hub
    from pytorchvideo_tpu_torch.transforms import Div255, Normalize
    from pytorchvideo_tpu_torch.transforms.functional import thwc_to_cthw

    dev, cfg = run.device, run.config
    dtype = getattr(torch, cfg["dtype"])
    run.note(f"set-up: {time.perf_counter() - run.t0:.3f} s at the program's import")
    weights, requests = inputs(run)
    run.note(f"set-up: {time.perf_counter() - run.t0:.3f} s with weights and requests")
    model = getattr(hub, cfg["program"])(device=dev.device, **run.model)
    model.load_state_dict(weights, strict=True)
    model.eval()
    deploy = convert_to_deployable_form(model, dtype)
    del model
    run.note(f"set-up: {time.perf_counter() - run.t0:.3f} s with the deploy form")
    transform = [Div255(), Normalize(cfg["normalize"]["mean"], cfg["normalize"]["std"])]

    def prepare(host):
        x = host.to(dev.device, non_blocking=True)
        for t in transform:
            x = t(x)
        return thwc_to_cthw(x).to(dtype)

    server = dev.capture(deploy, prepare(requests[0]))
    run.note(f"set-up: {time.perf_counter() - run.t0:.3f} s with the capture")
    run.program.update(weights=weights, pool=requests, prepare=prepare, server=server)
    for i in range(run.traffic["warmup_requests"]):
        serve(run, requests[i % len(requests)])
    dev.sync()
    run.setup_s = time.perf_counter() - run.t0


def serve(run, host, ranges: bool = False) -> torch.Tensor:
    """One request: frames on the host in, logits on the host out."""
    prog = run.program
    if not ranges:
        return prog["server"](prog["prepare"](host)).float().cpu()
    rf = torch.autograd.profiler.record_function
    with rf("perfbench.request"):
        with rf("perfbench.prepare"):
            x = prog["prepare"](host)
        with rf("perfbench.forward"):
            y = prog["server"](x)
        with rf("perfbench.to_host"):
            return y.float().cpu()


def measure(run) -> None:
    pool = run.program["pool"]
    answers, latencies = [], []
    i = 0
    start = time.perf_counter()
    deadline = start + run.seconds
    while True:
        issued = time.perf_counter()
        if issued >= deadline:
            break
        logits = serve(run, pool[i % len(pool)])
        latencies.append(time.perf_counter() - issued)
        answers.append((i % len(pool), logits))
        i += 1
    end = time.perf_counter()
    run.attempted = i
    run.window.update(seconds=end - start, requests=i, clips=i * run.traffic["batch"],
                      latencies_s=latencies, answers=answers)
    run.note(f"window: {i} requests, {i * run.traffic['batch']} clips in {end - start!r} s")


def trace(run) -> None:
    from perfbench.harness import trace as tr

    dev, traffic, pool = run.device, run.traffic, run.program["pool"]

    def sub_window():
        with torch.autograd.profiler.record_function(WINDOW):
            for i in range(traffic["traced_requests"]):
                serve(run, pool[i % len(pool)], ranges=True)
            dev.sync()

    dev.sync()
    run.events = tr.profile_events(sub_window, dev.activities())
    example = run.program["prepare"](pool[0])
    samples = []
    for _ in range(traffic["host_samples"]):
        dev.sync()
        t0 = time.perf_counter()
        run.program["server"](example)
        samples.append(time.perf_counter() - t0)
    dev.sync()
    run.window["replay_host_s"] = samples
    run.program["module"] = run.program["server"].module
    run.program["example"] = example


def release(run) -> None:
    for key in ("server", "module", "example", "prepare"):
        run.program.pop(key, None)
    run.device.free()


def reference_logits(run, host: torch.Tensor, control=None) -> torch.Tensor:
    """The plain float32 model's logits of one request's frames, computed
    in blocks of ``check_block`` clips; with ``control`` (a dtype) the
    reference computed at that precision instead."""
    norm = run.config["normalize"]
    dev = run.device.device
    mean = torch.tensor(norm["mean"], device=dev)
    std = torch.tensor(norm["std"], device=dev)
    out = []
    for rows in torch.split(host, run.traffic["check_block"]):
        x = (rows.to(dev).float() / 255.0 - mean) / std
        out.append(run.reference.forward(run.program["weights"], x.permute(0, 4, 1, 2, 3),
                                         run.model, control).float().cpu())
    return torch.cat(out)


def logit_gap(answer: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """Per clip: the largest gap of a logit from the reference's, over the
    reference's largest logit magnitude."""
    return (answer - reference).abs().amax(dim=1) / reference.abs().amax(dim=1)


def check(run) -> None:
    """Every answer in the window to ``check_requests`` pool entries drawn
    from the seed, held against the reference's logits of that entry."""
    limit = run.config["limits"]["serve_closed"]["logit_gap"]
    answers = run.window["answers"]
    entries = sorted({i for i, _ in answers})
    picked = random.Random(run.seed).sample(entries, min(run.traffic["check_requests"],
                                                         len(entries)))
    gaps = []
    with torch.no_grad(), exact_float32():
        for entry in picked:
            ref = reference_logits(run, run.program["pool"][entry])
            gaps += [float(logit_gap(logits, ref).max()) for i, logits in answers if i == entry]
    run.failed = sum(not gap <= limit for gap in gaps)
    worst = float("nan") if any(gap != gap for gap in gaps) else max(gaps, default=float("nan"))
    run.checks["logit_gap"] = (worst, limit)
    run.note(f"compared {len(gaps)} answers of pool entries {picked}")


def control(run, dtype) -> float:
    """The check's number with the reference at ``dtype`` put in the
    program's place, over the same pool entries a run would compare: the
    control of the comparison. No program runs."""
    run.program["weights"], run.program["pool"] = inputs(run)
    picked = random.Random(run.seed).sample(range(run.traffic["pool"]),
                                            min(run.traffic["check_requests"], run.traffic["pool"]))
    worst = 0.0
    with torch.no_grad(), exact_float32():
        for entry in picked:
            ref = reference_logits(run, run.program["pool"][entry])
            low = reference_logits(run, run.program["pool"][entry], control=dtype)
            worst = max(worst, float(logit_gap(low, ref).max()))
    return worst
