"""Device time of a model's units (a roofline's unit of work), and the
shapes that their work is counted from.

Forward hooks open a ``record_function`` range named
``perfbench.unit.<name>`` when a unit's first module starts and close it
when its last module returns, and keep the shapes each occurrence saw.
A few eager forwards of the program's deploy module run under the
profiler; each unit's device time is that of every kernel launched inside
its range (trace.attribute), whatever the kernel's name."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from perfbench.harness import trace as tr

PREFIX = "perfbench.unit."


def shapes(value: Any):
    """Tensors as (shape, itemsize), through tuples and lists; other values as they are."""
    if isinstance(value, torch.Tensor):
        return tuple(value.shape), value.element_size()
    if isinstance(value, (tuple, list)):
        return type(value)(shapes(v) for v in value)
    return value


def profile_units(device, module, example, units: Sequence[Tuple[str, Any, Any]],
                  forwards: int) -> List[Dict[str, Any]]:
    """For each unit ``(name, first module, last module)``: ``{"name",
    "inputs", "outputs", "device_us"}`` where inputs and outputs are the
    shapes of one occurrence (the first), and device_us its device time per
    forward (over ``forwards`` profiled forwards, after one unprofiled)."""
    seen: Dict[str, Dict[str, Any]] = {name: {"name": name} for name, _, _ in units}
    open_ranges: Dict[str, Any] = {}
    handles = []
    for name, first, last in units:
        def pre(_module, args, name=name):
            rec = torch.autograd.profiler.record_function(PREFIX + name)
            rec.__enter__()
            open_ranges[name] = rec
            seen[name].setdefault("inputs", shapes(args))

        def post(_module, _args, output, name=name):
            open_ranges.pop(name).__exit__(None, None, None)
            seen[name].setdefault("outputs", shapes(output))

        handles.append(first.register_forward_pre_hook(pre))
        handles.append(last.register_forward_hook(post))
    try:
        with torch.no_grad():
            module(example)
            device.sync()

            def run():
                for _ in range(forwards):
                    module(example)
                device.sync()

            events = tr.profile_events(run, device.activities())
    finally:
        for h in handles:
            h.remove()
    times = tr.attribute(events, PREFIX)
    out = []
    for name, _, _ in units:
        item = seen[name]
        item["device_us"] = sum(times.get(PREFIX + name, [])) / forwards
        out.append(item)
    return out


def roofline_share(run, units: List[Dict[str, Any]], work) -> Any:
    """The units' summed least time over their summed device time, in %;
    ``work(unit) -> (flops, bytes)``. Prints each unit's operations, bytes
    and bound. None where the trace gave the units no device time."""
    from perfbench.harness.peaks import least_s

    least_total = device_total = flops_total = bytes_total = 0.0
    for unit in units:
        flops, nbytes = work(unit)
        least, by = least_s(flops, nbytes)
        run.note(f"  unit {unit['name']}: {flops!r} FLOPs, {nbytes!r} bytes, bound {least * 1e6!r} us "
                 f"({by}), device {unit['device_us']!r} us")
        least_total += least
        device_total += unit["device_us"] * 1e-6
        flops_total += flops
        bytes_total += nbytes
    run.note(f"  all units: {flops_total!r} FLOPs, {bytes_total!r} bytes, bound "
             f"{least_total * 1e3!r} ms, device {device_total * 1e3!r} ms a forward")
    if device_total <= 0.0:
        return None
    return 100.0 * least_total / device_total
