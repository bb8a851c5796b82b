"""NeuralEngine: a pipeline of hooks run over one status dict (counterpart
of pytorchvideo_tpu/engine/engine.py; upstream
pytorchvideo/neural_engine/engine.py:11-77).

The hooks are ordered by their declared inputs and outputs with the
standard library's ``graphlib`` (the JAX package uses networkx, which the
card's machine lacks). The contract is the JAX engine's: a hook runs after
the hooks that produce its inputs, and a graph with a duplicate output, an
input that no hook produces and the status lacks, or an output no hook can
produce raises (ValueError here; the JAX engine asserts). Where the graph
allows several orders the two engines may pick different ones.
"""

from __future__ import annotations

import graphlib
from typing import Iterator, List, MutableMapping, Union

from pytorchvideo_tpu_torch.engine.hook import HookBase


class NeuralEngine:
    """Runs hooks in dependency order over a status dict, each hook's
    outputs merged into it."""

    def __init__(self, hooks: List[HookBase]) -> None:
        self.hooks = hooks
        self.execution_order_func = NeuralEngine.topological_sort

    def get_execution_order(self, status):
        return self.execution_order_func(status, self.hooks)

    def set_execution_order_func(self, func):
        self.execution_order_func = func

    @staticmethod
    def topological_sort(status: MutableMapping, hooks: List[HookBase]) -> Iterator[HookBase]:
        """Yields the hooks in an order where each follows the producers of
        its inputs. The graph's nodes are names, with an edge from each input
        of a hook to each of its outputs (so a hook without inputs or
        outputs has no place in it, as in the JAX engine). A generator: the
        caller merges a hook's outputs into ``status`` before the next name
        is checked against it."""
        output_to_hook = {}
        for hook in hooks:
            for output in hook.get_outputs():
                if output in output_to_hook:
                    raise ValueError(f"duplicate output {output!r}")
                output_to_hook[output] = hook
        sorter = graphlib.TopologicalSorter()
        for hook in hooks:
            for output in hook.get_outputs():
                for name in hook.get_inputs():
                    sorter.add(output, name)
        pending = set(output_to_hook)
        for name in sorter.static_order():
            if name in pending:
                hook = output_to_hook[name]
                yield hook
                pending -= set(hook.get_outputs())
            elif name not in status:
                raise ValueError(f"missing pipeline input {name!r}")
        if pending:
            raise ValueError(f"outputs no hook produced: {sorted(pending)}")

    def run(self, status: MutableMapping) -> MutableMapping:
        for hook in self.get_execution_order(status):
            status.update(hook.run(status))
        return status

    def __enter__(self):
        return self

    def __exit__(self, type, value, traceback):
        pass

    def __call__(self, status: Union[MutableMapping, str]) -> MutableMapping:
        """``status`` is a dict of the pipeline's inputs, or a path, which
        means ``{"path": path}``."""
        if isinstance(status, str):
            status = {"path": status}
        return self.run(status)
