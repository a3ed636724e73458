"""One step of a run loop captured as a CUDA graph that advances its own
state: :func:`workloads.stokes.run` and :meth:`parallel.spmd.EnsembleStep.run`
replay it once a step instead of launching the step's kernels one by one
from Python, which the host does slower than the card runs them."""

from __future__ import annotations

from typing import Any, Callable

import torch


def capture_step(step: Callable[[dict], tuple], state: dict, device) -> tuple[dict, Any, Any]:
    """(static state, outputs, graph): one call of ``step`` (``step(state)``
    → (new state, outputs), reading nothing back to the host) captured as a
    CUDA graph on ``device``.  The static state starts as a copy of
    ``state``, keyed in the order of the step's new state; the graph steps
    it and copies the new state back into it, so each replay advances it by
    one step and rewrites ``outputs``.

    A warm-up call on a side stream first fills the caches and workspaces
    the step reads; its result is dropped, and any side effect of it beyond
    its result (a device counter it adds to) is the caller's to undo."""
    static = {k: v.clone() for k, v in state.items()}
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # a capture stream of this card: torch.cuda.graph's default one is
        # made once, on the card current at its first use
        with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
            new, outputs = step(static)
            for k, v in new.items():
                static[k].copy_(v)
    return {k: static[k] for k in new}, outputs, graph
