"""CUDA graphs for the training chunk and the refinement sweep: the port's
counterpart of the JAX package's one-program dispatch (``lax.scan`` under
``jax.jit``).

* ``capture(fn, stream, name)`` records ``fn``'s launches on ``stream`` into
  a ``torch.cuda.CUDAGraph`` and returns a ``Captured``, whose ``replay()``
  runs them again on the current stream. A capture that fails raises: there
  is no eager fallback on the card. Each capture is a ``graph/capture``
  span (``utils/profiling.span``) with the graph's ``name``, so a capture
  made again where a replay was meant shows in a trace.
* ``count_launch(wrapper, plan)`` is how a counted kernel wrapper (its
  ``launches`` and ``plan_launches``) adds a launch. Inside a capture nothing
  runs yet, so the launch is recorded for the graph instead, and every replay
  of the graph adds the launches it holds: the counts stay the number of
  kernels that ran.
* ``warm_up(fn, stream, tensors)`` runs ``fn`` once on ``stream`` (cuDNN's
  plans, cuBLAS's workspace and the allocator settle before a capture) and
  then writes every tensor of ``tensors`` back as it was, so the warm-up
  leaves no trace in the results.

A graph replays on fixed addresses: its inputs are static tensors that the
caller refills, its state (parameters, moments, counters, resident data)
must stay where it was at capture, and its intermediates live in a private
memory pool that the graph keeps until it is freed.
"""

from __future__ import annotations

import torch

from weaklysuperviseddl_tpu_torch.utils.profiling import span

_recording: list[list] = []   # the launch lists of the captures in progress


def count_launch(wrapper, plan=None):
    """One launch of ``wrapper``'s kernel: ``wrapper.launches`` (and
    ``wrapper.plan_launches[plan]``) gain one now, or, during a capture, at
    every replay of the graph."""
    if _recording and torch.cuda.is_current_stream_capturing():
        _recording[-1].append((wrapper, plan))
        return
    wrapper.launches += 1
    if plan is not None:
        wrapper.plan_launches[plan] += 1


class Captured:
    """A captured graph and the counted kernel launches it holds."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: list, seconds: float):
        self.graph = graph
        self.launches = launches
        self.capture_seconds = seconds

    def replay(self):
        self.graph.replay()
        for wrapper, plan in self.launches:
            wrapper.launches += 1
            if plan is not None:
                wrapper.plan_launches[plan] += 1


def capture(fn, stream: torch.cuda.Stream, name: str) -> Captured:
    """Capture ``fn()`` on ``stream`` into a new graph with a private pool."""
    import time

    graph = torch.cuda.CUDAGraph()
    launches: list = []
    t0 = time.perf_counter()
    _recording.append(launches)
    try:
        with span("graph/capture", graph=name), torch.cuda.graph(graph, stream=stream):
            fn()
    finally:
        _recording.pop()
    return Captured(graph, launches, time.perf_counter() - t0)


@torch.no_grad()
def warm_up(fn, stream: torch.cuda.Stream, tensors):
    """Run ``fn()`` once on ``stream`` and restore ``tensors`` afterwards."""
    saved = [t.detach().clone() for t in tensors]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.enable_grad():
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    for t, s in zip(tensors, saved):
        t.copy_(s)
