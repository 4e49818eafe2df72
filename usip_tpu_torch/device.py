"""The device under the port's models, training and serving: the device a
caller names (``resolve_device``), and the CUDA graphs that the eval forward
(``inference.KeypointPipeline.infer``) and both train steps (``train.steps``)
replay, each site keeping its graphs in a ``GraphCache``. A site keeps only
its key, how it writes its batch and draws into ``graph.inputs``, and its
spans. Of the port this imports only ``ops.kernels`` (the launch counts).
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import torch

from usip_tpu_torch.ops import kernels


def resolve_device(device) -> torch.device:
    """The torch device named by ``device``; a CUDA device raises when CUDA is
    absent rather than carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


class ForwardGraph:
    """``forward(*inputs) -> outputs`` on CUDA tensors as a CUDA graph:
    captured once over the static ``inputs`` (copies of the example
    inputs), replayed after the caller writes new values into them.

    The capture follows the recipe of torch's CUDA-graph notes (whole-network
    capture): 3 eager calls on a side stream, then ``torch.cuda.graph`` into
    the memory ``pool``. The static ``outputs`` hold a replay's results until
    the next replay. Several graphs may share one pool where every replay
    runs on one stream and its caller copies the outputs it keeps before the
    next: the inputs live outside the pool, so nothing of the pool outlives a
    replay. The graph's kernel launches (``kernels.LAUNCHES``) count once a
    replay and never at the capture, which runs nothing. The capture leaves
    other threads free to work on the device meanwhile (``torch.cuda.graph``'s
    ``'thread_local'`` mode), as a train loader's copies do."""

    def __init__(self, forward: Callable, inputs: Tuple[torch.Tensor, ...],
                 pool):
        self.device = inputs[0].device
        self.inputs = tuple(t.clone(memory_format=torch.contiguous_format)
                            for t in inputs)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                for _ in range(3):
                    forward(*self.inputs)
            stream.wait_stream(side)
            before = dict(kernels.LAUNCHES)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.outputs = forward(*self.inputs)
            self.launches = kernels.take_launches(kernels.LAUNCHES, before)

    def replay(self) -> Tuple[torch.Tensor, ...]:
        """``forward`` on the values in ``inputs``: the static outputs."""
        with torch.cuda.device(self.device):
            self.graph.replay()
        kernels.add_launches(kernels.LAUNCHES, self.launches)
        return self.outputs


class StepGraph:
    """A train step's device part, ``device_step(*inputs) -> metrics`` (a
    dict of scalars, in the same order every call) ending in the backward of
    ``model``'s parameters, as one ``ForwardGraph`` in a memory pool of its
    own: the gradients live there until the caller's optimizer, run eagerly
    after ``replay``, has read them; ``replay`` points ``.grad`` back at
    them. ``ForwardGraph`` runs the step 3 times before the capture, so the
    model's buffers (BatchNorm statistics) are put back after it."""

    def __init__(self, model: torch.nn.Module, device_step: Callable,
                 inputs: Tuple[torch.Tensor, ...]):
        names = []

        def stacked(*tensors):
            metrics = device_step(*tensors)
            names[:] = metrics
            return torch.stack([v.float() for v in metrics.values()])

        kept = [t.detach().clone() for t in model.buffers()]
        self.graph = ForwardGraph(stacked, inputs, None)
        with torch.no_grad():
            for t, k in zip(model.buffers(), kept):
                t.copy_(k)
        self.model = model
        self.names = tuple(names)
        self.grads = [p.grad for p in model.parameters()]

    @property
    def inputs(self) -> Tuple[torch.Tensor, ...]:
        return self.graph.inputs

    def replay(self) -> Dict[str, torch.Tensor]:
        """The step on the values in ``inputs``: its metrics (copies), and
        the model's ``.grad`` on the new gradients."""
        values = self.graph.replay().clone()
        for p, g in zip(self.model.parameters(), self.grads):
            p.grad = g
        return dict(zip(self.names, values))


class GraphCache(dict):
    """A site's graphs by key, each captured at its key's first call;
    ``graph_counts`` counts the site's calls: ``captures``, ``replays`` of a
    graph captured before, and ``eager`` calls (``eager()``)."""

    def __init__(self):
        super().__init__()
        self.graph_counts = {"captures": 0, "replays": 0, "eager": 0}

    def graph(self, key: Hashable, capture: Callable[[], object]):
        """The graph of ``key``; ``capture()`` makes it at the first call."""
        graph = self.get(key)
        if graph is None:
            graph = self[key] = capture()
            self.graph_counts["captures"] += 1
        else:
            self.graph_counts["replays"] += 1
        return graph

    def eager(self) -> None:
        self.graph_counts["eager"] += 1
