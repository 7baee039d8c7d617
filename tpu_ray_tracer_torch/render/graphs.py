"""Replayed CUDA graphs: the port's counterpart of the JAX package's compiled
executables.

The JAX package runs a frame, a fit step and a bench sweep as one launch of
an executable that ``jax.jit`` compiled once for its static arguments
(``_render_pallas_jit``, ``tpu_ray_tracer/render/pallas_backend.py:1454-1457``;
the jitted ``train_step``, ``tpu_ray_tracer/diff/inverse.py:263``;
``bench.py``'s ``fwd_many`` and ``fwdbwd_many``). Here the same work is
captured once into a ``torch.cuda.CUDAGraph`` and replayed: one graph launch
in place of a frame's launches (its packing and its kernel), or the ~600
operations of a fit step.

A captured graph reads and writes fixed addresses, so:

* the graph reads static input buffers, and a call copies the caller's
  tensors into them (one ``torch._foreach_copy_``) before the replay;
* every tensor a call returns is a fresh copy of the graph's output, so a
  later replay cannot change what the caller kept (JAX's arrays are
  immutable);
* what the capture derived on the host (the scene statics, the bounce
  count, row0 and rows, the shapes, which inputs require grad) is part of
  the graph's key: a call whose key differs replays, or captures, another
  graph. No ``.cpu()``, ``.item()`` or ``float()`` runs inside a capture.

``GraphCache`` holds the graphs of one caller, at most ``MAX_GRAPHS`` keys
and ``MAX_GRAPH_BYTES`` of device memory, and drops the least recently used.
A key's first use runs eagerly on a side stream: that is the warm-up, which
also builds the kernels and sets their launch attributes outside any
capture, and the bytes it adds to the device's reserved memory (the
allocator's cache emptied first) are the key's bytes (a graph keeps its
private pool, which holds about what the eager call held at its peak). Its
second use captures the graph on that stream and replays it, and later uses
replay (``GraphCache.run``). So a call made once (a scene rendered once)
pays no capture. A key whose bytes exceed the bound alone
(the plain pipeline's one-shot frame of a large scene) is never captured:
it runs eagerly on the current stream at every use, and ``over_bound``
counts those calls.

Every graphed call goes through one ``Graph``, and every key's per-tensor
half is ``signature``'s.

Launch accounting. The kernels' wrappers count the launches they make
(``.launches`` and the rest) and register their counters in
``utils/launches.py`` (``launch_counts``), so this module names no kernel.
A capture runs the wrappers without executing the kernels, so ``capture``
takes their increments back and records them, and each ``replay`` adds
what was recorded: the counters count the launches that execute.

While a torch profiler runs, the graphs' host work shows as spans
(``utils.timing.span``): ``trt.graph.lookup`` (the key's graph and its
guard), ``trt.graph.load`` (the input copies), ``trt.graph.replay`` (the
launch and its counts), ``trt.graph.fresh`` (the output clones), and
``trt.graph.warmup``, ``trt.graph.capture`` and ``trt.graph.eager`` for a
key's warm-up, each capture and each call over the bound.

While a graph is warmed up or captured, ``eager()`` is on: an entry point
reached from inside (the frame of a fit step, the frames of a bench sweep)
runs its eager body, and no capture nests in another.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple

import torch

from ..utils import launches
from ..utils.timing import span

# Graphs a cache keeps (keys seen once included); the least recently used
# goes first. Each keeps its private memory pool on the card (chip_smoke.py
# 9e (e) and 9f (e) measure them).
MAX_GRAPHS = 16
# Device memory the graphs of one cache may keep (``GraphCache.bytes``): a
# kernel frame's graph keeps ~14-70 MiB, a plain pipeline frame's or fit
# step's ~0.1-0.9 GiB, the 33-light 640x480 gradient's ~1.4 GiB, 20spheres
# 800x600 in one shot ~2.0 GiB, its key's warm-up and its graph alike (5.2
# and ~29 GiB while the root solve was plain; chip_smoke.py 9e, 9f,
# pipeline_profile.py).
MAX_GRAPH_BYTES = 8 << 30


# The kernels' launch counters (``.launches`` and their breakdowns) by name
launch_counts = launches.counts


_STATE = threading.local()


@contextlib.contextmanager
def eager():
    """Inside the block, every entry point of this thread runs its eager
    body: no graph is captured or replayed."""
    before = getattr(_STATE, "eager", False)
    _STATE.eager = True
    try:
        yield
    finally:
        _STATE.eager = before


def active(device: torch.device) -> bool:
    """Whether an entry point on ``device`` goes through graphs: a CUDA
    device, outside ``eager()`` and outside any capture."""
    return (device.type == "cuda" and not getattr(_STATE, "eager", False)
            and not torch.cuda.is_current_stream_capturing())


class CudaGraphs:
    """The device side: one side stream per device, the warm-up and the
    capture on it, the replay on the current stream."""

    def __init__(self):
        self._streams = {}

    def _side(self, device) -> torch.cuda.Stream:
        index = torch.device(device).index
        index = torch.cuda.current_device() if index is None else index
        if index not in self._streams:
            self._streams[index] = torch.cuda.Stream(index)
        return self._streams[index]

    @staticmethod
    def grown(device, fn):
        """(``fn()``, the bytes it added to the device's reserved memory).
        The device is synchronized and the allocator's cache emptied first,
        so the growth is about what ``fn`` held at its peak above the memory
        in use before it. The peak statistics are left as they are."""
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(device)
        out = fn()
        return out, torch.cuda.memory_reserved(device) - before

    def warmup(self, device, fn):
        """``fn()`` on the side stream, ordered after the current stream's
        work and before its later work."""
        current = torch.cuda.current_stream(device)
        side = self._side(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn()
        current.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(current)  # the caller frees it on its own stream
        return out

    def capture(self, device, fn, pool=None):
        """(graph, ``fn()``'s outputs, the bytes the capture added to the
        device's reserved memory, ``grown``) from a capture of ``fn`` on the
        side stream into a private memory pool, or into ``pool``."""
        graph = torch.cuda.CUDAGraph()

        def run():
            with torch.cuda.graph(graph, pool=pool, stream=self._side(device)):
                return fn()

        out, nbytes = self.grown(device, run)
        return graph, out, nbytes

    @staticmethod
    def pool(graph):
        return graph.pool()

    @staticmethod
    def replay(graph) -> None:
        graph.replay()


# The device side of every graph; tests put a fake in its place.
BACKEND = CudaGraphs()


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


def fresh(out):
    """A copy of every tensor in ``out`` (a tensor, or tuples and lists of
    them; None kept)."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(fresh(o) for o in out)
    return out


class Captured(NamedTuple):
    graph: object
    outputs: object     # the graph's static outputs, rewritten by each replay
    counts: dict        # the launches each replay makes, by ``launch_counts`` name
    held: list          # what ``hold`` kept alive for the graph
    nbytes: int = 0     # the device memory its capture reserved (its pool's growth)


def hold(value):
    """Keep ``value`` alive as long as the graph being captured, if any.

    A graph reads the tensors it was captured with at their addresses, so a
    tensor made outside the capture that it reads (a table memoised by
    ``kernel_backend._memo``) must outlive the graph, whoever else drops
    it. Returns ``value``."""
    held = getattr(_STATE, "held", None)
    if held is not None:
        held.append(value)
    return value


def warmup(device, fn):
    """``fn()`` eagerly on the side stream, under ``eager()``."""
    with eager():
        return BACKEND.warmup(device, fn)


def capture(device, fn, pool=None) -> Captured:
    """Capture ``fn()`` under ``eager()``; the launches its wrappers counted
    are taken back and kept as the graph's ``counts``."""
    before = launches.counts()
    outer, _STATE.held = getattr(_STATE, "held", None), []
    try:
        with eager():
            graph, out, nbytes = BACKEND.capture(device, fn, pool)
        after = launches.counts()
        held = _STATE.held
    finally:
        launches.restore(before)
        _STATE.held = outer
    return Captured(graph, out, {k: after[k] - before[k] for k in after if after[k] != before[k]},
                    held, nbytes)


def replay(captured: Captured) -> None:
    """Launch the graph and add its launches to the counters."""
    with span("trt.graph.replay"):
        BACKEND.replay(captured.graph)
        launches.add(captured.counts)


def signature(tensors, grad: bool = False) -> tuple:
    """The per-tensor half of a graph's key: each tensor's shape, dtype and
    device and, for a differentiable graph (``grad``), whether it requires
    grad. The caller adds what its capture fixed on the host."""
    return tuple((tuple(t.shape), t.dtype, t.device, grad and t.requires_grad) for t in tensors)


class Graph:
    """A graph of ``fn(*inputs)`` whose inputs are static buffers: a call
    copies its tensors into them (``load``), replays and returns fresh
    outputs.

    Captured with grad mode on and an input requiring grad, it is
    differentiable: a second graph, ``backward`` (the outputs' gradient
    into the inputs that require grad, for cotangents loaded into static
    buffers), is captured into the pool of the first, ``forward``, where the
    forward leaves what it reads, and a call goes through autograd
    (``_GraphFunction``). The pool holds one call's saved tensors at a time
    (``current``'s): a backward of an earlier call replays its forward
    first."""

    def __init__(self, device, fn, inputs):
        self.fn = fn  # its closure may hold tensors the graph reads
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
        self.inputs = [t.detach().clone().requires_grad_(grad and t.requires_grad)
                       for t in inputs]
        self.forward = capture(device, lambda: fn(*self.inputs))
        self.backward, self.current, self.nbytes = None, None, self.forward.nbytes
        if grad:
            outputs = list(_tensors(self.forward.outputs))
            self.wanted = [i for i, t in enumerate(self.inputs) if t.requires_grad]
            self.cotangents = [torch.zeros_like(t) for t in outputs]
            self.backward = capture(
                device, lambda: torch.autograd.grad(
                    outputs, [self.inputs[i] for i in self.wanted], self.cotangents,
                    allow_unused=True),
                pool=BACKEND.pool(self.forward.graph))
            self.nbytes += self.backward.nbytes

    def load(self, tensors, into=None) -> None:
        """Copy the call's tensors into the static inputs, or into ``into``
        (the cotangents' buffers), in one multi-tensor copy."""
        into = self.inputs if into is None else into
        if into:
            with span("trt.graph.load"), torch.no_grad():
                torch._foreach_copy_(into, list(tensors))

    def replay(self, inputs):
        """Load ``inputs`` and replay the forward graph; its static outputs,
        which the next replay rewrites."""
        self.load(inputs)
        replay(self.forward)
        return self.forward.outputs

    def __call__(self, inputs):
        if self.backward is not None:
            return _GraphFunction.apply(self, *inputs)
        outputs = self.replay(inputs)
        with span("trt.graph.fresh"):
            return fresh(outputs)


class _GraphFunction(torch.autograd.Function):
    """A differentiable graph's call: its forward graph replayed in
    ``forward``, its backward graph in ``backward``, fresh outputs and
    gradients. Inputs: the ``Graph``, then the call's tensors."""

    @staticmethod
    def forward(ctx, graph, *inputs):
        ctx.graph, ctx.token = graph, object()
        ctx.inputs, ctx.versions = inputs, [t._version for t in inputs]
        outputs = graph.replay(inputs)
        graph.current = ctx.token
        with span("trt.graph.fresh"):
            return fresh(outputs)

    @staticmethod
    def backward(ctx, *cotangents):
        graph = ctx.graph
        if graph.current is not ctx.token:  # a later call's forward replaced what it saved
            if [t._version for t in ctx.inputs] != ctx.versions:
                raise RuntimeError("graphs: an input of a differentiable graph was modified in "
                                   "place between the call's forward and its backward")
            graph.replay(ctx.inputs)
            graph.current = ctx.token
        graph.load(cotangents, graph.cotangents)
        replay(graph.backward)
        with span("trt.graph.fresh"):
            grads = dict(zip(graph.wanted, fresh(graph.backward.outputs)))
        return (None, *(grads.get(i) for i in range(len(graph.inputs))))


class GraphCache:
    """The graphs of one caller by key, at most ``MAX_GRAPHS`` keys and
    ``MAX_GRAPH_BYTES`` of graphs.

    ``run`` makes one call of a key: ``fn()`` at the key's first use, its
    warm-up, which measures the key's bytes; from its second use a replay of
    the graph that ``make()`` captured then, after dropping the least
    recently used graphs until the cache's bytes and the key's fit under the
    bound. A graph's bytes are then what its capture reserved (``nbytes``),
    which also covers a backward graph that the warm-up did not run. A key
    whose bytes exceed the bound alone is never captured (or its graph is
    dropped at once): ``fn()`` runs eagerly at its every use, counted in
    ``over_bound``. ``captures`` counts the captures and ``capture_s`` holds
    the host seconds of each."""

    def __init__(self):
        self._entries = collections.OrderedDict()  # key -> [graph or None, bytes or None]
        self.captures = 0
        self.capture_s = []
        self.over_bound = 0

    def __len__(self) -> int:
        return sum(entry[0] is not None for entry in self._entries.values())

    def graphs(self) -> list:
        """The captured graphs, least recently used first."""
        return [entry[0] for entry in self._entries.values() if entry[0] is not None]

    def bytes(self, key=None):
        """The bytes of ``key`` (what its warm-up added to the reserved
        memory, then what its capture reserved; None if not measured), or
        with no key the sum over the captured graphs."""
        if key is not None:
            entry = self._entries.get(key)
            return None if entry is None else entry[1]
        return sum(entry[1] or 0 for entry in self._entries.values() if entry[0] is not None)

    def seen(self, key) -> bool:
        """Record a use of ``key``; whether it was used before."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return True
        self._entries[key] = [None, None]
        while len(self._entries) > MAX_GRAPHS:
            self._entries.popitem(last=False)
        return False

    def _over(self, key) -> bool:
        nbytes = self._entries[key][1]
        return nbytes is not None and nbytes > MAX_GRAPH_BYTES

    def lookup(self, key, make):
        """The key's graph, captured by ``make()`` at its second use; None at
        its first use and over the bound."""
        if not self.seen(key) or self._over(key):
            return None
        if self._entries[key][0] is None:
            return self.recapture(key, make)
        return self._entries[key][0]

    def run(self, key, device, make, fn, inputs, *, warm=False, current=None):
        """One use of ``key``: ``graph(inputs)`` on the key's graph
        (``lookup``), captured anew where ``current(graph)`` is false (the
        tensors it reads moved); else ``fn()``: the key's warm-up
        (``warmup``, its bytes measured by ``CudaGraphs.grown``) at its first
        use or where ``warm`` asks for one, or over the bound an eager call on
        the current stream, counted in ``over_bound``."""
        with span("trt.graph.lookup"):
            if warm:
                self.seen(key)
                graph = None
            else:
                graph = self.lookup(key, make)
                if graph is not None and current is not None and not current(graph):
                    graph = self.recapture(key, make)
        if graph is not None:
            return graph(inputs)
        if key in self._entries and self._over(key):
            self.over_bound += 1
            with span("trt.graph.eager"), eager():
                return fn()
        with span("trt.graph.warmup"):
            out, nbytes = BACKEND.grown(device, lambda: warmup(device, fn))
        if key in self._entries:
            self._entries[key][1] = nbytes
        return out

    def _make_room(self, need: int) -> None:
        """Drop the least recently used graphs until ``need`` more bytes fit."""
        for entry in self._entries.values():
            if self.bytes() + need <= MAX_GRAPH_BYTES:
                return
            entry[0] = None

    def recapture(self, key, make):
        """Capture the key's graph anew (its inputs moved), and return it
        (None if it is over the bound)."""
        entry = self._entries[key]
        entry[0] = None  # drop the old graph before the new one's pool
        self._make_room(entry[1] or 0)
        t0 = time.perf_counter()
        with span("trt.graph.capture"):
            graph = make()
        self.capture_s.append(time.perf_counter() - t0)
        self.captures += 1
        entry[1] = getattr(graph, "nbytes", entry[1])
        if self._over(key):
            return None
        self._make_room(entry[1] or 0)
        entry[0] = graph
        return graph

    def clear(self) -> None:
        self._entries.clear()
