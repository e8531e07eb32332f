"""CUDA graphs over in-place state: the port's counterpart of jax.jit's
shape-keyed cache with donation.

nlt_tpu runs each hot path as one compiled program: the training step
jitted with its state donated (``nlt_tpu/parallel/train.py``), the eval
step and the serving forward (``nlt_tpu/serve.py``). ``Captured(fn)``
gives the port the same shape: one CUDA graph per key, replayed.

- The key is the structure of the call's arguments (containers, the
  values of non-tensor leaves), and the shape, strides and dtype of each
  tensor leaf. Arguments named in ``by_address`` are used where they
  lie, so their leaves' addresses are part of the key: a replay reads
  and writes those tensors themselves (donation: the training step
  writes the new state into them). Every other tensor is copied, on each
  call, into a static input buffer the key allocated at capture.
- A key's first call is its warm-up: ``fn`` runs for real, eagerly, on a
  side stream, and its results are the call's. That run triggers the
  lazy kernel build (``ops/_build.py``), the split routes' plan lookups
  and cuDNN's and cuBLAS's choices before capture. The key's second
  call captures ``fn`` with ``torch.cuda.graph`` on the static buffers
  (nothing runs at capture), and it and every later call copy their
  inputs into the buffers and replay. (A program called once is never
  captured.)
- All keys of one runner capture into one memory pool
  (``torch.cuda.graph_pool_handle``), so a last partial batch or a
  validation batch size does not double memory. They replay one at a
  time on one stream, and no output is read from the pool after another
  replay (below), so sharing the pool is safe.
- Output contract: a graph's outputs live in its pool and the next
  replay of any key of the runner may overwrite them, so each call
  hands out clones of them. An output that is a ``by_address`` input
  (the donated state) is returned as that tensor. Kept outputs (losses
  across steps, ``Server.benchmark``'s n requests) are therefore
  distinct tensors.
- What ``fn`` reads from outside its arguments (a module attribute, a
  route or dispatch switch, torch's TF32 switches) is read at capture
  and replayed as it was. What may change between calls is passed as an
  argument, so that it is part of the key (the server's fields and
  packing are); non-tensor arguments must be hashable.
- On a CPU tensor ``fn`` runs eagerly: that is the device the caller
  asked for, not a fallback. On a CUDA tensor a failure to warm up,
  capture or replay raises; nothing falls back to eager.
- ``disabled()`` runs every runner eagerly inside it (the counterpart of
  ``jax.disable_jit()``): the eager side of a comparison.
- Launch counters: the kernels' wrappers count Python calls
  (``launch_counter``), and a replay makes none. A capture records each
  counter's change, takes it back (nothing launched), and every replay
  adds it again, so counts read the same eager or replayed.
- Spans (``utils/trace.py``, while a profiler runs): each call on the
  graph path is ``graph.call``, holding ``graph.key`` (the arguments
  flattened, their metadata and the lookup), then ``graph.warm_up`` or
  ``graph.capture`` on a key's first two calls, else ``graph.copy_in``,
  ``graph.replay`` and ``graph.clone_out``. ``CAPTURES`` counts warm-ups
  and captures by program name: a window of replays adds none.

What runs eagerly on the card is decided once, before the first step,
by ``eager_reason`` (the rule), and logged; never by catching a capture
failure.
"""

import contextlib
import threading

import torch

from ..utils import logging as logutil
from ..utils.trace import span

logger = logutil.Logger(loggee="graph")

_STATE = threading.local()
# Replays by program name, over every runner of the process.
REPLAYS = {}
# Warm-ups plus captures by program name, over every runner.
CAPTURES = {}
# The kernels' launch counters ({name: count} dicts), registered by the
# wrappers' modules at import.
COUNTERS = []


def launch_counter(counts):
    """Register a wrapper module's {kernel: launches} dict, so that a
    replay adds what its capture counted. Returns the dict."""
    COUNTERS.append(counts)
    return counts


@contextlib.contextmanager
def disabled():
    """Run every Captured program eagerly inside this context (this
    thread), as ``jax.disable_jit()`` does."""
    prev = getattr(_STATE, "disabled", False)
    _STATE.disabled = True
    try:
        yield
    finally:
        _STATE.disabled = prev


def eager_reason(device, model=None, mesh=None):
    """The rule: why a program of `model` on `device` under `mesh` runs
    eagerly, or None when it is captured on the card.

    - the CPU: no graphs there; the same body runs eagerly;
    - a mesh over a process group: its collectives run through the
      group (gloo through the host); capturing NCCL across ranks is
      still to do;
    - a stochastic loss (E-LPIPS): its transforms are drawn on the host
      every step, which changes the program on every draw."""
    device = torch.device(device)
    if device.type != "cuda":
        return "device %s: no CUDA graphs" % device
    if mesh is not None and mesh.active:
        return ("a mesh of %d rank(s) over a process group: collectives "
                "through the group" % mesh.world)
    if model is not None and model.has_stochastic_loss():
        return ("a stochastic loss: transforms drawn on the host change "
                "the program every step")
    return None


def wrap(fn, name, reason, by_address=()):
    """``Captured(fn)`` when the rule gave no `reason`, else `fn` itself
    (eager); logs which, once."""
    if reason is not None:
        logger.info("%s: eager (%s)", name, reason)
        return fn
    logger.info("%s: CUDA graphs, one per input shape", name)
    return Captured(fn, by_address=by_address, name=name)


def _flatten(x, tensors):
    """A hashable description of `x` with its tensors appended to
    `tensors` (dict keys in sorted order)."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return None
    if isinstance(x, dict):
        return ("d", tuple((k, _flatten(x[k], tensors)) for k in sorted(x)))
    if isinstance(x, (list, tuple)):
        return ("l" if isinstance(x, list) else "t",
                tuple(_flatten(v, tensors) for v in x))
    return ("v", x)


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    kind, body = spec
    if kind == "d":
        return {k: _unflatten(s, it) for k, s in body}
    if kind in ("l", "t"):
        vals = [_unflatten(s, it) for s in body]
        return vals if kind == "l" else tuple(vals)
    return body


def _meta(t):
    return (tuple(t.shape), tuple(t.stride()), t.dtype, t.device)


class _CudaGraphs:
    """The card's side of a runner: a side stream for its warm-ups and
    captures, and one memory pool for all its graphs."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm_up(self, fn, inputs):
        """fn() run eagerly on the side stream; the current stream then
        waits for it."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        for t in inputs:
            t.record_stream(self.stream)
        return out

    def capture(self, fn, addressed):
        """(graph, fn()'s outputs) with fn captured, not run: the
        `addressed` tensors are read and written only at replays."""
        del addressed
        graph = torch.cuda.CUDAGraph()
        # thread_local: the loader and placement threads may use the
        # card while this thread captures.
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = fn()
        return graph, out

    @staticmethod
    def replay(graph):
        graph.replay()


def _graphs_on(device):
    """The graph backend for `device`, or None to run eagerly there."""
    return _CudaGraphs if device.type == "cuda" else None


# A key not seen before (a warm-up's key maps to None until its capture).
_NEW = object()


class _Graph:
    """One key's graph: its static input buffers, its outputs' layout and
    the launch counts one replay makes."""

    def __init__(self, graph, inputs, out_spec, outs, counts):
        self.graph = graph
        self.inputs = inputs        # static buffers of the copied tensors
        self.out_spec = out_spec
        # Per output leaf: ("addr", i) the i-th by-address leaf, or
        # ("pool", tensor) a tensor in the pool (cloned out).
        self.outs = outs
        self.counts = counts        # [(counter dict, {name: delta})]


class Captured:
    """``fn(*args, **kwargs)`` as one CUDA graph per key (module
    docstring). ``by_address``: positions of the arguments used in place
    (read, and written by a donating body). ``captures`` and
    ``replays`` count this runner's graphs and replays (``REPLAYS``:
    every runner's, by name)."""

    def __init__(self, fn, by_address=(), name="program"):
        self.fn = fn
        self.by_address = frozenset(by_address)
        self.name = name
        self._graphs = {}
        self._backend = None
        self.captures = 0
        self.replays = 0

    def __call__(self, *args, **kwargs):
        if getattr(_STATE, "disabled", False):
            return self.fn(*args, **kwargs)
        with span("graph.call"):
            with span("graph.key"):
                addressed, copied = [], []
                spec = (tuple(_flatten(a, addressed if i in self.by_address
                                       else copied)
                              for i, a in enumerate(args)),
                        _flatten(kwargs, copied))
                devices = {t.device for t in addressed + copied}
                if len(devices) > 1:
                    raise ValueError("%s: tensors on several devices: %s"
                                     % (self.name,
                                        sorted(map(str, devices))))
                device = devices.pop() if devices else None
                backend = (_graphs_on(device) if device is not None
                           else None)
                if backend is not None:
                    key = (spec, tuple(map(_meta, copied)),
                           tuple(_meta(t) + (t.data_ptr(),)
                                 for t in addressed))
                    entry = self._graphs.get(key, _NEW)
            if backend is not None:
                if self._backend is None:
                    self._backend = backend(device)
                return self._run(key, entry, spec, addressed, copied)
        # No graphs on this device: the body runs eagerly, outside the
        # runner's spans.
        return self.fn(*args, **kwargs)

    def _run(self, key, entry, spec, addressed, copied):
        """The call on the graph path: warm-up, capture or replay."""
        if entry is _NEW:
            # The warm-up is the call itself: its results are the call's.
            self._graphs[key] = None
            CAPTURES[self.name] = CAPTURES.get(self.name, 0) + 1
            with span("graph.warm_up"):
                return self._backend.warm_up(
                    lambda: self._call_on(spec, addressed, copied), copied)
        if entry is None:
            CAPTURES[self.name] = CAPTURES.get(self.name, 0) + 1
            with span("graph.capture"):
                entry = self._graphs[key] = self._capture(spec, addressed,
                                                          copied)
        with span("graph.copy_in"):
            if copied:
                torch._foreach_copy_(entry.inputs, copied)
        with span("graph.replay"):
            for counter, delta in entry.counts:
                for k, v in delta.items():
                    counter[k] += v
            self._backend.replay(entry.graph)
        self.replays += 1
        REPLAYS[self.name] = REPLAYS.get(self.name, 0) + 1
        with span("graph.clone_out"):
            return _unflatten(entry.out_spec, iter(
                addressed[v] if how == "addr" else v.clone()
                for how, v in entry.outs))

    def _call_on(self, spec, addressed, copied):
        """fn on the given leaves, in the call's structure."""
        it_a, it_c = iter(addressed), iter(copied)
        args = tuple(_unflatten(s, it_a if i in self.by_address else it_c)
                     for i, s in enumerate(spec[0]))
        return self.fn(*args, **_unflatten(spec[1], it_c))

    def _capture(self, spec, addressed, copied):
        inputs = [t.clone() for t in copied]
        before = [dict(c) for c in COUNTERS]
        graph, static_out = self._backend.capture(
            lambda: self._call_on(spec, addressed, inputs), addressed)
        # Nothing launched at capture: take the wrappers' counts back and
        # keep them for the replays.
        counts = []
        for counter, was in zip(COUNTERS, before):
            delta = {k: counter[k] - was.get(k, 0) for k in counter}
            counter.update(was)
            if any(delta.values()):
                counts.append((counter, delta))
        leaves = []
        out_spec = _flatten(static_out, leaves)
        ids = {id(t): i for i, t in enumerate(addressed)}
        outs = [("addr", ids[id(t)]) if id(t) in ids else ("pool", t)
                for t in leaves]
        self.captures += 1
        logger.info("%s: captured a graph for %d input tensor(s) (%d in "
                    "place)", self.name, len(copied), len(addressed))
        return _Graph(graph, inputs, out_spec, outs, counts)
