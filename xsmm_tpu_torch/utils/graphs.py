"""CUDA graphs as the port's counterpart of ``jax.jit``.

The JAX package runs its distributed programs and its training and eval
steps compiled (``jax.jit``): traced once for each abstract signature of
their arguments, then dispatched as one program.  On the card the port
captures such a body into one ``torch.cuda.CUDAGraph`` a key and replays
it, so that no op is issued from the host once a key is captured:

* ``signature`` is the key of a list of tensors: each one's shape, dtype,
  strides and device, as ``jax.jit`` retraces on a new shape or dtype;
* ``capture`` warms the body up once, eagerly, on a side stream (what a
  library makes lazily for a stream exists before the capture: cuBLAS's
  workspace, the spgemm kernels' item counters), then captures it on the
  same stream.  Streams that the body forks from the capture stream and
  joins through events keep their order inside the graph.  The launch and
  hop counters that the capture moved (it ran nothing) are taken back and
  kept as the graph's ``Counts``, added again at each replay, so
  that every counter counts what the card ran.  ``Entry.replay`` copies
  a call's tensors into the graph's inputs where they differ, replays and
  counts the call's form.  A capture that fails raises ``RuntimeError``
  with the reason; nothing runs eagerly in its place;
* ``GraphCache`` holds a callable's graphs, at most ``capacity`` keys, the
  least recently used out (``evictions`` counts them).

A graph reads its inputs from the addresses it captured and writes its
outputs into its private memory pool; the callers (``parallel/dist_spmm``,
``models/engine``) copy inputs in where they differ and copy outputs out,
so that no call's result is overwritten by a later call.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch

# how a compiled callable ran each call: "graph" (a replay reading its
# inputs where they lie), "graph_copy" (a replay after copying the inputs
# into the graph's own), "eager" (op by op from the host), "captures" (the
# first call of a key: the eager warm-up, then the capture)
FORMS = ("graph", "graph_copy", "eager", "captures")
CAPACITY = 8
# graphs captured by this process (utils/trace.build_counts)
captures = 0


def new_forms() -> Dict[str, int]:
    return dict.fromkeys(FORMS, 0)


def graph_form(devices: Iterable[torch.device], compiled: Optional[bool],
               what: str, processes: int = 1) -> bool:
    """Whether ``what`` runs as CUDA graphs on ``devices`` (its local ranks'
    devices) within ``processes`` processes: by default wherever it can,
    that is on one card within one process; never under
    ``compiled=False``.  ``compiled=True`` where it cannot raises
    ``ValueError`` with the reason."""
    devs = set(devices)
    why = None
    if any(d.type != "cuda" for d in devs):
        why = "the CPU target runs the plain versions eagerly"
    elif processes > 1:
        why = ("the mesh spans processes: their transfers (gloo's, staged "
               "through host memory) cannot be captured")
    elif len(devs) > 1:
        why = "its ranks lie on several cards"
    if why is None:
        return compiled is not False
    if compiled:
        raise ValueError(f"{what}: compiled=True, but {why}")
    return False


def signature(tensors: Iterable[torch.Tensor]) -> tuple:
    """The abstract signature of ``tensors``: shape, dtype, strides and
    device of each."""
    return tuple((tuple(t.shape), t.dtype, tuple(t.stride()), t.device)
                 for t in tensors)


def _counter_dicts() -> List[Dict[str, int]]:
    """Every launch and hop counter of the port: the kernel wrappers'
    ``*launches`` dicts and the ring's hops."""
    from ..dnn import pooling, rnn_seq
    from ..ops import (packed_kernels, smm_packed, spgemm_kernels,
                       tiled_gemm_kernels, xcopy_kernels)
    from ..parallel import dist_spmm

    out = [dist_spmm.hops]
    for m in (smm_packed, spgemm_kernels, tiled_gemm_kernels, xcopy_kernels,
              packed_kernels, rnn_seq, pooling):
        out += [v for k, v in vars(m).items()
                if k.endswith("launches") and isinstance(v, dict)]
    return out


class Counts:
    """The counters a capture moved: (dict, key, increment) triples."""

    def __init__(self, moved: Sequence[tuple] = ()):
        self.moved = list(moved)

    @classmethod
    def around(cls, fn: Callable[[], Any]):
        """Run ``fn`` (a capture), take back what it added to the counters
        and return (its result, the ``Counts``)."""
        dicts = _counter_dicts()
        before = [dict(d) for d in dicts]
        try:
            out = fn()
        finally:
            moved = [(d, k, d[k] - b.get(k, 0)) for d, b in zip(dicts, before)
                     for k in d if d[k] != b.get(k, 0)]
            for d, k, n in moved:
                d[k] -= n
        return out, cls(moved)

    def add(self) -> None:
        for d, k, n in self.moved:
            d[k] += n


class Entry:
    """A captured program: its graph, the input tensors it reads, the
    outputs it writes at each replay, the ``Counts`` of one replay, and
    ``args``, the arguments as a caller passes them over those inputs."""

    def __init__(self, graph, inputs: Sequence[torch.Tensor], out,
                 counts: Counts, args: tuple = ()):
        self.graph, self.inputs, self.out, self.counts, self.args = (
            graph, list(inputs), out, counts, args)

    def replay(self, tensors: Sequence[torch.Tensor] = (),
               forms: Optional[Dict[str, int]] = None):
        """Copy each of ``tensors`` into the graph's input in its place
        (unless it is that tensor), replay once on the current stream,
        counted, and count the call in ``forms`` ("graph" where nothing was
        copied, else "graph_copy").  Returns the graph's outputs, which the
        next replay overwrites."""
        copied = False
        for mine, t in zip(self.inputs, tensors):
            if mine.data_ptr() != t.data_ptr():
                mine.copy_(t)
                copied = True
        self.graph.replay()
        self.counts.add()
        if forms is not None:
            forms["graph_copy" if copied else "graph"] += 1
        return self.out


def capture(body: Callable[[], Any], inputs: Sequence[torch.Tensor] = (),
            generators: Sequence = (), device: Optional[torch.device] = None,
            what: str = "the body", args: tuple = ()):
    """Warm ``body`` (which reads ``inputs``, passed to it as ``args``) up
    once on a side stream, then capture it into a CUDA graph on that
    stream: (the ``Entry``, the warm-up's outputs).  The ``generators`` (``torch.Generator``s the body
    draws from) are registered with the graph, so that each replay draws
    anew."""
    global captures
    dev = device if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    graph = torch.cuda.CUDAGraph()
    try:
        for g in dict.fromkeys(generators):
            graph.register_generator_state(g)
    except (AttributeError, RuntimeError) as e:
        raise RuntimeError(
            f"{what}: its generators cannot be registered with a CUDA graph "
            f"({e}); the body draws from them inside the graph") from e
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        warm = body()
    cur.wait_stream(side)

    def record():
        with torch.cuda.graph(graph, stream=side):
            return body()
    try:
        out, counts = Counts.around(record)
    except RuntimeError as e:
        raise RuntimeError(f"{what} could not be captured into a CUDA "
                           f"graph: {e}") from e
    cur.wait_stream(side)
    captures += 1
    return Entry(graph, inputs, out, counts, args), warm


class GraphCache:
    """A callable's graphs by key, at most ``capacity``, the least recently
    used evicted first (counted in ``evictions``)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.evictions = 0
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()

    def get(self, key):
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def put(self, key, entry) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries
