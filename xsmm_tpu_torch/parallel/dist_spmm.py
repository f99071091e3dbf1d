"""Distributed (multi-card / multi-host) partitioned SpMM / GEMM: the port
of ``xsmm_tpu/parallel/dist_spmm.py``.

Reference context: the reference's only multi-node mechanism is GxM's MLSL
data-parallel gradient allreduce (samples/deeplearning/gxm/src/Conv.cpp:350);
the core library has no network code.  The BASELINE targets ask for
row/block-partitioned matrices with halo exchange overlapped with compute
(BASELINE.md, SURVEY.md §5).

Design, one controller a process (``parallel/mesh.py``): the JAX package's
``shard_map`` bodies become loops over the local ranks of a mesh axis, each
rank's calls made on its own device and CUDA streams.  The **ring
schedule** is the JAX package's:

  A is row-partitioned: rank e holds A_e = A[e*Ml:(e+1)*Ml, :]  (all K)
  B is row(K)-partitioned: rank e holds B_e = B[e*Kl:(e+1)*Kl, :]
  C_e = sum_j A_e[:, j-block] @ B_j

Each of d steps multiplies the resident B panel with the matching column
block of A_e, then rotates the panel one hop: rank e receives rank e+1's
panel.  Within a process a hop is a device copy on the receiving rank's
communication stream; across processes it is a ``torch.distributed``
point-to-point transfer (gloo's takes CPU tensors, so a card's panel is
staged through host memory, counted in ``mesh.staged``).

Also provided: the no-communication column-sharded variant (B split along N,
A replicated), and the data-parallel wrappers over the batched SMM and the
packed LA kernels (no collectives).

Inputs and outputs are ``mesh.Sharded`` values; ``shard_rows`` and
``shard_cols`` place a global array with the JAX package's zero padding.

Compiled, as the JAX package's ``jax.jit(shard_map(...))``: on the card the
callable every builder returns runs its program as one CUDA graph a key
(``utils/graphs.py``; the key is the shapes, dtypes, strides and devices of
the inputs' shards). The first call of a key runs the program eagerly on a
side stream, as the warm-up and the call's result, then captures it: each
rank's compute and communication streams fork from the capture stream and
join it through the events of the eager schedule, so the graph keeps the
ring's order (hop s under the compute of sub-panels s+1..S). Later calls
replay it: inputs that are the graph's own (``fn.entry(*args).args``, as a
solver loop refills its buffers) are read where they lie, any other tensors
are copied into them first, and every output is copied out of the graph's
pool, so no call's result is overwritten by a later call. The spgemm
kernels' item counters need no reset between replays: each launch leaves
its stream's pair at zero (``ops/csrc/spgemm.cu`` ``sched_counters``), so
every replay starts from zero, bit for bit the eager call. The hop and
launch counters count each replay; ``forms`` counts every call under the
form it ran. Compiled is the default wherever the mesh lies in one process
with all its local ranks on one card; ``compiled=False`` gives the eager
form (the counterpart of ``jax.disable_jit()``). Meshes over several cards
or processes run eagerly (gloo's host-staged transfers cannot be captured),
as does the CPU target; ``compiled=True`` there raises ``ValueError``. A
capture that fails raises; nothing runs eagerly in its place. Each callable
keeps at most ``utils/graphs.CAPACITY`` graphs, the least recently used
evicted first (``fn.cache.evictions``).
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.smm import _matmul, as_tensor
from ..utils import graphs, trace
from .mesh import (COMM_TIMEOUT_S, Mesh, NamedSharding, P, Sharded,
                   device_put, on_rank, staged)

F32 = torch.float32

# hops since the last reset_counts(): device copies within a process and
# point-to-point transfers between processes (a panel stream each)
hops: Dict[str, int] = {"device": 0, "process": 0}
# the builders' calls by the form they ran (utils/graphs.FORMS)
forms: Dict[str, int] = graphs.new_forms()


def reset_counts() -> None:
    for counts in (hops, forms):
        for k in counts:
            counts[k] = 0


def _as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


def _event(stream):
    """An event recorded on ``stream`` now (None on the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _caller_stream(mesh: Mesh, rank: int):
    dev = mesh.device(rank)
    return torch.cuda.current_stream(dev) if dev.type == "cuda" else None


def _begin(mesh: Mesh, ranks: Sequence[int]) -> None:
    """Each rank's streams wait for the caller's stream (its inputs)."""
    for r in ranks:
        cur = _caller_stream(mesh, r)
        if cur is not None:
            for s in mesh.streams(r):
                s.wait_stream(cur)


def _finish(mesh: Mesh, rank: int, outs: Sequence[torch.Tensor]) -> None:
    """The caller's stream waits for the rank's compute stream, and the
    outputs (allocated there) are marked used on the caller's stream."""
    comp, _ = mesh.streams(rank)
    if comp is None:
        return
    cur = _caller_stream(mesh, rank)
    cur.wait_stream(comp)
    for t in outs:
        t.record_stream(cur)


def _used_on(ts: Sequence[torch.Tensor], stream) -> None:
    if stream is not None:
        for t in ts:
            t.record_stream(stream)


class _Ring:
    """One ring along a mesh axis: rotates each position's panels (a list
    of tensors a sub-panel) one hop, position e receiving position e+1's,
    after the compute event of the sub-panel on the sending rank."""

    def __init__(self, mesh: Mesh, group: List[int], tag0: int):
        self.mesh, self.group, self.d = mesh, group, len(group)
        self.local = [e for e in range(self.d) if mesh.is_local(group[e])]
        self.tag0 = tag0

    def hop(self, panels: Dict[int, List[torch.Tensor]],
            done: Dict[int, object], tag: int, label: str):
        """Returns (new panels, arrival events) for the local positions."""
        mesh, g, d = self.mesh, self.group, self.d
        new: Dict[int, List[torch.Tensor]] = {}
        ready: Dict[int, object] = {}
        sends, recvs = [], []
        for e in self.local:
            src = (e + 1) % d
            _, comm = mesh.streams(g[e])
            if mesh.is_local(g[src]):
                dev = mesh.device(g[e])
                with on_rank(mesh, g[e], comm), trace.scope(
                        f"ring.hop r{g[src]}->r{g[e]} {label}"):
                    if comm is not None and done[src] is not None:
                        comm.wait_event(done[src])
                    out = []
                    for p in panels[src]:
                        t = torch.empty(p.shape, dtype=p.dtype, device=dev)
                        t.copy_(p, non_blocking=True)
                        out.append(t)
                    _used_on(panels[src], comm)
                new[e] = out
                ready[e] = _event(comm)
                hops["device"] += len(out)
            else:
                recvs.append(e)
        for q in self.local:
            dst = (q - 1) % d
            if not mesh.is_local(g[dst]):
                sends.append(q)
        if sends or recvs:
            self._exchange(panels, done, sends, recvs, new, ready, tag)
        return new, ready

    def _exchange(self, panels, done, sends, recvs, new, ready, tag):
        """Point-to-point transfers with the neighbouring processes: every
        send posted, then every receive, then all waited on (each with the
        timeout); over gloo a card's panel crosses through pinned host
        memory."""
        import torch.distributed as dist

        mesh, g, d = self.mesh, self.group, self.d
        nccl = dist.get_backend() == "nccl"
        works, landing = [], []
        for q in sends:
            _, comm = mesh.streams(g[q])
            for j, p in enumerate(panels[q]):
                buf = p
                if comm is not None:
                    comm.wait_event(done[q])
                    if not nccl:
                        buf = torch.empty(p.shape, dtype=p.dtype,
                                          pin_memory=True)
                        with torch.cuda.stream(comm):
                            buf.copy_(p, non_blocking=True)
                        staged["transfers"] += 1
                        staged["bytes"] += buf.numel() * buf.element_size()
                    comm.synchronize()
                works.append(dist.isend(buf.contiguous(),
                                        mesh.owner(g[(q - 1) % d]),
                                        tag=self._tag(tag, q, j)))
                hops["process"] += 1
        for e in recvs:
            src = (e + 1) % d
            dev = mesh.device(g[e])
            bufs = []
            for j, p in enumerate(panels[e]):
                on_dev = nccl and dev.type == "cuda"
                buf = torch.empty(p.shape, dtype=p.dtype,
                                  device=dev if on_dev else "cpu",
                                  pin_memory=dev.type == "cuda"
                                  and not on_dev)
                works.append(dist.irecv(buf, mesh.owner(g[src]),
                                        tag=self._tag(tag, src, j)))
                bufs.append(buf)
            landing.append((e, bufs))
        timeout = datetime.timedelta(seconds=COMM_TIMEOUT_S)
        for w in works:
            if not w.wait(timeout):
                raise RuntimeError("ring hop between processes timed out")
        for e, bufs in landing:
            dev = mesh.device(g[e])
            _, comm = mesh.streams(g[e])
            with on_rank(mesh, g[e], comm):
                out = []
                for b in bufs:
                    if b.device != dev:    # host to the card (gloo)
                        staged["transfers"] += 1
                        staged["bytes"] += b.numel() * b.element_size()
                    out.append(b.to(dev))
            new[e] = out
            ready[e] = _event(comm)

    def _tag(self, tag: int, sender: int, j: int) -> int:
        return ((self.tag0 + tag) * self.d + sender) * 4 + j


def _panel(b: torch.Tensor, s: int, nc: int, chunks: int) -> torch.Tensor:
    if chunks == 1:
        return b.contiguous()
    return b[:, s * nc:(s + 1) * nc].contiguous()


def _as_sharded(mesh: Mesh, x, axis: str) -> Sharded:
    if isinstance(x, Sharded):
        return x
    return shard_rows(mesh, x, axis)


def _leaves(args) -> List[torch.Tensor]:
    return [t for a in args
            for t in (a.shards if isinstance(a, Sharded) else (a,))]


def _rebuild(args, tensors) -> tuple:
    """``args`` (Sharded values and tensors) over other tensors."""
    it = iter(tensors)
    return tuple(Sharded(a.sharding, [next(it) for _ in a.shards], a.shape)
                 if isinstance(a, Sharded) else next(it) for a in args)


def _copy_out(out):
    """A builder's result (a Sharded or a tuple of them) copied out of a
    graph's pool."""
    if isinstance(out, tuple):
        return tuple(_copy_out(o) for o in out)
    return Sharded(out.sharding, [t.clone() for t in out.shards], out.shape)


def _compiled(mesh: Mesh, body: Callable, place: Callable,
              compiled: Optional[bool], what: str) -> Callable:
    """The builders' callable: ``body(*place(*args))`` as one CUDA graph a
    key on the card (the module docstring), else eagerly; every call
    counted in ``forms``.  ``place`` puts the arguments on the mesh
    (Sharded values and tensors on the ranks' devices)."""
    local = mesh.local_ranks()
    if not graphs.graph_form([mesh.device(r) for r in local], compiled, what,
                             len(set(mesh.owners.flat))):
        def eager(*args):
            out = body(*place(*args))
            forms["eager"] += 1
            return out
        return eager
    dev = mesh.device(local[0])
    cache = graphs.GraphCache()

    def key(ins) -> tuple:
        return (tuple((a.spec, a.shape) if isinstance(a, Sharded) else None
                      for a in ins), graphs.signature(_leaves(ins)))

    def entry(*args) -> Optional[graphs.Entry]:
        """The captured program of ``args``' key, None before its first
        call; ``entry(*args).args`` are the arguments the graph reads."""
        return cache.get(key(place(*args)))

    def call(*args):
        ins = place(*args)
        k = key(ins)
        with torch.cuda.device(dev):
            got = cache.get(k)
            if got is None:
                static = _rebuild(ins, [t.clone() for t in _leaves(ins)])
                got, warm = graphs.capture(lambda: body(*static),
                                           _leaves(static), device=dev,
                                           what=what, args=static)
                cache.put(k, got)
                forms["captures"] += 1
                return warm
            return _copy_out(got.replay(_leaves(ins), forms))

    call.cache, call.entry = cache, entry
    return call


def ring_spmm(mesh: Mesh, axis: str = "mp", precision=None,
              compiled: Optional[bool] = None):
    """Build fn(a, b) -> c with A row-sharded, B k-sharded, C row-sharded
    (compiled per ``compiled``: the module docstring).

    a: [M, K] sharded (axis, None) — operator (dense or densified sparse)
    b: [K, N] sharded (axis, None)
    c: [M, N] sharded (axis, None)

    Plain products outside any kernel: ``torch.matmul`` in full f32 (TF32
    off, the caller's setting restored), as the JAX package's
    ``Precision.HIGHEST`` (``precision`` is taken for its signature)."""
    del precision
    d = mesh.shape[axis]

    def place(a, b):
        return _as_sharded(mesh, a, axis), _as_sharded(mesh, b, axis)

    def body(a_s, b_s):
        out = {}
        for gi, group in enumerate(mesh.groups((axis,))):
            ring = _Ring(mesh, group, gi * 4 * d * d)
            if not ring.local:
                continue
            ranks = [group[e] for e in ring.local]
            _begin(mesh, ranks)
            panels = {e: [b_s.shard(group[e])] for e in ring.local}
            ready = {e: None for e in ring.local}
            acc = {}
            for i in range(d):
                done = {}
                for e in ring.local:
                    r = group[e]
                    comp, _ = mesh.streams(r)
                    with on_rank(mesh, r, comp):
                        if ready[e] is not None:
                            comp.wait_event(ready[e])
                        a_loc = a_s.shard(r)
                        kl = panels[e][0].shape[0]
                        src = (e + i) % d
                        blk = a_loc[:, src * kl:(src + 1) * kl]
                        part = _matmul(blk.float(), panels[e][0].float())
                        acc[e] = part if i == 0 else acc[e] + part
                        _used_on(panels[e], comp)
                        done[e] = _event(comp)
                if i < d - 1:
                    panels, ready = ring.hop(panels, done, i, f"i{i}")
            for e in ring.local:
                r = group[e]
                with on_rank(mesh, r, mesh.streams(r)[0]):
                    out[r] = acc[e].to(a_s.dtype)
                _finish(mesh, r, [out[r]])
        local = mesh.local_ranks()
        m = a_s.shape[0]
        return Sharded(NamedSharding(mesh, P(axis, None)),
                       [out[r] for r in local], (m, b_s.shape[1]))

    return _compiled(mesh, body, place, compiled, "ring_spmm")


def ring_spmm_csr(mesh: Mesh, a, n: int, axis: str = "mp",
                  dtype="float32", strategy: str = "auto",
                  chunks: int = 1, f64_schedule: str = "split2",
                  compiled: Optional[bool] = None):
    """Ring SpMM whose per-step compute is the library's own CSR kernel
    (kernels 5-8 of ``ops/spgemm_kernels.py``), not a densified product;
    compiled per ``compiled`` (the module docstring).

    The fixed-structure operator A [M, K] is carved into a d x d grid of
    sparse blocks at build time; each nonempty block becomes one
    ``CsrSpgemm`` (registry-cached by structure digest).  At ring step i,
    rank e multiplies its block (e, (e+i) % d) with the resident B panel.
    Step 0 is the plain kernel (5, or 6 for f64); steps 1..d-1 accumulate
    with ``acc_fn`` (7, or 8), so at d = 1 the ring is the local kernel.
    Zero blocks are skipped (zeros at step 0, C kept after).

    ``chunks=S`` splits the rotating panel into S column sub-panels.  The
    hop of sub-panel s is a device copy on the receiving rank's
    communication stream that waits on an event recorded after the
    sub-panel's compute on the sending rank, and rides under the compute
    of sub-panels s+1..S: the event order is the analog of the JAX
    package's ``optimization_barrier`` (one panel image per chunk live, no
    rotation hoisted ahead of the kernels; ``parallel/schedule_check.py``
    reads it back from a profiler trace).  ``acc_fn`` returns new tensors
    (the TPU kernel aliases C), so each step's C planes replace the last
    and one set per chunk stays live.

    a: [M, K] numpy dense-with-zeros or Csr (fixed structure, values baked).
    Returns fn:
      f32:  fn(b [K, N] sharded P(axis, None)) -> c [M, N] P(axis, None)
      f64:  fn(bh[, bl]) -> (ch, cl) or the folded ch — f32 panel streams
            per ``f64_schedule`` (``ops/spgemm.F64_SCHEDULES``): two B
            streams rotate under split2, one under fold.
    A's M and K are padded to multiples of d internally; B must arrive with
    ceil(K/d)*d rows — ``shard_rows`` does exactly that zero-pad — and
    outputs carry the padded M.
    """
    from ..ops.spgemm import F64_SCHEDULES, create_csr_soa
    from ..utils.mtx import Csr

    d = mesh.shape[axis]
    a_dense = a.toarray() if isinstance(a, Csr) else np.asarray(a)
    m, k = a_dense.shape
    ml, kl = -(-m // d), -(-k // d)
    a_pad = np.zeros((ml * d, kl * d), a_dense.dtype)
    a_pad[:m, :k] = a_dense
    is_f64 = str(dtype) == "float64"
    if is_f64 and f64_schedule not in F64_SCHEDULES:
        raise ValueError(f"unknown f64 schedule {f64_schedule!r}")
    b_lo, c_lo = F64_SCHEDULES[f64_schedule] if is_f64 else (False, False)
    if n % chunks:
        raise ValueError(f"chunks={chunks} must divide n={n}")
    nc = n // chunks
    kernels = [[None] * d for _ in range(d)]
    for e in range(d):
        for j in range(d):
            blk = a_pad[e * ml:(e + 1) * ml, j * kl:(j + 1) * kl]
            if np.count_nonzero(blk):
                kernels[e][j] = create_csr_soa(blk, nc, dtype=dtype,
                                               strategy=strategy,
                                               f64_schedule=f64_schedule)
    n_b = 2 if b_lo else 1   # B streams (bh [+ bl])
    n_c = 2 if c_lo else 1   # C streams (ch [+ cl])

    def step(kern, i, cs, bs, dev):
        """One ring step on one sub-panel: cs (None at i = 0) += blk @ bs."""
        if i == 0:
            if kern is None:
                return tuple(torch.zeros((ml, nc), dtype=F32, device=dev)
                             for _ in range(n_c))
            return _as_tuple(kern._fn(*bs))
        if kern is None:
            return cs
        return _as_tuple(kern.acc_fn(*cs, *bs))

    def place(*b_streams):
        if len(b_streams) != n_b:
            raise ValueError(f"the ring takes {n_b} B stream(s) under "
                             f"{'f64 ' + f64_schedule if is_f64 else 'f32'}"
                             f", got {len(b_streams)}")
        return tuple(_as_sharded(mesh, b, axis) for b in b_streams)

    def body(*bss):
        for b in bss:
            if b.shape != (kl * d, n):
                raise ValueError(f"B must be [{kl * d}, {n}] (K padded to a "
                                 f"multiple of {d}), got {b.shape}")
        out: Dict[int, tuple] = {}
        for gi, group in enumerate(mesh.groups((axis,))):
            ring = _Ring(mesh, group, gi * (d * chunks + 1))
            if not ring.local:
                continue
            _begin(mesh, [group[e] for e in ring.local])
            # panels[s][e]: the B streams of sub-panel s at position e
            panels, ready = [], []
            for s in range(chunks):
                ps = {}
                for e in ring.local:
                    r = group[e]
                    with on_rank(mesh, r, mesh.streams(r)[0]):
                        ps[e] = [_panel(b.shard(r), s, nc, chunks)
                                 for b in bss]
                panels.append(ps)
                ready.append({e: None for e in ring.local})
            accs = [{e: None for e in ring.local} for _ in range(chunks)]
            for i in range(d):
                for s in range(chunks):
                    done = {}
                    for e in ring.local:
                        r = group[e]
                        comp, _ = mesh.streams(r)
                        with on_rank(mesh, r, comp), trace.scope(
                                f"ring.compute r{r} i{i} s{s}"):
                            if ready[s][e] is not None:
                                comp.wait_event(ready[s][e])
                            accs[s][e] = step(kernels[e][(e + i) % d], i,
                                              accs[s][e], panels[s][e],
                                              mesh.device(r))
                            _used_on(panels[s][e], comp)
                            done[e] = _event(comp)
                    if i < d - 1:
                        # rotate THIS sub-panel now: its hop rides under
                        # the next sub-panels' compute
                        panels[s], ready[s] = ring.hop(
                            panels[s], done, i * chunks + s, f"i{i} s{s}")
            for e in ring.local:
                r = group[e]
                with on_rank(mesh, r, mesh.streams(r)[0]):
                    cs = tuple(
                        torch.cat([accs[s][e][j] for s in range(chunks)],
                                  dim=1) if chunks > 1 else accs[0][e][j]
                        for j in range(n_c))
                _finish(mesh, r, cs)
                out[r] = cs
        local = mesh.local_ranks()
        sh = NamedSharding(mesh, P(axis, None))
        res = tuple(Sharded(sh, [out[r][j] for r in local], (ml * d, n))
                    for j in range(n_c))
        return res if n_c == 2 else res[0]

    fn = _compiled(mesh, body, place, compiled, "ring_spmm_csr")
    fn.kernels = kernels
    fn.streams = (n_b, n_c)
    return fn


def col_sharded_spmm(mesh: Mesh, axis: str = "mp", precision=None,
                     compiled: Optional[bool] = None):
    """fn(a, b) -> c with A replicated, B/C column(N)-sharded — zero comm;
    compiled per ``compiled`` (the module docstring).

    The right layout when B is the wide streaming operand (PyFR-style):
    each rank computes all M rows for its N columns (``torch.matmul`` in
    full f32)."""
    del precision

    def place(a, b):
        return (as_tensor(a, mesh.device(mesh.local_ranks()[0])),
                b if isinstance(b, Sharded) else shard_cols(mesh, b, axis))

    def body(a, b):
        local = mesh.local_ranks()
        _begin(mesh, local)
        outs = []
        for r, bt in zip(local, b.shards):
            comp, _ = mesh.streams(r)
            with on_rank(mesh, r, comp):
                at = as_tensor(a, mesh.device(r))
                c = _matmul(at.float(), bt.float()).to(at.dtype)
                _used_on([bt], comp)
            _finish(mesh, r, [c])
            outs.append(c)
        m = int(a.shape[0])
        return Sharded(NamedSharding(mesh, P(None, axis)), outs,
                       (m, b.shape[1]))

    return _compiled(mesh, body, place, compiled, "col_sharded_spmm")


def _dp_wrapper(mesh: Mesh, packed_fn: Callable, n_in: Optional[int],
                axis: str, compiled: Optional[bool], what: str):
    """fn(*ops) -> Sharded: ``packed_fn`` on each local rank's lane shard
    (the last axis of every operand), on the rank's compute stream;
    compiled per ``compiled`` (the module docstring)."""
    spec = P(None, None, axis)

    def place(*ops):
        if n_in is not None and len(ops) != n_in:
            raise ValueError(f"takes {n_in} operands, got {len(ops)}")
        return tuple(o if isinstance(o, Sharded) else
                     device_put(o, NamedSharding(mesh, spec)) for o in ops)

    def body(*ops):
        local = mesh.local_ranks()
        _begin(mesh, local)
        outs = []
        for i, r in enumerate(local):
            comp, _ = mesh.streams(r)
            with on_rank(mesh, r, comp):
                shards = [o.shards[i] for o in ops]
                res = _as_tuple(packed_fn(*shards))
                _used_on(shards, comp)
            _finish(mesh, r, res)
            outs.append(res)
        sh = NamedSharding(mesh, spec)
        res = tuple(Sharded(sh, [o[j] for o in outs],
                            tuple(outs[0][j].shape[:-1])
                            + (outs[0][j].shape[-1] * mesh.shape[axis],))
                    for j in range(len(outs[0])))
        return res if len(res) > 1 else res[0]

    return _compiled(mesh, body, place, compiled, what)


def dp_batched_smm(mesh: Mesh, kernel, axis: str = "dp",
                   compiled: Optional[bool] = None):
    """Data-parallel wrapper over a lane-packed ``BatchedSMM`` kernel
    (kernels 1-3): each rank runs ``kernel.packed`` on its lane shard of
    the packed operands ([M, K, B] / [K, N, B], the batch last).  No
    collectives for independent problems (the GxM-DP analog reduces
    gradients, not forward SMMs)."""
    return _dp_wrapper(mesh, kernel.packed, None, axis, compiled,
                       "dp_batched_smm")


def dp_packed(mesh: Mesh, packed_fn: Callable, n_in: int, axis: str = "dp",
              compiled: Optional[bool] = None):
    """Batch(lane)-partitioned wrapper for any lane-packed kernel
    (``getrf_dispatch(...).packed``, ``trsm_dispatch(...).packed``:
    kernels 11-14).

    BASELINE config #5's "packed batched TRSM+GETRF ... row-partitioned
    over hosts": the packed layout's lane axis is the batch, so
    distributing = sharding the last axis of every operand; each rank
    factors or solves its own problem instances (zero collectives)."""
    return _dp_wrapper(mesh, packed_fn, n_in, axis, compiled, "dp_packed")


def _pad(x, pads) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if any(pads):
        t = torch.nn.functional.pad(t, pads)
    return t


def shard_rows(mesh: Mesh, x, axis: str = "mp") -> Sharded:
    """Place [R, C] array row-sharded on the mesh axis (pads R with zeros
    to a multiple of the axis size)."""
    d = mesh.shape[axis]
    pad = (-x.shape[0]) % d
    return device_put(_pad(x, (0, 0, 0, pad)),
                      NamedSharding(mesh, P(axis, None)))


def shard_cols(mesh: Mesh, x, axis: str = "mp") -> Sharded:
    """Place [R, C] array column-sharded on the mesh axis (pads C)."""
    d = mesh.shape[axis]
    pad = (-x.shape[1]) % d
    return device_put(_pad(x, (0, pad, 0, 0)),
                      NamedSharding(mesh, P(None, axis)))
