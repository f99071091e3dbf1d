"""MLEngine — the GxM training-framework analog: the port of
``xsmm_tpu/models/engine.py``.

Reference: samples/deeplearning/gxm/src/Engine.cpp — builds the layer graph
from prototxt, runs epoch/minibatch loops (run(TRAIN) :484, :516-531), SGD
solver with lr schedules, prints images/s per epoch (:600-602), checkpoints
every epoch + snapshot dirs (:245-365), resumes at startup (:488-500).

The same surface as the JAX package: ``SolverConfig`` and its schedules,
``softmax_xent``, ``MLEngine(params, forward, solver)`` with ``train_epoch``,
``train_epoch_scan``, ``validate``, ``checkpoint`` and ``resume``, and the
batch sources; and ``train_step``, one step on a batch with the loss left on
the device, which ``train_epoch`` runs for each of its batches.  Inside,
PyTorch idiom on one device (``platform.device()``):

* parameters, momentum and BN running state are tensors the engine owns
  (copies of the caller's), updated in place under ``torch.no_grad()``;
  a step runs the forward, the weighted aux losses and
  ``torch.autograd.grad``, then the update on every trainable leaf:
  ``g + wd*p``, ``m = mu*m + g``, ``p -= lr*m`` (``torch._foreach_*``),
  with ``lr`` a device tensor written before the step;
* dropout draws from the engine's ``torch.Generator`` (seeded 0xA6);
* compiled, as the JAX package's ``jax.jit(self._train_step_impl)`` and
  ``jax.jit(self._eval_step_impl)``: on the card ``train_step`` (so
  ``train_epoch``) and ``validate`` run each step as a CUDA graph
  (``utils/graphs.py``), one a key (the batch's shapes, dtypes, strides
  and devices, and the solver's momentum and weight decay, which the graph
  holds as constants).  The
  first step of a key runs eagerly on a side stream, as the warm-up and
  the epoch's step, then is captured, with the dropout generator
  registered with the graph; each later step stages its host batch to the
  card (the non-blocking pinned copies), copies it into the graph's own
  input tensors, replays, and copies the loss (the metrics) out of the
  graph's pool.  Parameters, momentum and BN state stay the engine's
  tensors, updated in place by the replay.  ``forms`` counts every step
  under the form it ran (``utils/graphs.FORMS``); each engine keeps at most
  ``utils/graphs.CAPACITY`` graphs, the least recently used evicted first.
  ``compiled=False`` gives the eager form; the CPU target, and a mesh over
  several cards, run eagerly, and ``compiled=True`` there raises
  ``ValueError``.  A step that cannot be captured raises, naming the
  reason; nothing falls back to the eager form on the card;
* ``train_epoch_scan`` (the JAX package's one-dispatch ``lax.scan`` epoch)
  is a CUDA-graph epoch in the compiled form: one whole step (the batch
  made by ``batch_fn`` from the engine's data generator, forward, backward,
  update, BN state copied into its buffers) is captured once and replayed;
  the first epoch's first step runs eagerly, as the capture's warm-up.  In
  the eager form the same steps run as an eager loop;
* checkpoints have the JAX package's file names and array keys (the
  ``jax.tree_util.keystr`` of each leaf, dict keys sorted), so a JAX
  checkpoint resumes here.

Over a mesh (``mesh=``, a ``parallel.mesh.Mesh`` with a "dp" axis) the
engine is data parallel, as the JAX package's under ``jit`` with a
dp-sharded batch: each rank holds a replica of the parameters, the
momentum and the BN state on its device, and its shard of the batch (a
``Sharded`` batch is taken as it lies).  The graph runs in lock-step over
the ranks (``dnn/layers.Ranks``) with the BN moments averaged over "dp",
so the statistics, the loss (the mean of the ranks' shard means) and the
gradient are the global batch's; one ``torch.autograd.grad`` of the mean
loss gives every replica's share, the shares are summed in rank order
(the all-reduce), and every replica takes the same update; the running
statistics come from the global moments, so they stay replica-consistent.
Ranks along another axis ("mp") are replicas of their dp rank.  One
device is the same executor over one rank.
The compiled forms capture every rank's step into one CUDA graph (the
ranks on one card); checkpoints hold rank 0's replica.  The mesh lies in
one process: multi-process steps are ``parallel/multihost.py``'s.

Stated differences: dropout masks and the device batch makers (``device_*_batches``,
``*_batch_fn``, which take a ``torch.Generator`` where JAX takes a key)
have the JAX package's distributions, not its bits; the host batch
sources (``synthetic_batches``, ``template_batches``) give its data
exactly.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import platform
from ..dnn.layers import Ranks
from ..ops.smm import as_tensor
from ..parallel import mesh as _mesh
from ..utils import graphs, trace
from ..utils.scratch import STAGE_MIN_BYTES


@dataclasses.dataclass
class SolverConfig:
    """GxM solver surface (SGD + schedule)."""

    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    # Policies mirror the zoo solver.prototxt surface: fixed | step
    # (= Caffe "multistep", explicit epoch list) | poly | inv
    # (lr * (1 + gamma*epoch)^-power, the lenet_solver.prototxt policy)
    lr_policy: str = "fixed"
    gamma: float = 0.1              # step decay factor / inv denominator
    step_epochs: Tuple[int, ...] = (30, 60, 80)
    power: float = 1.0              # poly / inv exponent
    max_epochs: int = 90
    # Linear warmup (Solver.hpp:157,171 warmup_lr/warmup_epochs): ramp
    # from warmup_lr to lr over warmup_epochs, then the main policy.
    warmup_epochs: int = 0
    warmup_lr: float = 0.0


def _schedule(cfg: SolverConfig, epoch: float) -> float:
    if cfg.warmup_epochs > 0 and epoch < cfg.warmup_epochs:
        frac = epoch / cfg.warmup_epochs
        return cfg.warmup_lr + (cfg.lr - cfg.warmup_lr) * frac
    if cfg.lr_policy == "step":
        drops = sum(1 for e in cfg.step_epochs if epoch >= e)
        return cfg.lr * (cfg.gamma ** drops)
    if cfg.lr_policy == "poly":
        return cfg.lr * (1.0 - epoch / cfg.max_epochs) ** cfg.power
    if cfg.lr_policy == "inv":
        return cfg.lr * (1.0 + cfg.gamma * epoch) ** -cfg.power
    return cfg.lr


def softmax_xent(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


# ---------------------------------------------------------------------------
# Trees of tensors, with the JAX package's flatten order and key strings
# ---------------------------------------------------------------------------


def tree_flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr, leaf)] in ``jax.tree_util`` order: dict keys sorted, list
    and tuple items in order, a NamedTuple's fields as ``.name``; None has
    no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten_with_path(tree[k],
                                                 f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f, v in zip(tree._fields, tree)
                for kv in tree_flatten_with_path(v, f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_flatten_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf, the structure kept (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


class MLEngine:
    """Train/validate a functional model on one device, or data parallel
    over the ranks of a mesh."""

    def __init__(self, params, forward: Callable, solver: SolverConfig,
                 mesh=None, loss_fn: Callable = softmax_xent,
                 checkpoint_dir: Optional[str] = None,
                 compute_dtype=torch.float32,
                 compiled: Optional[bool] = None):
        if mesh is not None:
            if not isinstance(mesh, _mesh.Mesh) or "dp" not in \
                    mesh.axis_names:
                raise ValueError("MLEngine's mesh is a parallel.mesh.Mesh "
                                 "with a 'dp' axis")
            if len(mesh.local_ranks()) != mesh.size:
                raise ValueError("MLEngine's mesh must lie within this "
                                 "process (multi-process training steps: "
                                 "parallel/multihost.py)")
        self.mesh = mesh
        # for graph-built models (dnn/layers.py) the compute dtype is
        # chosen at model build time (resnet(..., dtype="bfloat16")); the
        # compute_dtype kwarg is forwarded but those forwards ignore it.
        self.solver = solver
        self.forward = forward
        self.loss_fn = loss_fn
        self.checkpoint_dir = checkpoint_dir
        self.compute_dtype = compute_dtype
        self._devices = ([mesh.device(r) for r in mesh.local_ranks()]
                         if mesh is not None else [platform.device()])
        self.device = self._devices[0]
        self.compiled = graphs.graph_form(self._devices, compiled, "MLEngine")
        self.epoch = 0
        self.step = 0

        def own(dev):
            def put(t):
                t = as_tensor(t, dev).detach().clone()
                return t.requires_grad_() if t.is_floating_point() else t
            return put

        # static metadata (strings etc.): split out once
        self.meta = {k: v for k, v in params.items() if k.startswith("_")}
        # one replica a rank (one on a single device); rank 0's is the
        # engine's params / momentum / state
        self._rep_params = [tree_map(own(d), self._trainable(params))
                            for d in self._devices]
        self._rep_moms = [tree_map(
            lambda p: torch.zeros_like(p, requires_grad=False), p)
            for p in self._rep_params]
        self.params, self.momentum = self._rep_params[0], self._rep_moms[0]
        self._rep_leaves = [[t for _, t in tree_flatten_with_path(p)]
                            for p in self._rep_params]
        self._rep_mom_leaves = [[t for _, t in tree_flatten_with_path(m)]
                                for m in self._rep_moms]
        self._leaves, self._moms = (self._rep_leaves[0],
                                    self._rep_mom_leaves[0])
        # graph-built forwards take train/rng so dropout nodes fire during
        # training; legacy forwards don't — detect once.  A **kwargs
        # forward also qualifies.
        try:
            params_ = inspect.signature(forward).parameters
            self._train_kwargs = (
                any(p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params_.values())
                or {"train", "rng"} <= set(params_))
        except (TypeError, ValueError):
            self._train_kwargs = False
        self._gen = torch.Generator(device=self.device).manual_seed(0xA6)
        # stateful models (graph-built nets with batchnorm) advertise their
        # running-statistics state; the engine threads it through train
        # (moving-sum update) and eval (use_global_stats path)
        init_state = getattr(forward, "init_state", None)
        self._stateful = bool(init_state)
        if (self._stateful and len(self._devices) > 1
                and not getattr(forward, "lockstep", False)):
            raise ValueError("a stateful forward over a mesh must run in "
                             "lock-step over Ranks (dnn/layers."
                             "make_model_forward), so that its BN "
                             "statistics are the global batch's")
        self._rep_states = [
            tree_map(lambda t, _d=d: as_tensor(t, _d).clone(),
                     dict(init_state)) if self._stateful else None
            for d in self._devices]
        self.state = self._rep_states[0]
        self._lr = torch.zeros((), device=self.device)
        # the compiled steps: ("train" | "eval", key) -> graphs.Entry;
        # ("scan", id(batch_fn)) -> (graphs.Entry, batch_fn, data
        # generator), the entry holding batch_fn (and the tensors its graph
        # reads) alive, so that its id is not reused
        self._graphs = graphs.GraphCache()
        self.forms = graphs.new_forms()

    @staticmethod
    def _trainable(params):
        return {k: v for k, v in params.items() if not k.startswith("_")}

    def _batch(self, x):
        """A batch as a list of each rank's shard along "dp" on the rank's
        device (a ``Sharded`` batch as it lies); one device is one rank."""
        if isinstance(x, _mesh.Sharded):
            if x.mesh is not self.mesh or tuple(x.spec[:1]) != ("dp",):
                raise ValueError("a Sharded batch must be split along 'dp' "
                                 "over the engine's mesh")
            return list(x.shards)
        x = self._to_device(x)
        if self.mesh is None:
            return [x]
        dp = self.mesh.shape["dp"]
        if x.shape[0] % dp:
            raise ValueError(f"batch {x.shape[0]} does not divide over "
                             f"dp = {dp} ranks")
        bs = x.shape[0] // dp
        return [x[self.mesh.coord(r, "dp") * bs:
                  (self.mesh.coord(r, "dp") + 1) * bs].to(d)
                for r, d in zip(self.mesh.local_ranks(), self._devices)]

    def _to_device(self, x):
        """A batch array on the engine's device.  From numpy to the card
        every copy is non-blocking from pinned memory (a pageable copy
        would wait for the steps already queued): large arrays through
        the staging pool (``as_tensor``), small ones (labels) pinned."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, non_blocking=True)
        arr = np.ascontiguousarray(x)
        if self.device.type == "cuda" and arr.nbytes < STAGE_MIN_BYTES:
            return torch.from_numpy(arr).pin_memory().to(self.device,
                                                         non_blocking=True)
        return as_tensor(arr, self.device)

    # -- one step --------------------------------------------------------------
    def _forward(self, xs, **kw):
        """The forward over the ranks: (each rank's logits, each rank's new
        state or None).  A graph-built forward runs in lock-step over
        ``Ranks`` (BN over the global batch); any other forward once a
        rank."""
        params = [{**p, **self.meta} for p in self._rep_params]
        kw["compute_dtype"] = self.compute_dtype
        if getattr(self.forward, "lockstep", False):
            if self._stateful:
                kw["state"] = self._rep_states
            out = self.forward(Ranks(params), Ranks(xs, self.mesh), **kw)
            logits, states = out if self._stateful else (out, None)
            if isinstance(logits, tuple):
                return list(zip(*logits)), states
            return list(logits), states
        outs = [self.forward(p, x, **kw, **({"state": st} if self._stateful
                                            else {}))
                for p, x, st in zip(params, xs, self._rep_states)]
        if not self._stateful:
            return outs, None
        return [o[0] for o in outs], [o[1] for o in outs]

    def _loss(self, xs, ys):
        """The mean of the ranks' losses (each the mean over its shard)
        and every rank's new state."""
        kw = {"train": True, "rng": self._gen} if self._train_kwargs else {}
        logits, new_states = self._forward(xs, **kw)
        losses = [self._weighted_loss(lg, y) for lg, y in zip(logits, ys)]
        total = losses[0]
        for lv in losses[1:]:
            total = total + lv.to(total.device)
        if len(losses) > 1:
            total = total / len(losses)
        return total, new_states

    def _weighted_loss(self, logits, y):
        with trace.scope("engine.loss"):
            if isinstance(logits, tuple):
                # weighted multi-loss (GoogLeNet-v1 aux classifiers: loss =
                # main + sum(w_i * aux_i), prototxt loss_weight semantics);
                # the weights come from the graph's aux taps
                main, auxs = logits[0], logits[1:]
                ws = getattr(self.forward, "aux_loss_weights",
                             (0.3,) * len(auxs))
                lval = self.loss_fn(main, y)
                for w, al in zip(ws, auxs):
                    lval = lval + w * self.loss_fn(al, y)
            else:
                lval = self.loss_fn(logits, y)
        return lval

    def _train_step(self, x, y) -> torch.Tensor:
        """One SGD step on device tensors x, y with the lr in ``self._lr``;
        returns the loss (a device tensor).  Reads nothing back to the
        host, so it can be captured into a CUDA graph."""
        with torch.enable_grad():
            lval, new_state = self._loss(x, y)
        leaves = [t for rep in self._rep_leaves for t in rep]
        with trace.scope("engine.backward"):
            grads = torch.autograd.grad(lval, leaves, allow_unused=True)
        cfg = self.solver
        n = len(self._leaves)
        with torch.no_grad(), trace.scope("engine.update"):
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, leaves)]
            # every replica's share of the gradient, summed in rank order
            # (the all-reduce); then the same update on every replica
            total = grads[:n]
            for r in range(1, len(self._rep_leaves)):
                part = grads[r * n:(r + 1) * n]
                torch._foreach_add_(total, [t.to(u.device)
                                            for t, u in zip(part, total)])
            states = new_state or [None] * len(self._devices)
            for ls, ms, st, dev, stv in zip(self._rep_leaves,
                                            self._rep_mom_leaves,
                                            self._rep_states, self._devices,
                                            states):
                g = torch._foreach_add([t.to(dev) for t in total], ls,
                                       alpha=cfg.weight_decay)
                torch._foreach_mul_(ms, cfg.momentum)
                torch._foreach_add_(ms, g)
                torch._foreach_sub_(ls, torch._foreach_mul(
                    ms, self._lr.to(dev)))
                if stv is not None:
                    for k, v in stv.items():
                        for dst, src in zip(st[k], v):
                            dst.copy_(src)
        return lval.detach()

    @torch.no_grad()
    def _eval_step(self, xs, ys):
        """Every rank's eval on its shard (GxM TEST/VAL mode: global
        statistics, no state update), averaged over the ranks (equal
        shards: the global batch's metrics)."""
        logits, _ = self._forward(xs)
        rows = []
        for lg, y in zip(logits, ys):
            y = y.long()
            # top-5 (Engine.cpp:642 validation / Accuracy.cpp analog)
            k = min(5, lg.shape[1])
            topk = lg.topk(k, dim=1).indices
            rows.append(torch.stack([
                self.loss_fn(lg, y), (lg.argmax(dim=1) == y).float().mean(),
                (topk == y[:, None]).any(dim=1).float().mean()
            ]).to(self.device))
        return rows[0] if len(rows) == 1 else torch.stack(rows).mean(dim=0)

    # -- public API --------------------------------------------------------------
    def train_step(self, x, y) -> torch.Tensor:
        """One SGD step on a batch (images NHWC, int labels: tensors, numpy
        arrays or ``Sharded`` batches) at the current epoch's lr, in the
        engine's form (compiled: the replay of the train step's CUDA graph
        for the batch's key).  Returns the loss as a device tensor; nothing
        is read back to the host.  The span ``engine.step`` covers its host
        work: the batch onto the device, the copy into the graph's inputs,
        the replay, the copy of the loss out."""
        with trace.span("engine.step"):
            self._lr.fill_(_schedule(self.solver, self.epoch))
            loss = self._run("train", self._train_step, self._batch(x),
                             self._batch(y), (self._gen,))
        self.step += 1
        return loss

    def train_epoch(self, batches: Iterator[Tuple[Any, Any]],
                    log_every: int = 50, verbose: bool = True):
        """One epoch of ``train_step`` over an iterator of (images NHWC,
        int labels), numpy arrays (staged to the card through pinned
        memory) or tensors.  Returns images/s, the last loss, the lr and
        every step's loss."""
        lr = _schedule(self.solver, self.epoch)
        n_images = 0
        t0 = time.perf_counter()
        losses = []
        for bi, (x, y) in enumerate(batches):
            losses.append(self.train_step(x, y))
            n_images += x.shape[0]
            if verbose and bi % log_every == 0:
                print(f"epoch {self.epoch} batch {bi} "
                      f"loss {float(losses[-1]):.4f} lr {lr:.5f}")
        losses = torch.stack(losses).float().tolist()   # waits for the card
        dt = time.perf_counter() - t0
        ips = n_images / dt
        if verbose:
            print(f"epoch {self.epoch}: {ips:.1f} images/s "
                  f"({n_images} images, {dt:.2f}s)")  # Engine.cpp:600 analog
        self.epoch += 1
        if self.checkpoint_dir:
            self.checkpoint()
            # snapshot dirs at schedule boundaries (Engine.cpp writes
            # snapshots at epochs 30/60/80 alongside the rolling checkpoint)
            if self.epoch in self.solver.step_epochs:
                self.checkpoint(tag=f"epoch{self.epoch}")
        return {"images_per_s": ips, "loss": losses[-1], "lr": lr,
                "losses": losses}

    def _run(self, kind: str, step: Callable, xs, ys, generators=()):
        """``step(xs, ys)`` (each rank's batch shard on its device) in the
        engine's form: eagerly, or as the CUDA graph of its key (the first
        step of a key is the warm-up, then the capture; later ones copy the
        batch into the graph's inputs, replay and copy the result out)."""
        if not self.compiled:
            self.forms["eager"] += 1
            return step(xs, ys)
        cfg = self.solver
        key = (kind, graphs.signature(xs), graphs.signature(ys),
               cfg.momentum, cfg.weight_decay)
        got = self._graphs.get(key)
        if got is None:
            sx, sy = [t.clone() for t in xs], [t.clone() for t in ys]
            got, warm = self._capture(lambda: step(sx, sy), sx + sy,
                                      generators, f"MLEngine {kind} step")
            self._graphs.put(key, got)
            self.forms["captures"] += 1
            return warm
        return got.replay(list(xs) + list(ys), self.forms).clone()

    def _scan_step(self, batch_fn: Callable, gen):
        x, y = batch_fn(gen)
        return self._train_step(self._batch(x), self._batch(y))

    def scan_seed(self, data_seed: int = 0) -> int:
        """The seed of the data generator for the next ``train_epoch_scan``
        (from the data seed and the step count, as the JAX package folds
        both into its key)."""
        return (0xDA7A << 32) + (data_seed << 20) + self.step

    def _capture(self, step: Callable[[], Any], inputs, generators,
                 what: str):
        """Warm up one real step on a side stream, then capture the same
        step (which reads ``inputs``) into a CUDA graph with
        ``generators`` registered: (its ``graphs.Entry``, the warm-up
        step's result)."""
        return graphs.capture(step, inputs, generators, self.device, what)

    def train_epoch_scan(self, n_batches: int, batch_fn: Callable,
                         batch_size: int, verbose: bool = True,
                         data_seed: int = 0):
        """One epoch of ``n_batches`` steps on batches made on the device.

        ``batch_fn(gen) -> (x NHWC, y int)`` draws a batch from the
        ``torch.Generator`` it is given (e.g. ``synthetic_batch_fn`` /
        ``template_batch_fn``); the engine's data generator is seeded with
        ``scan_seed(data_seed)`` at the epoch's start.  On the card the
        step is a CUDA graph replayed ``n_batches`` times (captured at the
        first call for this ``batch_fn``, after one eager warm-up step
        that is the epoch's first); on the CPU the same steps run eagerly.
        Over a mesh the batch is the global one, split along "dp" inside
        the step, and the graph holds every rank's step (the ranks share
        one card).  In the eager form the steps run as an eager loop.
        """
        lr = _schedule(self.solver, self.epoch)
        seed = self.scan_seed(data_seed)
        t0 = time.perf_counter()
        self._lr.fill_(lr)
        losses = torch.empty((n_batches,), device=self.device)
        if not self.compiled:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            for i in range(n_batches):
                losses[i] = self._scan_step(batch_fn, gen).float()
            self.forms["eager"] += n_batches
        else:
            first = 0
            key = ("scan", id(batch_fn))
            if key not in self._graphs:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                entry, warm = self._capture(
                    lambda: self._scan_step(batch_fn, gen), (),
                    (gen, self._gen), "train_epoch_scan: the step")
                self._graphs.put(key, (entry, batch_fn, gen))
                self.forms["captures"] += 1
                losses[0] = warm.float()
                first = 1
            entry, _, gen = self._graphs.get(key)
            if not first:
                gen.manual_seed(seed)
            for i in range(first, n_batches):
                losses[i] = entry.replay((), self.forms).float()
        losses = losses.tolist()    # waits for the card
        dt = time.perf_counter() - t0
        self.step += n_batches
        self.epoch += 1
        n_images = n_batches * batch_size
        ips = n_images / dt
        if verbose:
            print(f"epoch {self.epoch - 1}: {ips:.1f} images/s "
                  f"({n_images} images, {dt:.2f}s, "
                  f"{'CUDA graph' if self.compiled else 'eager'}"
                  f")")
        if self.checkpoint_dir:
            self.checkpoint()
        return {"images_per_s": ips, "loss": losses[-1], "lr": lr,
                "losses": losses}

    def validate(self, batches) -> Dict[str, float]:
        """Loss, top-1 and top-5 over ``batches``, each step in the
        engine's form (compiled: the eval step's CUDA graph)."""
        rows = []
        for x, y in batches:
            rows.append(self._run("eval", self._eval_step, self._batch(x),
                                  self._batch(y)).float())
        loss, acc, acc5 = torch.stack(rows).mean(dim=0).tolist()
        return {"loss": loss, "acc": acc, "acc5": acc5}

    # -- checkpoint / resume (Engine.cpp:245-365, 488-500 analog) --------------
    def _trees(self):
        trees = {"params": self.params, "momentum": self.momentum}
        if self._stateful:
            trees["state"] = self.state
        return trees

    def checkpoint(self, tag: Optional[str] = None):
        d = self.checkpoint_dir
        if not d:
            raise ValueError("no checkpoint_dir configured")
        os.makedirs(d, exist_ok=True)
        tag = tag or "latest"
        for name, tree in self._trees().items():
            np.savez(os.path.join(d, f"{name}_{tag}.npz"),
                     **{k: v.detach().cpu().numpy()
                        for k, v in tree_flatten_with_path(tree)})
        with open(os.path.join(d, f"meta_{tag}.json"), "w") as f:
            json.dump({"epoch": self.epoch, "step": self.step,
                       "lr": _schedule(self.solver, self.epoch)}, f)

    def resume(self, tag: str = "latest") -> bool:
        """Load a checkpoint (this package's or the JAX package's) into the
        engine's tensors, in place; False where there is none."""
        d = self.checkpoint_dir
        meta_p = os.path.join(d or "", f"meta_{tag}.json")
        if not d or not os.path.exists(meta_p):
            return False
        with open(meta_p) as f:
            meta = json.load(f)
        for name, tree in self._trees().items():
            path = os.path.join(d, f"{name}_{tag}.npz")
            if name == "state" and not os.path.exists(path):
                continue
            with np.load(path) as z, torch.no_grad():
                for k, t in tree_flatten_with_path(tree):
                    t.copy_(torch.from_numpy(z[k]))
        with torch.no_grad():   # rank 0's replica to every other
            for reps in (self._rep_params, self._rep_moms, self._rep_states):
                for rep in reps[1:]:
                    for (_, dst), (_, src) in zip(
                            tree_flatten_with_path(rep),
                            tree_flatten_with_path(reps[0])):
                        dst.copy_(src)
        self.epoch = meta["epoch"]
        self.step = meta["step"]
        return True


# ---------------------------------------------------------------------------
# Batch sources
# ---------------------------------------------------------------------------


def synthetic_batches(n_batches: int, batch: int, hw: int = 32,
                      classes: int = 10, seed: int = 0, chans: int = 3):
    """Synthetic data pipeline (LMDB-free input analog): numpy batches, the
    JAX package's draws."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield (rng.standard_normal(
                   (batch, hw, hw, chans)).astype(np.float32),
               rng.integers(0, classes, (batch,)).astype(np.int32))


def template_batches(n_batches: int, batch: int, hw: int = 32,
                     classes: int = 10, seed: int = 0, sigma: float = 0.6,
                     epoch: int = 0, chans: int = 3):
    """Deterministic LEARNABLE dataset: class templates + Gaussian noise
    (numpy batches, the JAX package's draws).

    Each class is a fixed random template image (drawn once from the data
    seed); every sample is template[label] + sigma*noise.  A working
    training stack must drive the loss well below ln(classes) and the
    accuracy far above 1/classes."""
    trng = np.random.default_rng(seed)  # templates: seed-stable
    templates = trng.standard_normal(
        (classes, hw, hw, chans)).astype(np.float32)
    rng = np.random.default_rng(seed + 1000 + epoch)
    for _ in range(n_batches):
        y = rng.integers(0, classes, (batch,)).astype(np.int32)
        x = templates[y] + sigma * rng.standard_normal(
            (batch, hw, hw, chans)).astype(np.float32)
        yield x, y


def _templates(seed: int, classes: int, hw: int, chans: int, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((classes, hw, hw, chans), generator=gen, device=dev)


def _template_batch(gen, templates, batch, sigma):
    classes, hw, _, chans = templates.shape
    dev = templates.device
    y = torch.randint(0, classes, (batch,), generator=gen, device=dev,
                      dtype=torch.int32)
    x = templates[y.long()] + sigma * torch.randn(
        (batch, hw, hw, chans), generator=gen, device=dev)
    return x, y


def _synthetic_batch(gen, batch, hw, classes, chans):
    dev = gen.device
    x = torch.randn((batch, hw, hw, chans), generator=gen, device=dev)
    y = torch.randint(0, classes, (batch,), generator=gen, device=dev,
                      dtype=torch.int32)
    return x, y


def device_template_batches(n_batches: int, batch: int, hw: int = 32,
                            classes: int = 10, seed: int = 0,
                            sigma: float = 0.6, epoch: int = 0,
                            chans: int = 3):
    """template_batches made on the device (nothing crosses the link): the
    same task family from a ``torch.Generator``, so the same distribution,
    not the same numbers (the JAX package says the same of its own)."""
    dev = platform.device()
    templates = _templates(seed, classes, hw, chans, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1000 + epoch)
    for _ in range(n_batches):
        yield _template_batch(gen, templates, batch, sigma)


def synthetic_batch_fn(batch: int, hw: int = 32, classes: int = 10,
                       chans: int = 3) -> Callable:
    """Per-step batch maker for ``train_epoch_scan``: gen -> (x NHWC,
    y int32), drawn on gen's device."""
    def make(gen):
        return _synthetic_batch(gen, batch, hw, classes, chans)
    return make


def template_batch_fn(batch: int, hw: int = 32, classes: int = 10,
                      seed: int = 0, sigma: float = 0.6,
                      chans: int = 3) -> Callable:
    """LEARNABLE batch maker (template task) for ``train_epoch_scan``: the
    class templates are made once, on the entry points' device, from the
    seed (the templates of ``device_template_batches``)."""
    templates = _templates(seed, classes, hw, chans, platform.device())

    def make(gen):
        return _template_batch(gen, templates, batch, sigma)
    return make


def device_synthetic_batches(n_batches: int, batch: int, hw: int = 32,
                             classes: int = 10, seed: int = 0,
                             sharding=None, chans: int = 3):
    """Synthetic batches made on the device (nothing crosses the link).
    With ``sharding`` (a ``parallel.mesh.NamedSharding`` over the batch
    axis, e.g. ``dp_sharding(mesh)``) each batch is drawn on the mesh's
    first rank's device and comes back as (``Sharded`` x, ``Sharded`` y),
    split along the batch over the ranks' devices."""
    if sharding is None:
        gen = torch.Generator(device=platform.device()).manual_seed(seed)
        for _ in range(n_batches):
            yield _synthetic_batch(gen, batch, hw, classes, chans)
        return
    mesh = sharding.mesh
    gen = torch.Generator(device=mesh.device(mesh.local_ranks()[0])
                          ).manual_seed(seed)
    y_sh = _mesh.NamedSharding(mesh, _mesh.P(*sharding.spec[:1]))
    for _ in range(n_batches):
        x, y = _synthetic_batch(gen, batch, hw, classes, chans)
        yield _mesh.device_put(x, sharding), _mesh.device_put(y, y_sh)
