"""Reusable layer nodes + graph-from-config builder — the GxM engine analog:
the port of ``xsmm_tpu/dnn/layers.py``.

Reference: samples/deeplearning/gxm/src/Engine.cpp:484-665 builds networks
from prototxt NodeParameter lists out of reusable layer nodes (ConvXSMM,
FusedBNormXSMM, Pooling, FullyConnected, Dropout, Split, Eltwise, Concat —
gxm/src/*.cpp), and the model zoo (AlexNet / ResNet-50 / Inception-v3) is
expressed as such graphs.

A graph is a list of layer-spec dicts consumed by ``build_graph`` ->
(params, graph), with the JAX package's names, spec grammar, parameter
structure and initial values (the same numpy draws in the same order,
f32 master weights).  Every compute node runs through the port's DNN layer
handles (``dnn/conv.py``, ``dnn/batchnorm.py``, ``dnn/pooling.py``,
``dnn/fullyconnected.py``); the fuse flags (BIAS/RELU) map onto the
handles' fused epilogues.  The handles' forwards take any batch, so a
graph built at a nominal shape serves any batch size.  Training
differentiates the forward with ``torch.autograd``; parameters are tensors
on the entry points' device (the card unless ``target="cpu"``).
Activations stay NHWC and contiguous from node to node.

Every node runs inside a ``utils/trace.scope`` named ``graph.<type>``
(a range only under a profiler or ``XSMM_TRACE``), so a profile of a step
splits its time by layer type.

Spec types (GxM node analog in parens):

  {"type": "conv", "k", "r"[, "s", "stride", "pad", "bias", "relu"]}  (ConvXSMM)
  {"type": "batchnorm"[, "relu"]}                                (FusedBNormXSMM)
  {"type": "pooling", "op": "max"|"avg", "r"[, "stride", "pad"]}      (Pooling)
  {"type": "fc", "k"[, "bias", "relu"]}                        (FullyConnected)
  {"type": "relu"}                                                     (ReLU)
  {"type": "dropout", "rate"}                                        (Dropout)
  {"type": "branch", "paths": [[...], ...], "combine": "concat"|"add"
      [, "relu"]}                                       (Split + Concat/Eltwise)
  {"type": "aux_head", "classes"[, ...]}          (train-only classifier tap)
  {"type": "global_avg_pool"} / {"type": "flatten"}

Over a mesh (``parallel/mesh.py``) the graph runs **in lock-step over
the ranks**: the input is a ``Ranks`` value (one tensor a local rank, with
the mesh and its data and model axes), the parameters one structure a
rank, and each node is applied to every rank's tensor in turn, the paths
of branch nodes too.  The BN nodes (and the fused conv+BN node) combine
the ranks' moments over the data axis with the mesh's collectives (the
JAX package's global batch statistics under ``jit``); an FC node whose
weight holds a column shard (tensor parallel over the model axis)
all-gathers its logits.  Torch ops throughout, so one
``torch.autograd.grad`` differentiates every rank's step.

Stated difference: dropout draws from a ``torch.Generator`` (``rng=``)
where the JAX package splits a key, so its bits differ; its rate, its
scale and its identity in eval are the same.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core import platform
from ..ops.smm import as_tensor
from ..parallel import mesh as _mesh
from ..utils import trace
from .batchnorm import _mean_over, _sum_over, create_fusedbatchnorm
from .conv import create_conv_layer
from .fullyconnected import create_fullyconnected_layer
from .pooling import create_pooling_layer
from .types import (BnDesc, BnFuse, ConvDesc, FCDesc, FuseOp, PoolingDesc,
                    PoolType)


# ---------------------------------------------------------------------------
# Reusable functional layer nodes (the Dropout/Eltwise/Split/Concat fns)
# ---------------------------------------------------------------------------


def dropout(x, rate: float, *, gen, train: bool):
    """GxM Dropout node: inverted dropout, identity at inference; the mask
    is drawn from ``gen`` (a ``torch.Generator`` on x's device)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def eltwise_add(a, b, relu: bool = False):
    """GxM Eltwise node (ELTWISE_OP_SUM), optional fused ReLU."""
    y = a + b.to(a.dtype)
    return torch.relu(y) if relu else y


def concat(xs: Sequence[torch.Tensor], axis: int = -1):
    """GxM Concat node (channel concat in NHWC)."""
    return torch.cat(list(xs), dim=axis)


def split(x, n: int = 2):
    """GxM Split node: fan a tensor out to n consumers (pure fan-out)."""
    return (x,) * n


def global_avg_pool(x):
    return x.mean(dim=(1, 2))


def flatten(x):
    return x.reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# Graph builder
# ---------------------------------------------------------------------------


def _conv_init(rng: np.random.Generator, r, s, cin, cout, dev,
               scheme: str = "he"):
    # The JAX package's init, draw for draw (its comments give the reasons):
    # scheme="he": N(0, 2/fan_in), for BN-normalized nets (resnet);
    # scheme="xavier": uniform on [-sqrt(3/fan_in), +sqrt(3/fan_in)], the
    # Caffe/GxM XavierFiller.  Master weights are f32 whatever the compute
    # dtype: the handles cast to their descriptor dtype per call.
    fan_in = max(r * s * cin, 1)
    if scheme == "xavier":
        lim = np.sqrt(3.0 / fan_in)
        w = rng.uniform(-lim, lim, (r, s, cin, cout))
    else:
        w = rng.standard_normal((r, s, cin, cout)) * np.sqrt(2.0 / fan_in)
    return _param(w, dev)


def _param(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(dev)


class Ranks(list):
    """One lock-step value: a tensor a local rank of ``mesh`` (in
    ``mesh.local_ranks()`` order), with the mesh's data axis (batch shards,
    BN statistics combined over it) and model axis (tensor-parallel FC
    shards gathered over it).  Without a mesh the ranks are the list's
    members; one device is a list of one."""

    def __init__(self, values, mesh=None, data_axis: str = "dp",
                 model_axis: str = "mp"):
        super().__init__(values)
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis

    def like(self, values) -> "Ranks":
        return Ranks(values, self.mesh, self.data_axis, self.model_axis)

    def pmean(self, values):
        """The mean over the data axis (over the list without a mesh)."""
        if self.mesh is None:
            return _mean_over(values)
        return _mesh.pmean(self.mesh, self.data_axis, values)

    def psum(self, values):
        """The sum over the data axis (over the list without a mesh)."""
        if self.mesh is None:
            return _sum_over(values)
        return _mesh.psum(self.mesh, self.data_axis, values)

    @property
    def data_size(self) -> int:
        return len(self) if self.mesh is None else \
            self.mesh.shape[self.data_axis]


def _pick(p: Ranks, i):
    """Item ``i`` of every rank's parameters."""
    return Ranks([q[i] for q in p])


def _scoped(name: str, node: Callable) -> Callable:
    """The node inside a trace scope, run once a rank unless it combines
    the ranks itself (``node.lockstep``)."""
    lockstep = getattr(node, "lockstep", False)

    def run(p, x, ctx):
        with trace.scope(name):
            if lockstep:
                return node(p, x, ctx)
            return x.like([node(pi, xi, ctx) for pi, xi in zip(p, x)])
    return run


class Graph:
    """A built layer graph: handles + init params + functional forward.

    Every node runs over ``Ranks``: a tensor given to the graph is one
    rank (its parameters and state one structure), and the result comes
    back as a tensor.

    Stateful layers (batchnorm running statistics — the GxM
    use_global_stats machinery, FusedBNormXSMM.cpp:427-467) keep their
    state in ``init_state``, a flat dict keyed by node id.  ``apply``
    threads it: train folds each step's batch stats into the moving sums,
    eval normalizes with the global stats (correct at batch size 1).
    Calling the graph directly (``__call__``) uses batch statistics
    unconditionally — the stateless legacy path.

    ``layers`` lists ("conv", ConvDesc) and ("fc", FCDesc) for every conv
    and FC node in build order (aux heads included), for counting a
    model's operations.
    """

    def __init__(self, specs: List[Dict[str, Any]],
                 input_shape: Tuple[int, int, int, int],
                 dtype: str = "float32", seed: int = 0,
                 fuse_conv_bn: bool = False):
        self.specs = specs
        self.dtype = dtype
        self.fuse_conv_bn = fuse_conv_bn
        self.device = platform.device()
        self._rng = np.random.default_rng(seed)
        self.init_state: Dict[str, Any] = {}
        self._n_stateful = 0
        self.layers: List[Tuple[str, Any]] = []
        # loss weights of aux_head taps, in trunk order (GoogLeNet v1's
        # two SoftmaxWithLoss branches at 4a/4d, loss_weight 0.3 —
        # model_zoo/googlenet/v1/train_val_flat.prototxt)
        self.aux_weights: List[float] = []
        self.nodes, self.init_params, self.out_shape = self._build(
            specs, tuple(input_shape))

    # -- recursive spec walk --------------------------------------------------
    def _build(self, specs, shape):
        nodes: List[Callable] = []
        params: List[Any] = []
        i = 0
        while i < len(specs):
            spec = specs[i]
            t = spec["type"]
            # FusedConvBN (gxm/src/FusedConvBNXSMM.cpp analog): a conv
            # without its own ReLU followed by a batchnorm becomes one
            # node — the conv's BATCH_STATS_FWD epilogue feeds the BN
            if (self.fuse_conv_bn and t == "conv"
                    and not spec.get("relu") and i + 1 < len(specs)
                    and specs[i + 1]["type"] == "batchnorm"):
                node, p, shape = self._build_conv_bn(spec, specs[i + 1],
                                                     shape)
                nodes.append(_scoped("graph.conv_bn", node))
                params.append(p)
                i += 2
                continue
            build = getattr(self, f"_build_{t}", None)
            if build is None:
                raise ValueError(f"unknown layer type: {t!r}")
            node, p, shape = build(spec, shape)
            if t not in ("branch", "aux_head"):   # their nodes are scoped
                node = _scoped(f"graph.{t}", node)
            nodes.append(node)
            params.append(p)
            i += 1
        return nodes, params, shape

    @staticmethod
    def _parse_conv_spec(spec):
        """Shared conv-spec grammar (r/s/stride/pad/k) — used by both the
        plain conv build and the FusedConvBN build so they cannot
        diverge."""
        r = int(spec.get("r", 3))
        s = int(spec.get("s", r))
        u = int(spec.get("stride", 1))
        pad = spec.get("pad", "same")
        ph, pw = ((r - 1) // 2, (s - 1) // 2) if pad == "same" else \
            ((0, 0) if pad == "valid" else (int(pad), int(pad)))
        return r, s, u, ph, pw, int(spec["k"])

    def _conv_desc(self, spec, shape, fuse):
        n, h, w, c = shape
        r, s, u, ph, pw, k = self._parse_conv_spec(spec)
        if spec.get("bias"):
            fuse |= FuseOp.BIAS
        desc = ConvDesc(n=n, c=c, h=h, w=w, k=k, r=r, s=s, u=u, v=u,
                        pad_h=ph, pad_w=pw, in_dtype=self.dtype,
                        out_dtype=self.dtype, fuse_ops=fuse)
        self.layers.append(("conv", desc))
        p = {"w": _conv_init(self._rng, r, s, c, k, self.device,
                             spec.get("init", "he"))}
        return desc, p

    def _build_conv(self, spec, shape):
        fuse = FuseOp.RELU if spec.get("relu") else FuseOp.NONE
        desc, p = self._conv_desc(spec, shape, fuse)
        layer = create_conv_layer(desc)
        if spec.get("bias"):
            p["b"] = torch.zeros((desc.k,), device=self.device)

        def node(p, x, ctx, _l=layer):
            return _l.forward(x, p["w"], p.get("b"))

        return node, p, (shape[0], desc.out_h, desc.out_w, desc.k)

    def _build_conv_bn(self, spec, bn_spec, shape):
        """Fused conv+BN node: conv with BATCH_STATS_FWD feeding the BN's
        normalization directly (FusedConvBNXSMM analog; opt-in via
        Graph(fuse_conv_bn=True))."""
        desc, p = self._conv_desc(spec, shape, FuseOp.BATCH_STATS_FWD)
        conv = create_conv_layer(desc)
        k = desc.k
        bn_fuse = BnFuse.RELU if bn_spec.get("relu") else BnFuse.BN
        bn = create_fusedbatchnorm(BnDesc(n=shape[0], c=k, h=desc.out_h,
                                          w=desc.out_w, fuse=bn_fuse,
                                          dtype=self.dtype))
        p["gamma"] = torch.ones((k,), device=self.device)
        p["beta"] = torch.zeros((k,), device=self.device)
        if spec.get("bias"):
            p["b"] = torch.zeros((k,), device=self.device)
        key = f"bn{self._n_stateful}"
        self._n_stateful += 1
        self.init_state[key] = bn.init_running()

        def node(p, x, ctx, _c=conv, _bn=bn, _key=key):
            return conv_bn_ranks(p, x, ctx, _c, _bn, _key)

        node.lockstep = True
        return node, p, (shape[0], desc.out_h, desc.out_w, k)

    def _build_batchnorm(self, spec, shape):
        n, h, w, c = shape
        fuse = BnFuse.RELU if spec.get("relu") else BnFuse.BN
        layer = create_fusedbatchnorm(BnDesc(n=n, c=c, h=h, w=w, fuse=fuse,
                                             dtype=self.dtype))
        p = {"gamma": torch.ones((c,), device=self.device),
             "beta": torch.zeros((c,), device=self.device)}
        key = f"bn{self._n_stateful}"
        self._n_stateful += 1
        self.init_state[key] = layer.init_running()

        def node(p, x, ctx, _l=layer, _key=key):
            return batchnorm_ranks(p, x, ctx, _l, _key)

        node.lockstep = True
        return node, p, shape

    def _build_pooling(self, spec, shape):
        n, h, w, c = shape
        r = int(spec.get("r", 2))
        u = int(spec.get("stride", r))
        pad = spec.get("pad", "same" if u == 2 and r == 3 else "valid")
        ph = (r - 1) // 2 if pad == "same" else int(0 if pad == "valid"
                                                    else pad)
        op = PoolType.MAX if spec.get("op", "max") == "max" else PoolType.AVG
        desc = PoolingDesc(n=n, c=c, h=h, w=w, r=r, s=r, u=u, v=u,
                           pad_h=ph, pad_w=ph, pool_type=op,
                           dtype=self.dtype)
        layer = create_pooling_layer(desc)

        def node(p, x, ctx, _l=layer):
            return _l.forward(x)

        return node, None, (n, desc.out_h, desc.out_w, c)

    def _build_fc(self, spec, shape):
        n = shape[0]
        cin = int(np.prod(shape[1:]))
        k = int(spec["k"])
        fuse = FuseOp.BIAS if spec.get("bias", True) else FuseOp.NONE
        if spec.get("relu"):
            fuse |= FuseOp.RELU
        desc = FCDesc(n=n, c=cin, k=k, in_dtype=self.dtype,
                      out_dtype=self.dtype, fuse_ops=fuse)
        self.layers.append(("fc", desc))
        layer = create_fullyconnected_layer(desc)
        # init "zero" (classifier heads of un-normalized nets): logits
        # start exactly uniform (the JAX package's recipe)
        if spec.get("init") == "zero":
            w0 = np.zeros((cin, k))
        else:
            w0 = self._rng.standard_normal((cin, k)) * np.sqrt(1.0 / cin)
        p = {"w": _param(w0, self.device)}
        if spec.get("bias", True):
            p["b"] = torch.zeros((k,), device=self.device)
        relu = bool(spec.get("relu"))

        def one(p, x, _l=layer, _relu=relu):
            if x.ndim > 2:
                x = flatten(x)
            out = _l.forward(x, p["w"], p.get("b"))
            # fused-ReLU fwd returns (y, relu_mask) for the layer-level bwd
            return out[0] if _relu else out

        def node(p, x, ctx, _k=k):
            ys = [one(pi, xi) for pi, xi in zip(p, x)]
            if p[0]["w"].shape[1] != _k:
                # a column shard a rank (tensor parallel over the model
                # axis): gather the logits' columns in axis order
                ys = _mesh.all_gather(x.mesh, x.model_axis, ys, dim=1)
            return x.like(ys)

        node.lockstep = True
        return node, p, (n, k)

    def _build_relu(self, spec, shape):
        def node(p, x, ctx):
            return torch.relu(x)
        return node, None, shape

    def _build_dropout(self, spec, shape):
        rate = float(spec.get("rate", 0.5))

        def node(p, x, ctx, _rate=rate):
            if not ctx["train"]:
                return x
            if ctx["rng"] is None:
                raise ValueError("dropout in train mode requires rng (a "
                                 "torch.Generator)")
            return dropout(x, _rate, gen=ctx["rng"], train=True)

        return node, None, shape

    def _build_branch(self, spec, shape):
        combine = spec.get("combine", "concat")
        paths = []
        out_shapes = []
        sub_params_init = []
        for path_specs in spec["paths"]:
            nodes, ps, out = self._build(path_specs, shape)
            paths.append(nodes)
            sub_params_init.append(ps)
            out_shapes.append(out)
        if combine == "concat":
            if any(o[:-1] != out_shapes[0][:-1] for o in out_shapes):
                raise ValueError(f"concat branches must agree on N,H,W: "
                                 f"{out_shapes}")
            out_shape = out_shapes[0][:-1] + (
                sum(o[-1] for o in out_shapes),)
        else:  # add (Eltwise): all shapes identical
            if any(o != out_shapes[0] for o in out_shapes):
                raise ValueError(f"eltwise branches must agree: "
                                 f"{out_shapes}")
            out_shape = out_shapes[0]
        relu = bool(spec.get("relu"))

        def combine_(outs, _combine=combine, _relu=relu):
            if _combine == "concat":
                y = concat(outs)
            else:
                y = outs[0]
                for o in outs[1:]:
                    y = eltwise_add(y, o)
            return torch.relu(y) if _relu else y

        def node(p, x, ctx, _paths=paths, _combine=combine):
            outs = []
            for pi, path_nodes in enumerate(_paths):
                path_params = _pick(p, pi)
                y = x
                for j, fn in enumerate(path_nodes):
                    y = fn(_pick(path_params, j), y, ctx)
                outs.append(y)
            with trace.scope(f"graph.{_combine}"):
                return x.like([combine_([o[r] for o in outs])
                               for r in range(len(x))])

        return node, sub_params_init, out_shape

    def _build_aux_head(self, spec, shape):
        """Auxiliary classifier tap (GoogLeNet-v1 training recipe —
        train_val_flat.prototxt's avgpool5/3 -> conv1x1 -> fc -> dropout
        -> fc SoftmaxWithLoss branches at 4a/4d, loss_weight 0.3).

        Train only, the prototxt's include{phase:TRAIN}: in train mode the
        branch appends its logits to ctx["aux"] (MLEngine's weighted
        multi-loss) and passes the trunk activation through unchanged; in
        eval it does not exist.
        """
        classes = int(spec["classes"])
        # clamp the prototxt's 5x5/3 tap pool to the trunk resolution so
        # width-scaled test builds (tiny H) keep the same topology
        pr = min(int(spec.get("pool_r", 5)), shape[1], shape[2])
        ps = min(int(spec.get("pool_stride", 3)), pr)
        sub_specs = spec.get("specs") or [
            {"type": "pooling", "op": "avg", "r": pr,
             "stride": ps, "pad": "valid"},
            {"type": "conv", "k": int(spec.get("conv_k", 128)), "r": 1,
             "bias": True, "relu": True,
             "init": spec.get("init", "he")},
            {"type": "fc", "k": int(spec.get("fc", 1024)), "relu": True},
            {"type": "dropout", "rate": float(spec.get("dropout", 0.7))},
            {"type": "fc", "k": classes,
             "init": spec.get("head_init", "he")},
        ]
        sub_nodes, sub_params, out = self._build(sub_specs, shape)
        if out != (shape[0], classes):
            raise ValueError(f"aux head gives {out}, not "
                             f"{(shape[0], classes)}")
        self.aux_weights.append(float(spec.get("weight", 0.3)))

        def node(p, x, ctx, _nodes=sub_nodes):
            if not ctx["train"]:
                return x
            y = x
            for j, fn in enumerate(_nodes):
                y = fn(_pick(p, j), y, ctx)
            ctx.setdefault("aux", []).append(y)
            return x

        return node, sub_params, shape

    def _build_global_avg_pool(self, spec, shape):
        def node(p, x, ctx):
            return global_avg_pool(x)
        return node, None, (shape[0], shape[-1])

    def _build_flatten(self, spec, shape):
        def node(p, x, ctx):
            return flatten(x)
        return node, None, (shape[0], int(np.prod(shape[1:])))

    # -- execution -------------------------------------------------------------
    def _run(self, params, state, x, train: bool, rng):
        """The nodes in order over ``Ranks`` (a tensor is one rank):
        (y, or (y, *aux) in train mode with aux taps; the new state)."""
        one = not isinstance(x, Ranks)
        if one:
            x = Ranks([x if isinstance(x, torch.Tensor)
                       else as_tensor(x, self.device)])
            params = Ranks([params])
            state = None if state is None else [state]
        ctx = {"train": train, "rng": rng, "state": state,
               "new_state": [{} for _ in x]}
        for j, fn in enumerate(self.nodes):
            x = fn(_pick(params, j), x, ctx)
        # aux taps (phase-TRAIN only) make the output (main, *aux)
        outs = (x, *ctx.get("aux", ()))
        if one:
            outs = tuple(o[0] for o in outs)
        if state is not None and train:
            state = [{**s, **ns} for s, ns in zip(state, ctx["new_state"])]
        if one and state is not None:
            state = state[0]
        return (outs if len(outs) > 1 else outs[0]), state

    def __call__(self, params, x, train: bool = False, rng=None):
        return self._run(params, None, x, train, rng)[0]

    def apply(self, params, state: Dict[str, Any], x,
              train: bool = False, rng=None):
        """Stateful forward: returns (y, new_state).

        train=True: batch-stat normalization + moving-sum update (GxM
        TRAIN mode); train=False: global-stats normalization (GxM
        TEST/VAL mode — use_global_stats).  Over ``Ranks`` (lock-step),
        params and state hold one structure a rank, and the new state comes
        back so."""
        return self._run(params, state, x, train, rng)

    def forward_flops(self, batch: int = 0) -> int:
        """The forward's conv and FC operations at ``batch`` (default: the
        nominal batch): 2*N*OH*OW*K*C*R*S a conv, 2*N*C*K an FC."""
        total = 0
        for kind, d in self.layers:
            n = batch or d.n
            if kind == "conv":
                total += 2 * n * d.out_h * d.out_w * d.k * d.c * d.r * d.s
            else:
                total += 2 * n * d.c * d.k
        return total


def batchnorm_ranks(p, x: Ranks, ctx, layer, key):
    """A BN node over the ranks: the moments averaged over the data axis
    (the global batch's statistics), each rank normalized with them, and
    every rank's running state updated from them (replica-consistent)."""
    st = ctx.get("state")
    if st is not None and not ctx["train"]:
        return x.like([layer.forward_eval(xi, pi["gamma"], pi["beta"],
                                          si[key])
                       for pi, xi, si in zip(p, x, st)])
    ys, bstates = layer.forward_replicas(
        list(x), [pi["gamma"] for pi in p], [pi["beta"] for pi in p],
        pmean=x.pmean)
    if st is not None:
        with torch.no_grad():
            for si, ns, bs in zip(st, ctx["new_state"], bstates):
                ns[key] = layer.update_running(si[key], bs)
    return x.like(ys)


def conv_bn_ranks(p, x: Ranks, ctx, conv, bn, key):
    """The fused conv+BN node over the ranks: the convs' sum and sumsq and
    the count nhw summed over the data axis."""
    st = ctx.get("state")
    outs = [conv.forward(xi, pi["w"], pi.get("b")) for pi, xi in zip(p, x)]
    ys = [y for y, _ in outs]
    if st is not None and not ctx["train"]:
        return x.like([bn.forward_eval(y, pi["gamma"], pi["beta"], si[key])
                       for y, pi, si in zip(ys, p, st)])
    sums = x.psum([s.sum for _, s in outs])
    sumsqs = x.psum([s.sumsq for _, s in outs])
    res = []
    for y, pi, s1, s2, i in zip(ys, p, sums, sumsqs, range(len(ys))):
        nhw = y.shape[0] * y.shape[1] * y.shape[2] * x.data_size
        mean = s1 / nhw
        var = s2 / nhw - torch.square(mean)
        out, bstate = bn.forward_from_moments(y, pi["gamma"], pi["beta"],
                                              mean, var)
        if st is not None:
            with torch.no_grad():
                ctx["new_state"][i][key] = bn.update_running(st[i][key],
                                                             bstate)
        res.append(out)
    return x.like(res)


def make_model_forward(graph: Graph, key: str = "layers"):
    """Wrap a Graph as a model-level forward for MLEngine.

    The returned callable has the legacy signature; the stateful path
    (running BN statistics) is exposed via ``state=`` and advertised to
    the engine through the attached ``init_state``.
    """

    def forward(params, x, compute_dtype=None, train=False, rng=None,
                state=None):
        del compute_dtype  # dtype is a build-time choice (dtype= kwarg)
        layer_params = (Ranks([p[key] for p in params])
                        if isinstance(params, Ranks) else params[key])
        if state is not None:
            return graph.apply(layer_params, state, x, train=train, rng=rng)
        return graph(layer_params, x, train=train, rng=rng)

    forward.graph = graph
    forward.lockstep = True     # takes Ranks (MLEngine over a mesh)
    forward.init_state = graph.init_state
    forward.aux_loss_weights = tuple(graph.aux_weights)
    return forward


def build_graph(specs: List[Dict[str, Any]],
                input_shape: Tuple[int, int, int, int],
                dtype: str = "float32", seed: int = 0,
                fuse_conv_bn: bool = False) -> Tuple[List[Any], Graph]:
    """Build a layer graph from specs: returns (init_params, graph).

    The graph object is the forward callable: graph(params, x, train, rng).
    fuse_conv_bn=True merges conv->batchnorm pairs into FusedConvBN nodes
    (the conv's BATCH_STATS_FWD epilogue feeds the BN; the fused pair's
    params live in ONE dict, so the params tree differs from the unfused
    build).
    """
    g = Graph(specs, input_shape, dtype=dtype, seed=seed,
              fuse_conv_bn=fuse_conv_bn)
    return g.init_params, g
