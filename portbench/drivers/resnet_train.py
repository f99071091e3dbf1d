"""Drives the port's training engine as one card of a data-parallel job runs
it: a call is one SGD step of ResNet-50 v1.5 on operand set ``s``:

    params, forward = resnet(depth=50, num_classes=classes, width=width,
                             seed=seed, input_shape=(B, image, image, 3),
                             dtype=dtype)
    engine = MLEngine(params, forward, SolverConfig(lr, momentum, wd))
    loss = engine.train_step(x_s, y_s)      # the step's CUDA graph replayed

on images ``x_s`` [B, image, image, 3] f32 (NHWC) and labels ``y_s`` [B]
int64 already on the card.  The engine is compiled (its default on one
card): the first call is the eager warm-up and the capture, every later one
a replay.  A call returns the loss (a device tensor) with copies of the
parameters and momentum from before the step (the previous call's copy, or
set-up's for the first call) and after it, each a [2, P] f32 tensor: the
parameters, then the momentum, every leaf flattened in the engine's order.
``spans["engine_forms"]`` is the engine's ``forms`` (steps by the form they
ran in), for ``graph_misses``.  Set-up ends with the traffic's
``pretrain_steps`` calls, so that the measured steps are those of a job
past its start.

Each operand set has its own images, N(0, 1), and labels, uniform over
the classes, from the seed; the weights are the port's He init from the
seed.  The control runs no engine: each call is the plain reference's step
(``reference/resnet.py``) with every conv's operands rounded through
float8 e4m3, from the control's own previous state.

The check runs the reference step in f32 from each kept output's state
before the step, on its set's whole batch (BN's statistics are over the
batch, so it cannot be split): ``loss_rel_err`` is |loss - loss_ref| /
|loss_ref|.  The update numbers compare the step's own term, g' = g +
wd p0, and not the whole update: p1 - p0 = -lr (mu m0 + g') carries the
momentum m0 of every earlier step, which is the same on both sides, so an
error in g' would read smaller the more steps came before.  g' is read from
both rows of the state, m1 - mu m0 and (p0 - p1) / lr - mu m0, each against
the reference's m1 - mu m0, so that a step that leaves the parameters or the
momentum behind fails too: ``update_rel_err`` is the relative Frobenius
error over every leaf as one vector, ``fc_update_rel_err`` the same over the
classifier's weight and bias alone.  In the first ~20 steps from the He
init the network amplifies any rounding: a bf16 step's g' reads 1.2-1.3
against f32 over every leaf and 0.07-0.10 over the classifier, and the f32
reference with its convs rounded to bf16 reads the same, step for step
(PERF.md); float8 reads only ~2x higher there.  From step ~25 on the
program reads 4x or more below float8 on the classifier, hence the
set-up's steps.
"""

from __future__ import annotations

import math

import torch

from .. import check, inputs, roofline_resnet
from ..reference import resnet as ref

F32 = torch.float32
CONTROL_ROUND = torch.float8_e4m3fn
FC = "fc."    # the classifier's leaves in the reference's names


class Driver:
    numbers = ("loss_rel_err", "update_rel_err", "fc_update_rel_err")

    def __init__(self, config, traffic, device, seed, control=False,
                 spans=None):
        from xsmm_tpu_torch.models import MLEngine, SolverConfig, resnet
        from xsmm_tpu_torch.models.engine import (tree_flatten_with_path,
                                                  tree_map)

        if not hasattr(MLEngine, "train_step"):
            raise RuntimeError("this program's MLEngine has no train_step")
        if int(config["depth"]) != 50:
            raise ValueError(f"depth {config['depth']}: this driver runs "
                             "ResNet-50")
        self.batch, self.image = int(config["batch"]), int(config["image"])
        self.classes = int(config["classes"])
        self.solver = dict(config["solver"])
        self.calls_per_step = int(traffic["calls_per_step"])
        self.device, self.seed, self.control = device, seed, control
        params, forward = resnet(
            depth=50, num_classes=self.classes, width=int(config["width"]),
            seed=seed, input_shape=(self.batch, self.image, self.image, 3),
            dtype=config["dtype"])
        trainable = {k: v for k, v in params.items() if not k.startswith("_")}
        # where each of the reference's named leaves lies in a flat state:
        # the reference's conversion of a tree of the leaves' positions
        flat = [t for _, t in tree_flatten_with_path(trainable)]
        offset, self._size = {}, 0
        for t in flat:
            offset[id(t)] = self._size
            self._size += t.numel()
        self._where = ref.from_engine(tree_map(
            lambda t: torch.arange(offset[id(t)], offset[id(t)] + t.numel(),
                                   device=device).view(t.shape),
            trainable)["layers"])
        self.engine = None
        if control:
            self.prev = self._flat(flat, [torch.zeros_like(t) for t in flat])
        else:
            self.engine = MLEngine(params, forward, SolverConfig(
                lr=self.solver["lr"], momentum=self.solver["momentum"],
                weight_decay=self.solver["weight_decay"]))
            self._leaves = [t for _, t in tree_flatten_with_path(
                self.engine.params)]
            self._moms = [t for _, t in tree_flatten_with_path(
                self.engine.momentum)]
            self.prev = self._flat(self._leaves, self._moms)
            if spans is not None:
                spans["engine_forms"] = self.engine.forms
        del params, forward, trainable, flat
        self.sets = [self._data(s) for s in range(inputs.SETS)]
        self.ops_per_call, self.bytes_per_call = roofline_resnet.step(config)
        for i in range(int(traffic["pretrain_steps"])):
            self.call(None, i % inputs.SETS)

    def _data(self, s):
        x = inputs.normal((self.batch, self.image, self.image, 3), F32,
                          self.device, self.seed, inputs.stream(s, 0))
        g = torch.Generator(device=self.device)
        g.manual_seed(inputs.stream_seed(self.seed, inputs.stream(s, 1)))
        y = torch.randint(0, self.classes, (self.batch,), generator=g,
                          device=self.device)
        return x, y

    @staticmethod
    def _flat(params, moms) -> torch.Tensor:
        """[2, P]: the parameters, then the momentum, each leaf flattened
        in the engine's order."""
        return torch.cat([t.detach().reshape(-1) for t in params]
                         + [t.detach().reshape(-1) for t in moms]
                         ).view(2, -1)

    def _named(self, flat: torch.Tensor):
        """(parameters, momentum) of a [2, P] state as the reference's
        named leaves, in its layouts."""
        return [{k: row[w] for k, w in self._where.items()} for row in flat]

    def _to_flat(self, params, moms) -> torch.Tensor:
        """The [2, P] state of the reference's named leaves."""
        out = torch.empty((2, self._size), dtype=F32, device=self.device)
        for row, src in zip(out, (params, moms)):
            for k, w in self._where.items():
                row[w] = src[k].to(F32)
        return out

    def lookup(self):
        return None

    def call(self, handle, s):
        x, y = self.sets[s]
        before = self.prev
        if self.control:
            p, m = self._named(before)
            st = ref.train_step(p, m, x, y, lr=self.solver["lr"],
                                mu=self.solver["momentum"],
                                wd=self.solver["weight_decay"],
                                conv_round=CONTROL_ROUND)
            loss, after = st.loss, self._to_flat(st.params, st.momentum)
        else:
            loss = self.engine.train_step(x, y)
            after = self._flat(self._leaves, self._moms)
        self.prev = after
        return loss, before, after

    def release(self):
        self.engine = self._leaves = self._moms = None
        del self.sets
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, outputs):
        """{number: [one reading an output]} of ``numbers``, each (set,
        output) against the f32 reference step from the output's state
        before the step, on its set's batch."""
        return check.per_set(outputs, self._check_set)

    def _check_set(self, s, outputs):
        x, y = self._data(s)
        got = {n: [] for n in self.numbers}
        lr, mu = self.solver["lr"], self.solver["momentum"]
        for loss, before, after in outputs:
            p0, m0 = self._named(before)
            p1, m1 = self._named(after)
            st = ref.train_step(p0, m0, x, y, lr=lr, mu=mu,
                                wd=self.solver["weight_decay"])
            for name, v in step_numbers(loss, p0, m0, p1, m1, st, lr,
                                        mu).items():
                got[name].append(v)
            del st
        return got


def step_numbers(loss, p0, m0, p1, m1, st, lr: float, mu: float) -> dict:
    """The cell's numbers of one step from (``p0``, ``m0``) to (``p1``,
    ``m1``), named leaves, with its ``loss``, against the reference's step
    ``st`` from the same state."""
    want = float(st.loss)
    sums = {"update_rel_err": [0.0, 0.0], "fc_update_rel_err": [0.0, 0.0]}
    for k in p0:
        carried = mu * m0[k].double()
        g_ref = st.momentum[k].double() - carried
        g_mom = m1[k].double() - carried
        g_par = (p0[k].double() - p1[k].double()) / lr - carried
        parts = (float(((g_mom - g_ref) ** 2).sum()
                       + ((g_par - g_ref) ** 2).sum()),
                 2.0 * float((g_ref ** 2).sum()))
        for name in sums if k.startswith(FC) else ("update_rel_err",):
            sums[name][0] += parts[0]
            sums[name][1] += parts[1]
    out = {"loss_rel_err": _finite(abs(float(loss) - want) / abs(want))}
    out.update({name: _finite(math.sqrt(err / sq))
                for name, (err, sq) in sums.items()})
    return out


def _finite(x: float) -> float:
    """A reading, with infinity for NaN: a comparison with NaN is false,
    so a NaN would pass any limit."""
    return x if not math.isnan(x) else math.inf
