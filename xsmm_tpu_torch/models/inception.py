"""Inception-v3 — third GxM model-zoo member — as a layer graph.
The port of ``xsmm_tpu/models/inception.py``: the same specs.

Reference: samples/deeplearning/gxm/model_zoo ships the Inception-v3
prototxt (Engine.cpp builds the layer graph).  Canonical Szegedy et al.
2015 v3 topology: conv stem, 3x InceptionA (35x35), ReductionA,
4x InceptionB (17x17, 7x1/1x7 factorized), ReductionB, 2x InceptionC
(8x8, expanded 1x3/3x1), global avgpool, fc.  Every "BasicConv2d"
(conv+BN+ReLU) runs through the framework's ConvLayer + FusedBatchNorm
handles; inception blocks are branch/concat nodes (the GxM Split+Concat
pattern), with nested branches for the C-block 1x3/3x1 forks.

``width`` scales every channel count by width/32 so tests run a tiny but
topologically complete network (width=32 is canonical).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ..dnn.layers import build_graph


def _c(v: int, width: int) -> int:
    return max(4, int(round(v * width / 32)))


def _cbr(k: int, r: int, s: int = None, stride: int = 1) -> List[Dict]:
    """BasicConv2d: conv + BN + ReLU (handles' fused epilogue)."""
    return [{"type": "conv", "k": k, "r": r, "s": s if s is not None else r,
             "stride": stride},
            {"type": "batchnorm", "relu": True}]


def _avgpool3():
    return {"type": "pooling", "op": "avg", "r": 3, "stride": 1,
            "pad": "same"}


def _maxpool3():
    return {"type": "pooling", "op": "max", "r": 3, "stride": 2,
            "pad": "same"}


def inception_specs(num_classes: int, width: int, aux: bool = True) -> Tuple[List[Dict], tuple]:
    c = lambda v: _c(v, width)

    def block_a(pool_c):
        return {"type": "branch", "combine": "concat", "paths": [
            _cbr(c(64), 1),
            _cbr(c(48), 1) + _cbr(c(64), 5),
            _cbr(c(64), 1) + _cbr(c(96), 3) + _cbr(c(96), 3),
            [_avgpool3()] + _cbr(pool_c, 1),
        ]}

    def reduction_a():
        return {"type": "branch", "combine": "concat", "paths": [
            _cbr(c(384), 3, stride=2),
            _cbr(c(64), 1) + _cbr(c(96), 3) + _cbr(c(96), 3, stride=2),
            [_maxpool3()],
        ]}

    def block_b(mid):
        return {"type": "branch", "combine": "concat", "paths": [
            _cbr(c(192), 1),
            _cbr(mid, 1) + _cbr(mid, 1, 7) + _cbr(c(192), 7, 1),
            (_cbr(mid, 1) + _cbr(mid, 7, 1) + _cbr(mid, 1, 7)
             + _cbr(mid, 7, 1) + _cbr(c(192), 1, 7)),
            [_avgpool3()] + _cbr(c(192), 1),
        ]}

    def reduction_b():
        return {"type": "branch", "combine": "concat", "paths": [
            _cbr(c(192), 1) + _cbr(c(320), 3, stride=2),
            (_cbr(c(192), 1) + _cbr(c(192), 1, 7) + _cbr(c(192), 7, 1)
             + _cbr(c(192), 3, stride=2)),
            [_maxpool3()],
        ]}

    def block_c():
        # branches 2/3 fork into parallel 1x3 + 3x1 — a nested branch node
        fork_2 = _cbr(c(384), 1) + [
            {"type": "branch", "combine": "concat",
             "paths": [_cbr(c(384), 1, 3), _cbr(c(384), 3, 1)]}]
        fork_3 = _cbr(c(448), 1) + _cbr(c(384), 3) + [
            {"type": "branch", "combine": "concat",
             "paths": [_cbr(c(384), 1, 3), _cbr(c(384), 3, 1)]}]
        return {"type": "branch", "combine": "concat", "paths": [
            _cbr(c(320), 1),
            fork_2,
            fork_3,
            [_avgpool3()] + _cbr(c(192), 1),
        ]}

    kinds = ("A", "A", "A", "RA", "B", "B", "B", "B", "RB", "C", "C")
    specs: List[Dict[str, Any]] = (
        _cbr(c(32), 3, stride=2) + _cbr(c(32), 3) + _cbr(c(64), 3)
        + [_maxpool3()]
        + _cbr(c(80), 1) + _cbr(c(192), 3) + [_maxpool3()])
    for pool_c in (c(32), c(64), c(64)):
        specs.append(block_a(pool_c))
    specs.append(reduction_a())
    for mid in (c(128), c(160), c(160), c(192)):
        specs.append(block_b(mid))
    if aux:
        # auxiliary classifier after the last 17x17 block (Szegedy et al.
        # 2015 §4: one aux head on the 17x17 stage, loss weight 0.4; BN in
        # the head is approximated by the generic tap — the reference zoo
        # carries no inception-v3, this model is a bonus member)
        specs.append({"type": "aux_head", "classes": num_classes,
                      "weight": 0.4, "pool_r": 5, "pool_stride": 3,
                      "conv_k": c(128), "fc": c(768), "dropout": 0.0})
    specs.append(reduction_b())
    specs += [block_c(), block_c()]
    specs += [{"type": "global_avg_pool"},
              {"type": "fc", "k": num_classes}]
    return specs, kinds


def inception_v3(num_classes: int = 1000, width: int = 32, seed: int = 0,
                 input_shape: Tuple[int, int, int, int] = (8, 64, 64, 3),
                 dtype: str = "float32", aux: bool = True):
    specs, kinds = inception_specs(num_classes, width, aux=aux)
    init, graph = build_graph(specs, input_shape, dtype=dtype, seed=seed)
    params = {"layers": init,
              "_meta": {"model": "inception_v3", "width": width,
                        "kinds": kinds}}

    from ..dnn.layers import make_model_forward
    return params, make_model_forward(graph)
