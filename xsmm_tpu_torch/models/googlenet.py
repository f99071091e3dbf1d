"""GoogLeNet (Inception-v1) — the reference zoo's googlenet/v1 member.
The port of ``xsmm_tpu/models/googlenet.py``: the same specs.

Reference: samples/deeplearning/gxm/model_zoo/googlenet/v1/
train_val_flat.prototxt (59 Convolution nodes, 9 Concat inception
modules, ReLU after every conv/fc, no batchnorm — v1 predates BN).
Canonical Szegedy et al. 2014 channel table: stem conv7x7/2-64,
maxpool3/2, conv1x1-64, conv3x3-192, maxpool3/2; inception modules
3a/3b, maxpool, 4a-4e, maxpool, 5a/5b; global avgpool, dropout 0.4, fc.

The two auxiliary classifier heads of the 2014 training recipe (the
prototxt's avgpool5/3 -> conv1x1-128 -> fc1024 -> dropout0.7 -> fc
SoftmaxWithLoss taps after 4a and 4d, loss_weight 0.3) are built as
train-only ``aux_head`` taps (``aux=True``, default): MLEngine trains
with loss = main + 0.3*aux4a + 0.3*aux4d and eval/inference sees the
plain single-output trunk — exactly the prototxt's include{phase:TRAIN}
semantics.

``width`` scales every channel count by width/64 (width=64 canonical)
so tests run a tiny but topologically complete 9-module network.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ..dnn.layers import build_graph, make_model_forward


def _c(v: int, width: int) -> int:
    return max(4, int(round(v * width / 64)))


def _conv(k: int, r: int, stride: int = 1) -> Dict[str, Any]:
    # v1 convs carry a bias (no BN to absorb it) and a fused ReLU.
    # Trunk init stays He: the prototxt requests XavierFiller, but at
    # this depth without BN xavier activations vanish by the classifier
    # (pooled std ~0.01 -> frozen; dnn/layers._conv_init has the r5
    # measurement).  He keeps the features variance-preserving; the
    # classifier FCs are zero-init instead so the loss starts exactly
    # at uniform ln(C) with no He logit blow-up to recover from.
    return {"type": "conv", "k": k, "r": r, "stride": stride,
            "bias": True, "relu": True}


def _maxpool3(stride: int = 2) -> Dict[str, Any]:
    return {"type": "pooling", "op": "max", "r": 3, "stride": stride,
            "pad": "same"}


def googlenet_specs(num_classes: int, width: int,
                    aux: bool = True) -> List[Dict[str, Any]]:
    c = lambda v: _c(v, width)

    def aux_head():
        # loss1/loss2 branch channel widths from the prototxt, scaled
        return {"type": "aux_head", "classes": num_classes, "weight": 0.3,
                "pool_r": 5, "pool_stride": 3, "conv_k": c(128),
                "fc": c(1024), "dropout": 0.7, "head_init": "zero"}

    def inception(c1, c3r, c3, c5r, c5, pp):
        """One v1 module: 1x1 / 1x1->3x3 / 1x1->5x5 / pool->1x1 concat."""
        return {"type": "branch", "combine": "concat", "paths": [
            [_conv(c(c1), 1)],
            [_conv(c(c3r), 1), _conv(c(c3), 3)],
            [_conv(c(c5r), 1), _conv(c(c5), 5)],
            [_maxpool3(stride=1), _conv(c(pp), 1)],
        ]}

    specs: List[Dict[str, Any]] = [
        _conv(c(64), 7, stride=2), _maxpool3(),
        _conv(c(64), 1), _conv(c(192), 3), _maxpool3(),
        inception(64, 96, 128, 16, 32, 32),      # 3a
        inception(128, 128, 192, 32, 96, 64),    # 3b
        _maxpool3(),
        inception(192, 96, 208, 16, 48, 64),     # 4a
        *([aux_head()] if aux else []),          # loss1 tap (prototxt)
        inception(160, 112, 224, 24, 64, 64),    # 4b
        inception(128, 128, 256, 24, 64, 64),    # 4c
        inception(112, 144, 288, 32, 64, 64),    # 4d
        *([aux_head()] if aux else []),          # loss2 tap
        inception(256, 160, 320, 32, 128, 128),  # 4e
        _maxpool3(),
        inception(256, 160, 320, 32, 128, 128),  # 5a
        inception(384, 192, 384, 48, 128, 128),  # 5b
        {"type": "global_avg_pool"},
        {"type": "dropout", "rate": 0.4},
        {"type": "fc", "k": num_classes, "init": "zero"},
    ]
    return specs


def googlenet(num_classes: int = 1000, width: int = 64, seed: int = 0,
              input_shape: Tuple[int, int, int, int] = (8, 64, 64, 3),
              dtype: str = "float32", aux: bool = True):
    specs = googlenet_specs(num_classes, width, aux=aux)
    init, graph = build_graph(specs, input_shape, dtype=dtype, seed=seed)
    params = {"layers": init,
              "_meta": {"model": "googlenet_v1", "width": width,
                        "n_inception": 9, "aux_heads": len(graph.aux_weights)}}
    return params, make_model_forward(graph)
