"""ResNet family as a layer graph on the framework's DNN handles: the port
of ``xsmm_tpu/models/resnet.py`` (the same specs, hence the same graph and
initial parameters).

Reference: the GxM model zoo ships AlexNet / ResNet-50 / Inception-v3
prototxt graphs and Engine.cpp builds the layer graph from them
(samples/deeplearning/gxm/src/Engine.cpp:484-665).  Here the graph is a
list of layer specs consumed by dnn/layers.py build_graph, and every
compute node is one of the framework's OWN layer handles: ConvLayer
(dnn/conv.py), FusedBatchNorm (dnn/batchnorm.py), PoolingLayer
(dnn/pooling.py), FullyConnectedLayer (dnn/fullyconnected.py).  Residual
blocks are branch nodes with an Eltwise-add combine — the GxM
Split + Eltwise pattern.

Parameters are nested dicts and lists of tensors and end-to-end training
uses torch.autograd through the handles' forwards; the handles' explicit bwd/upd methods remain
available for layer-level use.  Supports depths 18, 34 (basic blocks) and
50 (bottleneck), NHWC.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ..dnn.layers import build_graph

_CFG = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
}


def _block_spec(kind: str, cin: int, cout: int, stride: int):
    """One residual block as a branch(main, shortcut) Eltwise-add node."""
    if kind == "basic":
        main = [
            {"type": "conv", "k": cout, "r": 3, "stride": stride},
            {"type": "batchnorm", "relu": True},
            {"type": "conv", "k": cout, "r": 3},
            {"type": "batchnorm"},
        ]
        out_c = cout
    else:
        main = [
            {"type": "conv", "k": cout, "r": 1},
            {"type": "batchnorm", "relu": True},
            {"type": "conv", "k": cout, "r": 3, "stride": stride},
            {"type": "batchnorm", "relu": True},
            {"type": "conv", "k": cout * 4, "r": 1},
            {"type": "batchnorm"},
        ]
        out_c = cout * 4
    if stride != 1 or cin != out_c:
        shortcut = [
            {"type": "conv", "k": out_c, "r": 1, "stride": stride},
            {"type": "batchnorm"},
        ]
    else:
        shortcut = []  # identity
    return ({"type": "branch", "paths": [main, shortcut],
             "combine": "add", "relu": True}, out_c)


def resnet_specs(depth: int, num_classes: int, width: int) -> List[Dict]:
    kind, stages = _CFG[depth]
    specs: List[Dict[str, Any]] = [
        {"type": "conv", "k": width, "r": 7, "stride": 2},
        {"type": "batchnorm", "relu": True},
        {"type": "pooling", "op": "max", "r": 3, "stride": 2, "pad": "same"},
    ]
    cin = width
    for si, nblocks in enumerate(stages):
        cout = width * (2 ** si)
        for bi in range(nblocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk, cin = _block_spec(kind, cin, cout, stride)
            specs.append(blk)
    specs += [{"type": "global_avg_pool"},
              {"type": "fc", "k": num_classes}]
    return specs


def resnet(depth: int = 50, num_classes: int = 1000, width: int = 64,
           seed: int = 0, input_shape: Tuple[int, int, int, int] = (8, 32, 32, 3),
           dtype: str = "float32", fuse_conv_bn: bool = False):
    """Build (params, forward).  input_shape is the NOMINAL NHWC shape the
    layer descriptors are declared with (the prototxt analog); the handles'
    forwards are shape-polymorphic, so any batch/size with 3 input channels
    runs.  fuse_conv_bn merges conv->bn pairs into FusedConvBN nodes
    (gxm FusedConvBNXSMM analog)."""
    specs = resnet_specs(depth, num_classes, width)
    init, graph = build_graph(specs, input_shape, dtype=dtype, seed=seed,
                              fuse_conv_bn=fuse_conv_bn)
    params = {"layers": init,
              "_meta": {"model": "resnet", "depth": depth, "width": width}}
    from ..dnn.layers import make_model_forward
    return params, make_model_forward(graph)
