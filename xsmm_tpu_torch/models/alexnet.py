"""AlexNet (GxM model zoo member) as a layer graph on the DNN handles.
The port of ``xsmm_tpu/models/alexnet.py``: the same specs.

Reference: samples/deeplearning/gxm/model_zoo AlexNet prototxt; the graph
is built by dnn/layers.py build_graph and every compute node is a
framework layer handle (ConvLayer / PoolingLayer / FullyConnectedLayer
with BIAS+RELU fused epilogues).  Dropout after fc6/fc7 matches the GxM
Dropout nodes (train-mode only; pass rng to forward).
"""

from __future__ import annotations

from typing import Tuple

from ..dnn.layers import build_graph


def alexnet_specs(num_classes: int):
    return [
        {"type": "conv", "k": 64, "r": 11, "stride": 4, "bias": True,
         "relu": True},
        {"type": "pooling", "op": "max", "r": 3, "stride": 2,
         "pad": "valid"},
        {"type": "conv", "k": 192, "r": 5, "bias": True, "relu": True},
        {"type": "pooling", "op": "max", "r": 3, "stride": 2,
         "pad": "valid"},
        {"type": "conv", "k": 384, "r": 3, "bias": True, "relu": True},
        {"type": "conv", "k": 256, "r": 3, "bias": True, "relu": True},
        {"type": "conv", "k": 256, "r": 3, "bias": True, "relu": True},
        {"type": "global_avg_pool"},
        {"type": "fc", "k": 4096, "relu": True},
        {"type": "dropout", "rate": 0.5},
        {"type": "fc", "k": 4096, "relu": True},
        {"type": "dropout", "rate": 0.5},
        {"type": "fc", "k": num_classes},
    ]


def alexnet(num_classes: int = 1000, seed: int = 0,
            input_shape: Tuple[int, int, int, int] = (8, 64, 64, 3),
            dtype: str = "float32"):
    init, graph = build_graph(alexnet_specs(num_classes), input_shape,
                              dtype=dtype, seed=seed)
    params = {"layers": init, "_meta": {"model": "alexnet"}}
    from ..dnn.layers import make_model_forward
    return params, make_model_forward(graph)
