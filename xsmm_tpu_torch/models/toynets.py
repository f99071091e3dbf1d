"""LeNet (mnist) and the CIFAR-10 net — the reference zoo's small members:
the port of ``xsmm_tpu/models/toynets.py``.

References:
  samples/deeplearning/gxm/model_zoo/mnist/lenet_train_val.prototxt —
    conv5x5-20/s1, maxpool2/2, conv5x5-50/s1, maxpool2/2, fc500+ReLU,
    fc num_classes (the Caffe LeNet).
  samples/deeplearning/gxm/model_zoo/cifar10/train_val.prototxt —
    conv5x5-32, maxpool3/2, ReLU; conv5x5-32, ReLU, maxpool3/2;
    conv5x5-64, ReLU, avgpool3/2 (the MAX/MAX/AVE pooling sequence and
    all channel/kernel sizes kept); fc64, fc num_classes.  Padding
    semantics deliberately diverge: Caffe pools pad-0 with ceil
    rounding, here 'same' padding gives the identical 16/8/4 output
    sizes through the pooling handle (border windows differ — avg divides
    by the full 3x3 including pad; a model-weight port would need
    retraining, the topology/benchmark role does not).

Both run on the same ConvLayer / Pooling / FC handles as the big zoo
members; they are the quick CPU-trainable members (GxM uses them as the
bring-up nets) and exercise the valid-pad + flatten-fc path the larger
nets don't (LeNet has no global_avg_pool).
"""

from __future__ import annotations

from typing import Tuple

from ..dnn.layers import build_graph, make_model_forward


def lenet(num_classes: int = 10, seed: int = 0,
          input_shape: Tuple[int, int, int, int] = (8, 28, 28, 1),
          dtype: str = "float32"):
    specs = [
        {"type": "conv", "k": 20, "r": 5, "pad": "valid", "bias": True},
        {"type": "pooling", "op": "max", "r": 2, "stride": 2},
        {"type": "conv", "k": 50, "r": 5, "pad": "valid", "bias": True},
        {"type": "pooling", "op": "max", "r": 2, "stride": 2},
        {"type": "fc", "k": 500, "relu": True},
        {"type": "fc", "k": num_classes},
    ]
    init, graph = build_graph(specs, input_shape, dtype=dtype, seed=seed)
    params = {"layers": init, "_meta": {"model": "lenet"}}
    return params, make_model_forward(graph)


def cifar10net(num_classes: int = 10, seed: int = 0,
               input_shape: Tuple[int, int, int, int] = (8, 32, 32, 3),
               dtype: str = "float32"):
    specs = [
        {"type": "conv", "k": 32, "r": 5, "bias": True},
        {"type": "pooling", "op": "max", "r": 3, "stride": 2,
         "pad": "same"},
        {"type": "relu"},
        {"type": "conv", "k": 32, "r": 5, "bias": True, "relu": True},
        {"type": "pooling", "op": "max", "r": 3, "stride": 2,
         "pad": "same"},
        {"type": "conv", "k": 64, "r": 5, "bias": True, "relu": True},
        {"type": "pooling", "op": "avg", "r": 3, "stride": 2,
         "pad": "same"},
        {"type": "fc", "k": 64},
        {"type": "fc", "k": num_classes},
    ]
    init, graph = build_graph(specs, input_shape, dtype=dtype, seed=seed)
    params = {"layers": init, "_meta": {"model": "cifar10net"}}
    return params, make_model_forward(graph)
