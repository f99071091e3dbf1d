"""Model zoo + training engine (the GxM framework analog): the port of
``xsmm_tpu/models``.

Members mirror the reference zoo (samples/deeplearning/gxm/model_zoo):
AlexNet, ResNet {18,34,50}, Inception-v3, GoogLeNet (Inception-v1),
LeNet (mnist) and the CIFAR-10 net; MLEngine drives epoch/minibatch
training on one device or data parallel over a mesh's ranks, with SGD
solver schedules, a CUDA-graph epoch, checkpointing and resume.
``params_from_jax`` / ``state_from_jax`` carry the JAX package's weights
across.
"""

from .engine import MLEngine, SolverConfig, softmax_xent, synthetic_batches
from .resnet import resnet
from .alexnet import alexnet
from .inception import inception_v3
from .googlenet import googlenet
from .toynets import lenet, cifar10net
from .convert import params_from_jax, state_from_jax
