"""DNN layer handles — the libxsmm_dnn domain, in PyTorch and CUDA.

Layer handles are stateless and functional: create from a descriptor, then
execute(kind) / forward / backward / weight_update.  See types.py for the
layout policy (NHWC/HWIO native; NCHW/KCRS converted at the boundary).
The names are the JAX package's: conv, fully connected, pooling (with the
max-pool window backward kernel, ``pooling.maxpool2x2_bwd``), fused
batchnorm, the RNN cells (with the sequence kernels of ``rnn_seq.py``) and
quant.  ``dnn_params_from_numpy`` and ``rnn_params_from_numpy`` carry the
JAX package's parameters across.
"""

from .types import (BnDesc, BnFuse, CellType, ConvDesc, FCDesc, Format,
                    FuseOp, Kind, PoolingDesc, PoolType, RnnDesc)
from .conv import ConvLayer, create_conv_layer
from .fullyconnected import FullyConnectedLayer, create_fullyconnected_layer
from .pooling import PoolingLayer, create_pooling_layer
from .batchnorm import BnRunning, FusedBatchNorm, create_fusedbatchnorm
from .rnncell import RnnCell, create_rnncell, rnn_params_from_numpy
from .quant import (RoundMode, dequantize, quantize, quantize_act,
                    quantize_fil)
from .operands import dnn_params_from_numpy
