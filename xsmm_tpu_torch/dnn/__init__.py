"""DNN layer handles — the libxsmm_dnn domain, in PyTorch and CUDA.

Ported so far: the descriptors (``types.py``) and the RNN cells, forward
and backward (``rnncell.py``: ``forward``, ``forward_train``,
``backward_from_saved``, ``backward_weight_update``, ``execute`` and
autograd through ``forward``, with the LSTM, GRU and simple-RNN sequence
kernels of ``rnn_seq.py`` in both directions).  Conv, fully-connected,
pooling, batchnorm and quant come in later slices.
"""

from .types import (BnDesc, BnFuse, CellType, ConvDesc, FCDesc, Format,
                    FuseOp, Kind, PoolingDesc, PoolType, RnnDesc)
from .rnncell import RnnCell, create_rnncell, rnn_params_from_numpy
