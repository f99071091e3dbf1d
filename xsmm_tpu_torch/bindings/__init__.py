"""Foreign-framework bindings, the port of ``xsmm_tpu/bindings``.

Reference: samples/deeplearning/tf_lstm_ops — a TensorFlow custom op that
routes LSTM cell compute through the library.  Here the host framework is
PyTorch itself (``torch_lstm``).
"""

from .torch_lstm import XsmmLSTM, XsmmLSTMFunction, from_torch_lstm
