"""DNN descriptors, fusion flags, and tensor formats.

The port's own copy of ``xsmm_tpu/dnn/types.py`` (which imports no JAX):
the same enums with the same values and the same frozen dataclasses with
the same fields and defaults, so that one ``RnnDesc(...)`` argument list
drives both packages.

Reference: include/libxsmm_dnn.h:298-331 (conv desc), :265-287 (fuse ops),
libxsmm_typedefs.h:314-326 (tensor formats), include/libxsmm_dnn_*.h for
fully-connected / pooling / fusedbatchnorm / rnncell descriptors.  The
activation format is NHWC and the filter format HWIO (RSCK), as in the JAX
package; NCHW/KCRS inputs are converted at the boundary.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Kind(enum.Enum):
    """Execution kinds (libxsmm_dnn_compute_kind)."""

    FWD = "fwd"
    BWD = "bwd"   # data gradient
    UPD = "upd"   # weight gradient


class Format(enum.IntFlag):
    """Tensor formats (libxsmm_typedefs.h:314-326)."""

    LIBXSMM = 1   # blocked; mapped to NHWC on TPU (layout is XLA's job)
    NHWC = 2
    NCHW = 4
    RSCK = 8      # HWIO
    KCRS = 16     # OIHW


class FuseOp(enum.IntFlag):
    """Conv/FC fusion flags (libxsmm_dnn.h:265-287).

    Full reference set: BIAS / RELU_FWD / RELU_BWD / BATCH_STATS_FWD /
    MAX_STATS / BATCH_STATS_BWD / ELTWISE_BWD / BATCHNORM_STATS (+combos).
    Semantics on TPU (all are XLA-fused epilogues of the conv pass):
      BATCH_STATS_FWD   fwd also returns per-channel (sum y, sum y^2)
      BATCHNORM_STATS   fwd also returns per-channel (mean, var) of y
      MAX_STATS         fwd stats include per-channel max|y|; with
                        RELU_BWD, bwd stats include max|dx|
      BATCH_STATS_BWD   bwd also returns (sum dy, sum dy*y) — the fused
                        BN-backward reductions (dbeta / dgamma inputs)
      ELTWISE_BWD       bwd also returns the residual-input gradient of a
                        fused eltwise add (= relu-masked dy)
    """

    NONE = 0
    BIAS = 1
    RELU = 2
    BIAS_RELU = 3
    BATCH_STATS_FWD = 4
    RELU_BWD = 8
    MAX_STATS = 16
    BATCH_STATS_BWD = 32
    ELTWISE_BWD = 64
    BATCHNORM_STATS = 128


class BnFuse(enum.IntFlag):
    """Fused-batchnorm ops (libxsmm_typedefs.h:378-391)."""

    BN = 0
    ELTWISE = 1   # add residual input
    RELU = 2
    ELTWISE_RELU = 3


class PoolType(enum.Enum):
    MAX = "max"
    AVG = "avg"


class CellType(enum.Enum):
    """RNN cell types (libxsmm_dnn_rnncell.h:40-50)."""

    RNN_RELU = "rnn_relu"
    RNN_SIGMOID = "rnn_sigmoid"
    RNN_TANH = "rnn_tanh"
    LSTM = "lstm"
    GRU = "gru"


@dataclasses.dataclass(frozen=True)
class ConvDesc:
    """libxsmm_dnn_conv_desc analog (libxsmm_dnn.h:298-331)."""

    n: int
    c: int
    h: int
    w: int
    k: int
    r: int
    s: int
    u: int = 1            # stride h
    v: int = 1            # stride w
    pad_h: int = 0
    pad_w: int = 0
    in_dtype: str = "float32"
    out_dtype: str = "float32"
    buffer_format: Format = Format.NHWC
    filter_format: Format = Format.RSCK
    fuse_ops: FuseOp = FuseOp.NONE

    @property
    def out_h(self) -> int:
        return (self.h + 2 * self.pad_h - self.r) // self.u + 1

    @property
    def out_w(self) -> int:
        return (self.w + 2 * self.pad_w - self.s) // self.v + 1


@dataclasses.dataclass(frozen=True)
class FCDesc:
    """libxsmm_dnn_fullyconnected_desc analog (K=out, C=in, N=batch)."""

    n: int
    c: int
    k: int
    in_dtype: str = "float32"
    out_dtype: str = "float32"
    fuse_ops: FuseOp = FuseOp.NONE
    # block sizes bn/bk/bc kept for API parity; blocking is XLA's job
    bn: int = 0
    bk: int = 0
    bc: int = 0


@dataclasses.dataclass(frozen=True)
class PoolingDesc:
    """libxsmm_dnn_pooling_desc analog."""

    n: int
    c: int
    h: int
    w: int
    r: int
    s: int
    u: int = 1
    v: int = 1
    pad_h: int = 0
    pad_w: int = 0
    pool_type: PoolType = PoolType.MAX
    dtype: str = "float32"

    @property
    def out_h(self) -> int:
        return (self.h + 2 * self.pad_h - self.r) // self.u + 1

    @property
    def out_w(self) -> int:
        return (self.w + 2 * self.pad_w - self.s) // self.v + 1


@dataclasses.dataclass(frozen=True)
class BnDesc:
    """libxsmm_dnn_fusedbatchnorm_desc analog."""

    n: int
    c: int
    h: int
    w: int
    eps: float = 1e-5
    fuse: BnFuse = BnFuse.BN
    dtype: str = "float32"
    # global-stats momentum factor (FusedBNorm.hpp mmf_; gxm model
    # prototxts use 0.9): running sums decay by mmf per train step
    mmf: float = 0.9


@dataclasses.dataclass(frozen=True)
class RnnDesc:
    """libxsmm_dnn_rnncell_desc analog (libxsmm_dnn_rnncell.h:53-67)."""

    n: int          # minibatch
    c: int          # input features
    k: int          # hidden features
    max_t: int      # sequence length
    cell_type: CellType = CellType.LSTM
    in_dtype: str = "float32"
    out_dtype: str = "float32"
    # bn/bk/bc block sizes: parity only
    bn: int = 0
    bk: int = 0
    bc: int = 0
