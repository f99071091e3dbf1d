"""DNN layers on the card: the share of the card's device time, in the
capture of its activity alone, spent in convolution and matrix-product
kernels (cuDNN's, cuBLAS's, CUTLASS's), in %, classed by name (``CLASS``:
the short names of ``TraceSummary.device_ns``).  The rest is the torch ops
of batch norm, the casts, ReLU and pooling, autograd's sums and copies and
the update.  ``top`` lists the ten longest device operations with their
seconds and the class each was given."""

import re

# A kernel of a conv or a matrix product: cuDNN's and CUTLASS's engines
# (xmma, fprop/dgrad/wgrad, implicit GEMM) and cuDNN's layout and padding
# transforms around them (nhwcAddPaddingKernel, nchwToNhwcKernel), cuBLAS's
# (gemm, nvjet, its split-K reduction).  PyTorch's own kernels (at::native)
# are never.
CLASS = re.compile(r"cudnn|cutlass|cublas|xmma|gemm|nvjet|fprop|dgrad|wgrad"
                   r"|conv|winograd|nhwc\w*padding|nchwtonhwc|nhwctonchw",
                   re.IGNORECASE)
TORCH_OWN = "at::native"


def conv_gemm(name: str) -> bool:
    return TORCH_OWN not in name and bool(CLASS.search(name))


def read(ctx):
    t = ctx.trace
    if t is None or not t.device_ns:
        return None
    total = sum(t.device_ns.values())
    hits = sum(ns for name, ns in t.device_ns.items() if conv_gemm(name))
    top = sorted(t.device_ns.items(), key=lambda kv: -kv[1])[:10]
    return {"value": 100.0 * hits / total, "device_s": total / 1e9,
            "top": [[name, ns / 1e9, "conv_gemm" if conv_gemm(name)
                     else "other"] for name, ns in top]}
