"""Device, training cells: the model FLOPs of the traced steps
(``roofline_resnet.py``, counted from the architecture's layer table) over
the card's busy time in their capture, as a share of the card's dense BF16
peak (989.4 TFLOP/s on the H100 SXM), in %.  Over busy time and not the
window's, it reads how well the step's device work uses the card, apart
from the time the card waits on the host (``device_idle_share``).  Nothing
to read without a card."""

import torch

from .. import roofline_resnet


def read(ctx):
    t = ctx.trace
    if not ctx.peaks or t is None or not t.busy_ns or not ctx.trace_calls:
        return None
    peak = roofline_resnet.bf16_peak(torch.cuda.get_device_name(0))
    flops_per_s = ctx.trace_calls * ctx.ops_per_call / (t.busy_ns * 1e-9)
    return 100.0 * flops_per_s / peak
