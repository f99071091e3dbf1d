"""The 95th percentile (nearest rank) over all steps of the window, each
from its dispatch lookup through its synchronize, in ms."""

import math


def read(ctx):
    steps = sorted(ctx.step_ns)
    return steps[math.ceil(0.95 * len(steps)) - 1] / 1e6
