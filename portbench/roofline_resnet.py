"""Model FLOPs, bytes and peak of the ResNet-50 training cell, counted from
the architecture's published layer table, not from the program's specs.

He, Zhang, Ren, Sun, "Deep Residual Learning for Image Recognition", CVPR
2016, table 1, 50-layer column: a 7x7/2 conv, a 3x3/2 max pool, four
stages of (3, 4, 6, 3) bottlenecks [1x1, 3x3, 1x1 (x4)] at widths 64, 128,
256, 512, a global average pool and an FC to the classes.  Version 1.5
(torchvision's ``resnet50``, MLPerf Training's ResNet-50) puts a stage's
stride on its first block's 3x3 conv, so that block's first 1x1 conv runs
at the previous stage's resolution; the projection shortcut (1x1, the
stage's stride) opens each stage.

Model FLOPs are those of the convolutions and the FC: 2 a multiply-add,
once in the forward, once for the data gradient (not for the first conv,
whose input needs none) and once for the weight gradient.  Batch norm,
ReLU, pooling, the residual adds, the loss and the update count nothing,
as in MLPerf's and the usual MFU accounting.
"""

from __future__ import annotations

from typing import List, Tuple

STAGES = (3, 4, 6, 3)   # bottlenecks a stage (table 1, 50-layer)
EXPANSION = 4           # a bottleneck's output width over its own
F32_BYTES = 4
LABEL_BYTES = 8         # int64

# Dense BF16 tensor-core peak of one card (NVIDIA's data sheet, SXM part,
# without sparsity, at the full power limit of 700 W), FLOP/s.
BF16_PEAK = {"NVIDIA H100 80GB HBM3": 989.4e12}


def _out(size: int, r: int, stride: int) -> int:
    """Output size of an r x r window at ``stride`` with (r - 1) // 2 of
    padding on each side (the paper's 7x7/2 pad 3, 3x3 pad 1, 1x1 pad 0)."""
    pad = (r - 1) // 2
    return (size + 2 * pad - r) // stride + 1


def convs(width: int = 64, image: int = 224) -> List[Tuple[str, int, int,
                                                          int, int]]:
    """Every conv as (name, cin, cout, r, output size), in table order."""
    out = []
    size = _out(image, 7, 2)
    out.append(("conv1", 3, width, 7, size))
    size = _out(size, 3, 2)                       # max pool
    cin = width
    for si, blocks in enumerate(STAGES):
        w = width * 2 ** si
        for bi in range(blocks):
            stride = 2 if si > 0 and bi == 0 else 1
            small = _out(size, 3, stride)
            name = f"conv{si + 2}_{bi + 1}"
            out.append((name + "a", cin, w, 1, size))
            out.append((name + "b", w, w, 3, small))
            out.append((name + "c", w, EXPANSION * w, 1, small))
            if stride != 1 or cin != EXPANSION * w:
                out.append((name + "proj", cin, EXPANSION * w, 1, small))
            cin, size = EXPANSION * w, small
    return out


def forward_macs(width: int = 64, image: int = 224,
                 classes: int = 1000) -> Tuple[int, int]:
    """(multiply-adds of one image's forward, those of the first conv)."""
    cs = convs(width, image)
    conv = sum(s * s * cout * cin * r * r for _, cin, cout, r, s in cs)
    first = cs[0]
    fc = EXPANSION * width * 2 ** (len(STAGES) - 1) * classes
    return conv + fc, first[4] ** 2 * first[2] * first[1] * first[3] ** 2


def parameters(width: int = 64, classes: int = 1000) -> int:
    """Trainable parameters: conv filters, BN's scale and shift a channel,
    the FC's weight and bias."""
    cs = convs(width, 64)
    filters = sum(cin * cout * r * r for _, cin, cout, r, _ in cs)
    channels = sum(cout for _, _, cout, _, _ in cs)
    feats = EXPANSION * width * 2 ** (len(STAGES) - 1)
    return filters + 2 * channels + feats * classes + classes


def step(config: dict) -> Tuple[float, float]:
    """(model FLOPs, bytes) of one training step at the configuration's
    batch: 6 FLOPs a multiply-add, less 2 for the first conv's data
    gradient; the batch read once, and the parameters, gradients and
    momentum (f32) each read and written once."""
    width, image = int(config["width"]), int(config["image"])
    classes, batch = int(config["classes"]), int(config["batch"])
    macs, first = forward_macs(width, image, classes)
    flops = float(batch * (6 * macs - 2 * first))
    data = batch * (image * image * 3 * F32_BYTES + LABEL_BYTES)
    state = 3 * 2 * parameters(width, classes) * F32_BYTES
    return flops, float(data + state)


def bf16_peak(card: str) -> float:
    """The card's dense BF16 peak, FLOP/s; ``KeyError`` for another card."""
    try:
        return BF16_PEAK[card]
    except KeyError:
        raise KeyError(f"no BF16 peak for card {card!r}; known: "
                       f"{sorted(BF16_PEAK)}") from None
