#!/usr/bin/env python3
"""Drive xsmm_tpu_torch's main path on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py [--batch 131072] [--sparse-n 65536]
                          [--sparse-big 1048576] [--gemm-size 4096]
                          [--copy-size 8192] [--packed-batch 131072]
                          [--packed-big-m 125] [--packed-big-batch 4096]
                          [--rnn-shape 128,512,512,32] [--dnn-batch 64]
                          [--seed 0]

Run from the repository root, on a machine with a CUDA card and nvcc.  It:

1. prints the card (name, count, power limit);
2. builds the CUDA kernels from the sources in the checkout (one nvcc per
   source, all started together) and prints the build time, what ptxas
   says of each kernel and the tiled GEMM's HGMMA (wgmma) instruction count
   from ``cuobjdump -sass`` (none fails the run);
3. drives the main path through the user entry points at batch 131072, 23^3
   (``dmmdispatch`` under split2_fast, split2 and float32, beta 0 and 1;
   ``smmdispatch`` beta 0 and 1; ``bsmmdispatch``; ``bmmdispatch``), with the
   launch counts set to 0 just before and read just after (every f32 plane
   staged by TMA, the bf16 cases on the first design, the ``smmdispatch``
   calls on the natural kernel with bulk copies), and checks each result
   against numpy f64 gold on a 4096-problem subset;
4. compares each kernel with its plain version on the same packed operands
   (the natural calls on their batch-first operands, and with the pack
   route, kernel 2), and each schedule and the natural kernel once on the
   cp.async staging (operands one element off their alignment, Bp 4097),
   bit for bit;
5. runs the non-kernel routes once each (f32 product at 256^3 without TF32,
   native f64, int16, batch-reduce);
6. times the four kernels, their plain versions and ``torch.bmm`` on the
   same problems with CUDA events (each kernel in turns with ``torch.bmm``:
   kernel, library, library, kernel), beside the bound of the card, and the
   whole entry-point call (f64 split2_fast, and f32); and at the edge of
   the natural route, f32 28^3 (the natural kernel) and 32^3 (the pack
   route), the call's kernel counted and both routes timed in turns, the
   natural route required to be the faster at 28^3;
7. drives the sparse path through its entry points at N = 65536 on the
   three PyFR-shaped operators of ``samples/pyfr_driver.py`` (seed 0):
   ``create_dcsr_reg`` under each f64 schedule, beta 0 and ``acc_fn``;
   ``create_csr_soa`` f32, beta 0 and ``acc_fn``; ``create_csc_soa``;
   ``dfsspmdm_create`` / ``sfsspmdm_create``; the dense strategy; and
   ``spmdm_init`` dense and ell — with the sparse launch counts and their
   route counts (staging and structure) set to 0 just before and read just
   after, each result held against numpy f64 gold;
8. compares each sparse kernel with its plain version on the same operands,
   and on the 150x150 operator once on every route forced (tma, cp_async,
   unstaged x shared, global) and at N - 3 on the cp.async ring, bit for
   bit, each launch counted on its route; then times the
   four kernels (f64 under split2 and fold) at N = 65536 and 1048576
   beside their bounds,
   routes, the plain versions, ``torch.sparse.mm`` / ``torch.addmm`` on a
   CSR tensor and ``torch.matmul`` of the densified operator, with the line
   through the two N's (a fixed cost a call and a stream rate) and the
   wrapper's host time a call at N = 65536, and the whole
   ``create_dcsr_reg(op, 65536)(b)`` call step by step;
10. drives the dense path through its entry points, with the tiled-GEMM
    and xcopy launch counts set to 0 just before and read just after:
    ``xgemm`` at 4096^3 bf16 and f32, ``gemm_handle`` bf16 -> f32, ``xgemm``
    with ``c0``, the ragged 4095 x 4097 x 1000 (f32 and bf16) and the four
    DeepBench shapes of ``samples/xgemm_driver.py`` in bf16; ``matcopy``,
    ``otrans`` and ``itrans`` at 8192^2 f32, ``otrans`` at the ragged
    8448 x 8320, of f64 and of bf16, a batched ``matcopy``; each non-kernel
    route of ``ops/xcopy.py`` once (they must launch nothing); the blocked
    GEMM at 2048^3 bf16 with blocks of 256 and an f64 handle;
    ``gemm_batch`` and a ``torch.matmul`` rerouted by
    ``mmbatch_begin(record_only=False)``, contiguous f32 at 23^3, whose
    launches show that each reached the natural kernel once and kernel 2
    not at all; each result against gold (f64
    products on the card, or bit for bit for the copies);
11. compares the three dense kernels with their plain versions on the same
    inputs (GEMMs to f32 rounding, copies bit for bit), the tiled GEMM on
    the route it picks and, where that is the TMA + wgmma route, on the
    cp.async + mma.sync route forced through the route argument (the main
    path launches every route: TMA, mma.sync for the ragged 4097-column B,
    SIMT for f32);
12. times them beside their bounds, their plain versions and the library
    call (``torch.matmul`` without TF32, ``clone``,
    ``Tensor.t().contiguous()``): the two 16-bit GEMM routes in turns at
    4096^3 bf16, the DeepBench shapes on both, the copies in turns with
    ``clone`` (kernel, library, library, kernel); and the whole ``xgemm``
    call at 4096^3 bf16 with tensors on the card;
14. drives the packed-LA path through its entry points, with the packed
    launch counts set to 0 just before and read just after each call (each
    must launch its one kernel): ``getrf_dispatch`` 16x16 at batch 131072
    in f32 and f64 (numpy in and out), 12x8 and 8x12; ``trsm_dispatch``
    16/16 in the six variants of ``tests/test_packed.py`` (the four that
    reduce to an upper left solve launch the upper variant) and with alpha 2;
    the f64 trsm under refine None, "host" and False; getrf and trsm at
    125 (the element block of a p = 4 hexahedron) and batch 4096, which
    take the loop kernels (getrf on its "tile" route), and getrf at 140,
    which takes the loop kernel's "shared" route (each route must be
    launched); ``trmm_dispatch`` f32 and f64 and
    ``pgemm_dispatch`` 16^3, which reach the natural kernel (f32) and
    kernel 1 (f64);
    each result against f64 gold on the card (L U against A, op(A) X
    against alpha B, the refine gates of ``tests/test_packed.py``);
15. compares the four packed-LA kernels with their plain versions on the
    same packed operands, bit for bit (tolerance 0);
16. times them beside their bounds, their plain versions and the library
    call on the same problems in [B, M, N] (``torch.linalg.lu_factor_ex``
    without pivoting, ``torch.linalg.solve_triangular``; the loop getrf
    and the loop trsm in turns with theirs (kernel, library, library,
    kernel), and the trsm's unit-diagonal solve), and the whole
    ``getrf_dispatch(16, 16, batch=131072)(a)`` call with a tensor on the
    card and with numpy f64 step by step; then block-Jacobi's solves at
    ``--packed-big-m`` (125) with one column, B = ``--packed-batch``: one
    packed LU, the unit-lower solve and the upper variant on it through
    ``trsm_dispatch(...).packed`` (each must launch its one kernel), bit
    for bit their plain versions, and timed in turns (lower, upper, upper,
    lower) beside their bounds;
18. drives the RNN forward path through its entry points
    (``create_rnncell(RnnDesc(...))`` then ``forward`` and
    ``forward_train``) at N, C, K, T = 128, 512, 512, 32, the shape of
    ``samples/lstm_driver.py:30``: LSTM, GRU and RNN_TANH in f32 and bf16;
    RNN_RELU and RNN_SIGMOID at T = 8; the ragged N 100, C 200, K 300, T 5
    and T = 1; with the RNN launch counts and the scan route's count set to
    0 just before each call and read just after (each call must launch its
    one kernel, forward_train its train form, and the scan route 0 times);
    each result, the train residuals too, against numpy f64 gold (1e-3 f32,
    5e-2 bf16), and hs against ``torch.nn.LSTM``/``GRU``/``RNN`` (cuDNN,
    TF32 off) given the same weights, outside the path;
19. compares the three RNN kernels, in both forms, with their plain
    versions on the same zx, R, h0 and c0 (1e-5 with f32 R, 1e-3 with bf16
    R; bit-exactness reported when reached);
20. prints each forward kernel's launch plan at the full shape (blocks,
    SMs, its form; every form runs the product on FFMA), and
    times them beside their bounds (and per step), their plain versions,
    the whole ``forward`` call with tensors on the card and the cuDNN
    forward at the same shape, in f32 and bf16, with the FLOP rate
    2*T*N*(C+K)*G*K of the whole forward beside cuDNN's;
21. drives the RNN training path through its entry points at the same
    shapes, with the forward and backward launch counts and both scan
    routes' counts set to 0 just before each call and read just after
    (each call must launch its one backward kernel, and the scan routes 0
    times): ``forward_train`` then ``backward_from_saved``,
    ``backward_weight_update``, ``execute(Kind.BWD)`` and autograd through
    ``forward`` for LSTM, GRU and RNN_TANH in f32 and bf16;
    ``backward_from_saved`` for RNN_RELU and RNN_SIGMOID at T = 8, for
    every cell at the ragged N 100 C 200 K 300 T 5 with numpy inputs, and
    at T = 1; ``XsmmLSTM`` with ``loss.backward()``; every gradient (dx,
    dw, dr, db, dh0, dc0) against torch autograd through a plain f64 loop
    of the recurrence written here (1e-3 f32, 5e-2 bf16), and, outside the
    path, against cuDNN's ``torch.nn.LSTM``/``GRU``/``RNN`` backward (TF32
    off) given the same weights; and the RNN_TANH forward at N 37, C 50,
    K 70, T 4 a thousand times (hs and x@W bit for bit, card vs CPU);
22. compares the three backward kernels with their plain versions on the
    same residuals (1e-5 with f32 R; with bf16 R every output bit for bit,
    the gate 1e-3 besides);
23. times them beside their bounds (and per step), their plain versions,
    the whole ``backward_from_saved``, ``backward_weight_update`` and
    training step (``forward_train`` + ``backward_from_saved``) and its
    split, and cuDNN's backward and forward + backward at the same shape,
    with the rate 3*2*T*N*(C+K)*G*K of ``samples/lstm_driver.py:42-47``;
24. drives the DNN layer handles through their entry points, with the
    window kernel's launch count set to 0 just before each call and read
    just after (each ``pallas_window`` backward must launch it once, every
    other call never), and cuDNN's TF32 switched on by the caller (each
    call must leave it so): pooling, max and avg, forward and backward, at
    N64 C256 H56 W56 2x2/s2 (``samples/layer_driver.py:53``) in f32 and
    bf16 on both routes (``XSMM_POOL_WINDOW_KERNEL`` unset and 1), x of
    values rounded to 0.5 so that windows hold ties, every output against
    numpy gold bit for bit; FC at N1024 C4096 K4096 (``layer_driver.py:35``)
    with BIAS|RELU, FWD, BWD and UPD, f32 and bf16; fused BN at N64 C256
    H56 W56 with RELU and with ELTWISE_RELU, forward, backward,
    ``update_running`` and ``forward_eval``, f32 and bf16; conv at N32 C64
    H56 W56 K64 3x3 s1 p1 (``samples/cnnlayer_driver.py:26``, the fold's
    route) and K128 3x3 s2 p1, f32 and bf16, FWD, BWD, UPD, autograd
    through ``forward`` and every fusion; one stage-shaped training step
    (conv 1x1 C64->K256 with BATCH_STATS_FWD, ``forward_from_moments``
    with RELU, max pool 2x2/s2; then the window kernel, BN backward, conv
    BWD and UPD), each stage against f64 gold from its own inputs; quant
    on a 64x256x56x56 f32 tensor in all five modes, round-tripped through
    ``dequantize``; everything else against f64 gold on the card (FC and
    conv 1e-5 in f32, which TF32 would miss, a conv's weight gradient
    1e-4, 1e-2 in bf16; BN at the gates of ``tests/test_dnn.py``: 1e-3,
    dx 1e-2);
25. compares the window kernel with its plain version, bit for bit, on the
    tied pooling input and on the stage's activations;
26. times the window kernel beside its bound, its plain version and the
    ``vjp`` route (``F.max_pool2d`` forward and autograd backward on
    channels-last), the whole ``backward`` call on each route, the other
    layers' whole calls with GB/s or TFLOP/s (the models of
    ``layer_driver.py:11-18``), the space-to-depth fold against the direct
    cuDNN conv at K64 in turns, the stage step and its split, and quant;
28. checks that the registry's index is the native CRC32C table (built from
    ``native/{registry,mtx,spmdm}.cpp`` with g++; its build time is printed
    after the CUDA build) and that the main path's six dispatches, with the
    front memo and the MRU cache dropped, are answered by it;
29. measures the link's pinned rates (one 555 MB ``copy_`` each way);
30. times the three whole f64 calls with numpy in and out through the
    pinned staging pool -- batched 23^3 at B 131072 under split2_fast,
    ``create_dcsr_reg(150x150, N)(b)`` and ``getrf_dispatch(16, 16,
    batch=131072)`` -- first call, then five more, each in turns with the
    same steps written out (copy in, split, pack, kernel, unpack/join, copy
    out) through the pool and on pageable memory (the parent's path), step
    by step beside the link bound (bytes over the measured pinned rates,
    plus the kernel); it checks that each output is bit-identical to the
    pageable steps', that the pool allocates its staging buffers on the
    first call only and at most ``RESULT_BLOCKS`` pinned result blocks,
    that a held result is unchanged after three calls on other data, that
    overwriting the inputs right after a call leaves its result as it was,
    and each result against gold; it also times the loop ``c = call(a,
    b)``, each call made while the previous result is held;
31. times kernel 1 with ``utils/timer.device_bench`` (CUDA graphs)
    beside ``cuda_time_ms``, runs ``python -m xsmm_tpu_torch.bench`` once
    and prints its JSON line, and records one ``trace_region`` around a
    batched call, checking that its ``kernel_name`` range and the kernel's
    launch are in the Chrome trace, and the host time a call of the sparse
    entry point ``acc_fn``, with and without its trace scope, beside its
    kernel wrapper's, with tracing off;
32. trains one step of ResNet-18 (width 64, 100 classes, 8x64x64, f32,
    a ``template_batches`` batch) through ``MLEngine`` on the card and with
    ``target="cpu"`` (``models/fault3_stress.step``), the card's step three
    times on cuDNN's default algorithms and once on its deterministic ones,
    each under ``torch.profiler``, the CPU's twice: each card step against
    the CPU's within 1e-5 relative on the loss, 1e-3 rel-Frobenius on each
    parameter's update and 1e-4 on the BN running state, and each side's
    repeats against its first; the worst leaf by name, and a log of every
    step (its worst leaf, the kernels cuDNN ran for each convolution,
    forward and backward, the cuDNN state and the host's precision facts)
    in ``chiprun_out/step32.log``, printed on a failure;
33. trains ResNet-50 at its published width (64, 1000 classes) at batch
    64, 224x224, in f32 and bf16, each in the compiled form (the card's
    default: each step a CUDA graph replayed) and in the eager one
    (``compiled=False``) from the same parameters: 2 warm-up and 10 timed
    steps of ``train_epoch`` on ``synthetic_batches``, a ``validate``
    pass, and prints images/s (training, inference), ms a step, the
    model-FLOPs share (3 x the forward's conv and FC operations from the
    graph's descriptors over the step time and the card's f32 or bf16
    peak), the peak memory, the device's idle share in a profiled step,
    the two forms' steps side by side and a ``torch.profiler`` split of
    one eager step (conv, BN, pooling, FC, eltwise, loss, update; forward
    and backward); every loss finite, every parameter moved;
34. runs ``CONVERGENCE_r05.json``'s protocol (resnet18/width16, batch 256,
    100 classes, 32x32, poly lr 0.02, sigma 1.5, 8 epochs of 20 host
    ``template_batches``) in f32 and bf16 with the sample's criterion (last
    loss < 0.6 x the first, val top-1 >= 3/100), then ``train_epoch_scan``
    (the CUDA-graph epoch) against two eager loops from the same state and
    data generator: two LeNet epochs on cuDNN's deterministic algorithms
    (the losses step by step bit for bit), then on cuDNN's default ones
    two LeNet epochs and 6 steps of ResNet-50 as step 33 (the README's
    ``train_epoch_scan``) in f32 and bf16, where eager against eager is
    the run-to-run spread and the graph against eager is held to
    ``SCAN_DEFAULT_TOL``;
35. runs ``DATAPIPE_r05.json``'s protocol: a PPM corpus of 120 + 24
    images a class written under ``xsmm_tpu_torch/build/datapipe``,
    ``ingest_image_dir``, the native ``DataLoader`` feeding the card,
    ``make_augment`` on the card and cifar10net at batch 128 for 30
    epochs, with the sample's criterion, the loader backend (native) and
    images/s from disk to the trained step; then runs the benchmark cell
    ``resnet50_train.bf16_b256`` through its driver for 4 steps at its
    batch (``MLEngine.train_step`` replaying the step's CUDA graph) and
    fails unless every step after the capture replayed and its kept
    outputs meet the cell's limits against the f32 reference;
36. drives the distributed layer's ring on one card, its d ranks virtual
    ranks on ``cuda:0`` (each with its own compute and communication
    streams; the cards round robin where there are more):
    ``ring_spmm_csr`` on the 150x150 PyFR operator at N = 65536, d = 1, 2
    and 4, chunks 1 and 4, f32 and f64 under split2 and fold, each against
    numpy f64 gold (1e-3 f32, 1e-5 f64), with the sparse launch counts and
    the hop counts set to 0 just before and read just after; every block
    kernel of those calls against its plain version on the ring's panels,
    bit for bit; the ms of each call beside the local kernel's on the whole
    B (virtual ranks share the SMs: the machinery's cost, not scaling),
    each call's default callable (compiled: one CUDA graph a key) against
    its ``compiled=False`` form, bit for bit, with ``forms`` and the ms of
    the eager call, of the compiled calls (copying the caller's shards in,
    or on the graph's own inputs) and of the replay alone (the copies
    apart); and ``parallel/schedule_check`` on a profiler trace of the
    eager form at d = 4, chunks 4 (the share of hops under compute of
    another sub-panel, the event order, the live panel images, whether the
    hops ran as copies) and on a trace of the entry point's own replay
    (the copies that overlap a kernel; the step fails if none does);
37. drives ``dp_batched_smm`` at 23^3, B = 131072 over 4 ranks (split2_fast,
    float32, split2) and ``dp_packed`` getrf and trsm at 16^2, B = 131072
    and at 125^2, B = 4096, over 4 ranks, counted, each against gold and
    each rank's kernel against its plain version on its own shard; then
    ``ring_spmm`` and ``col_sharded_spmm`` on the densified 150x150
    operator at N = 65536 over 4 ranks against gold; every one of these
    builders' default callables against its ``compiled=False`` form as in
    step 36, the dp calls beside one call on the whole batch;
38. holds cross-replica BN over 2 replicas against the global batch's BN at
    N64 C256 H56 W56 (y, dx, dgamma, dbeta at 1e-5), then trains ResNet-50
    at width 64, batch 64, 224^2, f32 through ``MLEngine`` over a dp = 2
    mesh for 3 steps: the first against the single-device engine's step on
    the same batch, on cuDNN's deterministic algorithms (the loss at the
    step-32 gate, the whole update at ``DIST_UPDATE_TOL``, which two
    planted faults must exceed; the worst leaf, the BN state, the second
    step's loss and the one-device step with its input one ulp up
    printed) and on its default ones beside two single-device steps'
    spread, the other two timed beside step 33's in the compiled and the
    eager forms, with the peak memory, each profiled step's idle share and
    the eager step's split; before it, ResNet-18 width 8 at batch 8,
    16^2, over dp = 2 on the deterministic algorithms at every step-32
    gate;
39. runs ``entry.dryrun_multichip(4)`` and ``entry.entry()`` on the card,
    and ``parallel.multihost.launch_dryrun(2, 2)``: two processes of two
    ranks sharing the card over gloo (every cross-process transfer staged
    through host memory), each printing its line;
40. prints one ``{"kernels": [...]}`` JSON line (all twenty-two kernels;
    every wrapper's launch counts, set to 0 before steps 32-35, are still 0
    after them; the rows of kernels 1-3, 5-8 and 11-14 carry the
    distributed steps' launches as ``dist_launches``), the nvidia-smi
    line, and as its last line ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero without the last line; it
also exits non-zero when ``torch.cuda.is_available()`` is false.  It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from xsmm_tpu_torch.core.platform import H100, PEAKS

M = N = K = 23
GOLD_SUBSET = 4096

# H100 SXM peaks (the card's power limit is printed beside every number)
HBM_BYTES_PER_S = PEAKS[H100]["hbm_bytes_per_s"]
FP32_FLOP_PER_S = PEAKS[H100]["f32_flop_per_s"]

SOURCE = "xsmm_tpu_torch/ops/csrc/smm_packed.cu"
REPLACES = {
    "packed_split2_fast": "xsmm_tpu/ops/smm.py:296",
    "packed_f32": "xsmm_tpu/ops/smm.py:193",
    "packed_split2": "xsmm_tpu/ops/smm.py:251",
    # no TPU kernel: BatchedSMM.pack_a / pack_b / unpack_c fused with the
    # schedule of xsmm_tpu/ops/smm.py:193
    "natural_f32": "none (fuses the pack into xsmm_tpu/ops/smm.py:193)",
}

SPARSE_SOURCE = "xsmm_tpu_torch/ops/csrc/spgemm.cu"
SPARSE_REPLACES = {
    "spgemm_unroll_f32": "xsmm_tpu/ops/spgemm.py:195",
    "spgemm_unroll_f64": "xsmm_tpu/ops/spgemm.py:233",
    "spgemm_acc_f32": "xsmm_tpu/ops/spgemm.py:322",
    "spgemm_acc_f64": "xsmm_tpu/ops/spgemm.py:363",
}
# (M, K, density) of the PyFR-shaped operators, samples/pyfr_driver.py:23-30
PYFR_SPECS = [(105, 75, 0.11), (75, 105, 0.08), (150, 150, 0.05)]
SPARSE_TOL = {"float64": 1e-5, "float32": 1e-3}  # tests/test_sparse.py gates
PLAIN_TOL = 1e-6

BF16_FLOP_PER_S = PEAKS[H100]["bf16_flop_per_s"]  # on the tensor cores
DENSE_SOURCES = {
    "tiled_gemm": ("xsmm_tpu_torch/ops/csrc/tiled_gemm.cu",
                   "xsmm_tpu/ops/tiled_gemm.py:83"),
    "xcopy_copy": ("xsmm_tpu_torch/ops/csrc/xcopy.cu",
                   "xsmm_tpu/ops/xcopy.py:35"),
    "xcopy_trans": ("xsmm_tpu_torch/ops/csrc/xcopy.cu",
                    "xsmm_tpu/ops/xcopy.py:105"),
}
# (m, n, k) of samples/xgemm_driver.py:16-17
DEEPBENCH = [(1760, 128, 1760), (2048, 64, 2048), (2560, 64, 2560),
             (4096, 128, 4096)]
# tiled GEMM, kernel against plain and against gold: the two sum in f32 in
# other orders; a bf16 output holds ~3 digits
GEMM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}

PACKED_SOURCE = "xsmm_tpu_torch/ops/csrc/packed.cu"
PACKED_REPLACES = {
    "getrf_unrolled": "xsmm_tpu/ops/packed.py:66",
    "getrf_loop": "xsmm_tpu/ops/packed.py:104",
    "trsm_unrolled": "xsmm_tpu/ops/packed.py:196",
    "trsm_loop": "xsmm_tpu/ops/packed.py:219",
}
# the six (side, uplo, transa, diag) variants of tests/test_packed.py:57-60
TRSM_VARIANTS = [("L", "L", "N", "N"), ("L", "U", "N", "N"),
                 ("L", "L", "T", "N"), ("L", "L", "N", "U"),
                 ("R", "L", "N", "N"), ("R", "U", "T", "N")]
# f32 results against f64 gold; the f64 trsm gates of tests/test_packed.py
PACKED_TOL = {"f32": 1e-5, "refine": 1e-7, "host": 1e-8, "trmm_f64": 1e-6}
# kernel against its plain version: the same roundings in the same order
PACKED_PLAIN_TOL = 0.0

RNN_SOURCE = "xsmm_tpu_torch/ops/csrc/rnn_seq.cu"
RNN_REPLACES = {
    "lstm_seq": "xsmm_tpu/dnn/rnn_seq.py:112",
    "gru_seq": "xsmm_tpu/dnn/rnn_seq.py:271",
    "rnn_seq": "xsmm_tpu/dnn/rnn_seq.py:451",
}
# against f64 gold: the TOL of tests/test_dnn.py:20, and :370 for bf16
RNN_GOLD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# kernel against its plain version: f32 sums in another order than cuBLAS;
# with bf16 R both sum exact products in k order
RNN_PLAIN_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
RNN_BWD_REPLACES = {
    "lstm_seq_bwd": "xsmm_tpu/dnn/rnn_seq.py:185",
    "gru_seq_bwd": "xsmm_tpu/dnn/rnn_seq.py:335",
    "rnn_seq_bwd": "xsmm_tpu/dnn/rnn_seq.py:407",
}
GRAD_NAMES = ("dx", "dw", "dr", "db", "dh0", "dc0")

POOL_SOURCE = "xsmm_tpu_torch/ops/csrc/pooling.cu"
POOL_REPLACES = "xsmm_tpu/dnn/pooling.py:33"
# the DNN layers against f64 gold: f32 1e-5 (TF32 would give ~1e-3), a
# bf16 output 1e-2; BN at the gates of tests/test_dnn.py:20, :294-305
DNN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# a conv's f32 weight gradient sums N*H*W (1e5 to 2e5) products in cuDNN's
# own order: 1e-4 (TF32 would still give ~5e-4)
UPD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
BN_TOL = {"float32": (1e-3, 1e-2), "bfloat16": (1e-2, 1e-2)}  # (y, dx)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def pyfr_operators(np):
    """The three PyFR-shaped operators of samples/pyfr_driver.py:23-30, made
    in the same order from the same seed."""
    rng = np.random.default_rng(0)
    out = []
    for m, k, dens in PYFR_SPECS:
        a = np.where(rng.random((m, k)) < dens,
                     rng.standard_normal((m, k)), 0.0)
        out.append((f"{m}x{k}", a))
    return out


def _routed(fn, route):
    """``fn``, on ``route`` where one is given."""
    return fn if route is None else (
        lambda *x, **kw: fn(*x, route=route, **kw))


def sparse_phase(args, dev, smi):
    """Steps 7 and 8 of the module docstring; returns the sparse kernels'
    rows of the ``{"kernels": [...]}`` line."""
    import numpy as np
    import torch
    import xsmm_tpu_torch as xp
    from xsmm_tpu_torch.ops import spgemm_kernels as sk
    from xsmm_tpu_torch.ops.spgemm import F64_SCHEDULES
    from xsmm_tpu_torch.utils.timer import cuda_time_ms

    N = args.sparse_n
    scheds = sorted(F64_SCHEDULES)
    rng = np.random.default_rng(args.seed + 1)
    ops = pyfr_operators(np)
    f32, f64 = torch.float32, torch.float64

    def host(x):
        return x if isinstance(x, np.ndarray) else x.double().cpu().numpy()

    def gate(label, gold, got, tol):
        got = host(got)
        if got.shape != gold.shape:
            raise RuntimeError(f"{label}: shape {got.shape} != {gold.shape}")
        if not np.isfinite(got).all():
            raise RuntimeError(f"{label}: non-finite output")
        err = xp.matdiff(gold, got).normf_rel
        ok = err < tol
        print(f"gold  {label:36s} rel-Frobenius {err:.3e} (tol {tol:g}) "
              f"{'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: {err:.3e} >= {tol:g} against gold")

    # inputs: f64 on the host (the README call's numpy contract) and their
    # f32 hi/lo planes on the card
    data = {}
    for name, a in ops:
        m, k = a.shape
        b = rng.standard_normal((k, N))
        c = rng.standard_normal((m, N))
        bh, bl = xp.split_f64(b, dev)
        ch, cl = xp.split_f64(c, dev)
        data[name] = dict(a=a, b=b, c=c, bh=bh, bl=bl, ch=ch, cl=cl,
                          gold=a @ b)

    # -- 7. the sparse path through its entry points, counted ----------------
    sk.reset_launches()
    t0 = time.perf_counter()
    for name, a in ops:
        d = data[name]
        m, k = a.shape
        for sched in scheds:
            kern = xp.create_dcsr_reg(a, N, f64_schedule=sched)
            if kern.strategy != "unroll":
                raise RuntimeError(f"{name}: strategy {kern.strategy}")
            gate(f"dcsr_reg {name} {sched}", d["gold"], kern(d["b"]),
                 SPARSE_TOL["float64"])
            cs = [d["ch"], d["cl"]] if kern.c_lo else [d["ch"]]
            bs = [d["bh"], d["bl"]] if kern.b_lo else [d["bh"]]
            out = kern.acc_fn(*cs, *bs)
            out = out[0].to(f64) + out[1].to(f64) if kern.c_lo else out
            gate(f"dcsr_reg acc_fn {name} {sched}", d["c"] + d["gold"], out,
                 SPARSE_TOL["float64"])
        a32 = a.astype(np.float32)
        gold32 = a32.astype(np.float64) @ host(d["bh"])
        kern = xp.create_csr_soa(a32, N)
        gate(f"csr_soa f32 {name}", gold32, kern(d["bh"]),
             SPARSE_TOL["float32"])
        gate(f"csr_soa f32 acc_fn {name}", host(d["ch"]) + gold32,
             kern.acc_fn(d["ch"], d["bh"]), SPARSE_TOL["float32"])
    # dense A [N, 75] x sparse B: the transpose of the 105x75 operator
    bsp = ops[0][1].T.astype(np.float32)
    a_dense = torch.randn((N, bsp.shape[0]), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(
                              args.seed))
    kern = xp.create_csc_soa(bsp, N)
    gate("csc_soa f32 75x105^T", host(a_dense) @ bsp.astype(np.float64),
         kern(a_dense), SPARSE_TOL["float32"])
    name, a = ops[2]
    d = data[name]
    m, k = a.shape
    h = xp.dfsspmdm_create(m, N, k, a)
    gate(f"dfsspmdm {name} ({h.strategy})", d["gold"], h(d["b"]),
         SPARSE_TOL["float64"])
    a32 = a.astype(np.float32)
    h = xp.sfsspmdm_create(m, N, k, a32)
    gate(f"sfsspmdm {name} ({h.strategy})",
         a32.astype(np.float64) @ host(d["bh"]), h(d["bh"]),
         SPARSE_TOL["float32"])
    kern = xp.create_dcsr_reg(a, N, strategy="dense")
    gate(f"dcsr_reg dense strategy {name}", d["gold"], kern(d["b"]),
         SPARSE_TOL["float64"])
    sm = 1024
    a_sp = np.where(rng.random((sm, sm)) < 0.01,
                    rng.standard_normal((sm, sm)), 0).astype(np.float32)
    b_sp = rng.standard_normal((sm, sm)).astype(np.float32)
    for strategy in ("dense", "ell"):
        hs = xp.spmdm_init(sm, sm, sm, strategy=strategy)
        sl = hs.create_sparse_slice(a_sp)
        if sl.kind != strategy:
            raise RuntimeError(f"spmdm {strategy}: slice kind {sl.kind}")
        gate(f"spmdm {strategy} {sm}^3 1 %", a_sp.astype(np.float64)
             @ b_sp, hs.compute(sl, b_sp), SPARSE_TOL["float32"])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launched = dict(sk.launches)
    routes = {k_: v for k_, v in sk.route_launches.items() if v}
    print(f"sparse path: N={N}, 3 PyFR-shaped operators, in {main_s:.2f} s; "
          f"launches {launched}; routes {routes}")
    for kname, n in launched.items():
        if n < 1:
            raise RuntimeError(f"{kname} was not launched on the sparse path")

    # -- 8a. each kernel against its plain version, same operands -----------
    def variants(d, op):
        """(kernel name, label, wrapper call, plain call) of every kernel
        variant on operator ``op``."""
        bh, bl, ch, cl = d["bh"], d["bl"], d["ch"], d["cl"]

        out = [("spgemm_unroll_f32", "f32", lambda p=False, route=None: (
                    sk.unroll_f32_plain if p else _routed(sk.unroll_f32,
                                                          route))(op, bh)),
               ("spgemm_acc_f32", "f32", lambda p=False, route=None: (
                   sk.acc_f32_plain if p else _routed(sk.acc_f32, route))(
                       op, ch, bh))]
        for sched in scheds:
            b_lo, c_lo = F64_SCHEDULES[sched]
            bl_, cl_ = (bl if b_lo else None), (cl if c_lo else None)
            out.append(("spgemm_unroll_f64", sched,
                        lambda p=False, route=None, bl_=bl_, c_lo=c_lo: (
                            sk.unroll_f64_plain if p else _routed(
                                sk.unroll_f64, route))(op, bh, bl_,
                                                       c_lo=c_lo)))
            out.append(("spgemm_acc_f64", sched,
                        lambda p=False, route=None, bl_=bl_, cl_=cl_: (
                            sk.acc_f64_plain if p else _routed(
                                sk.acc_f64, route))(op, ch, cl_, bh, bl_)))
        return out

    max_abs = {kname: 0.0 for kname in SPARSE_REPLACES}
    plain_ops = {}
    for name, a in ops:
        op = sk.SparseOperator(xp.Csr.from_dense(a), dev)
        plain_ops[name] = op
        for kname, label, run in variants(data[name], op):
            got, want = run(), run(True)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = rel = 0.0
            for g_, w_ in zip(got, want):
                dd = g_.double() - w_.double()
                err = max(err, dd.abs().max().item())
                rel = max(rel, (torch.linalg.vector_norm(dd) / max(
                    torch.linalg.vector_norm(w_.double()).item(), 1e-300)
                    ).item())
            max_abs[kname] = max(max_abs[kname], err)
            ok = rel <= PLAIN_TOL
            print(f"plain {name:8s} {kname:18s} {label:11s} max_abs_err "
                  f"{err:.3e} rel-Frobenius {rel:.3e} (tol {PLAIN_TOL:g}) "
                  f"{'pass' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{name} {kname} {label}: kernel and plain "
                                   f"version disagree")
    # every route forced once on the 150x150 operator, bit for bit, and
    # the cp.async ring on a ragged N (the main path takes tma/shared)
    name, a = ops[2]
    op = plain_ops[name]
    odd = {k_: v[:, :N - 3].contiguous() for k_, v in data[name].items()
           if k_ in ("bh", "bl", "ch", "cl")}
    for d, rts in ((data[name], [(st, sr) for st in sk.STAGINGS
                                 for sr in sk.STRUCTURES]),
                   (odd, [("cp_async", "shared")])):
        for st, sr in rts:
            for kname, label, run in variants(d, op):
                r0 = dict(sk.route_launches)
                got = run(route=(st, sr))
                want = run(True)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                torch.cuda.synchronize()
                ok = all(torch.equal(g_, w_) for g_, w_ in zip(got, want)) \
                    and sk.route_launches[st] == r0[st] + 1 \
                    and sk.route_launches[sr] == r0[sr] + 1
                print(f"route {name:8s} N={got[0].shape[1]:<6d} {st}/{sr:6s} "
                      f"{kname:18s} {label:11s} bit-exact and counted "
                      f"{'pass' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError(f"{kname} {label} on {st}/{sr}: "
                                       f"kernel and plain version disagree")

    # -- 8b. times at N and at the big N, 150x150 operator in the JSON --------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    timed = [("spgemm_unroll_f32", None), ("spgemm_acc_f32", None),
             ("spgemm_unroll_f64", "split2"), ("spgemm_unroll_f64", "fold"),
             ("spgemm_acc_f64", "split2"), ("spgemm_acc_f64", "fold")]
    rows, first = {}, {}
    for name, a in ops:
        m, k = a.shape
        nnz = int(np.count_nonzero(a))
        a32 = torch.from_numpy(a.astype(np.float32)).to(dev)
        a64 = torch.from_numpy(a).to(dev)
        csr32, csr64 = a32.to_sparse_csr(), a64.to_sparse_csr()
        for n in (N, args.sparse_big):
            g = torch.Generator(device=dev).manual_seed(args.seed)
            bh, bl = (torch.randn((k, n), generator=g, device=dev)
                      for _ in range(2))
            ch, cl = (torch.randn((m, n), generator=g, device=dev)
                      for _ in range(2))
            b64, c64 = bh.double(), ch.double()
            op = plain_ops[name]
            lib = {
                "sparse.mm f32": cuda_time_ms(torch.sparse.mm, csr32, bh),
                "sparse.mm f64": cuda_time_ms(torch.sparse.mm, csr64, b64),
                "matmul dense f32": cuda_time_ms(torch.matmul, a32, bh),
                "addmm f32": cuda_time_ms(torch.addmm, ch, csr32, bh),
                "addmm f64": cuda_time_ms(torch.addmm, c64, csr64, b64),
            }
            for kname, sched in timed:
                acc = kname.startswith("spgemm_acc")
                is64 = kname.endswith("f64")
                b_lo, c_lo = F64_SCHEDULES[sched] if is64 else (False, False)
                kern = (xp.create_dcsr_reg(a, n, f64_schedule=sched) if is64
                        else xp.create_csr_soa(a, n))
                rd, wr = kern.stream_bytes
                nbytes = (rd + wr + (wr if acc else 0) + 4 * (m + 1)
                          + nnz * (12 if is64 else 8))
                nops = (6 if b_lo else 4 if is64 else 2) * nnz * n
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = nops / FP32_FLOP_PER_S * 1e3
                bound_ms = max(t_bytes, t_ops)
                bound_by = "bytes" if t_bytes >= t_ops else "operations"
                bl_ = bl if b_lo else None
                cl_ = cl if c_lo else None
                if kname == "spgemm_unroll_f32":
                    fn, fargs = sk.unroll_f32, (op, bh)
                    lib_key = "sparse.mm f32"
                elif kname == "spgemm_acc_f32":
                    fn, fargs, lib_key = sk.acc_f32, (op, ch, bh), "addmm f32"
                elif kname == "spgemm_unroll_f64":
                    fn = lambda *x, c_lo=c_lo: sk.unroll_f64(*x, c_lo=c_lo)
                    fargs, lib_key = (op, bh, bl_), "sparse.mm f64"
                else:
                    fn, fargs = sk.acc_f64, (op, ch, cl_, bh, bl_)
                    lib_key = "addmm f64"
                ms = cuda_time_ms(fn, *fargs, warmup=3, iters=20)
                plain_ms = host_us = None
                if n == N:
                    # the wrapper's host time a call, 100 calls enqueued
                    torch.cuda.synchronize()
                    t_h = time.perf_counter()
                    for _ in range(100):
                        fn(*fargs)
                    host_us = (time.perf_counter() - t_h) * 1e4
                    torch.cuda.synchronize()
                    plain = getattr(sk, kname.removeprefix("spgemm_")
                                    + "_plain")
                    plain_ms = cuda_time_ms(
                        (lambda *x, c_lo=c_lo: plain(*x, c_lo=c_lo))
                        if kname == "spgemm_unroll_f64" else plain, *fargs,
                        warmup=1, iters=3)
                label = f"{kname} {sched or 'f32'}"
                # a fixed cost a call and a stream rate: the line through
                # this N's (bytes, ms) and the first N's
                fit = ""
                if (name, label) in first and first[(name, label)][1] != ms:
                    b0, t0 = first[(name, label)]
                    rate = (nbytes - b0) / ((ms - t0) * 1e-3)
                    fit = (f"; fit with N={N}: fixed "
                           f"{(t0 * 1e-3 - b0 / rate) * 1e6:.1f} us a call, "
                           f"stream {rate / 1e12:.2f} TB/s")
                first.setdefault((name, label), (nbytes, ms))
                route = "/".join(sk.pick_route(
                    op, kname.endswith("f64"),
                    [bh] + ([bl_] if bl_ is not None else []),
                    (1 + c_lo) if acc else 0))
                print(f"time  {name:8s} N={n:<8d} {label:24s} {ms:.4f} ms, "
                      f"{nbytes / ms / 1e6:.1f} GB/s, bound {bound_ms:.4f} ms "
                      f"({bound_by}), share {bound_ms / ms:.3f}"
                      + (f"; plain {plain_ms:.3f} ms" if plain_ms else "")
                      + (f"; host {host_us:.1f} us a call" if host_us else "")
                      + f"; {lib_key} {lib[lib_key]:.4f} ms; route {route}"
                      + fit + f"  [{smi}]")
                if name == ops[2][0] and sched in (None, "split2"):
                    row = rows.setdefault(kname, {
                        "name": kname, "route": "cuda",
                        "source": SPARSE_SOURCE,
                        "replaces": SPARSE_REPLACES[kname],
                        "launches": launched[kname],
                        "max_abs_err": max_abs[kname],
                        "check": "pass"})
                    if n == N:
                        row.update(ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=lib[lib_key],
                                   library=f"torch.{lib_key}",
                                   shape=f"{name} nnz={nnz} N={n} "
                                         f"{sched or 'f32'}")
                    else:
                        row.update(ms_big=ms, bound_ms_big=bound_ms,
                                   n_big=n)
            print(f"lib   {name:8s} N={n:<8d} " + ", ".join(
                f"{k_} {v:.4f} ms" for k_, v in lib.items()) + f"  [{smi}]")
            del bh, bl, ch, cl, b64, c64
            torch.cuda.empty_cache()

    # -- 8c. the whole README call, numpy f64 in and out, step by step -------
    name, a = ops[2]
    b = data[name]["b"]
    kern = xp.create_dcsr_reg(a, N)
    op = plain_ops[name]
    whole, steps = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern(b)
        whole.append(time.perf_counter() - t0)
        t = [time.perf_counter()]
        bd = torch.from_numpy(b).to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        bh = bd.to(f32)
        bl = (bd - bh.to(f64)).to(f32)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ch, cl = sk.unroll_f64(op, bh, bl, c_lo=True)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        cd = ch.to(f64) + cl.to(f64)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        cd.cpu().numpy()
        t.append(time.perf_counter())
        steps.append([t[i + 1] - t[i] for i in range(5)])
    med = sorted(whole)[2] * 1e3
    parts = np.median(np.array(steps), axis=0) * 1e3
    print(f"call  create_dcsr_reg({name}, {N})(b) split2: {med:.3f} ms "
          f"(median of 5, host clock, numpy f64 in and out); steps (median): "
          f"copy in {parts[0]:.3f}, split {parts[1]:.3f}, kernel "
          f"{parts[2]:.3f}, join {parts[3]:.3f}, copy out {parts[4]:.3f} ms"
          f"  [{smi}]")
    return [rows[k_] for k_ in SPARSE_REPLACES]


def dense_phase(args, dev, smi):
    """Steps 10 to 12 of the module docstring; returns the dense kernels'
    rows of the ``{"kernels": [...]}`` line."""
    import numpy as np
    import torch
    import xsmm_tpu_torch as xp
    from xsmm_tpu_torch.ops import smm_packed
    from xsmm_tpu_torch.ops import tiled_gemm_kernels as tk
    from xsmm_tpu_torch.ops import xcopy_kernels as xk
    from xsmm_tpu_torch.utils.timer import cuda_time_ms

    # the plain GEMM, the gold products and the torch.matmul yardstick in
    # full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    S, T = args.gemm_size, args.copy_size
    g = torch.Generator(device=dev).manual_seed(args.seed + 2)

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=f64 if dtype == f64 else f32).to(dtype)

    def rel(got, want):
        d = torch.linalg.vector_norm(got.double() - want.double())
        return (d / max(torch.linalg.vector_norm(want.double()).item(),
                        1e-300)).item()

    def gate(label, err, tol, what="gold"):
        ok = err <= tol
        print(f"{what:5s} {label:36s} rel-Frobenius {err:.3e} (tol {tol:g}) "
              f"{'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: {err:.3e} > {tol:g} against {what}")

    def equal(label, got, want, what="gold"):
        ok = got.shape == want.shape and torch.equal(got, want)
        print(f"{what:5s} {label:36s} bit-exact {'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: not equal to {what}")

    # -- inputs, made on the card from the seed ------------------------------
    a32, b32, c0 = randn(S, S), randn(S, S), randn(S, S)
    a16, b16 = a32.to(bf16), b32.to(bf16)
    rm, rn, rk = S - 1, S + 1, 1000          # 4095 x 4097 x 1000 at S = 4096
    ra, rb = randn(rm, rk), randn(rk, rn)
    deep = [(m, n, k, randn(m, k, dtype=bf16), randn(k, n, dtype=bf16))
            for m, n, k in DEEPBENCH]
    x = randn(T, T)
    xr = randn(T + 256, T + 128)             # 8448 x 8320 at T = 8192
    x64 = randn(T // 2, T // 4, dtype=f64)
    x16 = randn(T // 4, T // 2, dtype=bf16)
    xb = randn(16, T // 8, T // 2)           # [rows, n] = [16 T/8, T/2]
    small = randn(23, 37), randn(3, 17, 29), randn(512, 256)
    B2 = S // 2                              # blocked GEMM 2048^3, blocks 256
    ba, bb = randn(B2, B2, dtype=bf16), randn(B2, B2, dtype=bf16)
    rng = np.random.default_rng(args.seed + 2)
    da, db, dc = (rng.standard_normal(s) for s in
                  [(768, 512), (512, 640), (768, 640)])
    ga, gb = randn(4096, 23, 23), randn(4096, 23, 23)

    # -- 10. the dense path through its entry points, counted ----------------
    # (label, call): every call the users make on this surface
    gemm_calls = [
        (f"xgemm bf16 {S}^3", lambda: xp.xgemm(a16, b16)),
        (f"xgemm f32 {S}^3", lambda: xp.xgemm(a32, b32)),
        (f"gemm_handle bf16->f32 {S}^3", lambda: xp.gemm_handle(
            S, S, S, in_dtype="bfloat16", out_dtype="float32")(a16, b16)),
        (f"xgemm f32 c0 {S}^3", lambda: xp.xgemm(a32, b32, c0)),
        (f"xgemm f32 {rm}x{rn}x{rk}", lambda: xp.xgemm(ra, rb)),
        (f"xgemm bf16 {rm}x{rn}x{rk}",
         lambda: xp.xgemm(ra.to(bf16), rb.to(bf16))),
    ] + [(f"xgemm bf16 {m}x{n}x{k}", lambda a=a, b=b: xp.xgemm(a, b))
         for m, n, k, a, b in deep]
    copy_calls = [
        (f"matcopy f32 {T}^2", lambda: xp.matcopy(x)),
        (f"otrans f32 {T}^2", lambda: xp.otrans(x)),
        (f"itrans f32 {T}^2", lambda: xp.itrans(x)),
        (f"otrans f32 {T + 256}x{T + 128}", lambda: xp.otrans(xr)),
        (f"otrans f64 {T // 2}x{T // 4}", lambda: xp.otrans(x64)),
        (f"otrans bf16 {T // 4}x{T // 2}", lambda: xp.otrans(x16)),
        (f"matcopy f32 16x{T // 8}x{T // 2}", lambda: xp.matcopy(xb)),
    ]
    # the JAX package's non-kernel routes: these must launch nothing
    route_calls = [
        ("matcopy 23x37 (clone)", lambda: xp.matcopy(small[0])),
        ("matcopy zero 23x37", lambda: xp.matcopy(small[0], zero=True)),
        ("otrans 3x17x29 (batched)", lambda: xp.otrans(small[1])),
        ("otrans 512x256 (small)", lambda: xp.otrans(small[2])),
    ]
    hb = xp.blocked_gemm_handle(B2, B2, B2, bm=256, bn=256, bk=256,
                                dtype="bfloat16")
    hd = xp.blocked_gemm_handle(768, 640, 512, bm=128, bn=128, bk=128,
                                dtype="float64")
    tk.reset_launches()
    xk.reset_launches()
    t0 = time.perf_counter()
    outs = {label: fn() for label, fn in gemm_calls + copy_calls}
    torch.cuda.synchronize()
    before = dict(tk.launches, **xk.launches)
    for label, fn in route_calls:
        outs[label] = fn()
    if dict(tk.launches, **xk.launches) != before:
        raise RuntimeError("a non-kernel route launched a kernel")
    outs["bgemm bf16"] = hb(ba, bb)
    outs["bgemm f64"] = hd(da, db, dc)
    batched0 = dict(smm_packed.launches)
    outs["gemm_batch f32 4096x23^3"] = xp.gemm_batch(ga, gb)
    with xp.mmbatch_begin(record_only=False) as calls:
        outs["mmbatch_begin reroute"] = torch.matmul(ga, gb)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launched = dict(tk.launches, **xk.launches)
    routes = dict(tk.route_launches)
    rerouted = {kn: n - batched0[kn] for kn, n in smm_packed.launches.items()
                if n != batched0[kn]}
    print(f"dense path: {len(outs)} calls in {main_s:.2f} s; launches "
          f"{launched}; tiled_gemm routes {routes}; batched SMM {rerouted} "
          f"(gemm_batch and the mmbatch_begin reroute); recorded "
          f"{len(calls)} call(s)")
    for kname, n in list(launched.items()) + [
            (f"tiled_gemm route {r}", n) for r, n in routes.items()]:
        if n < 1:
            raise RuntimeError(f"{kname} was not launched on the dense path")
    # contiguous f32 at 23^3: the natural kernel, once each
    if rerouted != {"natural_f32": 2} or len(calls) != 1:
        raise RuntimeError("gemm_batch or the mmbatch_begin reroute did not "
                           "reach the natural kernel once each")

    # gold: f64 products on the card of what each handle computed from
    gold16 = a16.double() @ b16.double()
    gold32 = a32.double() @ b32.double()
    golds = {f"xgemm bf16 {S}^3": (gold16, "bfloat16"),
             f"xgemm f32 {S}^3": (gold32, "float32"),
             f"gemm_handle bf16->f32 {S}^3": (gold16, "float32"),
             f"xgemm f32 c0 {S}^3": (gold32 + c0.double(), "float32"),
             f"xgemm f32 {rm}x{rn}x{rk}": (ra.double() @ rb.double(),
                                          "float32"),
             f"xgemm bf16 {rm}x{rn}x{rk}": (ra.to(bf16).double()
                                           @ rb.to(bf16).double(),
                                           "bfloat16")}
    for m, n, k, a, b in deep:
        golds[f"xgemm bf16 {m}x{n}x{k}"] = (a.double() @ b.double(),
                                           "bfloat16")
    for label, (gold, out_dt) in golds.items():
        got = outs[label]
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{label}: non-finite output")
        gate(label, rel(got, gold), GEMM_TOL[out_dt])
    del gold16, gold32, golds
    copy_gold = {f"matcopy f32 {T}^2": x, f"otrans f32 {T}^2": x.t(),
                 f"itrans f32 {T}^2": x.t(),
                 f"otrans f32 {T + 256}x{T + 128}": xr.t(),
                 f"otrans f64 {T // 2}x{T // 4}": x64.t(),
                 f"otrans bf16 {T // 4}x{T // 2}": x16.t(),
                 f"matcopy f32 16x{T // 8}x{T // 2}": xb,
                 "matcopy 23x37 (clone)": small[0],
                 "matcopy zero 23x37": torch.zeros_like(small[0]),
                 "otrans 3x17x29 (batched)": small[1].transpose(-1, -2),
                 "otrans 512x256 (small)": small[2].t()}
    for label, want in copy_gold.items():
        equal(label, outs[label], want)
        if not outs[label].is_contiguous():
            raise RuntimeError(f"{label}: not a contiguous tensor")
    gate(f"blocked bf16 {B2}^3 blocks 256", rel(outs["bgemm bf16"],
                                               ba.double() @ bb.double()),
         GEMM_TOL["bfloat16"])
    err = xp.matdiff(da @ db + dc, outs["bgemm f64"]).normf_rel
    gate("blocked f64 768x640x512 + C", err, 1e-6)
    gsum = torch.einsum("bmk,bkn->bmn", ga.double(), gb.double())
    gate("gemm_batch f32 4096x23^3", rel(outs["gemm_batch f32 4096x23^3"],
                                         gsum), 1e-5)
    gate("mmbatch_begin reroute", rel(outs["mmbatch_begin reroute"], gsum),
         1e-5)

    # -- 11. each kernel against its plain version, same inputs --------------
    max_abs = {k_: 0.0 for k_ in DENSE_SOURCES}
    plain_cases = [(f"bf16 {S}^3", a16, b16, bf16), (f"f32 {S}^3", a32, b32, f32),
                   (f"bf16->f32 {S}^3", a16, b16, f32),
                   (f"f32 {rm}x{rn}x{rk}", ra, rb, f32),
                   (f"bf16 {rm}x{rn}x{rk}", ra.to(bf16), rb.to(bf16), bf16)]
    plain_cases += [(f"bf16 {m}x{n}x{k}", a, b, bf16) for m, n, k, a, b in deep]
    for label, a, b, out_dt in plain_cases:
        h = xp.gemm_handle(a.shape[0], b.shape[1], a.shape[1],
                           in_dtype=a.dtype, out_dtype=out_dt)
        want = tk.gemm_plain(a, b, out_dtype=out_dt, bk=h.bk)
        # the route the wrapper picks, and the mma.sync route forced where
        # it picks TMA
        picked = tk.pick_route(a, b)
        for rt in [picked] + (["mma"] if picked == "tma" else []):
            got = tk.gemm(a, b, out_dtype=out_dt, route=rt)
            max_abs["tiled_gemm"] = max(max_abs["tiled_gemm"], (
                got.double() - want.double()).abs().max().item())
            gate(f"tiled_gemm {label} {rt}", rel(got, want),
                 GEMM_TOL["float32" if out_dt == f32 else "bfloat16"],
                 "plain")
    for label, fn, plain, src in [
            (f"copy f32 {T}^2", xk.copy, xk.copy_plain, x),
            (f"copy f32 16x{T // 8}x{T // 2}", xk.copy, xk.copy_plain, xb),
            (f"trans f32 {T}^2", xk.trans, xk.trans_plain, x),
            (f"trans f32 {T + 256}x{T + 128}", xk.trans, xk.trans_plain, xr),
            (f"trans f64 {T // 2}x{T // 4}", xk.trans, xk.trans_plain, x64),
            (f"trans bf16 {T // 4}x{T // 2}", xk.trans, xk.trans_plain, x16)]:
        equal(label, fn(src), plain(src), "plain")

    # -- 12. times, beside the bound, the plain version and the library ------
    def gemm_bound(m, n, k, in_size, out_size, peak):
        t_bytes = ((m * k + k * n) * in_size + m * n * out_size) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * m * n * k / peak * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    timed = {}
    # the two 16-bit routes in turns (tma, mma, mma, tma), torch.matmul
    # beside them
    turns = {"tma": [], "mma": []}
    for rt in ("tma", "mma", "mma", "tma"):
        turns[rt].append(cuda_time_ms(lambda: tk.gemm(
            a16, b16, out_dtype=bf16, route=rt), warmup=3, iters=20))
    mm16 = cuda_time_ms(torch.matmul, a16, b16, warmup=3, iters=20)
    print(f"time  tiled_gemm bf16 {S}^3 routes in turns: tma "
          f"{turns['tma'][0]:.4f} / {turns['tma'][1]:.4f} ms, mma "
          f"{turns['mma'][0]:.4f} / {turns['mma'][1]:.4f} ms; torch.matmul "
          f"{mm16:.4f} ms  [{smi}]")
    deep_mma = {}
    for m, n, k, a, b in deep:
        deep_mma[(m, n, k)] = cuda_time_ms(lambda: tk.gemm(
            a, b, out_dtype=bf16, route="mma"), warmup=3, iters=20)
    for label, a, b, out_dt, lib in [
            (f"bf16->bf16 {S}^3", a16, b16, bf16, True),
            (f"f32 {S}^3", a32, b32, f32, True),
            (f"bf16->f32 {S}^3", a16, b16, f32, False),
            (f"f32 {rm}x{rn}x{rk}", ra, rb, f32, True)] + [
            (f"bf16 {m}x{n}x{k}", a, b, bf16, True) for m, n, k, a, b in deep]:
        m, k = a.shape
        n = b.shape[1]
        peak = FP32_FLOP_PER_S if a.dtype == f32 else BF16_FLOP_PER_S
        bound_ms, bound_by = gemm_bound(m, n, k, a.element_size(),
                                        torch.empty((), dtype=out_dt)
                                        .element_size(), peak)
        ms = cuda_time_ms(lambda: tk.gemm(a, b, out_dtype=out_dt), warmup=3,
                          iters=20)
        plain_ms = library_ms = None
        if label in (f"bf16->bf16 {S}^3", f"f32 {S}^3"):
            plain_ms = cuda_time_ms(lambda: tk.gemm_plain(
                a, b, out_dtype=out_dt, bk=512), warmup=1, iters=3)
        if lib:
            library_ms = cuda_time_ms(torch.matmul, a, b, warmup=3, iters=20)
        timed[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms)
        rt = tk.pick_route(a, b)
        mma_ms = deep_mma.get((m, n, k))
        print(f"time  tiled_gemm {label:22s} {rt:4s} {ms:.4f} ms, "
              f"{2 * m * n * k / ms / 1e9:.1f} TFLOP/s, bound {bound_ms:.4f} "
              f"ms ({bound_by}), share {bound_ms / ms:.3f}"
              + (f"; mma route {mma_ms:.4f} ms" if mma_ms else "")
              + (f"; plain {plain_ms:.3f} ms" if plain_ms else "")
              + (f"; torch.matmul {library_ms:.4f} ms" if lib else "")
              + f"  [{smi}]")
    for label, fn, plain, lib, src in [
            (f"copy f32 {T}^2", xk.copy, xk.copy_plain, torch.clone, x),
            (f"trans f32 {T}^2", xk.trans, xk.trans_plain,
             lambda t: t.t().contiguous(), x),
            (f"trans f32 {T + 256}x{T + 128}", xk.trans, xk.trans_plain,
             lambda t: t.t().contiguous(), xr),
            (f"trans f64 {T // 2}x{T // 4}", xk.trans, xk.trans_plain,
             lambda t: t.t().contiguous(), x64),
            (f"trans bf16 {T // 4}x{T // 2}", xk.trans, xk.trans_plain,
             lambda t: t.t().contiguous(), x16),
            (f"copy f32 16x{T // 8}x{T // 2}", xk.copy, xk.copy_plain,
             torch.clone, xb)]:
        nbytes = 2 * src.numel() * src.element_size()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # the copies in turns with the library call: kernel, library,
        # library, kernel
        got = {"k": [], "l": []}
        for what in ("k", "l", "l", "k") if fn is xk.copy else ("k", "l"):
            got[what].append(cuda_time_ms(fn if what == "k" else lib, src,
                                          warmup=3, iters=20))
        ms, library_ms = (sum(v) / len(v) for v in (got["k"], got["l"]))
        plain_ms = cuda_time_ms(plain, src, warmup=3, iters=20)
        timed[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by="bytes", library_ms=library_ms)
        in_turns = (f"; in turns: kernel "
                    f"{' / '.join('%.4f' % v for v in got['k'])}, library "
                    f"{' / '.join('%.4f' % v for v in got['l'])} ms"
                    if fn is xk.copy else "")
        print(f"time  {label:33s} {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s, "
              f"bound {bound_ms:.4f} ms (bytes), share {bound_ms / ms:.3f}; "
              f"plain {plain_ms:.4f} ms; library {library_ms:.4f} ms"
              f"{in_turns}  [{smi}]")

    # the whole entry-point call at the headline shape, tensors on the card
    call_ms = cuda_time_ms(lambda: xp.xgemm(a16, b16), warmup=3, iters=20)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xp.xgemm(a16, b16)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    print(f"call  xgemm bf16 {S}^3: {call_ms:.4f} ms (CUDA events, 20 calls); "
          f"{sorted(host)[2] * 1e3:.4f} ms (median of 5, host clock, "
          f"synchronized); kernel {timed[f'bf16->bf16 {S}^3']['ms']:.4f} ms"
          f"  [{smi}]")

    def row(kname, label, shape, library, extra=None):
        src, replaces = DENSE_SOURCES[kname]
        r = {"name": kname, "route": "cuda", "source": src,
             "replaces": replaces, "launches": launched[kname],
             "max_abs_err": max_abs[kname], **timed[label],
             "library": library, "check": "pass", "shape": shape}
        r.update(extra or {})
        return r

    f32_row = timed[f"f32 {S}^3"]
    return [
        row("tiled_gemm", f"bf16->bf16 {S}^3", f"{S}^3 bf16->bf16",
            "torch.matmul bf16",
            {"routes": routes, "ms_tma_turns": turns["tma"], "ms_mma_turns": turns["mma"],
             "ms_f32": f32_row["ms"], "plain_ms_f32": f32_row["plain_ms"],
             "bound_ms_f32": f32_row["bound_ms"],
             "library_ms_f32": f32_row["library_ms"],
             "deepbench": {f"{m}x{n}x{k}": {
                 "ms": timed[f"bf16 {m}x{n}x{k}"]["ms"],
                 "ms_mma": deep_mma[(m, n, k)],
                 "library_ms": timed[f"bf16 {m}x{n}x{k}"]["library_ms"],
                 "bound_ms": timed[f"bf16 {m}x{n}x{k}"]["bound_ms"]}
                 for m, n, k in DEEPBENCH}}),
        row("xcopy_copy", f"copy f32 {T}^2", f"{T}^2 f32", "torch.clone",
            {f"{k}_16x{T // 8}x{T // 2}": v for k, v in
             timed[f"copy f32 16x{T // 8}x{T // 2}"].items()
             if k in ("ms", "library_ms")}),
        row("xcopy_trans", f"trans f32 {T}^2", f"{T}^2 f32",
            "Tensor.t().contiguous()",
            {"ms_ragged": timed[f"trans f32 {T + 256}x{T + 128}"]["ms"]}),
    ]


def packed_phase(args, dev, smi):
    """Steps 14 to 16 of the module docstring; returns the packed-LA
    kernels' rows of the ``{"kernels": [...]}`` line."""
    import numpy as np
    import torch
    import xsmm_tpu_torch as xp
    from xsmm_tpu_torch.ops import packed_kernels as pk
    from xsmm_tpu_torch.ops import smm_packed
    from xsmm_tpu_torch.ops.pack_util import pack_lanes as pack
    from xsmm_tpu_torch.utils.timer import cuda_time_ms

    f64 = torch.float64
    B, M = args.packed_batch, 16
    BB, BM = args.packed_big_batch, args.packed_big_m
    S = min(GOLD_SUBSET, B, BB)
    g = torch.Generator(device=dev).manual_seed(args.seed + 3)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=f64)

    def dd(b, m, n=None):
        """tests/test_packed.py:23-29: standard normal plus m on the
        diagonal (factorizable without pivoting)."""
        a = randn(b, m, n or m)
        idx = torch.arange(min(m, n or m), device=dev)
        a[:, idx, idx] += m
        return a

    def sub(x):
        x = x[:S]
        return (torch.from_numpy(np.ascontiguousarray(x)) if
                isinstance(x, np.ndarray) else x).to(dev, f64)

    def rel(got, want):
        d = torch.linalg.vector_norm(got - want)
        return (d / torch.linalg.vector_norm(want)).item()

    def gate(label, err, tol):
        ok = err <= tol
        print(f"gold  {label:36s} rel-Frobenius {err:.3e} (tol {tol:g}) "
              f"{'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: {err:.3e} > {tol:g} against gold")

    def op_tri(a, uplo, transa, diag):
        at = (torch.tril if uplo == "L" else torch.triu)(a)
        if diag == "U":
            idx = torch.arange(at.shape[-1], device=dev)
            at[..., idx, idx] = 1.0
        return at.transpose(-1, -2) if transa == "T" else at

    # -- inputs, made on the card from the seed ------------------------------
    a64, b64 = dd(B, M), randn(B, M, M)
    a32, b32 = a64.float(), b64.float()
    a_np, b_np = a64.cpu().numpy(), b64.cpu().numpy()  # the f64 contract
    rect = {(12, 8): dd(B, 12, 8).float(), (8, 12): dd(B, 8, 12).float()}
    abig, bbig = dd(BB, BM).float(), randn(BB, BM, BM).float()
    # kernel 12's "shared" route: beyond the tile route's 128
    BS = 140
    ashared = dd(BB, BS).float()

    # -- 14. the packed path through its entry points, counted ---------------
    counts = (pk.launches, smm_packed.launches)
    totals = dict.fromkeys(PACKED_REPLACES, 0)
    route_totals = dict.fromkeys(pk.GETRF_ROUTES, 0)
    outs = {}

    def drive(label, fn, expect):
        """Counts set to 0 just before the call and read just after it:
        the call must launch ``expect`` and nothing else."""
        pk.reset_launches()
        smm_packed.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for c in counts for k, v in c.items() if v}
        if set(got) != {expect}:
            raise RuntimeError(f"{label}: launched {got}, expected {expect}")
        for k in totals:
            totals[k] += pk.launches[k]
        for k in route_totals:
            route_totals[k] += pk.getrf_route_launches[k]
        routes = {k: v for k, v in pk.getrf_route_launches.items() if v}
        print(f"drive {label:36s} launches {got}"
              + (f", getrf_loop routes {routes}" if routes else ""))
        outs[label] = out

    t0 = time.perf_counter()
    drive(f"getrf f32 {M}x{M}", lambda: xp.getrf_dispatch(M, M, batch=B)(a32),
          "getrf_unrolled")
    drive(f"getrf f64 {M}x{M} numpy", lambda: xp.getrf_dispatch(
        M, M, dtype="float64", batch=B)(a_np), "getrf_unrolled")
    for (m, n), a in rect.items():
        drive(f"getrf f32 {m}x{n}", lambda m=m, n=n, a=a: xp.getrf_dispatch(
            m, n, batch=B)(a), "getrf_unrolled")
    for v in TRSM_VARIANTS:
        side, uplo, transa, diag = v
        # the left solve that the call reduces to is upper where the stored
        # triangle is upper and no transpose flips it, or lower and one does
        upper = (uplo == "U") == ((side == "R") == (transa == "T"))
        drive(f"trsm f32 {''.join(v)} {M}/{M}", lambda v=v: xp.trsm_dispatch(
            M, M, side=v[0], uplo=v[1], transa=v[2], diag=v[3], batch=B)(
                a32, b32), "trsm_unrolled_upper" if upper else "trsm_unrolled")
    drive(f"trsm f32 LLNN {M}/{M} alpha=2", lambda: xp.trsm_dispatch(
        M, M, batch=B)(a32, b32, alpha=2.0), "trsm_unrolled")
    k64 = xp.trsm_dispatch(M, M, dtype="float64", batch=B)
    for refine in (None, "host", False):
        drive(f"trsm f64 {M}/{M} refine={refine}",
              lambda r=refine: k64(a_np, b_np, refine=r), "trsm_unrolled")
    drive(f"getrf f32 {BM}x{BM}", lambda: xp.getrf_dispatch(
        BM, BM, batch=BB)(abig), "getrf_loop")
    drive(f"getrf f32 {BS}x{BS}", lambda: xp.getrf_dispatch(
        BS, BS, batch=BB)(ashared), "getrf_loop")
    drive(f"trsm f32 LLNN {BM}/{BM}", lambda: xp.trsm_dispatch(
        BM, BM, batch=BB)(abig, bbig), "trsm_loop")
    drive(f"trmm f32 {M}/{M}", lambda: xp.trmm_dispatch(M, M, batch=B)(
        a32, b32), "natural_f32")
    drive(f"trmm f64 {M}/{M} numpy", lambda: xp.trmm_dispatch(
        M, M, dtype="float64", batch=B)(a_np, b_np), "packed_split2_fast")
    drive(f"pgemm f32 {M}^3", lambda: xp.pgemm_dispatch(M, M, M, batch=B)(
        a32, b32), "natural_f32")
    main_s = time.perf_counter() - t0
    print(f"packed path: {len(outs)} calls at B={B} ({M}) and B={BB} ({BM}, "
          f"{BS}) in {main_s:.2f} s; packed-LA launches {totals}; "
          f"getrf_loop routes {route_totals}")
    for kname, n in [*totals.items(), *(
            (f"getrf_loop route {r}", n) for r, n in route_totals.items())]:
        if n < 1:
            raise RuntimeError(f"{kname} was not launched on the packed path")

    # -- 15. gold on the first S problems, f64 on the card -------------------
    for label, a in [(f"getrf f32 {M}x{M}", a32), (f"getrf f64 {M}x{M} numpy",
                                                   a32),
                     (f"getrf f32 12x8", rect[(12, 8)]),
                     (f"getrf f32 8x12", rect[(8, 12)]),
                     (f"getrf f32 {BM}x{BM}", abig),
                     (f"getrf f32 {BS}x{BS}", ashared)]:
        lu, a = sub(outs[label]), sub(a)
        if not torch.isfinite(lu).all():
            raise RuntimeError(f"{label}: non-finite output")
        m, n = lu.shape[1:]
        k = min(m, n)
        low = torch.tril(lu[:, :, :k], -1) + torch.eye(m, k, dtype=f64,
                                                       device=dev)
        gate(f"{label} L@U", rel(low @ torch.triu(lu[:, :k, :]), a),
             PACKED_TOL["f32"])

    def solve_gate(label, a, b, v, alpha, tol):
        side, uplo, transa, diag = v
        x, opa = sub(outs[label]), op_tri(sub(a), uplo, transa, diag)
        if not torch.isfinite(x).all():
            raise RuntimeError(f"{label}: non-finite output")
        gate(f"{label} op(A)X", rel(opa @ x if side == "L" else x @ opa,
                                    alpha * sub(b)), tol)

    for v in TRSM_VARIANTS:
        solve_gate(f"trsm f32 {''.join(v)} {M}/{M}", a32, b32, v, 1.0,
                   PACKED_TOL["f32"])
    solve_gate(f"trsm f32 LLNN {M}/{M} alpha=2", a32, b32, TRSM_VARIANTS[0],
               2.0, PACKED_TOL["f32"])
    for refine, tol in ((None, "refine"), ("host", "host"), (False, "f32")):
        solve_gate(f"trsm f64 {M}/{M} refine={refine}", a64, b64,
                   TRSM_VARIANTS[0], 1.0, PACKED_TOL[tol])
    solve_gate(f"trsm f32 LLNN {BM}/{BM}", abig, bbig, TRSM_VARIANTS[0], 1.0,
               PACKED_TOL["f32"])
    for label, a, b, tol in [(f"trmm f32 {M}/{M}", a32, b32, "f32"),
                             (f"trmm f64 {M}/{M} numpy", a64, b64,
                              "trmm_f64")]:
        gate(label, rel(sub(outs[label]), torch.tril(sub(a)) @ sub(b)),
             PACKED_TOL[tol])
    gate(f"pgemm f32 {M}^3", rel(sub(outs[f"pgemm f32 {M}^3"]),
                                 sub(a32) @ sub(b32)), PACKED_TOL["f32"])
    del outs

    # -- 16a. each kernel against its plain version, same packed operands ---
    # the unit-diagonal solves take A scaled by 1/m: random unit-lower
    # matrices grow X exponentially in m
    pa, pb, pabig, pbbig = pack(a32), pack(b32), pack(abig), pack(bbig)
    cases = [("getrf_unrolled", f"{M}x{M}", (pa,)),
             ("getrf_unrolled", "12x8", (pack(rect[(12, 8)]),)),
             ("getrf_unrolled", "8x12", (pack(rect[(8, 12)]),)),
             ("getrf_loop", f"{BM}x{BM}", (pabig,)),
             ("getrf_loop", f"{BS}x{BS}", (pack(ashared),)),
             ("trsm_unrolled", f"{M}/{M}", (pa, pb, False)),
             ("trsm_unrolled", f"{M}/{M} unit", (pa / M, pb, True)),
             ("trsm_loop", f"{BM}/{BM}", (pabig, pbbig, False)),
             ("trsm_loop", f"{BM}/{BM} unit", (pabig / BM, pbbig, True))]
    max_abs = dict.fromkeys(PACKED_REPLACES, 0.0)
    for kname, label, ops in cases:
        got = getattr(pk, kname)(*ops)
        want = getattr(pk, kname + "_plain")(*ops)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        ok = (bool(torch.isfinite(got).all()) and torch.equal(got, want)
              and err <= PACKED_PLAIN_TOL)
        max_abs[kname] = max(max_abs[kname], err)
        print(f"plain {kname:15s} {label:14s} max_abs_err {err:.3e} (tol "
              f"{PACKED_PLAIN_TOL:g}, bit for bit) {'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{kname} {label}: kernel and plain version "
                               f"disagree")
    del cases

    # -- 16b. times beside the bound, the plain version and the library ----
    def getrf_ops(m, n, recip):
        steps = [k for k in range(min(m, n)) if k + 1 < m]
        return sum((m - k - 1) + 2 * (m - k - 1) * (n - k - 1) + recip
                   for k in steps)

    def trsm_ops(sm, sn, loop):
        # loop: a multiply and an add per term, then b - s and a division;
        # unrolled: a multiply and a subtract per term, the reciprocal and
        # the row scaling
        return sm * (sm - 1) * sn + (2 * sm * sn if loop else sm * sn + sm)

    timed = [
        ("getrf_unrolled", f"{M}x{M} B={B}", (pa,), M, M, B,
         getrf_ops(M, M, 1), "torch.linalg.lu_factor_ex(pivot=False)",
         (lambda x: torch.linalg.lu_factor_ex(x, pivot=False), a32)),
        ("getrf_loop", f"{BM}x{BM} B={BB}", (pabig,), BM, BM, BB,
         getrf_ops(BM, BM, 0), "torch.linalg.lu_factor_ex(pivot=False)",
         (lambda x: torch.linalg.lu_factor_ex(x, pivot=False), abig)),
        ("trsm_unrolled", f"{M}/{M} B={B}", (pa, pb, False), M, M, B,
         trsm_ops(M, M, False), "torch.linalg.solve_triangular",
         (lambda x, y: torch.linalg.solve_triangular(x, y, upper=False),
          a32, b32)),
        ("trsm_loop", f"{BM}/{BM} B={BB}", (pabig, pbbig, False), BM, BM, BB,
         trsm_ops(BM, BM, True), "torch.linalg.solve_triangular",
         (lambda x, y: torch.linalg.solve_triangular(x, y, upper=False),
          abig, bbig)),
    ]
    rows = []
    for kname, shape, ops, m, n, bsz, nops1, lib_name, lib in timed:
        # getrf reads A and writes LU; trsm reads tril(A) and B, writes X
        nbytes = (2 * m * n if kname.startswith("getrf")
                  else m * (m + 1) // 2 + 2 * m * n) * 4 * bsz
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops1 * bsz / FP32_FLOP_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        fn = getattr(pk, kname)
        extra = {}
        if kname == "getrf_loop":
            # in turns with the library call (kernel, library, library,
            # kernel)
            ms_t, lib_t = [], []
            for what in ("k", "l", "l", "k"):
                if what == "k":
                    ms_t.append(cuda_time_ms(fn, *ops, warmup=3, iters=20))
                else:
                    lib_t.append(cuda_time_ms(*lib, warmup=2, iters=10))
            ms, library_ms = sum(ms_t) / 2, sum(lib_t) / 2
            extra = {"getrf_route": pk.getrf_route(m, n), "ms_turns": ms_t,
                     "library_ms_turns": lib_t, "routes": route_totals}
            print(f"time  getrf_loop {shape} in turns: {extra['getrf_route']}"
                  f" route {ms_t[0]:.4f} / {ms_t[1]:.4f} ms, {lib_name} "
                  f"{lib_t[0]:.4f} / {lib_t[1]:.4f} ms  [{smi}]")
        elif kname == "trsm_loop":
            # in turns with the library call (kernel, library, library,
            # kernel), and the unit-diagonal solve
            ms_t, lib_t = [], []
            for what in ("k", "l", "l", "k"):
                if what == "k":
                    ms_t.append(cuda_time_ms(fn, *ops, warmup=3, iters=20))
                else:
                    lib_t.append(cuda_time_ms(*lib, warmup=2, iters=10))
            ms, library_ms = sum(ms_t) / 2, sum(lib_t) / 2
            extra = {"ms_turns": ms_t, "library_ms_turns": lib_t,
                     "ms_unit": cuda_time_ms(fn, ops[0] / m, ops[1], True,
                                             warmup=3, iters=20)}
            print(f"time  trsm_loop {shape} in turns: kernel "
                  f"{ms_t[0]:.4f} / {ms_t[1]:.4f} ms, {lib_name} "
                  f"{lib_t[0]:.4f} / {lib_t[1]:.4f} ms; unit diagonal "
                  f"{extra['ms_unit']:.4f} ms  [{smi}]")
        else:
            ms = cuda_time_ms(fn, *ops, warmup=3, iters=20)
            library_ms = cuda_time_ms(*lib, warmup=2, iters=10)
        plain_ms = cuda_time_ms(getattr(pk, kname + "_plain"), *ops,
                                warmup=1, iters=3)
        print(f"time  {kname:15s} {shape:18s} {ms:.4f} ms, "
              f"{nbytes / ms / 1e6:.1f} GB/s, {nops1 * bsz / ms / 1e9:.2f} "
              f"TFLOP/s, bound {bound_ms:.4f} ms ({bound_by}; bytes "
              f"{t_bytes:.4f}, ops {t_ops:.4f}), share {bound_ms / ms:.3f}; "
              f"plain {plain_ms:.3f} ms; {lib_name} {library_ms:.4f} ms  "
              f"[{smi}]")
        rows.append({
            "name": kname, "route": "cuda", "source": PACKED_SOURCE,
            "replaces": PACKED_REPLACES[kname], "launches": totals[kname],
            "max_abs_err": max_abs[kname], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library": lib_name, "check": "pass",
            "shape": shape, **extra})

    # -- 16b'. block-Jacobi's solves: kernel 14 at one column on one packed
    # LU, the lower (unit) solve and the upper variant, which reads triu(LU)
    # in place
    rows_by = {row["name"]: row for row in rows}
    pa1 = torch.randn((BM, BM, B), generator=g, device=dev,
                      dtype=torch.float32) / BM
    idx = torch.arange(BM, device=dev)
    pa1[idx, idx] += 1.0
    lu1 = pk.getrf_loop(pa1)
    del pa1
    r1 = torch.randn((BM, 1, B), generator=g, device=dev,
                     dtype=torch.float32)
    solves, outs = {}, {}
    for uplo, diag, expect in (("L", "U", "trsm_loop"),
                               ("U", "N", "trsm_loop_upper")):
        kern = xp.trsm_dispatch(BM, 1, uplo=uplo, diag=diag, batch=B)
        drive(f"trsm f32 L{uplo}N{diag} {BM}/1 packed",
              lambda k=kern: k.packed(lu1, r1), expect)
        got = outs.pop(f"trsm f32 L{uplo}N{diag} {BM}/1 packed")
        want = (pk.trsm_loop_plain(lu1, r1, True) if uplo == "L"
                else pk.trsm_loop_upper_plain(lu1, r1, False))
        torch.cuda.synchronize()
        ok = bool(torch.isfinite(got).all()) and torch.equal(got, want)
        print(f"plain {expect:15s} {BM}/1 B={B} packed on the LU: bit for "
              f"bit {'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{expect} {BM}/1: kernel and plain version "
                               f"disagree")
        del got, want
        # reads its triangle (the diagonal where it divides), B and X
        tri = BM * (BM - 1) // 2 + (0 if diag == "U" else BM)
        nbytes = (tri + 2 * BM) * 4 * B
        nops = (BM * (BM - 1) + (0 if diag == "U" else BM)) * B
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_FLOP_PER_S * 1e3
        solves[uplo] = {"bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations", "ms_turns": []}
    for uplo in ("L", "U", "U", "L"):
        solves[uplo]["ms_turns"].append(cuda_time_ms(
            pk.trsm_loop, lu1, r1, uplo == "L", uplo == "U", warmup=3,
            iters=20))
    # the lower solve with the division, which the upper one makes: the
    # variants' gap apart from the diagonal
    lower_div_ms = cuda_time_ms(pk.trsm_loop, lu1, r1, False, warmup=3,
                                iters=20)
    for uplo, name in (("L", "lower unit"), ("U", "upper")):
        sv = solves[uplo]
        sv["ms"] = sum(sv["ms_turns"]) / 2
        print(f"time  trsm_loop {name:10s} {BM}/1 B={B} packed on the LU in "
              f"turns: {sv['ms_turns'][0]:.4f} / {sv['ms_turns'][1]:.4f} ms, "
              f"bound {sv['bound_ms']:.4f} ms ({sv['bound_by']}), share "
              f"{sv['bound_ms'] / sv['ms']:.3f}  [{smi}]")
    print(f"time  trsm_loop lower, non-unit diagonal, {BM}/1 B={B}: "
          f"{lower_div_ms:.4f} ms  [{smi}]")
    rows_by["trsm_loop"]["block_jacobi"] = {
        "shape": f"{BM}/1 B={B}", "lower_unit": solves["L"],
        "upper": solves["U"], "lower_ms": lower_div_ms}
    del lu1, r1

    # -- 16c. the whole getrf call: tensors on the card, and numpy f64 ------
    kern = xp.getrf_dispatch(M, M, batch=B)
    call_ms = cuda_time_ms(kern, a32, warmup=2, iters=10)
    kern64 = xp.getrf_dispatch(M, M, dtype="float64", batch=B)
    whole, steps = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern64(a_np)
        whole.append(time.perf_counter() - t0)
        t = [time.perf_counter()]
        ad = torch.from_numpy(np.asarray(a_np, np.float32)).to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ap = pack(ad)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        lu = pk.getrf_unrolled(ap)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = lu.permute(2, 0, 1).contiguous()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out.cpu().numpy().astype(np.float64)
        t.append(time.perf_counter())
        steps.append([t[i + 1] - t[i] for i in range(5)])
    med = sorted(whole)[2] * 1e3
    parts = np.median(np.array(steps), axis=0) * 1e3
    print(f"call  getrf_dispatch({M}, {M}, batch={B})(a): f32 tensor on the "
          f"card {call_ms:.4f} ms (CUDA events, kernel "
          f"{rows[0]['ms']:.4f} ms); f64 numpy in and out {med:.3f} ms "
          f"(median of 5, host clock); steps (median): copy in "
          f"{parts[0]:.3f}, pack {parts[1]:.3f}, kernel {parts[2]:.3f}, "
          f"unpack {parts[3]:.3f}, copy out {parts[4]:.3f} ms  [{smi}]")
    return rows


def rnn_gold(np, act, ct, x, w, r, b, h0, c0):
    """The cell's recurrence in numpy f64 (tests/test_dnn.py:323-336 for the
    LSTM, :603-614 for the GRU): (hs, h_T, c_T, residuals), the residuals
    those of forward_train (LSTM cs, i, g, f, o; GRU ri, zi, gi, zr_g)."""
    x, w, r, b, h, c = (np.asarray(v, np.float64) for v in (x, w, r, b, h0,
                                                            c0))
    t, n, _ = x.shape
    k = h.shape[1]
    sig = lambda z: 1 / (1 + np.exp(-z))
    zx = (x.reshape(t * n, -1) @ w + b).reshape(t, n, -1)
    hs, res = [], []
    for ti in range(t):
        if ct == "lstm":
            z = zx[ti] + h @ r
            i, g = sig(z[:, :k]), np.tanh(z[:, k:2 * k])
            f, o = sig(z[:, 2 * k:3 * k]), sig(z[:, 3 * k:])
            c = f * c + i * g
            h = o * np.tanh(c)
            res.append((c, i, g, f, o))
        elif ct == "gru":
            zr = h @ r
            ri = sig(zx[ti][:, :k] + zr[:, :k])
            zi = sig(zx[ti][:, k:2 * k] + zr[:, k:2 * k])
            gi = np.tanh(zx[ti][:, 2 * k:] + ri * zr[:, 2 * k:])
            h = (1 - zi) * gi + zi * h
            res.append((ri, zi, gi, zr[:, 2 * k:]))
        else:
            a = zx[ti] + h @ r
            h = {"relu": lambda v: np.maximum(v, 0), "sigmoid": sig,
                 "tanh": np.tanh}[act](a)
        hs.append(h)
    return np.stack(hs), h, c, [np.stack(v) for v in zip(*res)]


def rnn_phase(args, dev, smi):
    """Steps 18 to 20 of the module docstring; returns the RNN kernels' rows
    of the ``{"kernels": [...]}`` line."""
    import numpy as np
    import torch
    import xsmm_tpu_torch as xp
    from xsmm_tpu_torch.dnn import (CellType, RnnDesc, create_rnncell,
                                    rnn_params_from_numpy)
    from xsmm_tpu_torch.dnn import rnn_seq as rs
    from xsmm_tpu_torch.dnn import rnncell
    from xsmm_tpu_torch.utils.timer import cuda_time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    N, C, K, T = (int(v) for v in args.rnn_shape.split(","))
    f32, bf16 = torch.float32, torch.bfloat16
    kinds = {CellType.LSTM: ("lstm", 4, "lstm_seq"),
             CellType.GRU: ("gru", 3, "gru_seq"),
             CellType.RNN_RELU: ("relu", 1, "rnn_seq"),
             CellType.RNN_SIGMOID: ("sigmoid", 1, "rnn_seq"),
             CellType.RNN_TANH: ("tanh", 1, "rnn_seq")}
    cases = {}   # (cell type, shape) -> inputs, device tensors and gold

    def inputs(ct, shape):
        """numpy inputs from the seed (x ~ N(0,1); weights x0.1 as
        samples/lstm_driver.py:37-38; small random b, h0 and c0), the
        same on the card, and the f64 gold; made once per cell and shape."""
        key = (ct, shape)
        if key not in cases:
            name, g, _ = kinds[ct]
            n, c, k, t = shape
            rng = np.random.default_rng(args.seed + 10 + len(cases))
            x = rng.standard_normal((t, n, c)).astype(np.float32)
            w, r = ((rng.standard_normal(s) * 0.1).astype(np.float32)
                    for s in ((c, g * k), (k, g * k)))
            b = (rng.standard_normal(g * k) * 0.1).astype(np.float32)
            h0, c0 = ((rng.standard_normal((n, k)) * 0.1).astype(np.float32)
                      for _ in range(2))
            wd, rd, bd = rnn_params_from_numpy(w, r, b)
            cell = name if g > 1 else "rnn"
            cases[key] = dict(
                np=(x, w, r, b, h0, c0),
                dev=(torch.from_numpy(x).to(dev), wd, rd, bd,
                     torch.from_numpy(h0).to(dev),
                     torch.from_numpy(c0).to(dev)),
                gold=rnn_gold(np, name, cell, x, w, r, b, h0, c0))
        return cases[key]

    def rel(gold, got):
        got = np.asarray(got.double().cpu().numpy() if isinstance(
            got, torch.Tensor) else got, np.float64)
        if got.shape != gold.shape:
            raise RuntimeError(f"shape {got.shape} != {gold.shape}")
        if not np.isfinite(got).all():
            raise RuntimeError("non-finite output")
        return np.linalg.norm(got - gold) / max(np.linalg.norm(gold), 1e-300)

    def gate(label, err, tol, what="gold"):
        ok = err <= tol
        print(f"{what:5s} {label:44s} rel-Frobenius {err:.3e} (tol {tol:g}) "
              f"{'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: {err:.3e} > {tol:g} against {what}")

    # -- 18. the RNN path through its entry points, counted ------------------
    full, ragged = (N, C, K, T), (100, 200, 300, 5)
    drive = []   # (cell type, dtype, shape, train, numpy inputs)
    for ct in (CellType.LSTM, CellType.GRU, CellType.RNN_TANH):
        for dt in ("float32", "bfloat16"):
            drive += [(ct, dt, full, False, False), (ct, dt, full, True, False)]
    for ct in (CellType.RNN_RELU, CellType.RNN_SIGMOID):
        for dt in ("float32", "bfloat16"):
            drive.append((ct, dt, (N, C, K, 8), False, False))
    for ct in CellType:
        drive.append((ct, "float32", ragged, False, True))
    for ct in (CellType.LSTM, CellType.GRU):
        drive += [(ct, "bfloat16", ragged, False, True),
                  (ct, "float32", ragged, True, True)]
    for ct in (CellType.LSTM, CellType.GRU, CellType.RNN_TANH):
        drive.append((ct, "float32", (N, C, K, 1), False, False))
    drive.append((CellType.LSTM, "float32", (N, C, K, 1), True, False))

    totals = dict.fromkeys(RNN_REPLACES, 0)
    t0 = time.perf_counter()
    for ct, dt, shape, train, numpy_in in drive:
        name, g, kname = kinds[ct]
        n, c, k, t = shape
        case = inputs(ct, shape)
        cell = create_rnncell(RnnDesc(n=n, c=c, k=k, max_t=t, cell_type=ct,
                                      in_dtype=dt, out_dtype=dt))
        ins = case["np"] if numpy_in else case["dev"]
        rs.reset_launches()
        rnncell.reset_scan_calls()
        if train:
            (hs, h_t, c_t), saved = cell.forward_train(*ins)
        else:
            hs, h_t, c_t = cell.forward(*ins)
        torch.cuda.synchronize()
        got = {k_: v for k_, v in rs.launches.items() if v}
        trained = {k_: v for k_, v in rs.train_launches.items() if v}
        label = (f"{'forward_train' if train else 'forward'} {ct.value} {dt} "
                 f"N{n} C{c} K{k} T{t}" + (" numpy" if numpy_in else ""))
        want_train = {kname: 1} if train and g > 1 else {}
        if (got != {kname: 1} or trained != want_train
                or any(rnncell.scan_calls.values())):
            raise RuntimeError(f"{label}: launched {got}, train form "
                               f"{trained}, scan route {rnncell.scan_calls}")
        totals[kname] += 1
        if hs.dtype != (bf16 if dt == "bfloat16" else f32) or hs.device != dev:
            raise RuntimeError(f"{label}: hs {hs.dtype} on {hs.device}")
        ghs, gh, gc, gres = case["gold"]
        tol = RNN_GOLD_TOL[dt]
        errs = [rel(ghs, hs), rel(gh, h_t)] + ([rel(gc, c_t)] if g == 4
                                                else [])
        if train and g > 1:
            errs += [rel(gv, v) for gv, v in zip(gres, saved[-1])]
        print(f"drive {label:44s} launches {got} train {trained} scan 0")
        gate(label + (" (hs, states, residuals)" if train and g > 1
                      else " (hs, states)"), max(errs), tol)
    main_s = time.perf_counter() - t0
    print(f"rnn path: {len(drive)} calls in {main_s:.2f} s; launches "
          f"{totals}  [{smi}]")
    for kname, n_ in totals.items():
        if n_ < 1:
            raise RuntimeError(f"{kname} was not launched on the RNN path")

    # -- 18b. hs against cuDNN, outside the path -------------------------------
    def cudnn(ct, shape, dtype):
        """torch.nn.LSTM/GRU/RNN with the cell's weights: the gate blocks
        (i, g, f, o) become torch's (i, f, g, o) as
        xsmm_tpu/bindings/torch_lstm.py:163-174 does; b goes into bias_ih,
        bias_hh is zero (for the GRU that is exactly the cell)."""
        name, g, _ = kinds[ct]
        _, c, k, _ = shape
        x, w, r, b, h0, c0 = cases[(ct, shape)]["dev"]
        if ct == CellType.LSTM:
            mod, perm = torch.nn.LSTM(c, k), (0, 2, 1, 3)
        elif ct == CellType.GRU:
            mod, perm = torch.nn.GRU(c, k), (0, 1, 2)
        else:
            mod, perm = torch.nn.RNN(c, k, nonlinearity=name), (0,)

        def blocks(a):
            return torch.cat([a[..., p * k:(p + 1) * k] for p in perm], -1)
        mod = mod.to(dev)
        with torch.no_grad():
            mod.weight_ih_l0.copy_(blocks(w).T)
            mod.weight_hh_l0.copy_(blocks(r).T)
            mod.bias_ih_l0.copy_(blocks(b))
            mod.bias_hh_l0.zero_()
        mod = mod.to(dtype)
        xs, hx = x.to(dtype), h0[None].to(dtype)
        hx = (hx, c0[None].to(dtype)) if g == 4 else hx

        def run():
            with torch.no_grad():
                return mod(xs, hx)[0]
        return run

    lib_ms = {}
    for ct, shape in [(CellType.LSTM, full), (CellType.GRU, full),
                      (CellType.RNN_TANH, full),
                      (CellType.RNN_RELU, (N, C, K, 8))]:
        for dt, dtype in (("float32", f32), ("bfloat16", bf16)):
            n, c, k, t = shape
            cell = create_rnncell(RnnDesc(n=n, c=c, k=k, max_t=t, cell_type=ct,
                                          in_dtype=dt, out_dtype=dt))
            hs = cell.forward(*cases[(ct, shape)]["dev"])[0]
            run = cudnn(ct, shape, dtype)
            ref = run()
            torch.cuda.synchronize()
            gate(f"{ct.value} {dt} hs vs torch.nn (cuDNN) T{t}",
                 rel(ref.double().cpu().numpy(), hs), RNN_GOLD_TOL[dt],
                 "cudnn")
            if shape == full:
                lib_ms[(ct, dt)] = cuda_time_ms(run, warmup=3, iters=20)
    print("cudnn RNN_SIGMOID: no torch.nn counterpart (nn.RNN takes tanh and "
          "relu only)")

    # -- 19. each kernel against its plain version, same operands -----------
    ops = {}
    for ct in (CellType.LSTM, CellType.GRU, CellType.RNN_TANH):
        name, g, kname = kinds[ct]
        x, w, r, b, h0, c0 = cases[(ct, full)]["dev"]
        zx = (x.reshape(T * N, C) @ w + b).reshape(T, N, g * K)
        for rdt in (f32, bf16):
            ops[(kname, rdt)] = (zx, r.to(rdt), h0, c0)

    def call(kname, rdt, train, plain=False):
        zx, r, h0, c0 = ops[(kname, rdt)]
        sfx = "_plain" if plain else ""
        if kname == "lstm_seq":
            return getattr(rs, kname + sfx)(zx, r, h0, c0, train=train)
        if kname == "gru_seq":
            return getattr(rs, kname + sfx)(zx, r, h0, train=train)
        return getattr(rs, kname + sfx)(zx, r, h0, act="tanh")

    max_abs = dict.fromkeys(RNN_REPLACES, 0.0)
    for kname in RNN_REPLACES:
        for rdt in (f32, bf16):
            for train in ((False, True) if kname != "rnn_seq" else (False,)):
                got = call(kname, rdt, train)
                want = call(kname, rdt, train, plain=True)
                torch.cuda.synchronize()
                dt = "float32" if rdt == f32 else "bfloat16"
                err = max((g_.double() - w_.double()).abs().max().item()
                          for g_, w_ in zip(got, want))
                relf = max(rel(w_.double().cpu().numpy(), g_)
                           for g_, w_ in zip(got, want))
                exact = all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
                max_abs[kname] = max(max_abs[kname], err)
                print(f"plain {kname:8s} R {dt:8s} "
                      f"{'train' if train else 'infer'} max_abs_err "
                      f"{err:.3e}" + (" (bit-exact)" if exact else ""))
                gate(f"{kname} R {dt} {'train' if train else 'inference'} "
                     f"vs plain", relf, RNN_PLAIN_TOL[dt], "plain")
                del got, want

    # -- 20. times: kernels, plain versions, the whole call, cuDNN -----------
    def bound(kname, g, rdt, train):
        """(bound ms, bound by) at the full shape: each input read once and
        each output written once; h@R's 2*T*N*K*G*K operations at the FP32
        or bf16 peak."""
        nres = {"lstm_seq": 5, "gru_seq": 4}.get(kname, 0) if train else 0
        states = 2 if kname == "lstm_seq" else 1
        nbytes = (4 * T * N * g * K + rdt.itemsize * K * g * K
                  + 4 * states * N * K * 2 + 4 * T * N * K * (1 + nres))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        peak = FP32_FLOP_PER_S if rdt == f32 else BF16_FLOP_PER_S
        t_ops = 2 * T * N * K * g * K / peak * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    rows = []
    for ct in (CellType.LSTM, CellType.GRU, CellType.RNN_TANH):
        name, g, kname = kinds[ct]
        module = {"lstm": "LSTM", "gru": "GRU"}.get(name, "RNN")
        row = {"name": kname, "route": "cuda", "source": RNN_SOURCE,
               "replaces": RNN_REPLACES[kname], "launches": totals[kname],
               "max_abs_err": max_abs[kname], "check": "pass",
               "shape": f"N{N} C{C} K{K} T{T}",
               "library": f"torch.nn.{module} (cuDNN), the whole forward"}
        flops = 2 * T * N * (C + K) * g * K
        for dt, rdt in (("float32", f32), ("bfloat16", bf16)):
            form = rs.seq_form(N, K, g, rdt.itemsize)
            print(f"grid  {kname:8s} {dt:8s} {form['blocks']} blocks on "
                  f"{min(form['blocks'], form['sms'])} of {form['sms']} SMs "
                  f"({form['column_blocks']} column blocks x "
                  f"{form['blocks'] // form['column_blocks']} row blocks, "
                  f"{form['passes']} pass(es) of {form['rows']} rows), "
                  f"{form['form']} form, product on FFMA")
            row[f"grid{'' if rdt == f32 else '_bf16'}"] = form["blocks"]
            row[f"form{'' if rdt == f32 else '_bf16'}"] = form["form"]
            ms = cuda_time_ms(call, kname, rdt, False, warmup=3, iters=20)
            ms_train = (cuda_time_ms(call, kname, rdt, True, warmup=3,
                                     iters=20) if g > 1 else ms)
            plain_ms = cuda_time_ms(call, kname, rdt, False, True, warmup=1,
                                    iters=3 if rdt == f32 else 1)
            bound_ms, bound_by = bound(kname, g, rdt, False)
            cell = create_rnncell(RnnDesc(n=N, c=C, k=K, max_t=T,
                                          cell_type=ct, in_dtype=dt,
                                          out_dtype=dt))
            call_ms = cuda_time_ms(cell.forward, *cases[(ct, full)]["dev"],
                                   warmup=3, iters=20)
            lms = lib_ms[(ct, dt)]
            print(f"time  {kname:8s} {dt:8s} kernel {ms:.4f} ms "
                  f"({ms * 1e3 / T:.2f} us/step; train form {ms_train:.4f} "
                  f"ms), bound {bound_ms:.4f} ms ({bound_by}), share "
                  f"{bound_ms / ms:.3f}; plain {plain_ms:.3f} ms; forward "
                  f"call {call_ms:.4f} ms = {flops / call_ms / 1e9:.2f} "
                  f"TFLOP/s; cuDNN {lms:.4f} ms = {flops / lms / 1e9:.2f} "
                  f"TFLOP/s  [{smi}]")
            sfx = "" if dt == "float32" else "_bf16"
            row.update({f"ms{sfx}": ms, f"ms_train{sfx}": ms_train,
                        f"us_per_step{sfx}": ms * 1e3 / T,
                        f"plain_ms{sfx}": plain_ms,
                        f"bound_ms{sfx}": bound_ms,
                        f"bound_by{sfx}": bound_by,
                        f"call_ms{sfx}": call_ms,
                        f"library_ms{sfx}": lms})
        rows.append(row)
    return rows


def rnn_bwd_gold(torch, dev, kind, act, x, w, r, b, h0, c0, dhs):
    """The gradients (dx, dw, dr, db, dh0, dc0) of sum(hs * dhs) by torch
    autograd through a plain f64 loop of the cell's recurrence on the card,
    independent of the port (c0 unused for the GRU and the RNN: zeros)."""
    f64 = torch.float64
    leaves = [torch.from_numpy(v).to(dev, f64).requires_grad_()
              for v in (x, w, r, b, h0, c0)]
    x, w, r, b, h, c = leaves
    t, n, _ = x.shape
    k = h.shape[1]
    zx = (x.reshape(t * n, -1) @ w + b).reshape(t, n, -1)
    hs = []
    for ti in range(t):
        if kind == "lstm":
            z = zx[ti] + h @ r
            i, g = torch.sigmoid(z[:, :k]), torch.tanh(z[:, k:2 * k])
            f, o = torch.sigmoid(z[:, 2 * k:3 * k]), torch.sigmoid(z[:, 3 * k:])
            c = f * c + i * g
            h = o * torch.tanh(c)
        elif kind == "gru":
            zr = h @ r
            ri = torch.sigmoid(zx[ti][:, :k] + zr[:, :k])
            zi = torch.sigmoid(zx[ti][:, k:2 * k] + zr[:, k:2 * k])
            gi = torch.tanh(zx[ti][:, 2 * k:] + ri * zr[:, 2 * k:])
            h = (1 - zi) * gi + zi * h
        else:
            h = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                 "tanh": torch.tanh}[act](zx[ti] + h @ r)
        hs.append(h)
    loss = (torch.stack(hs) * torch.from_numpy(dhs).to(dev, f64)).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [(torch.zeros_like(v) if g is None else g).cpu().numpy()
            for g, v in zip(grads, leaves)]


def rnn_bwd_phase(args, dev, smi):
    """Steps 21 to 23 of the module docstring; returns the RNN backward
    kernels' rows of the ``{"kernels": [...]}`` line."""
    import numpy as np
    import torch
    from xsmm_tpu_torch.bindings import XsmmLSTM
    from xsmm_tpu_torch.dnn import (CellType, Kind, RnnDesc, create_rnncell,
                                    rnn_params_from_numpy)
    from xsmm_tpu_torch.dnn import rnn_seq as rs
    from xsmm_tpu_torch.dnn import rnncell
    from xsmm_tpu_torch.utils.timer import cuda_time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    N, C, K, T = (int(v) for v in args.rnn_shape.split(","))
    f32, bf16 = torch.float32, torch.bfloat16
    kinds = {CellType.LSTM: ("lstm", 4, "lstm_seq"),
             CellType.GRU: ("gru", 3, "gru_seq"),
             CellType.RNN_RELU: ("relu", 1, "rnn_seq"),
             CellType.RNN_SIGMOID: ("sigmoid", 1, "rnn_seq"),
             CellType.RNN_TANH: ("tanh", 1, "rnn_seq")}
    cases = {}   # (cell type, shape) -> inputs, dhs and f64 gold

    def inputs(ct, shape):
        """numpy inputs and dhs from the seed (weights x0.1 as
        samples/lstm_driver.py:37-38, but for the relu cell's R; small
        random b, h0 and c0), the same on the card, and the f64 gradients;
        made once per cell and shape."""
        key = (ct, shape)
        if key not in cases:
            name, g, _ = kinds[ct]
            n, c, k, t = shape
            rng = np.random.default_rng(args.seed + 100 + len(cases))
            x = rng.standard_normal((t, n, c)).astype(np.float32)
            w, r = ((rng.standard_normal(s) * 0.1).astype(np.float32)
                    for s in ((c, g * k), (k, g * k)))
            if ct == CellType.RNN_RELU:
                # torch.nn.RNN's init bound: with x0.1 a relu recurrence
                # of width 512 grows ~4x a step, and the rounding of bf16
                # with it (1.2e-1 from the f64 gradients at T 8)
                r = rng.uniform(-k ** -0.5, k ** -0.5, (k, k)).astype(
                    np.float32)
            b = (rng.standard_normal(g * k) * 0.1).astype(np.float32)
            h0, c0 = ((rng.standard_normal((n, k)) * 0.1).astype(np.float32)
                      for _ in range(2))
            dhs = rng.standard_normal((t, n, k)).astype(np.float32)
            wd, rd, bd = rnn_params_from_numpy(w, r, b)
            kind = name if g > 1 else "rnn"
            cases[key] = dict(
                np=(x, w, r, b, h0, c0), dhs_np=dhs,
                dev=(torch.from_numpy(x).to(dev), wd, rd, bd,
                     torch.from_numpy(h0).to(dev),
                     torch.from_numpy(c0).to(dev)),
                dhs=torch.from_numpy(dhs).to(dev),
                gold=rnn_bwd_gold(torch, dev, kind, name, x, w, r, b, h0, c0,
                                  dhs))
        return cases[key]

    def rel(want, got):
        got = np.asarray(got.double().cpu().numpy() if isinstance(
            got, torch.Tensor) else got, np.float64)
        want = np.asarray(want.double().cpu().numpy() if isinstance(
            want, torch.Tensor) else want, np.float64)
        if got.shape != want.shape:
            raise RuntimeError(f"shape {got.shape} != {want.shape}")
        if not np.isfinite(got).all():
            raise RuntimeError("non-finite output")
        return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)

    def gate(label, err, tol, what="gold"):
        ok = err <= tol
        print(f"{what:5s} {label:52s} rel-Frobenius {err:.3e} (tol {tol:g}) "
              f"{'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: {err:.3e} > {tol:g} against {what}")

    def check_grads(label, gold, grads, tol, what="gold"):
        """Each of the six gradients against ``gold``; one that is zero in
        ``gold`` (dc0 of the GRU and the RNN) must be exactly zero."""
        errs = []
        for name, want, got in zip(GRAD_NAMES, gold, grads):
            if not np.any(want):
                if got.shape != want.shape or bool(got.any()):
                    raise RuntimeError(f"{label}: {name} is not zero")
                continue
            errs.append(rel(want, got))
        gate(label, max(errs), tol, what)

    def nonzero(counts):
        return {k_: v for k_, v in counts.items() if v}

    # -- 21. the training path through its entry points, counted ------------
    full, ragged = (N, C, K, T), (100, 200, 300, 5)
    drive = []   # (cell type, dtype, shape, call, numpy inputs)
    calls = ("backward_from_saved", "backward_weight_update", "execute",
             "autograd")
    for ct in (CellType.LSTM, CellType.GRU, CellType.RNN_TANH):
        for dt in ("float32", "bfloat16"):
            drive += [(ct, dt, full, cl, False) for cl in calls]
    for ct in (CellType.RNN_RELU, CellType.RNN_SIGMOID):
        for dt in ("float32", "bfloat16"):
            drive.append((ct, dt, (N, C, K, 8), calls[0], False))
    for ct in CellType:
        drive.append((ct, "float32", ragged, calls[0], True))
    for ct in (CellType.LSTM, CellType.GRU):
        drive.append((ct, "bfloat16", ragged, calls[0], True))
    for ct in (CellType.LSTM, CellType.GRU, CellType.RNN_TANH):
        drive.append((ct, "float32", (N, C, K, 1), calls[0], False))
    drive.append((CellType.LSTM, "float32", full, "XsmmLSTM", False))

    totals = dict.fromkeys(RNN_BWD_REPLACES, 0)
    t0 = time.perf_counter()
    for ct, dt, shape, call, numpy_in in drive:
        name, g, kname = kinds[ct]
        n, c, k, t = shape
        case = inputs(ct, shape)
        cell = create_rnncell(RnnDesc(n=n, c=c, k=k, max_t=t, cell_type=ct,
                                      in_dtype=dt, out_dtype=dt))
        x, w, r, b, h0, c0 = case["np"] if numpy_in else case["dev"]
        dhs = case["dhs_np"] if numpy_in else case["dhs"]
        want_fwd = {kname: 1}
        if call == "backward_from_saved":
            _, saved = cell.forward_train(x, w, r, b, h0, c0)
            torch.cuda.synchronize()
            want_fwd = {}
        leaves = [v.detach().clone().requires_grad_() for v in case["dev"]]
        if call == "XsmmLSTM":
            mod = XsmmLSTM(c, k)
            with torch.no_grad():
                for p, v in zip((mod.w, mod.r, mod.b), leaves[1:4]):
                    p.copy_(v)
        rs.reset_launches()
        rnncell.reset_scan_calls()
        if call == "backward_from_saved":
            grads = cell.backward_from_saved(saved, dhs)
        elif call == "backward_weight_update":
            grads = cell.backward_weight_update(x, w, r, b, dhs, h0, c0)
        elif call == "execute":
            grads = cell.execute(Kind.BWD, input=x, weight=w, recur_weight=r,
                                 bias=b, grad_hidden=dhs, h0=h0, c0=c0)
        elif call == "autograd":
            hs, _, _ = cell.forward(*leaves)
            (hs.float() * dhs).sum().backward()
            grads = [v.grad if v.grad is not None else torch.zeros_like(v)
                     for v in leaves]
        else:
            hs, _ = mod(leaves[0], leaves[4], leaves[5])
            (hs * dhs).sum().backward()
            grads = [leaves[0].grad, mod.w.grad, mod.r.grad, mod.b.grad,
                     leaves[4].grad, leaves[5].grad]
        torch.cuda.synchronize()
        got_b, got_f = nonzero(rs.bwd_launches), nonzero(rs.launches)
        got_t = nonzero(rs.train_launches)
        label = (f"{call} {ct.value} {dt} N{n} C{c} K{k} T{t}"
                 + (" numpy" if numpy_in else ""))
        if (got_b != {kname + "_bwd": 1} or got_f != want_fwd
                or got_t != (want_fwd if g > 1 else {})
                or any(rnncell.scan_calls.values())
                or any(rnncell.bwd_scan_calls.values())):
            raise RuntimeError(
                f"{label}: backward {got_b}, forward {got_f} (train form "
                f"{got_t}), scan routes {rnncell.scan_calls} "
                f"{rnncell.bwd_scan_calls}")
        totals[kname + "_bwd"] += 1
        if any(gr.device != dev or gr.dtype != f32 for gr in grads):
            raise RuntimeError(f"{label}: gradients not f32 on {dev}")
        print(f"drive {label:52s} backward {got_b} forward {got_f} scan 0")
        check_grads(label + " (6 gradients)", case["gold"], grads,
                    RNN_GOLD_TOL[dt])
    main_s = time.perf_counter() - t0
    print(f"rnn training path: {len(drive)} calls in {main_s:.2f} s; "
          f"backward launches {totals}  [{smi}]")
    for kname, n_ in totals.items():
        if n_ < 1:
            raise RuntimeError(f"{kname} was not launched on the RNN path")

    # -- 21b. the gradients against cuDNN's backward, outside the path -------
    def cudnn(ct, dtype):
        """torch.nn.LSTM/GRU/RNN with the cell's weights (the gate blocks
        (i, g, f, o) become torch's (i, f, g, o); b into bias_ih, bias_hh
        zero), its inputs as leaves, and a function of the six gradients of
        sum(hs * dhs) in the cell's layout (the gate shuffle is its own
        inverse)."""
        name, g, _ = kinds[ct]
        x, w, r, b, h0, c0 = cases[(ct, full)]["dev"]
        if ct == CellType.LSTM:
            mod, perm = torch.nn.LSTM(C, K), (0, 2, 1, 3)
        elif ct == CellType.GRU:
            mod, perm = torch.nn.GRU(C, K), (0, 1, 2)
        else:
            mod, perm = torch.nn.RNN(C, K, nonlinearity=name), (0,)

        def blocks(a):
            return torch.cat([a[..., p * K:(p + 1) * K] for p in perm], -1)
        mod = mod.to(dev)
        with torch.no_grad():
            mod.weight_ih_l0.copy_(blocks(w).T)
            mod.weight_hh_l0.copy_(blocks(r).T)
            mod.bias_ih_l0.copy_(blocks(b))
            mod.bias_hh_l0.zero_()
        mod = mod.to(dtype)
        xs = x.to(dtype).requires_grad_()
        hx = [h0[None].to(dtype).requires_grad_()]
        if g == 4:
            hx.append(c0[None].to(dtype).requires_grad_())
        params = [mod.weight_ih_l0, mod.weight_hh_l0, mod.bias_ih_l0]
        gout = cases[(ct, full)]["dhs"].to(dtype)
        wrt = [xs, *params, *hx]

        def fwd():
            return mod(xs, tuple(hx) if g == 4 else hx[0])[0]

        def grads(out):
            gx, gw, gr, gb, gh, *gc = torch.autograd.grad(
                out, wrt, grad_outputs=gout, retain_graph=True)
            return [gx, blocks(gw.T), blocks(gr.T), blocks(gb), gh[0],
                    gc[0][0] if gc else torch.zeros_like(gh[0])]
        return fwd, grads, wrt, gout

    lib = {}
    for ct in (CellType.LSTM, CellType.GRU, CellType.RNN_TANH):
        x, w, r, b, h0, c0 = cases[(ct, full)]["dev"]
        for dt, dtype in (("float32", f32), ("bfloat16", bf16)):
            cell = create_rnncell(RnnDesc(n=N, c=C, k=K, max_t=T, cell_type=ct,
                                          in_dtype=dt, out_dtype=dt))
            mine = cell.backward_weight_update(x, w, r, b,
                                               cases[(ct, full)]["dhs"], h0,
                                               c0)
            fwd, grads, wrt, gout = cudnn(ct, dtype)
            out = fwd()
            theirs = grads(out)
            torch.cuda.synchronize()
            check_grads(f"{ct.value} {dt} gradients vs torch.nn (cuDNN) T{T}",
                        [v.double().cpu().numpy() for v in theirs], mine,
                        RNN_GOLD_TOL[dt], "cudnn")
            # in bf16 both sides round on their own: cuDNN's distance from
            # the f64 gradients says how much of the gap above is its own
            own = max(rel(want, got) for want, got in
                      zip(cases[(ct, full)]["gold"], theirs) if np.any(want))
            print(f"cudnn {ct.value} {dt} cuDNN's own gradients vs gold "
                  f"rel-Frobenius {own:.3e}")

            def bwd_only(out=out, wrt=wrt, gout=gout):
                torch.autograd.grad(out, wrt, grad_outputs=gout,
                                    retain_graph=True)

            def step(fwd=fwd, wrt=wrt, gout=gout):
                torch.autograd.grad(fwd(), wrt, grad_outputs=gout)
            lib[(ct, dt)] = (cuda_time_ms(bwd_only, warmup=3, iters=20),
                             cuda_time_ms(step, warmup=3, iters=20))
            del out

    # -- 21c. repeatability: the case of a card test that once missed its
    # tolerance (RNN_TANH f32, N 37 C 50 K 70 T 4), 1000 times ---------------
    import xsmm_tpu_torch as xp
    from xsmm_tpu_torch.ops.smm import _matmul
    n, c, k, t = 37, 50, 70, 4
    rng = np.random.default_rng(34)
    x = rng.standard_normal((t, n, c)).astype(np.float32)
    w, r = ((rng.standard_normal(s) * 0.1).astype(np.float32)
            for s in ((c, k), (k, k)))
    b = rng.standard_normal(k).astype(np.float32)
    h0 = rng.standard_normal((n, k)).astype(np.float32) * 0.1
    desc = RnnDesc(n=n, c=c, k=k, max_t=t, cell_type=CellType.RNN_TANH)
    cell = create_rnncell(desc)
    xd = torch.from_numpy(x).to(dev).reshape(t * n, c)
    wd = torch.from_numpy(w).to(dev)
    hs0, zx0 = cell.forward(x, w, r, b, h0)[0].clone(), _matmul(xd, wd)
    hs_var = zx_var = 0
    for _ in range(1000):
        hs_var += not torch.equal(cell.forward(x, w, r, b, h0)[0], hs0)
        zx_var += not torch.equal(_matmul(xd, wd), zx0)
    target = xp.get_config().target
    xp.set_config(target="cpu")
    # the CPU call keeps its own products (x@W, each step's h@R) for the
    # diagnosis, which must not recompute them
    from xsmm_tpu_torch.dnn.fault2_stress import products_report
    from xsmm_tpu_torch.dnn.rnn_seq import keep_products
    with keep_products() as kept:
        cpu = create_rnncell(desc).forward(x, w, r, b, h0)[0]
    xp.set_config(target=target)
    err = rel(cpu, hs0)
    print(f"repeat rnn_tanh f32 N{n} C{c} K{k} T{t}: hs differed in {hs_var} "
          f"of 1000 calls, x@W in {zx_var} of 1000; card vs CPU "
          f"rel-Frobenius {err:.3e}")
    if err > 1e-5:  # the failing call's own products first, then the side
        # and the CPU's products recomputed and its tanh
        print("  " + products_report(kept, "the cpu forward"))
        gold = rnn_gold(np, "tanh", "rnn", x, w, r, b, h0,
                        np.zeros_like(h0))[0]
        xp.set_config(target="cpu")
        again = create_rnncell(desc).forward(x, w, r, b, h0)[0]
        xp.set_config(target=target)
        xc = torch.from_numpy(x.reshape(t * n, c))
        zx, hr = _matmul(xc, torch.from_numpy(w)), _matmul(
            torch.from_numpy(h0), torch.from_numpy(r))
        arg = (zx[:n] + torch.from_numpy(b)) + hr
        tanh_err = (torch.tanh(arg).double() - torch.from_numpy(
            np.tanh(arg.double().numpy()))).abs().max().item()
        print(f"  card vs gold {rel(torch.from_numpy(gold), hs0.cpu()):.3e}, "
              f"cpu vs gold {rel(torch.from_numpy(gold), cpu):.3e}, cpu "
              f"again vs gold {rel(torch.from_numpy(gold), again):.3e}; cpu "
              f"x@W vs f64 {rel(torch.from_numpy(x.reshape(t * n, c) @ w.astype(np.float64)), zx):.3e}, "
              f"h0@R vs f64 {rel(torch.from_numpy(h0 @ r.astype(np.float64)), hr):.3e}, "
              f"tanh worst abs {tanh_err:.3e}; threads "
              f"{torch.get_num_threads()}")
    if hs_var or zx_var or err > 1e-5:
        raise RuntimeError("the RNN forward is not repeatable on the card")

    # -- 22. each backward kernel against its plain version ------------------
    ops = {}
    for ct in (CellType.LSTM, CellType.GRU, CellType.RNN_TANH):
        name, g, kname = kinds[ct]
        for dt, rdt in (("float32", f32), ("bfloat16", bf16)):
            cell = create_rnncell(RnnDesc(n=N, c=C, k=K, max_t=T, cell_type=ct,
                                          in_dtype=dt, out_dtype=dt))
            _, saved = cell.forward_train(*cases[(ct, full)]["dev"])
            xt_f, w_or_wr = saved[0], saved[1]
            r = w_or_wr[C:] if g == 4 else saved[2]
            rt = r.t().to(rdt).contiguous()
            z = torch.zeros((N, K), device=dev)
            dhs = cases[(ct, full)]["dhs"]
            if g == 4:
                _, _, h0, c0, hs, (cs, i, gg, f, o) = saved
                args_ = (dhs, i, gg, f, o, cs, c0, z, z, rt)
            elif g == 3:
                _, _, _, h0, hs, res = saved
                args_ = (dhs, *res, hs, h0, z, rt)
            else:
                args_ = (dhs, saved[4], z, rt)
            ops[(kname, rdt)] = args_

    def call(kname, rdt, plain=False):
        fn = getattr(rs, kname + "_bwd" + ("_plain" if plain else ""))
        kw = {"act": "tanh"} if kname == "rnn_seq" else {}
        return fn(*ops[(kname, rdt)], dz_dt=rdt, **kw)

    max_abs = dict.fromkeys(RNN_BWD_REPLACES, 0.0)
    for kname in ("lstm_seq", "gru_seq", "rnn_seq"):
        for dt, rdt in (("float32", f32), ("bfloat16", bf16)):
            got = call(kname, rdt)
            want = call(kname, rdt, plain=True)
            torch.cuda.synchronize()
            err = max((g_.double() - w_.double()).abs().max().item()
                      for g_, w_ in zip(got, want))
            relf = max(rel(w_, g_) for g_, w_ in zip(got, want))
            exact = [torch.equal(g_, w_) for g_, w_ in zip(got, want)]
            max_abs[kname + "_bwd"] = max(max_abs[kname + "_bwd"], err)
            print(f"plain {kname + '_bwd':12s} R {dt:8s} max_abs_err "
                  f"{err:.3e}; bit-exact by output {exact}")
            gate(f"{kname}_bwd R {dt} vs plain", relf, RNN_PLAIN_TOL[dt],
                 "plain")
            if dt == "bfloat16" and not all(exact):
                raise RuntimeError(f"{kname}_bwd R bf16: not bit for bit "
                                   f"against its plain version ({exact})")
            del got, want

    # -- 23. times: kernels, plain versions, the whole calls, cuDNN ----------
    def bound(g, rdt):
        """(bound ms, bound by) at the full shape: dhs and the residuals
        (LSTM i, g, f, o, cs; GRU ri, zi, gi, zr_g, hs; RNN hs), the states
        and R^T read once; dz (GRU also dgiri) in R's dtype, dh0 (dc0) and
        db written once; dz @ R^T's 2*T*N*G*K*K operations at the FP32 or
        bf16 peak."""
        nres, nstate = {4: (5, 3), 3: (5, 2), 1: (1, 1)}[g]
        nout = 2 if g == 4 else 1
        nbytes = (4 * T * N * K * (1 + nres) + 4 * N * K * nstate
                  + rdt.itemsize * g * K * K
                  + rdt.itemsize * T * N * K * (g + (g == 3))
                  + 4 * N * K * nout + 4 * g * K)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        peak = FP32_FLOP_PER_S if rdt == f32 else BF16_FLOP_PER_S
        t_ops = 2 * T * N * g * K * K / peak * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    rows = []
    for ct in (CellType.LSTM, CellType.GRU, CellType.RNN_TANH):
        name, g, kname = kinds[ct]
        module = {"lstm": "LSTM", "gru": "GRU"}.get(name, "RNN")
        row = {"name": kname + "_bwd", "route": "cuda", "source": RNN_SOURCE,
               "replaces": RNN_BWD_REPLACES[kname + "_bwd"],
               "launches": totals[kname + "_bwd"],
               "max_abs_err": max_abs[kname + "_bwd"], "check": "pass",
               "shape": f"N{N} C{C} K{K} T{T}",
               "library": f"torch.nn.{module} (cuDNN) backward alone"}
        flops = 2 * T * N * (C + K) * g * K
        for dt, rdt in (("float32", f32), ("bfloat16", bf16)):
            ms = cuda_time_ms(call, kname, rdt, warmup=3, iters=20)
            plain_ms = cuda_time_ms(call, kname, rdt, True, warmup=1,
                                    iters=3 if rdt == f32 else 1)
            bound_ms, bound_by = bound(g, rdt)
            cell = create_rnncell(RnnDesc(n=N, c=C, k=K, max_t=T,
                                          cell_type=ct, in_dtype=dt,
                                          out_dtype=dt))
            ins, dhs = cases[(ct, full)]["dev"], cases[(ct, full)]["dhs"]
            _, saved = cell.forward_train(*ins)
            bfs_ms = cuda_time_ms(cell.backward_from_saved, saved, dhs,
                                  warmup=3, iters=20)
            fwd_ms = cuda_time_ms(cell.forward_train, *ins, warmup=3,
                                  iters=20)

            def train_step(cell=cell, ins=ins, dhs=dhs):
                cell.backward_from_saved(cell.forward_train(*ins)[1], dhs)
            step_ms = cuda_time_ms(train_step, warmup=3, iters=20)
            bwu_ms = cuda_time_ms(cell.backward_weight_update, *ins[:4], dhs,
                                  *ins[4:], warmup=3, iters=20)
            dz = call(kname, rdt)[0]
            hs = saved[4]
            w = saved[1][:C] if g == 4 else saved[1]
            flat_ms = cuda_time_ms(rnncell._flat_grads, saved[0], w,
                                   ins[4], hs, dz, dz, warmup=3, iters=20)
            lib_bwd, lib_step = lib[(ct, dt)]
            print(f"time  {kname + '_bwd':12s} {dt:8s} kernel {ms:.4f} ms "
                  f"({ms * 1e3 / T:.2f} us/step), bound {bound_ms:.4f} ms "
                  f"({bound_by}), share {bound_ms / ms:.3f}; plain "
                  f"{plain_ms:.3f} ms; cuDNN backward {lib_bwd:.4f} ms  "
                  f"[{smi}]")
            print(f"call  {ct.value:11s} {dt:8s} backward_from_saved "
                  f"{bfs_ms:.4f} ms = {3 * flops / bfs_ms / 1e9:.2f} TFLOP/s "
                  f"(3x the forward's); backward_weight_update {bwu_ms:.4f} "
                  f"ms = {3 * flops / bwu_ms / 1e9:.2f}; training step "
                  f"{step_ms:.4f} ms = forward_train {fwd_ms:.4f} + backward "
                  f"kernel {ms:.4f} + dx/dw/dr products {flat_ms:.4f} + rest "
                  f"{step_ms - fwd_ms - ms - flat_ms:.4f}; {4 * flops / step_ms / 1e9:.2f} "
                  f"TFLOP/s; cuDNN forward+backward {lib_step:.4f} ms = "
                  f"{4 * flops / lib_step / 1e9:.2f} TFLOP/s  [{smi}]")
            sfx = "" if dt == "float32" else "_bf16"
            row.update({f"ms{sfx}": ms, f"us_per_step{sfx}": ms * 1e3 / T,
                        f"plain_ms{sfx}": plain_ms,
                        f"bound_ms{sfx}": bound_ms,
                        f"bound_by{sfx}": bound_by,
                        f"library_ms{sfx}": lib_bwd,
                        f"backward_from_saved_ms{sfx}": bfs_ms,
                        f"train_step_ms{sfx}": step_ms,
                        f"cudnn_step_ms{sfx}": lib_step})
        rows.append(row)
    return rows


def pool_first_match_gold(np, x, dy):
    """dx of 2x2/s2 max pooling in numpy: dy goes to the first element of
    its window, in row-major order, that equals the window's max."""
    n, h, w, c = x.shape
    x6 = x.reshape(n, h // 2, 2, w // 2, 2, c)
    order = ((0, 0), (0, 1), (1, 0), (1, 1))
    m = x6.max(axis=(2, 4))
    taken = np.zeros(m.shape, bool)
    dx6 = np.zeros_like(x6)
    for a, b in order:
        hit = (x6[:, :, a, :, b] == m) & ~taken
        dx6[:, :, a, :, b] = np.where(hit, dy, 0)
        taken |= hit
    return dx6.reshape(n, h, w, c)


def dnn_phase(args, dev, smi):
    """Steps 24 to 26 of the module docstring; returns kernel 21's row of
    the ``{"kernels": [...]}`` line."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight
    from xsmm_tpu_torch import dnn as pd
    from xsmm_tpu_torch.dnn import conv as pconv
    from xsmm_tpu_torch.dnn import pooling as ppool
    from xsmm_tpu_torch.utils.timer import cuda_time_ms

    # the layers switch cuDNN's TF32 off for their f32 convs and leave the
    # caller's setting as it was: this caller has it on
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    dts = {"float32": f32, "bfloat16": bf16}
    NB = args.dnn_batch
    red = (0, 1, 2)
    g = torch.Generator(device=dev).manual_seed(args.seed + 70)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def rel(want, got):
        got = got.double()
        if tuple(got.shape) != tuple(want.shape):
            raise RuntimeError(f"shape {tuple(got.shape)} != "
                               f"{tuple(want.shape)}")
        if not torch.isfinite(got).all():
            raise RuntimeError("non-finite output")
        return (torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want).clamp_min(1e-300)).item()

    def gate(label, err, tol, what="gold"):
        ok = err <= tol
        print(f"{what:5s} {label:52s} rel-Frobenius {err:.3e} (tol {tol:g}) "
              f"{'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: {err:.3e} > {tol:g} against {what}")

    def equal(label, want, got, what="gold"):
        """Bit for bit (want: a numpy array or a tensor)."""
        want = torch.as_tensor(want).to(got.device, got.dtype)
        ok = tuple(want.shape) == tuple(got.shape) and torch.equal(want, got)
        print(f"{what:5s} {label:52s} bit-exact {'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: not bit-exact against {what}")

    totals = {"maxpool2x2_bwd": 0}

    def call(label, expect, fn, *a):
        """fn(*a) with the window kernel's count set to 0 just before and
        read just after: the call must launch it ``expect`` times, and must
        leave cuDNN's TF32 flag as this caller set it."""
        ppool.reset_launches()
        out = fn(*a)
        torch.cuda.synchronize()
        n_ = ppool.launches["maxpool2x2_bwd"]
        print(f"drive {label:52s} window kernel launches {n_}")
        if n_ != expect:
            raise RuntimeError(f"{label}: window kernel launched {n_} times, "
                               f"expected {expect}")
        if torch.backends.cudnn.allow_tf32 is not True:
            raise RuntimeError(f"{label}: left cudnn.allow_tf32 changed")
        totals["maxpool2x2_bwd"] += n_
        return out

    def knob(on_):
        if on_:
            os.environ["XSMM_POOL_WINDOW_KERNEL"] = "1"
        else:
            os.environ.pop("XSMM_POOL_WINDOW_KERNEL", None)

    def conv64(x, w, stride, pad):
        """f64 NHWC x (*) HWIO w on the card."""
        return F.conv2d(x.double().permute(0, 3, 1, 2),
                        w.double().permute(3, 2, 0, 1), stride=stride,
                        padding=pad).permute(0, 2, 3, 1)

    def conv64_dx(dy, w, xshape, stride, pad):
        n, h, w_, c = xshape
        return conv2d_input((n, c, h, w_), w.double().permute(3, 2, 0, 1),
                            dy.double().permute(0, 3, 1, 2), stride=stride,
                            padding=pad).permute(0, 2, 3, 1)

    def conv64_dw(x, dy, wshape, stride, pad):
        r, s, c, k = wshape
        return conv2d_weight(x.double().permute(0, 3, 1, 2), (k, c, r, s),
                             dy.double().permute(0, 3, 1, 2), stride=stride,
                             padding=pad).permute(2, 3, 1, 0)

    t0 = time.perf_counter()
    # -- 24. the DNN layers through their entry points, counted --------------
    # pooling at N64 C256 H56 W56 2x2/s2 (samples/layer_driver.py:53): x of
    # values rounded to 0.5, so windows hold ties; dy exact in bf16
    PH, PC = 56, 256
    xp_ = torch.round(randn(NB, PH, PH, PC) * 2) / 2
    dyp = randn(NB, PH // 2, PH // 2, PC).bfloat16().float()
    x_np, dy_np = xp_.cpu().numpy(), dyp.cpu().numpy()
    x6 = x_np.reshape(NB, PH // 2, 2, PH // 2, 2, PC)
    gold = {"MAX": (x6.max(axis=(2, 4)), pool_first_match_gold(np, x_np,
                                                               dy_np)),
            "AVG": (x6.mean(axis=(2, 4), dtype=np.float64).astype(np.float32),
                    np.repeat(np.repeat(dy_np / 4, 2, 1), 2, 2))}
    del x6
    pool_layers = {}
    for dt in ("float32", "bfloat16"):
        for ptype, window in (("MAX", False), ("MAX", True), ("AVG", False)):
            knob(window)
            layer = pd.create_pooling_layer(pd.PoolingDesc(
                n=NB, c=PC, h=PH, w=PH, r=2, s=2, u=2, v=2,
                pool_type=pd.PoolType[ptype], dtype=dt))
            knob(False)
            kind_ = "pallas_window" if window else "vjp"
            if layer.bwd_kind != kind_:
                raise RuntimeError(f"pooling {ptype}: bwd_kind "
                                   f"{layer.bwd_kind}, expected {kind_}")
            pool_layers[(ptype, dt, window)] = layer
            label = f"pooling {ptype} {dt} N{NB} C{PC} H{PH} 2x2/s2"
            y = call(f"{label} forward", 0, layer.forward, xp_)
            dx = call(f"{label} backward ({kind_})", int(window),
                      layer.backward, dyp, xp_)
            if y.dtype != dts[dt] or dx.dtype != dts[dt]:
                raise RuntimeError(f"{label}: dtypes {y.dtype}, {dx.dtype}")
            gy, gdx = gold[ptype]
            if not np.array_equal(y.float().cpu().numpy(), gy):
                raise RuntimeError(f"{label}: forward differs from gold")
            print(f"gold  {label + ' forward':52s} equal pass")
            equal(f"{label} dx ({kind_})", gdx, dx)
    del gold

    # fully connected at N1024 C4096 K4096, BIAS|RELU (layer_driver.py:35)
    FN, FC_, FK = 16 * NB, 4096, 4096
    x, w = randn(FN, FC_), randn(FC_, FK, scale=0.02)
    b, dy = randn(FK, scale=0.1), randn(FN, FK)
    fc_layers = {}
    for dt in ("float32", "bfloat16"):
        layer = pd.create_fullyconnected_layer(pd.FCDesc(
            n=FN, c=FC_, k=FK, in_dtype=dt, out_dtype=dt,
            fuse_ops=pd.FuseOp.BIAS | pd.FuseOp.RELU))
        fc_layers[dt] = layer
        label = f"fc {dt} N{FN} C{FC_} K{FK} bias+relu"
        y, mask = call(f"{label} FWD", 0, layer.forward, x, w, b)
        dx = call(f"{label} BWD", 0, layer.backward, dy, w, mask)
        dw, db = call(f"{label} UPD", 0, layer.weight_update, x, dy, mask)
        z = x.to(dts[dt]).double() @ w.to(dts[dt]).double() + b.double()
        tol = DNN_TOL[dt]
        gate(f"{label} FWD y", rel(torch.relu(z), y), tol)
        agree = (mask == (z > 0)).float().mean().item()
        print(f"gold  {label + ' FWD relu mask':52s} agrees on {agree:.6f}")
        if agree < 0.999:
            raise RuntimeError(f"{label}: relu mask differs from gold")
        dym = torch.where(mask, dy, 0.0).double()
        gate(f"{label} BWD dx", rel(dym @ w.double().t(), dx), tol)
        gate(f"{label} UPD dw", rel(x.double().t() @ dym, dw), tol)
        gate(f"{label} UPD db", rel(dym.sum(0), db), DNN_TOL["float32"])
    del x, w, b, dy, y, mask, dx, dw, db, z, dym

    # fused BN at N64 C256 H56 W56 with RELU and ELTWISE_RELU
    x = randn(NB, PH, PH, PC) * 2 + 1
    res, dy = randn(NB, PH, PH, PC), randn(NB, PH, PH, PC)
    gamma, beta = randn(PC), randn(PC, scale=0.5)
    nhw = NB * PH * PH
    x64 = x.double()
    mean64, var64 = x64.mean(red), x64.var(red, correction=0)
    xhat64 = (x64 - mean64) / torch.sqrt(var64 + 1e-5)
    bn_layers = {}
    for fuse in ("RELU", "ELTWISE_RELU"):
        r = res if fuse == "ELTWISE_RELU" else None
        z = xhat64 * gamma.double() + beta.double()
        if r is not None:
            z = z + r.double()
        gy = torch.relu(z)
        gvar = var64 * nhw / (nhw - 1)
        gmask = z > 0
        ze = (x64 - mean64) / torch.sqrt(gvar + 1e-5) * gamma.double() \
            + beta.double() + (0 if r is None else r.double())
        for dt in ("float32", "bfloat16"):
            bn = pd.create_fusedbatchnorm(pd.BnDesc(
                n=NB, c=PC, h=PH, w=PH, fuse=pd.BnFuse[fuse], dtype=dt))
            bn_layers[(fuse, dt)] = bn
            label = f"bn {fuse} {dt} N{NB} C{PC} H{PH}"
            y, st = call(f"{label} forward", 0, bn.forward, x, gamma, beta, r)
            out = call(f"{label} backward", 0, bn.backward, dy, gamma, st)
            run_ = call(f"{label} update_running", 0, bn.update_running,
                        bn.init_running(), st)
            ye = call(f"{label} forward_eval", 0, bn.forward_eval, x, gamma,
                      beta, run_, r)
            ty, tdx = BN_TOL[dt]
            gate(f"{label} y", rel(gy, y), ty)
            # the gradients' gold takes the layer's own ReLU mask: an
            # element within an f32 rounding of 0 may fall on either side
            agree = (st.relu_mask == gmask).double().mean().item()
            print(f"gold  {label + ' relu mask':52s} agrees on {agree:.7f}")
            if agree < 0.9999:
                raise RuntimeError(f"{label}: relu mask differs from gold")
            dym = torch.where(st.relu_mask, dy.double(), 0.0)
            gdb, gdg = dym.sum(red), (dym * xhat64).sum(red)
            gdx = (gamma.double() / torch.sqrt(var64 + 1e-5) / nhw
                   * (nhw * dym - gdb - xhat64 * gdg))
            gate(f"{label} dx", rel(gdx, out[0]), tdx)
            gate(f"{label} dgamma", rel(gdg, out[1]), 1e-3)
            gate(f"{label} dbeta", rel(gdb, out[2]), 1e-3)
            if r is not None:
                gate(f"{label} dresidual", rel(dym, out[3]), 1e-3)
            gate(f"{label} running gmean", rel(mean64, run_.gmean), 1e-3)
            gate(f"{label} running gvar", rel(gvar, run_.gvar), 1e-3)
            if float(run_.scf) != 1.0:
                raise RuntimeError(f"{label}: scf {float(run_.scf)} != 1")
            gate(f"{label} forward_eval", rel(torch.relu(ze), ye), ty)
    del x64, xhat64, z, gy, dym, gdx, ze, out, ye

    # conv at N32 C64 H56 W56 K64 3x3 s1 p1 (samples/cnnlayer_driver.py:26,
    # the fold route) and the strided K128 3x3 s2 p1, with the fusions
    Fo = pd.FuseOp
    CN = max(NB // 2, 1)
    conv_cases = {}
    for k, u in ((64, 1), (128, 2)):
        xc = randn(CN, PH, PH, 64)
        wc = randn(3, 3, 64, k, scale=0.05)
        bc = randn(k, scale=0.1)
        oh = (PH + 2 - 3) // u + 1
        dyc = randn(CN, oh, oh, k)
        for dt in ("float32", "bfloat16"):
            kw = dict(n=CN, c=64, h=PH, w=PH, k=k, r=3, s=3, u=u, v=u,
                      pad_h=1, pad_w=1, in_dtype=dt, out_dtype=dt)
            lf = pd.create_conv_layer(pd.ConvDesc(
                **kw, fuse_ops=Fo.BIAS | Fo.RELU | Fo.BATCH_STATS_FWD
                | Fo.BATCHNORM_STATS | Fo.MAX_STATS))
            lb = pd.create_conv_layer(pd.ConvDesc(
                **kw, fuse_ops=Fo.RELU_BWD | Fo.ELTWISE_BWD
                | Fo.BATCH_STATS_BWD | Fo.MAX_STATS))
            lp = pd.create_conv_layer(pd.ConvDesc(**kw))
            conv_cases[(k, dt)] = (lp, xc, wc, dyc)
            label = f"conv {dt} N{CN} C64 H{PH} K{k} 3x3 s{u} p1"
            tol = DNN_TOL[dt]
            y0 = call(f"{label} FWD", 0, lp.forward, xc, wc)
            y, st = call(f"{label} FWD bias+relu+stats", 0, lf.forward, xc,
                         wc, bc)
            dx0 = call(f"{label} BWD", 0, lp.backward, dyc, wc)
            dx, delt, bst = call(f"{label} BWD relu/eltwise/stats", 0,
                                 lb.backward, dyc, wc, y)
            dw = call(f"{label} UPD", 0, lp.weight_update, xc, dyc)

            def autograd(lp=lp, xc=xc, wc=wc, dyc=dyc):
                xa = xc.clone().requires_grad_()
                wa = wc.clone().requires_grad_()
                ya = lp.forward(xa, wa)
                ya.backward(dyc.to(ya.dtype))
                return xa.grad, wa.grad
            gxa, gwa = call(f"{label} autograd through forward", 0, autograd)
            xr, wr = xc.to(dts[dt]), wc.to(dts[dt])
            z = conv64(xr, wr, u, 1)
            gate(f"{label} FWD y", rel(z, y0), tol)
            yf = torch.relu(z + bc.double())
            gate(f"{label} FWD y bias+relu", rel(yf, y), tol)
            gate(f"{label} FWD sum", rel(yf.sum(red), st.sum), tol)
            gate(f"{label} FWD sumsq", rel((yf * yf).sum(red), st.sumsq), tol)
            gate(f"{label} FWD mean", rel(yf.mean(red), st.mean), tol)
            gate(f"{label} FWD var", rel(yf.var(red, correction=0), st.var),
                 tol)
            gate(f"{label} FWD absmax", rel(yf.abs().amax(red), st.absmax),
                 tol)
            gdx0 = conv64_dx(dyc, wc, xc.shape, u, 1)
            gate(f"{label} BWD dx", rel(gdx0, dx0), tol)
            dym = torch.where(y > 0, dyc, 0.0).double()
            gdx = conv64_dx(dym, wc, xc.shape, u, 1)
            gate(f"{label} BWD dx relu_bwd", rel(gdx, dx), tol)
            gate(f"{label} BWD d_eltwise", rel(dym, delt), tol)
            gate(f"{label} BWD dbeta", rel(dym.sum(red), bst.dbeta), tol)
            gate(f"{label} BWD dgamma_y",
                 rel((dym * y.double()).sum(red), bst.dgamma_y), tol)
            gate(f"{label} BWD dx_absmax",
                 rel(gdx.abs().amax(red), bst.dx_absmax), tol)
            gate(f"{label} UPD dw", rel(conv64_dw(xc, dyc, wc.shape, u, 1),
                                        dw), UPD_TOL[dt])
            gate(f"{label} autograd dx",
                 rel(conv64_dx(dyc.to(dts[dt]), wr, xc.shape, u, 1), gxa),
                 tol)
            gate(f"{label} autograd dw",
                 rel(conv64_dw(xr, dyc.to(dts[dt]), wc.shape, u, 1), gwa),
                 UPD_TOL[dt])
            del y0, y, st, dx0, dx, delt, bst, dw, gxa, gwa, z, yf, gdx
            del gdx0, dym

    # one stage-shaped training step at the pooling shape: conv 1x1
    # C64->K256 (BATCH_STATS_FWD) -> forward_from_moments (RELU) -> max pool
    # 2x2/s2; then the window kernel -> BN backward -> conv BWD and UPD
    knob(True)
    s_pool = pd.create_pooling_layer(pd.PoolingDesc(
        n=NB, c=PC, h=PH, w=PH, r=2, s=2, u=2, v=2))
    knob(False)
    s_conv = pd.create_conv_layer(pd.ConvDesc(
        n=NB, c=64, h=PH, w=PH, k=PC, r=1, s=1,
        fuse_ops=pd.FuseOp.BATCH_STATS_FWD))
    s_bn = pd.create_fusedbatchnorm(pd.BnDesc(n=NB, c=PC, h=PH, w=PH,
                                              fuse=pd.BnFuse.RELU))
    sx, sw = randn(NB, PH, PH, 64), randn(1, 1, 64, PC, scale=0.1)
    sg, sb = randn(PC), randn(PC, scale=0.5)
    sdz = randn(NB, PH // 2, PH // 2, PC)

    def stage_fwd():
        y, st = s_conv.forward(sx, sw)
        mean = st.sum / nhw
        a, bst = s_bn.forward_from_moments(y, sg, sb, mean,
                                           st.sumsq / nhw - mean * mean)
        return y, st, a, bst, s_pool.forward(a)

    def stage_bwd(a, bst):
        da = s_pool.backward(sdz, a)
        dy, dgamma, dbeta = s_bn.backward(da, sg, bst)
        return da, dy, dgamma, dbeta, s_conv.backward(dy, sw), \
            s_conv.weight_update(sx, dy)

    def stage_step():
        y, st, a, bst, z = stage_fwd()
        return (y, st, a, z) + stage_bwd(a, bst)

    if s_pool.bwd_kind != "pallas_window":
        raise RuntimeError("stage: the pool's backward is not the window route")
    label = f"stage conv1x1 C64->K{PC} + bn + maxpool N{NB} H{PH}"
    y, st, a, z, da, dy, dgam, dbet, dx, dw = call(f"{label} step", 1,
                                                   stage_step)
    # each stage against f64 gold from its own inputs (the previous stage's
    # outputs)
    gate(f"{label} conv y", rel(conv64(sx, sw, 1, 0), y), 1e-5)
    y64 = y.double()
    gate(f"{label} conv sum", rel(y64.sum(red), st.sum), 1e-5)
    gate(f"{label} conv sumsq", rel((y64 * y64).sum(red), st.sumsq), 1e-5)
    m64, v64 = y64.mean(red), y64.var(red, correction=0)
    xh64 = (y64 - m64) / torch.sqrt(v64 + 1e-5)
    za = xh64 * sg.double() + sb.double()
    gate(f"{label} bn from moments", rel(torch.relu(za), a), 1e-3)
    a_np = a.cpu().numpy()
    equal(f"{label} pool forward", a_np.reshape(
        NB, PH // 2, 2, PH // 2, 2, PC).max(axis=(2, 4)), z)
    equal(f"{label} pool window backward",
          pool_first_match_gold(np, a_np, sdz.cpu().numpy()), da)
    dam = torch.where(za > 0, da.double(), 0.0)
    gdb, gdg = dam.sum(red), (dam * xh64).sum(red)
    gdy = (sg.double() / torch.sqrt(v64 + 1e-5) / nhw
           * (nhw * dam - gdb - xh64 * gdg))
    gate(f"{label} bn dx", rel(gdy, dy), 1e-2)
    gate(f"{label} bn dgamma", rel(gdg, dgam), 1e-3)
    gate(f"{label} bn dbeta", rel(gdb, dbet), 1e-3)
    gate(f"{label} conv dx", rel(conv64_dx(dy, sw, sx.shape, 1, 0), dx),
         1e-5)
    gate(f"{label} conv dw", rel(conv64_dw(sx, dy, sw.shape, 1, 0), dw),
         UPD_TOL["float32"])
    del y, st, z, dy, dx, dw, y64, xh64, za, dam, gdy, a_np

    # quant on a 64x256x56x56 f32 tensor in all five modes, round-tripped
    xq = randn(NB, PC, PH, PH, scale=3.0)
    ax = xq.abs().max().double()
    max_exp = int(torch.frexp(ax).exponent) + 126
    scf_g = max(14 - (max_exp - 127), 0)
    mag = xq.double().abs() * 2.0 ** scf_g
    sign = torch.sign(xq.double())
    qgold = {"NO_ROUND": torch.floor(mag), "NEAREST": torch.floor(mag + 0.5),
             "BIAS": torch.floor(mag + 0.75), "FPHW": torch.floor(mag + 0.5)}
    step_ = 2.0 ** -scf_g
    for mode in pd.RoundMode:
        key = (torch.Generator(device=dev).manual_seed(args.seed)
               if mode == pd.RoundMode.STOCH else None)
        label = f"quant {mode.name} {NB}x{PC}x{PH}x{PH} f32"
        q, scf = call(f"{label} quantize", 0, pd.quantize, xq, 0, mode, key)
        back = call(f"{label} dequantize", 0, pd.dequantize, q, scf)
        if int(scf) != scf_g or q.dtype != torch.int16:
            raise RuntimeError(f"{label}: scf {int(scf)} (gold {scf_g}), "
                               f"{q.dtype}")
        if mode.name in qgold:
            want = torch.clamp(sign * qgold[mode.name], -32768, 32767)
            equal(f"{label} q", want.to(torch.int16), q)
        else:
            up = q.double() * sign - torch.floor(mag)
            if not ((up == 0) | (up == 1)).all():
                raise RuntimeError(f"{label}: not a neighbour of x")
            bias = (back.double() - xq.double()).mean().item() / step_
            print(f"gold  {label + ' round trip':52s} mean error "
                  f"{bias:+.2e} steps")
            if abs(bias) > 1e-3:
                raise RuntimeError(f"{label}: biased by {bias:.2e} steps")
        equal(f"{label} dequantize", q.double() * step_, back.double())
    del mag, sign, qgold, q, back
    drive_s = time.perf_counter() - t0
    print(f"dnn path in {drive_s:.2f} s; window kernel launches {totals}  "
          f"[{smi}]")
    if totals["maxpool2x2_bwd"] < 1:
        raise RuntimeError("maxpool2x2_bwd was not launched on the DNN path")

    # -- 25. the window kernel against its plain version ---------------------
    got = ppool.maxpool2x2_bwd(dyp, xp_)
    want = ppool.maxpool2x2_bwd_plain(dyp, xp_)
    torch.cuda.synchronize()
    max_abs = (got - want).abs().max().item()
    equal(f"maxpool2x2_bwd N{NB} C{PC} H{PH} tied", want, got, "plain")
    got = ppool.maxpool2x2_bwd(sdz, a)
    equal(f"maxpool2x2_bwd stage activations", ppool.maxpool2x2_bwd_plain(
        sdz, a), got, "plain")
    del got, want

    # -- 26. times ---------------------------------------------------------------
    el = NB * PH * PH * PC
    nbytes = 4 * (el + el // 4 + el)          # read x, dy; write dx
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 14 * el / 4 / FP32_FLOP_PER_S * 1e3
    bound_by = "bytes" if bound_ms >= t_ops else "operations"
    bound_ms = max(bound_ms, t_ops)
    ms = cuda_time_ms(ppool.maxpool2x2_bwd, dyp, xp_, warmup=3, iters=50)
    plain_ms = cuda_time_ms(ppool.maxpool2x2_bwd_plain, dyp, xp_, warmup=1,
                            iters=5)
    vjp = pool_layers[("MAX", "float32", False)]
    lib_ms = cuda_time_ms(vjp._bwd, dyp, xp_, warmup=3, iters=20)
    xr_ = xp_.permute(0, 3, 1, 2)
    _, idx = F.max_pool2d(xr_, 2, 2, return_indices=True)
    dyr = dyp.permute(0, 3, 1, 2)
    alone_ms = cuda_time_ms(torch.ops.aten.max_pool2d_with_indices_backward,
                            dyr, xr_, [2, 2], [2, 2], [0, 0], [1, 1], False,
                            idx, warmup=3, iters=20)
    print(f"time  maxpool2x2_bwd f32 N{NB} C{PC} H{PH} kernel {ms:.4f} ms, "
          f"{nbytes / ms / 1e6:.1f} GB/s, bound {bound_ms:.4f} ms "
          f"({bound_by}), share {bound_ms / ms:.3f}; plain {plain_ms:.3f} "
          f"ms; vjp route (F.max_pool2d forward + autograd backward, "
          f"channels-last) {lib_ms:.4f} ms; max_pool2d_with_indices_backward "
          f"alone {alone_ms:.4f} ms  [{smi}]")
    row = {"name": "maxpool2x2_bwd", "route": "cuda", "source": POOL_SOURCE,
           "replaces": POOL_REPLACES,
           "launches": totals["maxpool2x2_bwd"], "max_abs_err": max_abs,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": lib_ms, "check": "pass",
           "shape": f"N{NB} C{PC} H{PH} W{PH} 2x2/s2 f32",
           "library": "F.max_pool2d channels-last forward + autograd "
                      "backward (the vjp route)",
           "backward_alone_ms": alone_ms}
    for dt in ("float32", "bfloat16"):
        isz = 2 if dt == "bfloat16" else 4
        fwd = {}
        for ptype in ("MAX", "AVG"):
            fwd[ptype] = cuda_time_ms(pool_layers[(ptype, dt, False)].forward,
                                      xp_.to(dts[dt]), warmup=3, iters=20)
        bwd = {k_: cuda_time_ms(pool_layers[("MAX", dt, k_)].backward, dyp,
                                xp_, warmup=3, iters=20)
               for k_ in (False, True)}
        io = (el + el // 4) * isz
        print(f"call  pooling {dt:8s} forward max {fwd['MAX']:.4f} ms avg "
              f"{fwd['AVG']:.4f} ms ({io / fwd['MAX'] / 1e6:.1f} / "
              f"{io / fwd['AVG'] / 1e6:.1f} GB/s in+out); max backward "
              f"whole call: vjp route {bwd[False]:.4f} ms, pallas_window "
              f"route {bwd[True]:.4f} ms  [{smi}]")
        row[f"pool_fwd_max_ms_{dt}"] = fwd["MAX"]
        row[f"backward_vjp_ms_{dt}"] = bwd[False]
        row[f"backward_window_ms_{dt}"] = bwd[True]

    x, w = randn(FN, FC_), randn(FC_, FK, scale=0.02)
    b, dy = randn(FK, scale=0.1), randn(FN, FK)
    flops = 2 * FN * FC_ * FK
    for dt, layer in fc_layers.items():
        _, mask = layer.forward(x, w, b)
        t_f = cuda_time_ms(layer.forward, x, w, b)
        t_b = cuda_time_ms(layer.backward, dy, w, mask)
        t_u = cuda_time_ms(layer.weight_update, x, dy, mask)
        print(f"call  fc {dt:8s} N{FN} C{FC_} K{FK} FWD {t_f:.4f} ms "
              f"{flops / t_f / 1e9:.1f} TFLOP/s; BWD {t_b:.4f} "
              f"{flops / t_b / 1e9:.1f}; UPD {t_u:.4f} "
              f"{flops / t_u / 1e9:.1f}  [{smi}]")
    del x, w, b, dy, mask

    for (fuse, dt), bn in bn_layers.items():
        if fuse != "RELU":
            continue
        xb = randn(NB, PH, PH, PC)
        _, st = bn.forward(xb, gamma, beta)
        t_f = cuda_time_ms(bn.forward, xb, gamma, beta)
        t_b = cuda_time_ms(bn.backward, xb, gamma, st)
        io = el * (4 + (2 if dt == "bfloat16" else 4))
        print(f"call  bn RELU {dt:8s} N{NB} C{PC} H{PH} forward {t_f:.4f} ms "
              f"({io / t_f / 1e6:.1f} GB/s on x read + y written); backward "
              f"{t_b:.4f} ms  [{smi}]")
    del xb, st

    for (k, dt), (lp, xc, wc, dyc) in conv_cases.items():
        d = lp.desc
        flops = 2 * d.n * d.out_h * d.out_w * d.c * d.k * d.r * d.s
        t_f = cuda_time_ms(lp.forward, xc, wc)
        t_b = cuda_time_ms(lp.backward, dyc, wc)
        t_u = cuda_time_ms(lp.weight_update, xc, dyc)
        print(f"call  conv {dt:8s} N{d.n} C{d.c} H{d.h} K{d.k} 3x3 s{d.u} "
              f"FWD {t_f:.4f} ms {flops / t_f / 1e9:.1f} TFLOP/s; BWD "
              f"{t_b:.4f} {flops / t_b / 1e9:.1f}; UPD {t_u:.4f} "
              f"{flops / t_u / 1e9:.1f}  [{smi}]")
        if k != 64:
            continue
        # the space-to-depth fold against the direct cuDNN conv, both ways
        xi, wi = xc.to(dts[dt]), wc.to(dts[dt])
        dyi = dyc.float()
        times = {}
        saved = pconv.S2D_ON_CARD
        try:
            for fold in (False, True, True, False):
                pconv.S2D_ON_CARD = fold
                tf = cuda_time_ms(lp._core_conv, xi, wi)
                tb = cuda_time_ms(lp._bwd_direct, dyi, wc)
                times.setdefault(fold, []).append((tf, tb))
            pconv.S2D_ON_CARD = True
            yf, bf_ = lp._core_conv(xi, wi), lp._bwd_direct(dyi, wc)
            pconv.S2D_ON_CARD = False
            yd, bd = lp._core_conv(xi, wi), lp._bwd_direct(dyi, wc)
        finally:
            pconv.S2D_ON_CARD = saved
        gate(f"fold vs direct conv {dt} K64 forward", rel(yd.double(), yf),
             DNN_TOL[dt], "fold")
        gate(f"fold vs direct conv {dt} K64 backward", rel(bd.double(), bf_),
             DNN_TOL[dt], "fold")
        (df1, db1), (df2, db2) = times[False]
        (ff1, fb1), (ff2, fb2) = times[True]
        print(f"call  s2d fold {dt:8s} N{d.n} C64 H{d.h} K64 3x3 s1 (in "
              f"turns direct, fold, fold, direct): forward direct {df1:.4f} "
              f"/ {df2:.4f} ms, fold {ff1:.4f} / {ff2:.4f}; backward dx "
              f"direct {db1:.4f} / {db2:.4f}, fold {fb1:.4f} / {fb2:.4f}; "
              f"S2D_ON_CARD {saved}  [{smi}]")
        row[f"s2d_fwd_direct_fold_ms_{dt}"] = [df1, df2, ff1, ff2]
        row[f"s2d_bwd_direct_fold_ms_{dt}"] = [db1, db2, fb1, fb2]

    def timed(fn, *a):
        return cuda_time_ms(fn, *a, warmup=2, iters=10)
    step_ms = timed(stage_step)
    y, st, a, bst, _ = stage_fwd()
    da = s_pool.backward(sdz, a)
    dy = s_bn.backward(da, sg, bst)[0]
    mean = st.sum / nhw
    parts = {
        "conv fwd": timed(s_conv.forward, sx, sw),
        "bn from moments": timed(s_bn.forward_from_moments, y, sg, sb, mean,
                                 st.sumsq / nhw - mean * mean),
        "pool fwd": timed(s_pool.forward, a),
        "pool bwd (window)": timed(s_pool.backward, sdz, a),
        "bn bwd": timed(s_bn.backward, da, sg, bst),
        "conv bwd": timed(s_conv.backward, dy, sw),
        "conv upd": timed(s_conv.weight_update, sx, dy)}
    print(f"call  stage step N{NB} H{PH} conv1x1 C64->K{PC} + bn + maxpool: "
          f"{step_ms:.4f} ms = " + " + ".join(
              f"{k_} {v:.4f}" for k_, v in parts.items())
          + f" (sum {sum(parts.values()):.4f})  [{smi}]")
    row["stage_step_ms"] = step_ms
    del y, st, a, bst, da, dy

    for mode in pd.RoundMode:
        key = (torch.Generator(device=dev).manual_seed(args.seed)
               if mode == pd.RoundMode.STOCH else None)
        tq = timed(pd.quantize, xq, 0, mode, key)
        print(f"call  quantize {mode.name:8s} {NB}x{PC}x{PH}x{PH} {tq:.4f} ms "
              f"({el * 6 / tq / 1e6:.1f} GB/s on x read + q written)  "
              f"[{smi}]")
    return [row]


STEP_NAMES = ("copy in", "split", "pack", "kernel", "unpack/join", "copy out")
RUNTIME_ROUNDS = 5   # later calls of each whole call, in turns


def run_steps(torch, steps, x):
    """Run ``steps`` (name -> function of the previous output) in order,
    each synchronized; returns (output, {name: ms})."""
    ms = {}
    for name, fn in steps:
        t0 = time.perf_counter()
        x = fn(x)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    return x, ms


def runtime_phase(args, dev, smi, native_s):
    """Steps 28 to 31 of the module docstring (the runtime layer)."""
    import contextlib
    import glob
    import shutil
    import threading
    import numpy as np
    import torch
    import xsmm_tpu_torch as xp
    from xsmm_tpu_torch.bench import pinned_rates
    from xsmm_tpu_torch.ops import cuda_build, smm_packed
    from xsmm_tpu_torch.ops import packed_kernels as pk
    from xsmm_tpu_torch.ops import spgemm_kernels as sk
    from xsmm_tpu_torch.ops.pack_util import pack_lanes
    from xsmm_tpu_torch.utils import scratch, trace
    from xsmm_tpu_torch.utils.timer import cuda_time_ms, device_bench

    f32, f64 = torch.float32, torch.float64
    B = args.batch
    g = torch.Generator(device=dev).manual_seed(args.seed + 7)
    xp.set_config(f64_strategy="split2_fast")

    # -- 28. the native index ----------------------------------------------
    reg = xp.get_registry()
    info = xp.get_registry_info()
    if info["native"] is not True:
        raise RuntimeError(f"the registry's index is not native: {info}")
    specs = [(xp.dmmdispatch, 0.0), (xp.dmmdispatch, 1.0),
             (xp.smmdispatch, 0.0), (xp.smmdispatch, 1.0),
             (xp.bsmmdispatch, 0.0), (xp.bmmdispatch, 0.0)]
    first = [d(M, N, K, batch=B, beta=beta) for d, beta in specs]
    # the main path's dispatches again with the front memo and this
    # thread's MRU cache dropped: each must be answered by the native index
    reg.front_memo.clear()
    reg._tls = threading.local()
    finds = reg.native_finds
    again = [d(M, N, K, batch=B, beta=beta) for d, beta in specs]
    found = reg.native_finds - finds
    if found != len(specs) or any(a is not b for a, b in zip(first, again)):
        raise RuntimeError(f"native index answered {found} of {len(specs)} "
                           f"dispatches (or gave other kernels)")
    info = xp.get_registry_info()
    print(f"native: build {native_s:.2f} s (g++, native/{{registry,mtx,"
          f"spmdm}}.cpp); registry {info}; {found} of {len(specs)} main-path "
          f"dispatches answered by the native index with the memo and MRU "
          f"cache dropped")

    # -- 29. the link's pinned rates ----------------------------------------
    h2d, d2h = pinned_rates(B * M * K * 8)
    print(f"link: pinned copy_ of {B * M * K * 8 / 1e6:.1f} MB (CUDA events, "
          f"min of 3): host to card {h2d / 1e9:.2f} GB/s, card to host "
          f"{d2h / 1e9:.2f} GB/s  [{smi}]")

    # -- 30. the three whole calls, through the pool and, in turns, the same
    # steps on pageable memory ----------------------------------------------
    scratch.release_scratch()     # a fresh pool: its first call allocates
    pool = scratch.get_staging_pool()
    if not pool.pinned():
        raise RuntimeError("the staging pool is not pinned on the card")

    def host_randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=f64).cpu().numpy()

    def whole(label, call, inputs, others, pinned, pageable, gold, kernel,
              bytes_in, bytes_out):
        """Time ``call(*inputs)`` (first, then RUNTIME_ROUNDS in turns with
        the pinned and the pageable steps) and check the pool's contract."""
        torch.cuda.synchronize()
        n0, r0, u0 = pool.nmallocs, pool.nresults, pool.nresult_reuse
        t0 = time.perf_counter()
        out = call(*inputs)
        first_ms = (time.perf_counter() - t0) * 1e3
        first_mallocs = pool.nmallocs - n0
        if first_mallocs < 1:
            raise RuntimeError(f"{label}: the first call allocated no "
                               f"staging buffer")
        gold(out)
        whole_ms, pin, page = [], [], []
        reuse = 0
        out_page = out_pin = None
        for i in range(RUNTIME_ROUNDS):
            for what in (("whole", "pinned", "pageable") if i % 2 == 0
                         else ("whole", "pageable", "pinned")):
                if what == "whole":
                    torch.cuda.synchronize()
                    n2, r2 = pool.nmallocs, pool.nreuse
                    t0 = time.perf_counter()
                    out = call(*inputs)
                    whole_ms.append((time.perf_counter() - t0) * 1e3)
                    if pool.nmallocs != n2 or pool.nreuse <= r2:
                        raise RuntimeError(f"{label}: a later call "
                                           f"allocated staging buffers "
                                           f"({pool.nmallocs - n2}) or "
                                           f"reused none")
                    reuse += pool.nreuse - r2
                elif what == "pinned":
                    out_pin, ms = run_steps(torch, pinned, inputs)
                    pin.append(ms)
                else:
                    out_page, ms = run_steps(torch, pageable, inputs)
                    page.append(ms)
            if i == 0:
                for name, got in (("whole call", out), ("pinned steps",
                                                        out_pin)):
                    if (got.dtype != out_page.dtype
                            or got.shape != out_page.shape
                            or not np.array_equal(got, out_page)):
                        raise RuntimeError(f"{label}: the {name}' output is "
                                           f"not bit-identical to the "
                                           f"pageable steps'")
                # a result held here would keep its pinned block leased
                del got
            del out, out_pin
        # a held result survives three more calls on other data
        held = call(*inputs)
        keep = held.copy()
        for _ in range(3):
            nxt = call(*others)
            if np.shares_memory(nxt, held):
                raise RuntimeError(f"{label}: a result shares memory with "
                                   f"an earlier one")
            del nxt
        if not np.array_equal(held, keep):
            raise RuntimeError(f"{label}: a held result changed")
        del held, keep
        # the usual loop, c = call(a, b): each call runs while the previous
        # result is still held
        held_ms = []
        got = call(*inputs)
        for _ in range(RUNTIME_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = call(*inputs)
            held_ms.append((time.perf_counter() - t0) * 1e3)
        del got
        # the results' pinned blocks: at most RESULT_BLOCKS for the key
        blocks = pool.nresults - r0
        if not 1 <= blocks <= scratch.RESULT_BLOCKS:
            raise RuntimeError(f"{label}: {blocks} pinned result blocks "
                               f"(at most {scratch.RESULT_BLOCKS})")
        # inputs overwritten right after the call returns leave its result
        # as it was: bit-identical to the pageable steps on the same data
        mine = [x.copy() for x in inputs]
        got = call(*mine)
        for x in mine:
            x[...] = np.nan
        if not np.array_equal(got, out_page):
            raise RuntimeError(f"{label}: overwriting the inputs after the "
                               f"call changed its result")
        gold(got)
        del got, mine, out_page
        kms = cuda_time_ms(kernel, warmup=1, iters=5)
        bound = bytes_in / h2d * 1e3 + bytes_out / d2h * 1e3 + kms
        med = sorted(whole_ms)[len(whole_ms) // 2]

        def fmt(runs):
            return ", ".join(
                f"{n} {np.median([r[n] for r in runs]):.3f}" if n in runs[0]
                else f"{n} -" for n in STEP_NAMES) + (
                f" (sum {np.median([sum(r.values()) for r in runs]):.3f})")
        print(f"call  {label}: first {first_ms:.3f} ms; whole call "
              f"{med:.3f} ms (median of {RUNTIME_ROUNDS}, host clock; "
              f"{', '.join(f'{t:.3f}' for t in whole_ms)}); with the "
              f"previous result held {sorted(held_ms)[len(held_ms) // 2]:.3f}"
              f" ms (median of {RUNTIME_ROUNDS}; "
              f"{', '.join(f'{t:.3f}' for t in held_ms)}); link bound "
              f"{bound:.3f} ms ({bytes_in / 1e6:.1f} MB in, "
              f"{bytes_out / 1e6:.1f} MB out at the pinned rates, kernel "
              f"{kms:.4f} ms)  [{smi}]")
        print(f"steps {label} pinned (median ms): {fmt(pin)}")
        print(f"steps {label} pageable (median ms): {fmt(page)}")
        print(f"pool  {label}: first call {first_mallocs} allocations, "
              f"the {RUNTIME_ROUNDS} later calls 0 ({reuse} reuses); "
              f"results in {blocks} pinned blocks, landed "
              f"{pool.nresult_reuse - u0} times in a block given back; "
              f"bit-identical to the "
              f"pageable steps; a held result intact after 3 calls; inputs "
              f"overwritten after the call harmless")

    def gate(label, err, tol):
        print(f"gold  {label:36s} rel-Frobenius {err:.3e} (tol {tol:g}) "
              f"{'pass' if err < tol else 'FAIL'}")
        if not err < tol:
            raise RuntimeError(f"{label}: {err:.3e} >= {tol:g} against gold")

    # batched f64 23^3, split2_fast, numpy f64 in and out (the README call)
    kern = xp.dmmdispatch(M, N, K, batch=B, beta=0.0)
    a_np, b_np = host_randn(B, M, K), host_randn(B, K, N)
    sub = slice(0, GOLD_SUBSET)
    gold_ab = np.einsum("bmk,bkn->bmn", a_np[sub], b_np[sub])

    def split_b(x):
        ah, b64 = x
        bh = b64.to(f32)
        return ah, bh, (b64 - bh.to(f64)).to(f32)

    def pack_ops(x):
        return (kern.pack_a(x[0]), kern.pack_b(x[1]), kern.pack_b(x[2]))

    def join(x):
        return kern.unpack_c(x, B).to(f64, memory_format=torch.contiguous_format)
    tail = [("pack", pack_ops),
            ("kernel", lambda x: smm_packed.packed_split2_fast(*x)),
            ("unpack/join", join)]
    ops = pack_ops(split_b((torch.from_numpy(a_np).to(dev, f32),
                            torch.from_numpy(b_np).to(dev))))
    whole(
        f"dmmdispatch({M}, {N}, {K}, batch={B}) split2_fast (a, b)",
        kern, (a_np, b_np), (-a_np, -b_np),
        [("copy in", lambda x: (
            scratch.host_to_device(x[0], dev, f32, "smoke_a"),
            scratch.host_to_device(x[1], dev, f64, "smoke_b"))),
         ("split", split_b), *tail,
         ("copy out", scratch.device_to_host)],
        [("copy in", lambda x: (torch.from_numpy(x[0]).to(dev),
                                torch.from_numpy(x[1]).to(dev))),
         ("split", lambda x: split_b((x[0].to(f32), x[1]))), *tail,
         ("copy out", lambda x: x.cpu().numpy())],
        lambda out: gate("whole dmmdispatch split2_fast",
                         xp.matdiff(gold_ab, out[sub]).normf_rel, 1e-6),
        lambda: smm_packed.packed_split2_fast(*ops),
        a_np.size * 4 + b_np.nbytes, B * M * N * 8)
    del a_np, b_np, ops, kern
    torch.cuda.empty_cache()

    # sparse f64 create_dcsr_reg(150x150, N)(b), split2, numpy in and out
    N_sp = args.sparse_n
    name, op_np = pyfr_operators(np)[2]
    skern = xp.create_dcsr_reg(op_np, N_sp)
    sop = skern._operand(dev)
    bs_np = host_randn(op_np.shape[1], N_sp)
    gold_sp = op_np @ bs_np

    def split_s(b64):
        bh = b64.to(f32)
        return bh, (b64 - bh.to(f64)).to(f32)
    stail = [("split", split_s),
             ("kernel", lambda x: sk.unroll_f64(sop, x[0], x[1], c_lo=True)),
             ("unpack/join", lambda x: x[0].to(f64) + x[1].to(f64))]
    bhl = split_s(torch.from_numpy(bs_np).to(dev))
    whole(
        f"create_dcsr_reg({name}, {N_sp})(b) split2",
        skern, (bs_np,), (-bs_np,),
        [("copy in", lambda x: scratch.host_to_device(x[0], dev, f64,
                                                      "smoke_b")),
         *stail, ("copy out", scratch.device_to_host)],
        [("copy in", lambda x: torch.from_numpy(x[0]).to(dev)), *stail,
         ("copy out", lambda x: x.cpu().numpy())],
        lambda out: gate("whole create_dcsr_reg split2",
                         xp.matdiff(gold_sp, out).normf_rel,
                         SPARSE_TOL["float64"]),
        lambda: sk.unroll_f64(sop, bhl[0], bhl[1], c_lo=True),
        bs_np.nbytes, op_np.shape[0] * N_sp * 8)
    del bs_np, gold_sp, bhl, sop, skern
    torch.cuda.empty_cache()

    # packed getrf 16^2, numpy f64 in and out
    PB, PM = args.packed_batch, 16
    gkern = xp.getrf_dispatch(PM, PM, dtype="float64", batch=PB)
    ad = torch.randn((PB, PM, PM), generator=g, device=dev, dtype=f64)
    idx = torch.arange(PM, device=dev)
    ad[:, idx, idx] += PM     # factorizable without pivoting
    ga_np = ad.cpu().numpy()
    del ad

    def gold_lu(out):
        lu = torch.from_numpy(np.ascontiguousarray(out[:GOLD_SUBSET])).to(dev)
        low = torch.tril(lu, -1) + torch.eye(PM, device=dev, dtype=f64)
        a = torch.from_numpy(ga_np[:GOLD_SUBSET]).to(dev)
        gate("whole getrf_dispatch f64 (L U vs A)",
             (torch.linalg.vector_norm(low @ torch.triu(lu) - a)
              / torch.linalg.vector_norm(a)).item(), PACKED_TOL["f32"])
    gtail = [("pack", pack_lanes), ("kernel", pk.getrf_unrolled)]
    gap = pack_lanes(torch.from_numpy(ga_np).to(dev, f32))
    whole(
        f"getrf_dispatch({PM}, {PM}, batch={PB}) f64 (a)",
        gkern, (ga_np,), (ga_np * 0.5,),
        [("copy in", lambda x: scratch.host_to_device(x[0], dev, f32,
                                                      "smoke_a")),
         *gtail,
         ("unpack/join", lambda x: x.permute(2, 0, 1).to(
             f64, memory_format=torch.contiguous_format)),
         ("copy out", scratch.device_to_host)],
        [("copy in", lambda x: torch.from_numpy(
            np.asarray(x[0], np.float32)).to(dev)), *gtail,
         ("unpack/join", lambda x: x.permute(2, 0, 1).contiguous()),
         ("copy out", lambda x: x.cpu().numpy().astype(np.float64))],
        gold_lu, lambda: pk.getrf_unrolled(gap),
        ga_np.size * 4, ga_np.nbytes)
    del ga_np, gap, gkern
    scratch.release_scratch()
    torch.cuda.empty_cache()

    # -- 31. the timer, the port bench and a trace ---------------------------
    ah = torch.randn((M, K, B), generator=g, device=dev)
    bh = torch.randn((K, N, B), generator=g, device=dev)
    bl = bh * 1e-8
    dt, dinfo = device_bench(smm_packed.packed_split2_fast, ah, bh, bl,
                             iters=40, base_iters=8, stats=True)
    ct = cuda_time_ms(smm_packed.packed_split2_fast, ah, bh, bl, warmup=3,
                      iters=20)
    print(f"timer packed_split2_fast B={B}: device_bench {dt * 1e3:.4f} ms "
          f"(CUDA graphs of {dinfo['iters']} and 8 calls differenced, "
          f"spread {dinfo['spread']:.3f}); cuda_time_ms {ct:.4f} ms; ratio "
          f"{dt * 1e3 / ct:.3f}  [{smi}]")
    del ah, bh, bl
    torch.cuda.empty_cache()

    root = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-m", "xsmm_tpu_torch.bench"],
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"xsmm_tpu_torch.bench failed ({res.returncode})"
                           f":\n{res.stderr[-4000:]}")
    line = res.stdout.strip().splitlines()[-1]
    bench = json.loads(line)
    if (bench.get("metric") != "batched_f64_smm_23x23x23_gflops_per_chip"
            or not bench.get("value", 0) > 0):
        raise RuntimeError(f"the port bench printed {line}")
    print(f"bench {line}")

    # one batched call inside trace_region: its kernel_name range and the
    # kernel's launch must be in the Chrome trace
    kern = xp.dmmdispatch(M, N, K, batch=B, beta=0.0)
    a64 = torch.randn((B, M, K), generator=g, device=dev, dtype=f64)
    b64 = torch.randn((B, K, N), generator=g, device=dev, dtype=f64)
    kern(a64, b64)
    tdir = os.path.join(str(cuda_build.BUILD_DIR), "trace")
    shutil.rmtree(tdir, ignore_errors=True)
    with trace.trace_region(tdir):
        kern(a64, b64)
    files = glob.glob(os.path.join(tdir, "*.json"))
    if len(files) != 1:
        raise RuntimeError(f"trace_region wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("name") == kern.name]
    launched = [e for e in events if e.get("cat") == "kernel"
                and "packed_tile_kernel" in e.get("name", "")]
    if not ranges or not launched:
        raise RuntimeError(f"trace: {len(ranges)} ranges named {kern.name}, "
                           f"{len(launched)} packed_tile_kernel launches")
    corr = {e.get("args", {}).get("correlation") for e in launched}
    calls = [e for e in events if e.get("cat") == "cuda_runtime"
             and e.get("args", {}).get("correlation") in corr]
    r = ranges[0]
    inside = [c for c in calls
              if r["ts"] <= c["ts"] <= r["ts"] + r.get("dur", 0)]
    if calls and not inside:
        raise RuntimeError("trace: the kernel was launched outside its "
                           "kernel_name range")
    print(f"trace {files[0]}: {len(events)} events; range {kern.name} "
          f"{r.get('dur', 0):.1f} us; packed_tile_kernel on the card "
          f"{launched[0].get('dur', 0):.1f} us, launched inside the range "
          f"({len(inside)} of {len(calls)} launch calls)")
    del a64, b64

    # the host time a call of the sparse entry point acc_fn beside its
    # kernel wrapper's, in turns, 100 calls enqueued each: with tracing off
    # the entry point's trace scope is one flag check
    if trace.trace_enabled() or torch.autograd._profiler_enabled():
        raise RuntimeError("tracing is on outside trace_region")
    name, op_np = pyfr_operators(np)[2]
    fk = xp.create_csr_soa(op_np, args.sparse_n, dtype="float32",
                           strategy="unroll")
    op = fk._operand(dev)
    cs, bs = (torch.randn((n_, args.sparse_n), generator=g, device=dev)
              for n_ in op_np.shape)
    fns = {"acc_fn": lambda: fk.acc_fn(cs, bs),
           "acc_fn without its trace scope": lambda: fk.acc_fn(cs, bs),
           "sk.acc_f32": lambda: sk.acc_f32(op, cs, bs)}
    if not torch.equal(fns["acc_fn"](), fns["sk.acc_f32"]()):
        raise RuntimeError("acc_fn and its kernel wrapper disagree")
    host = {k: [] for k in fns}
    scope = trace.scope
    for i in range(6):
        for k in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            if k == "acc_fn without its trace scope":
                trace.scope = lambda name, layer=None: contextlib.nullcontext()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):
                    fns[k]()
                host[k].append((time.perf_counter() - t0) * 1e4)
            finally:
                trace.scope = scope
    torch.cuda.synchronize()
    print(f"host  {name} N={args.sparse_n} f32, us a call (100 enqueued, "
          f"median of 6 in turns, tracing off): " + "; ".join(
              f"{k} {np.median(v):.1f} ({', '.join(f'{t:.1f}' for t in v)})"
              for k, v in host.items()))
    del cs, bs, op, fk
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# Steps 32-35: the training framework (dnn/layers, models/, the data path)
# ---------------------------------------------------------------------------

# step 32: card against CPU, one training step (the repo's 1e-3 gate on each
# parameter's update; the loss and the BN running state tighter)
STEP_LOSS_TOL = 1e-5
STEP_UPDATE_TOL = 1e-3
STEP_STATE_TOL = 1e-4
# step 32's card steps on cuDNN's default algorithms (one more on its
# deterministic ones), each against the CPU's
STEP32_REPEATS = 3
TRAIN_BATCH = 64          # step 33: ResNet-50's batch (224x224)
# the val top-1 of CONVERGENCE_r05.json's last epoch (f32, bf16): a TPU run
# on jax.random data, printed beside, not a target
R05_TOP1 = {"float32": 0.796, "bfloat16": 0.794}
# step 34: the CUDA-graph epoch against eager on cuDNN's default algorithms
# (on its deterministic ones: bit for bit), the worst step rel of the loss.
# Two eager loops from one state differ by up to 1.07e-4 (LeNet, 2 x 40
# steps) and 6.5e-3 (ResNet-50 f32, 6 steps): their weight gradients run
# cuDNN's wgrad_alg0 engine, which cuDNN documents as non-deterministic
# (CUDNN_CONVOLUTION_BWD_FILTER_ALGO_0 sums with atomics).  The limits are
# 10x and ~5x those spreads.
SCAN_DEFAULT_TOL = {"lenet": 1e-3, "resnet50": 3e-2}


def _leaves(tree):
    from xsmm_tpu_torch.models.engine import tree_flatten_with_path
    return tree_flatten_with_path(tree)


def step_split(prof, scope="smoke.step"):
    """Device time of one profiled training step by layer type, forward and
    backward, with the device's idle share and the largest kernels.

    Forward ops lie inside the graph's ``graph.<type>`` scopes (and the
    engine's ``engine.loss`` / ``engine.update``); each backward function
    is charged to the scope of the forward op with its sequence number.
    Kernels count by their launching op; the profiler's annotation spans
    (the scopes' own ranges on the device timeline) are not kernels.  The
    window is the ``scope`` range, which ends after a synchronize."""
    from torch.autograd import DeviceType

    groups = {"graph.conv": "conv", "graph.conv_bn": "conv",
              "graph.batchnorm": "bn", "graph.pooling": "pool",
              "graph.global_avg_pool": "pool", "graph.fc": "fc",
              "graph.add": "eltwise", "graph.concat": "eltwise",
              "graph.relu": "eltwise", "graph.dropout": "eltwise",
              "graph.flatten": "eltwise", "engine.loss": "loss",
              "engine.update": "update"}
    events = list(prof.events())

    def group_of(e):
        while e is not None:
            if e.name in groups:
                return groups[e.name]
            e = e.cpu_parent
        return None

    def in_backward(e):
        while e is not None:
            if getattr(e, "scope", 0) == 1:
                return True
            e = e.cpu_parent
        return False

    def device_us(e):
        """Kernel time of ``e`` and its children (annotations left out)."""
        return (sum(k.duration for k in e.kernels if k.name != e.name)
                + sum(device_us(c) for c in e.cpu_children))

    split = {}
    fwd_seq = {}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in groups and group_of(e.cpu_parent) is None:
            key = groups[e.name] + ("" if groups[e.name] == "update"
                                    else "_fwd")
            split[key] = split.get(key, 0.0) + device_us(e)
        if e.sequence_nr >= 0 and not in_backward(e):
            g = group_of(e)
            if g is not None:
                fwd_seq.setdefault((e.sequence_nr, e.thread), g)
    for e in events:
        if (e.device_type == DeviceType.CPU and getattr(e, "scope", 0) == 1
                and not in_backward(e.cpu_parent)):
            g = fwd_seq.get((e.sequence_nr, e.fwd_thread), "other")
            split[g + "_bwd"] = split.get(g + "_bwd", 0.0) + device_us(e)
    real, busy_ms, window_ms = device_busy(events, scope)
    total = sum(e.time_range.end - e.time_range.start for e in real)
    split = {k: v / 1e3 for k, v in sorted(split.items())}   # ms
    split["other"] = total / 1e3 - sum(split.values())
    by_name = {}
    for e in real:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    split["largest kernels"] = "; ".join(f"{k[:70]} {v / 1e3:.3f}"
                                         for k, v in top)
    return split, busy_ms, window_ms, 1.0 - busy_ms / window_ms


def device_busy(events, scope="smoke.step"):
    """The device events of a profile (annotations left out), the ms the
    device was busy and the ms of the ``scope`` window (to the last device
    event).  A CUDA graph's replay counts like any launch: its kernels
    carry no host op, so only the busy time and the window are read."""
    from torch.autograd import DeviceType

    real = [e for e in events if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]
    window = [e for e in events if e.name == scope
              and e.device_type == DeviceType.CPU]
    if not real or not window:
        raise RuntimeError("the profile holds no device time: "
                           "torch.profiler saw no CUDA kernel")
    spans = sorted((e.time_range.start, e.time_range.end) for e in real)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    w0 = window[0].time_range.start
    w1 = max(window[0].time_range.end, spans[-1][1])
    return real, busy / 1e3, (w1 - w0) / 1e3


def train_card_vs_cpu(args, dev, smi):
    """Step 32: one ResNet-18 step on the card and with target="cpu"
    (``models/fault3_stress.step``).  The card's step runs
    ``STEP32_REPEATS`` times on cuDNN's default algorithms and once on its
    deterministic ones, each under ``torch.profiler``, the CPU's twice;
    every card step is held to the first CPU step at the step-32 gates, and
    the repeats on each side against their first (the run-to-run spread).
    The log (each step's worst leaf and each convolution's cuDNN kernels,
    the cuDNN state, the host's precision facts) goes to
    ``chiprun_out/step32.log``; on a failure the failing steps' entries are
    printed too."""
    import torch
    from xsmm_tpu_torch.dnn.fault2_stress import precision_facts
    from xsmm_tpu_torch.models import fault3_stress as f3

    x, y = f3.batch(args.seed)
    cpu = [f3.step("cpu", x, y, args.seed) for _ in range(2)]
    card = [f3.step("cuda", x, y, args.seed, profile=True)
            for _ in range(STEP32_REPEATS)]
    card.append(f3.step("cuda", x, y, args.seed, deterministic=True,
                        profile=True))
    errs = [f3.diff(c, cpu[0]) for c in card]
    card_spread = [f3.diff(c, card[0]) for c in card[1:-1]]
    cpu_spread = f3.diff(cpu[1], cpu[0])
    ok = all(f3.passes(e) for e in errs)
    worst = max(range(len(errs)), key=lambda i: errs[i][1])
    lc, lh = card[worst]["loss"], cpu[0]["loss"]
    entries = [f3.describe(i, c, e) + (" (deterministic)"
                                       if i == len(card) - 1 else "")
               for i, (c, e) in enumerate(zip(card, errs))]
    log = os.path.join("chiprun_out", "step32.log")
    f3.write_log(log, "\n".join(
        [f"{torch.cuda.get_device_name(0)}; {f3.cudnn_state()}; host "
         f"{precision_facts()}",
         f"cpu repeat against the first (loss, update, leaf, state): "
         f"{cpu_spread}"] + entries) + "\n")
    print(f"train resnet18 width64 100 classes 8x64x64 f32, one step card "
          f"vs cpu: loss {lc:.6f} / {lh:.6f} (rel {errs[worst][0]:.3e}, tol "
          f"{STEP_LOSS_TOL:g}), worst update rel-Frobenius "
          f"{errs[worst][1]:.3e} at {errs[worst][2]} (tol "
          f"{STEP_UPDATE_TOL:g}) over {len(card[0]['updates'])} leaves, BN "
          f"state max abs {errs[worst][3]:.3e} (tol {STEP_STATE_TOL:g}); "
          f"every card step's worst update (cuDNN default "
          f"x{STEP32_REPEATS}, deterministic): "
          f"{[float(f'{e[1]:.4g}') for e in errs]}; card repeats against "
          f"the first (loss, update, state): "
          f"{[(float(f'{e[0]:.3g}'), float(f'{e[1]:.3g}'), float(f'{e[3]:.3g}')) for e in card_spread]}, "
          f"cpu against cpu: {tuple(float(f'{cpu_spread[i]:.3g}') for i in (0, 1, 3))}"
          f"; first step {card[0]['seconds'] * 1e3:.1f} / "
          f"{cpu[0]['seconds'] * 1e3:.1f} ms; log {log} "
          f"{'pass' if ok else 'FAIL'}  [{smi}]")
    if not ok:
        print(f"step 32 failed: {f3.cudnn_state()}; host "
              f"{precision_facts()}")
        for e, entry in zip(errs, entries):
            if not f3.passes(e):
                print(entry)
        raise RuntimeError("one training step: the card and the CPU "
                           "disagree")


def _train_timed(eng, batches, n):
    """Step 33's protocol on one engine: 2 warm-up steps of
    ``train_epoch`` (in the compiled form the first runs eagerly and
    captures), 10 timed ones, a validate pass timed over 4 batches after
    one warm-up batch, and one profiled step.  Returns the warm-up and
    timed results, the validate metrics, images/s of validate, the peak
    memory (allocated, and reserved: a graph's pool, held since its
    capture, counts as reserved only) and the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    warm = eng.train_epoch(iter(batches[:2]), verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = eng.train_epoch(iter(batches[2:12]), verbose=False)
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9,
               torch.cuda.max_memory_reserved() / 1e9)
    eng.validate(iter(batches[:1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = eng.validate(iter(batches[:4]))
    torch.cuda.synchronize()
    infer_ips = 4 * n / (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke.step"):
            eng.train_epoch(iter(batches[2:3]), verbose=False)
            torch.cuda.synchronize()
    return warm, timed, val, infer_ips, peak_gb, prof


def train_resnet50(args, dev, smi):
    """Step 33: ResNet-50 at its published width, 64x224x224, f32 and
    bf16, through ``train_epoch`` and ``validate`` in the compiled form
    (the card's default: CUDA graphs) and in the eager one
    (``compiled=False``), from the same parameters: each timed, with the
    model-FLOPs share, the peak memory and a profiled step's idle share;
    the eager step's profile split by layer (a graph's replay has no host
    ops to charge its kernels to)."""
    import numpy as np
    import torch
    from xsmm_tpu_torch.models import MLEngine, SolverConfig, resnet
    from xsmm_tpu_torch.models.engine import synthetic_batches

    n, hw, classes = TRAIN_BATCH, 224, 1000
    t0 = time.perf_counter()
    batches = list(synthetic_batches(12, n, hw=hw, classes=classes,
                                     seed=args.seed))
    print(f"train resnet50 data: 12 synthetic_batches of {n}x{hw}x{hw}x3 "
          f"made on the host in {time.perf_counter() - t0:.2f} s")
    peak = {"float32": FP32_FLOP_PER_S, "bfloat16": BF16_FLOP_PER_S}
    rows = {}
    for dt in ("float32", "bfloat16"):
        params, fwd = resnet(depth=50, width=64, num_classes=classes,
                             input_shape=(n, hw, hw, 3), dtype=dt,
                             seed=args.seed)
        flops = 3 * fwd.graph.forward_flops(n)
        row = {}
        for form in ("compiled", "eager"):
            eng = MLEngine(params, fwd, SolverConfig(lr=0.01),
                           **({} if form == "compiled" else
                              {"compiled": False}))
            if eng.compiled != (form == "compiled"):
                raise RuntimeError(f"resnet50 {dt}: the engine's default "
                                   f"form is not the compiled one")
            p0 = [t.detach().clone() for _, t in _leaves(eng.params)]
            warm, timed, val, infer_ips, peak_gb, prof = _train_timed(
                eng, batches, n)
            step_ms = 1e3 * n / timed["images_per_s"]
            share = flops / (step_ms / 1e3) / peak[dt]
            if form == "eager":
                split, busy_ms, window_ms, idle = step_split(prof)
            else:
                split = None
                _, busy_ms, window_ms = device_busy(list(prof.events()))
                idle = 1.0 - busy_ms / window_ms
            losses = warm["losses"] + timed["losses"]
            moved = sum(not torch.equal(a, b) for a, (_, b) in
                        zip(p0, _leaves(eng.params)))
            ok = (np.isfinite(losses).all() and np.isfinite(val["loss"])
                  and moved == len(p0))
            # the profiler's host overhead stretches the profiled step: the
            # timed loop's step against the same device work gives the idle
            # share without it
            idle_timed = max(0.0, 1.0 - busy_ms / step_ms)
            print(f"train resnet50 width64 {dt} batch {n} {hw}^2, {form} "
                  f"({dict(eng.forms)}): {timed['images_per_s']:.1f} images/s"
                  f" training ({step_ms:.2f} ms a step, 10 steps of "
                  f"train_epoch, host batches), {infer_ips:.1f} images/s "
                  f"validate (4 batches); model FLOPs 3 x {flops / 3e9:.1f} "
                  f"GFLOP a step = {share:.4f} of {peak[dt] / 1e12:.0f} "
                  f"TFLOP/s; peak memory {peak_gb[0]:.2f} GB allocated, "
                  f"{peak_gb[1]:.2f} GB reserved; device busy "
                  f"{busy_ms:.3f} ms of a {window_ms:.3f} ms profiled step, "
                  f"idle share {idle:.4f} profiled, {idle_timed:.4f} against "
                  f"the timed step; losses {losses[0]:.4f} .. "
                  f"{losses[-1]:.4f}; {moved} of {len(p0)} parameters moved "
                  f"{'pass' if ok else 'FAIL'}  [{smi}]")
            if split is not None:
                print(f"split resnet50 {dt} one eager step, device ms: "
                      + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                                  else f"{k}: {v}" for k, v in split.items())
                      + f"  [{smi}]")
            if not ok:
                raise RuntimeError(f"resnet50 {dt} {form}: a non-finite "
                                   f"loss or a parameter that did not move")
            pre = "" if form == "compiled" else "eager_"
            row.update({f"{pre}images_per_s": timed["images_per_s"],
                        f"{pre}infer_images_per_s": infer_ips,
                        f"{pre}step_ms": step_ms,
                        f"{pre}flops_share": share,
                        f"{pre}peak_gb": peak_gb,
                        f"{pre}idle_share": idle,
                        f"{pre}idle_share_timed": idle_timed,
                        f"{pre}busy_ms": busy_ms})
            if split is not None:
                row["split_ms"] = split
            del eng, p0, prof
            torch.cuda.empty_cache()
        print(f"train resnet50 {dt}: the compiled step {row['step_ms']:.2f} "
              f"ms against the eager {row['eager_step_ms']:.2f} ms "
              f"({row['eager_step_ms'] / row['step_ms']:.3f}x), idle "
              f"{row['idle_share_timed']:.4f} against "
              f"{row['eager_idle_share_timed']:.4f}  [{smi}]")
        rows[dt] = row
        del params, fwd
        torch.cuda.empty_cache()
    del batches
    return rows


def train_convergence(args, dev, smi):
    """Step 34, first part: CONVERGENCE_r05.json's protocol
    (samples/convergence_run.py) in f32 and bf16."""
    import numpy as np
    import torch
    from xsmm_tpu_torch.models import MLEngine, SolverConfig, resnet
    from xsmm_tpu_torch.models.engine import template_batches

    epochs, bpe, batch, hw, classes = 8, 20, 256, 32, 100
    for dt in ("float32", "bfloat16"):
        params, fwd = resnet(depth=18, num_classes=classes, width=16,
                             input_shape=(batch, hw, hw, 3), dtype=dt)
        eng = MLEngine(params, fwd, SolverConfig(
            lr=0.02, lr_policy="poly", max_epochs=epochs, weight_decay=1e-4))
        rows = []
        t0 = time.perf_counter()
        for ep in range(epochs):
            st = eng.train_epoch(template_batches(
                bpe, batch, hw=hw, classes=classes, sigma=1.5, epoch=ep),
                verbose=False)
            val = eng.validate(template_batches(
                4, batch, hw=hw, classes=classes, sigma=1.5,
                epoch=1000 + ep))
            rows.append((st["loss"], val["acc"], st["images_per_s"]))
        first, last = rows[0], rows[-1]
        ok = last[0] < 0.6 * first[0] and last[1] >= 3.0 / classes
        print(f"converge resnet18/width16 {dt} batch {batch} {classes} "
              f"classes {hw}^2, {epochs} epochs x {bpe} (poly lr 0.02, sigma "
              f"1.5) in {time.perf_counter() - t0:.1f} s: loss "
              f"{first[0]:.4f} -> {last[0]:.4f} (criterion < 0.6 x first), "
              f"val top-1 by epoch "
              f"{' '.join(f'{r[1]:.3f}' for r in rows)} (criterion >= "
              f"{3.0 / classes:.2f}; CONVERGENCE_r05.json's last epoch "
              f"{R05_TOP1[dt]}, a TPU run on other data), images/s by epoch "
              f"{' '.join(f'{r[2]:.0f}' for r in rows)} "
              f"{'pass' if ok else 'FAIL'}  [{smi}]")
        if not ok:
            raise RuntimeError(f"resnet18 {dt} did not meet the convergence "
                               f"criterion")
        del eng, fwd, params
        torch.cuda.empty_cache()


def scan_against_eager(make, batch_fn, b, nb, epochs, deterministic, dev):
    """One CUDA-graph engine and two eager ones from one state; each epoch
    the graph's ``train_epoch_scan`` and the two ``train_epoch`` over the
    same generator's batches, on cuDNN's deterministic or default
    algorithms.  Returns the worst step rel of the loss, graph against the
    first eager and the second eager against the first, the graph's and
    the first eager's images/s of the last epoch and the graph's losses."""
    import torch
    from xsmm_tpu_torch.models import MLEngine, SolverConfig

    def worst(got, want):
        return max(abs(g - w) / abs(w) for g, w in zip(got, want))

    params, fwd = make()
    engs = [MLEngine(params, fwd, SolverConfig(lr=0.002),
                     compiled=None if i == 0 else False) for i in range(3)]
    del params
    ge = ee = 0.0
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        for _ in range(epochs):
            og = engs[0].train_epoch_scan(nb, batch_fn, b, verbose=False)
            oe = []
            for eng in engs[1:]:
                gen = torch.Generator(device=dev).manual_seed(
                    eng.scan_seed(0))
                oe.append(eng.train_epoch((batch_fn(gen) for _ in range(nb)),
                                          verbose=False))
            ge = max(ge, worst(og["losses"], oe[0]["losses"]))
            ee = max(ee, worst(oe[1]["losses"], oe[0]["losses"]))
    finally:
        torch.backends.cudnn.deterministic = saved
    del engs
    torch.cuda.empty_cache()
    return ge, ee, og["images_per_s"], oe[0]["images_per_s"], og["losses"]


def train_scan(args, dev, smi):
    """Step 34, second part: the CUDA-graph epoch against the eager loop,
    for LeNet and for ResNet-50 as step 33 trains it.  On cuDNN's
    deterministic algorithms the losses are bit for bit the eager loop's.
    On the default ones (the main path's) cuDNN's weight gradients may
    differ from run to run: there the spread of two eager loops is
    printed beside the graph's difference, which is held to
    SCAN_DEFAULT_TOL."""
    from xsmm_tpu_torch.models import lenet, resnet
    from xsmm_tpu_torch.models.engine import template_batch_fn

    cases = [
        ("lenet", "lenet", 256, 28, 1, 10, 40, 2,
         lambda: lenet(num_classes=10, input_shape=(256, 28, 28, 1)))]
    for dt in ("float32", "bfloat16"):
        cases.append((f"resnet50 width64 {dt}", "resnet50", TRAIN_BATCH, 224,
                      3, 1000, 6, 1, lambda dt=dt: resnet(
                          depth=50, width=64, num_classes=1000,
                          input_shape=(TRAIN_BATCH, 224, 224, 3), dtype=dt,
                          seed=args.seed)))
    bad = []
    for deterministic in (True, False):
        for name, key, b, hw, ch, classes, nb, epochs, make in cases:
            bf = template_batch_fn(b, hw=hw, classes=classes, chans=ch)
            ge, ee, g_ips, e_ips, losses = scan_against_eager(
                make, bf, b, nb, epochs, deterministic, dev)
            tol = 0.0 if deterministic else SCAN_DEFAULT_TOL[key]
            # LeNet's 80 steps must learn; ResNet-50's 6 need not
            ok = ge <= tol and (key != "lenet" or losses[-1] < losses[0])
            print(f"scan {name} batch {b} {hw}^2, cuDNN "
                  f"{'deterministic' if deterministic else 'default'} "
                  f"algorithms, {epochs} x {nb} steps (the first eager as "
                  f"the warm-up, then the capture): CUDA graph "
                  f"{g_ips:.1f} images/s, eager train_epoch {e_ips:.1f} "
                  f"images/s; losses {losses[0]:.5f} .. {losses[-1]:.5f}; "
                  f"worst step rel, graph against eager {ge:.3e} (tol "
                  f"{tol:g}), eager against eager {ee:.3e} "
                  f"{'pass' if ok else 'FAIL'}  [{smi}]")
            if not ok:
                bad.append(name)
    if bad:
        raise RuntimeError(f"the CUDA-graph epoch does not give the eager "
                           f"loop's losses, or does not learn: {bad}")


def train_datapipe(args, dev, smi):
    """Step 35: DATAPIPE_r05.json's protocol (samples/data_pipeline_run.py)
    on the card: a PPM corpus -> ingest_image_dir -> the native DataLoader
    -> make_augment on the card -> cifar10net, batch 128, 30 epochs."""
    import shutil
    import numpy as np
    import torch
    from xsmm_tpu_torch.models import MLEngine, SolverConfig, cifar10net
    from xsmm_tpu_torch.utils.augment import make_augment
    from xsmm_tpu_torch.utils.dataset import DataLoader
    from xsmm_tpu_torch.utils.images import ingest_image_dir, write_pnm

    hw, classes, chans, batch, epochs = 32, 10, 3, 128, 30
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "xsmm_tpu_torch", "build", "datapipe")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        rng = np.random.default_rng(7)
        templates = rng.integers(48, 208, (classes, hw, hw, chans))
        for split, per in (("train", 120), ("val", 24)):
            for c in range(classes):
                d = os.path.join(work, split, f"class{c:02d}")
                os.makedirs(d)
                noise = rng.normal(0.0, 18.0, (per, hw, hw, chans))
                imgs = np.clip(templates[c] + noise, 0, 255).astype(np.uint8)
                for i in range(per):
                    write_pnm(os.path.join(d, f"img{i:04d}.ppm"), imgs[i])
        t_corpus = time.perf_counter() - t0
        t0 = time.perf_counter()
        paths = {s: os.path.join(work, s + ".xsd") for s in ("train", "val")}
        man = {s: ingest_image_dir(os.path.join(work, s), paths[s],
                                   hw=(hw, hw), channels=chans)
               for s in paths}
        t_ingest = time.perf_counter() - t0
        params, fwd = cifar10net(num_classes=classes,
                                 input_shape=(batch, hw, hw, chans))
        eng = MLEngine(params, fwd, SolverConfig(lr=0.01, lr_policy="poly",
                                                 max_epochs=epochs))
        aug = make_augment(crop=hw, pad=4, flip=True, brightness=0.1,
                           contrast=0.1)
        gen = torch.Generator(device=dev).manual_seed(1000)
        rows = []
        backend = None
        for ep in range(epochs):
            dl = DataLoader(paths["train"], batch=batch, seed=ep, device=dev)
            backend = dl.backend
            st = eng.train_epoch(((aug(gen, x), y) for x, y in dl),
                                 verbose=False)
            val = eng.validate(DataLoader(paths["val"], batch=batch, seed=0,
                                          device=dev))
            rows.append((st["loss"], val["acc"], st["images_per_s"]))
        first, last = rows[0], rows[-1]
        ok = (backend == "native" and last[0] < 0.6 * first[0]
              and last[1] >= 3.0 / classes)
        ips = sorted(r[2] for r in rows[1:])[(epochs - 1) // 2]
        print(f"datapipe cifar10net batch {batch}: corpus {man['train']['n_images']}"
              f" + {man['val']['n_images']} PPM files written in "
              f"{t_corpus:.2f} s, ingested in {t_ingest:.2f} s; loader "
              f"{backend}; {epochs} epochs, loss {first[0]:.4f} -> "
              f"{last[0]:.4f}, val top-1 {rows[0][1]:.3f} -> {last[1]:.3f} "
              f"(criterion: loss < 0.6 x first, top-1 >= "
              f"{3.0 / classes:.1f}); disk to trained step {ips:.1f} "
              f"images/s (median of epochs 1-{epochs - 1}; epoch 0 "
              f"{rows[0][2]:.1f}) {'pass' if ok else 'FAIL'}  [{smi}]")
        if not ok:
            raise RuntimeError("the data path did not meet its criterion")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def train_cell(args, dev, smi):
    """Step 35, last part: the benchmark cell ``resnet50_train.bf16_b256``
    (``portbench/drivers/resnet_train.py``) for 4 steps at its own batch,
    after its set-up's training steps,
    with the port's configuration and ``XSMM_*`` settings put back after
    it: the steps' times, the engine's forms, the peak memory and the
    numbers of its check against the f32 reference, each beside its
    limit."""
    import dataclasses

    import xsmm_tpu_torch as xp
    from portbench import run
    from xsmm_tpu_torch.utils import graphs

    cell = "resnet50_train.bf16_b256"
    saved = dataclasses.asdict(xp.get_config())
    env = {k: v for k, v in os.environ.items() if k.startswith("XSMM_")}
    captures = graphs.captures
    t0 = time.perf_counter()
    try:
        res, info = run.run_cell(cell, args.seed, 0, False, "cuda", steps=4)
    finally:
        for k in [k for k in os.environ if k.startswith("XSMM_")]:
            del os.environ[k]
        os.environ.update(env)
        xp.set_config(**saved)
    m = res["metrics"]
    print(f"train cell {cell}: {info['steps']} steps, step_ms_p95 "
          f"{m['step_ms_p95']['value']:.2f}, {m['work_gflops']['value']:.1f}"
          f" GFLOP/s, peak {m['peak_mem_gib']['value']:.3f} GiB, setup "
          f"{m['setup_s']['value']:.1f} s, checks "
          + ", ".join(f"{k} {c['value']:.4g} (limit {c['limit']:.4g})"
                      for k, c in res["checks"].items())
          + f"; {graphs.captures - captures} capture, "
          f"{time.perf_counter() - t0:.1f} s "
          f"{'pass' if res['correct'] else 'FAIL'}  [{smi}]")
    if graphs.captures - captures != 1:
        raise RuntimeError(f"{cell}: {graphs.captures - captures} captures "
                           f"for the steps of one key, not 1")
    if not res["correct"]:
        raise RuntimeError(f"{cell}: the driver's steps do not meet the "
                           f"cell's limits: {res['checks']}")


def kernel_modules():
    """The modules of the 22 kernels' wrappers, each with its launch
    counters (``*launches`` dicts) and ``reset_launches``."""
    from xsmm_tpu_torch.dnn import pooling, rnn_seq
    from xsmm_tpu_torch.ops import (packed_kernels, smm_packed,
                                    spgemm_kernels, tiled_gemm_kernels,
                                    xcopy_kernels)
    return (smm_packed, spgemm_kernels, tiled_gemm_kernels, xcopy_kernels,
            packed_kernels, rnn_seq, pooling)


def kernel_launch_counts():
    """Every launch counter of ``kernel_modules()`` that is not 0."""
    return {f"{m.__name__.rsplit('.', 1)[1]}.{attr}.{k}": n
            for m in kernel_modules() for attr, counts in vars(m).items()
            if attr.endswith("launches") and isinstance(counts, dict)
            for k, n in counts.items() if n}


def training_phase(args, dev, smi):
    """Steps 32 to 35 of the module docstring (the training framework)."""
    import torch

    # the training path launches none of the 22 kernels: the handles run
    # on cuDNN, cuBLAS and torch ops (as the JAX package's on XLA).  A
    # wrapper counts where it launches, and a CUDA graph's replay counts
    # what it replays: any launch in a step shows.
    for m in kernel_modules():
        m.reset_launches()
    if kernel_launch_counts():
        raise RuntimeError("launch counts not 0 after their reset")
    train_card_vs_cpu(args, dev, smi)
    torch.cuda.empty_cache()
    rows = train_resnet50(args, dev, smi)
    torch.cuda.empty_cache()
    train_convergence(args, dev, smi)
    torch.cuda.empty_cache()
    train_scan(args, dev, smi)
    torch.cuda.empty_cache()
    train_datapipe(args, dev, smi)
    torch.cuda.empty_cache()
    train_cell(args, dev, smi)
    launched = kernel_launch_counts()
    print(f"train path kernel launches (every wrapper's counts, set to 0 "
          f"before step 32): {launched or 'none'}")
    if launched:
        raise RuntimeError(f"the training path launched kernels: {launched}")
    return rows


# ---------------------------------------------------------------------------
# Steps 36-40: the distributed layer (parallel/, sync BN, MLEngine over a
# mesh, entry.py)
# ---------------------------------------------------------------------------

DIST_RANKS = (1, 2, 4)
DIST_CHUNKS = (1, 4)
# (dtype, f64 schedule) of the ring; gates against numpy f64 gold
DIST_RING_CASES = (("float32", None), ("float64", "split2"),
                   ("float64", "fold"))
DIST_GOLD_TOL = {"float32": 1e-3, "float64": 1e-5}
DIST_SMM = ("split2_fast", "float32", "split2")
# the kernels of the distributed path: (module, launch counter) by row name
DIST_KERNELS = {
    "packed_split2_fast": "smm_packed", "packed_f32": "smm_packed",
    "packed_split2": "smm_packed",
    "spgemm_unroll_f32": "spgemm_kernels",
    "spgemm_unroll_f64": "spgemm_kernels",
    "spgemm_acc_f32": "spgemm_kernels", "spgemm_acc_f64": "spgemm_kernels",
    "getrf_unrolled": "packed_kernels", "getrf_loop": "packed_kernels",
    "trsm_unrolled": "packed_kernels", "trsm_loop": "packed_kernels",
}
DIST_ENGINE_STEPS = 3
# step 38: the dp = 2 ResNet-50 step's whole update (every leaf in one
# vector, rel-Frobenius) against the one-device step's, on cuDNN's
# deterministic algorithms.  Between the sound step's reading and a planted
# fault's (a rank's gradient share dropped, or the shares doubled), both
# of which the step measures and must find above it.  On an H100 80GB
# HBM3 at 700 W: sound 2.897e-2 (the one-device step with its input one
# ulp up reads 2.236e-2: the step's own conditioning), faults 0.7119 and
# 1.001.
DIST_UPDATE_TOL = 0.1


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def _bits(got, want):
    """(bit for bit, max abs difference) of two tensors or tuples of them."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    same = all(g.shape == w.shape and bool((g == w).all())
               for g, w in zip(got, want))
    err = max((g.double() - w.double()).abs().max().item()
              for g, w in zip(got, want))
    return same, err


def compiled_vs_eager(label, fn, eager, args, smi):
    """A builder's default callable ``fn`` (compiled: CUDA graphs) against
    its ``compiled=False`` form ``eager`` on ``args``: the call that
    copies the caller's shards in, the call on the graph's own inputs and
    a later call each bit for bit the eager call's; the ms of the eager
    call, of the two compiled calls and of the replay alone (so the copies
    in and out apart); ``dist_spmm.forms`` over these calls.  Fails unless
    ``fn`` ran as a graph, never eagerly."""
    import torch
    from xsmm_tpu_torch.parallel import dist_spmm
    from xsmm_tpu_torch.utils.timer import cuda_time_ms

    f0 = dict(dist_spmm.forms)
    want = eager(*args)
    got = [fn(*args)]
    entry = fn.entry(*args)
    if entry is None:
        raise RuntimeError(f"{label}: the default callable kept no graph")
    got += [fn(*args), fn(*entry.args)]
    torch.cuda.synchronize()
    same = all(_bits(tuple(o.gather() for o in _tup(g)),
                     tuple(o.gather() for o in _tup(want)))[0] for g in got)
    eager_ms = cuda_time_ms(eager, *args, warmup=2, iters=10)
    eager_calls = 1 + 2 + 10       # want, then cuda_time_ms's calls
    copy_ms = cuda_time_ms(fn, *args, warmup=2, iters=10)
    own_ms = cuda_time_ms(fn, *entry.args, warmup=2, iters=10)
    replay_ms = cuda_time_ms(entry.replay, warmup=2, iters=20)
    forms = {k: dist_spmm.forms[k] - f0[k] for k in f0}
    ok = (same and forms["eager"] == eager_calls and forms["graph"] >= 1
          and forms["graph_copy"] >= 1)
    print(f"compiled {label}: eager {eager_ms:.4f} ms, compiled "
          f"{copy_ms:.4f} ms (copies in and out) / {own_ms:.4f} ms (its own "
          f"inputs: copy out) / replay alone {replay_ms:.4f} ms: copy in "
          f"{copy_ms - own_ms:.4f}, copy out {own_ms - replay_ms:.4f} ms; "
          f"{eager_ms / copy_ms:.2f}x; forms {forms} (the eager form's "
          f"{eager_calls} calls as eager); bit for bit {same} "
          f"{'pass' if ok else 'FAIL'}  [{smi}]")
    if not ok:
        raise RuntimeError(f"{label}: the compiled callable is not a graph "
                           f"bit for bit its eager form")
    return {"eager_ms": eager_ms, "compiled_ms": copy_ms, "own_ms": own_ms,
            "replay_ms": replay_ms, "forms": forms}


def dist_ring(args, dev, smi, max_abs):
    """Step 36: ``ring_spmm_csr`` on the 150x150 PyFR operator at N =
    ``--sparse-n``: d = 1, 2, 4, chunks 1 and 4, f32 and f64 under split2
    and fold, against numpy f64 gold; every block kernel against its plain
    version on the ring's own panels, bit for bit; the ms at each d beside
    the local kernel's; ``schedule_check`` on a trace of d = 4, chunks 4."""
    import numpy as np
    import torch
    import xsmm_tpu_torch as xp
    from xsmm_tpu_torch.ops import spgemm_kernels as sk
    from xsmm_tpu_torch.parallel import dist_spmm, schedule_check
    from xsmm_tpu_torch.parallel.mesh import make_mesh, virtual_devices
    from xsmm_tpu_torch.utils.timer import cuda_time_ms

    name, op = pyfr_operators(np)[2]
    n = args.sparse_n
    g = torch.Generator(device=dev).manual_seed(args.seed)
    b64 = torch.randn((op.shape[1], n), generator=g, device=dev,
                      dtype=torch.float64)
    gold = torch.from_numpy(op).to(dev) @ b64
    runs = []
    sk.reset_launches()
    dist_spmm.reset_counts()
    for dtype, sched in DIST_RING_CASES:
        for d in DIST_RANKS:
            kpad = -(-op.shape[1] // d) * d
            bp = torch.zeros((kpad, n), dtype=torch.float64, device=dev)
            bp[:op.shape[1]] = b64
            bh = bp.float()
            streams = {None: [bh], "split2": [bh, (bp - bh.double()).float()],
                       "fold": [bh]}[sched]
            mesh = make_mesh((1, d), ("dp", "mp"),
                             devices=virtual_devices(d))
            shards = [dist_spmm.shard_rows(mesh, s) for s in streams]
            for chunks in DIST_CHUNKS:
                fn = dist_spmm.ring_spmm_csr(
                    mesh, op.astype(np.float32) if sched is None else op, n,
                    dtype=dtype, chunks=chunks,
                    f64_schedule=sched or "split2")
                out = fn(*shards)
                out = out if isinstance(out, tuple) else (out,)
                c = sum(o.gather().double() for o in out)[:op.shape[0]]
                torch.cuda.synchronize()
                err = xp.matdiff(gold.cpu().numpy(),
                                 c.cpu().numpy()).normf_rel
                tol = DIST_GOLD_TOL[dtype]
                label = f"{dtype}{'/' + sched if sched else ''} d={d} " \
                        f"chunks={chunks}"
                print(f"dist ring {name} N={n} {label}: gold rel-Frobenius "
                      f"{err:.3e} (tol {tol:g}) "
                      f"{'pass' if err < tol else 'FAIL'}")
                if not err < tol:
                    raise RuntimeError(f"ring {label}: {err:.3e} against "
                                       f"gold")
                runs.append((label, d, chunks, dtype, sched, fn, shards))
    launched = dict(sk.launches)
    hops = dict(dist_spmm.hops)
    print(f"dist ring launches (counts set to 0 before the ring's calls): "
          f"{launched}; routes {dict(sk.route_launches)}; hops {hops}")
    for k, v in launched.items():
        if v < 1:
            raise RuntimeError(f"the ring did not launch {k}")

    # every block kernel against its plain version, on the ring's panels
    seen = set()
    checked = 0
    for label, d, chunks, dtype, sched, fn, shards in runs:
        for e in range(d):
            for j in range(d):
                kern = fn.kernels[e][j]
                if kern is None or (id(kern), j) in seen:
                    continue
                seen.add((id(kern), j))
                o = kern._operand(dev)
                nc = kern.n
                panels = [s.shards[j][:, :nc].contiguous() for s in shards]
                cin = torch.randn((o.m, nc), generator=g, device=dev)
                if dtype == "float32":
                    pairs = [("spgemm_unroll_f32", sk.unroll_f32(o, *panels),
                              sk.unroll_f32_plain(o, *panels)),
                             ("spgemm_acc_f32", sk.acc_f32(o, cin, *panels),
                              sk.acc_f32_plain(o, cin, *panels))]
                else:
                    c_lo = sched == "split2"
                    cl = cin * 1e-8 if c_lo else None
                    pairs = [("spgemm_unroll_f64",
                              sk.unroll_f64(o, *panels, c_lo=c_lo),
                              sk.unroll_f64_plain(o, *panels, c_lo=c_lo)),
                             ("spgemm_acc_f64",
                              sk.acc_f64(o, cin, cl, *panels),
                              sk.acc_f64_plain(o, cin, cl, *panels))]
                for kname, got, want in pairs:
                    same, err = _bits(got, want)
                    max_abs[kname] = max(max_abs.get(kname, 0.0), err)
                    checked += 1
                    if not same:
                        raise RuntimeError(
                            f"ring {label}: block ({e}, {j}) {kname} and "
                            f"its plain version differ by {err:.3e}")
    print(f"dist ring plain: {checked} block kernels of the ring's calls, "
          f"each bit for bit against its plain version on the ring's panels "
          f"pass")

    # times: each ring call, compiled (the default) and eager, beside the
    # local kernel on the whole B
    local_ms = {}
    for label, d, chunks, dtype, sched, fn, shards in runs:
        key = (dtype, sched)
        if key not in local_ms:    # d = 1 comes first: its shard is all of B
            kern = xp.create_csr_soa(op.astype(np.float32) if sched is None
                                     else op, n, dtype=dtype,
                                     f64_schedule=sched or "split2")
            local_ms[key] = cuda_time_ms(
                kern._fn, *[s.shards[0] for s in shards], warmup=3, iters=20)
        eager = dist_spmm.ring_spmm_csr(
            shards[0].mesh, op.astype(np.float32) if sched is None else op, n, dtype=dtype,
            chunks=chunks, f64_schedule=sched or "split2", compiled=False)
        t = compiled_vs_eager(f"dist ring {name} N={n} {label}", fn, eager,
                              shards, smi)
        print(f"time  dist ring {name} N={n} {label}: {t['eager_ms']:.4f} ms "
              f"eager, {t['compiled_ms']:.4f} ms compiled (one CUDA graph, "
              f"bit for bit), against the local kernel's "
              f"{local_ms[key]:.4f} ms ({t['eager_ms'] / local_ms[key]:.2f}x"
              f", compiled {t['compiled_ms'] / local_ms[key]:.2f}x; {d} "
              f"virtual rank(s) on one card share its SMs: the ring "
              f"machinery's cost, not scaling)  [{smi}]")

    os.makedirs(os.path.join("xsmm_tpu_torch", "build", "trace"),
                exist_ok=True)
    st = schedule_check.check_ring(
        d=4, chunks=4, n=n, op=op.astype(np.float32),
        trace_path=os.path.join("xsmm_tpu_torch", "build", "trace",
                                "ring_trace.json"), seed=args.seed,
        graph=True)
    gr = st["graph"]
    share = st["under_compute"] / max(st["hops"], 1)
    graph_share = gr["copies_under_kernel"] / max(gr["copies"], 1)
    print(f"dist schedule d=4 chunks=4 f32 N={n}, eager form: {st['hops']} "
          f"hops (expected {st['expected_hops']}), {share:.3f} of them under "
          f"compute of another sub-panel (min {st['min_under_us']:.1f} us "
          f"shared), {st['ordered']} after their sending compute, at most "
          f"{st['max_live_images']} images of a sub-panel live on a rank; "
          f"hop device events {st['hop_device_events']}; overlap_ok "
          f"{st['overlap_ok']} order_ok {st['order_ok']} live_ok "
          f"{st['live_ok']} hops_ok {st['hops_ok']}; the entry point's "
          f"compiled form: {gr['call_ms']:.4f} ms a call (replay "
          f"{gr['replay_ms']:.4f}) against {gr['eager_ms']:.4f} eager; its "
          f"replay: {gr['kernels']} kernels and {gr['copies']} copies, "
          f"{gr['copies_under_kernel']} copies overlapping a kernel (share "
          f"of hops under compute {graph_share:.3f}), kernel "
          f"{gr['kernel_us']:.1f} us and copy {gr['copy_us']:.1f} us in a "
          f"{gr['span_us']:.1f} us span  [{smi}]")
    if not (st["order_ok"] and st["hops_ok"]):
        raise RuntimeError(f"the ring's event order is broken: {st}")
    if graph_share == 0:
        raise RuntimeError("the compiled ring's replay runs no hop under "
                           "compute (d = 4, chunks 4)")
    return launched


def dist_wrappers(args, dev, smi, max_abs):
    """Step 37: ``dp_batched_smm`` at 23^3, B = ``--batch``, over 4 ranks
    (split2_fast, float32, split2) and ``dp_packed`` getrf and trsm at 16^2,
    B = ``--packed-batch``, and at ``--packed-big-m``, B =
    ``--packed-big-batch``, over 4 ranks: each against gold, each rank's
    kernel against its plain version on the same shard."""
    import numpy as np
    import torch
    import xsmm_tpu_torch as xp
    from xsmm_tpu_torch.ops import packed_kernels as pk
    from xsmm_tpu_torch.ops import smm_packed
    from xsmm_tpu_torch.ops.pack_util import pack_lanes
    from xsmm_tpu_torch.parallel import dist_spmm
    from xsmm_tpu_torch.parallel.mesh import (NamedSharding, P, device_put,
                                              make_mesh, virtual_devices)
    from xsmm_tpu_torch.utils.timer import cuda_time_ms

    mesh = make_mesh((4, 1), ("dp", "mp"), devices=virtual_devices(4))
    lanes = NamedSharding(mesh, P(None, None, "dp"))
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    B = args.batch
    a64, b64 = (torch.randn((B, M, K), generator=g, device=dev,
                            dtype=torch.float64) for _ in range(2))
    gold = torch.einsum("bmk,bkn->bmn", a64[:GOLD_SUBSET], b64[:GOLD_SUBSET])
    smm_packed.reset_launches()
    pk.reset_launches()
    calls = []
    for strategy in DIST_SMM:
        xp.set_config(f64_strategy=strategy)
        kern = xp.dmmdispatch(M, N, K, batch=B, beta=0.0)
        ah, al = xp.split_f64(a64, dev)
        bh, bl = xp.split_f64(b64, dev)
        ops = {"split2": [kern.pack_a(ah), kern.pack_a(al), kern.pack_b(bh),
                          kern.pack_b(bl)],
               "split2_fast": [kern.pack_a(ah), kern.pack_b(bh),
                               kern.pack_b(bl)],
               "float32": [kern.pack_a(ah), kern.pack_b(bh)]}[strategy]
        sharded = [device_put(o, lanes) for o in ops]
        out = dist_spmm.dp_batched_smm(mesh, kern)(*sharded)
        out = out if isinstance(out, tuple) else (out,)
        c = sum(o.gather().double() for o in out)
        c = kern.unpack_c(c, B)[:GOLD_SUBSET]
        torch.cuda.synchronize()
        err = xp.matdiff(gold.cpu().numpy(), c.cpu().numpy()).normf_rel
        kname = {"split2": "packed_split2", "split2_fast":
                 "packed_split2_fast", "float32": "packed_f32"}[strategy]
        print(f"dist dp_batched_smm {strategy} {M}^3 B={B} over 4 ranks: "
              f"gold rel-Frobenius {err:.3e} (tol 1e-6) "
              f"{'pass' if err < 1e-6 else 'FAIL'}")
        if not err < 1e-6:
            raise RuntimeError(f"dp_batched_smm {strategy}: {err:.3e}")
        calls.append((kname, kern, sharded, out, ops))
    xp.set_config(f64_strategy="split2_fast")

    packed = []
    for m, bsz in ((16, args.packed_batch),
                   (args.packed_big_m, args.packed_big_batch)):
        a = torch.randn((bsz, m, m), generator=g, device=dev)
        a = a + m * torch.eye(m, device=dev)
        low = torch.tril(a)
        rhs = torch.randn((bsz, m, m), generator=g, device=dev)
        getrf = xp.getrf_dispatch(m, m, batch=bsz)
        trsm = xp.trsm_dispatch(m, m, batch=bsz)
        ap, lp, bp = (device_put(pack_lanes(t), lanes) for t in (a, low, rhs))
        lu = dist_spmm.dp_packed(mesh, getrf.packed, 1)(ap)
        x = dist_spmm.dp_packed(mesh, trsm.packed, 2)(lp, bp)
        luf = lu.gather().permute(2, 0, 1).double()
        xf = x.gather().permute(2, 0, 1).double()
        torch.cuda.synchronize()
        lo = torch.tril(luf, -1) + torch.eye(m, device=dev,
                                             dtype=torch.float64)
        e_lu = xp.matdiff(a.double().cpu().numpy(),
                          (lo @ torch.triu(luf)).cpu().numpy()).normf_rel
        e_x = xp.matdiff(rhs.double().cpu().numpy(),
                         (low.double() @ xf).cpu().numpy()).normf_rel
        ok = e_lu < PACKED_TOL["f32"] and e_x < PACKED_TOL["f32"]
        print(f"dist dp_packed getrf / trsm {m}^2 B={bsz} over 4 ranks: "
              f"L U against A {e_lu:.3e}, L X against B {e_x:.3e} (tol "
              f"{PACKED_TOL['f32']:g}) {'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"dp_packed {m}^2 against gold")
        packed.append((getrf.kernel_name, lu, [ap], getrf))
        packed.append((trsm.kernel_name, x, [lp, bp], trsm))
    launched = {**{k: v for k, v in smm_packed.launches.items()},
                **{k: v for k, v in pk.launches.items()}}
    print(f"dist wrappers launches (counts set to 0 before their calls): "
          f"{launched}")
    for k in ("packed_split2_fast", "packed_f32", "packed_split2",
              "getrf_unrolled", "getrf_loop", "trsm_unrolled", "trsm_loop"):
        if launched.get(k, 0) < 1:
            raise RuntimeError(f"the dp wrappers did not launch {k}")

    # each rank's kernel against its plain version on its own shard
    for kname, kern, sharded, out, ops in calls:
        for i in range(len(out[0].shards)):
            shard_ops = [s.shards[i] for s in sharded]
            want = getattr(smm_packed, kname + "_plain")(
                *shard_ops, **({"out_dtype": torch.float32}
                               if kname == "packed_f32" else {}))
            want = want if isinstance(want, tuple) else (want,)
            got = tuple(o.shards[i] for o in out)
            d = max((gg.double() - ww.double()).abs().max().item()
                    for gg, ww in zip(got, want))
            r = max((torch.linalg.vector_norm(gg.double() - ww.double())
                     / torch.linalg.vector_norm(ww.double())).item()
                    for gg, ww in zip(got, want))
            max_abs[kname] = max(max_abs.get(kname, 0.0), d)
            if not r <= PLAIN_TOL:
                raise RuntimeError(f"dp {kname} rank {i}: {r:.3e} from plain")
    for kname, out, ins, _ in packed:
        for i in range(len(out.shards)):
            args_ = [t.shards[i] for t in ins]
            if kname.startswith("trsm"):
                args_.append(False)
            same, err = _bits(out.shards[i],
                              getattr(pk, kname + "_plain")(*args_))
            max_abs[kname] = max(max_abs.get(kname, 0.0), err)
            if not same:
                raise RuntimeError(f"dp {kname} rank {i}: not bit for bit "
                                   f"({err:.3e})")
    print("dist wrappers plain: every rank's kernel against its plain "
          "version on its shard (smm rel-Frobenius <= 1e-6, packed LA bit "
          "for bit) pass")

    # times: the 4-rank call, compiled (the default) and eager, beside the
    # kernel on the whole batch
    for kname, kern, sharded, out, ops in calls:
        t = compiled_vs_eager(
            f"dist dp_batched_smm {kname} {M}^3 B={B} 4 ranks",
            dist_spmm.dp_batched_smm(mesh, kern),
            dist_spmm.dp_batched_smm(mesh, kern, compiled=False), sharded,
            smi)
        one = cuda_time_ms(kern.packed, *ops, warmup=2, iters=10)
        print(f"time  dist dp_batched_smm {kname} {M}^3 B={B}: 4 ranks "
              f"{t['eager_ms']:.4f} ms eager, {t['compiled_ms']:.4f} ms "
              f"compiled, against one call on the whole batch {one:.4f} ms "
              f"(4 virtual ranks share one card)  [{smi}]")
    for kname, out, ins, kern in packed:
        n_in = len(ins)
        compiled_vs_eager(
            f"dist dp_packed {kname} {ins[0].shape[0]}^2 B={ins[0].shape[2]}"
            f" 4 ranks", dist_spmm.dp_packed(mesh, kern.packed, n_in),
            dist_spmm.dp_packed(mesh, kern.packed, n_in, compiled=False),
            ins, smi)

    # the dense ring and the column-sharded product on the 150x150 PyFR
    # operator (densified, f32) at N = --sparse-n over 4 ranks: no kernel
    # of the 21 (full-f32 torch.matmul), the compiled form's other builders
    row = make_mesh((1, 4), ("dp", "mp"), devices=virtual_devices(4))
    _, op = pyfr_operators(np)[2]
    kp = -(-max(op.shape) // 4) * 4       # M and K padded to whole shards
    a = torch.zeros((kp, kp), device=dev)
    a[:op.shape[0], :op.shape[1]] = torch.from_numpy(op.astype(np.float32))
    b = torch.randn((kp, args.sparse_n), generator=g, device=dev)
    b[op.shape[1]:] = 0
    gold = a.double() @ b.double()
    for label, fn, eager, fargs in (
            ("ring_spmm", dist_spmm.ring_spmm(row),
             dist_spmm.ring_spmm(row, compiled=False),
             (dist_spmm.shard_rows(row, a), dist_spmm.shard_rows(row, b))),
            ("col_sharded_spmm", dist_spmm.col_sharded_spmm(row),
             dist_spmm.col_sharded_spmm(row, compiled=False),
             (a, dist_spmm.shard_cols(row, b)))):
        c = fn(*fargs).gather().double()
        torch.cuda.synchronize()
        err = xp.matdiff(gold.cpu().numpy(), c.cpu().numpy()).normf_rel
        print(f"dist {label} 150x150 N={args.sparse_n} f32 over 4 ranks: gold "
              f"rel-Frobenius {err:.3e} (tol {DIST_GOLD_TOL['float32']:g}) "
              f"{'pass' if err < DIST_GOLD_TOL['float32'] else 'FAIL'}")
        if not err < DIST_GOLD_TOL["float32"]:
            raise RuntimeError(f"{label}: {err:.3e} against gold")
        compiled_vs_eager(f"dist {label} 150x150 N={args.sparse_n} 4 ranks",
                          fn, eager, fargs, smi)
    return launched


def dist_sync_bn(args, dev, smi):
    """Step 38a: cross-replica BN over 2 replicas against the global
    batch's BN at N64 C256 H56 W56, RELU: y, dx, dgamma, dbeta."""
    import torch
    import xsmm_tpu_torch as xp
    from xsmm_tpu_torch.dnn import BnDesc, BnFuse, create_fusedbatchnorm

    n, c, hw = args.dnn_batch, 256, 56
    g = torch.Generator(device=dev).manual_seed(args.seed + 2)
    x = torch.randn((n, hw, hw, c), generator=g, device=dev) * 2 + 1
    dy = torch.randn((n, hw, hw, c), generator=g, device=dev)
    gamma = torch.randn((c,), generator=g, device=dev)
    beta = torch.randn((c,), generator=g, device=dev)
    glob = create_fusedbatchnorm(BnDesc(n=n, c=c, h=hw, w=hw,
                                        fuse=BnFuse.RELU))
    y, st = glob.forward(x, gamma, beta)
    want = (y,) + tuple(glob.backward(dy, gamma, st))
    sync = create_fusedbatchnorm(BnDesc(n=n // 2, c=c, h=hw, w=hw,
                                        fuse=BnFuse.RELU), axis_name="dp")
    ys, sts = sync.forward(list(x.chunk(2)), gamma, beta)
    dxs, dgs, dbs = sync.backward(list(dy.chunk(2)), gamma, sts)
    got = (torch.cat(ys), torch.cat(dxs), dgs[0], dbs[0])
    errs = [xp.matdiff(w.double().cpu().numpy(),
                       v.double().cpu().numpy()).normf_rel
            for w, v in zip(want, got)]
    ok = max(errs) <= 1e-5
    print(f"dist sync bn N{n} C{c} H{hw} W{hw} RELU over 2 replicas against "
          f"the global batch: y {errs[0]:.3e}, dx {errs[1]:.3e}, dgamma "
          f"{errs[2]:.3e}, dbeta {errs[3]:.3e} (tol 1e-5) "
          f"{'pass' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("cross-replica BN disagrees with the global batch")


def _one_step(params, fwd, batch, mesh, before, then=None, loss_fn=None,
              compiled=None):
    """One ``train_epoch`` step of a fresh engine (over ``mesh``, or one
    device): (loss, each leaf's update, the BN state, the engine, and the
    loss of a second step on ``then``, else None)."""
    from xsmm_tpu_torch.models import MLEngine, SolverConfig

    eng = MLEngine(params, fwd, SolverConfig(lr=0.01), mesh=mesh,
                   compiled=compiled,
                   **({"loss_fn": loss_fn} if loss_fn else {}))
    loss = eng.train_epoch(iter([batch]), verbose=False)["loss"]
    upd = [t.detach().double().cpu() - b for (_, t), b in
           zip(_leaves(eng.params), before)]
    state = [t.double().cpu() for _, t in _leaves(eng.state)]
    second = (None if then is None else
              eng.train_epoch(iter([then]), verbose=False)["loss"])
    return loss, upd, state, eng, second


def _planted(kind: str):
    """A loss function that plants a fault in a dp = 2 step: "dropped"
    zeroes the second rank's loss (its gradient share lost), "doubled"
    doubles every rank's (the shares summed twice, or the mean over the
    ranks left out)."""
    from xsmm_tpu_torch.models.engine import softmax_xent

    calls = [0]

    def loss_fn(logits, y):
        calls[0] += 1
        lv = softmax_xent(logits, y)
        if kind == "doubled":
            return 2.0 * lv
        return lv if calls[0] % 2 else 0.0 * lv
    return loss_fn


def _step_diff(x, y):
    """(loss rel, rel-Frobenius of the whole update (every leaf in one
    vector), BN state max abs, the worst leaf's update rel-Frobenius, its
    index, its update's norm over the median leaf's) of two ``_one_step``
    results."""
    import torch

    upd = [(torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item() for a, b in zip(x[1], y[1])]
    worst = max(range(len(upd)), key=upd.__getitem__)
    norms = sorted(torch.linalg.vector_norm(b).item() for b in y[1])
    whole = (torch.cat([(a - b).flatten() for a, b in zip(x[1], y[1])])
             .norm() / torch.cat([b.flatten() for b in y[1]]).norm()).item()
    return (abs(x[0] - y[0]) / abs(y[0]), whole,
            max((a - b).abs().max().item() for a, b in zip(x[2], y[2])),
            upd[worst], worst,
            torch.linalg.vector_norm(y[1][worst]).item()
            / norms[len(norms) // 2])


def dist_engine(args, dev, smi, train_rows):
    """Step 38b: the dp engine against the single-device engine, card
    against card, on the same batch.  First ResNet-18 width 8, batch 8,
    16^2 (``tests/test_torch_engine.py``'s) over dp = 2 on cuDNN's
    deterministic algorithms, held to the step-32 gates (the loss, every
    leaf's update, the BN state).  Then ResNet-50 width 64, batch
    ``TRAIN_BATCH``, 224^2, f32, over dp = 2 for ``DIST_ENGINE_STEPS``
    steps.  On the deterministic algorithms the first step's loss is held
    to the step-32 gate and its whole update to ``DIST_UPDATE_TOL``, and
    two planted faults (``_planted``) must read above that limit; the
    worst leaf, the BN state and the second step's loss are printed, and
    beside them the one-device step on the batch moved one f32 ulp up, the
    step's own conditioning.  On the default algorithms (the main path's)
    the same readings stand beside two single-device steps' spread.  The
    other steps are timed beside step 33's, with the peak memory and a
    profiled step's split."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from xsmm_tpu_torch.models import resnet
    from xsmm_tpu_torch.models.engine import synthetic_batches
    from xsmm_tpu_torch.parallel.mesh import make_mesh, virtual_devices

    mesh = make_mesh((2, 1), ("dp", "mp"), devices=virtual_devices(2))
    saved = torch.backends.cudnn.deterministic
    # tests/test_torch_engine.py's model and batch
    params, fwd = resnet(depth=18, width=8, num_classes=10,
                         input_shape=(8, 16, 16, 3))
    from xsmm_tpu_torch.models.engine import template_batches
    small = next(template_batches(1, 8, hw=16))
    before = [t.detach().double().cpu() for _, t in _leaves(params["layers"])]
    torch.backends.cudnn.deterministic = True
    try:
        res = [_one_step(params, fwd, small, m, before)[:3]
               for m in (None, mesh)]
    finally:
        torch.backends.cudnn.deterministic = saved
    sd = _step_diff(res[1], res[0])
    leaf_ok = all((torch.linalg.vector_norm(a - b)
                   / torch.linalg.vector_norm(b)).item() <= STEP_UPDATE_TOL
                  for a, b in zip(res[1][1], res[0][1]))
    small_ok = (sd[0] <= STEP_LOSS_TOL and leaf_ok
                and sd[2] <= STEP_STATE_TOL)
    print(f"dist engine resnet18 width8 batch 8 16^2 over dp=2, one step "
          f"against the single-device engine's (cuDNN deterministic): loss "
          f"rel {sd[0]:.3e} (tol {STEP_LOSS_TOL:g}), worst leaf's update "
          f"rel-Frobenius {sd[3]:.3e} (tol {STEP_UPDATE_TOL:g}), whole update "
          f"{sd[1]:.3e}, BN state max abs {sd[2]:.3e} (tol "
          f"{STEP_STATE_TOL:g}) {'pass' if small_ok else 'FAIL'}  [{smi}]")
    if not small_ok:
        raise RuntimeError("the dp engine disagrees with the single-device "
                           "engine (ResNet-18)")

    n, hw, classes = TRAIN_BATCH, 224, 1000
    batches = list(synthetic_batches(DIST_ENGINE_STEPS, n, hw=hw,
                                     classes=classes, seed=args.seed))
    params, fwd = resnet(depth=50, width=64, num_classes=classes,
                         input_shape=(n, hw, hw, 3), seed=args.seed)
    keys = [k for k, _ in _leaves(params["layers"])]
    before = [t.detach().double().cpu() for _, t in _leaves(params["layers"])]
    x0, y0 = batches[0]
    ulp = (np.nextafter(x0, np.float32(np.inf)), y0)
    torch.backends.cudnn.deterministic = True
    try:
        one, dp = (_one_step(params, fwd, batches[0], m, before,
                             then=batches[1]) for m in (None, mesh))
        one, dp = ([*r[:3], r[4]] for r in (one, dp))
        moved = _one_step(params, fwd, ulp, None, before)[:3]
        faults = {k: _one_step(params, fwd, batches[0], mesh, before,
                               loss_fn=_planted(k))[:3]
                  for k in ("dropped", "doubled")}
    finally:
        torch.backends.cudnn.deterministic = saved
    torch.cuda.empty_cache()
    one_a = _one_step(params, fwd, batches[0], None, before)[:3]
    one_b = _one_step(params, fwd, batches[0], None, before)[:3]
    torch.cuda.empty_cache()
    # the dp step timed in the compiled form (the default; its first step
    # is the warm-up and the capture) and in the eager one
    timing = {}
    for form in ("compiled", "eager"):
        *first, eng, _ = _one_step(params, fwd, batches[0], mesh, before,
                                   compiled=None if form == "compiled"
                                   else False)
        if form == "compiled":
            dp_def = first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed = eng.train_epoch(iter(batches[1:]), verbose=False)
        peak_gb = (torch.cuda.max_memory_allocated() / 1e9,
                   torch.cuda.max_memory_reserved() / 1e9)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("smoke.step"):
                eng.train_epoch(iter(batches[1:2]), verbose=False)
                torch.cuda.synchronize()
        if form == "eager":
            split, busy_ms, window_ms, idle = step_split(prof)
        else:
            split = None
            _, busy_ms, window_ms = device_busy(list(prof.events()))
            idle = 1.0 - busy_ms / window_ms
        step_ms = 1e3 * n / timed["images_per_s"]
        timing[form] = {
            "step_ms": step_ms, "timed": timed, "peak_gb": peak_gb,
            "split": split, "busy_ms": busy_ms, "window_ms": window_ms,
            "idle": idle, "idle_timed": max(0.0, 1 - busy_ms / step_ms),
            "forms": dict(eng.forms),
            "reps_equal": all(torch.equal(a, b) for a, b in
                              zip(eng._rep_leaves[0], eng._rep_leaves[1]))}
        del eng, prof
        torch.cuda.empty_cache()
    reps_equal = all(t["reps_equal"] for t in timing.values())
    timed = timing["compiled"]["timed"]
    eager_timed = timing["eager"]["timed"]
    gated = _step_diff(dp, one)
    second = abs(dp[3] - one[3]) / abs(one[3])
    cond = _step_diff(moved, one)
    planted = {k: _step_diff(v, one)[1] for k, v in faults.items()}
    spread = _step_diff(one_b, one_a)
    default = _step_diff(dp_def, one_a)
    step_ms = timing["compiled"]["step_ms"]
    one_ms = train_rows["float32"]["step_ms"]
    one_eager_ms = train_rows["float32"]["eager_step_ms"]
    caught = all(v > DIST_UPDATE_TOL for v in planted.values())
    ok = (gated[0] <= STEP_LOSS_TOL and gated[1] <= DIST_UPDATE_TOL
          and caught and reps_equal
          and np.isfinite(timed["losses"]).all()
          and np.isfinite(eager_timed["losses"]).all())

    def diff(t):
        return (f"loss rel {t[0]:.3e}, whole update {t[1]:.3e}, BN state "
                f"{t[2]:.3e}, worst leaf {keys[t[4]]} {t[3]:.3e} (its "
                f"update {t[5]:.3g}x the median leaf's)")
    print(f"dist engine resnet50 width64 f32 batch {n} {hw}^2 over dp=2 "
          f"(virtual ranks on one card), the first step against the "
          f"single-device engine's, cuDNN deterministic: loss "
          f"{dp[0]:.6f} / {one[0]:.6f}, {diff(gated)} (tol: the loss "
          f"{STEP_LOSS_TOL:g}, the whole update {DIST_UPDATE_TOL:g}); the "
          f"second step's loss {dp[3]:.6f} / {one[3]:.6f} rel {second:.3e}; "
          f"the one-device step with every input "
          f"one f32 ulp up against it (the step's own conditioning): "
          f"{diff(cond)}; planted faults' whole update (must exceed "
          f"{DIST_UPDATE_TOL:g}): a rank's share dropped "
          f"{planted['dropped']:.3e}, the shares doubled "
          f"{planted['doubled']:.3e}; "
          f"cuDNN default: dp against one {diff(default)}; one against one "
          f"(the run-to-run spread) {diff(spread)}; replicas equal "
          f"{reps_equal} {'pass' if ok else 'FAIL'}  [{smi}]")
    for form, ref in (("compiled", one_ms), ("eager", one_eager_ms)):
        t = timing[form]
        print(f"dist engine resnet50 dp=2 {form} {DIST_ENGINE_STEPS - 1} "
              f"timed steps ({t['forms']}): {t['step_ms']:.2f} ms a step "
              f"({t['timed']['images_per_s']:.1f} images/s) against step "
              f"33's one-device {form} {ref:.2f} ms; losses "
              f"{t['timed']['losses']}; peak memory {t['peak_gb'][0]:.2f} "
              f"GB allocated, {t['peak_gb'][1]:.2f} GB reserved; "
              f"one profiled step: busy {t['busy_ms']:.3f} of "
              f"{t['window_ms']:.3f} ms, idle share {t['idle']:.4f} "
              f"profiled, {t['idle_timed']:.4f} against the timed step"
              + ("" if t["split"] is None else "; device ms: " + ", ".join(
                  f"{k} {v:.3f}" if isinstance(v, float) else f"{k}: {v}"
                  for k, v in t["split"].items()))
              + f"  [{smi}]")
    print(f"dist engine resnet50 dp=2: compiled {step_ms:.2f} ms against "
          f"eager {timing['eager']['step_ms']:.2f} ms a step "
          f"({timing['eager']['step_ms'] / step_ms:.3f}x); one device "
          f"compiled {one_ms:.2f}, eager {one_eager_ms:.2f}  [{smi}]")
    if not caught:
        raise RuntimeError("the dp engine's update gate does not tell a "
                           "planted fault from a sound step")
    if not ok:
        raise RuntimeError("the dp engine disagrees with the single-device "
                           "engine")
    return {"step_ms": step_ms, "one_step_ms": one_ms,
            "eager_step_ms": timing["eager"]["step_ms"],
            "peak_gb": timing["compiled"]["peak_gb"],
            "busy_ms": timing["compiled"]["busy_ms"],
            "idle_share": timing["compiled"]["idle"],
            "deterministic": gated, "second_loss": second,
            "conditioning": cond, "planted": planted,
            "default": default, "spread": spread}


def dist_entry(args, dev, smi):
    """Step 39: ``entry.dryrun_multichip(4)`` (4 virtual ranks on the card)
    and ``launch_dryrun(2, 2)`` (two processes of two ranks sharing the
    card over gloo, every cross-process hop staged through host memory)."""
    from xsmm_tpu_torch import entry
    from xsmm_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    got = entry.dryrun_multichip(4)
    print(f"dist entry dryrun_multichip(4): {got} in "
          f"{time.perf_counter() - t0:.2f} s pass  [{smi}]")
    fn, x = entry.entry()
    out = fn(*x)
    if tuple(out.shape) != (8, 100) or not bool(out.isfinite().all()):
        raise RuntimeError(f"entry(): {tuple(out.shape)}")
    t0 = time.perf_counter()
    lines = multihost.launch_dryrun(2, 2, timeout_s=300, device="cuda")
    print(f"dist entry launch_dryrun(2, 2) on the card: {len(lines)} workers "
          f"OK in {time.perf_counter() - t0:.2f} s  [{smi}]")
    if len(lines) != 2 or "staged" not in lines[0]:
        raise RuntimeError("launch_dryrun: a worker did not report")


def distributed_phase(args, dev, smi, rows, train_rows):
    """Steps 36 to 39 of the module docstring (the distributed layer)."""
    import torch
    from xsmm_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    max_abs = {}
    counts = {}
    counts.update(dist_ring(args, dev, smi, max_abs))
    torch.cuda.empty_cache()
    counts.update(dist_wrappers(args, dev, smi, max_abs))
    torch.cuda.empty_cache()
    dist_sync_bn(args, dev, smi)
    torch.cuda.empty_cache()
    eng = dist_engine(args, dev, smi, train_rows)
    torch.cuda.empty_cache()
    pmesh.reset_counts()
    dist_entry(args, dev, smi)
    for row in rows:
        if row["name"] in DIST_KERNELS:
            row["dist_launches"] = counts.get(row["name"], 0)
            row["dist_max_abs_err"] = max_abs.get(row["name"], 0.0)
    print(f"dist path kernel launches (each set to 0 before its step): "
          + json.dumps({k: counts.get(k, 0) for k in DIST_KERNELS})
          + f"; steps 36-39 in {time.perf_counter() - t0:.1f} s")
    return eng


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=131072)
    ap.add_argument("--sparse-n", type=int, default=65536)
    ap.add_argument("--sparse-big", type=int, default=1 << 20)
    ap.add_argument("--gemm-size", type=int, default=4096)
    ap.add_argument("--copy-size", type=int, default=8192)
    ap.add_argument("--packed-batch", type=int, default=131072)
    ap.add_argument("--packed-big-m", type=int, default=125)
    ap.add_argument("--packed-big-batch", type=int, default=4096)
    ap.add_argument("--rnn-shape", default="128,512,512,32",
                    help="N,C,K,T of the RNN phase")
    ap.add_argument("--dnn-batch", type=int, default=64,
                    help="N of the DNN phase's pooling, BN and stage shapes "
                         "(conv N/2, FC N x16)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import xsmm_tpu_torch as xp
    from xsmm_tpu_torch.ops import cuda_build, smm_packed
    from xsmm_tpu_torch.utils.timer import cuda_time_ms

    if "jax" in sys.modules or "xsmm_tpu" in sys.modules:
        raise RuntimeError("the port pulled in jax or xsmm_tpu")

    # -- 1. the card ---------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"device: {kind} (count {count}); torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    xp.set_config(target="cuda")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s ({', '.join(cuda_build.SOURCES)})")
    for name, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")
    # kernel 4's TMA route issues wgmma: HGMMA in the machine code
    from xsmm_tpu_torch.ops.kernel_profile import sass_counts
    sass = sass_counts(cuda_build.library_path("tiled_gemm"))
    print(f"sass: tiled_gemm {sass if sass else 'cuobjdump not found'}")
    if sass is not None and sass["HGMMA"] < 1:
        raise RuntimeError("tiled_gemm has no HGMMA instruction")
    # the native runtime (the registry's CRC32C index, the .mtx reader, the
    # ELL pack), built from native/*.cpp with g++
    from xsmm_tpu_torch.core import native_bridge
    t0 = time.perf_counter()
    native_bridge.build()
    native_s = time.perf_counter() - t0
    print(f"build: native {native_s:.2f} s ({native_bridge.library_path()})")

    # -- inputs, made on the card from the seed ------------------------------
    B = args.batch
    g = torch.Generator(device=dev).manual_seed(args.seed)
    a64, b64, c64 = (torch.randn((B, M, K), generator=g, device=dev,
                                 dtype=torch.float64) for _ in range(3))
    a32, b32, c32 = a64.float(), b64.float(), c64.float()
    a16, b16 = a32.bfloat16(), b32.bfloat16()

    # (label, f64 strategy, dispatcher, beta, (a, b, c), kernel, gold tol)
    cases = [
        ("dmm split2_fast beta0", "split2_fast", xp.dmmdispatch, 0.0,
         (a64, b64, c64), "packed_split2_fast", 1e-6),
        ("dmm split2 beta0", "split2", xp.dmmdispatch, 0.0,
         (a64, b64, c64), "packed_split2", 1e-6),
        ("dmm float32 beta0", "float32", xp.dmmdispatch, 0.0,
         (a64, b64, c64), "packed_f32", 1e-6),
        ("dmm split2_fast beta1", "split2_fast", xp.dmmdispatch, 1.0,
         (a64, b64, c64), "packed_split2_fast", 1e-6),
        ("dmm split2 beta1", "split2", xp.dmmdispatch, 1.0,
         (a64, b64, c64), "packed_split2", 1e-6),
        # f32 tensors, batch-first and contiguous: the natural kernel
        ("smm beta0", None, xp.smmdispatch, 0.0, (a32, b32, c32),
         "natural_f32", 1e-3),
        ("smm beta1", None, xp.smmdispatch, 1.0, (a32, b32, c32),
         "natural_f32", 1e-3),
        # bf16 inputs, f32 sum: gold is exact products of the bf16 values
        ("bsmm beta0", None, xp.bsmmdispatch, 0.0, (a16, b16, None),
         "packed_f32", 1e-6),
        # bf16 sum rounded at every k step (as the TPU kernel): ~5e-3
        ("bmm beta0", None, xp.bmmdispatch, 0.0, (a16, b16, None),
         "packed_f32", 1e-2),
    ]

    # -- 3. the main path, counted -------------------------------------------
    kernels = {}
    subsets = {}
    smm_packed.reset_launches()
    t0 = time.perf_counter()
    for label, strategy, disp, beta, (a, b, c), kname, _ in cases:
        xp.set_config(f64_strategy=strategy or "split2_fast")
        kern = disp(M, N, K, batch=B, beta=beta)
        if not isinstance(kern, xp.BatchedSMM):
            raise RuntimeError(f"{label}: routed to {type(kern).__name__}")
        before = smm_packed.launches[kname]
        out = kern(a, b, c) if beta else kern(a, b)
        torch.cuda.synchronize()
        if smm_packed.launches[kname] <= before:
            raise RuntimeError(f"{label}: {kname} was not launched")
        if tuple(out.shape) != (B, M, N):
            raise RuntimeError(f"{label}: shape {tuple(out.shape)}")
        sub = out[:GOLD_SUBSET]
        sub = (np.array(sub) if isinstance(sub, np.ndarray)
               else sub.float().cpu().numpy())
        if not np.isfinite(sub).all():
            raise RuntimeError(f"{label}: non-finite output")
        subsets[label] = sub
        kernels[label] = kern
    main_s = time.perf_counter() - t0
    main_launches = dict(smm_packed.launches)
    main_staging = dict(smm_packed.staging_launches)
    print(f"main path: {len(cases)} dispatch calls at B={B}, {M}x{N}x{K} in "
          f"{main_s:.2f} s; launches {main_launches}; stagings "
          f"{main_staging}")
    for kname, n in main_launches.items():
        if n < 1:
            raise RuntimeError(f"{kname} was not launched on the main path")
    # f32 planes of the main path are aligned with B % 4 == 0: every one
    # takes TMA staging, the bf16 cases the first design, and the natural
    # calls' operands (on 16 bytes) bulk copies
    if (main_staging["cp.async"] or main_staging["tma"] < 1
            or main_staging["first"] < 1 or main_staging["bulk"] < 1):
        raise RuntimeError(f"main path stagings {main_staging}: expected tma, "
                           f"first and bulk, no cp.async")

    # gold on a subset of the problems
    for label, strategy, disp, beta, (a, b, c), kname, tol in cases:
        af = a[:GOLD_SUBSET].double().cpu().numpy()
        bf = b[:GOLD_SUBSET].double().cpu().numpy()
        gold = np.einsum("bmk,bkn->bmn", af, bf)
        if beta:
            gold = gold + c[:GOLD_SUBSET].double().cpu().numpy()
        err = xp.matdiff(gold, subsets[label]).normf_rel
        ok = err < tol
        print(f"gold  {label:24s} rel-Frobenius {err:.3e} (tol {tol:g}) "
              f"{'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: {err:.3e} >= {tol:g} against gold")
    del subsets

    # -- 4. each kernel against its plain version, same packed operands ------
    def packed_ops(kern, a, b, c):
        if kern.is_f64:
            ah, al = xp.split_f64(a, dev)
            bh, bl = xp.split_f64(b, dev)
            ops = {"split2": [ah, al, bh, bl], "split2_fast": [ah, bh, bl],
                   "float32": [ah, bh]}[kern.strategy]
            n_a = 2 if kern.strategy == "split2" else 1
            ops = ([kern.pack_a(x) for x in ops[:n_a]]
                   + [kern.pack_b(x) for x in ops[n_a:]])
            if kern.desc.beta:
                ch, cl = xp.split_f64(c, dev)
                ops += [kern.pack_c(x) for x in
                        ([ch, cl] if kern.strategy == "split2" else [ch])]
            return ops
        ops = [kern.pack_a(a), kern.pack_b(b)]
        if kern.desc.beta:
            ops.append(kern.pack_c(c.to(kern.out_dt)))
        return ops

    def run_kernel(kname, kern, ops, plain=False):
        """The wrapper of kernel ``kname`` (or its plain version) on ``ops``."""
        fn = getattr(smm_packed, kname + ("_plain" if plain else ""))
        if kname == "packed_f32":
            return fn(*ops, out_dtype=kern.out_dt)
        return fn(*ops)
    max_abs = {k: 0.0 for k in REPLACES}
    timing_ops = {}
    for label, strategy, disp, beta, (a, b, c), kname, _ in cases:
        kern = kernels[label]
        ops = packed_ops(kern, a, b, c)
        if kname == "natural_f32":
            # the natural call against its plain version and against the
            # pack route (kernel 2 on the packed operands), bit for bit
            nat = (a, b, c) if beta else (a, b)
            got = kern(*nat)
            want = run_kernel(kname, kern, nat, plain=True)
            packed = kern.unpack_c(kern.packed(*ops), B)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs().max().item()
            ok = torch.equal(got, want) and torch.equal(got, packed)
            max_abs[kname] = max(max_abs[kname], err)
            print(f"plain {label:24s} {kname:18s} max_abs_err {err:.3e}; "
                  f"pack route (packed_f32) max_abs_err "
                  f"{(got.double() - packed.double()).abs().max().item():.3e}"
                  f" (bit for bit) {'pass' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{label}: the natural kernel, its plain "
                                   f"version and the pack route disagree")
            if label == "smm beta0":
                timing_ops[kname] = (kern, nat)
                timing_ops["packed_f32"] = (kern, ops)
            del ops, got, want, packed
            continue
        got = kern.packed(*ops)
        want = run_kernel(kname, kern, ops, plain=True)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        # bf16 outputs hold ~3 digits; everything else is f32
        tol = 1e-2 if kern.out_dt == torch.bfloat16 else 1e-6
        err = rel = 0.0
        for g_, w_ in zip(got, want):
            d = (g_.double() - w_.double())
            err = max(err, d.abs().max().item())
            rel = max(rel, (torch.linalg.vector_norm(d)
                            / torch.linalg.vector_norm(w_.double())).item())
        max_abs[kname] = max(max_abs[kname], err)
        ok = rel <= tol
        print(f"plain {label:24s} {kname:18s} max_abs_err {err:.3e} "
              f"rel-Frobenius {rel:.3e} (tol {tol:g}) "
              f"{'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: kernel and plain version disagree")
        if label in ("dmm split2_fast beta0", "dmm split2 beta0"):
            timing_ops[kname] = (kern, ops)
        del ops, got, want
    del kernels

    # the cp.async staging (f32 planes TMA cannot address), once for each
    # schedule, on planes one element past their alignment with an odd Bp
    bp_off = 4097
    base = torch.randn(4 * M * K * bp_off + 1, generator=g, device=dev)
    ah, al, bh, bl = (base[1 + i * M * K * bp_off:1 + (i + 1) * M * K * bp_off]
                      .view(M, K, bp_off) for i in range(4))
    smm_packed.reset_launches()
    checks = [("packed_split2", smm_packed.packed_split2(ah, al, bh, bl),
               smm_packed.packed_split2_plain(ah, al, bh, bl)),
              ("packed_split2_fast", smm_packed.packed_split2_fast(ah, bh, bl),
               smm_packed.packed_split2_fast_plain(ah, bh, bl)),
              ("packed_f32", smm_packed.packed_f32(ah, bh,
                                                    out_dtype=torch.float32),
               smm_packed.packed_f32_plain(ah, bh, out_dtype=torch.float32))]
    # and the natural kernel on batch-first operands one element past their
    # alignment, with a ragged last group
    nat_off = [base[1 + i * M * K * bp_off:1 + (i + 1) * M * K * bp_off]
               .view(bp_off, M, K) for i in range(2)]
    checks.append(("natural_f32", smm_packed.natural_f32(*nat_off),
                   smm_packed.natural_f32_plain(*nat_off)))
    torch.cuda.synchronize()
    staged = dict(smm_packed.staging_launches)
    if staged != {"tma": 0, "cp.async": 4, "first": 0, "bulk": 0}:
        raise RuntimeError(f"offset planes took stagings {staged}")
    for kname, got, want in checks:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max((g_.double() - w_.double()).abs().max().item()
                  for g_, w_ in zip(got, want))
        ok = all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
        print(f"plain cp.async staging {kname:18s} {M}x{N}x{K} Bp={bp_off} "
              f"offset planes: max_abs_err {err:.3e} (bit for bit) "
              f"{'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{kname} on cp.async staging: kernel and "
                               f"plain version disagree")
    del base, ah, al, bh, bl, nat_off, checks
    torch.cuda.empty_cache()

    # -- 5. the non-kernel routes --------------------------------------------
    rng = np.random.default_rng(args.seed)
    xp.set_config(f64_strategy="split2_fast")
    kern = xp.smmdispatch(256, 256, 256, batch=4, beta=0.0)
    assert isinstance(kern, xp.XlaGemm), type(kern)
    a = rng.standard_normal((4, 256, 256), dtype=np.float32)
    b = rng.standard_normal((4, 256, 256), dtype=np.float32)
    err = xp.matdiff(np.einsum("bmk,bkn->bmn", a.astype(np.float64), b),
                     kern(a, b).cpu().numpy()).normf_rel
    print(f"route XlaGemm f32 256^3 (tf32 {torch.backends.cuda.matmul.allow_tf32}"
          f", precision {torch.get_float32_matmul_precision()}): {err:.3e}")
    if not err < 1e-5:
        raise RuntimeError("f32 XlaGemm is not full f32")

    xp.set_config(f64_strategy="native")
    kern = xp.dmmdispatch(M, N, K, batch=GOLD_SUBSET, beta=0.0)
    assert isinstance(kern, xp.XlaGemm), type(kern)
    a = rng.standard_normal((GOLD_SUBSET, M, K))
    b = rng.standard_normal((GOLD_SUBSET, K, N))
    gold = np.matmul(a, b)
    err = np.linalg.norm(kern(a, b) - gold) / np.linalg.norm(gold)
    print(f"route XlaGemm f64 native: {err:.3e}")
    if not err < 1e-13:
        raise RuntimeError("native f64 is not f64")
    xp.set_config(f64_strategy="split2_fast")

    probe = torch.ones((2, 2), dtype=torch.int16, device=dev)
    try:
        torch.matmul(probe, probe)
        int_mm = "has int16 kernels"
    except RuntimeError as e:
        int_mm = f"raises ({str(e).splitlines()[0][:80]})"
    kern = xp.wimmdispatch(9, 9, 9, batch=8, beta=0.0)
    a = rng.integers(-100, 100, (8, 9, 9)).astype(np.int16)
    b = rng.integers(-100, 100, (8, 9, 9)).astype(np.int16)
    c = kern(a, b)
    exact = (c.dtype == torch.int32 and np.array_equal(
        c.cpu().numpy(), np.einsum("bmk,bkn->bmn", a.astype(np.int64),
                                   b.astype(np.int64))))
    print(f"route XlaGemm int16->int32 exact: {exact}; torch.matmul int16 on "
          f"cuda {int_mm}")
    if not exact:
        raise RuntimeError("int16 product is not exact")

    a = rng.standard_normal((12, 14, 6))
    b = rng.standard_normal((12, 6, 10))
    gold = np.einsum("bmk,bkn->mn", a, b)
    e32 = xp.matdiff(gold, xp.smmdispatch_reducebatch(14, 10, 6, beta=0.0)(
        a.astype(np.float32), b.astype(np.float32)).cpu().numpy()).normf_rel
    e64 = xp.matdiff(gold, xp.dmmdispatch_reducebatch(14, 10, 6, beta=0.0)(
        a, b)).normf_rel
    print(f"route BatchReduceGemm f32 {e32:.3e}, f64 split2_fast {e64:.3e}")
    if not (e32 < 1e-5 and e64 < 1e-6):
        raise RuntimeError("batch-reduce out of tolerance")

    # -- 6. times at the main path's shape -----------------------------------
    planes = {  # f32 planes moved at beta = 0: (A, B, C)
        "packed_f32": (1, 1, 1), "packed_split2_fast": (1, 2, 1),
        "packed_split2": (2, 2, 2), "natural_f32": (1, 1, 1)}
    ops_per_mnk = {"packed_f32": 2, "packed_split2_fast": 4,
                   "packed_split2": 6, "natural_f32": 2}
    library = {
        "packed_f32": (a32, b32),
        "packed_split2_fast": (a64, b64),
        "packed_split2": (a64, b64),
        "natural_f32": (a32, b32),
    }
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for kname in ("packed_split2_fast", "packed_f32", "packed_split2",
                  "natural_f32"):
        kern, ops = timing_ops[kname]
        la, lb = library[kname]
        # in turns with the library call: kernel, library, library, kernel
        ms_t, lib_t = [], []
        for what in ("k", "l", "l", "k"):
            if what == "k":
                ms_t.append(cuda_time_ms(run_kernel, kname, kern, ops,
                                         warmup=3, iters=20))
            else:
                lib_t.append(cuda_time_ms(lambda: torch.bmm(la, lb), warmup=3,
                                          iters=20))
        ms, library_ms = sum(ms_t) / 2, sum(lib_t) / 2
        plain_ms = cuda_time_ms(run_kernel, kname, kern, ops, True, warmup=1,
                                iters=3)
        pa, pb, pc = planes[kname]
        nbytes = (pa * M * K + pb * K * N + pc * M * N) * B * 4
        nops = ops_per_mnk[kname] * M * N * K * B
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_FLOP_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"time  {kname:18s} {ms:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s, "
              f"bound {bound_ms:.4f} ms ({bound_by}), share "
              f"{bound_ms / ms:.3f}; plain {plain_ms:.3f} ms; torch.bmm "
              f"{la.dtype} {library_ms:.4f} ms; in turns: kernel "
              f"{ms_t[0]:.4f} / {ms_t[1]:.4f}, torch.bmm {lib_t[0]:.4f} / "
              f"{lib_t[1]:.4f} ms  [{smi}]")
        rows.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": main_launches[kname],
            "max_abs_err": max_abs[kname], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "check": "pass",
            "shape": f"B={B} {M}x{N}x{K} beta=0", "ms_turns": ms_t,
            "library_ms_turns": lib_t, "main_path_stagings": main_staging,
        })

    # the whole entry-point call at the same shape: f64 in, numpy f64 out
    # (split, pack, kernel, unpack, join, copy to the host), and f32 with
    # tensors that stay on the card
    xp.set_config(f64_strategy="split2_fast")
    kern = xp.dmmdispatch(M, N, K, batch=B, beta=0.0)
    call_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern(a64, b64)
        call_s.append(time.perf_counter() - t0)
    kern32 = xp.smmdispatch(M, N, K, batch=B, beta=0.0)
    call32_ms = cuda_time_ms(lambda: kern32(a32, b32), warmup=2, iters=10)
    print(f"call  dmmdispatch split2_fast beta0 {sorted(call_s)[2] * 1e3:.3f} "
          f"ms (median of 5, host clock, numpy f64 out); smmdispatch f32 "
          f"beta0 {call32_ms:.3f} ms (CUDA events, tensors on the card)  "
          f"[{smi}]")

    # the edge of the natural route: the smallest blocks per SM it takes
    # (28^3, 3) and the first shape it leaves to the pack route (32^3, 2),
    # at about the main path's bytes; each call's kernel counted, both
    # routes timed in turns (natural, pack, pack, natural)
    for em, want in ((28, "natural_f32"), (32, "packed_f32")):
        enb = B * M * K // (em * em)
        ea, eb = (torch.randn((enb, em, em), device=dev) for _ in range(2))
        ekern = xp.smmdispatch(em, em, em, batch=enb, beta=0.0)
        before = dict(smm_packed.launches)
        ekern(ea, eb)
        torch.cuda.synchronize()
        grown = {kn: n - before[kn] for kn, n in smm_packed.launches.items()
                 if n != before[kn]}
        if grown != {want: 1}:
            raise RuntimeError(f"{em}^3 f32 launched {grown}, not {want}")

        def nat():
            return smm_packed.natural_f32(ea, eb)

        def pack():
            return ekern.unpack_c(ekern.packed(ekern.pack_a(ea),
                                               ekern.pack_b(eb)), enb)

        turns = [cuda_time_ms(fn, warmup=2, iters=10)
                 for fn in (nat, pack, pack, nat)]
        nat_ms, pack_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        print(f"route {em}^3 B={enb} blocks/SM "
              f"{smm_packed.natural_blocks(em, em, em)} -> {want}: natural "
              f"{nat_ms:.4f} ms, pack route {pack_ms:.4f} ms, pack/natural "
              f"{pack_ms / nat_ms:.2f}; in turns {turns[0]:.4f} / "
              f"{turns[1]:.4f} / {turns[2]:.4f} / {turns[3]:.4f}  [{smi}]")
        if want == "natural_f32" and nat_ms >= pack_ms:
            raise RuntimeError(f"the natural route at {em}^3 is not faster "
                               f"than the pack route")
        del ea, eb, ekern

    del cases, library, la, lb, timing_ops
    del a64, b64, c64, a32, b32, c32, a16, b16
    torch.cuda.empty_cache()
    rows += sparse_phase(args, dev, smi)
    torch.cuda.empty_cache()
    rows += dense_phase(args, dev, smi)
    torch.cuda.empty_cache()
    rows += packed_phase(args, dev, smi)
    torch.cuda.empty_cache()
    rows += rnn_phase(args, dev, smi)
    torch.cuda.empty_cache()
    rows += rnn_bwd_phase(args, dev, smi)
    torch.cuda.empty_cache()
    rows += dnn_phase(args, dev, smi)
    torch.cuda.empty_cache()
    runtime_phase(args, dev, smi, native_s)
    torch.cuda.empty_cache()
    train_rows = training_phase(args, dev, smi)
    torch.cuda.empty_cache()
    distributed_phase(args, dev, smi, rows, train_rows)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
