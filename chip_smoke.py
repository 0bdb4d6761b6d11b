"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100:
the CUDA kernels are built for sm_90a). It exits non-zero, printing no
result, when there is no card or when the checkout's files are missing.

Phases (none is caught; any failure exits non-zero), each printing its
seconds:

 1. the card's name and power limit, as nvidia-smi reports them;
 2. build the CUDA kernel libraries (one nvcc per source, all at once) and
    compile the Triton kernels (``dequant_int8`` among them);
 3. inference: write an FFHQ-512 controller directory (configs/ffhq.json,
    the orientation and age heads) at random init in the JAX package's
    layout, with the port's own msgpack writer, and load it through
    ``Controller``;
 4. inference kernels: at every (shape, dtype) the generation path gives
    ``fused_bias_act`` and ``blur2x_up`` (module hooks in one warm-up call),
    in f32 with TF32 off and in bf16, each kernel against its plain PyTorch
    version, and the times of the kernel, the plain version and, for
    blur2x_up, a depthwise ``conv_transpose2d`` (see "Times" below);
 5. inference main path: one ``gen_batch_by_controls(batch_size=8, ...)`` in
    bf16 with the launch counters set to 0 just before and read just after;
    the median of a few warm calls; the device time by kernel (profiler);
 6. inference card against CPU: batch 1 f32, TF32 off, same latent and noise;
 7. training main path: ``GeneratorTrainer`` on configs/ffhq.json (FFHQ-512,
    batch 16, bf16 synthesis and D pyramid, f32 parameters) with the
    synthetic loader, results under build/, and the config's contrastive
    battery as ``train_generator.py`` builds it (``build_attr_losses``: six
    losses on six frozen nets at random init, stored and run in bf16);
    ``dry_run()`` then ``train(5)`` (iterations 0 and 4 take the path-length
    step, 0 the R1 step) with the counters set to 0 just before
    ``train(5)`` and read just after, checked per step kind against counts
    derived from the modules (the battery launches none of the port's
    kernels); finite losses, the six attribute losses of every iteration,
    every parameter of G and D moved, every predictor tensor unchanged and
    without a gradient, the sample images' launches (iteration 0 saves them)
    counted apart; median ms per step kind and per iteration, peak
    memory; each predictor's loss forward and image-gradient backward
    (CUDA events) and the battery's share of ``g_step``; the saved
    ``g_ema`` generates through ``Inference``; the median of a few plain
    iterations (d_step + g_step) between syncs, and the device time by
    kernel of one more iteration;
 7b. training from an image folder (its first command line beside phase 9,
    on a thread that sends the signal): 64 RGB PNGs of 1024 px written from a
    seed (as FFHQ's images1024x1024); ``python -m
    gan_control_torch.train_generator`` on configs/ffhq.json at full width,
    batch 16, with the six-loss battery at random init and
    ``data_config.path`` at the folder, iteration 0 saving the sample images
    and the nets; SIGTERM once iteration 3 is logged (exit 0, a checkpoint
    at the next iteration, the sample grid and the seven group matrices);
    a second run resumed from that checkpoint (``ckpt_config``) for two
    more iterations; the checkpoint loaded into a fresh ``GeneratorTrainer``
    and every parameter, EMA tensor and Adam moment held equal to the file;
    the decode route, the loader's ms per batch alone, and the plain
    iterations' median and device-busy share with the image loader against
    phase 7's with the synthetic loader. The two runs' logs go to
    ``build/gan_control_torch/``;
 8. training kernels: every (kernel, shape, dtype, static arguments) that
    ``train(5)`` launched (recorded by hooks on the launchers), in f32 with
    TF32 off and in bf16: the forward and the backward (autograd of a seeded
    projection) against the plain version; the second order at one shape
    each for fused_bias_act, blur_sep and the blur2x_up/blur2x_down pair;
    the times of the kernel, the plain version and the PyTorch call that
    computes the same function (depthwise ``conv2d`` for blur_sep and, with
    stride 2, for blur2x_down), and each kernel's bound; per-kernel totals
    over ``train(5)``, the blur2x pair's totals against the library call's,
    and blur_sep per D level (one launch of each of its four shapes); then
    blur_sep's direct variant (one channel a thread) at shapes the path
    never gives (C = 33 and 40, 2 and 3 taps, a misaligned input), forward
    and backward against the plain version;
 9. training card against CPU: each of the battery's six nets alone (batch
    2, 512 px, f32, TF32 off, batch-norm statistics set from the G's
    images): every layer it returns and the image gradient of a seeded
    projection; then iteration 0 of a size-32 model (f32, TF32 off) from the
    same parameters and explicit random inputs, each step kind's losses and
    gradients, and ``g_step`` with the battery. The hair mask may differ only
    at pixels whose logit lies at the threshold; both sides then use the
    CPU's mask;
10. phase-2a sweep: an FFHQ-512 phase-1 directory at random init (phase
    3's writer), then ``python -m gan_control_torch.make_attributes_df
    --batch_size 40 --number_of_samples 640`` into
    ``build/gan_control_torch/attributes.npz`` (the config's six predictors
    at random init, f32); the table's columns and shapes are the JAX
    sweep's, every value finite, ``latents_w`` the port's mapping of
    ``latents``; its rows per second; one batch in-process: launches
    against the counts derived from the modules, and its time split
    between the synthesis and each predictor (CUDA events);
11. phase-2b ``latent_rec``: configs/controller_configs/ffhq/age_controller.json
    with its paths under build/ and evaluations and saves every 100
    iterations, through ``python -m gan_control_torch.train_controller
    --iters 100``: finite metrics, checkpoints, dual grids, the median
    iteration and the config's 800 000 iterations at that rate; launches and
    ms per step in-process;
12. ``attribute_rec``: the same config in-process with losses
    ``latent_rec`` and ``attribute_rec`` (weight 0.01), batch 128, DEX at
    random init, the G rematerialised: five steps and one evaluation with
    launches against counts derived from the modules (the recompute
    included), ms and peak memory; the head's gradients with and without
    rematerialisation on the same noise at batch 16 (G in f32);
13. the trained age head and phase 3's orientation head in one controller
    directory through ``Controller``: each head's output is its group's
    slice of w;
14. one size-32 controller step, card against CPU (f32, TF32 off, explicit
    noise), with ``latent_rec`` and with ``attribute_rec``; then every
    (kernel, shape, dtype) that phases 10-12 launched in-process, at its
    path dtype, forward and backward against the plain version, with its
    times and bound;
15. serving: phase 3's FFHQ-512 directory through
    ``ServingController(buckets=(1, 4, 16, 64))`` (bf16 synthesis) with
    the counters set to 0 before ``warmup()`` (one CUDA graph per bucket)
    and a few uint8 requests and read after them, each capture's launches
    against the counts derived from the modules (79 and 7, as phase 5); the
    request latency (host clock, request to numpy; p50 and p90 of 20) of
    ``generate`` against ``gen_batch_by_controls`` + ``.cpu()`` alternated,
    through ``gan_control_torch/tools/serving_bench.py``, at n = 1, 3, 16
    and 64, and of the uint8 output; each graph's replay time (CUDA
    events), the device-busy share and images/s; capture seconds and the
    graph pool's memory; replay against eager ``gen_batch_by_controls`` at
    each bucket; the per-row noise across buckets; a ``torch.export``
    program at bucket 4 (seconds, MiB) loaded by ``load_exported_serving``,
    replayed against the live path, and its latency; bucket 1 in f32 with
    TF32 off against the CPU; then every (kernel, shape, dtype) that the
    serving path and that f32 check launched, forward and backward against
    the plain version, with its times and bound;
16. evaluation (phase 18's two command lines run beside its own, which
    time nothing, and end before its in-process part): 2304 seeded RGB PNGs
    of 256 px; ``python -m
    gan_control_torch.calc_inception --size 512 --n_samples 2304`` (random
    Inception, with its warning) writes the real statistics; ``python -m
    gan_control_torch.train_generator --iters 3`` on configs/ffhq.json at
    full width (batch 16, the six-loss battery at random init, the folder as
    its data, TensorBoard and the CSV monitor on) with every evaluation due
    at iteration 2: FID against those statistics with a random Inception on
    2304 samples (cut from 50 000), separability and both histograms on the
    config's 2000, cut to 500); its metrics record, ``best_fid.ckpt``, bucket image,
    plots and annotated matrices, and no "not ported" warning; then a fresh
    ``GeneratorTrainer`` loads ``best_fid.ckpt`` and runs each evaluation
    in-process (separability and the histograms on 500 samples, cut from
    the config's 2000; FID on the command line's 2304) with the
    counters set to 0 just before and read just after,
    against the launches derived from the modules (also of one FID chunk,
    separability batch and histogram batch), with its seconds and the peak
    memory; the logged FID against its recomputation from the same
    features in float64 on the CPU; the FID chunk's images/s at chunks 16
    and 64, its device-busy share and the 50 000-sample time they give;
    Inception card against CPU (batch 2, 512 px, f32, TF32 off); then every
    (kernel, shape, dtype) that the evaluation launched, forward and
    backward against the plain version, with its times and bound;
18. AFHQ and MetFaces (ADA, the three new nets, transfer learning), at
    full width (512 px, channel multiplier 2, batch 16), random init:
    (a) 64 seeded 512-px PNGs in AFHQ's ``train/dog`` layout (three
    unreadable files in ``train/cat``, which the loader must not read) and
    ``python -m gan_control_torch.train_generator --iters 2`` on a copy of
    configs/afhq.json: the battery (Hopenet, DogFaceNet, ResNet-18, bf16)
    and adaptive ADA; every iteration's losses and three attribute losses
    finite, ``ada_p`` logged and equal in the checkpoint, the sample grid and
    the three group matrices; (b) beside it, the same on a copy of
    configs/metfaces.json (data set ``met-faces``, phase 16's PNGs) with
    ``augment.p`` 0.5 and ``transfer_learning_model`` at phase 7b's FFHQ run:
    before, in-process, every synthesis tensor of G and its EMA equal to
    the run's ``g_ema`` and each mapping tensor the source's where name and
    shape match, else its own init; after, the five-net battery's losses
    finite, ``ada_p`` 0.5 in the checkpoint; (c) one ``GeneratorTrainer``
    per config with the counters set to 0 around ``train(2)``, each step
    kind's launches against ``expected_step_counts`` with 3 and 6 groups,
    ms per step kind, peak memory, each net's loss forward and
    image-gradient backward, plain iterations with ADA against the same
    trainer with it off (alternated), ``augment`` alone at [16, 512, 512,
    3] bf16 p 0.5 with its device time by kernel; (d) card against CPU: the
    three new nets alone (as phase 9), ``apply_affine`` + ``apply_color``
    at 512 px with explicit matrices, a size-32 ``d_step`` and ``g_step``
    with a fixed-matrix augment, and that ``g_step``'s distance from a
    float64 run on the CPU, of the CPU's, of the card's and of the card's
    with cuDNN off; (e) every (kernel, shape, dtype) that (c)
    launched, forward and backward against the plain version, with its
    times and bound. The two runs' logs go to
    ``build/gan_control_torch/afhq_metfaces/``;
19. alignment in the phase-2a sweep: seeded random-init FAN (4 modules),
    S3FD, BlazeFace and ResNetDepth (3, 8, 36, 3) checkpoints in their
    reference layouts under ``build/gan_control_torch/alignment/``; ``python
    -m gan_control_torch.make_attributes_df --align_3d --fan_weights ...
    --detector {sfd,blazeface} --detector_weights ... --depth_weights ...``
    (batch 40, 80 rows) on phase 10's directory, once per detector: rows/s
    beside phase 10's, each stage's host and device ms per batch (generation,
    detector net, detector decode + NMS, FAN, heatmap decode, depth, the POS
    warp, the alignment as a whole, the predictors), the detector's
    candidate, kept-box and NMS-pass counts, misses and boxes without a
    crop window, the POS scale's range, the peak, the table against phase
    10's columns; one aligned batch in-process with its launches against the
    derived counts; each net card against CPU (f32, TF32 off) and the
    discrete results (best box, argmax landmarks, aligned crops) where the
    decision margin exceeds the nets' error, with the flips counted;
20. projection: ``python -m gan_control_torch.project --steps 100`` on the
    same directory (batch 1, a model-generated target, random LPIPS): ms
    per step, the loss at the first and last logged step, the peak and its
    three artifacts; in-process ``get_avg_latent`` and three projector
    steps with their launches against the derived counts (per step: one
    ``fused_bias_act`` and one gradient per StyledConv, one ``blur2x_up``
    and one ``blur2x_down`` per ToRGB skip), the median synced step, its
    device-busy share and peak; three steps at size 32 card against CPU
    from the same draws; then every (kernel, shape, dtype) that phases
    19-20 launched in-process, forward and backward against the plain
    version, with its times and bound;
21. data parallelism across processes (ranks started as torchrun starts
    them, by ``torch.multiprocessing`` or ``torchrun --standalone``; a rank
    that fails fails the script; the processes of (a), (c) and (d), which
    time nothing, run at once while this process computes what they are
    held to, then (b) alone): (a) phase 9's size-32 model (f32, TF32
    off) with ADA adaptive, a small contrastive net and path length, each
    of the four steps from one state on two ranks sharing the card over
    gloo and on one rank over NCCL, each gradient against the one-process
    card step at the full batch (TRAIN_PARITY_RTOL); (b) ``train_generator --iters 3``
    (its ``main``) on configs/ffhq.json at full width, batch 16 over two
    ranks sharing the card (gloo, bf16, the six-loss battery): the ranks'
    parameters bitwise equal, each rank's launches per step against
    ``expected_step_counts``, each step's collectives (calls, payload MB,
    ms between syncs), the plain iterations' ms, the peaks; every (kernel,
    shape, dtype) the two ranks launched, forward and backward against the
    plain version, with its times and bound; (c) ``torchrun
    --nproc_per_node=2 -m gan_control_torch.make_attributes_df`` (80 rows)
    on phase 10's directory made f32 (``mixed_precision`` off): every row
    of every column against the same sweep replayed in this script at the
    ranks' batch, and every column but DIST_BATCH_SENSITIVE against the
    one-process sweep; ArcFace and DEX on fixed images at the batch of one
    process against two halves, in f32 as the sweep runs, in f32 with
    cuDNN off and in float64 (the float64 shift bounded); (d) ``torchrun --nproc_per_node=2 -m
    gan_control_torch.train_controller --iters 20`` against one process in
    this script: the head and the logged metrics;
22. the blob world, the marge mapping and meshed serving: (a) ``python -m
    gan_control_torch.tools.convergence --bf16``'s ``run`` (600
    iterations, 32 px, batch 8, the toy battery) and, in a second
    process started before phase 19, (b) ``control_fidelity.run`` at 1000
    / 600 iterations and 2048 rows (the heads and rows cut from 2000 /
    4096), each process with its
    counters set to 0 just before its run and read just after (and its
    launches recorded by shape): (a)'s launches against counts derived
    from the blob model's modules and the trainer's cadence and the JAX
    harness's verdict asserted, (b)'s stages' seconds and its verdict
    (Spearman >= 0.9 in every control dimension, measured spans > 0.05)
    asserted, while (c) and (d) run in this process; then the median of a
    few plain iterations of a fresh blob trainer and the device time by
    kernel of one more; (c) configs/ffhq.json with ``marge_fc`` at full width
    through ``Inference``: one batch-8 bf16 generation with its launches
    against the modules (7 x 4 split + 4 shared mapping layers, 15
    StyledConvs, 7 skips) and its synced median; a size-32 marge
    ``g_step`` card against CPU (f32, TF32 off, TRAIN_PARITY_RTOL); (d)
    ``ServingController(mesh=("cuda:0", "cuda:0"))`` on phase 15's
    directory: an indivisible ladder refused, each replica's capture at
    buckets 2, 8 and 64 against the derived launches, the pools' memory
    against one device's, images and w against the one-device controller
    at the same bucket with static and row noise (bf16 within 2^-7 of max;
    f32 with TF32 off within 2e-5), the p50 of requests of 8 and 64 against
    one device (alternated) and each replica's replay; then every (kernel,
    shape, dtype) that these paths launched, forward and backward against
    the plain version, with its times and bound;
23. the measuring tools (``gan_control_torch/tools/``): (a) at the end
    of phase 7, on its trainer's state and six-net battery, ``train_mfu``'s
    train family (``d_step``, ``g_step``, ``d_reg_step``, ``g_reg_step``
    at FFHQ-512, batch 16): each step counted once by
    ``utils/accounting.py`` (FLOPs by op kind and precision, bytes), warmed
    once and run 8 times back to back (CUDA events), its line, the
    cadence-amortised summary, every MFU and HBM share in (0, 1.05], the
    launches over the 10 runs equal to ``expected_step_counts`` times 10;
    (b) while phase 22's blob-world processes train: seeded random-init
    checkpoints of the fourteen nets ``convert_weights`` knows, in their
    reference layouts and file names, and a CPU child process that counts
    the size-32 steps (configs/ffhq.json at 32 px, 32 channels, ESR-9 and
    Hopenet of the battery) and runs ``convert_weights --device cpu`` on
    them; the same
    size-32 steps counted on the card; ``precision_drift --storage`` (64
    images, its three legs on the card: the table, every threshold
    finite); (c) ``convert_weights`` on the card, then its ``--validate``
    against its own goldens; (d) after phase 22, ``train_mfu``'s
    generation (batch 128, bf16) and phase-2b executables (``latent_rec``
    at 128, ``attribute_rec`` through the rematerialised G and Hopenet at
    32) as (a), their launches against counts derived from the modules;
    the size-32 counts card against CPU (FLOPs per op kind exactly, bytes
    apart from ``.contiguous()`` layout copies exactly; both printed); the
    card's and the CPU's msgpack files byte for byte; the card's probes
    against the CPU's goldens with the tool's tolerance (ArcFace's and
    DEX's, GOLDEN_CHAOTIC, printed, not held); then every (kernel, shape,
    dtype) that (a) and (d) launched, forward and backward against the
    plain version, with its times and bound;
24. int8 storage of the battery (``training_config.predictor_dtype:
    "int8"``) and the last developer probes ((a), (b), (d) and (e) beside
    phase 22's blob-world processes, (c) after phase 23): (a) a ``GeneratorTrainer``
    on configs/ffhq.json with int8 storage (FFHQ-512, batch 16, the
    six-net battery at random init: 1685 tensors, 280.5 M elements, in one
    int8 store), and the ``dequant_int8`` kernel on that whole store
    against its plain version, bitwise in bf16 and f32, with its device
    time (graph replay), its host-rate time, the plain per-tensor loop's
    and its bound; (b) ``train(2)`` with the counters set to 0 just before
    and read just after: each step kind's launches against
    ``expected_step_counts`` with exactly one dequantisation per
    ``g_step``, finite losses, the store unchanged, no float copy of a
    quantised tensor resident, each step's bf16 buffer freed with its
    step and the first bitwise the plain version's; then every (kernel,
    shape, dtype) of the G and D that it launched, against the plain
    version, with its times and bound; (c) ``battery_share``'s four legs
    (f32, bf16 and int8 storage, adversarial only) at FFHQ-512, batch 16:
    ms (synced median of 5, legs in turn), FLOPs and bytes, resident
    battery bytes and peaks; (d) on phase 9's size-32 model and calibrated
    battery, the CPU's side in a process of its own from the end of phase
    9 on, the card's beside phase 22: int8 stores quantised on the card
    and on the CPU bitwise
    equal and the dequantisation bitwise, the bf16 resize backward on the
    card within a rounding of the f32 sum, each net's features from the
    store bitwise a bf16 battery's of the dequantised weights, each net's
    image gradient card against CPU (f32 and bf16, against a float64
    witness), and the size-32 int8 ``g_step``'s G gradients card against
    CPU, each against the CPU's f32 step (``int8_card_vs_cpu`` gives the
    bounds); (e) ``profile_bench`` (its ``g_full`` step on (b)'s trainer,
    generation at batch 128) and ``loader_bench`` on 32 seeded JPEGs, as
    smoke tests of the tools;
25. float16 storage of the battery, ``collective_scaling`` and the
    notebook ((b) and (d) beside phase 22's blob-world processes, (c)'s CPU
    ranks from phase 22 on, (a) after 24c): (a) 24b's trainer with its
    battery recast (the six nets drawn again from its seed, their
    batch-norm statistics set from four of its G images: at random init the
    R-Net overflows float16, in the JAX package too) and stored in float16;
    ``train(2)`` with the counters set to 0 just before and read just
    after, each step kind against ``expected_step_counts``, finite losses
    and G gradients, the battery unchanged and in float16; then ``g_step``
    in float16 against the same weights in bf16 and the adversarial loss
    alone (synced median of 5, the legs in turn), FLOPs, bytes, resident
    battery bytes and peaks; (b) on phase 9's size-32 model and calibrated
    battery, the CPU's side in 24d's process: the predictors' float16
    resize backward within one float16 rounding of the f32 sum, each net's
    image gradient card against CPU (f32, and float16 against a float64
    witness on the float16 weights) and the size-32 float16 ``g_step``'s G
    gradients against the CPU's f32 step (``float16_card_vs_cpu`` gives the
    bounds), each float16 reading again with cuBLAS's float16
    reduced-precision reduction off; (c) ``python -m
    gan_control_torch.tools.collective_scaling`` on phase 7's plain
    iteration: its JSON names this card, its parameter bytes are the JAX
    tool's, each step all-reduces its gradients once at their bytes; (d)
    ``gan_control_torch/examples/gan_control_inference_example.ipynb``'s
    code cells on the card against phase 13's controller directory, its
    four images written, its launches counted;
26. the slowest phases' seconds, the script's total seconds; one JSON
    line of per-kernel numbers over ``train(5)``, the phase-2 launches of
    phases 10-12, the serving
    launches of phase 15, the evaluation launches of phase 16, the AFHQ and
    MetFaces launches of phase 18, the alignment and projection launches
    of phases 19-20, the two ranks' launches of phase 21b, phase 22's
    launches, phase 23's, phase 24's and phase 25's (launches, times and
    bounds summed over the eleven), then the card's line and the result
    line.

Times, per launch at each shape and summed over a path's launches:
"host-rate" is the mean over back-to-back eager calls between two CUDA
events, which is the host's launch rate wherever the device is faster than
the host (``ms`` in the JSON line); "device" is the mean over the same calls
captured in one CUDA graph and replayed, which takes the host out
(``device_ms``; the graph's gap between nodes, about a microsecond, stays
in). Both repeat a call on the same inputs, so inputs of up to tens of MB
are read from L2, as a layer's input written just before would be; larger
ones (blur_sep's four largest D levels, 67-537 MB) stream from HBM. The
bound is the bytes moved over the HBM rate or the f32 operations over the
f32 peak, whichever is larger.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import json
import logging
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
CONFIGS = REPO / "gan_control_tpu" / "configs"
BATCH = 8
TRAIN_ITERS = 5
PALLAS = "gan_control_tpu/ops/pallas_kernels.py"
# name -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "fused_bias_act": ("triton", "gan_control_torch/csrc/fused_bias_act.py", f"{PALLAS}:86"),
    # the gradient of the TPU kernel, which the JAX package left to XLA's autodiff
    "fused_bias_act_grad": ("triton", "gan_control_torch/csrc/fused_bias_act.py", f"{PALLAS}:86"),
    "blur2x_up": ("cuda", "gan_control_torch/csrc/blur2x_up.cu", f"{PALLAS}:215"),
    "blur2x_down": ("cuda", "gan_control_torch/csrc/blur2x_down.cu", f"{PALLAS}:149"),
    "blur_sep": ("cuda", "gan_control_torch/csrc/blur_sep.cu", f"{PALLAS}:318"),
    # no Pallas kernel: the JAX package dequantises the int8 battery with an
    # XLA convert per tensor (dequantize_predictor_params)
    "dequant_int8": ("triton", "gan_control_torch/csrc/dequant_int8.py",
                     "gan_control_tpu/losses/registry.py:148"),
}
# the kernels of the G and the D; dequant_int8 runs only under int8 storage (phase 24)
GD_KERNELS = tuple(n for n in KERNELS if n != "dequant_int8")
INFER_KERNELS = ("fused_bias_act", "blur2x_up")
# the one PyTorch call that computes a kernel's function (timed, never used by the port)
LIBRARY = {"blur2x_up": "conv_transpose2d", "blur2x_down": "stride-2 depthwise conv2d",
           "blur_sep": "depthwise conv2d"}
# kernel vs plain version, relative to max|plain|: f32 is the same f32
# arithmetic in another order; bf16 may round across one bf16 step (2**-7)
KERNEL_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7}
# gradients through a kernel's autograd Function vs autograd of the plain
# version: the backward kernels sum in another order than autograd's ops
GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-6}
# card vs CPU through the whole f32 generator: cuDNN and the CPU convs sum in
# other orders over up to 4608 terms per output, 16 layers deep
PARITY_RTOL = 1e-3
# card vs CPU training gradients (f32, TF32 off), per tensor against its
# largest entry: the same sums in other orders through up to two backward
# passes of a size-32 G and D
TRAIN_PARITY_RTOL = 1e-3
# predictor card vs CPU (f32, TF32 off, batch-norm statistics set from the
# G's images by calibrate_frozen_stats_): each returned layer against its
# largest entry, as PARITY_RTOL (sums in other orders, and cuDNN's choice of
# algorithm, through up to 100 conv layers); the
# image gradient in relative L2 norm, because a max-pool choice between two
# inputs within rounding of each other can flip and move it over a
# receptive field (calibrated, the nets' own f32 and float64 gradients
# differ by up to 5.5e-3 in relative L2 and 6.2e-2 in the largest entry;
# gan_control_torch/tools/predictor_precision_probe.py)
PREDICTOR_RTOL = 1e-3
PREDICTOR_GRAD_REL_L2 = 5e-2
PREDICTOR_BATCH = 2
# card vs CPU gradients of the G in a size-32 g_step with the battery, per
# tensor against its largest entry: on the CPU, running the battery in
# float64 instead of f32 moves them by up to 1.69e-3 (DEX alone 2.45e-3,
# the R-Net 9.7e-4; gan_control_torch/tools/predictor_precision_probe.py):
# the noise weights' scalar gradients, sums over every pixel of the image
# gradients of five deep nets; each side of card vs CPU carries such an
# error (measured card vs CPU on the H100: 3.5e-3, a noise weight)
BATTERY_PARITY_RTOL = 5e-3
# the hair mask is sigmoid(logit) >= 0.5: card and CPU logits agree to this
# share of max|logit|, and a pixel may take another mask on the card only
# where its logit lies that close to 0. In the size-32 g_step the G's
# images entering the mask net already differ between card and CPU, and
# the logits by 3.5e-3 of max (this script's "hair mask" line, H100)
HAIR_LOGIT_RTOL = 1e-2
BATTERY_REPS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


_T0 = time.perf_counter()
PHASE_SECONDS: list[tuple[str, float]] = []  # every phase that ended, in order


class Phase:
    """Prints a phase's seconds (and the script's seconds when it ends) and
    keeps them for the summary before the result lines."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            now = time.perf_counter()
            PHASE_SECONDS.append((self.name, now - self.t0))
            log(f"phase {self.name}: {now - self.t0:.1f} s (at {now - _T0:.1f} s)")


def cuda_ms(fn, min_total_ms: float = 30.0) -> float:
    """Host-rate time of ``fn``: the mean over back-to-back eager calls,
    between two CUDA events. It is the device's time only where the device is
    slower than the host's launch path; for small shapes it is the host's."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = int(min(1000, max(5, min_total_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, host_ms: float, target_ms: float = 20.0, replays: int = 3) -> float:
    """Device time of ``fn`` per call: back-to-back calls captured in one CUDA
    graph, replayed, between two CUDA events. The replay runs no Python, so
    this is the card's time: each kernel plus the graph's gap between nodes
    (about a microsecond). ``host_ms`` (from :func:`cuda_ms`, an upper
    bound) sizes the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture (cuDNN plans, the allocator)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    calls = int(min(200, max(3, target_ms / max(host_ms, 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def us(ms: float | None) -> str:
    return "none" if ms is None else f"{ms * 1e3:.2f} us"


def bound(name: str, shape, dtype, args=()) -> tuple[float, str]:
    """Least time (ms) for one launch: bytes (each input read once, each
    output written once) over peak bandwidth vs float operations over the
    f32 peak (the kernels compute in f32 whatever the storage), the work
    from ``kernels.kernel_work``, the peaks from ``utils/accounting.py``."""
    from gan_control_torch.ops.kernels import kernel_work
    from gan_control_torch.utils.accounting import PEAK_BYTES_PER_S, PEAK_FLOPS

    nbytes, ops = kernel_work(name, shape, dtype, args)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FLOPS["f32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def new_totals(names) -> dict:
    return {n: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                    library_ms=None, library_device_ms=None, launches=0, max_abs_err=0.0)
            for n in names}


def add_to_totals(tot: dict, count: int, t: dict, t_b: float, by: str) -> None:
    """``t``: per-launch times ``ms`` (host-rate) and ``device_ms`` of the
    kernel, ``plain_ms``, and those of the library call (None without one)."""
    for key in ("ms", "device_ms", "plain_ms"):
        tot[key] += count * t[key]
    tot["bound_ms"] += count * t_b
    tot["bytes_ms" if by == "bytes" else "ops_ms"] += count * t_b
    for key in ("library_ms", "library_device_ms"):
        if t[key] is not None:
            tot[key] = (tot[key] or 0.0) + count * t[key]


def merge_totals(into: dict, other: dict) -> None:
    """Adds another path's per-kernel totals to ``into``."""
    for n, t in other.items():
        tot = into[n]
        for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
            tot[key] += t[key]
        for key in ("library_ms", "library_device_ms"):
            if t[key] is not None:
                tot[key] = (tot[key] or 0.0) + t[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], t["max_abs_err"])


def totals_text(tot: dict) -> str:
    lib = "" if tot["library_ms"] is None else (
        f" library host-rate {tot['library_ms']:.4f} ms device {tot['library_device_ms']:.4f} ms")
    return (f"kernel host-rate {tot['ms']:.4f} ms device {tot['device_ms']:.4f} ms plain "
            f"{tot['plain_ms']:.4f} ms bound {tot['bound_ms']:.4f} ms{lib} "
            f"max_abs_err {tot['max_abs_err']:.3g}")


def time_case(run, plain, library) -> dict:
    """Per-launch times of a kernel call, its plain version and the library
    call (or None): host-rate for all three, device time for the kernel and
    the library call."""
    t = {"ms": cuda_ms(run), "plain_ms": cuda_ms(plain), "library_ms": None, "library_device_ms": None}
    t["device_ms"] = device_ms(run, t["ms"])
    if library is not None:
        t["library_ms"] = cuda_ms(library)
        t["library_device_ms"] = device_ms(library, t["library_ms"])
    return t


def timing_text(t: dict, t_b: float, by: str, library_name: str | None) -> str:
    """Per launch: device and host-rate times of the kernel and the library
    call, beside the bound."""
    text = (f"kernel device {us(t['device_ms'])} host-rate {us(t['ms'])}, plain {us(t['plain_ms'])}, "
            f"bound {us(t_b)} ({by}; the device reaches {100 * t_b / t['device_ms']:.0f}% of it)")
    if library_name is not None:
        text += (f"; {library_name} device {us(t['library_device_ms'])} "
                 f"host-rate {us(t['library_ms'])}")
    return text


# ---------------------------------------------------------------------------
# inference (the first slice)
# ---------------------------------------------------------------------------


def write_controller_dir(root: Path) -> None:
    """FFHQ-512 generator + orientation and age heads at random init (the
    JAX initialisers' distributions), in the JAX package's layout."""
    from gan_control_torch.models.blocks import init_params_
    from gan_control_torch.models.controller import FcStack
    from gan_control_torch.models.factory import build_generator, build_group_spec
    from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

    config = json.loads((CONFIGS / "ffhq.json").read_text())
    gdir = root / "generator"
    gdir.mkdir(parents=True)
    (gdir / "args.json").write_text(json.dumps(config, indent=2))
    spec = build_group_spec(config)
    gen = build_generator(config, spec, device="cpu", seed=0)
    save_flax_checkpoint(gdir / "checkpoint", "g_ema", gen)
    for i, group in enumerate(("orientation", "age")):
        hcfg = json.loads((CONFIGS / "controller_configs" / "ffhq" / f"{group}_controller.json").read_text())
        mc = hcfg["model_config"]
        head = FcStack(in_dim=mc["in_dim"], n_mlp=mc["n_mlp"], mid_dim=mc["mid_dim"],
                       out_dim=spec.group(group).latent_size, lr_mlp=mc["lr_mlp"])
        cdir = root / f"{group}_{hcfg['save_name']}"
        cdir.mkdir()
        (cdir / "args.json").write_text(json.dumps(hcfg, indent=2))
        save_flax_checkpoint(cdir / "checkpoint", "controller", init_params_(head, seed=1 + i))


def controls(batch: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        orientation=(rng.uniform(-30, 30, size=(batch, 3))).astype(np.float32),
        age=rng.uniform(20, 70, size=(batch, 1)).astype(np.float32),
    )


def record_kernel_shapes(ctrl, ctl: dict) -> Counter:
    """(kernel, shape, dtype) -> launches in one main-path call, seen by
    forward hooks on the modules that call each kernel."""
    from gan_control_torch.models.blocks import EqualLinear, StyledConv, ToRGB

    seen: Counter = Counter()

    def out_hook(mod, args, out):
        seen[("fused_bias_act", tuple(out.shape), out.dtype)] += 1

    def skip_hook(mod, args, out):
        if len(args) > 2 and args[2] is not None:
            seen[("blur2x_up", tuple(args[2].shape), args[2].dtype)] += 1

    mods = [ctrl.model, *ctrl.fc_controls.values()]
    handles = []
    for root in mods:
        for m in root.modules():
            if (isinstance(m, EqualLinear) and m.activation == "fused_lrelu") or isinstance(m, StyledConv):
                handles.append(m.register_forward_hook(out_hook))
            elif isinstance(m, ToRGB):
                handles.append(m.register_forward_hook(skip_hook))
    try:
        ctrl.gen_batch_by_controls(batch_size=BATCH, latent=np.zeros((BATCH, 512), np.float32), **ctl)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return seen


def inference_kernel_phase(shapes: Counter) -> dict:
    """Compare and time each kernel at every recorded shape, in f32 and bf16.
    Returns per-kernel totals over one main-path call: times and bounds
    summed over its launches at the path's own dtypes, the worst error."""
    from gan_control_torch.ops import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = new_totals(INFER_KERNELS)
    for (name, shape, path_dtype), count in sorted(shapes.items(), key=lambda kv: str(kv[0])):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            if name == "fused_bias_act":
                b = torch.randn(shape[-1], generator=gen, device="cuda")
                run = lambda: kernels.fused_bias_act(x, b)  # noqa: E731
                plain = lambda: kernels.fused_bias_act_plain(x, b)  # noqa: E731
                library = None
            else:
                c = shape[-1]
                k = torch.tensor([1.0, 3.0, 3.0, 1.0], device="cuda")
                w = (torch.outer(k, k) / 64.0 * 4.0)[None, None].repeat(c, 1, 1, 1).to(dtype)
                run = lambda: kernels.blur2x_up(x)  # noqa: E731
                plain = lambda: kernels.blur2x_up_plain(x)  # noqa: E731
                library = lambda: F.conv_transpose2d(  # noqa: E731
                    x.permute(0, 3, 1, 2), w, stride=2, padding=1, groups=c)
            with torch.no_grad():
                got, want = run().float(), plain().float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = KERNEL_RTOL[dtype] * max(1.0, float(want.abs().max()))
            ok = err <= tol and bool(torch.isfinite(got).all())
            if not ok:
                fail(f"{name} disagrees with its plain version at {shape} {dtype}: {err} > {tol}")
            with torch.no_grad():
                lib_err = None
                if library is not None:
                    lib_err = float((library().permute(0, 2, 3, 1).float() - want).abs().max())
                t = time_case(run, plain, library)
            t_b, by = bound(name, shape, dtype)
            log(f"kernel {name} {list(shape)} {str(dtype)[6:]} (x{count} on the path in "
                f"{str(path_dtype)[6:]}): max_abs_err {err:.3g} (tol {tol:.3g}); per launch "
                + timing_text(t, t_b, by, LIBRARY.get(name))
                + ("" if lib_err is None else f" (its err {lib_err:.3g})"))
            if dtype == path_dtype:
                add_to_totals(totals[name], count, t, t_b, by)
                totals[name]["max_abs_err"] = max(totals[name]["max_abs_err"], err)
    return totals


def profile_phase(label: str, fn, median_ms: float) -> None:
    """Device time by kernel over one warm call of ``fn`` (torch.profiler;
    the profiled call runs slower than an unprofiled one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    log(f"profile {label}: device busy {busy:.3f} ms per call in {sum(n for *_, n in rows)} kernels "
        f"= {100 * busy / median_ms:.1f}% of the {median_ms:.2f} ms median call")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:15]:
        log(f"profile {label}: {ms:8.3f} ms {100 * ms / max(busy, 1e-9):5.1f}% x{n:<4d} {key[:100]}")


def inference_phases(build_root: Path) -> tuple[dict, dict]:
    """Phases 3-6. Returns (per-kernel totals of one call, main-path counts)."""
    from gan_control_torch.inference.controller import Controller
    from gan_control_torch.ops import kernels

    with tempfile.TemporaryDirectory(dir=build_root) as tmp:
        root = Path(tmp) / "ffhq_controller"
        with Phase("inference load"):
            write_controller_dir(root)
            ctrl = Controller(root)
            log(f"load: synthesis {ctrl.model.dtype}, heads {sorted(ctrl.fc_controls)}")
            ctl = controls(BATCH, 1)
            shapes = record_kernel_shapes(ctrl, ctl)
            expected = {n: sum(c for (k, _, _), c in shapes.items() if k == n) for n in INFER_KERNELS}
            log(f"path: kernel launches per call by shape hooks {expected}")

        with Phase("inference kernels"):
            totals = inference_kernel_phase(shapes)

        with Phase("inference main path"):
            torch.backends.cudnn.allow_tf32 = True  # defaults; synthesis is bf16
            z = np.random.default_rng(2).standard_normal((BATCH, 512)).astype(np.float32)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            img, _, latent_w = ctrl.gen_batch_by_controls(batch_size=BATCH, latent=z, **ctl)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            log(f"main path: launches {counts}")
            if tuple(img.shape) != (BATCH, 512, 512, 3) or not bool(torch.isfinite(img).all()):
                fail(f"bad main-path output {tuple(img.shape)}")
            want = {"fused_bias_act": 56 + 2 * 4 + 15, "fused_bias_act_grad": 0, "blur2x_up": 7,
                    "blur2x_down": 0, "blur_sep": 0, "dequant_int8": 0}
            if counts != want or any(counts[n] != expected[n] for n in INFER_KERNELS):
                fail(f"launch counts {counts}, expected {expected} (79 and 7)")
            times = []
            for _ in range(7):
                t0 = time.perf_counter()
                ctrl.gen_batch_by_controls(batch_size=BATCH, latent=z, **ctl)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            med = statistics.median(times)
            log(f"main path: gen_batch_by_controls batch {BATCH} bf16 median {med:.2f} ms over "
                f"{len(times)} warm calls ({BATCH / med * 1e3:.1f} images/s); all "
                f"{[round(t, 2) for t in times]}; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            profile_phase("inference", lambda: ctrl.gen_batch_by_controls(
                batch_size=BATCH, latent=z, **ctl), med)
            del ctrl, img, latent_w

        with Phase("inference card vs cpu"):
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            card = Controller(root, device="cuda", dtype=torch.float32)
            cpu = Controller(root, device="cpu", dtype=torch.float32)
            rng = np.random.default_rng(3)
            z1 = rng.standard_normal((1, 512)).astype(np.float32)
            noise = [rng.standard_normal(s).astype(np.float32) for s in card.model.noise_shapes(1)]
            card.set_noise(noise)
            cpu.set_noise(noise)
            ctl1 = controls(1, 4)
            want_img, _, _ = cpu.gen_batch_by_controls(latent=z1, normalize=False, **ctl1)
            got, _, _ = card.gen_batch_by_controls(latent=z1, normalize=False, **ctl1)
            got = got.cpu()
            err = float((got - want_img).abs().max())
            tol = PARITY_RTOL * max(1.0, float(want_img.abs().max()))
            log(f"card vs cpu: batch 1 f32 TF32 off, max_abs_err {err:.3g} (tol {tol:.3g}, "
                f"max|img| {float(want_img.abs().max()):.3g})")
            if not (err <= tol and bool(torch.isfinite(got).all())):
                fail("card and CPU disagree")
    return totals, counts


# ---------------------------------------------------------------------------
# training (this slice)
# ---------------------------------------------------------------------------

def g_counts(g) -> tuple[int, int, int]:
    """(mapping layers that run fused_bias_act, StyledConvs, ToRGB skips
    that run blur2x_up) of a generator."""
    from gan_control_torch.models.blocks import EqualLinear, StyledConv

    # the mapping's layers, whichever mapping: the only EqualLinears with the
    # fused activation in G (the modulations have none)
    n_map = sum(isinstance(m, EqualLinear) and m.activation == "fused_lrelu" for m in g.modules())
    n_conv = sum(isinstance(m, StyledConv) for m in g.modules())
    return n_map, n_conv, len(g.to_rgbs)


def row(fba: int, grad: int, up: int, down: int, sep: int = 0, dequant: int = 0) -> dict:
    """Launches of each kernel."""
    return {"fused_bias_act": fba, "fused_bias_act_grad": grad, "blur2x_up": up,
            "blur2x_down": down, "blur_sep": sep, "dequant_int8": dequant}


def expected_step_counts(g, d, n_groups: int) -> dict:
    """Kernel launches per step kind, and per ``save_images`` (the EMA
    generator's forward on the sample grid and on one matrix per each of
    ``n_groups`` latent groups), derived from the modules.

    G: ``n_map`` mapping layers and ``n_conv`` StyledConvs run
    fused_bias_act, ``n_up`` ToRGB skips run blur2x_up. D: ``d_fba``
    fused_bias_act layers (``d_low`` of them below the minibatch-stddev
    statistic), ``d_sep`` blur_sep pre-blurs. A backward runs each
    Function's gradient kernel once: fused_bias_act_grad, blur_sep again,
    blur2x_down for blur2x_up. The R1 double backward runs the gradient
    kernels of the first backward once more, and the gradient kernels of
    the forward layers below the stddev statistic, whose gradient reads its
    input. The path-length double backward runs the StyledConvs' gradient
    kernels again, and those of every forward layer of G (the modulations'
    gradients read the activations, and the latent comes from the mapping);
    the skip chain's first-order gradient is the projection noise carried
    back by blur2x_down, which no parameter touches, so the double backward
    launches no blur kernel in G.
    """
    from gan_control_torch.models.blocks import ConvLayer, EqualLinear

    n_map, n_conv, n_up = g_counts(g)
    heads = [m for name, m in d.named_children() if name.endswith("_head")]
    in_heads = {id(x) for h in heads for x in h.modules()}
    fba = [m for m in d.modules() if (isinstance(m, ConvLayer) and m.activate)
           or (isinstance(m, EqualLinear) and m.activation == "fused_lrelu")]
    d_fba = len(fba)
    d_low = sum(id(m) not in in_heads for m in fba)
    d_sep = sum(isinstance(m, ConvLayer) and m.downsample for m in d.modules())
    g_fba = n_map + n_conv
    return {
        "d_step": row(g_fba + 2 * d_fba, 2 * d_fba, n_up, 0, 4 * d_sep),
        "d_reg_step": row(d_fba, 2 * d_fba + d_low, 0, 0, 4 * d_sep),
        "g_step": row(g_fba + d_fba, g_fba + d_fba, n_up, n_up, 2 * d_sep),
        "g_reg_step": row(g_fba, 3 * n_conv + n_map, n_up, n_up, 0),
        "save_images": row((1 + n_groups) * g_fba, 0, (1 + n_groups) * n_up, 0, 0),
    }


def install_launch_recorder(seen: Counter):
    """Hooks on the launchers: (kernel, shape, dtype, static args) -> launches.
    Returns a function that removes them."""
    from gan_control_torch.ops import kernels

    originals = {}
    for name in KERNELS:
        attr = f"_cuda_{name}"
        orig = originals[attr] = getattr(kernels, attr)

        def hook(*a, _orig=orig, _name=name):
            seen[(_name, tuple(a[0].shape), a[0].dtype, kernels.launch_static_args(_name, a))] += 1
            return _orig(*a)

        setattr(kernels, attr, hook)

    def remove():
        for attr, orig in originals.items():
            setattr(kernels, attr, orig)

    return remove


def count_by_kind(gt, trainer=None):
    """Wraps each step function of the trainer module ``gt`` (and, with
    ``trainer``, its ``save_images``) so that each call appends the launch
    counters' change over it to its kind's list. Returns (lists by kind, a
    function that removes the wrappers)."""
    from gan_control_torch.ops import kernels

    kinds = (*gt.STEP_KINDS, "save_images") if trainer is not None else gt.STEP_KINDS
    by_kind: dict[str, list[dict]] = {k: [] for k in kinds}
    originals = {k: getattr(gt, k) for k in gt.STEP_KINDS}

    def counted(kind, fn):
        def run(*a, **kw):
            before = kernels.launch_counts()
            out = fn(*a, **kw)
            after = kernels.launch_counts()
            by_kind[kind].append({n: after[n] - before[n] for n in after})
            return out
        return run

    for k in gt.STEP_KINDS:
        setattr(gt, k, counted(k, originals[k]))
    if trainer is not None:
        trainer.save_images = counted("save_images", trainer.save_images)

    def restore():
        for k in gt.STEP_KINDS:
            setattr(gt, k, originals[k])
        if trainer is not None:
            del trainer.save_images

    return by_kind, restore


def worst_grad_err(want: dict, got: dict, floor: float = 1e-12) -> tuple[float, str]:
    """The largest error of a gradient tensor of ``got`` over the largest
    entry of its ``want`` tensor, and that tensor's name."""
    worst, worst_name = 0.0, ""
    for n in want:
        r = float((got[n] - want[n]).abs().max()) / max(float(want[n].abs().max()), floor)
        if r > worst:
            worst, worst_name = r, n
    return worst, worst_name


def event_ms(fn, reps: int = BATTERY_REPS) -> list[float]:
    """Milliseconds between two CUDA events around each of ``reps`` calls
    of ``fn`` (after one warm call); each call returns its own list of
    events to time between, so a call may time several spans."""
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        events = fn()
        events[-1].synchronize()
        spans.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    return [statistics.median(s[i] for s in spans) for i in range(len(spans[0]))]


def battery_timing(trainer, g_step_ms: float) -> None:
    """Device time of each predictor's loss at the trainer's batch, dtype and
    512 px: its forward (the net and the contrastive loss over the
    mini-batch chunks) and the backward to the images, between CUDA events,
    median of a few calls; the recon sub-losses share one R-Net forward, so
    they are timed together. Then the whole battery against the median
    ``g_step``."""
    from gan_control_torch.training import train_step as ts
    from gan_control_torch.utils.precision import battery_compute_dtype, battery_dtype

    cfg = trainer.step_cfg
    dtype = battery_compute_dtype(cfg.predictor_dtype)
    gen = torch.Generator(device="cuda").manual_seed(11)
    images = torch.randn((cfg.batch, 512, 512, 3), generator=gen, device="cuda").to(dtype) * 0.5
    groups: dict[str, list] = {}
    for al in trainer.attr_losses:
        groups.setdefault(al.share_key or al.name, []).append(al)

    def fwd_bwd(specs):
        def run():
            x = images.detach().clone().requires_grad_(True)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            total, _ = ts._attr_losses_for_batch(specs, trainer.spec, trainer.predictors, x, cfg.num_mini,
                                                 remat=cfg.remat_predictors,
                                                 dtype=battery_dtype(cfg.predictor_dtype))
            ev[1].record()
            torch.autograd.grad(total, x)
            ev[2].record()
            return ev
        return event_ms(run)

    for key, specs in groups.items():
        f, b = fwd_bwd(specs)
        log(f"battery {key} ({', '.join(s.name for s in specs)}): batch {cfg.batch} "
            f"{str(dtype)[6:]} 512 px, remat {cfg.remat_predictors}: forward {f:.2f} ms, image-gradient "
            f"backward {b:.2f} ms (CUDA events, median of {BATTERY_REPS})")
    f, b = fwd_bwd(list(trainer.attr_losses))
    log(f"battery all {len(trainer.attr_losses)} losses: forward {f:.2f} ms, backward {b:.2f} ms, "
        f"together {f + b:.2f} ms = {100 * (f + b) / g_step_ms:.1f}% of the {g_step_ms:.2f} ms median g_step")


def train_phase(build_root: Path) -> tuple[Counter, dict, dict, tuple]:
    """Phase 7, and phase 23a on its trainer. Returns the recorded launches
    of ``train(5)`` by (kernel, shape, dtype, static args), the counters
    read after it, the plain iterations' ms with the synthetic loader, and
    phase 23a's recorded launches and counts."""
    from gan_control_torch.data.datasets import synthetic_data_loader
    from gan_control_torch.inference.inference import Inference
    from gan_control_torch.losses.registry import build_attr_losses, distinct_predictors
    from gan_control_torch.ops import kernels
    from gan_control_torch.trainers import generator_trainer as gt

    torch.backends.cudnn.allow_tf32 = True  # the defaults: the config trains in bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["results_dir"] = str(build_root / "train_results")
    with Phase("train build"):
        # as train_generator.py builds it: the config's battery at random init
        specs, predictors = build_attr_losses(config["training_config"], device="cuda")
        trainer = gt.GeneratorTrainer(
            config=config, data_loader=synthetic_data_loader(16, 512, seed=0), device="cuda",
            attr_losses=specs, predictors=predictors)
        st = trainer.state
        log(f"train: G synthesis {st.generator.dtype}, D {st.discriminator.dtype}, batch "
            f"{trainer.step_cfg.batch}, params G {sum(p.numel() for p in st.generator.parameters())} "
            f"D {sum(p.numel() for p in st.discriminator.parameters())}; results {trainer.save_dir}")
        nets = distinct_predictors(trainer.predictors)
        log(f"train: battery {[al.name for al in trainer.attr_losses]}, "
            f"{trainer.step_cfg.predictor_dtype}, remat {trainer.step_cfg.remat_predictors}; nets "
            + ", ".join(f"{n} {type(m).__name__} {sum(p.numel() for p in m.parameters())}"
                        for n, m in nets.items()))
        if len(trainer.attr_losses) != 6 or len(nets) != 6:
            fail("configs/ffhq.json should give six losses on six nets")
        pred_before = {n: {k: v.detach().clone() for k, v in m.state_dict().items()} for n, m in nets.items()}
        per_kind = expected_step_counts(st.generator, st.discriminator, len(trainer.spec.groups))
        log(f"train: expected launches per step kind {per_kind}")

    with Phase("train dry run"):
        m = trainer.dry_run()
        log(f"dry run: {m}")
        if not all(math.isfinite(v) for v in m.values()):
            fail(f"dry run losses not finite: {m}")

    before_params = {f"G.{k}": v.detach().clone() for k, v in st.generator.state_dict().items()}
    before_params.update({f"D.{k}": v.detach().clone() for k, v in st.discriminator.state_dict().items()})
    seen: Counter = Counter()
    with Phase("train main path"):
        by_kind, restore = count_by_kind(gt, trainer)
        remove = install_launch_recorder(seen)
        trainer.profile_steps = True
        torch.cuda.reset_peak_memory_stats()
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            trainer.train(TRAIN_ITERS)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            copies = kernels.contiguous_grad.copies
        finally:
            remove()
            restore()
        log(f"train main path: launches over train({TRAIN_ITERS}) {counts}; gradient layout copies {copies}")
        for kind in gt.STEP_KINDS:
            for got in by_kind[kind]:
                if got != per_kind[kind]:
                    fail(f"{kind}: launches {got}, expected {per_kind[kind]}")
        for got in by_kind["save_images"]:
            if got != per_kind["save_images"]:
                fail(f"save_images: launches {got}, expected {per_kind['save_images']}")
        runs = {k: len(v) for k, v in by_kind.items()}
        if runs != {"d_step": 5, "d_reg_step": 1, "g_step": 5, "g_reg_step": 2, "save_images": 1}:
            fail(f"step kinds run {runs}")
        want_total = {n: sum(runs[k] * per_kind[k][n] for k in runs) for n in KERNELS}
        if counts != want_total:
            fail(f"launch counts {counts}, expected {want_total}")
        recorded = {n: sum(c for key, c in seen.items() if key[0] == n) for n in KERNELS}
        if recorded != counts:
            fail(f"launch hooks saw {recorded}, counters say {counts}")
        for h in trainer.metrics_history:
            if not all(math.isfinite(v) for v in h.values()):
                fail(f"losses not finite: {h}")
        log(f"train metrics: {trainer.metrics_history}")
        unmoved = [k for k, v in (
            [(f"G.{k}", v) for k, v in st.generator.state_dict().items()]
            + [(f"D.{k}", v) for k, v in st.discriminator.state_dict().items()])
            if torch.equal(v, before_params[k])]
        if unmoved:
            fail(f"parameters that did not change: {unmoved}")
        attr_names = [f"g_{al.name}" for al in trainer.attr_losses]
        for h in trainer.metrics_history:
            if not all(n in h for n in attr_names):
                fail(f"iteration {h['iter']} lacks attribute-loss metrics: {sorted(h)}")
            log(f"train attribute losses, iteration {h['iter']}: "
                + ", ".join(f"{n} {h[n]:.6g}" for n in attr_names) + f"; g_loss {h['g_loss']:.6g}")
        for n, m in nets.items():
            with_grad = [k for k, p in m.named_parameters() if p.grad is not None or p.requires_grad]
            changed = [k for k, v in m.state_dict().items() if not torch.equal(v, pred_before[n][k])]
            if with_grad or changed:
                fail(f"predictor {n}: parameters with a gradient {with_grad[:3]}, changed {changed[:3]}")
        log(f"train: every predictor tensor unchanged, none with a gradient "
            f"({sum(len(s) for s in pred_before.values())} tensors)")
        for kind, ts in trainer.step_times.items():
            log(f"train time: {kind} median {statistics.median(ts):.2f} ms over {len(ts)} "
                f"({[round(t, 2) for t in ts]})")
        it = [t * 1e3 for t in trainer.iter_times]
        log(f"train time: iteration median {statistics.median(it):.2f} ms over {len(it)} "
            f"({[round(t, 2) for t in it]}); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    with Phase("train battery times"):
        battery_timing(trainer, statistics.median(trainer.step_times["g_step"]))

    with Phase("train profile"):
        trainer.profile_steps = False
        times = plain_iteration_ms(trainer)
        synthetic = {"times": times, "median": statistics.median(times)}
        log(f"train plain iteration (d_step + g_step) with the synthetic loader: median "
            f"{synthetic['median']:.2f} ms ({[round(t, 2) for t in times]})")
        profile_phase("train iteration 1 (d_step, g_step)", lambda: trainer.one_iteration(1),
                      synthetic["median"])
        t0 = time.perf_counter()
        trainer.one_iteration(0)
        torch.cuda.synchronize()
        profile_phase("train iteration 0 (all four steps)", lambda: trainer.one_iteration(0),
                      (time.perf_counter() - t0) * 1e3)

    with Phase("train g_ema inference"):
        ckpts = sorted(p.name for p in (trainer.save_dir / "checkpoint").iterdir())
        log(f"train checkpoints: {ckpts}")
        inf = Inference(trainer.save_dir, device="cuda")
        img, _, _ = inf.gen_batch(batch_size=4, generator=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        if tuple(img.shape) != (4, 512, 512, 3) or not bool(torch.isfinite(img).all()):
            fail(f"bad g_ema output {tuple(img.shape)}")
        log(f"g_ema through Inference: {tuple(img.shape)} {img.dtype}, checkpoint {inf.ckpt_iter}, "
            f"mean {float(img.mean()):.4f}")
    # phase 23a: train_mfu's train family on this trainer's state and battery
    measuring = mfu_train_phase(trainer, per_kind)
    trainer.close()
    del trainer, inf, img
    torch.cuda.empty_cache()
    return seen, counts, synthetic, measuring


PLAIN_ITERS = (1, 2, 3, 5)  # d_step + g_step only (no R1, no path length)


def plain_iteration_ms(trainer) -> list[float]:
    """Host ms of each of the plain iterations ``PLAIN_ITERS``, each from a
    synced device to a synced device, the batch taken from the trainer's
    loader (through its prefetching feeder) inside the timed span."""
    times = []
    for i in PLAIN_ITERS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.one_iteration(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


FOLDER_IMAGES = 64
FOLDER_PX = 1024
PREEMPT_AFTER = 3  # SIGTERM once this iteration's metrics are logged
RESUME_ITERS = 2  # iterations of the resumed run past its checkpoint


def write_image_folder(root: Path, n: int, px: int, seed: int = 0) -> Path:
    """``n`` RGB PNGs of ``px`` pixels, as FFHQ's images1024x1024: smooth
    random faces-sized pictures (seeded low-resolution noise, upsampled
    bicubically, plus fine noise), written by threads."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    coarse = (rng.random((n, 16, 16, 3)) * 255).astype(np.uint8)
    fine_seeds = rng.integers(0, 2**31, n)

    def one(i):
        img = np.asarray(Image.fromarray(coarse[i]).resize((px, px), Image.BICUBIC), np.int16)
        img = img + np.random.default_rng(int(fine_seeds[i])).integers(-8, 9, img.shape, dtype=np.int16)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(root / f"{i:05d}.png")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(n)))
    return root


class CliRun:
    """``python -m gan_control_torch.train_generator`` in a subprocess, its
    log read line by line on a thread (kept in ``lines``)."""

    def __init__(self, config_path: Path, iters: int, log_path: Path):
        import queue
        import threading

        self.proc = subprocess.Popen(
            [sys.executable, "-m", "gan_control_torch.train_generator", "--config_path",
             str(config_path), "--iters", str(iters)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        self.lines: list[str] = []
        self._queue: queue.Queue = queue.Queue()
        self._log = open(log_path, "w")
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self._log.write(line)
            self._log.flush()
            self._queue.put(line)
        self._queue.put(None)

    def wait_for(self, pattern: str, timeout: float):
        import queue
        import re

        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                line = self._queue.get(timeout=1)
            except queue.Empty:
                continue
            if line is None:
                break
            self.lines.append(line)
            m = re.search(pattern, line)
            if m:
                return m
        self.kill()
        fail(f"train_generator: no line matching {pattern!r}; last lines:\n" + "".join(self.lines[-20:]))

    def finish(self, timeout: float) -> int:
        import queue

        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            fail("train_generator did not exit in time")
        while True:
            try:
                line = self._queue.get(timeout=10)
            except queue.Empty:
                break
            if line is None:
                break
            self.lines.append(line)
        self._log.close()
        return rc

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def log_time(line: str) -> float:
    """Seconds of a log line's ``%(asctime)s`` stamp (same day)."""
    stamp = line.split(" ")[1]  # HH:MM:SS,mmm
    h, m, rest = stamp.split(":")
    sec, ms = rest.split(",")
    return int(h) * 3600 + int(m) * 60 + int(sec) + int(ms) / 1e3


def in_thread(fn):
    """``fn()`` started on a thread; returns a function that waits for it
    and gives its result, or raises what it raised (a ``fail`` included)."""
    import threading

    box: dict = {}

    def target():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller's thread
            box["error"] = e

    thread = threading.Thread(target=target, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["result"]

    return join


def image_folder_start(build_root: Path):
    """Phase 7b's image folder and config, and its preempted command line
    started, watched on a thread (which sends the SIGTERM), beside phase 9.
    Returns (config, its path, the waiter of the preempted run)."""
    with Phase("folder write"):
        folder = write_image_folder(build_root / "ffhq_images1024x1024", FOLDER_IMAGES, FOLDER_PX)
        log(f"image folder: {FOLDER_IMAGES} RGB PNGs of {FOLDER_PX} px, "
            f"{sum(p.stat().st_size for p in folder.iterdir()) / 2**20:.1f} MiB")
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["results_dir"] = str(build_root / "folder_results")
    config["data_config"]["path"] = str(folder)
    tc = config["training_config"]
    # iteration 0 saves the sample images and the nets; every iteration logs
    tc.update(save_images_interval=1000, save_nets_interval=1000, log_every=1)
    cfg_path = build_root / "folder_config.json"
    cfg_path.write_text(json.dumps(config))
    return config, cfg_path, in_thread(lambda: folder_preempted(build_root, cfg_path))


def folder_preempted(build_root: Path, cfg_path: Path) -> tuple[Path, Path, int]:
    """Phase 7b's first command line, SIGTERM once iteration PREEMPT_AFTER
    is logged. Returns (its run directory, its checkpoint, the checkpoint's
    iteration)."""
    with Phase("folder train, preempted (beside phase 9)"):
        run = CliRun(cfg_path, 1000, build_root / "train_generator_preempted.log")
        save_dir = Path(run.wait_for(r"save dir: (\S+)", 300)[1])
        run.wait_for(rf"iter {PREEMPT_AFTER}: ", 600)
        run.proc.send_signal(signal.SIGTERM)
        warn = run.wait_for(r"checkpointing at iter (\d+)", 120)
        at = int(warn[1])
        saved = run.wait_for(rf"saved (\S+{at:06d}\.ckpt)", 300)
        rc = run.finish(120)
        if rc != 0:
            fail(f"the preempted train_generator exited {rc}")
        ckpt = save_dir / "checkpoint" / f"{at:06d}.ckpt"
        if not ckpt.exists() or at <= PREEMPT_AFTER:
            fail(f"no checkpoint at the iteration after the signal: {ckpt}")
        save_s = log_time(saved.string) - log_time(warn.string)
        size = ckpt.stat().st_size
        log(f"folder train: SIGTERM after iteration {PREEMPT_AFTER} was logged; exit 0; checkpoint "
            f"{ckpt.name} ({size / 2**20:.1f} MiB), preemption save {save_s * 1e3:.0f} ms (log stamps)")
        want = ["samples", *json.loads(cfg_path.read_text())["training_config"]["sub_groups_dict"]]
        missing = [g for g in want if not (save_dir / "images" / g / "000000.jpg").exists()]
        if missing or len(want) != 8:
            fail(f"sample images missing: {missing} of {want}")
        log(f"folder train: sample grid and {len(want) - 1} group matrices written at iteration 0")
    return save_dir, ckpt, at


def image_folder_phase(build_root: Path, synthetic: dict, started) -> Path:
    """Phase 7b: FFHQ-512 training from an image folder through the port's
    command line, preempted by SIGTERM (started by :func:`image_folder_start`),
    resumed from its checkpoint, and the checkpoint held against a fresh
    trainer's state; then the loader alone and plain iterations with the
    image loader against phase 7's synthetic ones (``synthetic``: its
    plain-iteration ms and busy share). Returns the preempted run's
    directory (phase 18's transfer source)."""
    from gan_control_torch.data import native_loader
    from gan_control_torch.data.datasets import get_data_loader
    from gan_control_torch.losses.registry import build_attr_losses
    from gan_control_torch.trainers import generator_trainer as gt
    from gan_control_torch.utils import checkpoint as ckpt_lib
    from gan_control_torch.utils.flax_bridge import flax_to_state_dict, load_gan_state

    config, cfg_path, wait = started
    save_dir, ckpt, at = wait()
    with Phase("folder train, resumed"):
        config["ckpt_config"] = {"enabled": True, "ckpt": str(ckpt)}
        cfg_path.write_text(json.dumps(config))
        resume_to = at + RESUME_ITERS
        run = CliRun(cfg_path, resume_to, build_root / "train_generator_resumed.log")
        start = int(run.wait_for(r"resumed from \S+: start_iter (\d+)", 300)[1])
        run.wait_for(rf"iter {resume_to - 1}: ", 600)
        rc = run.finish(300)
        if rc != 0 or start != at:
            fail(f"the resumed train_generator: exit {rc}, start_iter {start} (checkpoint step {at})")
        finals = sorted((build_root / "folder_results").glob(f"*/checkpoint/{resume_to:06d}.ckpt"))
        if not finals:
            fail(f"the resumed run left no checkpoint at {resume_to}")
        log(f"folder train: resumed at start_iter {start}, trained to {resume_to}, exit 0")

    with Phase("folder checkpoint against a fresh trainer"):
        config.pop("ckpt_config")
        specs, predictors = build_attr_losses(config["training_config"], device="cuda")
        trainer = gt.GeneratorTrainer(config=config, init_dirs=False, device="cuda",
                                      attr_losses=specs, predictors=predictors)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = ckpt_lib.load_state_dict(ckpt)
        t_read = time.perf_counter()
        load_gan_state(trainer.state, tree)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st = trainer.state
        for key, module in (("g_params", st.generator), ("d_params", st.discriminator),
                            ("g_ema", st.g_ema)):
            want_sd = flax_to_state_dict(tree[key])
            got_sd = module.state_dict()
            bad = [k for k in want_sd if not torch.equal(got_sd[k].cpu(), want_sd[k])]
            if bad or set(got_sd) != set(want_sd):
                fail(f"{key}: restored tensors differ from the file: {bad[:3]}")
        n_moments = 0
        for key, opt, module in (("g_opt_state", st.g_opt, st.generator),
                                 ("d_opt_state", st.d_opt, st.discriminator)):
            inner = tree[key]["0"]
            mu, nu = flax_to_state_dict(inner["mu"]), flax_to_state_dict(inner["nu"])
            for name, p in module.named_parameters():
                s_ = opt.state[p]
                if not (torch.equal(s_["exp_avg"].cpu(), mu[name]) and torch.equal(s_["exp_avg_sq"].cpu(), nu[name])
                        and int(s_["step"]) == int(inner["count"])):
                    fail(f"{key}: Adam state of {name} differs from the file")
                n_moments += 2
        if st.step != at or float(st.mean_path_length) != float(tree["mean_path_length"]):
            fail(f"step {st.step} / path-length mean differ from the file")
        log(f"folder resume: every parameter, EMA tensor and {n_moments} Adam moments equal the file "
            f"(step {st.step}, count g {int(tree['g_opt_state']['0']['count'])} "
            f"d {int(tree['d_opt_state']['0']['count'])}); resume {(t1 - t0) * 1e3:.0f} ms "
            f"(read and decode {(t_read - t0) * 1e3:.0f} ms, load to the card {(t1 - t_read) * 1e3:.0f} ms)")

    with Phase("folder loader and iterations"):
        route = "native (C++, native/gcdata.cpp)" if native_loader.available() else "PIL (Python loader)"
        # the config's decode threads, then one per core
        for k, workers in enumerate(dict.fromkeys((config["data_config"]["workers"], os.cpu_count()))):
            data_config = dict(config["data_config"], workers=workers)
            loader = get_data_loader(data_config, 16, 512)
            next(loader)
            n = 8
            t0 = time.perf_counter()
            for _ in range(n):
                batch = next(loader)
            per_batch = (time.perf_counter() - t0) * 1e3 / n
            loader.close()
            log(f"folder loader: decode route {route}; {per_batch:.1f} ms per batch of 16 at 512 px alone "
                f"(mean over {n} after a first; {workers} workers, {FOLDER_PX}-px PNGs); batch "
                f"{tuple(batch.shape)} in [{batch.min():.3f}, {batch.max():.3f}]")
            if batch.shape != (16, 512, 512, 3) or not np.isfinite(batch).all() or abs(batch).max() > 1.0:
                fail("the folder loader's batch is wrong")
            trainer.close()
            trainer.loader = get_data_loader(data_config, 16, 512)
            trainer.next_real()  # start the feeder: the first batch is set-up
            times = plain_iteration_ms(trainer)
            med = statistics.median(times)
            if k == 0:
                profile_phase("train plain iteration with the image loader",
                              lambda: trainer.one_iteration(PLAIN_ITERS[0]), med)
            log(f"folder iterations: plain iteration (d_step + g_step) median {med:.2f} ms with the image "
                f"loader at {workers} workers ({[round(t, 2) for t in times]}) against "
                f"{synthetic['median']:.2f} ms with the synthetic loader "
                f"({[round(t, 2) for t in synthetic['times']]})")
        trainer.close()
    del trainer
    torch.cuda.empty_cache()
    return save_dir


def kernel_case(name: str, shape, dtype, args, gen):
    """For one recorded launch: (inputs, Function call, plain version on the
    same inputs, launcher call, library call or None)."""
    from gan_control_torch.ops import kernels

    def rnd(s, dt=dtype):
        return torch.randn(s, generator=gen, device="cuda").to(dt)

    x = rnd(shape)
    c = shape[-1]
    if name == "fused_bias_act":
        slope, scale = args
        b = rnd((c,), torch.float32)
        return ([x, b], lambda x, b: kernels._FusedBiasAct.apply(x, b, slope, scale),
                lambda x, b: kernels.fused_bias_act_plain(x, b, slope, scale),
                lambda: kernels._cuda_fused_bias_act(x, b, slope, scale), None)
    if name == "fused_bias_act_grad":
        has_gb, slope, scale = args
        g, b = rnd(shape), rnd((c,), torch.float32)
        gb = rnd((c,), torch.float32) if has_gb else None
        ins = [g, gb] if has_gb else [g]

        def fn(g, gb=None):
            return kernels._FusedBiasActGrad.apply(g, x, b, gb, slope, scale)[0]

        return (ins, fn, lambda g, gb=None: kernels.fused_bias_act_grad_plain(g, x, b, gb, slope, scale),
                lambda: kernels._cuda_fused_bias_act_grad(g, x, b, gb, slope, scale), None)
    if name in ("blur2x_up", "blur2x_down"):
        (k,) = args
        up = name == "blur2x_up"
        fn_cls = kernels._Blur2xUp if up else kernels._Blur2xDown
        plain = kernels._up_plain if up else kernels._down_plain
        launch = kernels._cuda_blur2x_up if up else kernels._cuda_blur2x_down
        kt = torch.tensor(k, device="cuda", dtype=torch.float32)
        w = torch.outer(kt, kt)[None, None].repeat(c, 1, 1, 1).to(dtype)
        if up:  # correlation taps of the lhs-dilated form: conv_transpose2d with the flipped kernel
            library = lambda: F.conv_transpose2d(  # noqa: E731
                x.permute(0, 3, 1, 2), torch.flip(w, (2, 3)), stride=2, padding=1, groups=c)
        else:
            library = lambda: F.conv2d(x.permute(0, 3, 1, 2), w, stride=2, padding=1, groups=c)  # noqa: E731
        return ([x], lambda x: fn_cls.apply(x, k), lambda x: plain(x, k), lambda: launch(x, k), library)
    rt, ct, pad = args
    w = torch.outer(torch.tensor(rt, device="cuda"), torch.tensor(ct, device="cuda"))
    w = w[None, None].repeat(c, 1, 1, 1).to(dtype)
    p0, p1 = pad

    def library():
        xn = x.permute(0, 3, 1, 2)
        if p0 == p1:
            return F.conv2d(xn, w, padding=p0, groups=c)
        return F.conv2d(F.pad(xn, (p0, p1, p0, p1)), w, groups=c)

    return ([x], lambda x: kernels._BlurSep.apply(x, rt, ct, pad),
            lambda x: kernels.blur_sep_plain(x, rt, ct, pad),
            lambda: kernels._cuda_blur_sep(x, rt, ct, pad), library)


def max_err(got, want) -> tuple[float, float]:
    """(max abs error, max |want|)."""
    return float((got.float() - want.float()).abs().max()), float(want.float().abs().max())


def grads_of(fn, ins, gen, order2: bool):
    """Forward, first-order gradients of a seeded projection and, with
    ``order2``, the gradient of a seeded projection of those with respect
    to the first projection's weights."""
    ins = [t.detach().clone().requires_grad_(True) for t in ins]
    out = fn(*ins)
    g1 = torch.randn(out.shape, generator=gen, device="cuda").requires_grad_(order2)
    firsts = torch.autograd.grad((out.float() * g1).sum(), ins, create_graph=order2)
    res = [out.detach(), *[f.detach() for f in firsts]]
    if order2:
        w2 = [torch.randn(f.shape, generator=gen, device="cuda") for f in firsts]
        (second,) = torch.autograd.grad(sum((f.float() * w).sum() for f, w in zip(firsts, w2)), g1)
        res.append(second)
    return res


# (kernel, shape, dtype, static args) -> (errors, whether they include the
# second order, per-launch times or None): an earlier path's check of the
# same launch, which a later path's totals reuse
CHECKED: dict = {}


def train_kernel_phase(seen: Counter, label: str = f"train({TRAIN_ITERS})", both_dtypes: bool = True) -> dict:
    """Phase 8: per recorded (kernel, shape, dtype, args), forward and
    backward (and, once per kernel pair, the second order) against the
    plain version in f32 and bf16 (with ``both_dtypes``, else at the path's
    dtype alone); times at the path's dtype. A launch that an earlier call
    checked and timed (CHECKED) is not run again: its line says "checked
    above" and its numbers count in this path's totals. Returns per-kernel
    totals over the recorded launches (``label`` names them)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    totals = new_totals(KERNELS)
    levels: dict[tuple, dict] = {}  # blur_sep per D level (size, C): one launch of each shape
    second_done = set()
    for case, ((name, shape, path_dtype, args), count) in enumerate(
            sorted(seen.items(), key=lambda kv: str(kv[0]))):
        for dtype in ((torch.float32, torch.bfloat16) if both_dtypes else (path_dtype,)):
            key = (name, shape, dtype, args)
            errs, order2, t = CHECKED.get(key, (None, False, None))
            if errs is None:
                seed = 1000 * case + (dtype == torch.bfloat16)
                ins, fn, plain, launch, library = kernel_case(name, shape, dtype, args,
                                                              torch.Generator(device="cuda").manual_seed(seed))
                pair = "blur2x" if name.startswith("blur2x") else name
                order2 = pair not in second_done and dtype == torch.float32 and \
                    int(np.prod(shape)) <= (1 << 22)
                got = grads_of(fn, ins, torch.Generator(device="cuda").manual_seed(1), order2)
                want = grads_of(plain, ins, torch.Generator(device="cuda").manual_seed(1), order2)
                errs = []
                for i, (g, w) in enumerate(zip(got, want)):
                    err, scale = max_err(g, w)
                    rtol = KERNEL_RTOL[dtype] if i == 0 else GRAD_RTOL[dtype]
                    if not (err <= rtol * max(1.0, scale) and bool(torch.isfinite(g).all())):
                        fail(f"{name} {list(shape)} {dtype} {args}: output {i} disagrees with the plain "
                             f"version: {err} > {rtol * max(1.0, scale)}")
                    errs.append(err)
                if order2:
                    second_done.add(pair)
                if dtype == path_dtype:
                    with torch.no_grad():
                        t = time_case(launch, lambda: plain(*ins), library)
                del ins, got, want
                checked = ""
            else:
                checked = "checked above: "
                if t is None and dtype == path_dtype:  # checked, not timed, at this dtype
                    ins, _, plain, launch, library = kernel_case(name, shape, dtype, args,
                                                                 torch.Generator(device="cuda").manual_seed(case))
                    with torch.no_grad():
                        t = time_case(launch, lambda: plain(*ins), library)
                    del ins
            CHECKED[key] = (errs, order2, t)
            n_grads = len(errs) - 1 - order2
            line = (f"kernel {name} {list(shape)} {str(dtype)[6:]} {args} (x{count} in {label} in "
                    f"{str(path_dtype)[6:]}): {checked}errors fwd {errs[0]:.3g} bwd "
                    f"{max(errs[1:n_grads + 1]):.3g}" + (f" 2nd {errs[-1]:.3g}" if order2 else ""))
            if dtype == path_dtype:
                t_b, by = bound(name, shape, dtype, args)
                line += "; per launch " + timing_text(t, t_b, by, LIBRARY.get(name))
                add_to_totals(totals[name], count, t, t_b, by)
                # the forward's error, as for the inference kernels; the
                # gradients' errors are on the lines above
                totals[name]["max_abs_err"] = max(totals[name]["max_abs_err"], errs[0])
                if name == "blur_sep":
                    add_to_level(levels, shape, args, count, t, t_b)
            log(line)
    missing = sorted({"fused_bias_act", "fused_bias_act_grad", "blur_sep", "blur2x"} - second_done)
    if missing and both_dtypes:
        fail(f"no second-order check ran for {missing}")
    for (s, c), lv in sorted(levels.items(), reverse=True):
        log(f"blur_sep level {s} px C {c}: {lv['shapes']} shapes, x{lv['count']} in train("
            f"{TRAIN_ITERS}); one launch of each: kernel device {us(lv['device_ms'])} host-rate "
            f"{us(lv['ms'])}, bound {us(lv['bound_ms'])} (the device reaches "
            f"{100 * lv['bound_ms'] / lv['device_ms']:.0f}% of it); depthwise conv2d device "
            f"{us(lv['library_device_ms'])}")
    return totals


def add_to_level(levels: dict, shape, args, count: int, t: dict, t_b: float) -> None:
    """Adds one blur_sep shape's per-launch times to its D level: the even
    one of its input and output sizes (a level of size s runs s -> s+1 and
    s -> s-1 forward, s+1 -> s and s-1 -> s backward)."""
    _, _, (p0, p1) = args
    h = shape[1]
    level = (h if h % 2 == 0 else h + p0 + p1 - 3, shape[-1])
    lv = levels.setdefault(level, dict(shapes=0, count=0, ms=0.0, device_ms=0.0, bound_ms=0.0,
                                       library_device_ms=0.0))
    lv["shapes"] += 1
    lv["count"] += count
    lv["bound_ms"] += t_b
    for key in ("ms", "device_ms", "library_device_ms"):
        lv[key] += t[key]


def blur_sep_variant_check() -> None:
    """The direct (one channel a thread) variant of blur_sep at shapes the
    path never gives (C = 33 and 40, 2 and 3 taps, a 16-byte-misaligned
    input), in f32 (TF32 off) and bf16, forward and backward against the
    plain version."""
    from gan_control_torch.ops import kernels

    torch.backends.cudnn.allow_tf32 = False
    cases = [((4, 37, 29, 33), (0.25, 0.5, 0.25), (0.2, 0.3, 0.5), (1, 2), 0),
             ((4, 64, 64, 64), (0.125, 0.375, 0.375, 0.125), (0.125, 0.375, 0.375, 0.125), (2, 2), 1),
             ((2, 31, 17, 40), (0.5, 0.5), (0.7, 0.3), (0, 1), 3)]
    for i, (shape, rt, ct, pad, offset) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(2000 + i)
            buf = torch.randn(int(np.prod(shape)) + offset, generator=gen, device="cuda").to(dtype)
            x = buf[offset:].view(shape)
            lanes, rows = kernels.blur_sep_plan(x.shape, len(rt), pad, x.element_size(), x.data_ptr())
            if lanes != 1:
                fail(f"blur_sep {shape} offset {offset} {dtype}: the direct variant was not chosen")
            g1 = None

            def fwd_bwd(fn):  # on x itself: a copy would be aligned
                nonlocal g1
                xg = x.detach().requires_grad_(True)
                out = fn(xg)
                if g1 is None:
                    g1 = torch.randn(out.shape, generator=gen, device="cuda")
                (dx,) = torch.autograd.grad((out.float() * g1).sum(), xg)
                return out.detach(), dx

            before = kernels.blur_sep.launches
            got = fwd_bwd(lambda a: kernels.blur_sep(a, rt, ct, pad))
            want = fwd_bwd(lambda a: kernels.blur_sep_plain(a, rt, ct, pad))
            if kernels.blur_sep.launches != before + 2:
                fail(f"blur_sep {shape}: {kernels.blur_sep.launches - before} launches, expected 2")
            errs = []
            for j, (g, w) in enumerate(zip(got, want)):
                err, scale = max_err(g, w)
                tol = (KERNEL_RTOL if j == 0 else GRAD_RTOL)[dtype] * max(1.0, scale)
                if not (err <= tol and bool(torch.isfinite(g).all())):
                    fail(f"blur_sep direct variant {shape} {rt} {pad} offset {offset} {dtype}: "
                         f"output {j} disagrees with the plain version: {err} > {tol}")
                errs.append(err)
            log(f"blur_sep direct variant {list(shape)} taps {len(rt)} pad {pad} offset {offset} "
                f"{str(dtype)[6:]} (lanes {lanes}, rows {rows}): errors fwd {errs[0]:.3g} bwd {errs[1]:.3g}")


def hair_mask_check(card_logit: torch.Tensor, cpu_logit: torch.Tensor, label: str) -> None:
    """The hair net's mask logits on the card and the CPU agree to
    HAIR_LOGIT_RTOL of max|logit|, and a pixel whose mask differs has its
    logit that close to the threshold."""
    from gan_control_torch.losses.predictors.hair_pspnet import HairPSPNet

    card_logit, cpu_logit = card_logit.float().cpu(), cpu_logit.float().cpu()
    flipped = HairPSPNet.mask_from_logit(card_logit, torch.float32) != \
        HairPSPNet.mask_from_logit(cpu_logit, torch.float32)
    scale = float(cpu_logit.abs().max())
    err = float((card_logit - cpu_logit).abs().max())
    worst = float(cpu_logit[flipped].abs().max()) if bool(flipped.any()) else 0.0
    tol = HAIR_LOGIT_RTOL * scale
    log(f"{label}: hair mask logits max_abs_err {err:.3g} (max|logit| {scale:.3g}, tol {tol:.3g}); "
        f"{int(flipped.sum())} of {flipped.numel()} mask pixels flipped, largest |logit| among them "
        f"{worst:.3g}; hair pixels "
        f"{100 * float(HairPSPNet.mask_from_logit(cpu_logit, torch.float32).mean()):.1f}%")
    if err > tol or worst > tol:
        fail(f"{label}: the hair mask logits disagree, or a pixel flipped away from the threshold")


def features_and_grad(module, images: torch.Tensor, proj_seed: int, logit=None):
    """A predictor's layers on ``images`` and the image gradient of a seeded
    projection of them, on the CPU; with ``logit`` the hair net's mask is
    that logit's, not its own."""
    x = images.detach().clone().requires_grad_(True)
    if logit is None:
        feats = module(x)
    else:
        xr = module.resize_input(x)
        feats = [module.masked_feature(xr, module.mask_from_logit(logit.to(x.device), x.dtype))]
    gen = torch.Generator().manual_seed(proj_seed)
    projs = [torch.randn(f.shape, generator=gen).to(x.device) for f in feats]
    (grad,) = torch.autograd.grad(sum((f.float() * p).sum() for f, p in zip(feats, projs)), x)
    return [f.detach().float().cpu() for f in feats], grad.float().cpu()


def predictor_card_vs_cpu(name: str, cpu_module, images: torch.Tensor, seed: int) -> dict:
    """One predictor on the card and on the CPU, f32, TF32 off, from the
    same weights and images: every returned layer to PREDICTOR_RTOL of its
    largest entry, the image gradient to PREDICTOR_GRAD_REL_L2 in relative
    L2 norm; the hair net's mask checked by ``hair_mask_check`` and then
    taken from the CPU on both sides. Returns the errors."""
    card_module = copy.deepcopy(cpu_module).to("cuda")
    logit = None
    if hasattr(cpu_module, "mask_logit"):
        with torch.no_grad():
            logit = cpu_module.mask_logit(cpu_module.resize_input(images))
            card_logit = card_module.mask_logit(card_module.resize_input(images.cuda()))
        hair_mask_check(card_logit, logit, f"predictor {name}")
    want_f, want_g = features_and_grad(cpu_module, images, seed, logit)
    got_f, got_g = features_and_grad(card_module, images.cuda(), seed, logit)
    del card_module
    layer_errs = [max_err(g, w)[0] / max(max_err(g, w)[1], 1e-12) for g, w in zip(got_f, want_f)]
    grad_rel = float((got_g - want_g).norm() / want_g.norm())
    grad_max = float((got_g - want_g).abs().max() / want_g.abs().max())
    log(f"predictor {name} card vs cpu: batch {images.shape[0]} f32 TF32 off, "
        f"{[tuple(f.shape) for f in want_f]}: layer errors / max|layer| "
        f"{[f'{e:.2e}' for e in layer_errs]} (tol {PREDICTOR_RTOL}); image gradient relative L2 "
        f"{grad_rel:.2e} (tol {PREDICTOR_GRAD_REL_L2}), largest entry error / max {grad_max:.2e}")
    finite = all(bool(torch.isfinite(f).all()) for f in got_f) and bool(torch.isfinite(got_g).all())
    if not finite or max(layer_errs) > PREDICTOR_RTOL or grad_rel > PREDICTOR_GRAD_REL_L2:
        fail(f"predictor {name}: card and CPU disagree")
    return {"layers": max(layer_errs), "grad_rel_l2": grad_rel, "grad_max": grad_max}


def train_card_vs_cpu() -> tuple[dict, list, dict]:
    """Phase 9: iteration 0 of a size-32 model (max_channels 64, batch 16 in
    the config's 7-group arrangement, f32, TF32 off) on the card and on the
    CPU from the same parameters and explicit random inputs: each step
    kind's losses and gradients, each step from the same initial state;
    and ``g_step`` again with the config's six-loss battery (f32,
    batch-norm statistics set from this G's images), its G gradients held
    to BATTERY_PARITY_RTOL. Before it, each of the battery's
    six nets on its own (``predictor_card_vs_cpu``) on two of those images
    resized to 512 px. Returns 24d's inputs: the size-32 set-up (as
    ``predictor_precision_probe.size32_setup`` gives it), the battery's
    specs and the calibrated f32 battery."""
    from gan_control_torch.losses.registry import build_attr_losses, calibrate_battery, distinct_predictors
    from gan_control_torch.models.factory import build_discriminator, build_generator, build_group_spec
    from gan_control_torch.training import train_step as ts
    from gan_control_torch.training.state import init_gan_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["model_config"].update(size=32, max_channels=64, mixed_precision=False)
    tc = config["training_config"]
    spec = build_group_spec(config)
    cfg = ts.TrainStepConfig(batch=tc["batch"], mini_batch=tc["mini_batch"])
    rng = np.random.default_rng(5)
    b = tc["batch"]
    z = torch.from_numpy(rng.standard_normal((b, 512)).astype(np.float32))
    real = torch.from_numpy(rng.standard_normal((b, 32, 32, 3)).astype(np.float32) * 0.5)
    g0 = build_generator(config, spec, device="cpu", seed=0)
    noise = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in g0.noise_shapes(b)]
    path_noise = torch.from_numpy(rng.standard_normal((b // 2, 32, 32, 3)).astype(np.float32))
    d0 = build_discriminator(config, device="cpu", seed=1)
    with torch.no_grad():
        for m in g0.modules():  # non-zero noise weights, so the injection counts
            if type(m).__name__ == "NoiseInjection":
                m.weight.fill_(0.3)

    # the battery: f32, its batch-norm statistics from this G's images; the
    # in-training battery falls back to TF32 on the card, so ask for "highest"
    specs, cpu_preds = build_attr_losses({**tc, "predictor_precision": "highest"}, device="cpu", seed=3)
    with torch.no_grad():
        img, _ = ts._gen_images(init_gan_state(copy.deepcopy(g0), copy.deepcopy(d0), tc), cfg, spec,
                                (z,), noise, None, arrange=True)
        img512 = F.interpolate(img.permute(0, 3, 1, 2), size=(512, 512), mode="bilinear",
                               align_corners=False).permute(0, 2, 3, 1).contiguous()
    calibrate_battery(cpu_preds, img512[:4])
    with Phase("predictors card vs cpu"):
        for i, (name, m) in enumerate(distinct_predictors(cpu_preds).items()):
            predictor_card_vs_cpu(name, m, img512[:PREDICTOR_BATCH], 300 + i)
    card_nets = {id(m): copy.deepcopy(m).to("cuda") for m in distinct_predictors(cpu_preds).values()}
    preds = {"cpu": cpu_preds, "cuda": {n: card_nets[id(m)] for n, m in cpu_preds.items()}}
    hair = {dev: p["hair_loss"] for dev, p in preds.items()}
    hair_logits: dict[str, torch.Tensor] = {}

    def use_cpu_mask(dev: str):
        """The hair net's mask logit on ``dev``: recorded on the CPU; on the
        card computed, kept for the check, and replaced by the CPU's."""
        own = type(hair[dev]).mask_logit.__get__(hair[dev])

        def mask_logit(x):
            out = own(x)
            hair_logits.setdefault(dev, out.detach().cpu())
            return out if dev == "cpu" else hair_logits["cpu"].to(out.device)
        hair[dev].mask_logit = mask_logit

    def steps_on(dev: str) -> dict:
        def mv(t):
            return t.to(dev)

        use_cpu_mask(dev)
        runs = {
            "d_step": lambda st: ts.d_step(st, cfg, spec, mv(real), (mv(z),), noise=[mv(n) for n in noise]),
            "d_reg_step": lambda st: ts.d_reg_step(st, cfg, mv(real)),
            "g_step": lambda st: ts.g_step(st, cfg, spec, (mv(z),), noise=[mv(n) for n in noise]),
            "g_step with the battery": lambda st: ts.g_step(
                st, cfg, spec, (mv(z),), noise=[mv(n) for n in noise], attr_losses=specs,
                predictors=preds[dev]),
            "g_reg_step": lambda st: ts.g_reg_step(
                st, cfg, (mv(z[: b // 2]),), noise=[mv(n[: b // 2]) for n in noise],
                path_noise=mv(path_noise)),
        }
        out = {}
        for kind, run in runs.items():
            st = init_gan_state(copy.deepcopy(g0).to(dev), copy.deepcopy(d0).to(dev), tc)
            metrics = {k: float(v) for k, v in run(st).items()}
            grads = {f"{p}.{n}": t.grad.detach().cpu() for p, mod in (("G", st.generator),
                                                                     ("D", st.discriminator))
                     for n, t in mod.named_parameters() if t.grad is not None}
            out[kind] = (metrics, grads)
        return out

    cpu, card = steps_on("cpu"), steps_on("cuda")
    hair_mask_check(hair_logits["cuda"], hair_logits["cpu"], "train card vs cpu g_step")
    for n, m in preds["cuda"].items():
        if any(p.grad is not None for p in m.parameters()):
            fail(f"g_step gave predictor {n} a gradient")
    for kind in cpu:
        (mc, gc), (mg, gg) = cpu[kind], card[kind]
        if mc.keys() != mg.keys() or gc.keys() != gg.keys():
            fail(f"{kind}: card and CPU return other metrics or gradients")
        loss_err = max(abs(mc[k] - mg[k]) / max(1.0, abs(mc[k])) for k in mc)
        worst, worst_name = worst_grad_err(gc, gg)
        tol = BATTERY_PARITY_RTOL if "battery" in kind else TRAIN_PARITY_RTOL
        log(f"train card vs cpu: {kind} losses {mc} (card {mg}), worst loss rel err {loss_err:.3g} "
            f"(tol {TRAIN_PARITY_RTOL}); {len(gc)} gradients, worst rel err {worst:.3g} ({worst_name}), "
            f"tol {tol}")
        if loss_err > TRAIN_PARITY_RTOL or worst > tol:
            fail(f"{kind}: card and CPU disagree")
    return ({"tc": tc, "spec": spec, "cfg": cfg, "g0": g0, "d0": d0, "z": z, "noise": noise, "img": img},
            specs, cpu_preds)


# ---------------------------------------------------------------------------
# phase 2: the attribute sweep and controller training (this slice)
# ---------------------------------------------------------------------------

SWEEP_BATCH = 40
SWEEP_ROWS = 640  # cut from 1280 for phase 25 (PERF.md §4)
CTRL_ITERS = 100  # cut from 200 for phase 25 (PERF.md §4)
CTRL_CHECK_INTERVAL = 50  # min_evaluate_interval and save_nets_interval of phase 11
ATTR_STEPS = 5
REMAT_CHECK_BATCH = 16
PARITY_CTRL_BATCH = 8
# the JAX sweep's columns (latents, latents_w, the five one-net columns,
# the R-Net's three) and each row's shape
SWEEP_COLUMNS = {"latents": (512,), "latents_w": (512,), "orientation": (3,), "age": (),
                 "expression_q": (), "hair": (3,), "arcface_emb": (512,), "gamma3d": (27,),
                 "expression3d": (64,), "orientation3d": (3,)}
# the sweep's latents_w against the port's mapping of its latents: the same
# f32 mapping in another process, relative to max|w| (the synthesis that
# follows it is bf16; the mapping is not)
LATENT_RTOL = 1e-3
# the head's gradients with and without rematerialisation: the same f32
# operations recomputed (TF32 off); only the order of the float atomics in
# the predictor's resize backward differs between two runs
REMAT_RTOL = 1e-5


def start_cli(module: str, args: list[str], log_path: Path) -> tuple:
    """``python -m module args`` started, its output going to ``log_path``."""
    f = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, "-m", module, *args], stdout=f, stderr=subprocess.STDOUT, cwd=REPO)
    return module, proc, f, log_path


def finish_cli(started: tuple, timeout: float) -> list[str]:
    """Waits for a :func:`start_cli` process; its last lines printed and the
    script failed when it does not exit 0. Returns its lines."""
    module, proc, f, log_path = started
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"{module} did not exit within {timeout} s")
    finally:
        f.close()
    lines = log_path.read_text().splitlines()
    if proc.returncode != 0:
        fail(f"{module} exited {proc.returncode}; last lines:\n" + "\n".join(lines[-30:]))
    return lines


def run_cli(module: str, args: list[str], log_path: Path, timeout: float) -> list[str]:
    """``python -m module args`` with its output in ``log_path``, to its end
    (see :func:`finish_cli`)."""
    return finish_cli(start_cli(module, args, log_path), timeout)


def launches_of(fn, seen: Counter) -> dict:
    """Kernel launches of one call of ``fn`` (counters set to 0 just before,
    read just after), its launches recorded by shape in ``seen``."""
    from gan_control_torch.ops import kernels

    remove = install_launch_recorder(seen)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return kernels.launch_counts()
    finally:
        remove()


def add_counts(total: dict, counts: dict) -> None:
    for n, c in counts.items():
        total[n] += c


def synced_ms(fn, reps: int) -> list[float]:
    """Host ms of each of ``reps`` calls of ``fn``, each from a synced device
    to a synced device."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def sweep_phase(root: Path, seen: Counter, counts: dict) -> Path:
    """Phase 10: the phase-2a sweep through its command line on an FFHQ-512
    phase-1 directory at random init; the table against the JAX columns and
    the port's mapping; one batch in-process: launches, and the split of
    its time between synthesis and the six predictors. Returns the table."""
    from gan_control_torch.data.dataframe import read_table
    from gan_control_torch.inference.extract_controls import ControlExtractor
    from gan_control_torch.inference.inference import Inference

    with Phase("sweep write"):
        write_controller_dir(root / "controller")  # phase 3's writer: G and two heads
    model_dir = root / "controller" / "generator"
    table_path = root.parent / "attributes.npz"
    with Phase("sweep command line"):
        t0 = time.perf_counter()
        lines = run_cli("gan_control_torch.make_attributes_df",
                        ["--model_dir", str(model_dir), "--batch_size", str(SWEEP_BATCH),
                         "--number_of_samples", str(SWEEP_ROWS), "--save_path", str(table_path)],
                        root.parent / "make_attributes_df.log", 900)
        wall = time.perf_counter() - t0
        m = re.search(r"swept (\d+) rows in ([\d.]+) s \(([\d.]+) rows/s", "\n".join(lines))
        if not m:
            fail("make_attributes_df logged no sweep line")
        rate = float(m[3])
        log(f"sweep: make_attributes_df --batch_size {SWEEP_BATCH} --number_of_samples {SWEEP_ROWS}: "
            f"{m[1]} rows in {m[2]} s = {rate:.2f} rows/s (its loop, writes included; the command "
            f"{wall:.1f} s with start-up); 100000 rows at that rate {100000 / rate / 60:.1f} min")

    with Phase("sweep table"):
        table = read_table(table_path)
        if list(table) != list(SWEEP_COLUMNS):
            fail(f"sweep columns {list(table)}, expected {list(SWEEP_COLUMNS)}")
        for name, shape in SWEEP_COLUMNS.items():
            col = table[name]
            if col.shape != (SWEEP_ROWS, *shape) or not np.isfinite(col).all():
                fail(f"sweep column {name}: shape {col.shape} (expected {(SWEEP_ROWS, *shape)}) or not finite")
        q = table["expression_q"]
        if not (np.all(q == np.round(q)) and q.min() >= 0 and q.max() < 8):
            fail("expression_q is not a class index")
        torch.backends.cuda.matmul.allow_tf32 = False
        inf = Inference(model_dir, device="cuda")
        with torch.no_grad():
            w = inf.model.map_latent(torch.from_numpy(table["latents"]).cuda()).cpu().numpy()
        err = float(np.abs(w - table["latents_w"]).max())
        tol = LATENT_RTOL * max(1.0, float(np.abs(w).max()))
        log(f"sweep table: {SWEEP_ROWS} rows, columns {list(table)}, every value finite; latents_w against "
            f"the port's mapping of latents max_abs_err {err:.3g} (tol {tol:.3g}); "
            + ", ".join(f"{k} mean {table[k].mean():.4g} std {table[k].std():.4g}"
                        for k in ("age", "expression_q", "orientation", "hair")))
        if err > tol:
            fail("latents_w is not the mapping of latents")

    with Phase("sweep batch"):
        extractor = ControlExtractor(inf.config["training_config"], device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)

        def batch():
            z = torch.randn((SWEEP_BATCH, 512), generator=gen, device="cuda")
            img, _, _ = inf.gen_batch(batch_size=SWEEP_BATCH, normalize=False, latent=z, generator=gen)
            return extractor.extract_tensors(img)

        batch()
        got = launches_of(batch, seen)
        n_map, n_conv, n_up = g_counts(inf.model)
        want = row(n_map + n_conv, 0, n_up, 0)
        log(f"sweep batch: launches {got}, expected {want} (mapping {n_map}, StyledConvs {n_conv}, "
            f"ToRGB skips {n_up}; the predictors launch none of the port's kernels); the command line "
            f"ran {SWEEP_ROWS // SWEEP_BATCH} such batches")
        if got != want:
            fail("sweep batch launches differ from the derived counts")
        add_counts(counts, got)

        def split():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 + len(extractor._fns))]
            ev[0].record()
            z = torch.randn((SWEEP_BATCH, 512), generator=gen, device="cuda")
            img, _, _ = inf.gen_batch(batch_size=SWEEP_BATCH, normalize=False, latent=z, generator=gen)
            ev[1].record()
            with torch.no_grad():
                for i, fn in enumerate(extractor._fns.values()):
                    fn(img)
                    ev[2 + i].record()
            return ev

        spans = event_ms(split)
        med = statistics.median(synced_ms(batch, BATTERY_REPS))
        log(f"sweep batch {SWEEP_BATCH} (CUDA events, median of {BATTERY_REPS}): synthesis (z, mapping, bf16 "
            f"512 px) {spans[0]:.2f} ms; predictors (f32) "
            + ", ".join(f"{k} {t:.2f} ms" for k, t in zip(extractor._fns, spans[1:]))
            + f"; predictors together {sum(spans[1:]):.2f} ms = {100 * sum(spans[1:]) / sum(spans):.1f}%; "
            f"host clock per synced batch median {med:.2f} ms = {SWEEP_BATCH / med * 1e3:.2f} rows/s")
    del extractor, inf
    torch.cuda.empty_cache()
    return table_path


def controller_config(model_dir: Path, table_path: Path, results_dir: Path) -> dict:
    """configs/controller_configs/ffhq/age_controller.json with its paths
    under build/ and evaluations and saves every CTRL_CHECK_INTERVAL."""
    cfg = json.loads((CONFIGS / "controller_configs" / "ffhq" / "age_controller.json").read_text())
    cfg["results_dir"] = str(results_dir)
    cfg["training_config"].update(generator_dir=str(model_dir), sampled_df_path=str(table_path),
                                  min_evaluate_interval=CTRL_CHECK_INTERVAL,
                                  save_nets_interval=CTRL_CHECK_INTERVAL)
    return cfg


def latent_rec_phase(root: Path, table_path: Path, seen: Counter, counts: dict) -> Path:
    """Phase 11: the age head trained by ``python -m
    gan_control_torch.train_controller --iters 100`` on the sweep's table
    (latent_rec); finite metrics, checkpoints and dual grids; launches per
    step in-process against the derived count and the step's time. Returns
    the head's directory."""
    from gan_control_torch.trainers.controller_trainer import ControllerTrainer

    cfg = controller_config(root / "controller" / "generator", table_path, root / "controllers")
    cfg_path = root / "age_controller.json"
    cfg_path.write_text(json.dumps(cfg, indent=2))
    with Phase("controller command line"):
        lines = run_cli("gan_control_torch.train_controller",
                        ["--config_path", str(cfg_path), "--iters", str(CTRL_ITERS)],
                        root.parent / "train_controller.log", 900)
        heads = sorted((root / "controllers").glob("age_*"))
        if len(heads) != 1:
            fail(f"expected one age head directory, found {heads}")
        head = heads[0]
        history = []
        for ln in lines:
            m = re.search(r"controller iter (\d+): (\{.*\})", ln)
            if m:
                vals = {k: float(v) for k, v in re.findall(r"'(\w+)': ([-\w.+]+)", m[2])}
                if not all(math.isfinite(v) for v in vals.values()):
                    fail(f"controller metrics not finite: {m[2]}")
                history.append(vals)
        want_ckpts = [f"{i:06d}.ckpt" for i in range(CTRL_CHECK_INTERVAL, CTRL_ITERS + 1, CTRL_CHECK_INTERVAL)]
        ckpts = sorted(p.name for p in (head / "checkpoint").glob("*.ckpt"))
        grids = sorted(p.name for p in (head / "images" / "sample").glob("*.png"))
        want_grids = [f"{i:06d}.png" for i in range(0, CTRL_ITERS, CTRL_CHECK_INTERVAL)]
        if [int(h["iter"]) for h in history] != list(range(0, CTRL_ITERS, CTRL_CHECK_INTERVAL)) \
                or ckpts != want_ckpts or grids != want_grids \
                or not (head / "generator" / "args.json").exists():
            fail(f"controller run: metrics at {[h.get('iter') for h in history]}, checkpoints {ckpts}, "
                 f"grids {grids}")
        med = float(re.search(r"median ([\d.]+) ms per iteration", "\n".join(lines))[1])
        log(f"controller command line: {head.name}, latent_rec, batch {cfg['training_config']['batch']}; "
            f"metrics {history}; checkpoints {ckpts}; dual grids {grids}; median {med:.4f} ms per "
            f"iteration (host clock, no sync); the config's {cfg['training_config']['iter']} iterations at "
            f"that rate {cfg['training_config']['iter'] * med / 3.6e6:.2f} h")

    with Phase("controller latent_rec steps"):
        tr = ControllerTrainer(config=cfg, init_dirs=False, device="cuda")
        n_head = tr.controller.n_mlp
        want = row(n_head, n_head, 0, 0)
        tr.train_step(*next(tr.loader))
        for _ in range(3):
            got = launches_of(lambda: tr.train_step(*next(tr.loader)), seen)
            if got != want:
                fail(f"latent_rec step launches {got}, expected {want}")
            add_counts(counts, got)
        times = synced_ms(lambda: tr.train_step(*next(tr.loader)), 20)
        log(f"controller latent_rec step: launches {want} per step (the head's {n_head} layers forward and "
            f"backward); median {statistics.median(times):.3f} ms between syncs, the loader's batch included "
            f"({[round(t, 3) for t in times]})")
    return head


def attribute_rec_phase(root: Path, table_path: Path, seen: Counter, counts: dict) -> None:
    """Phase 12: latent_rec + attribute_rec (weight 0.01) at batch 128
    through the rematerialised bf16 G and DEX (f32, random init): five
    steps and one evaluation with launches against the derived counts, ms,
    peak memory; then, at a batch that fits without rematerialisation, the
    head's gradients with and without it on the same noise (G in f32,
    TF32 off)."""
    from gan_control_torch.trainers.controller_trainer import ControllerTrainer

    cfg = controller_config(root / "controller" / "generator", table_path, root / "controllers")
    cfg["training_config"].update(losses=["latent_rec", "attribute_rec"], attribute_rec_w=0.01)
    torch.backends.cudnn.allow_tf32 = True  # the defaults: the synthesis is bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    with Phase("controller attribute_rec steps"):
        tr = ControllerTrainer(config=cfg, init_dirs=False, device="cuda")
        g = tr.generator
        n_map, n_conv, n_up = g_counts(g)
        n_head, n_remat = tr.controller.n_mlp, len(g.convs)
        # the head forward and backward; each StyledConv forward, again in
        # the backward for the rematerialised ones (every conv after conv1),
        # and its gradient; each ToRGB skip up, and down in the backward
        want = row(n_head + n_conv + n_remat, n_head + n_conv, n_up, n_up)
        log(f"controller attribute_rec: G synthesis {g.dtype}, remat {g.remat}, predictor "
            f"{type(tr.predictor).__name__} {next(tr.predictor.parameters()).dtype}, batch "
            f"{cfg['training_config']['batch']}; expected launches per step {want}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, history = [], []
        for _ in range(ATTR_STEPS):
            batch = next(tr.loader)
            t0 = time.perf_counter()
            got = launches_of(lambda: history.append(tr.train_step(*batch)), seen)
            times.append((time.perf_counter() - t0) * 1e3)
            if got != want:
                fail(f"attribute_rec step launches {got}, expected {want}")
            add_counts(counts, got)
        peak = torch.cuda.max_memory_allocated() / 2**30
        metrics = [{k: float(v) for k, v in h.items()} for h in history]
        if not all(math.isfinite(v) for h in metrics for v in h.values()):
            fail(f"attribute_rec metrics not finite: {metrics}")
        log(f"controller attribute_rec step: median {statistics.median(times[1:]):.2f} ms between syncs "
            f"over steps 2-{ATTR_STEPS} ({[round(t, 2) for t in times]}); peak memory {peak:.2f} GiB; "
            f"launches as derived; metrics {metrics}")
        n_eval = 5 if cfg["training_config"].get("debug") else 25
        result = {}
        t0 = time.perf_counter()
        got = launches_of(lambda: result.update(tr.evaluate()), seen)
        eval_ms = (time.perf_counter() - t0) * 1e3
        want_eval = row(n_eval * (n_head + n_conv), 0, n_eval * n_up, 0)
        log(f"controller evaluation: {result}, {n_eval} batches of {min(50, len(tr.eval_dataset))} "
            f"in {eval_ms:.1f} ms; launches {got}, expected {want_eval}")
        if got != want_eval or not all(math.isfinite(v) for v in result.values()):
            fail("the evaluation's launches or metrics are wrong")
        add_counts(counts, got)

    with Phase("controller remat against plain"):
        torch.backends.cudnn.allow_tf32 = False
        g.dtype = torch.float32
        controls, w = (a[:REMAT_CHECK_BATCH] for a in next(tr.loader))
        noise = g.draw_noise(len(controls), torch.Generator(device="cuda").manual_seed(5), "cuda")
        start = copy.deepcopy(tr.controller.state_dict())
        grads, peaks = {}, {}
        for remat in (True, False):
            tr.controller.load_state_dict(start)
            g.remat = remat
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tr.train_step(controls, w, noise=noise)
            torch.cuda.synchronize()
            peaks[remat] = torch.cuda.max_memory_allocated() / 2**30
            grads[remat] = {n: p.grad.detach().clone() for n, p in tr.controller.named_parameters()}
        worst = max(float((grads[True][n] - grads[False][n]).abs().max())
                    / max(float(grads[False][n].abs().max()), 1e-30) for n in grads[False])
        log(f"controller remat against plain: batch {len(controls)}, G f32, TF32 off, the same noise: "
            f"head gradients worst rel err {worst:.3g} (tol {REMAT_RTOL}); peak memory {peaks[True]:.2f} "
            f"GiB with remat, {peaks[False]:.2f} without")
        if worst > REMAT_RTOL:
            fail("the rematerialised G gives other gradients")
    del tr, g
    torch.cuda.empty_cache()


def two_heads_phase(root: Path, age_head: Path) -> None:
    """Phase 13: the trained age head and phase 3's orientation head in one
    controller directory, through ``Controller``: each head's output lands
    in its group's slice of w."""
    import shutil

    from gan_control_torch.inference.controller import Controller

    with Phase("controller two heads"):
        cdir = root / "two_heads"
        shutil.copytree(root / "controller" / "generator", cdir / "generator")
        (orientation,) = (root / "controller").glob("orientation_*")
        shutil.copytree(orientation, cdir / orientation.name)
        shutil.copytree(age_head, cdir / age_head.name, ignore=shutil.ignore_patterns("generator"))
        ctrl = Controller(cdir, device="cuda")
        if sorted(ctrl.fc_controls) != ["age", "orientation"]:
            fail(f"heads {sorted(ctrl.fc_controls)}")
        ctl = controls(BATCH, 6)
        z = np.random.default_rng(7).standard_normal((BATCH, 512)).astype(np.float32)
        img, _, latent_w = ctrl.gen_batch_by_controls(batch_size=BATCH, latent=z, **ctl)
        torch.cuda.synchronize()
        errs = {}
        for group, value in ctl.items():
            grp = ctrl.spec.group(group)
            with torch.no_grad():
                want = ctrl.generate_group_w_latent(group, value)
            errs[group] = float((latent_w[:, grp.latent_start:grp.latent_end] - want).abs().max())
        log(f"controller two heads: {sorted(ctrl.fc_controls)} from {sorted(p.name for p in cdir.iterdir())}; "
            f"each head's output against its slice of w: max_abs_err {errs}; images {tuple(img.shape)}")
        if any(e != 0.0 for e in errs.values()) or tuple(img.shape) != (BATCH, 512, 512, 3) \
                or not bool(torch.isfinite(img).all()):
            fail("a head's output is not its slice of w, or the images are wrong")
        del ctrl, img


def controller_card_vs_cpu(root: Path) -> None:
    """Phase 14: one controller step of a size-32 model (max_channels 64,
    f32, TF32 off, the predictor at "highest") on the card and on the CPU
    from the same parameters, batch and noise: with latent_rec each head
    gradient to TRAIN_PARITY_RTOL of its largest entry; with attribute_rec
    (DEX at random init, f32) to BATTERY_PARITY_RTOL."""
    from gan_control_torch.data.dataframe import write_table
    from gan_control_torch.models.factory import build_generator, build_group_spec
    from gan_control_torch.trainers.controller_trainer import ControllerTrainer
    from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["model_config"].update(size=32, max_channels=64, mixed_precision=False)
    config["training_config"]["predictor_precision"] = "highest"
    gdir = root / "size32" / "generator"
    gdir.mkdir(parents=True)
    (gdir / "args.json").write_text(json.dumps(config))
    gen = build_generator(config, build_group_spec(config), device="cpu", seed=0)
    with torch.no_grad():
        for m in gen.modules():  # non-zero noise weights, so the injection counts
            if type(m).__name__ == "NoiseInjection":
                m.weight.fill_(0.3)
    save_flax_checkpoint(gdir / "checkpoint", "g_ema", gen)
    rng = np.random.default_rng(8)
    table = root / "size32" / "attributes.npz"
    write_table(table, {"latents_w": rng.standard_normal((40, 512)).astype(np.float32),
                        "age": rng.uniform(15, 75, 40)})
    controls_, w = rng.uniform(15, 75, (PARITY_CTRL_BATCH, 1)).astype(np.float32), \
        rng.standard_normal((PARITY_CTRL_BATCH, 512)).astype(np.float32)
    noise = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in gen.noise_shapes(PARITY_CTRL_BATCH)]
    for losses, tol in ((["latent_rec"], TRAIN_PARITY_RTOL), (["latent_rec", "attribute_rec"], BATTERY_PARITY_RTOL)):
        cfg = controller_config(gdir, table, root / "size32" / "controllers")
        cfg["training_config"].update(losses=losses, batch=PARITY_CTRL_BATCH)
        out = {}
        for dev in ("cpu", "cuda"):
            tr = ControllerTrainer(config=cfg, init_dirs=False, device=dev)
            m = tr.train_step(controls_, w, noise=[n.to(dev) for n in noise])
            out[dev] = ({k: float(v) for k, v in m.items()},
                        {n: p.grad.detach().cpu() for n, p in tr.controller.named_parameters()})
            del tr
        (mc, gc), (mg, gg) = out["cpu"], out["cuda"]
        loss_err = max(abs(mc[k] - mg[k]) / max(1.0, abs(mc[k])) for k in mc)
        worst, worst_name = worst_grad_err(gc, gg, floor=1e-30)
        log(f"controller card vs cpu: {'+'.join(losses)} batch {PARITY_CTRL_BATCH} size 32 f32: losses {mc} "
            f"(card {mg}), worst loss rel err {loss_err:.3g} (tol {TRAIN_PARITY_RTOL}); head gradients worst "
            f"rel err {worst:.3g} ({worst_name}), tol {tol}")
        if loss_err > TRAIN_PARITY_RTOL or worst > tol:
            fail(f"controller step {losses}: card and CPU disagree")


def phase2(build_root: Path) -> tuple[Counter, dict]:
    """Phases 10-14. Returns the launches recorded on the phase-2 paths by
    (kernel, shape, dtype, static args) and their counts: the sweep's (the
    in-process batch's times the command line's batches), the latent_rec
    and attribute_rec steps' and the evaluation's."""
    import shutil

    root = build_root / "phase2"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    seen: Counter = Counter()
    counts: dict = {n: 0 for n in KERNELS}
    table = sweep_phase(root, seen, counts)
    head = latent_rec_phase(root, table, seen, counts)
    attribute_rec_phase(root, table, seen, counts)
    two_heads_phase(root, head)
    with Phase("controller card vs cpu"):
        controller_card_vs_cpu(root)
    missing = [n for n in ("fused_bias_act", "fused_bias_act_grad", "blur2x_up", "blur2x_down") if not counts[n]]
    if missing:
        fail(f"phase 2 launched no {missing}")
    return seen, counts


# ---------------------------------------------------------------------------
# serving (this slice)
# ---------------------------------------------------------------------------

SERVE_BUCKETS = (1, 4, 16, 64)
SERVE_SIZES = (1, 3, 16, 64)  # 3 pads to bucket 4
SERVE_REQUESTS = 20
EXPORT_BUCKET = 4


def replay_ms(graph, reps: int = 10) -> float:
    """Device time of one replay of a captured request graph (CUDA events
    around ``reps`` back-to-back replays, after one warm replay)."""
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def stats_text(s: dict) -> str:
    return f"p50 {s['p50_ms']:.3f} ms p90 {s['p90_ms']:.3f} ms (min {s['min_ms']:.3f}, {s['requests']} requests)"


def held_to(label: str, got: np.ndarray, want: np.ndarray, rtol: float) -> None:
    """Prints whether two image arrays are bitwise equal, else their
    largest difference, and fails beyond ``rtol`` of max|want|."""
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    tol = rtol * max(1.0, float(np.abs(want).max()))
    log(f"{label}: " + ("bitwise equal" if np.array_equal(got, want) else
                        f"max_abs_err {err:.3g} (tol {tol:.3g})"))
    if not (err <= tol and np.isfinite(got).all()):
        fail(f"{label}: {err} > {tol}")


def serving_phase(build_root: Path) -> tuple[Counter, dict, Counter]:
    """Phase 15. Returns the launches recorded on the serving path (warmup's
    captures and the requests, by kernel, shape, dtype and static args), the
    counters read after it, and the launches of the f32 card-vs-CPU check."""
    import shutil

    from gan_control_torch.inference.exported import load_exported_serving
    from gan_control_torch.inference.row_noise import row_noise
    from gan_control_torch.inference.serving import ServingController
    from gan_control_torch.models.blocks import EqualLinear
    from gan_control_torch.ops import kernels
    from gan_control_torch.tools.serving_bench import ab_latency, request_latency

    root = build_root / "serving"
    if root.exists():
        shutil.rmtree(root)
    ctrl_dir = root / "ffhq_controller"
    with Phase("serving load"):
        write_controller_dir(ctrl_dir)  # phase 3's writer: G and the orientation and age heads
        torch.backends.cudnn.allow_tf32 = True  # the defaults; synthesis is bf16
        torch.backends.cuda.matmul.allow_tf32 = False
        serve = ServingController(ctrl_dir, buckets=SERVE_BUCKETS)
        n_map, n_conv, n_up = g_counts(serve.model)
        n_head = sum(isinstance(m, EqualLinear) and m.activation == "fused_lrelu"
                     for fc in serve.fc_controls.values() for m in fc.modules())
        want = {"fused_bias_act": n_map + n_head + n_conv, "blur2x_up": n_up}
        log(f"serving: synthesis {serve.model.dtype}, heads {sorted(serve.fc_controls)}, buckets "
            f"{serve.buckets}; launches per request derived from the modules {want}")
        if want != {"fused_bias_act": 56 + 2 * 4 + 15, "blur2x_up": 7}:
            fail(f"derived serving launches {want}, phase 5 derives 79 and 7")

    seen: Counter = Counter()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    remove = install_launch_recorder(seen)
    try:
        with Phase("serving warmup"):
            torch.cuda.empty_cache()
            reserved0, allocated0 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            serve.warmup()
            peak = torch.cuda.max_memory_allocated() - allocated0
            torch.cuda.empty_cache()
            held = torch.cuda.memory_reserved() - reserved0
            for key, entry in sorted(serve._serve_cache.items(), key=lambda kv: kv[0][4]):
                got = {k: v for k, v in entry.launches.items() if v}
                log(f"serving capture bucket {key[4]} groups {[g for g, _ in key[0]]}: "
                    f"{entry.capture_seconds:.3f} s (eager warm-up, capture), launches {got}")
                if got != want:
                    fail(f"capture at bucket {key[4]} launched {got}, derived {want}")
            log(f"serving memory: peak {peak / 2**30:.3f} GiB allocated during warmup (the eager "
                f"warm-ups included); {held / 2**30:.3f} GiB held after it by the shared graph pool "
                f"and the static buffers")
            ctl64 = controls(64, 30)
            z64 = np.random.default_rng(31).standard_normal((64, 512)).astype(np.float32)
            u8 = {n: request_latency(lambda n=n: serve.generate(
                latent=z64[:n], output="uint8", **{g: v[:n] for g, v in ctl64.items()})[0],
                SERVE_REQUESTS) for n in SERVE_BUCKETS[-2:]}
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        remove()
    log(f"serving main path (warmup, uint8 requests): launches {counts}")

    with Phase("serving latency"):
        p50 = {("uint8", serve.bucket_for(n)): (n, s["p50_ms"]) for n, s in u8.items()}
        for n in SERVE_SIZES:
            res = ab_latency(serve, n, SERVE_REQUESTS, {g: v[:n] for g, v in ctl64.items()},
                             latent=z64[:n])
            p50[("float32", serve.bucket_for(n))] = (n, res["generate"]["p50_ms"])
            log(f"serving latency n {n} (bucket {serve.bucket_for(n)}): generate "
                f"{stats_text(res['generate'])}; gen_batch_by_controls + .cpu() "
                f"{stats_text(res['gen_batch_by_controls'])}; alternated, host clock, request to numpy")
        for n, s in u8.items():
            log(f"serving latency n {n} uint8 output: generate {stats_text(s)}")
        for key, entry in sorted(serve._serve_cache.items(), key=lambda kv: (kv[0][3], kv[0][4])):
            b = key[4]
            ms = replay_ms(entry.graph)
            n, req = p50[(key[3], b)]
            log(f"serving replay bucket {b} {key[3]}: device {ms:.3f} ms per replay (CUDA events), "
                f"{100 * ms / req:.1f}% of the {req:.3f} ms p50 request of {n} (device busy); "
                f"{b / ms * 1e3:.1f} images/s on the device, {n / req * 1e3:.1f} per request")

    with Phase("serving replay vs eager"):
        for b in SERVE_BUCKETS:
            ctl = {g: v[:b] for g, v in ctl64.items()}
            got, _, got_w = serve.generate(latent=z64[:b], **ctl)
            want_img, _, want_w = serve.gen_batch_by_controls(latent=z64[:b], **ctl)
            held_to(f"serving replay vs eager bucket {b} bf16 image", got, want_img.cpu().numpy(),
                    KERNEL_RTOL[torch.bfloat16])
            held_to(f"serving replay vs eager bucket {b} w", got_w, want_w.cpu().numpy(), KERNEL_RTOL[torch.float32])
        # per-row noise on the card: the first rows do not depend on the bucket
        shapes = serve.model.noise_shapes(64)
        seed = torch.tensor([2**40 + 7], dtype=torch.int64, device="cuda")
        big, small = row_noise(seed, shapes), row_noise(seed, [(4, *s[1:]) for s in shapes])
        if not all(torch.equal(a[:4], c) for a, c in zip(big, small)):
            fail("per-row noise of bucket 4 differs from the first rows of bucket 64")
        flat = torch.cat([x.flatten() for x in big])
        log(f"serving per-row noise on the card: bucket 4 rows equal to bucket 64's first rows; "
            f"{flat.numel()} values mean {float(flat.mean()):.5f} std {float(flat.std()):.5f}")

    with Phase("serving export"):
        t0 = time.perf_counter()
        manifest = serve.export_artifacts(root / "artifacts", buckets=(EXPORT_BUCKET,))
        export_s = time.perf_counter() - t0
        (entry,) = manifest["artifacts"]
        mib = (root / "artifacts" / entry["file"]).stat().st_size / 2**20
        t0 = time.perf_counter()
        exported = load_exported_serving(root / "artifacts")
        ctl3 = {g: v[:3] for g, v in ctl64.items()}
        got, _, got_w = exported.generate(latent=z64[:3], generator=torch.Generator().manual_seed(5), **ctl3)
        load_s = time.perf_counter() - t0
        (graph,) = exported._cache.values()
        launched = {k: v for k, v in graph.launches.items() if v}
        log(f"serving export: {entry['file']} ({entry['device']}, {entry['dtype']}) in {export_s:.2f} s, "
            f"{mib:.2f} MiB; load and first request (capture) {load_s:.2f} s, launches {launched}")
        if launched != want:
            fail(f"the exported program's capture launched {launched}, derived {want}")
        want_img, _, want_w = serve.generate(latent=z64[:3], generator=torch.Generator().manual_seed(5), **ctl3)
        held_to("serving exported vs live bucket 4 bf16 image", got, want_img, KERNEL_RTOL[torch.bfloat16])
        held_to("serving exported vs live w", got_w, want_w, KERNEL_RTOL[torch.float32])
        s = request_latency(lambda: exported.generate(latent=z64[:3], **ctl3)[0], SERVE_REQUESTS)
        log(f"serving latency n 3 exported program: {stats_text(s)}")
        del exported, graph

    del serve
    torch.cuda.empty_cache()
    seen32: Counter = Counter()
    remove = install_launch_recorder(seen32)
    try:
        with Phase("serving card vs cpu"):
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            card = ServingController(ctrl_dir, buckets=(1, 4), dtype=torch.float32)
            cpu = ServingController(ctrl_dir, buckets=(1,), device="cpu", dtype=torch.float32)
            rng = np.random.default_rng(40)
            noise = [rng.standard_normal(s).astype(np.float32) for s in card.model.noise_shapes(1)]
            card.set_noise(noise)
            cpu.set_noise(noise)
            z4 = rng.standard_normal((4, 512)).astype(np.float32)
            ctl4 = controls(4, 41)
            ctl1 = {g: v[:1] for g, v in ctl4.items()}
            want_img, _, _ = cpu.generate(latent=z4[:1], **ctl1)
            got, _, _ = card.generate(latent=z4[:1], **ctl1)
            held_to("serving card vs cpu bucket 1 f32 TF32 off", got, want_img, PARITY_RTOL)
            one, _, _ = card.generate(latent=z4[:1], static_noise=False, generator=torch.Generator().manual_seed(6),
                                      **ctl1)
            four, _, _ = card.generate(latent=z4, static_noise=False, generator=torch.Generator().manual_seed(6),
                                       **ctl4)
            held_to("serving per-row noise bucket 1 vs the first row of bucket 4 (f32, TF32 off)",
                    one, four[:1], PARITY_RTOL)
            del card, cpu
    finally:
        remove()
    return seen, counts, seen32


# ---------------------------------------------------------------------------
# phase-1 evaluation (this slice)
# ---------------------------------------------------------------------------

# real images for the statistics: more than Inception's 2048 features, so
# that their covariance has full rank and sqrt(C1 C2) is well defined
EVAL_IMAGES = 2304
EVAL_PX = 256
# the FID's generated samples: cut from the config's 50 000, and more than
# 2048 for the same reason
FID_SAMPLES = 2304
EVAL_AT = 2  # min_evaluate_interval and every evaluation interval
EVAL_ITERS = 3
FID_CHUNKS = (16, 64)
SWEEP_CHUNKS = 12  # timed chunks per chunk size
FID_RECOMPUTE_RTOL = 1e-9
# in-process separability and histogram samples (cut from the config's 2000;
# 250 from 500 for phase 25, PERF.md §4)
EVAL_INPROCESS_SAMPLES = 250
# the command line's separability and histograms (cut from the config's 2000
# for phase 22, and from 500 for phase 25, PERF.md §4)
EVAL_CLI_SAMPLES = 250


def eval_config(folder: Path, stats_path: Path, results_dir: Path) -> dict:
    """configs/ffhq.json at full width with every evaluation, TensorBoard and
    the CSV monitor on, due at iteration EVAL_AT: FID against
    ``stats_path`` with a random Inception and FID_SAMPLES samples,
    separability and both histograms at EVAL_CLI_SAMPLES samples, the
    sample images at 0 and EVAL_AT, data from ``folder``."""
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["results_dir"] = str(results_dir)
    config["data_config"]["path"] = str(folder)
    config["tensorboard_config"]["enabled"] = True
    config["monitor_config"]["enabled"] = True
    config["training_config"].update(min_evaluate_interval=EVAL_AT, save_images_interval=EVAL_AT,
                                     save_nets_interval=1000, log_every=1)
    ec = config["evaluation_config"]
    ec["fid"].update(inception_weights="__random__", inception_stat_path=str(stats_path),
                     fid_interval=EVAL_AT, num_of_samples=FID_SAMPLES)
    ec["separability"].update(separability_interval=EVAL_AT, num_of_samples=EVAL_CLI_SAMPLES)
    for kind in ("orientation_hist", "expression_bar"):
        ec[kind].update({f"{kind}_interval": EVAL_AT, "num_of_samples": EVAL_CLI_SAMPLES})
    return config


def inception_card_vs_cpu(seed: int = 0) -> float:
    """The FID net (random init, seed 42) on the card and on the CPU, batch
    2 of 512-px images (the resize to 299 included), f32 with TF32 off:
    the features to PREDICTOR_RTOL of their largest entry. Returns the
    error over that entry."""
    from gan_control_torch.evaluation import fid as fid_lib
    from gan_control_torch.evaluation.inception import load_inception

    cpu = load_inception("__random__", "cpu")
    card = copy.deepcopy(cpu).to("cuda")
    x = torch.from_numpy(np.random.default_rng(seed).random((2, 512, 512, 3)).astype(np.float32))
    want = fid_lib.make_feature_fn(cpu)(x)
    got = fid_lib.make_feature_fn(card)(x.cuda()).cpu()
    err, scale = max_err(got, want)
    log(f"inception card vs cpu: batch 2, 512 px, f32 TF32 off, features {tuple(got.shape)}: "
        f"max error {err:.3g} / max|features| {scale:.3g} = {err / scale:.2e} (tol {PREDICTOR_RTOL})")
    if not bool(torch.isfinite(got).all()) or err > PREDICTOR_RTOL * scale:
        fail("Inception: card and CPU disagree")
    return err / scale


def fid_sweep(g_ema, inception, chunk: int) -> dict:
    """The FID chunk (G + Inception, features to the host) at ``chunk``:
    images/s over SWEEP_CHUNKS warm chunks between syncs, host clock; the
    device time of one chunk (profiler) and its share of a chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gan_control_torch.evaluation import fid as fid_lib

    run = fid_lib.make_gen_feature_fn(g_ema, inception, chunk)
    gen = torch.Generator(device="cuda").manual_seed(chunk)
    for _ in range(2):
        run(gen).cpu()
    per = synced_ms(lambda: run(gen).cpu(), SWEEP_CHUNKS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(gen).cpu()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    med = statistics.median(per)
    return {"chunk": chunk, "ms": med, "images_per_s": chunk * 1e3 / med, "device_ms": busy,
            "busy": busy / med}


def evaluation_folder(build_root: Path) -> Path:
    """Phase 16's image folder (also phase 18's MetFaces data)."""
    import shutil

    root = build_root / "evaluation"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    torch.cuda.empty_cache()
    with Phase("evaluation folder write"):
        return write_image_folder(root / "images", EVAL_IMAGES, EVAL_PX, seed=5)


def evaluation_phase(build_root: Path, folder: Path, before_in_process) -> tuple[Counter, dict]:
    """Phase 16 on :func:`evaluation_folder`'s images; ``before_in_process()``
    runs between its command lines and its in-process evaluations (which
    time). Returns the launches recorded on the evaluation path (one
    in-process evaluation of each kind at iteration EVAL_AT, by kernel,
    shape, dtype and static args) and their counts."""
    from gan_control_torch.data.datasets import synthetic_data_loader
    from gan_control_torch.evaluation import fid as fid_lib
    from gan_control_torch.evaluation.inception import load_inception
    from gan_control_torch.losses.registry import build_attr_losses
    from gan_control_torch.trainers.generator_trainer import GeneratorTrainer

    root = build_root / "evaluation"
    stats_path = root / "real_stats.pkl"
    with Phase("evaluation calc_inception"):
        t0 = time.perf_counter()
        lines = run_cli("gan_control_torch.calc_inception",
                        ["--path", str(folder), "--size", "512", "--n_samples", str(EVAL_IMAGES),
                         "--save_path", str(stats_path)], root / "calc_inception.log", 600)
        secs = time.perf_counter() - t0
        if not any("random inception weights" in ln for ln in lines):
            fail("calc_inception did not warn of its random weights")
        mu, cov = fid_lib.load_stats(stats_path)
        eig = np.linalg.eigvalsh(cov)
        log(f"calc_inception: {EVAL_IMAGES} PNGs of {EVAL_PX} px resized to 512, random Inception "
            f"(seed 42), {secs:.1f} s in its process; stats mean {mu.shape} cov {cov.shape}, the "
            f"covariance's eigenvalues {eig.min():.3g} to {eig.max():.3g}")
        if mu.shape != (2048,) or cov.shape != (2048, 2048) or not np.isfinite(cov).all():
            fail("calc_inception wrote statistics of the wrong shape")

    config = eval_config(folder, stats_path, root / "results")
    cfg_path = root / "eval_config.json"
    cfg_path.write_text(json.dumps(config))
    with Phase("evaluation train_generator"):
        t0 = time.perf_counter()
        lines = run_cli("gan_control_torch.train_generator",
                        ["--config_path", str(cfg_path), "--iters", str(EVAL_ITERS)],
                        root / "train_generator.log", 900)
        secs = time.perf_counter() - t0
        text = "\n".join(lines)
        bad = [ln for ln in lines if "not ported" in ln]
        if bad:
            fail(f"train_generator logged: {bad[:3]}")
        save_dir = Path(re.search(r"save dir: (\S+)", text)[1])
        recs = [json.loads(ln) for ln in (save_dir / "metrics.jsonl").read_text().splitlines()]
        rec = next((r for r in recs if r["iter"] == EVAL_AT and "fid" in r), None)
        keys = ("fid", "best_fid", "separability/embedding_loss/l0_same_mean",
                "separability/embedding_loss/l0_2ndbest_mean", "separability/embedding_loss/l0_margin",
                "orientation/yaw_std")
        if rec is None or not all(k in rec and math.isfinite(rec[k]) for k in keys):
            fail(f"metrics.jsonl at iteration {EVAL_AT} lacks a finite {keys}: {rec}")
        files = ["checkpoint/best_fid.ckpt", f"buckets/embedding_loss/{EVAL_AT:06d}.jpg",
                 f"graphs/orientation_{EVAL_AT:06d}.jpg", f"graphs/expression_{EVAL_AT:06d}.jpg",
                 "monitor.csv"] + [f"images/{k}_matrix/{EVAL_AT:06d}.jpg" for k in
                                   ("orientation", "expression", "age", "hair", "attribute")]
        missing = [f for f in files if not (save_dir / f).is_file()]
        if missing:
            fail(f"the evaluation run left no {missing}")
        events = list((save_dir / "tensorboard").glob("events.out.tfevents.*"))
        log(f"evaluation train_generator: configs/ffhq.json at full width, batch 16, the six-loss "
            f"battery at random init, {EVAL_ITERS} iterations from {EVAL_IMAGES} PNGs, every "
            f"evaluation at iteration {EVAL_AT} (FID on {FID_SAMPLES} samples, cut from 50 000; "
            f"separability and both histograms on {EVAL_CLI_SAMPLES}), {secs:.1f} s in its process; fid "
            f"{rec['fid']:.6f}, best_fid {rec['best_fid']:.6f}, separability margin "
            f"{rec['separability/embedding_loss/l0_margin']:.6g}, yaw std "
            f"{rec['orientation/yaw_std']:.6g}; files {len(files)} present; TensorBoard events "
            f"written: {bool(events)} ({sum(p.stat().st_size for p in events)} bytes)")

    before_in_process()
    seen: Counter = Counter()
    counts: dict = {n: 0 for n in KERNELS}
    with Phase("evaluation in-process"):
        cfg2 = json.loads(json.dumps(config))
        cfg2["results_dir"] = str(root / "in_process")
        cfg2["ckpt_config"] = {"enabled": True, "ckpt": str(save_dir / "checkpoint" / "best_fid.ckpt")}
        attr_losses, predictors = build_attr_losses(cfg2["training_config"], device="cuda")
        tr = GeneratorTrainer(config=cfg2, device="cuda", attr_losses=attr_losses, predictors=predictors,
                              data_loader=synthetic_data_loader(16, 512))
        if tr.start_iter != 0 or tr.state.step != EVAL_ITERS:
            fail(f"best_fid.ckpt loaded at start_iter {tr.start_iter}, step {tr.state.step}")
        n_map, n_conv, n_up = g_counts(tr.state.g_ema)
        per_forward = row(n_map + n_conv, 0, n_up, 0)
        ec = cfg2["evaluation_config"]
        for kind in ("separability", "orientation_hist", "expression_bar"):
            ec[kind]["num_of_samples"] = EVAL_INPROCESS_SAMPLES  # the trainer's own dicts
        batch = cfg2["training_config"]["batch"]
        forwards = {"fid": -(-FID_SAMPLES // batch),
                    "separability": -(-ec["separability"]["num_of_samples"] // 20) + 1,
                    "orientation_hist": -(-ec["orientation_hist"]["num_of_samples"] // batch),
                    "expression_bar": -(-ec["expression_bar"]["num_of_samples"] // batch)}
        out = {}
        kinds = (("fid", lambda: out.update(fid=tr.evaluate_fid())),
                 ("separability", lambda: tr.evaluate_separability(EVAL_AT)),
                 ("orientation_hist", lambda: tr.evaluate_attribute_hist(
                     EVAL_AT, "orientation_hist", "orientation_loss", ec["orientation_hist"])),
                 ("expression_bar", lambda: tr.evaluate_attribute_hist(
                     EVAL_AT, "expression_bar", "expression_loss", ec["expression_bar"])))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kind, fn in kinds:
            t0 = time.perf_counter()
            got = launches_of(fn, seen)
            secs = time.perf_counter() - t0
            want = {n: forwards[kind] * c for n, c in per_forward.items()}
            log(f"evaluation {kind}: {secs:.2f} s, {forwards[kind]} G forwards, launches "
                f"{ {n: c for n, c in got.items() if c} } (derived {want})")
            if got != want:
                fail(f"evaluation {kind}: launches {got}, derived {want}")
            add_counts(counts, got)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"evaluation peak memory {peak:.2f} GiB allocated (train state, the battery and the "
            f"FID net alive), {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        tr.tracker.register_fid(EVAL_AT, out["fid"])
        rec2 = tr.tracker.write_stats(EVAL_AT)
        t0 = time.perf_counter()
        recomputed = fid_lib.frechet_distance(*fid_lib.compute_stats(tr.fid_features),
                                              *fid_lib.load_stats(stats_path))
        t_fd = time.perf_counter() - t0
        rel = abs(recomputed - rec2["fid"]) / abs(recomputed)
        log(f"evaluation fid: logged {rec2['fid']:.9f}, recomputed on the CPU in float64 from the "
            f"same {tr.fid_features.shape} features {recomputed:.9f} (relative {rel:.2e}, tol "
            f"{FID_RECOMPUTE_RTOL}; the Frechet distance {t_fd:.2f} s on the host); the command "
            f"line's {rec['fid']:.9f} from the same checkpoint in another process (relative "
            f"{abs(rec['fid'] - recomputed) / abs(recomputed):.2e})")
        if not rel <= FID_RECOMPUTE_RTOL:
            fail("the logged FID is not the FID of its features")
        one = Counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        z20 = torch.randn((20, 512), generator=gen, device="cuda")
        for label, fn in (("FID chunk", lambda: tr._fid_chunk(gen)),
                          ("separability batch", lambda: tr._separability_images(z20, gen)),
                          ("histogram batch", lambda: tr.state.g_ema([z20[:batch]], generator=gen))):
            got = launches_of(fn, one)
            log(f"evaluation launches of one {label}: {got} (derived {per_forward})")
            if got != per_forward:
                fail(f"one {label}: launches {got}, derived {per_forward}")

    with Phase("evaluation fid sweep"):
        inception = load_inception("__random__", "cuda")
        sweeps = [fid_sweep(tr.state.g_ema, inception, chunk) for chunk in FID_CHUNKS]
        for sw in sweeps:
            log(f"evaluation fid sweep chunk {sw['chunk']}: {sw['ms']:.2f} ms per chunk (median of "
                f"{SWEEP_CHUNKS}), {sw['images_per_s']:.1f} images/s (G bf16 + Inception f32 TF32 "
                f"off); device {sw['device_ms']:.2f} ms per chunk = {100 * sw['busy']:.1f}% busy; a "
                f"50 000-sample FID {50_000 / sw['images_per_s']:.1f} s of chunks + "
                f"{t_fd:.1f} s of Frechet distance")
    with Phase("evaluation inception card vs cpu"):
        inception_card_vs_cpu()
    del tr, attr_losses, predictors, inception
    torch.cuda.empty_cache()
    return seen, counts


# ---------------------------------------------------------------------------
# phase 18: AFHQ and MetFaces training (ADA, the three new nets, transfer)
# ---------------------------------------------------------------------------

AFHQ_IMAGES = 64
AFHQ_CATS = 3  # not images: the AFHQ loader reads train/dog only
NEW_ITERS = 2  # each command-line run and each in-process train() (cut from 3 for phase 23, PERF.md §4)
FIXED_P = 0.5  # MetFaces' augment.p: the augmentation moves pixels from the first step
NEW_NETS = {"dog_id_loss": "afhq", "classification_loss": "afhq", "style_loss": "metfaces"}
NEW_GROUPS = {"afhq": 3, "metfaces": 6}
NEW_LOSSES = {"afhq": ("orientation_loss", "dog_id_loss", "classification_loss"),
              "metfaces": ("embedding_loss", "orientation_loss", "age_loss", "expression_loss",
                           "style_loss")}
ADA_REPS = 2  # alternations of plain iterations with ADA and without
# ADA card vs CPU (f32, TF32 off), against the output's largest entry: the
# sampling grid's coordinates differ by an ulp or two between the devices'
# f32 orders (~2e-4 px of the 1549-px upsampled frame at 512 px), and a
# point on the pad's cover boundary may take the direct or the folded
# sample (they differ by the SYM6 filter's asymmetry)
AUGMENT_RTOL = 1e-3


def smooth_images(n: int, seed: int, px: int = 512) -> torch.Tensor:
    """``n`` NHWC f32 images on the CPU: seeded 32-px noise resized
    bilinearly to ``px``, as smooth as a generator's."""
    small = np.random.default_rng(seed).standard_normal((n, 3, 32, 32)).astype(np.float32) * 0.5
    return F.interpolate(torch.from_numpy(small), size=(px, px), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1).contiguous()


def fixed_augment(batch: int, seed: int, fold: bool = True):
    """An ``augment_fn`` of explicit colour matrices and geometric
    transforms, the same on any device. With ``fold``: rotations,
    anisotropic scales and translations as ``sample_affine`` draws them,
    every fourth row translated about one image size away, into the reflect
    fold. Without: mild ones (a few degrees, a few percent, a few pixels),
    whose output never reads a sample beyond the materialised pad."""
    rng = np.random.default_rng(seed)
    g = []
    for i in range(batch):
        mild = 1.0 if fold else 0.1
        th = rng.uniform(-math.pi, math.pi) * (1.0 if fold else 0.03)
        s, s2 = np.exp(rng.normal(size=2) * 0.2 * math.log(2) * mild)
        t = rng.normal(size=2) * 0.125 * mild + (np.array([0.9, -0.7]) if fold and i % 4 == 3 else 0.0)
        m = np.array([[math.cos(th), -math.sin(th), t[0]], [math.sin(th), math.cos(th), t[1]], [0, 0, 1]])
        g.append(m @ np.diag([s * s2, s / s2, 1.0]))
    g = torch.tensor(np.array(g), dtype=torch.float32)
    c = torch.eye(4).repeat(batch, 1, 1)
    c[:, :3, :3] += torch.from_numpy(rng.standard_normal((batch, 3, 3)).astype(np.float32)) * 0.2
    c[:, :3, 3] = torch.from_numpy(rng.standard_normal((batch, 3)).astype(np.float32)) * 0.1

    def augment_fn(img, p, generator):
        from gan_control_torch.training import ada

        return ada.apply_color(ada.apply_affine(img, g.to(img.device)), c.to(img.device))

    return augment_fn


def augment_card_vs_cpu(seed: int = 0) -> dict:
    """``apply_affine`` then ``apply_color`` on two 512-px images with
    explicit matrices, f32 with TF32 off, card against CPU: the output and
    the image gradient of a seeded projection to AUGMENT_RTOL of their
    largest entries."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fn = fixed_augment(2, seed)
    images = smooth_images(2, seed)
    proj = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(images.shape).astype(np.float32))

    def run(dev):
        x = images.to(dev).requires_grad_(True)
        out = fn(x, None, None)
        (grad,) = torch.autograd.grad((out * proj.to(dev)).sum(), x)
        return out.detach().cpu(), grad.cpu()

    (want, want_g), (got, got_g) = run("cpu"), run("cuda")
    errs = {}
    for label, g, w in (("output", got, want), ("image gradient", got_g, want_g)):
        err, scale = max_err(g, w)
        errs[label] = err / scale
        if not bool(torch.isfinite(g).all()) or err > AUGMENT_RTOL * scale:
            fail(f"ADA card vs cpu: the {label} disagrees: {err:.3g} > {AUGMENT_RTOL} x {scale:.3g}")
    log(f"ADA card vs cpu: apply_affine + apply_color, batch 2, 512 px, f32 TF32 off, explicit "
        f"matrices (one into the reflect fold): output error / max {errs['output']:.2e}, image gradient "
        f"{errs['image gradient']:.2e} (tol {AUGMENT_RTOL})")
    return errs


def new_nets_card_vs_cpu() -> None:
    """DogFaceNet, ResNet-18 and the VGG-16 style net alone, card against
    CPU, as phase 9 holds the FFHQ nets: batch 2 of 512-px images, f32,
    TF32 off, batch-norm statistics (the style net: its conv outputs)
    calibrated from the images."""
    from gan_control_torch.losses.registry import build_attr_losses, calibrate_battery

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images = smooth_images(4, 3)
    for i, (name, cfg_name) in enumerate(NEW_NETS.items()):
        block = json.loads((CONFIGS / f"{cfg_name}.json").read_text())["training_config"][name]
        _, preds = build_attr_losses({name: dict(block, enabled=True)}, device="cpu", seed=5)
        calibrate_battery(preds, images)
        predictor_card_vs_cpu(name, preds[name], images[:PREDICTOR_BATCH], 400 + i)


def ada_steps_card_vs_cpu() -> None:
    """A size-32 FFHQ model's ``d_step`` (ADA adapting ``ada_p`` from 0.3)
    and ``g_step``, each with a fixed-matrix ``augment_fn``, card against
    CPU from the same parameters and explicit inputs, f32 with TF32 off:
    losses and gradients to TRAIN_PARITY_RTOL, ``ada_p`` equal. The
    matrices are mild (``fixed_augment(fold=False)``): at the pad's cover
    boundary the reference's pipeline switches between the direct and the
    folded sample, which differ by the SYM6 filter's asymmetry, and among
    the ~4e5 upsampled samples of a batch of 16 at 32 px one lands within
    an ulp of it about as often as not, where the card and the CPU may
    take other branches (an error of 1.14e-3 in a D gradient, measured;
    ROADMAP Queue 3). ``augment_card_vs_cpu`` holds the fold at 512 px."""
    from gan_control_torch.models.factory import build_discriminator, build_generator, build_group_spec
    from gan_control_torch.ops import kernels
    from gan_control_torch.training import train_step as ts
    from gan_control_torch.training.state import init_gan_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["model_config"].update(size=32, max_channels=64, mixed_precision=False)
    tc = config["training_config"]
    spec = build_group_spec(config)
    b = tc["batch"]
    cfg = ts.TrainStepConfig(batch=b, mini_batch=tc["mini_batch"], ada_enabled=True)
    augment_fn = fixed_augment(b, 9, fold=False)
    rng = np.random.default_rng(6)
    z = torch.from_numpy(rng.standard_normal((b, 512)).astype(np.float32))
    real = smooth_images(b, 7, px=32)
    g0 = build_generator(config, spec, device="cpu", seed=0)
    d0 = build_discriminator(config, device="cpu", seed=1)
    noise = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in g0.noise_shapes(b)]

    def step(dev: str, kind: str, dtype=torch.float32):
        g, d = copy.deepcopy(g0).to(dev, dtype), copy.deepcopy(d0).to(dev, dtype)
        g.dtype = d.dtype = dtype
        st = init_gan_state(g, d, tc)
        st.ada_p = torch.tensor(0.3, device=dev)
        kw = dict(noise=[n.to(dev, dtype) for n in noise], augment_fn=augment_fn)
        if kind == "d_step":
            m = ts.d_step(st, cfg, spec, real.to(dev, dtype), (z.to(dev, dtype),), **kw)
        else:
            m = ts.g_step(st, cfg, spec, (z.to(dev, dtype),), **kw)
        grads = {f"{p}.{n}": t.grad.detach().cpu().double() for p, mod in (("G", st.generator),
                                                                          ("D", st.discriminator))
                 for n, t in mod.named_parameters() if t.grad is not None}
        return {k: float(v) for k, v in m.items()}, grads, float(st.ada_p)

    out = {(dev, kind): step(dev, kind) for dev in ("cpu", "cuda") for kind in ("d_step", "g_step")}
    # the float64 reference on the CPU, and the card with cuDNN off (ATen's own convs):
    # which side of card vs CPU lies nearer the float64 gradients, and whether cuDNN's
    # convs carry the difference (ROADMAP Queue 3 item 7); printed, the bound unchanged
    check = kernels._check_dtype
    kernels._check_dtype = lambda name, x: None  # the plain versions, in float64 on the CPU
    try:
        ref = step("cpu", "g_step", torch.float64)[1]
    finally:
        kernels._check_dtype = check
    torch.backends.cudnn.enabled = False
    try:
        no_cudnn = step("cuda", "g_step")[1]
    finally:
        torch.backends.cudnn.enabled = True
    for label, grads in (("cpu f32", out["cpu", "g_step"][1]), ("card f32 (cuDNN)", out["cuda", "g_step"][1]),
                         ("card f32 (cuDNN off)", no_cudnn)):
        worst, worst_name = worst_grad_err(ref, grads)
        noise_w = max(worst_grad_err({k: v}, {k: grads[k]})[0] for k, v in ref.items() if "noise" in k)
        log(f"ADA g_step against float64 (CPU): {label} worst rel err {worst:.3g} ({worst_name}), "
            f"worst noise weight {noise_w:.3g}")
    for kind in ("d_step", "g_step"):
        (mc, gc, pc), (mg, gg, pg) = out["cpu", kind], out["cuda", kind]
        loss_err = max(abs(mc[k] - mg[k]) / max(1.0, abs(mc[k])) for k in mc)
        worst, worst_name = worst_grad_err(gc, gg)
        log(f"ADA steps card vs cpu: {kind} with a fixed-matrix augment: losses {mc}, worst loss rel err "
            f"{loss_err:.3g}; {len(gc)} gradients, worst rel err {worst:.3g} ({worst_name}), tol "
            f"{TRAIN_PARITY_RTOL}; ada_p cpu {pc} card {pg}")
        if loss_err > TRAIN_PARITY_RTOL or worst > TRAIN_PARITY_RTOL or pc != pg or gc.keys() != gg.keys():
            fail(f"ADA {kind}: card and CPU disagree")
    if out["cpu", "d_step"][2] == float(np.float32(0.3)):
        fail("ADA d_step: ada_p did not adapt")


def augment_timing() -> tuple[float, float]:
    """``augment`` alone at the path's shape, [16, 512, 512, 3] bf16, p 0.5:
    the forward and the image-gradient backward (CUDA events, median of a
    few), then the device time by kernel of one forward and backward."""
    from gan_control_torch.training import ada

    gen = torch.Generator(device="cuda").manual_seed(17)
    x0 = (torch.randn((16, 512, 512, 3), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    proj = torch.randn(x0.shape, generator=gen, device="cuda").to(torch.bfloat16)

    def run():
        x = x0.detach().clone().requires_grad_(True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        out = ada.augment(x, 0.5, gen)
        ev[1].record()
        torch.autograd.grad((out * proj).float().sum(), x)
        ev[2].record()
        return ev

    f, b = event_ms(run)
    log(f"ADA augment alone: [16, 512, 512, 3] bf16, p 0.5: forward {f:.2f} ms, image-gradient backward "
        f"{b:.2f} ms (CUDA events, median of {BATTERY_REPS})")
    profile_phase("ADA augment forward and backward", run, f + b)
    return f, b


def transfer_check(config: dict, ffhq_run: Path) -> None:
    """MetFaces with ``transfer_learning_model`` at phase 7b's FFHQ run,
    before any step: every synthesis tensor of G and its EMA equal to the
    run's ``g_ema``; each mapping tensor the source's where its name and
    shape match, else the MetFaces G's own init; ``ada_p`` at the fixed p."""
    from gan_control_torch.data.datasets import synthetic_data_loader
    from gan_control_torch.inference.inference import Inference
    from gan_control_torch.models.factory import build_generator, build_group_spec
    from gan_control_torch.trainers.generator_trainer import GeneratorTrainer

    source = Inference.retrieve_model(ffhq_run, torch.device("cpu"), None)[0].state_dict()
    # the trainer's G before the transfer: the factory's init at the trainer's seed
    fresh = build_generator(config, build_group_spec(config), device="cuda",
                            seed=config["training_config"].get("seed", 0)).state_dict()
    tr = GeneratorTrainer(config=config, init_dirs=False, device="cuda", data_loader=synthetic_data_loader(16, 512))
    g, ema = tr.state.generator.state_dict(), tr.state.g_ema.state_dict()
    synth, loaded, kept = 0, 0, []
    for name, v in g.items():
        src = source.get(name)
        if src is not None and src.shape == v.shape:
            if not torch.equal(v.cpu(), src):
                fail(f"transfer: {name} differs from the source")
            synth += not name.startswith("style.")
            loaded += name.startswith("style.")
        elif not name.startswith("style.") or not torch.equal(v, fresh[name]):
            fail(f"transfer: {name} neither loaded nor kept at its init")
        else:
            kept.append(name)
        if not torch.equal(ema[name], v):
            fail(f"transfer: the EMA's {name} is not G's")
    n_synth = sum(not k.startswith("style.") for k in g)
    if synth != n_synth or not kept or float(tr.state.ada_p) != FIXED_P:
        fail(f"transfer: {synth} of {n_synth} synthesis tensors loaded, {len(kept)} kept, "
             f"ada_p {float(tr.state.ada_p)}")
    groups = sorted({k.split(".")[1] for k in kept})
    log(f"transfer: MetFaces G and EMA from {ffhq_run.name}: all {n_synth} synthesis tensors equal the "
        f"FFHQ run's g_ema, {loaded} mapping tensors loaded (name and shape match), {len(kept)} kept their "
        f"init (groups {groups}); ada_p {float(tr.state.ada_p)} before the first step")
    del tr, fresh
    torch.cuda.empty_cache()


def check_new_run(name: str, run: CliRun, config: dict) -> Path:
    """The metrics, checkpoint and images of one command-line run of
    phase 18 (a) or (b)."""
    text = "".join(run.lines)
    if "not ported" in text:
        fail(f"{name} train_generator logged 'not ported'")
    save_dir = Path(re.search(r"save dir: (\S+)", text)[1])
    recs = [json.loads(ln) for ln in (save_dir / "metrics.jsonl").read_text().splitlines()]
    if [r["iter"] for r in recs] != list(range(NEW_ITERS)):
        fail(f"{name}: metrics of iterations {[r['iter'] for r in recs]}")
    attr = [f"g_{n}" for n in NEW_LOSSES[name]]
    adaptive = config["training_config"]["augment"]["p"] == 0
    for r in recs:
        nums = {k: v for k, v in r.items() if isinstance(v, (int, float))}
        if not all(math.isfinite(v) for v in nums.values()) or not all(a in r for a in attr):
            fail(f"{name}: iteration {r['iter']} lacks a finite {attr}: {r}")
        if ("ada_p" in r) != adaptive:
            fail(f"{name}: ada_p logged {'ada_p' in r}, adaptive {adaptive}")
        log(f"{name} attribute losses, iteration {r['iter']}: "
            + ", ".join(f"{a} {r[a]:.6g}" for a in attr)
            + (f"; ada_p {r['ada_p']:.9g}" if adaptive else "") + f"; g_loss {r['g_loss']:.6g}")
    from gan_control_torch.utils import checkpoint as ckpt_lib

    ckpt_p = float(ckpt_lib.load_state_dict(save_dir / "checkpoint" / f"{NEW_ITERS:06d}.ckpt")["ada_p"])
    want_p = float(np.float32(recs[-1]["ada_p"])) if adaptive else FIXED_P
    if ckpt_p != want_p:
        fail(f"{name}: the checkpoint's ada_p {ckpt_p}, expected {want_p}")
    groups = list(config["training_config"]["sub_groups_dict"])
    files = [f"images/{g}/000000.jpg" for g in ("samples", *groups)] + ["images/orientation_matrix/000000.jpg"]
    missing = [f for f in files if not (save_dir / f).is_file()]
    if missing or len(groups) != NEW_GROUPS[name]:
        fail(f"{name}: no {missing} (groups {groups})")
    log(f"{name} train_generator: {NEW_ITERS} iterations, {len(attr)} attribute losses finite in each, "
        f"checkpoint ada_p {ckpt_p!r}; the sample grid and {len(groups)} group matrices written")
    return save_dir


def new_trainer_in_process(name: str, config: dict, seen: Counter, counts: dict) -> None:
    """Phase 18 (c) for one config: ``train(NEW_ITERS)`` with the launches
    of each step kind held to ``expected_step_counts`` (the battery and
    ADA launch none of the port's kernels), step and iteration times, peak
    memory, the battery's times, and plain iterations with ADA against the
    same trainer with it off."""
    from gan_control_torch.data.datasets import synthetic_data_loader
    from gan_control_torch.losses.registry import build_attr_losses
    from gan_control_torch.ops import kernels
    from gan_control_torch.trainers import generator_trainer as gt
    from gan_control_torch.training import ada

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    specs, predictors = build_attr_losses(config["training_config"], device="cuda")
    tr = gt.GeneratorTrainer(config=config, init_dirs=False, device="cuda", attr_losses=specs,
                             predictors=predictors, data_loader=synthetic_data_loader(16, 512, seed=0))
    st = tr.state
    if [s.name for s in specs] != list(NEW_LOSSES[name]) or len(tr.spec.groups) != NEW_GROUPS[name]:
        fail(f"{name}: battery {[s.name for s in specs]}, {len(tr.spec.groups)} groups")
    per_kind = expected_step_counts(st.generator, st.discriminator, NEW_GROUPS[name])
    tr.profile_steps = True
    torch.cuda.reset_peak_memory_stats()
    by_kind, restore = count_by_kind(gt)
    remove = install_launch_recorder(seen)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        tr.train(NEW_ITERS)
        torch.cuda.synchronize()
        got = kernels.launch_counts()
    finally:
        remove()
        restore()
    runs = {k: len(v) for k, v in by_kind.items()}
    if runs != {"d_step": NEW_ITERS, "d_reg_step": 1, "g_step": NEW_ITERS, "g_reg_step": 1}:
        fail(f"{name}: step kinds run {runs}")
    for kind, rows in by_kind.items():
        for r in rows:
            if r != per_kind[kind]:
                fail(f"{name} {kind}: launches {r}, derived {per_kind[kind]}")
    want = {n: sum(runs[k] * per_kind[k][n] for k in runs) for n in KERNELS}
    if got != want:
        fail(f"{name}: launches over train({NEW_ITERS}) {got}, derived {want}")
    add_counts(counts, got)
    for h in tr.metrics_history:
        if not all(math.isfinite(v) for v in h.values()) or not all(f"g_{n}" in h for n in NEW_LOSSES[name]):
            fail(f"{name}: iteration {h['iter']} metrics {h}")
    log(f"{name} in-process: {NEW_GROUPS[name]} groups, battery {list(NEW_LOSSES[name])} "
        f"({tr.step_cfg.predictor_dtype}, remat {tr.step_cfg.remat_predictors}), ADA "
        f"{'adaptive' if tr.step_cfg.ada_p_fixed == 0 else f'fixed p {tr.step_cfg.ada_p_fixed}'}; launches "
        f"over train({NEW_ITERS}) {got}, each step kind as derived ({ {k: per_kind[k] for k in runs} })")
    for kind, ts_ in tr.step_times.items():
        log(f"{name} time: {kind} median {statistics.median(ts_):.2f} ms over {len(ts_)} "
            f"({[round(t, 2) for t in ts_]})")
    it = [t * 1e3 for t in tr.iter_times]
    log(f"{name} time: iteration median {statistics.median(it):.2f} ms ({[round(t, 2) for t in it]}); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    battery_timing(tr, statistics.median(tr.step_times["g_step"]))
    tr.profile_steps = False
    with_ada, without = [], []
    for _ in range(ADA_REPS):
        tr.augment_fn = ada.augment
        with_ada += plain_iteration_ms(tr)
        tr.augment_fn = None
        without += plain_iteration_ms(tr)
    tr.augment_fn = ada.augment
    a, o = statistics.median(with_ada), statistics.median(without)
    log(f"{name} ADA share: plain iteration (d_step + g_step) median {a:.2f} ms with ADA "
        f"({[round(t, 2) for t in with_ada]}) against {o:.2f} ms with augment off "
        f"({[round(t, 2) for t in without]}), alternated; ADA {a - o:.2f} ms = {100 * (a - o) / a:.1f}% "
        f"of the iteration")
    tr.close()
    del tr, specs, predictors
    torch.cuda.empty_cache()


def afhq_metfaces_start(build_root: Path, ffhq_run: Path, metfaces_folder: Path) -> dict:
    """Phase 18 (a) and (b): AFHQ and MetFaces through ``train_generator``
    at full width, started side by side (beside phase 16's command lines);
    before them the MetFaces transfer checked in-process. Returns what
    :func:`afhq_metfaces_wait` and :func:`afhq_metfaces_phase` read."""
    import shutil

    root = build_root / "afhq_metfaces"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    with Phase("afhq folder write"):
        write_image_folder(root / "afhq" / "train" / "dog", AFHQ_IMAGES, 512, seed=7)
        cats = root / "afhq" / "train" / "cat"
        cats.mkdir()
        for i in range(AFHQ_CATS):
            (cats / f"{i:05d}.png").write_bytes(b"not a PNG: the AFHQ loader reads the dogs only")
    configs = {}
    for name, folder in (("afhq", root / "afhq"), ("metfaces", metfaces_folder)):
        config = json.loads((CONFIGS / f"{name}.json").read_text())
        config["results_dir"] = str(root / f"{name}_results")
        config["data_config"]["path"] = str(folder)
        config["training_config"].update(save_images_interval=1000, save_nets_interval=1000, log_every=1)
        configs[name] = config
    met_tc = configs["metfaces"]["training_config"]
    met_tc["transfer_learning_model"] = {"enabled": True, "model_path": str(ffhq_run)}
    met_tc["augment"]["p"] = FIXED_P
    with Phase("metfaces transfer before the first step"):
        transfer_check(configs["metfaces"], ffhq_run)

    runs = {}
    for name, config in configs.items():
        path = root / f"{name}_config.json"
        path.write_text(json.dumps(config))
        runs[name] = CliRun(path, NEW_ITERS, root / f"train_generator_{name}.log")
    return {"runs": runs, "configs": configs, "t0": time.perf_counter(), "ffhq_run": ffhq_run}


def afhq_metfaces_wait(started: dict) -> None:
    """Phase 18 (a) and (b) to their ends, and their checks."""
    runs, configs = started["runs"], started["configs"]
    with Phase("afhq and metfaces command lines (the wait beside phase 16's)"):
        for name, run in runs.items():
            rc = run.finish(900)
            if rc != 0:
                fail(f"{name} train_generator exited {rc}; last lines:\n" + "".join(run.lines[-30:]))
        log(f"afhq and metfaces train_generator: both runs side by side (beside phase 16's command lines), "
            f"{time.perf_counter() - started['t0']:.1f} s; AFHQ from {AFHQ_IMAGES} 512-px PNGs in train/dog "
            f"({AFHQ_CATS} unreadable files in train/cat), MetFaces ('met-faces') from phase 16's {EVAL_IMAGES} "
            f"PNGs with transfer from {started['ffhq_run'].name}")
        for name, run in runs.items():
            check_new_run(name, run, configs[name])


def afhq_metfaces_phase(started: dict) -> tuple[Counter, dict]:
    """Phase 18 after (a) and (b): (c) one trainer per config in-process;
    (d) the new nets, ADA and the ADA steps card against CPU. Returns (c)'s
    launches by (kernel, shape, dtype, static args) and their counts."""
    configs = started["configs"]
    seen: Counter = Counter()
    counts: dict = {n: 0 for n in KERNELS}
    with Phase("afhq and metfaces in-process"):
        for name, config in configs.items():
            config = copy.deepcopy(config)
            config["training_config"]["transfer_learning_model"]["enabled"] = False
            new_trainer_in_process(name, config, seen, counts)
        augment_timing()
    with Phase("afhq and metfaces card vs cpu"):
        new_nets_card_vs_cpu()
        augment_card_vs_cpu()
        ada_steps_card_vs_cpu()
    return seen, counts


# ---------------------------------------------------------------------------
# phases 19-20: alignment in the sweep, and projection (this slice)
# ---------------------------------------------------------------------------

ALIGN_ROWS = 80  # two batches of SWEEP_BATCH per command line (cut from four for phase 23, PERF.md §4)
ALIGN_DETECTORS = ("sfd", "blazeface")
ALIGN_PARITY_BATCH = 2
PROJ_STEPS = 100  # cut from 200 for phase 21 (PERF.md §4)
PROJ_COUNTED_STEPS = 3
PROJ_TIMED_STEPS = 10
PROJ_PARITY_STEPS = 3
# projector card vs CPU (f32, TF32 off, the same draws): the latent and the
# noises after three Adam steps, each against its largest entry, as
# PARITY_RTOL (the same sums in other orders through the G's and LPIPS's
# forward and backward)
PROJ_PARITY_RTOL = 1e-3


def write_alignment_checkpoints(root: Path) -> dict:
    """FAN (4 modules), S3FD, BlazeFace and ResNetDepth (3, 8, 36, 3) at
    seeded random init, each in its reference checkpoint's layout (the depth
    net's keys with the ``module.`` prefix under ``state_dict``)."""
    from gan_control_torch.alignment import blazeface, depth, fan, sfd
    from gan_control_torch.losses.predictors.common import init_predictor_

    root.mkdir(parents=True, exist_ok=True)
    paths = {n: root / f"{n}.pth" for n in ("fan", "sfd", "blazeface", "depth")}
    torch.save(init_predictor_(fan.FANNet(4), 21).state_dict(), paths["fan"])
    torch.save(init_predictor_(sfd.S3FD(), 22).state_dict(), paths["sfd"])
    torch.save(init_predictor_(blazeface.BlazeFaceNet(), 23).state_dict(), paths["blazeface"])
    sd = init_predictor_(depth.ResNetDepth(), 24).state_dict()
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, paths["depth"])
    return paths


def aligned_sweep(detector: str, model_dir: Path, paths: dict, root: Path, unaligned: float | None) -> None:
    """The command line with ``--align_3d`` and ``detector``: rows/s beside
    phase 10's, each stage's host and device ms per batch, the counts, the
    POS scale's range and the peak; the table against SWEEP_COLUMNS."""
    from gan_control_torch.data.dataframe import read_table

    table_path = root / f"attributes_aligned_{detector}.npz"
    lines = run_cli("gan_control_torch.make_attributes_df",
                    ["--model_dir", str(model_dir), "--batch_size", str(SWEEP_BATCH), "--number_of_samples",
                     str(ALIGN_ROWS), "--save_path", str(table_path), "--align_3d", "--fan_weights",
                     str(paths["fan"]), "--detector", detector, "--detector_weights", str(paths[detector]),
                     "--depth_weights", str(paths["depth"])],
                    root / f"make_attributes_df_aligned_{detector}.log", 900)
    text = "\n".join(lines)
    m = re.search(r"swept (\d+) rows in ([\d.]+) s \(([\d.]+) rows/s", text)
    if not m:
        fail(f"aligned make_attributes_df ({detector}) logged no sweep line")
    steady = re.search(r"after the first batch: (\d+) rows in ([\d.]+) s \(([\d.]+) rows/s", text)
    if not steady:
        fail(f"aligned make_attributes_df ({detector}) logged no rate after its first batch")
    rate = float(steady[3])
    log(f"alignment sweep {detector}: make_attributes_df --align_3d --batch_size {SWEEP_BATCH} "
        f"--number_of_samples {ALIGN_ROWS}: {m[1]} rows in {m[2]} s = {m[3]} rows/s (its loop, the first "
        f"batch's warm-up and the writes included); after the first batch {steady[1]} rows in {steady[2]} s "
        f"= {rate:.2f} rows/s; phase 10's unaligned sweep "
        + ("not run" if unaligned is None else f"{unaligned:.2f} rows/s ({unaligned / rate:.1f}x)"))
    for name, host, dev in re.findall(r"stage (.+?): host ([\d.]+) ms/batch, device (\S+) ms/batch", text):
        log(f"alignment sweep {detector} stage {name}: host {host} ms/batch, device {dev} ms/batch "
            f"(batches 2-{ALIGN_ROWS // SWEEP_BATCH})")
    for name, total, per in re.findall(r"count (.+?): (\S+) in \d+ batches, ([\d.]+) per image", text):
        log(f"alignment sweep {detector} count {name}: {total} in batches 2-{ALIGN_ROWS // SWEEP_BATCH} "
            f"({per} per image)")
    for pattern in (r"range POS scale: .*", r"peak memory .*"):
        hit = re.search(pattern, text)
        log(f"alignment sweep {detector}: " + (hit[0] if hit else f"no {pattern[:15]!r} line"))
        if not hit:
            fail("the aligned sweep logged no POS scale or peak memory")
    warned = sum("alignment WARNING" in ln for ln in lines)
    log(f"alignment sweep {detector}: {warned} detector warnings (misses and boxes without a crop window)")
    table = read_table(table_path)
    if list(table) != list(SWEEP_COLUMNS):
        fail(f"aligned sweep columns {list(table)}, expected {list(SWEEP_COLUMNS)}")
    for name, shape in SWEEP_COLUMNS.items():
        if table[name].shape != (ALIGN_ROWS, *shape) or not np.isfinite(table[name]).all():
            fail(f"aligned sweep column {name}: shape {table[name].shape} or not finite")
    log(f"alignment sweep {detector} table: {ALIGN_ROWS} rows, the columns and shapes of SWEEP_COLUMNS, finite")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    err, scale = max_err(got.cpu(), want)
    return err / max(scale, 1e-12)


def held(label: str, errs: dict, rtol: float) -> None:
    log(f"alignment card vs cpu: {label}: error / max " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol {rtol})")
    if max(errs.values()) > rtol:
        fail(f"alignment {label}: card and CPU disagree")


def alignment_card_vs_cpu(paths: dict) -> None:
    """Each net card against CPU (f32, TF32 off, the same checkpoints and
    inputs) to PREDICTOR_RTOL of each output's largest entry; then the
    discrete results, compared where the decision margin exceeds the nets'
    measured error: the detector's best box, FAN's argmax landmarks and the
    aligned crops, with the number of flips."""
    from gan_control_torch.alignment import align_u8_images, blazeface, depth, fan, sfd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images = smooth_images(ALIGN_PARITY_BATCH, 11).clamp(-1, 1)
    u8 = torch.clamp((images * 0.5 + 0.5) * 255.0, 0, 255).to(torch.uint8)
    with torch.no_grad():
        sd = sfd.read_reference_state_dict(paths["sfd"])
        det = {dev: sfd.make_sfd(sd, device=dev) for dev in ("cpu", "cuda")}
        want, got = det["cpu"].heads(u8), det["cuda"].heads(u8.cuda())
        errs = {}
        for i, ((cw, rw), (cg, rg)) in enumerate(zip(want, got)):
            errs[f"conf{i}"], errs[f"loc{i}"] = rel_err(cg, cw), rel_err(rg, rw)
        held(f"S3FD heads at {images.shape[2]} px", errs, PREDICTOR_RTOL)
        pw = torch.cat([F.softmax(c, 1)[:, 1].flatten(1) for c, _ in want], 1)
        pg = torch.cat([F.softmax(c, 1)[:, 1].flatten(1) for c, _ in got], 1).cpu()
        p_err = float((pw - pg).abs().max())
        dw, dg = det["cpu"].detect(u8), det["cuda"].detect(u8.cuda())
        flips = 0
        for w, g in zip(dw, dg):
            s = np.sort(w[:, 4])[::-1]
            margin = float(s[0] - s[1]) if len(s) > 1 else float("inf")
            same = len(g) == len(w) == 0 or (len(g) > 0 and len(w) > 0 and np.allclose(
                g[np.argmax(g[:, 4])], w[np.argmax(w[:, 4])], rtol=1e-3, atol=1e-3))
            if not same:
                flips += 1
                if margin > p_err:
                    fail(f"S3FD best box differs where its score margin {margin:.3g} exceeds the error {p_err:.3g}")
        log(f"alignment card vs cpu: S3FD kept boxes cpu {[len(w) for w in dw]} card {[len(g) for g in dg]}; "
            f"best box flips {flips} of {len(dw)} (face probability error {p_err:.3g}; a flip is allowed "
            f"only where the best two scores lie within it)")

        sd = blazeface.read_reference_state_dict(paths["blazeface"])
        bz = {dev: blazeface.make_blazeface(sd, device=dev) for dev in ("cpu", "cuda")}
        crops, _ = bz["cpu"].preprocess(u8.numpy())
        (bw, sw), (bg, sg) = bz["cpu"].raw(crops), bz["cuda"].raw(crops)
        held("BlazeFace raw boxes and scores",
             {"boxes": rel_err(torch.from_numpy(bg), torch.from_numpy(bw)),
              "scores": rel_err(torch.from_numpy(sg), torch.from_numpy(sw))}, PREDICTOR_RTOL)

        sd = fan.read_reference_state_dict(paths["fan"])
        fans = {dev: fan.make_fan(state_dict=sd, device=dev) for dev in ("cpu", "cuda")}
        center, scale = fan.box_to_center_scale((0.0, 0.0, images.shape[2], images.shape[1]))
        crop = fan.crop((images * 0.5 + 0.5).permute(0, 3, 1, 2), center, scale)
        hw, hg = fans["cpu"].net(crop), fans["cuda"].net(crop.cuda())
        held("FAN heatmaps (4 modules)", {f"module{i}": rel_err(g, w) for i, (w, g) in enumerate(zip(hw, hg))},
             PREDICTOR_RTOL)
        hm_err = float((hw[-1] - hg[-1].cpu()).abs().max())
        flat_w, flat_g = hw[-1].flatten(2), hg[-1].cpu().flatten(2)
        iw, ig = flat_w.argmax(-1), flat_g.argmax(-1)
        gap = flat_w.max(-1).values - flat_w.gather(-1, ig[..., None])[..., 0]
        flips = int((iw != ig).sum())
        if bool(((iw != ig) & (gap > hm_err)).any()):
            fail("FAN's argmax landmark differs where the heatmap margin exceeds the error")
        log(f"alignment card vs cpu: FAN argmax landmarks: {flips} flips of {iw.numel()} (heatmap error "
            f"{hm_err:.3g}; a flip is allowed only where the two peaks lie within it)")

        sd = depth.read_reference_state_dict(paths["depth"])
        coords = fan.decode_heatmaps(hw[-1]) * 4.0
        zw = depth.make_depth(state_dict=sd, device="cpu").predict(crop, coords)
        zg = depth.make_depth(state_dict=sd, device="cuda").predict(crop.cuda(), coords.cuda())
        held("depth net (3, 8, 36, 3)", {"z": rel_err(zg, zw)}, PREDICTOR_RTOL)

        lw, lg = fans["cpu"].get_landmarks(images), fans["cuda"].get_landmarks(images.cuda())
        aw, _ = align_u8_images(u8.numpy(), lw)
        ag, _ = align_u8_images(u8.numpy(), lg)
        equal_lm = [bool(np.array_equal(a, b)) for a, b in zip(lw, lg)]
        differ = [not np.array_equal(a, b) for a, b in zip(aw, ag)]
        if any(d and e for d, e in zip(differ, equal_lm)):
            fail("aligned crops differ for equal landmarks")
        log(f"alignment card vs cpu: landmarks equal in {sum(equal_lm)} of {len(lw)} images; aligned crops "
            f"differ in {sum(differ)} (only where the landmarks did)")


def alignment_phase(build_root: Path, model_dir: Path, unaligned: float | None,
                    seen: Counter, counts: dict) -> None:
    """Phase 19: reference-layout checkpoints; the sweep's command line with
    ``--align_3d``, once per detector; one aligned batch in-process with
    its launches; the nets card against CPU."""
    import argparse
    import shutil

    from gan_control_torch.inference.extract_controls import ControlExtractor
    from gan_control_torch.inference.inference import Inference
    from gan_control_torch.make_attributes_df import make_align_fn_of

    root = build_root / "alignment"
    if root.exists():
        shutil.rmtree(root)
    with Phase("alignment checkpoints"):
        paths = write_alignment_checkpoints(root)
        log("alignment checkpoints: " + ", ".join(f"{n} {p.stat().st_size / 2**20:.1f} MiB"
                                                   for n, p in paths.items()))
    for detector in ALIGN_DETECTORS:
        with Phase(f"alignment sweep {detector}"):
            aligned_sweep(detector, model_dir, paths, root, unaligned)
    with Phase("alignment batch in-process"):
        inf = Inference(model_dir, device="cuda")
        ns = argparse.Namespace(fan_weights=str(paths["fan"]), detector="sfd",
                                detector_weights=str(paths["sfd"]), depth_weights=str(paths["depth"]))
        align_fn = make_align_fn_of(ns, inf.device)
        extractor = ControlExtractor(inf.config["training_config"], align_fn=align_fn, align_3d=True,
                                     device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)

        def batch():
            z = torch.randn((SWEEP_BATCH, 512), generator=gen, device="cuda")
            img, _, _ = inf.gen_batch(batch_size=SWEEP_BATCH, normalize=False, latent=z, generator=gen)
            return extractor.extract_tensors(img)

        quiet = logging.getLogger("gan_control_torch.alignment")
        level = quiet.level
        quiet.setLevel(logging.ERROR)  # the command lines above logged each box without a crop window
        try:
            batch()
            got = launches_of(batch, seen)
        finally:
            quiet.setLevel(level)
        n_map, n_conv, n_up = g_counts(inf.model)
        want = row(n_map + n_conv, 0, n_up, 0)
        log(f"alignment batch: launches {got}, expected {want} (the G's; the alignment nets and the "
            f"predictors launch none of the port's kernels)")
        if got != want:
            fail("the aligned sweep batch's launches differ from the derived counts")
        add_counts(counts, got)
        del extractor, align_fn, inf
        torch.cuda.empty_cache()
    with Phase("alignment card vs cpu"):
        alignment_card_vs_cpu(paths)


def projection_card_vs_cpu() -> None:
    """Three projector steps of a size-32 model (``max_channels`` 32, noise
    weights 0.3) with LPIPS at random init, on the card and on the CPU from
    the same target, start, noises and draws, f32 with TF32 off: the latent
    and the noises to PROJ_PARITY_RTOL of each one's largest entry."""
    from gan_control_torch.models.factory import build_generator, build_group_spec
    from gan_control_torch.projection import Projector, make_lpips

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["model_config"].update(size=32, max_channels=32, mixed_precision=False)
    g0 = build_generator(config, build_group_spec(config), device="cpu", seed=0)
    with torch.no_grad():
        for m in g0.modules():
            if type(m).__name__ == "NoiseInjection":
                m.weight.fill_(0.3)
    rng = np.random.default_rng(13)
    target = smooth_images(1, 12, px=32).clamp(-1, 1)
    latent = torch.from_numpy(rng.standard_normal((1, g0.n_latent, 512)).astype(np.float32) * 0.3)
    noises = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in g0.noise_shapes(1)]
    draws = [torch.from_numpy(rng.standard_normal(latent.shape).astype(np.float32))
             for _ in range(PROJ_PARITY_STEPS)]
    out = []
    for dev in ("cpu", "cuda"):
        g = copy.deepcopy(g0).to(dev).requires_grad_(False)
        proj = Projector(lambda w, ns, _g=g: _g([w], input_is_latent=True, noise=ns)[0],
                         make_lpips(seed=1, device=dev), target.to(dev), latent.to(dev), g.noise_shapes(1),
                         steps=PROJ_PARITY_STEPS, latent_std=0.7, mse_weight=0.1, noises_init=noises,
                         draws=draws)
        losses = [float(proj.step(i)[0]) for i in range(PROJ_PARITY_STEPS)]
        out.append((losses, [t.detach().cpu() for t in (proj.latent, *proj.noises)]))
    (cpu_losses, want), (card_losses, got) = out
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    log(f"projection card vs cpu: {PROJ_PARITY_STEPS} steps at size 32, f32 TF32 off, the same draws: losses "
        f"cpu {[round(x, 6) for x in cpu_losses]} card {[round(x, 6) for x in card_losses]}; latent "
        f"error / max {errs[0]:.2e}, noises worst {max(errs[1:]):.2e} (tol {PROJ_PARITY_RTOL})")
    if max(errs) > PROJ_PARITY_RTOL or not all(bool(torch.isfinite(t).all()) for t in got):
        fail("projection: card and CPU disagree")


def projection_phase(build_root: Path, model_dir: Path, seen: Counter, counts: dict) -> None:
    """Phase 20: ``python -m gan_control_torch.project`` on the FFHQ-512
    directory (batch 1, a model-generated target, random LPIPS); in-process,
    ``get_avg_latent`` and PROJ_COUNTED_STEPS steps with their launches
    against the derived counts, the step's ms, device-busy share and peak;
    card against CPU at size 32."""
    import shutil

    from gan_control_torch.inference.inference import Inference
    from gan_control_torch.projection import Projector, get_avg_latent, make_lpips
    from gan_control_torch.projection.projection import downsample_to_256

    root = build_root / "projection"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    with Phase("projection command line"):
        t0 = time.perf_counter()
        lines = run_cli("gan_control_torch.project", ["--model_dir", str(model_dir), "--out", str(root / "out"),
                                                      "--steps", str(PROJ_STEPS)], root / "project.log", 900)
        wall = time.perf_counter() - t0
        text = "\n".join(lines)
        m = re.search(r"projection: loss (\S+) \(step (\d+)\) -> (\S+) \(step (\d+)\), (\d+) steps in ([\d.]+) s = "
                      r"([\d.]+) ms/step", text)
        peak = re.search(r"peak memory ([\d.]+) GiB", text)
        if not m or not peak or "no LPIPS weights" not in text:
            fail("project logged no result, peak or random-LPIPS line")
        hist = json.loads((root / "out" / "history.json").read_text())
        w = np.load(root / "out" / "projected_w_plus.npy")
        size = json.loads((model_dir / "args.json").read_text())["model_config"]["size"]
        n_latent = 2 * int(math.log2(size)) - 2
        if [h["step"] for h in hist] != list(range(0, PROJ_STEPS, 50)) or w.shape != (1, n_latent, 512) \
                or not np.isfinite(w).all() or not (root / "out" / "target_vs_projection.jpg").exists():
            fail(f"project's artifacts: history steps {[h['step'] for h in hist]}, w+ {w.shape}")
        log(f"projection command line: {m[5]} steps at batch 1, {size} px (random LPIPS, as the command says): "
            f"{m[7]} ms/step ({m[6]} s, the command {wall:.1f} s with start-up); loss {m[1]} at step {m[2]} -> "
            f"{m[3]} at step {m[4]}; peak {peak[1]} GiB; w+ {w.shape}")

    with Phase("projection in-process"):
        inf = Inference(model_dir, device="cuda")
        g = inf.model
        gen = torch.Generator(device="cuda").manual_seed(7)
        img01, _, _ = inf.gen_batch(batch_size=1, generator=gen)
        target = downsample_to_256(img01 * 2.0 - 1.0)
        lpips = make_lpips(seed=1, device="cuda")
        avg = {}

        def mean_w():
            avg["w"], avg["std"] = get_avg_latent(g.map_latent, torch.Generator(device="cuda").manual_seed(2))

        n_map, n_conv, n_up = g_counts(g)
        got = launches_of(mean_w, seen)
        log(f"projection get_avg_latent (10000 z): launches {got}, expected {row(n_map, 0, 0, 0)}")
        if got != row(n_map, 0, 0, 0):
            fail("get_avg_latent's launches differ from the derived counts")
        add_counts(counts, got)
        latent = avg["w"][None, None].expand(1, g.n_latent, 512).contiguous()
        total = PROJ_COUNTED_STEPS + 1 + 2 * PROJ_TIMED_STEPS
        proj = Projector(lambda w_, ns: g([w_], input_is_latent=True, noise=ns)[0], lpips, target, latent,
                         g.noise_shapes(1), steps=total, latent_std=avg["std"], mse_weight=0.1,
                         generator=torch.Generator(device="cuda").manual_seed(0))
        want = row(n_conv, n_conv, n_up, n_up)
        for i in range(PROJ_COUNTED_STEPS):
            got = launches_of(lambda: proj.step(i), seen)
            if got != want:
                fail(f"projector step {i}: launches {got}, expected {want}")
            add_counts(counts, got)
        log(f"projection step: launches {want} each of {PROJ_COUNTED_STEPS} steps, as derived (StyledConvs "
            f"{n_conv}: fused_bias_act and its gradient; ToRGB skips {n_up}: blur2x_up and blur2x_down; the "
            f"mapping does not run on w+)")
        steps = iter(range(PROJ_COUNTED_STEPS, total))
        torch.cuda.reset_peak_memory_stats()
        times = synced_ms(lambda: proj.step(next(steps)), PROJ_TIMED_STEPS)
        med = statistics.median(times)
        log(f"projection step (batch 1, {str(g.dtype)[6:]} synthesis at {g.size} px, LPIPS at {min(g.size, 256)} px f32): median "
            f"{med:.2f} ms over {len(times)} synced steps {[round(t, 2) for t in times]}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        profile_phase("projection step", lambda: proj.step(next(steps)), med)
        del proj, lpips, inf, g
        torch.cuda.empty_cache()
    with Phase("projection card vs cpu"):
        projection_card_vs_cpu()


# ---------------------------------------------------------------------------
# data parallelism across processes (this slice)
# ---------------------------------------------------------------------------

DIST_ITERS = 2  # train_generator over two ranks; iteration 0 runs all four steps (cut from 3 for phase 25)
DIST_PLAIN_ITERS = (1, 2, 3)  # d_step + g_step only
DIST_SWEEP_ROWS = 80  # two batches of SWEEP_BATCH (cut from four for phase 23, PERF.md §4)
DIST_CTRL_ITERS = 20
DIST_CTRL_EVAL = 10  # min_evaluate_interval of the two-rank controller run
# the two-rank sweep against the one-process sweep of the same directory in
# f32 (the same f32 nets at batch 20 against 40 on the card): as the CPU test
# bounds them
DIST_LATENT_RTOL = 1e-5
DIST_PREDICTOR_RTOL = 1e-4
# the sweep's columns whose random-init nets move with the batch size alone
# in f32 on the card (ArcFace's embedding by up to 0.824 of its largest
# entry, DEX's age by 0.0246, at batch 20 against 40 in one process on an
# H100 80GB HBM3 at 700 W): column -> loss block. They are held to the
# sweep replayed at the ranks' batch, not to the one-process sweep, and
# only while the same nets on fixed images move by no more than
# DIST_F64_BATCH_RTOL between the two batch sizes in float64, where
# rounding is 2**29 times smaller than in f32 and an op that couples rows
# would move them as much as in f32
DIST_BATCH_SENSITIVE = {"arcface_emb": "embedding_loss", "age": "age_loss"}
DIST_F64_BATCH_RTOL = 1e-6
# the two-rank controller after DIST_CTRL_ITERS steps against one process,
# relative to each tensor's largest entry: each step's gradients agree to
# 1e-5 (the CPU test's bound on one step), and Adam with b1 = 0 divides each
# gradient by its own running RMS, so a gradient's relative error passes
# into its update whole and the 20 updates' errors add
DIST_CTRL_RTOL = 1e-4


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn, world: int, local_world: int, port: int, *args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(local_world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    # every rank is on this machine, which may have no network: NCCL's
    # bootstrap goes over the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    fn(rank, *args)


def spawn_ranks(fn, world: int, *args, join: bool = True):
    """``fn(rank, *args)`` in ``world`` processes on this machine's one card,
    each with torchrun's environment (so the ranks share the card over
    gloo; one rank runs NCCL). A rank that fails raises here, or, with
    ``join`` false, in :func:`join_ranks` of the context returned."""
    import torch.multiprocessing as mp

    return mp.start_processes(_rank_entry, args=(fn, world, world, free_port(), *args), nprocs=world,
                              start_method="spawn", join=join)


def join_ranks(context) -> None:
    while not context.join():
        pass


class SmallNet(torch.nn.Module):
    """A small frozen contrastive "predictor" (conv, mean pool, linear)."""

    def __init__(self, seed: int = 5):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.conv = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.fc = torch.nn.Linear(8, 16)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)

    def forward(self, x):
        y = torch.relu(self.conv(x.to(self.conv.weight.dtype).permute(0, 3, 1, 2)))
        return self.fc(y.mean(dim=(2, 3))).float()


def parity_steps(rank: int, world: int, device) -> dict:
    """Phase 21a's steps: each of the four steps from one size-32 state
    (configs/ffhq.json at size 32, max_channels 64, batch 16 in its 7-group
    arrangement, f32, TF32 off, injection-noise weights 0.3, ADA adaptive
    from p 0.3, a SmallNet contrastive loss on the ``id`` group, style
    mixing in d_step and g_reg_step) on the rank's rows of seeded inputs.
    Each step's gradients (on the CPU) and metrics, and d_step's ``ada_p``.
    Each step starts from the same state, as phase 9's do: after a first
    Adam step (b1 = 0, an update of about ``lr * sign(g)``) a gradient entry
    that cuDNN's nondeterministic algorithms put on either side of 0 moves
    its parameter by 2 lr, so on the card steps in a row do not repeat even
    in one process, and the next step's gradients move by percents of
    their largest entries."""
    from gan_control_torch.losses.contrastive import ContrastiveConfig, pairwise_sq_l2
    from gan_control_torch.models.factory import build_discriminator, build_generator, build_group_spec
    from gan_control_torch.training import ada
    from gan_control_torch.training import train_step as ts
    from gan_control_torch.training.state import init_gan_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["model_config"].update(size=32, max_channels=64, mixed_precision=False)
    tc = config["training_config"]
    spec = build_group_spec(config)
    b = tc["batch"]
    cfg = ts.TrainStepConfig(batch=b, mini_batch=tc["mini_batch"], ada_enabled=True)
    g0 = build_generator(config, spec, device=device, seed=0)
    with torch.no_grad():
        for m in g0.modules():
            if type(m).__name__ == "NoiseInjection":
                m.weight.fill_(0.3)
    d0 = build_discriminator(config, device=device, seed=1)
    rng = np.random.default_rng(7)

    def rows(shape, scale=1.0):
        full = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale)
        n = shape[0] // world
        return full[rank * n : (rank + 1) * n].to(device)

    real = rows((b, 32, 32, 3), 0.5)
    z_d, z_g = [rows((b, 512)), rows((b, 512))], [rows((b, 512))]
    z_reg = [rows((b // 2, 512)), rows((b // 2, 512))]
    ccfg = ContrastiveConfig(intermediate_weights=(), last_layer_weight=1.0, lower_thres=(),
                             upper_thres=(), last_lower_thres=0.5, last_upper_thres=40.0,
                             focus_on=("same_as_last_layer",))
    battery = (ts.AttributeLossSpec(name="small_loss", group="id", cfg=ccfg,
                                    feature_fn=lambda m, imgs: [m(imgs)], dist_fn=pairwise_sq_l2),)
    nets = {"small_loss": SmallNet().to(device).requires_grad_(False)}
    runs = {
        "d_step": lambda st: ts.d_step(st, cfg, spec, real, z_d, augment_fn=ada.augment),
        "d_reg_step": lambda st: ts.d_reg_step(st, cfg, real),
        "g_step": lambda st: ts.g_step(st, cfg, spec, z_g, attr_losses=battery, predictors=nets,
                                       augment_fn=ada.augment),
        "g_reg_step": lambda st: ts.g_reg_step(st, cfg, z_reg),
    }
    out = {}
    for kind, run in runs.items():
        st = init_gan_state(copy.deepcopy(g0), copy.deepcopy(d0), tc)
        st.ada_p = torch.tensor(0.3, device=device)
        metrics = {k: float(v) for k, v in run(st).items()}
        mod = st.discriminator if kind.startswith("d_") else st.generator
        out[kind] = (metrics, {n: p.grad.detach().cpu() for n, p in mod.named_parameters()})
    out["ada_p"] = out["d_step"][0]["ada_p"]
    return out


def parity_rank(rank: int, out_dir: str) -> None:
    from gan_control_torch.utils import multihost
    from gan_control_torch.utils.device import resolve_device

    _, world = multihost.initialize()
    res = parity_steps(rank, world, resolve_device(None))
    res["backend"] = torch.distributed.get_backend()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def params_digest(*modules) -> str:
    import hashlib

    h = hashlib.sha256()
    for m in modules:
        for k, v in m.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def ffhq_rank(rank: int, out_dir: str, config_path: str) -> None:
    """Phase 21b on one rank: ``train_generator --iters DIST_ITERS`` (its
    ``main``, as torchrun runs it) with each step's launches and collectives
    recorded; then the parameters' digest and plain iterations' ms."""
    from gan_control_torch import train_generator
    from gan_control_torch.data.datasets import synthetic_data_loader
    from gan_control_torch.ops import kernels
    from gan_control_torch.trainers import generator_trainer as gt
    from gan_control_torch.utils import collectives
    from gan_control_torch.utils.device import resolve_device

    resolve_device(None)  # the rank's card becomes the current device
    trainers = []
    close = gt.GeneratorTrainer.close

    def keep(self):
        trainers.append(self)
        close(self)

    gt.GeneratorTrainer.close = keep
    by_kind, restore = count_by_kind(gt)
    records: list = []
    by_step: dict[str, list] = {k: [] for k in gt.STEP_KINDS}
    inner = {k: getattr(gt, k) for k in gt.STEP_KINDS}

    def with_collectives(kind, fn):
        def run(*a, **kw):
            n = len(records)
            out = fn(*a, **kw)
            by_step[kind].append(records[n:])
            return out
        return run

    for k in gt.STEP_KINDS:
        setattr(gt, k, with_collectives(k, inner[k]))
    seen: Counter = Counter()
    remove_seen = install_launch_recorder(seen)
    torch.cuda.reset_peak_memory_stats()
    try:
        with collectives.recording(records, timed=True):
            kernels.reset_launch_counts()
            train_generator.main(["--config_path", config_path, "--iters", str(DIST_ITERS)])
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
    finally:
        remove_seen()
        for k in gt.STEP_KINDS:
            setattr(gt, k, inner[k])
        restore()
        gt.GeneratorTrainer.close = close
    tr = trainers[0]
    st = tr.state
    expected = expected_step_counts(st.generator, st.discriminator, len(tr.spec.groups))
    digest, step = params_digest(st.generator, st.discriminator, st.g_ema), st.step
    real = tr._to_device(next(synthetic_data_loader(tr.step_cfg.batch, tr.mc["size"], seed=1, shard_index=rank,
                                                    num_shards=tr.world)))
    plain = []
    for i in DIST_PLAIN_ITERS:
        torch.cuda.synchronize()
        collectives.barrier()
        t0 = time.perf_counter()
        tr.one_iteration(i, real)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    torch.save({"digest": digest, "by_kind": by_kind,
                "expected": expected, "counts": counts, "seen": seen, "by_step": by_step,
                "plain_ms": plain, "metrics": tr.metrics_history, "step": step,
                "save_dir": tr.save_dir, "world": tr.world, "backend": torch.distributed.get_backend(),
                "local_batch": real.shape[0], "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "params": {"G": sum(p.numel() for p in st.generator.parameters()),
                           "D": sum(p.numel() for p in st.discriminator.parameters())}},
               Path(out_dir) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def collectives_text(calls: list) -> str:
    """One step's collectives (``collectives.Call``s): count, payload MB per
    rank and ms, by op."""
    parts = []
    for op in dict.fromkeys(c.op for c in calls):
        sel = [c for c in calls if c.op == op]
        parts.append(f"{op} {len(sel)} calls {sum(c.nbytes for c in sel) / 1e6:.3f} MB "
                     f"{sum(c.ms or 0.0 for c in sel):.2f} ms")
    return ", ".join(parts) or "none"


def max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


def replay_sweep(model_dir: Path) -> tuple[dict, torch.Tensor, object]:
    """The sweep of DIST_SWEEP_ROWS rows (seed 0, batches of SWEEP_BATCH) as
    the two ranks compute it: each batch's z drawn whole, then each half
    through ``gen_batch`` (the static noise drawn after z) and the
    predictors at half the batch, under the command line's TF32 defaults.
    The columns as the table has them, the first batch's images (its
    halves joined) and the extractor."""
    from gan_control_torch.inference.extract_controls import ControlExtractor
    from gan_control_torch.inference.inference import Inference

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Inference(model_dir, device="cuda")
    extractor = ControlExtractor(model.config["training_config"], device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    half = SWEEP_BATCH // 2
    cols: dict[str, list] = {}
    first = []
    for b in range(DIST_SWEEP_ROWS // SWEEP_BATCH):
        z = torch.randn((SWEEP_BATCH, model.style_dim), generator=gen, device=gen.device)
        after_z = gen.get_state()
        for rows in (slice(0, half), slice(half, SWEEP_BATCH)):
            gen.set_state(after_z)
            img, latent, latent_w = model.gen_batch(batch_size=half, normalize=False, latent=z[rows],
                                                    generator=gen)
            if b == 0:
                first.append(img)
            batch = {"latents": latent, "latents_w": latent_w[:, 0], **extractor.extract_tensors(img)}
            for name, t in batch.items():
                cols.setdefault(name, []).append(t.detach().cpu().numpy())
    return {k: np.concatenate(v) for k, v in cols.items()}, torch.cat(first), extractor


def net_batch_witness(extractor, images: torch.Tensor) -> dict:
    """The nets of DIST_BATCH_SENSITIVE on ``images`` (one sweep batch) at
    the whole batch against its two halves: in f32 as the sweep runs them
    (TF32 convolutions), in f32 with cuDNN off (ATen's convolutions take
    one image at a time) and in float64. Column -> reading -> (the halves
    against the whole batch, the whole batch against float64's), each the
    largest error over the largest entry."""
    from gan_control_torch.losses.predictors import predictor_module

    half = images.shape[0] // 2
    out = {}
    for col, loss in DIST_BATCH_SENSITIVE.items():
        model, pm = extractor.models[loss], predictor_module(loss)

        @torch.no_grad()
        def run(x):
            whole = pm.predict(model, x)
            halves = torch.cat([pm.predict(model, x[:half]), pm.predict(model, x[half:])])
            return whole.double().cpu().numpy(), halves.double().cpu().numpy()

        readings = {}
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            readings["f32"] = run(images.float())
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            readings["f32 cuDNN off"] = run(images.float())
        readings["float64"] = run(images.double())
        exact = readings["float64"][0]
        out[col] = {k: (max_rel(halves, whole), max_rel(whole, exact)) for k, (whole, halves) in readings.items()}
    return out


def parity_start(root: Path, worlds) -> dict:
    """Phase 21a's ranks at each world size in ``worlds`` (one rank over
    NCCL; more share the card over gloo), all started at once."""
    started = {}
    for world in worlds:
        out = root / f"parity{world}"
        out.mkdir()
        started[world] = (out, spawn_ranks(parity_rank, world, str(out), join=False))
    return started


def parity_ranks(started: dict) -> None:
    """Phase 21a: each step of ``parity_steps`` on the ranks of
    :func:`parity_start` against this process at the full batch."""
    want = parity_steps(0, 1, torch.device("cuda"))
    for world, (out, context) in started.items():
        join_ranks(context)
        for r in range(world):
            got = torch.load(out / f"rank{r}.pt", weights_only=False)
            for kind in ("d_step", "d_reg_step", "g_step", "g_reg_step"):
                (mw, gw), (mg, gg) = want[kind], got[kind]
                loss_err = max(abs(mw[k] - mg[k]) / max(1.0, abs(mw[k])) for k in mw)
                worst, worst_name = worst_grad_err(gw, gg)
                log(f"distributed parity: world {world} ({got['backend']}) rank {r} {kind}: "
                    f"{len(gw)} gradients, worst rel err {worst:.3g} ({worst_name}), losses "
                    f"{mg} worst rel err {loss_err:.3g} (tol {TRAIN_PARITY_RTOL})")
                if mw.keys() != mg.keys() or loss_err > TRAIN_PARITY_RTOL or worst > TRAIN_PARITY_RTOL:
                    fail(f"distributed parity: world {world} rank {r} {kind} disagrees")
            if got["ada_p"] != want["ada_p"] or want["ada_p"] == 0.3:
                fail(f"distributed parity: ada_p {got['ada_p']} against {want['ada_p']}")
            want_backend = "gloo" if world > torch.cuda.device_count() else "nccl"
            if got["backend"] != want_backend:
                fail(f"distributed parity: world {world} ran {got['backend']}, expected {want_backend}")


def ffhq_ranks(root: Path, world: int) -> list[dict]:
    """Phase 21b at ``world`` ranks (sharing the card over gloo): ``ffhq_rank`` on
    configs/ffhq.json with the synthetic loader; the ranks' parameters
    bitwise equal and their launches per step as derived; the collectives
    and plain iterations logged. Returns each rank's results."""
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["results_dir"] = str(root / f"train_results{world}")
    config["data_config"] = {"data_set_name": "synthetic"}
    config_path = root / f"ffhq_{world}_ranks.json"
    config_path.write_text(json.dumps(config, indent=2))
    out = root / f"ffhq{world}"
    out.mkdir()
    spawn_ranks(ffhq_rank, world, str(out), str(config_path))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]
    a = ranks[0]
    backend = "gloo" if world > torch.cuda.device_count() else "nccl"
    layout = f"{world} ranks ({backend}, {min(world, torch.cuda.device_count())} cards)"
    for res in ranks:
        if res["digest"] != a["digest"] or res["metrics"] != a["metrics"] or res["step"] != DIST_ITERS:
            fail(f"distributed train_generator: {layout}: parameters, metrics or steps differ")
        if (res["world"], res["backend"], res["local_batch"]) != (world, backend, 16 // world):
            fail(f"distributed train_generator: world {res['world']} backend {res['backend']}, "
                 f"local batch {res['local_batch']}")
        for kind, calls in res["by_kind"].items():
            for got in calls:
                if got != res["expected"][kind]:
                    fail(f"distributed {kind}: launches {got}, expected {res['expected'][kind]}")
        if not all(math.isfinite(v) for h in res["metrics"] for v in h.values()):
            fail(f"distributed train_generator: metrics not finite {res['metrics']}")
    runs = {k: len(v) for k, v in a["by_kind"].items()}
    if runs != {"d_step": DIST_ITERS + 1, "d_reg_step": 2, "g_step": DIST_ITERS + 1, "g_reg_step": 2}:
        fail(f"distributed train_generator: step kinds run {runs}")
    ckpts = sorted(p.name for p in (a["save_dir"] / "checkpoint").iterdir())
    log(f"distributed train_generator: {layout}, local batch {16 // world} of 16, {DIST_ITERS} "
        f"iterations after the dry run; parameters bitwise equal (sha256 {a['digest'][:16]}); launches "
        f"per rank per step as expected_step_counts ({runs}); checkpoints {ckpts}; params G "
        f"{a['params']['G']} D {a['params']['D']}; peak per rank {[round(r['peak_gib'], 2) for r in ranks]} GiB")
    log(f"distributed metrics: {a['metrics']}")
    for kind, calls in a["by_step"].items():
        for c in calls:
            log(f"distributed collectives: {layout}, rank 0 {kind}: {collectives_text(c)}")
    for r, res in enumerate(ranks):
        log(f"distributed plain iteration (d_step + g_step), {layout}: rank {r} median "
            f"{statistics.median(res['plain_ms']):.2f} ms ({[round(t, 2) for t in res['plain_ms']]})")
    return ranks


def distributed_phase(build_root: Path) -> tuple[Counter, dict]:
    """Phase 21. Returns the launches that rank 0 recorded in (b) by (kernel,
    shape, dtype, static args), and (b)'s launch counts over both ranks."""
    import shutil

    from gan_control_torch.data.dataframe import read_table
    from gan_control_torch.trainers.controller_trainer import ControllerTrainer
    from gan_control_torch.utils import checkpoint as ckpt_lib
    from gan_control_torch.utils.flax_bridge import flax_to_state_dict

    root = build_root / "distributed"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)

    # (a), (c) and (d) check results and time nothing: their processes run
    # at once, while this process computes what they are held to; (b)
    # times its ranks and runs alone after them
    model_dir = build_root / "phase2" / "controller" / "generator"
    f32_dir = root / "generator_f32"
    shutil.copytree(model_dir, f32_dir)
    args = json.loads((f32_dir / "args.json").read_text())
    args["model_config"]["mixed_precision"] = False
    (f32_dir / "args.json").write_text(json.dumps(args, indent=2))
    table_path = build_root / "attributes.npz"
    cfg = controller_config(model_dir, table_path, root / "controllers")
    cfg["training_config"].update(min_evaluate_interval=DIST_CTRL_EVAL, save_nets_interval=10**6)
    cfg_path = root / "age_controller_two_ranks.json"
    cfg_path.write_text(json.dumps(cfg, indent=2))
    with Phase("distributed parity, sweep and controller (their processes at once)"):
        # (a) size-32 parity: two ranks over gloo on the one card, one over NCCL
        parity = parity_start(root, (2, 1))
        # (c) the attribute sweep over two ranks against one process, on
        # phase 10's directory with an f32 synthesis: in bf16 the synthesis
        # at batch 20 and 40 differs by bf16 rounding, and the random-init
        # predictors (DEX's one-hot softmax) turn that into whole classes
        sweeps = {}
        for label, launcher in (("one process", []),
                                ("two ranks", ["torch.distributed.run", "--standalone", "--nproc_per_node=2"])):
            path = root / f"attributes_{label.replace(' ', '_')}.npz"
            cmd = ["--model_dir", str(f32_dir), "--batch_size", str(SWEEP_BATCH), "--number_of_samples",
                   str(DIST_SWEEP_ROWS), "--save_path", str(path)]
            if launcher:
                run = start_cli(launcher[0], [*launcher[1:], "-m", "gan_control_torch.make_attributes_df", *cmd],
                                root / "make_attributes_df_two_ranks.log")
            else:
                run = start_cli("gan_control_torch.make_attributes_df", cmd, root / "make_attributes_df.log")
            sweeps[label] = (path, run)
        # (d) train_controller over two ranks against one process
        ctrl_run = start_cli("torch.distributed.run",
                             ["--standalone", "--nproc_per_node=2", "-m", "gan_control_torch.train_controller",
                              "--config_path", str(cfg_path), "--iters", str(DIST_CTRL_ITERS)],
                             root / "train_controller.log")

        # the whole sweep again in this process, at the ranks' batch: each
        # half through the G and the predictors alone, from the same draws
        replay, images, extractor = replay_sweep(f32_dir)
        witness = net_batch_witness(extractor, images)
        del extractor, images
        tr = ControllerTrainer(config=cfg, init_dirs=False, device="cuda")
        tr.train(DIST_CTRL_ITERS)
        want = {k: v.detach().cpu() for k, v in tr.controller.state_dict().items()}

        parity_ranks(parity)

        tables = {}
        for label, (path, run) in sweeps.items():
            lines = finish_cli(run, 900)
            rate = re.search(r"swept \d+ rows in [\d.]+ s \(([\d.]+) rows/s", "\n".join(lines))
            tables[label] = read_table(path)
            log(f"distributed sweep: {label}: make_attributes_df --batch_size {SWEEP_BATCH} --number_of_samples "
                f"{DIST_SWEEP_ROWS} (f32 synthesis, beside the other processes of 21a, c and d): "
                f"{rate[1] if rate else 'no'} rows/s")
        got, one = tables["two ranks"], tables["one process"]
        if list(got) != list(one) or any(got[c].shape != one[c].shape for c in one):
            fail(f"distributed sweep: columns {list(got)} against {list(one)}")

        def err(col, a, b):  # the vote: rows that differ; else the error over the largest entry
            return int((a != b).sum()) if col == "expression_q" else max_rel(a, b)

        rel = {col: (err(col, got[col], w), err(col, got[col], replay[col])) for col, w in one.items()}
        log(f"distributed sweep: per column over all {DIST_SWEEP_ROWS} rows, two ranks against one process / "
            f"two ranks against this process at batch {SWEEP_BATCH // 2}; the largest error over the largest "
            f"entry, rows for expression_q: " + ", ".join(f"{c} {a:.3g} / {r:.3g}" for c, (a, r) in rel.items()))
        for col, (a, r) in rel.items():
            tol = 0 if col == "expression_q" else DIST_LATENT_RTOL if col.startswith("latents") \
                else DIST_PREDICTOR_RTOL
            if r > tol or (col not in DIST_BATCH_SENSITIVE and a > tol):
                fail(f"distributed sweep: {col} errors {a:.3g} / {r:.3g} against {tol}")
        for col, readings in witness.items():
            log(f"distributed sweep: {col} on one batch's images, {SWEEP_BATCH // 2} + {SWEEP_BATCH // 2} rows "
                f"against {SWEEP_BATCH} / {SWEEP_BATCH} rows against float64's: " + ", ".join(
                    f"{k} {h:.3g} / {e:.3g}" for k, (h, e) in readings.items())
                + f" (float64's batch shift tol {DIST_F64_BATCH_RTOL})")
            if readings["float64"][0] > DIST_F64_BATCH_RTOL:
                fail(f"distributed sweep: {col} moves with the batch size in float64: a net couples rows")

        lines = finish_cli(ctrl_run, 900)
        heads = sorted((root / "controllers").glob("age_*"))
        if len(heads) != 1:
            fail(f"distributed controller: head directories {heads}")
        ckpts = sorted(p.name for p in (heads[0] / "checkpoint").glob("*.ckpt"))
        if ckpts != [f"{DIST_CTRL_ITERS:06d}.ckpt"]:
            fail(f"distributed controller: checkpoints {ckpts}")
        got = flax_to_state_dict(ckpt_lib.load_state_dict(heads[0] / "checkpoint" / ckpts[0])["controller"])
        worst, worst_name = worst_grad_err(want, got)
        logged = [m for m in (re.search(r"controller iter (\d+): (\{.*\})", ln) for ln in lines) if m]
        by_iter = {}
        for m in logged:
            by_iter.setdefault(int(m[1]), {k: float(v) for k, v in re.findall(r"'(\w+)': ([-\w.+]+)", m[2])})
        metric_err = max(abs(by_iter[h["iter"]][k] - h[k]) / max(abs(h[k]), 1e-12)
                         for h in tr.metrics_history for k in h if k != "iter")
        log(f"distributed controller: torchrun --nproc_per_node=2 train_controller --iters {DIST_CTRL_ITERS} "
            f"(batch {cfg['training_config']['batch']}, latent_rec): the head against one process, worst rel "
            f"err {worst:.3g} ({worst_name}); metrics at {sorted(by_iter)} worst rel err {metric_err:.3g} "
            f"(tol {DIST_CTRL_RTOL})")
        if sorted(by_iter) != [h["iter"] for h in tr.metrics_history] or worst > DIST_CTRL_RTOL \
                or metric_err > DIST_CTRL_RTOL:
            fail("distributed controller: two ranks and one process disagree")
        del tr

    # (b) FFHQ-512 train_generator over two ranks sharing the card
    with Phase("distributed train_generator"):
        ranks = ffhq_ranks(root, 2)
    seen = ranks[0]["seen"] + ranks[1]["seen"]
    counts = {n: sum(res["counts"][n] for res in ranks) for n in KERNELS}
    if counts != {n: sum(c for key, c in seen.items() if key[0] == n) for n in KERNELS}:
        fail(f"distributed train_generator: launch hooks disagree with the counters {counts}")
    return seen, counts


# ---------------------------------------------------------------------------
# the blob world, the marge mapping and meshed serving (phase 22)
# ---------------------------------------------------------------------------

BLOB_ITERS = 600  # convergence's default
BLOB_EVAL_EVERY = 100
# control_fidelity: phase-1 iterations, each head's iterations, table rows
# (the heads and rows cut from the harness's 2000 / 4096, whose committed
# card run is gan_control_torch/tools/results/control_fidelity.jsonl).
# Phase 1 keeps the harness's 1000: at 400 the colour spans fell to
# 0.05-0.10, one run under the verdict's 0.05, and the heads' iterations
# (600 to 2000) did not move them (PERF.md §6)
FIDELITY = (1000, 600, 2048)
MARGE_REPS = 5
MESH = ("cuda:0", "cuda:0")  # two replicas sharing the one card
MESH_BUCKETS = (2, 8, 64)
MESH_F32_BUCKETS = (2, 8)
MESH_SIZES = (5, 8, 64)  # 5 pads to bucket 8 (4 + 1 rows over the replicas)
MESH_LATENCY_SIZES = (8, 64)
MESH_REQUESTS = 10
# each replica's rows against one device at the replica's batch, f32 with
# TF32 off and cuDNN's deterministic algorithms (the JAX package's bound for
# meshed against one-device serving)
MESH_RTOL = 2e-5


def blob_counts(iters: int, eval_every: int) -> dict:
    """The port's kernel launches of ``convergence.run(iters, eval_every)``,
    derived from the blob model's modules: each step kind as
    ``expected_step_counts`` derives it, on the trainer's cadence (R1 when
    ``i % 16 == 0``, path length when ``i % 4 == 0``), and the evaluations'
    forwards (at initialisation and every ``eval_every``: two generators,
    four sweeps of four chunks each; the toy battery launches none)."""
    from gan_control_torch.models.factory import build_discriminator, build_generator, build_group_spec
    from gan_control_torch.tools import convergence

    config = convergence.toy_config(iters)
    g = build_generator(config, build_group_spec(config), device="cpu")
    d = build_discriminator(config, device="cpu")
    per = expected_step_counts(g, d, 2)
    n_map, n_conv, n_up = g_counts(g)
    tc = config["training_config"]
    runs = {"d_step": iters, "g_step": iters,
            "d_reg_step": sum(i % tc["d_reg_every"] == 0 for i in range(iters)),
            "g_reg_step": sum(i % tc["g_reg_every"] == 0 for i in range(iters))}
    forwards = (1 + iters // eval_every) * 2 * 4 * (convergence.N_EVAL // convergence.EVAL_CHUNK)
    total = {n: forwards * c for n, c in row(n_map + n_conv, 0, n_up, 0).items()}
    for kind, times in runs.items():
        for n, c in per[kind].items():
            total[n] += times * c
    return total


def blob_child(which: str, out: str) -> None:
    """Runs in a fresh interpreter (``python -c``, from :func:`blob_phase`):
    one blob-world harness on the card, ``which`` "convergence" (bf16, 600
    iterations) or "fidelity" (FIDELITY), with the launch recorder on and
    the counters set to 0 just before it and read just after. Writes its
    records, counts, recorded shapes and seconds to the JSON file ``out``."""
    from gan_control_torch.tools import control_fidelity, convergence

    root = Path(out).parent
    records: list = []
    if which == "convergence":
        def run():
            records.extend(convergence.run(iters=BLOB_ITERS, eval_every=BLOB_EVAL_EVERY, seed=0,
                                           out_path=root / "convergence_bf16.jsonl", bf16=True))
    else:
        iters, ctrl_iters, rows = FIDELITY

        def run():
            records.extend(control_fidelity.run(iters=iters, ctrl_iters=ctrl_iters, n_samples=rows,
                                                workdir=root / "ctrl_fid", out_path=root / "control_fidelity.jsonl"))
    seen: Counter = Counter()
    t0 = time.perf_counter()
    counts = launches_of(run, seen)
    Path(out).write_text(json.dumps({
        "records": records, "counts": counts, "seconds": time.perf_counter() - t0,
        "seen": [[n, list(shape), str(dtype), args, c] for (n, shape, dtype, args), c in seen.items()]}))


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def start_blob_children(build_root: Path, whiches: tuple[str, ...]) -> dict:
    """Phase 22a-b's processes (:func:`blob_child`), each in a directory of
    its own under ``build/.../blob``: each harness is host-bound and the
    card idles ~90 % of a plain iteration, so they run beside other phases.
    Returns {which: process}."""
    import atexit
    import shutil

    procs = {}
    for which in whiches:
        root = build_root / "blob" / which
        if root.exists():
            shutil.rmtree(root)
        root.mkdir(parents=True)
        with open(root / f"{which}.log", "w") as f:
            procs[which] = subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.blob_child({which!r}, "
                 f"{str(root / (which + '.json'))!r})"], stdout=f, stderr=subprocess.STDOUT, cwd=REPO)
        atexit.register(procs[which].kill)
    return procs


def blob_phase(build_root: Path, procs: dict, seen: Counter, counts: dict) -> None:
    """Phase 22a-b: waits for the two blob-world processes and checks what
    they wrote; then times plain iterations of a fresh blob trainer."""
    from gan_control_torch.tools import control_fidelity, convergence

    res = {}
    with Phase("blob-world harnesses, the wait for their processes"):
        try:
            for which, proc in procs.items():
                rc = proc.wait(timeout=1100)
                root = build_root / "blob" / which
                if rc != 0:
                    tail = (root / f"{which}.log").read_text().splitlines()[-30:]
                    fail(f"the blob-world {which} process exited {rc}; last lines:\n" + "\n".join(tail))
                res[which] = json.loads((root / f"{which}.json").read_text())
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    for r in res.values():
        for n, shape, dtype, args, c in r["seen"]:
            seen[(n, tuple(shape), getattr(torch, dtype.split(".")[1]), _tuples(args))] += c

    records, got = res["convergence"]["records"], res["convergence"]["counts"]
    v = convergence.verdict(records)
    want = blob_counts(BLOB_ITERS, BLOB_EVAL_EVERY)
    log(f"blob convergence bf16 first record: {json.dumps(records[0])}")
    log(f"blob convergence bf16 last record: {json.dumps(records[-1])}")
    log(f"blob convergence bf16: {BLOB_ITERS} iterations and {len(records)} evaluations in "
        f"{res['convergence']['seconds']:.1f} s ({1e3 * records[-1]['seconds'] / BLOB_ITERS:.2f} ms per "
        f"iteration with the evaluations, host clock, beside the control-fidelity process and (c)-(d)); verdict "
        f"{json.dumps(v)}; launches {got}, derived {want}")
    if got != want:
        fail(f"the blob-world run launched {got}, derived {want}")
    if not convergence.passed(v):
        fail(f"blob-world convergence missed the JAX harness's verdict: {v}")
    add_counts(counts, got)

    out, got = res["fidelity"]["records"], res["fidelity"]["counts"]
    iters, ctrl_iters, rows = FIDELITY
    last = 0.0
    for rec in out[:-1]:
        log(f"control fidelity stage {rec['stage']}: {rec['seconds'] - last:.1f} s "
            + json.dumps({k: v for k, v in rec.items() if k not in ("stage", "seconds")}))
        last = rec["seconds"]
    v = out[-1]
    log(f"control fidelity ({iters} / {ctrl_iters} iterations, {rows} rows): {res['fidelity']['seconds']:.1f} s; "
        f"Spearman means color {v['color_spearman_means']} position {v['position_spearman_means']}; verdict "
        f"{json.dumps(v)}; launches {got}")
    if not control_fidelity.passed(v):
        fail(f"control fidelity missed its verdict: {v}")
    if not all(got[n] for n in GD_KERNELS):
        fail(f"the control-fidelity run left a kernel unlaunched: {got}")
    add_counts(counts, got)

    with Phase("blob-world plain iterations"):
        trainer = convergence.make_trainer(BLOB_ITERS, 0, torch.device("cuda"), bf16=True)
        trainer.one_iteration(0)  # every step kind once, outside the timing
        ms = plain_iteration_ms(trainer)
        log(f"blob plain iteration (d_step + g_step, bf16, batch {convergence.BATCH}): "
            f"{[round(m, 3) for m in ms]} ms (synced), median {statistics.median(ms):.3f} ms")
        profile_phase("blob plain iteration", lambda: trainer.one_iteration(7), statistics.median(ms))
        trainer.close()


def marge_config(size: int | None = None) -> dict:
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["model_config"].update(split_fc=False, marge_fc=True)
    if size is not None:
        config["model_config"].update(size=size, max_channels=64, mixed_precision=False)
    return config


def marge_phase(build_root: Path, seen: Counter, counts: dict) -> None:
    """Phase 22c: FFHQ-512 with the marge mapping through ``Inference``, and
    a size-32 marge ``g_step`` card against CPU."""
    import shutil

    from gan_control_torch.inference.inference import Inference
    from gan_control_torch.models.factory import build_discriminator, build_generator, build_group_spec
    from gan_control_torch.training import train_step as ts
    from gan_control_torch.training.state import init_gan_state
    from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

    gdir = build_root / "marge" / "generator"
    if gdir.parent.exists():
        shutil.rmtree(gdir.parent)
    gdir.mkdir(parents=True)
    config = marge_config()
    with Phase("marge generation"):
        (gdir / "args.json").write_text(json.dumps(config, indent=2))
        save_flax_checkpoint(gdir / "checkpoint", "g_ema",
                             build_generator(config, build_group_spec(config), device="cpu", seed=0))
        torch.backends.cudnn.allow_tf32 = True  # the defaults; synthesis is bf16
        torch.backends.cuda.matmul.allow_tf32 = False
        inf = Inference(gdir)
        n_map, n_conv, n_up = g_counts(inf.model)
        want = {"fused_bias_act": n_map + n_conv, "blur2x_up": n_up}
        n_groups = len(inf.spec.names)
        if n_map != n_groups * 4 + 4:
            fail(f"the marge mapping has {n_map} fused layers, not {n_groups} x 4 + 4")
        z = np.random.default_rng(50).standard_normal((BATCH, 512)).astype(np.float32)
        images = []
        got = launches_of(lambda: images.append(inf.gen_batch(batch_size=BATCH, latent=z)[0]), seen)
        img = images[0]
        got_nz = {k: v for k, v in got.items() if v}
        ms = synced_ms(lambda: inf.gen_batch(batch_size=BATCH, latent=z), MARGE_REPS)
        log(f"marge generation: FFHQ-512 {inf.model.dtype}, batch {BATCH}, {n_groups} x 4 split + 4 shared "
            f"mapping layers; launches {got_nz}, derived {want}; median {statistics.median(ms):.3f} ms "
            f"(synced, {MARGE_REPS} calls)")
        if got_nz != want:
            fail(f"marge generation launched {got_nz}, derived {want}")
        if tuple(img.shape) != (BATCH, 512, 512, 3) or not bool(torch.isfinite(img).all()):
            fail(f"marge generation gave {tuple(img.shape)} or non-finite values")
        add_counts(counts, got)
        del inf, images, img
        torch.cuda.empty_cache()

    with Phase("marge g_step card vs cpu"):
        torch.backends.cudnn.allow_tf32 = False
        config = marge_config(32)
        tc = config["training_config"]
        spec = build_group_spec(config)
        cfg = ts.TrainStepConfig(batch=tc["batch"], mini_batch=tc["mini_batch"])
        rng = np.random.default_rng(51)
        b = tc["batch"]
        z = torch.from_numpy(rng.standard_normal((b, 512)).astype(np.float32))
        g0 = build_generator(config, spec, device="cpu", seed=0)
        d0 = build_discriminator(config, device="cpu", seed=1)
        noise = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)) for sh in g0.noise_shapes(b)]
        with torch.no_grad():
            for m in g0.modules():  # non-zero noise weights, so the injection counts
                if type(m).__name__ == "NoiseInjection":
                    m.weight.fill_(0.3)
        out = {}
        for dev in ("cpu", "cuda"):
            st = init_gan_state(copy.deepcopy(g0).to(dev), copy.deepcopy(d0).to(dev), tc)

            def step(st=st, dev=dev):
                out[dev] = ({k: float(v) for k, v in ts.g_step(
                    st, cfg, spec, (z.to(dev),), noise=[n.to(dev) for n in noise]).items()},
                    {n: t.grad.detach().cpu() for n, t in st.generator.named_parameters()
                     if t.grad is not None})

            if dev == "cuda":
                launches_of(step, seen)
            else:
                step()
        (mc, gc), (mg, gg) = out["cpu"], out["cuda"]
        loss_err = max(abs(mc[k] - mg[k]) / max(1.0, abs(mc[k])) for k in mc)
        worst, worst_name = worst_grad_err(gc, gg)
        n_mapping = sum(n.startswith("style_") for n in gc)
        log(f"marge g_step card vs cpu (size 32, f32, TF32 off): losses {mc} (card {mg}), worst loss rel err "
            f"{loss_err:.3g}; {len(gc)} G gradients ({n_mapping} of the mapping), worst rel err {worst:.3g} "
            f"({worst_name}), tol {TRAIN_PARITY_RTOL}")
        if gc.keys() != gg.keys() or n_mapping != 2 * (len(spec.names) * 4 + 4):
            fail(f"marge g_step: gradients of {sorted(gc)[:4]}... on the CPU, {len(gg)} on the card")
        if loss_err > TRAIN_PARITY_RTOL or worst > TRAIN_PARITY_RTOL:
            fail("marge g_step: card and CPU disagree")


def replica_blocks(meshed, one, n: int, z: np.ndarray, ctl: dict, static: bool, label: str, rtol: float):
    """A meshed request of ``n`` rows against the one-device controller
    ``one`` at each replica's batch: replica ``k``'s padded rows ``[k b/m,
    (k + 1) b/m)`` (zeros past the request, as the replica computes them)
    as one request of ``b/m`` rows; with row noise replica 0's alone, whose
    rows are the global rows. Returns the meshed images and w."""
    m = len(meshed.mesh)
    b = meshed.bucket_for(n)
    h = b // m
    zp = np.zeros((b, z.shape[1]), np.float32)
    zp[:n] = z[:n]
    cp = {g: np.concatenate([v[:n], np.zeros((b - n, v.shape[1]), np.float32)]) for g, v in ctl.items()}
    noise = "static noise" if static else "row noise"
    got, _, got_w = meshed.generate(latent=z[:n], static_noise=static, generator=torch.Generator().manual_seed(n),
                                    **{g: v[:n] for g, v in ctl.items()})
    for k in (range(m) if static else (0,)):
        rows = slice(k * h, (k + 1) * h)
        want, _, want_w = one.generate(latent=zp[rows], static_noise=static,
                                       generator=torch.Generator().manual_seed(n), **{g: v[rows] for g, v in cp.items()})
        keep = max(0, min(n - k * h, h))
        if keep:
            held_to(f"meshed serving n {n} {noise} {label} replica {k} rows vs one device at {h} rows: image",
                    got[rows][:keep], want[:keep], rtol)
            held_to(f"meshed serving n {n} {noise} {label} replica {k} rows vs one device at {h} rows: w",
                    got_w[rows][:keep], want_w[:keep], rtol)
    return got, got_w


def meshed_serving_phase(build_root: Path, seen: Counter, counts: dict) -> None:
    """Phase 22d: ``ServingController(mesh=...)`` on phase 15's FFHQ-512
    directory, two replicas sharing the card, against one device. The
    card's synthesis moves with the batch size (other cuDNN and cuBLAS
    algorithms at b and b/m rows), so each replica's rows are held to one
    device at the replica's batch; the distance to one device at the same
    bucket, that batch shift, is printed. The f32 check runs with cuDNN's
    deterministic algorithms: without them two replays of one f32 graph
    differ by a few 1e-5 on the card."""
    from gan_control_torch.inference.row_noise import row_noise
    from gan_control_torch.inference.serving import ServingController
    from gan_control_torch.models.blocks import EqualLinear
    from gan_control_torch.tools.serving_bench import request_latency

    ctrl_dir = build_root / "serving" / "ffhq_controller"
    m = len(MESH)
    try:
        ServingController(ctrl_dir, buckets=(3, 8), mesh=MESH)
    except ValueError as e:
        if "not divisible" not in str(e):
            raise
        log(f"meshed serving: an indivisible ladder raises: {e}")
    else:
        fail("a ladder that the mesh does not divide was accepted")

    with Phase("meshed serving"):
        torch.backends.cudnn.allow_tf32 = True  # the defaults; synthesis is bf16
        torch.backends.cuda.matmul.allow_tf32 = False
        meshed = ServingController(ctrl_dir, buckets=MESH_BUCKETS, mesh=MESH)
        one = ServingController(ctrl_dir, buckets=sorted(set(MESH_BUCKETS) | {b // m for b in MESH_BUCKETS}))
        n_map, n_conv, n_up = g_counts(meshed.model)
        n_head = sum(isinstance(mod, EqualLinear) and mod.activation == "fused_lrelu"
                     for fc in meshed.fc_controls.values() for mod in fc.modules())
        want = {"fused_bias_act": n_map + n_head + n_conv, "blur2x_up": n_up}
        held = {}
        for label, serve in (("meshed", meshed), ("one-device", one)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved()
            got = launches_of(serve.warmup, seen)
            torch.cuda.empty_cache()
            held[label] = torch.cuda.memory_reserved() - reserved0
            if label == "meshed":
                for key, entry in sorted(serve._serve_cache.items(), key=lambda kv: kv[0][4]):
                    per = [{k: v for k, v in r.launches.items() if v} for r in entry.replicas]
                    log(f"meshed serving capture bucket {key[4]}: {len(entry.replicas)} replicas of "
                        f"{entry.rows} rows, {entry.capture_seconds:.3f} s, launches {per}")
                    if per != [want] * m:
                        fail(f"a replica's capture at bucket {key[4]} launched {per}, derived {want}")
                # each capture runs the request once eagerly first (the
                # side-stream warm-up), then once captured
                if {k: v for k, v in got.items() if v} != {k: 2 * len(MESH_BUCKETS) * m * v
                                                           for k, v in want.items()}:
                    fail(f"meshed warmup launched {got}")
                add_counts(counts, got)
        log(f"meshed serving memory: {held['meshed'] / 2**30:.3f} GiB held by the {m} replicas' pools and "
            f"buffers at buckets {MESH_BUCKETS}; {held['one-device'] / 2**30:.3f} GiB by one device's at "
            f"{one.buckets}")
        ctl64 = controls(64, 60)
        z64 = np.random.default_rng(61).standard_normal((64, 512)).astype(np.float32)
        for n in MESH_SIZES:
            for static in (True, False):
                got, got_w = replica_blocks(meshed, one, n, z64, ctl64, static, "bf16", KERNEL_RTOL[torch.bfloat16])
                same, _, same_w = one.generate(latent=z64[:n], static_noise=static,
                                               generator=torch.Generator().manual_seed(n),
                                               **{g: v[:n] for g, v in ctl64.items()})
                log(f"meshed serving n {n} {'static' if static else 'row'} noise bf16 against one device at bucket "
                    f"{meshed.bucket_for(n)} (the batch shift, not held): image max_abs_err "
                    f"{float(np.abs(got.astype(np.float64) - same).max()):.4g}, w "
                    f"{float(np.abs(got_w.astype(np.float64) - same_w).max()):.3g}")
        # the per-row noise of a replica hashes its global rows
        shapes = meshed.model.noise_shapes(64)
        seed = torch.tensor([2**40 + 9], dtype=torch.int64, device="cuda")
        full = row_noise(seed, shapes)
        for k in range(m):
            part = row_noise(seed, [(64 // m, *sh[1:]) for sh in shapes], k * 64 // m)
            if not all(torch.equal(a[k * 64 // m:(k + 1) * 64 // m], c) for a, c in zip(full, part)):
                fail(f"replica {k}'s per-row noise is not rows {k * 64 // m}.. of the one-device noise")
        offsets = {key[4]: [r.fn.row_offset for r in e.replicas] for key, e in meshed._serve_cache.items()}
        if any(o != [k * b // m for k in range(m)] for b, o in offsets.items()):
            fail(f"replica row offsets {offsets}")
        log(f"meshed serving per-row noise: each replica hashes its global rows (bitwise on the card); "
            f"row offsets by bucket {dict(sorted(offsets.items()))}")
        for n in MESH_LATENCY_SIZES:
            ctl = {g: v[:n] for g, v in ctl64.items()}
            stats = {}
            for rep in range(2):  # alternated
                for label, serve in (("meshed", meshed), ("one-device", one)):
                    stats.setdefault(label, []).append(request_latency(
                        lambda serve=serve: serve.generate(latent=z64[:n], **ctl)[0], MESH_REQUESTS))
            key = next(k for k in meshed._serve_cache if k[4] == n and k[2])
            replay = [replay_ms(r.graph) for r in meshed._serve_cache[key].replicas]
            one_replay = replay_ms(one._serve_cache[key].graph)
            log(f"meshed serving latency n {n}: meshed p50 {[round(s['p50_ms'], 3) for s in stats['meshed']]} ms, "
                f"one-device p50 {[round(s['p50_ms'], 3) for s in stats['one-device']]} ms (alternated, "
                f"{MESH_REQUESTS} requests each, host clock, request to numpy); replays: replicas "
                f"{[round(r, 3) for r in replay]} ms, one device {one_replay:.3f} ms (CUDA events)")
        del meshed, one
        torch.cuda.empty_cache()

    with Phase("meshed serving f32"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        try:
            meshed = ServingController(ctrl_dir, buckets=MESH_F32_BUCKETS, mesh=MESH, dtype=torch.float32)
            one = ServingController(ctrl_dir, buckets=sorted(set(MESH_F32_BUCKETS) | {b // m for b in MESH_F32_BUCKETS}),
                                    dtype=torch.float32)
            z = np.random.default_rng(62).standard_normal((8, 512)).astype(np.float32)
            ctl = controls(8, 63)
            for n in (5, 8):
                for static in (True, False):
                    res: list = []
                    launches_of(lambda: res.append(replica_blocks(
                        meshed, one, n, z, ctl, static, "f32 TF32 off", MESH_RTOL)), seen)
                    (got, got_w), = res
                    same, _, same_w = one.generate(latent=z[:n], static_noise=static,
                                                   generator=torch.Generator().manual_seed(n),
                                                   **{g: v[:n] for g, v in ctl.items()})
                    log(f"meshed serving n {n} {'static' if static else 'row'} noise f32 TF32 off against one "
                        f"device at bucket {meshed.bucket_for(n)} (the batch shift, not held): image max_abs_err "
                        f"{float(np.abs(got.astype(np.float64) - same).max()):.4g}, w "
                        f"{float(np.abs(got_w.astype(np.float64) - same_w).max()):.3g}")
            del meshed, one
        finally:
            torch.backends.cudnn.deterministic = False
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the measuring tools (phase 23)
# ---------------------------------------------------------------------------

MFU_MAX = 1.05  # an MFU or an HBM share above this is a counting error
SMALL = (32, 32)  # size and max_channels of the train steps counted on both devices
# their battery: two of the six nets (the six cost ~70 s of a shared CPU)
SMALL_LOSSES = ("expression_loss", "orientation_loss")
DRIFT_IMAGES = 64  # synthetic images per precision_drift leg (the tool's default 256)
DRIFT_BATCH = 32
REF_SEED = 40
# nets whose random-init forward in f32 moves with the algorithm that runs it
# (ROADMAP Queue 3 item 13: ArcFace's and DEX's outputs move with the batch
# size on the card): the card's probe is printed beside the CPU's golden,
# not held to it
GOLDEN_CHAOTIC = {
    "embedding_loss": "ArcFace at random init: its f32 forward moves with the cuDNN algorithm",
    "age_loss": "DEX at random init: its f32 forward moves with the cuDNN algorithm",
}


def counted_runs(exes: dict) -> tuple[dict, Counter]:
    """Wraps each executable's ``run`` so that each call adds the launch
    counters' change over it to its name's Counter; returns (those, runs)."""
    from gan_control_torch.ops import kernels

    got = {n: Counter() for n in exes}
    runs: Counter = Counter()
    for n, e in exes.items():
        def run(_run=e.run, _n=n):
            before = kernels.launch_counts()
            out = _run()
            after = kernels.launch_counts()
            got[_n].update({k: after[k] - before[k] for k in after})
            runs[_n] += 1
            return out
        e.run = run
    return got, runs


def check_mfu_rows(rows: list[dict], got: dict, runs: Counter, want: dict, seen_counts: dict) -> None:
    """Every MFU and HBM share in (0, MFU_MAX]; each executable's launches
    over its runs (the counting pass, the warm run and the timed runs) equal
    to its derived launches per run times the runs."""
    for r in rows:
        if not (0 < r["mfu"] <= MFU_MAX and 0 < r["hbm"] <= MFU_MAX):
            fail(f"{r['name']}: MFU {r['mfu']} or HBM share {r['hbm']} outside (0, {MFU_MAX}]")
        n = r["name"]
        expected = {k: v * runs[n] for k, v in want[n].items()}
        if dict(got[n]) != expected:
            fail(f"{n}: launches over its {runs[n]} runs {dict(got[n])}, expected {expected}")
        add_counts(seen_counts, got[n])
        by_prec = ", ".join(f"{p} {v / 1e12:.3f}" for p, v in sorted(r["flops_by_precision"].items()))
        log(f"train_mfu {n}: {r['flops'] / 1e12:.3f} TFLOP ({by_prec}), "
            f"{r['bytes'] / 1e9:.2f} GB (layout copies {r['summary']['layout_bytes'] / 1e9:.3f}, host transfers "
            f"{r['summary']['transfer_bytes'] / 1e6:.3f} MB); floors compute {r['compute_floor_ms']:.2f} ms, HBM "
            f"{r['hbm_floor_ms']:.2f} ms; measured {r['ms']:.2f} ms; MFU {r['mfu']:.4f}, HBM {r['hbm']:.4f}, "
            f"{r['limiter']}; {r['imgs_per_s']:.1f} images/s; launches over {runs[n]} runs {dict(got[n])}")


def mfu_train_phase(trainer, per_kind: dict) -> tuple[Counter, dict]:
    """Phase 23a, on phase 7's trainer: ``train_mfu``'s train family
    (``report(..., measure=True)``) on its state and battery, with the
    launches recorded. Returns (recorded launches, counts)."""
    from gan_control_torch.tools import train_mfu as tm

    seen: Counter = Counter()
    counts = {n: 0 for n in KERNELS}
    with Phase("measuring tools: train_mfu train"):
        exes = tm.train_exes(trainer.state, trainer.step_cfg, trainer.spec, trainer.attr_losses,
                             trainer.predictors, trainer.augment_fn)
        got, runs = counted_runs(exes)
        remove = install_launch_recorder(seen)
        try:
            rows = tm.report(exes, True, "train", "cuda")
        finally:
            remove()
        check_mfu_rows(rows, got, runs, per_kind, counts)
    return seen, counts


def write_reference_root(root: Path) -> list[str]:
    """Seeded random-init nets in their reference checkpoints' layouts, under
    the file names convert_weights looks for: ESR-9's ten files, the hair
    net's ``{'weight': ...}`` wrapper, DEX's caffe ``fc8-101``, Hopenet's
    ``fc_finetune``, a whole torchvision VGG16 ``features`` (13 convs, for
    the style loss and LPIPS's backbone) and richzhang's LPIPS heads, and the
    rest as state_dicts in their own names. (The tests' writer,
    ``tests/test_torch_predictors.py``, lives in a file that imports JAX.)
    Returns the entry names written."""
    from gan_control_torch.alignment import blazeface, fan, sfd
    from gan_control_torch.evaluation import inception
    from gan_control_torch.losses.predictors import predictor_module
    from gan_control_torch.losses.predictors.common import init_predictor_
    from gan_control_torch.projection import lpips

    def net_sd(loss: str, seed: int) -> dict:
        return init_predictor_(predictor_module(loss).make_model({"center_crop": None}), seed).state_dict()

    def save(obj, name: str) -> None:
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        torch.save(obj, root / name)

    root.mkdir(parents=True, exist_ok=True)
    files = {"embedding_loss": "model_ir_se50.pth",
             "recon_3d_loss": "face3dmm_recon/models/pytorch_converted_model.pt",
             "dog_id_loss": "dogfacenet/models/pytorch_converted_model.pt",
             "classification_loss": "resnet18-f37072fd.pth"}
    for i, (loss, name) in enumerate(files.items()):
        save(net_sd(loss, REF_SEED + i), name)
    sd = net_sd("orientation_loss", REF_SEED + 4)
    sd.update({"fc_finetune.weight": torch.zeros(3, 2051), "fc_finetune.bias": torch.zeros(3)})
    save(sd, "hopenet_robust_alpha1.pkl")
    sd = net_sd("age_loss", REF_SEED + 5)
    save({k.replace("fc8_101", "fc8-101"): v for k, v in sd.items()}, "dex_imdb_wiki.pt")
    save({"weight": net_sd("hair_loss", REF_SEED + 6)}, "pspnet_resnet101_sgd_lr_0.002_epoch_100_test_iou_0.918.pth")
    sd = net_sd("expression_loss", REF_SEED + 7)
    save({k[5:]: v for k, v in sd.items() if k.startswith("base.")}, "esr_9/Net-Base-Shared_Representations.pt")
    for i in range(9):
        pre = f"convolutional_branches.{i}."
        branch = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
        branch.update({"fc_dimensional.weight": torch.zeros(2, 8), "fc_dimensional.bias": torch.zeros(2)})
        save(branch, f"esr_9/Net-Branch_{i + 1}.pt")
    lp = lpips.make_lpips(seed=REF_SEED + 8).state_dict()
    save({f"features.{k[len('vgg.conv'):]}": v for k, v in lp.items() if k.startswith("vgg.")},
         "vgg16-397923af.pth")
    save({f"lin{i}.model.1.weight": lp[f"lins.{i}.weight"].reshape(1, -1, 1, 1) for i in range(5)},
         "lpips/vgg.pth")
    save(inception.init_params(REF_SEED + 9).state_dict(), "pt_inception-2015-12-05-6726825d.pth")
    save(init_predictor_(fan.FANNet(4), REF_SEED + 10).state_dict(), "3DFAN4-7835d9f11d.pth.tar")
    save(init_predictor_(sfd.S3FD(), REF_SEED + 11).state_dict(), "s3fd-619a316812.pth")
    save(init_predictor_(blazeface.BlazeFaceNet(), REF_SEED + 12).state_dict(), "blazeface.pth")
    return [*files, "orientation_loss", "age_loss", "hair_loss", "expression_loss", "style_loss",
            "lpips", "fid_inception", "fan", "sfd", "blazeface"]


@contextlib.contextmanager
def phase7_tf32():
    """TF32 switches at phase 7's setting (cuDNN on, cuBLAS off, the
    defaults), restored on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def small_step_counts(device: str) -> dict:
    """The size-32 train steps (configs/ffhq.json cut to SMALL, ESR-9 and
    Hopenet of its battery, the bf16 plan) counted once each on ``device``,
    the TF32 switches at phase 7's setting: {step: accountant summary}."""
    from gan_control_torch.tools import train_mfu as tm

    tr = tm.build_trainer(tm.model_config(CONFIGS / "ffhq.json", *SMALL, losses=SMALL_LOSSES), device)
    try:
        exes = tm.train_exes(tr.state, tr.step_cfg, tr.spec, tr.attr_losses, tr.predictors, tr.augment_fn)
        with phase7_tf32():
            return {n: tm.count(e, device).summary() for n, e in exes.items()}
    finally:
        tr.close()


def measuring_cpu_child(root: str, out: str) -> None:
    """Runs in a fresh interpreter on the CPU (four threads), beside phase
    23's card work: the size-32 steps' counts and ``convert_weights`` of the
    reference root with ``--device cpu`` into ``converted_cpu`` beside
    ``out`` (the CPU's goldens). Writes the counts and its seconds to the
    JSON file ``out``."""
    from gan_control_torch.tools import convert_weights

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    counts = small_step_counts("cpu")
    t1 = time.perf_counter()
    rc = convert_weights.main(["--root", root, "--out", str(Path(out).parent / "converted_cpu"), "--device", "cpu"])
    Path(out).write_text(json.dumps({"counts": counts, "rc": rc, "count_seconds": t1 - t0,
                                     "convert_seconds": time.perf_counter() - t1}))


def measuring_start(build_root: Path) -> dict:
    """Phase 23b-c, none of it timed (it runs while phase 22's blob-world
    processes train): the reference root and the CPU child
    (:func:`measuring_cpu_child`), the size-32 steps counted on the card,
    ``precision_drift`` with ``--storage`` on the card, and
    ``convert_weights`` on the card, validated against its own goldens.
    Returns what :func:`measuring_finish` compares."""
    import shutil

    from gan_control_torch.tools import convert_weights, precision_drift

    root = build_root / "measuring"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    with Phase("measuring tools: reference checkpoints"):
        names = write_reference_root(root / "pretrained")
        out = root / "cpu_child.json"
        with open(root / "cpu_child.log", "w") as f:
            child = subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.measuring_cpu_child("
                 f"{str(root / 'pretrained')!r}, {str(out)!r})"], stdout=f, stderr=subprocess.STDOUT, cwd=REPO)
    with Phase("measuring tools: size-32 counts on the card"):
        card = small_step_counts("cuda")
    with Phase("measuring tools: precision_drift"):
        drift = precision_drift.main(["--num_images", str(DRIFT_IMAGES), "--batch_size", str(DRIFT_BATCH),
                                      "--storage", "--out", str(root / "drift"), "--device", "cuda"])
        for loss, tables in drift.items():
            vals = [v for t in tables.values() for layer in t.values() for v in layer["suggested"].values()]
            if len(tables) != 3 or not all(math.isfinite(v) for v in vals):
                fail(f"precision_drift {loss}: legs {sorted(tables)}, values {vals}")
            log(f"precision_drift {loss}: legs {sorted(tables)} on cuda, {len(vals)} suggested thresholds, "
                "all finite")
    with Phase("measuring tools: convert_weights on the card"):
        specs = convert_weights.make_specs()
        converted, missing = convert_weights.convert(specs, str(root / "pretrained"),
                                                     str(root / "converted_card"), "cuda")
        if sorted(converted) != sorted(names) or missing:
            fail(f"convert_weights converted {converted}, missing {missing}; wrote {names}")
        own = convert_weights.validate(specs, str(root / "converted_card"), "cuda")
        bad = [n for n, (ok, _, _) in own.items() if not ok]
        if len(own) != len(names) or bad:
            fail(f"convert_weights --validate on the card against its own goldens: {len(own)} nets, "
                 f"mismatches {bad}")
        log(f"convert_weights on the card: {len(converted)} nets converted and validated")
    return {"root": root, "names": names, "child": child, "out": out, "card": card}


def measuring_finish(build_root: Path, started: dict, seen: Counter, counts: dict) -> None:
    """Phase 23d: ``train_mfu``'s generation and phase-2b executables
    (measured, launches recorded), then the CPU child's results against the
    card's: the size-32 counts, the msgpack files, the probes against the
    CPU's goldens."""
    from gan_control_torch.tools import convert_weights
    from gan_control_torch.tools import train_mfu as tm

    root, names, child, out, card = (started[k] for k in ("root", "names", "child", "out", "card"))
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    with Phase("measuring tools: train_mfu gen and phase2b"), phase7_tf32():
        exes = {**tm.gen_exe(config, "cuda"), **tm.phase2b_exes(tm.write_generator_dir(root, config), "cuda")}
        n_map, n_conv, n_up = g_counts(exes["generation"].model)
        want = {"generation": row(n_map + n_conv, 0, n_up, 0)}
        rec, attr = exes["phase2b_latent_rec_step"].model, exes["phase2b_attr_rec_step"].model
        want["phase2b_latent_rec_step"] = row(rec.controller.n_mlp, rec.controller.n_mlp, 0, 0)
        g = attr.generator
        _, a_conv, a_up = g_counts(g)
        n_head = attr.controller.n_mlp
        # the head forward and backward; each StyledConv forward, again in the
        # backward for the rematerialised ones, and its gradient; each ToRGB
        # skip up, and down in the backward (as phase 12)
        want["phase2b_attr_rec_step"] = row(n_head + a_conv + len(g.convs), n_head + a_conv, a_up, a_up)
        got, runs = counted_runs(exes)
        remove = install_launch_recorder(seen)
        try:
            rows = tm.report(exes, True, "gen and phase2b", "cuda")
        finally:
            remove()
        check_mfu_rows(rows, got, runs, want, counts)
        del exes, rec, attr, g
        torch.cuda.empty_cache()
    with Phase("measuring tools: the CPU child"):
        child.wait(timeout=900)
    log_text = (root / "cpu_child.log").read_text().splitlines()
    if child.returncode != 0 or not out.exists():
        fail(f"the CPU child exited {child.returncode}; last lines:\n" + "\n".join(log_text[-30:]))
    res = json.loads(out.read_text())
    log(f"measuring tools CPU child: size-32 counts {res['count_seconds']:.1f} s, convert_weights "
        f"{res['convert_seconds']:.1f} s (rc {res['rc']})")
    with Phase("measuring tools: card against CPU"):
        for step, c in card.items():
            h = res["counts"][step]
            same = c["flops"] == h["flops"] and c["bytes"] - c["layout_bytes"] == h["bytes"] - h["layout_bytes"]
            log(f"size-32 {step} count, card against CPU: FLOPs {sum(c['flops'].values())} / "
                f"{sum(h['flops'].values())} over {len(c['flops'])} op kinds, bytes less layout copies "
                f"{c['bytes'] - c['layout_bytes']} / {h['bytes'] - h['layout_bytes']}, layout copies "
                f"{c['layout_bytes']} / {h['layout_bytes']}, host transfers {c['transfer_bytes']} / "
                f"{h['transfer_bytes']}: {'equal' if same else 'DIFFERENT'}")
            if not same:
                fail(f"size-32 {step}: the card's count {c} differs from the CPU's {h}")
        for name in names:
            a, b = (root / "converted_card" / f"{name}.msgpack").read_bytes(), \
                (root / "converted_cpu" / f"{name}.msgpack").read_bytes()
            if a != b:
                fail(f"convert_weights {name}: the card's msgpack differs from the CPU's")
        held = convert_weights.validate(convert_weights.make_specs(), str(root / "converted_cpu"), "cuda")
        for name, (ok, got, want) in sorted(held.items()):
            dist = max(abs(got["mean"] - want["mean"]), abs(got["std"] - want["std"]),
                       *(abs(x - y) for x, y in zip(got["first8"], want["first8"])))
            if name in GOLDEN_CHAOTIC:
                log(f"convert_weights golden {name}: card against the CPU's golden, largest distance "
                    f"{dist:.3g} ({'within' if ok else 'beyond'} the tool's tolerance; not held: "
                    f"{GOLDEN_CHAOTIC[name]})")
                continue
            if not ok:
                fail(f"convert_weights golden {name}: the card's probe {got} against the CPU's {want}")
            log(f"convert_weights golden {name}: card against the CPU's golden, largest distance {dist:.3g}: "
                "within the tool's tolerance (relative 1e-3, absolute 1e-4)")
        if sorted(held) != sorted(names):
            fail(f"validated {sorted(held)}, expected {sorted(names)}")
        log(f"convert_weights: the card's and the CPU's {len(names)} msgpack files are byte for byte equal")


# ---------------------------------------------------------------------------
# phase 24: int8 storage of the battery, battery_share, profile_bench and
# loader_bench (this slice)
# ---------------------------------------------------------------------------

INT8_ITERS = 2  # train(2) under int8 storage: iteration 0 runs all four steps
SHARE_ROUNDS = 5  # battery_share's timed steps per leg
DEQUANT_GRAPH_MS = 2.0  # a few calls per captured graph: each writes a fresh 561 MB buffer
LOADER_ARGS = ["--images", "32", "--batches", "4", "--workers", "4"]
# 24d: the card's distance from a reference, as a multiple of the CPU's
# (predictor_precision_probe, section 3, on an H100 80GB HBM3 at 700 W,
# battery seeds 3, 11, 19, TF32 off): each net's bf16 image gradient on
# INT8_NET_ROWS images, card 0.96-1.13x the CPU's distance from float64;
# the g_step's G gradients 0.87-1.31x the larger of the CPU's and the
# CPU's with one rounding moved (itself 1.3-5.3x the CPU's)
INT8_NET_FACTOR = 1.5
INT8_CARD_FACTOR = 2.0
INT8_NET_ROWS = 4
INT8_CHILD_TIMEOUT = 600.0  # seconds 24d waits for its CPU side (it takes ~2 min beside phases 10-22)
# each of the two CPU children (24d's, 25b's), which run at once beside
# phases 7b-16: two cores of the card machine's eight stay with the script
CPU_CHILD_THREADS = 3


def dequant_kernel_check(battery) -> tuple[dict, float, str, float]:
    """24a: the kernel on the whole store against its plain version,
    bitwise in bf16 and f32; per launch its host-rate and device times, the
    plain per-tensor loop's host-rate time, and the bound. Returns (times,
    bound ms, what bounds it, the largest error)."""
    from gan_control_torch.ops import kernels

    args = (battery.q, battery.scales, battery.block_tensor, battery.segments)
    err = 0.0
    for dtype, bits in ((torch.bfloat16, torch.int16), (torch.float32, torch.int32)):
        got = kernels._cuda_dequant_int8(*args, dtype)
        want = kernels.dequant_int8_plain(*args, dtype)
        torch.cuda.synchronize()
        e, _ = max_err(got, want)
        err = max(err, e)
        if not torch.equal(got.view(bits), want.view(bits)):
            fail(f"dequant_int8 {str(dtype)[6:]}: the kernel and its plain version differ (max abs err {e})")
        del got, want
    run = lambda: kernels._cuda_dequant_int8(*args, torch.bfloat16)  # noqa: E731
    plain = lambda: kernels.dequant_int8_plain(*args, torch.bfloat16)  # noqa: E731
    t = {"ms": cuda_ms(run), "plain_ms": cuda_ms(plain), "library_ms": None, "library_device_ms": None}
    t["device_ms"] = device_ms(run, t["ms"], target_ms=DEQUANT_GRAPH_MS)
    t_b, by = bound("dequant_int8", battery.q.shape, torch.int8, (torch.bfloat16, battery.num_tensors))
    elements = sum(math.prod(shape) for shape, _ in battery.shapes)
    log(f"kernel dequant_int8 {battery.num_tensors} tensors, {elements} elements in a store of "
        f"{battery.q.numel()} (bf16 out): bitwise equal to the plain version (bf16 and f32); per launch "
        + timing_text(t, t_b, by, None) + f"; the plain per-tensor loop host-rate {t['plain_ms']:.3f} ms "
        f"({t['plain_ms'] / t['ms']:.1f}x the kernel's)")
    return t, t_b, by, err


def int8_train_phase(build_root: Path) -> tuple[Counter, dict, tuple, object]:
    """24a-b: a ``GeneratorTrainer`` on configs/ffhq.json with
    ``predictor_dtype: "int8"`` (FFHQ-512, batch 16, the six-net battery at
    random init, as ``train_generator`` builds it); the kernel check on its
    store; ``train(INT8_ITERS)`` with the counters set to 0 just before and
    read just after, each step kind against ``expected_step_counts`` with
    one dequantisation per ``g_step``; finite losses, the store unchanged,
    every quantised tensor of the modules on the meta device, each step's
    bf16 buffer freed with its step, the first one bitwise equal to the
    plain version. Returns (recorded launches, counts, the kernel's 24a
    numbers, the trainer, which 25a recasts)."""
    import weakref

    from gan_control_torch.losses.int8_storage import Int8Battery
    from gan_control_torch.losses.registry import distinct_predictors
    from gan_control_torch.ops import kernels
    from gan_control_torch.tools import train_mfu as tm
    from gan_control_torch.trainers import generator_trainer as gt

    config = tm.model_config(CONFIGS / "ffhq.json")
    config["training_config"]["predictor_dtype"] = "int8"
    with phase7_tf32():
        with Phase("int8 build"):
            trainer = tm.build_trainer(config, "cuda")
            battery = trainer.predictors
            if not isinstance(battery, Int8Battery) or len(distinct_predictors(battery)) != 6:
                fail(f"int8 storage: the trainer's battery is {type(battery).__name__}")
            floats = [f"{n}.{k}" for n, m in distinct_predictors(battery).items()
                      for k, t in (*m.named_parameters(), *m.named_buffers()) if t.device.type != "meta"]
            if floats:
                fail(f"int8 storage: float tensors left in the modules: {floats[:5]}")
            torch.cuda.synchronize()
            log(f"int8 storage: {battery.num_tensors} tensors of {len(distinct_predictors(battery))} nets, "
                f"store {battery.q.numel()} int8 + {battery.scales.numel()} scales, resident "
                f"{battery.resident_bytes / 1e6:.2f} MB; card memory allocated "
                f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
        with Phase("int8 kernel (24a)"):
            kernel = dequant_kernel_check(battery)

        st = trainer.state
        per_kind = expected_step_counts(st.generator, st.discriminator, len(trainer.spec.groups))
        per_kind["g_step"] = dict(per_kind["g_step"], dequant_int8=1)
        q0, s0 = battery.q.clone(), battery.scales.clone()
        buffers, checked = [], []
        dequantize = battery.dequantize

        def watched(dtype=torch.bfloat16):
            out = dequantize(dtype)
            buffers.append(weakref.ref(out))
            if not checked:
                want = kernels.dequant_int8_plain(battery.q, battery.scales, battery.block_tensor,
                                                  battery.segments, dtype)
                checked.append(torch.equal(out.view(torch.int16), want.view(torch.int16)))
            return out

        battery.dequantize = watched
        seen: Counter = Counter()
        with Phase("int8 main path (24b)"):
            by_kind, restore = count_by_kind(gt)
            remove = install_launch_recorder(seen)
            trainer.profile_steps = True
            torch.cuda.reset_peak_memory_stats()
            try:
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                trainer.train(INT8_ITERS)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
            finally:
                remove()
                restore()
                del battery.dequantize
            peak = torch.cuda.max_memory_allocated()
            log(f"int8 main path: launches over train({INT8_ITERS}) {counts}")
            runs = {k: len(v) for k, v in by_kind.items()}
            if runs != {"d_step": INT8_ITERS, "d_reg_step": 1, "g_step": INT8_ITERS, "g_reg_step": 1}:
                fail(f"int8: step kinds run {runs}")
            for kind in gt.STEP_KINDS:
                for got in by_kind[kind]:
                    if got != per_kind[kind]:
                        fail(f"int8 {kind}: launches {got}, expected {per_kind[kind]}")
            if counts["dequant_int8"] != runs["g_step"]:
                fail(f"int8: {counts['dequant_int8']} dequantisations over {runs['g_step']} g_steps")
            if checked != [True]:
                fail("int8: the g_step's dequantised weights differ from the plain version")
            if len(buffers) != runs["g_step"] or any(b() is not None for b in buffers):
                fail(f"int8: {sum(b() is not None for b in buffers)} of {len(buffers)} bf16 buffers outlived their step")
            if not (torch.equal(battery.q, q0) and torch.equal(battery.scales, s0)):
                fail("int8: the store changed in training")
            if any(t.device.type != "meta" for m in distinct_predictors(battery).values()
                   for t in (*m.parameters(), *m.buffers())):
                fail("int8: a float copy of a quantised tensor is resident")
            attr_names = [f"g_{al.name}" for al in trainer.attr_losses]
            for h in trainer.metrics_history:
                if not all(math.isfinite(v) for v in h.values()) or not all(n in h for n in attr_names):
                    fail(f"int8: losses not finite or missing: {h}")
                log(f"int8 train losses, iteration {h['iter']}: "
                    + ", ".join(f"{n} {h[n]:.6g}" for n in attr_names) + f"; g_loss {h['g_loss']:.6g}")
            for kind, ts_ in trainer.step_times.items():
                log(f"int8 train time: {kind} {[round(t, 2) for t in ts_]} ms")
            log(f"int8: one dequantisation per g_step, bitwise the plain version's; the store unchanged; "
                f"no float copy resident and every step's bf16 buffer freed; peak memory "
                f"{peak / 2**30:.2f} GiB, allocated after the steps {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
        with Phase("profile_bench train (24e)"):
            from gan_control_torch.tools import profile_bench

            out = profile_bench.profile_train(config, "cuda", "g_full", trainer=trainer)
            log(f"profile_bench train on this trainer: {json.dumps(out)}")
            if not (out["ms"] > 0 and math.isfinite(out["ms"])):
                fail(f"profile_bench train: {out}")
    del battery, q0, s0, st
    torch.cuda.empty_cache()
    return seen, counts, kernel, trainer


def battery_share_phase() -> None:
    """24c: ``battery_share``'s four legs at FFHQ-512, batch 16 (the
    launches of its int8 leg: one per step it runs)."""
    from gan_control_torch.ops import kernels
    from gan_control_torch.tools import battery_share as bs
    from gan_control_torch.tools import train_mfu as tm

    with Phase("battery_share (24c)"), phase7_tf32():
        trainer, legs = bs.build_legs(tm.model_config(CONFIGS / "ffhq.json"), "cuda")
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            rows = bs.measure(legs, "cuda", SHARE_ROUNDS)
            launches = kernels.launch_counts()["dequant_int8"]
        finally:
            trainer.close()
        for r in rows:
            log("battery_share " + bs.line(r) + f" (steps {[round(t, 2) for t in r['times_ms']]} ms)")
        by = {r["name"]: r for r in rows}
        f32, int8 = by["g_step_battery_f32"]["battery_bytes"], by["g_step_battery_int8"]["battery_bytes"]
        if not all(math.isfinite(r["ms"]) and r["ms"] > 0 and r["peak_bytes"] > 0 for r in rows):
            fail(f"battery_share: bad rows {rows}")
        if not f32 / 4 < int8 < f32 / 3.5 or launches != 2 + SHARE_ROUNDS:
            fail(f"battery_share: int8 battery {int8} B against f32 {f32} B, {launches} dequantisations")
    del trainer, legs
    torch.cuda.empty_cache()


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


def int8_cpu_child(inputs: str, out: str) -> None:
    """24d's CPU side, in a fresh interpreter on the CPU (CPU_CHILD_THREADS
    threads) from the end of phase 9 on: from phase 9's size-32 model, images and
    calibrated battery (``inputs``), the int8 store's digests and its
    plain dequantisation's; per net (INT8_NET_ROWS images) the float64
    witness's image gradient and the hair net's mask logit
    (``predictor_precision_probe.int8_witness``) and the CPU's gradients
    from the store (``int8_net_grads``); the witness's mask logit on all
    the images; the size-32 ``g_step``'s G gradients with the battery in
    f32 on the dequantised weights, in int8 storage, and in int8 storage
    with one rounding moved (the resizes' forward from f32), the hair net
    on the witness's mask. Writes them to ``out``."""
    from gan_control_torch.losses.int8_storage import Int8Battery
    from gan_control_torch.losses.registry import build_attr_losses, distinct_predictors
    from gan_control_torch.ops import kernels
    from gan_control_torch.tools import predictor_precision_probe as probe

    torch.set_num_threads(CPU_CHILD_THREADS)
    t0 = time.perf_counter()
    saved = torch.load(inputs, weights_only=False)
    setup = probe.size32_setup(json.loads(probe.CONFIG.read_text()))
    setup["g0"].load_state_dict(saved["g0"])
    setup["d0"].load_state_dict(saved["d0"])
    setup.update(z=saved["z"], noise=saved["noise"], img=saved["img"])
    specs, preds = build_attr_losses({**setup["tc"], "predictor_precision": "highest"}, device="cpu", seed=3)
    for name, m in distinct_predictors(preds).items():
        m.load_state_dict(saved["nets"][name])
    cpu8 = Int8Battery(preds)
    flat = kernels.dequant_int8_plain(cpu8.q, cpu8.scales, cpu8.block_tensor, cpu8.segments, torch.bfloat16)
    res = {"q": _digest(cpu8.q), "scales": _digest(cpu8.scales), "dequant": _digest(flat), "nets": {}}
    del flat
    rows = setup["img"][:INT8_NET_ROWS]
    for i, name in enumerate(distinct_predictors(cpu8)):
        want, logit = probe.int8_witness(cpu8, name, rows, 300 + i)
        res["nets"][name] = {"witness": want, "logit": logit,
                             "cpu": probe.int8_net_grads(cpu8, name, rows, 300 + i, logit)}
    witness = cpu8.float_module("hair_loss", torch.bfloat16).double()
    with torch.no_grad():
        res["logit"] = logit = witness.mask_logit(witness.resize_input(setup["img"].double()))
    f32 = {id(m): cpu8.float_module(n) for n, m in distinct_predictors(cpu8).items()}
    cpu32 = {n: f32[id(m)] for n, m in cpu8.items()}
    for battery in (cpu8, cpu32):  # one hair mask everywhere: the witness's
        battery["hair_loss"].mask_logit = lambda t: logit.to(t.device, t.dtype)
    res["ref"] = probe.int8_g_step_grads(setup, specs, "float32", cpu32, "cpu")
    res["cpu"] = probe.int8_g_step_grads(setup, specs, "int8", cpu8, "cpu")
    with probe.resize_forward_from_f32():
        res["moved"] = probe.int8_g_step_grads(setup, specs, "int8", cpu8, "cpu")
    res["seconds"] = time.perf_counter() - t0
    torch.save(res, out)


def wait_for_child(child, out: Path, log_path: Path, label: str) -> None:
    """Until a CPU child has exited; fails unless it exited 0 having
    written ``out``."""
    try:
        rc = child.wait(timeout=INT8_CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        rc = None
    if rc != 0 or not out.exists():
        fail(f"{label}: the CPU child ended with {rc}:\n{log_path.read_text()[-3000:]}")


def battery_copies(cpu_preds: dict, device) -> dict:
    """A copy of phase 9's battery on ``device``, its recon sharing kept
    and its hair-mask hook dropped."""
    nets = {id(m): copy.deepcopy(m).to(device) for m in cpu_preds.values()}
    for m in nets.values():
        m.__dict__.pop("mask_logit", None)  # phase 9's hair-mask hook
    return {n: nets[id(m)] for n, m in cpu_preds.items()}


def int8_cpu_start(build_root: Path, setup: dict, specs, cpu_preds: dict) -> dict:
    """Phase 9's inputs to 24d written to disk and :func:`int8_cpu_child`
    and :func:`float16_cpu_child` started on them; returns what
    :func:`int8_card_vs_cpu` and :func:`float16_card_vs_cpu` read."""
    import atexit

    from gan_control_torch.losses.registry import distinct_predictors

    root = build_root / "int8_24d"
    root.mkdir(parents=True, exist_ok=True)
    inputs, out = root / "inputs.pt", root / "cpu.pt"
    out.unlink(missing_ok=True)
    out16 = root / "cpu_float16.pt"
    out16.unlink(missing_ok=True)
    torch.save({"g0": setup["g0"].state_dict(), "d0": setup["d0"].state_dict(), "z": setup["z"],
                "noise": setup["noise"], "img": setup["img"],
                "nets": {n: m.state_dict() for n, m in distinct_predictors(cpu_preds).items()}}, inputs)
    children = {}
    for fn, dest, log_name in (("int8_cpu_child", out, "cpu_child.log"),
                               ("float16_cpu_child", out16, "float16_child.log")):
        with open(root / log_name, "w") as f:
            children[fn] = subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.{fn}({str(inputs)!r}, {str(dest)!r})"],
                stdout=f, stderr=subprocess.STDOUT, cwd=REPO)
        atexit.register(children[fn].kill)
    return {"child": children["int8_cpu_child"], "out": out, "log": root / "cpu_child.log",
            "child16": children["float16_cpu_child"], "out16": out16, "log16": root / "float16_child.log",
            "setup": setup, "specs": specs, "cpu_preds": cpu_preds}


def resize_backward_check(img: torch.Tensor, dtype: torch.dtype, label: str) -> None:
    """The predictors' ``dtype`` resize backward (32 -> 256 px) on the card
    within one ``dtype`` rounding of the CPU's f32 gradient; F.interpolate's
    own (CUDA sums it by ``dtype`` atomics) logged beside it."""
    from gan_control_torch.losses.predictors.common import resize_bilinear

    tol = torch.finfo(dtype).eps / 2  # one rounding: 2**-8 in bf16, 2**-11 in float16
    x = img.permute(0, 3, 1, 2).to(dtype)
    g = torch.randn((x.shape[0], 3, 256, 256), generator=torch.Generator().manual_seed(7)).to(dtype)
    x32 = x.float().requires_grad_(True)
    (want,) = torch.autograd.grad(F.interpolate(x32, size=(256, 256), mode="bilinear", align_corners=True),
                                  x32, g.float())
    errs = {}
    for name, fn in (("port", resize_bilinear), ("F.interpolate", lambda t, hw, ac: F.interpolate(
            t, size=hw, mode="bilinear", align_corners=ac))):
        xc = x.cuda().requires_grad_(True)
        (got,) = torch.autograd.grad(fn(xc, (256, 256), True), xc, g.cuda())
        errs[name] = float((got.float().cpu() - want).abs().max() / want.abs().max())
    log(f"{label}: {str(dtype)[6:]} resize 32 -> 256 px backward on the card against the CPU's f32, largest "
        f"error over max: the port's {errs['port']:.3g} (tol {tol:.3g}), F.interpolate's {errs['F.interpolate']:.3g}")
    if errs["port"] > tol:
        fail(f"{label}: the predictors' {str(dtype)[6:]} resize backward is not the f32 sum rounded once")


def int8_card_vs_cpu(started: dict) -> None:
    """24d: int8 storage on the card against the CPU, on phase 9's size-32
    model and calibrated f32 battery (the CPU's side from
    :func:`int8_cpu_child`, which ran meanwhile):

      - the stores quantised on the card and on the CPU bitwise equal, and
        the card's kernel dequantisation bitwise the CPU's plain one;
      - the predictors' bf16 resize backward on the card (32 -> 256 px, the
        hair net's) within one bf16 rounding of the CPU's f32 gradient
        (F.interpolate's own bf16 backward, summed by bf16 atomics, is
        logged beside it);
      - each net's features on the card from the int8 store bitwise those
        of a bf16 battery holding the dequantised weights;
      - each net alone (INT8_NET_ROWS images, the hair net on the
        witness's mask): the image gradient from the store dequantised to
        f32 card against CPU to PREDICTOR_GRAD_REL_L2, and from the store
        dequantised to bf16 the card no farther from a float64 witness on
        the bf16 weights than INT8_NET_FACTOR times the CPU, plus
        BATTERY_PARITY_RTOL;
      - the ``g_step`` in int8 storage (the hair mask the witness's on
        every side): the card's G gradients no farther from the CPU's f32
        step on the dequantised weights than INT8_CARD_FACTOR times the
        CPU's int8 step, or that step with one rounding moved (its
        resizes' forward from f32), whichever lies farther, plus
        BATTERY_PARITY_RTOL.

    Why a factor and not BATTERY_PARITY_RTOL card against CPU: the random
    battery is chaotic at 32 px, where every net upsamples its input, and
    most in bf16 (ROADMAP Queue 3 item 17): moving one rounding of the
    CPU's own int8 step moves its G gradients up to several times their
    distance from f32 (``predictor_precision_probe``, section 3). The
    card's f32 runs with TF32 off, as phase 9's."""
    from gan_control_torch.losses.int8_storage import Int8Battery
    from gan_control_torch.losses.registry import distinct_predictors
    from gan_control_torch.tools import predictor_precision_probe as probe

    setup, specs, cpu_preds = started["setup"], started["specs"], started["cpu_preds"]
    wait_for_child(started["child"], started["out"], started["log"], "int8 card vs cpu")
    cpu_res = torch.load(started["out"], weights_only=False)
    log(f"int8 card vs cpu (24d): the CPU side took {cpu_res['seconds']:.1f} s in its own process")

    def copies(device):
        return battery_copies(cpu_preds, device)

    card8 = Int8Battery(copies("cuda"), "cuda")
    flat = card8.dequantize()
    if (_digest(card8.q), _digest(card8.scales), _digest(flat)) != (cpu_res["q"], cpu_res["scales"],
                                                                     cpu_res["dequant"]):
        fail("int8 card vs cpu: the card's quantisation or dequantisation differs from the CPU's")
    del flat

    img = setup["img"]
    resize_backward_check(img, torch.bfloat16, "int8 card vs cpu (24d)")

    views = card8.nets(torch.bfloat16)
    card16 = copies("cuda")
    with torch.no_grad():
        for name, m in distinct_predictors(card16).items():
            m.to(torch.bfloat16)
            sd = m.state_dict()
            for key, v in views[name].tensors.items():
                sd[key].copy_(v)
        for al in specs:
            got = al.feature_fn(views[al.name], img.cuda().to(torch.bfloat16))
            ref16 = al.feature_fn(card16[al.name], img.cuda().to(torch.bfloat16))
            if not all(torch.equal(a, b) for a, b in zip(got, ref16)):
                fail(f"int8 card: {al.name}'s features from the store differ from the bf16 battery's")
    del views, card16

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i, name in enumerate(distinct_predictors(card8)):
            net = cpu_res["nets"][name]
            d = probe.int8_net_distances(net["witness"], net["cpu"], probe.int8_net_grads(
                card8, name, img[:INT8_NET_ROWS], 300 + i, net["logit"]))
            log(f"int8 card vs cpu (24d) {name}: image gradient of a projection, {INT8_NET_ROWS} rows, relative "
                f"L2 from float64 on the bf16 weights: bf16 cpu {d['cpu_bf16']:.4g}, card {d['card_bf16']:.4g} "
                f"(tol {INT8_NET_FACTOR} x cpu + {BATTERY_PARITY_RTOL}); f32 card from cpu "
                f"{d['card_f32_vs_cpu_f32']:.3g} (tol {PREDICTOR_GRAD_REL_L2}; cpu {d['cpu_f32']:.4g}, card "
                f"{d['card_f32']:.4g} from float64)")
            if d["card_f32_vs_cpu_f32"] > PREDICTOR_GRAD_REL_L2 or \
                    d["card_bf16"] > INT8_NET_FACTOR * d["cpu_bf16"] + BATTERY_PARITY_RTOL:
                fail(f"int8 card vs cpu: {name}'s image gradient on the card departs from the CPU's")
        logit = cpu_res["logit"]
        card8["hair_loss"].mask_logit = lambda t: logit.to(t.device, t.dtype)
        card = probe.int8_g_step_grads(setup, specs, "int8", card8, "cuda")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    ref = cpu_res["ref"]
    cpu_err, moved_err, card_err = (probe.g_rel_l2(g, ref) for g in (cpu_res["cpu"], cpu_res["moved"], card))
    spread = max(cpu_err, moved_err)
    log(f"int8 card vs cpu (24d): size-32 g_step in int8 storage, G gradients relative L2 from the CPU's f32 step "
        f"on the dequantised weights: CPU {cpu_err:.4g}, CPU with one rounding moved {moved_err:.4g}, card "
        f"{card_err:.4g} (tol {INT8_CARD_FACTOR} x the larger CPU's + {BATTERY_PARITY_RTOL}); card from CPU "
        f"{probe.g_rel_l2(card, cpu_res['cpu']):.4g}")
    if not all(bool(torch.isfinite(t).all()) for t in card.values()) or \
            card_err > INT8_CARD_FACTOR * spread + BATTERY_PARITY_RTOL:
        fail(f"int8 card vs cpu: the card's gradients are {card_err:.3g} from the f32 step, the CPU's {spread:.3g}")
    del card8
    torch.cuda.empty_cache()


def developer_probes_phase() -> None:
    """24e: ``profile_bench``'s generation at batch 128 (its ``g_full``
    step ran on 24b's int8 trainer) and ``loader_bench`` on a small corpus
    (the PIL loader; the native one where its library builds): a smoke
    test of the tools, not a loader rate."""
    from gan_control_torch.tools import loader_bench, profile_bench

    with Phase("profile_bench (24e)"), phase7_tf32():
        out = profile_bench.main(["gen"])
        log(f"profile_bench: {json.dumps(out)}")
        if not out["gen"]["full_ms"] > out["gen"]["mapping_ms"] > 0:
            fail(f"profile_bench: {out}")
    torch.cuda.empty_cache()
    with Phase("loader_bench (24e)"):
        rows = loader_bench.main(LOADER_ARGS)
        for r in rows:
            log(f"loader_bench: {json.dumps(r)}")
        if not any(r.get("backend") == "python_pil" and r["imgs_per_s"] > 0 for r in rows):
            fail(f"loader_bench: {rows}")

# ---------------------------------------------------------------------------
# phase 25: float16 battery storage, collective_scaling, the notebook
# ---------------------------------------------------------------------------

F16_ITERS = 2  # train(2) on 24b's trainer, its battery recast to float16
F16_ROUNDS = 3  # timed g_steps per leg (float16, bf16, adversarial only)
F16_CALIBRATION_ROWS = 4
# 25b: the card's distance from the float64 witness (per net) or from the
# CPU's f32 step on the float16 weights (the g_step) as a multiple of the
# CPU's, as 24d bounds bf16 (INT8_NET_FACTOR, INT8_CARD_FACTOR): the
# random battery is chaotic in any low precision (ROADMAP Queue 3 item 2);
# float16 holds 3 more mantissa bits than bf16, so the factors are bf16's
F16_NET_FACTOR = 1.5
F16_CARD_FACTOR = 2.0
F16_PROJ_SEED = 400
# 25b's size-32 step: a batch of four on two latent groups (a float16
# convolution on the card machine's CPU is far slower than an f32 one: phase
# 9's batch of 16 on seven groups outlasted the script)
F16_BATCH = 4
F16_NET_ROWS = 2  # each net alone on two of its images
F16_GROUPS = {"embedding_loss": "id", "orientation_loss": "id", "age_loss": "id", "expression_loss": "other",
              "hair_loss": "other", "recon_gamma_loss": "other"}
# the JAX tool's FFHQ-512 parameter bytes (tools/ici_scaling.py
# flagship_param_bytes; tests/test_torch_collective_scaling.py holds the
# port's to them on the CPU)
JAX_FLAGSHIP_PARAM_BYTES = {"g": 124812188, "d": 115931396}


def float16_setup(specs) -> tuple[dict, tuple]:
    """25b's size-32 model (``predictor_precision_probe.size32_setup``'s,
    seeds as there) at batch F16_BATCH on two latent groups, and ``specs``
    (phase 9's six losses) on those groups: the float16 ``g_step`` of
    tests/test_torch_float16_step.py. Both sides build it alike."""
    from gan_control_torch.tools import predictor_precision_probe as probe

    config = json.loads(probe.CONFIG.read_text())
    half = F16_BATCH // 2
    config["training_config"].update(batch=F16_BATCH, mini_batch=F16_BATCH, sub_groups_dict={
        "id": {"place_in_latent": [0, 256], "place_in_mini_batch": [0, half], "count_in_mini_bach": [2, 2]},
        "other": {"place_in_latent": [256, 512], "place_in_mini_batch": [half, F16_BATCH],
                  "count_in_mini_bach": [2, 2]}})
    return probe.size32_setup(config), tuple(dataclasses.replace(al, group=F16_GROUPS[al.name]) for al in specs)


def float16_cpu_child(inputs: str, out: str) -> None:
    """25b's CPU side, in a fresh interpreter on the CPU (CPU_CHILD_THREADS
    threads) from the end of phase 9 on, beside 24d's: phase 9's calibrated battery
    (``inputs``) in f32 and cast to float16; on :func:`float16_setup`'s
    model, per net (INT8_NET_ROWS of its images) a float64 witness on the
    float16 weights (its image gradient of a seeded projection and the
    hair net's mask logit) and the CPU's float16 gradients and f32 ones
    on the float16 weights; the witness's hair logit on all its images;
    its ``g_step``'s G gradients with the battery in f32 on the float16
    weights and in float16, the hair net on the witness's mask. Writes
    them, with each part's seconds, to ``out``."""
    from gan_control_torch.losses.registry import build_attr_losses, cast_predictor_params, distinct_predictors
    from gan_control_torch.tools import predictor_precision_probe as probe

    torch.set_num_threads(CPU_CHILD_THREADS)
    t0 = time.perf_counter()
    times = {}
    saved = torch.load(inputs, weights_only=False)
    setup = probe.size32_setup(json.loads(probe.CONFIG.read_text()))
    specs, f32 = build_attr_losses({**setup["tc"], "predictor_precision": "highest"}, device="cpu", seed=3)
    for name, m in distinct_predictors(f32).items():
        m.load_state_dict(saved["nets"][name])
    setup, specs = float16_setup(specs)
    f16 = cast_predictor_params(f32, "float16")
    # f32 on the float16 weights (a statistic past 65504 stays inf): the
    # same function as the float16 battery, as 24d's f32 reference runs on
    # the dequantised weights
    f32 = cast_predictor_params(battery_copies(f16, "cpu"), "float32")
    rows = setup["img"][:F16_NET_ROWS]
    res: dict = {"nets": {}}
    for i, name in enumerate(distinct_predictors(f16)):
        t = time.perf_counter()
        want, logit = probe.witness_of(f16[name], rows, F16_PROJ_SEED + i)
        res["nets"][name] = {"witness": want, "logit": logit, "cpu": probe.net_grads(
            {"f16": f16[name], "f32": f32[name]}, rows, F16_PROJ_SEED + i, logit)}
        times[name] = time.perf_counter() - t
    witness = copy.deepcopy(f16["hair_loss"]).double()
    with torch.no_grad():
        res["logit"] = logit = witness.mask_logit(witness.resize_input(setup["img"].double()))
    for battery in (f32, f16):  # one hair mask everywhere: the witness's
        battery["hair_loss"].mask_logit = lambda t: logit.to(t.device, t.dtype)
    for key, dtype, battery in (("ref", "float32", f32), ("cpu", "float16", f16)):
        t = time.perf_counter()
        res[key] = probe.int8_g_step_grads(setup, specs, dtype, battery, "cpu")
        times[f"g_step {key}"] = time.perf_counter() - t
    res["times"], res["seconds"] = times, time.perf_counter() - t0
    torch.save(res, out)


@contextlib.contextmanager
def fp16_reduction(allowed: bool):
    """cuBLAS's reduced-precision reduction for float16 GEMMs, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = allowed
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = saved


def float16_card_vs_cpu(started: dict) -> None:
    """25b: float16 storage on the card against the CPU, on
    :func:`float16_setup`'s size-32 model and phase 9's calibrated battery
    (the CPU's side from :func:`float16_cpu_child`), by 24d's method:

      - the predictors' float16 resize backward on the card (32 -> 256 px)
        within one float16 rounding of the CPU's f32 gradient
        (F.interpolate's own float16 backward logged beside it);
      - each net alone (F16_NET_ROWS images, the hair net on the witness's
        mask): the f32 image gradient on the float16 weights card against
        CPU to PREDICTOR_GRAD_REL_L2, and the float16 one no farther from
        the float64 witness than F16_NET_FACTOR times the CPU's, plus
        BATTERY_PARITY_RTOL;
      - the ``g_step`` in float16 storage: the card's G gradients no
        farther from the CPU's f32 step on the float16 weights than
        F16_CARD_FACTOR times the CPU's float16 step, plus
        BATTERY_PARITY_RTOL; every gradient finite. 24d also takes the
        CPU's step with one rounding moved, because at its seed the CPU's
        int8 step lies unusually near f32; in float16 the two lay within
        0.2 % of each other on the card's machine (0.0229 and 0.02286), and
        that step took 80 s of its CPU, so 25b skips it.

    Each float16 reading is taken with cuBLAS's reduced-precision reduction
    on (PyTorch's default, which the port keeps) and logged again with it
    off. The card's f32 runs with TF32 off, as phase 9's."""
    from gan_control_torch.losses.registry import cast_predictor_params, distinct_predictors
    from gan_control_torch.tools import predictor_precision_probe as probe

    cpu_preds = started["cpu_preds"]
    setup, specs = float16_setup(started["specs"])
    wait_for_child(started["child16"], started["out16"], started["log16"], "float16 card vs cpu")
    cpu_res = torch.load(started["out16"], weights_only=False)
    log(f"float16 card vs cpu (25b): the CPU side took {cpu_res['seconds']:.1f} s in its own process ("
        + ", ".join(f"{k} {v:.1f}" for k, v in cpu_res["times"].items()) + ")")

    img = setup["img"]
    resize_backward_check(img, torch.float16, "float16 card vs cpu (25b)")

    card16 = cast_predictor_params(battery_copies(cpu_preds, "cuda"), "float16")
    card32 = cast_predictor_params(battery_copies(card16, "cuda"), "float32")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i, name in enumerate(distinct_predictors(card16)):
            net, rows, seed = cpu_res["nets"][name], img[:F16_NET_ROWS], F16_PROJ_SEED + i
            with fp16_reduction(True):
                card = probe.net_grads({"f16": card16[name], "f32": card32[name]}, rows, seed, net["logit"])
            with fp16_reduction(False):
                off = probe.net_grads({"f16": card16[name]}, rows, seed, net["logit"])["f16"]
            d = probe.int8_net_distances(net["witness"], net["cpu"], card)
            log(f"float16 card vs cpu (25b) {name}: image gradient of a projection, {F16_NET_ROWS} rows, "
                f"relative L2 from float64 on the float16 weights: float16 cpu {d['cpu_f16']:.4g}, card "
                f"{d['card_f16']:.4g} (tol {F16_NET_FACTOR} x cpu + {BATTERY_PARITY_RTOL}), card with cuBLAS's "
                f"float16 reduced-precision reduction off {probe._rel(off, net['witness']):.4g} (from the card's "
                f"with it on {probe._rel(off, card['f16']):.3g}); f32 card from cpu {d['card_f32_vs_cpu_f32']:.3g} "
                f"(tol {PREDICTOR_GRAD_REL_L2})")
            if d["card_f32_vs_cpu_f32"] > PREDICTOR_GRAD_REL_L2 or \
                    d["card_f16"] > F16_NET_FACTOR * d["cpu_f16"] + BATTERY_PARITY_RTOL:
                fail(f"float16 card vs cpu: {name}'s image gradient on the card departs from the CPU's")
        logit = cpu_res["logit"]
        card16["hair_loss"].mask_logit = lambda t: logit.to(t.device, t.dtype)
        with fp16_reduction(True):
            card = probe.int8_g_step_grads(setup, specs, "float16", card16, "cuda")
        with fp16_reduction(False):
            card_off = probe.int8_g_step_grads(setup, specs, "float16", card16, "cuda")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    ref = cpu_res["ref"]
    cpu_err, card_err = probe.g_rel_l2(cpu_res["cpu"], ref), probe.g_rel_l2(card, ref)
    log(f"float16 card vs cpu (25b): size-32 g_step in float16 storage, G gradients relative L2 from the CPU's "
        f"f32 step on the float16 weights: CPU {cpu_err:.4g}, card {card_err:.4g} (tol {F16_CARD_FACTOR} x "
        f"the CPU's + {BATTERY_PARITY_RTOL}); card from CPU "
        f"{probe.g_rel_l2(card, cpu_res['cpu']):.4g}; card with the reduced-precision reduction off "
        f"{probe.g_rel_l2(card_off, ref):.4g} (from the card's with it on {probe.g_rel_l2(card_off, card):.3g})")
    if not all(bool(torch.isfinite(t).all()) for t in (*card.values(), *cpu_res["cpu"].values())) or \
            card_err > F16_CARD_FACTOR * cpu_err + BATTERY_PARITY_RTOL:
        fail(f"float16 card vs cpu: the card's gradients are {card_err:.3g} from the f32 step, the CPU's {cpu_err:.3g}")
    del card16, card32
    torch.cuda.empty_cache()


def float16_train_phase(trainer) -> tuple[Counter, dict]:
    """25a: 24b's FFHQ-512 trainer (batch 16) with its battery recast: the
    config's six nets drawn again from the trainer's seed, their
    batch-norm statistics set from the trainer's G images (at random init
    the R-Net's activations pass float16's 65504 and its coefficients turn
    NaN, in the JAX package too; ROADMAP Queue 3) and stored in float16.
    ``train(F16_ITERS)`` with the counters set to 0 just before and read
    just after: each step kind against ``expected_step_counts`` (the
    battery launches none of the port's kernels), finite losses and G
    gradients, the battery unchanged and in float16; then ``g_step`` timed
    beside the same weights in bf16 and the adversarial loss alone (the
    legs in turn, ``battery_share``'s way), with each leg's resident battery
    and peak. Returns the recorded launches and their counts."""
    from gan_control_torch.losses.registry import build_attr_losses, calibrate_battery, cast_predictor_params
    from gan_control_torch.losses.registry import distinct_predictors
    from gan_control_torch.ops import kernels
    from gan_control_torch.tools import battery_share as bs
    from gan_control_torch.tools import train_mfu as tm
    from gan_control_torch.trainers import generator_trainer as gt
    from gan_control_torch.training import train_step as ts

    st, cfg, spec = trainer.state, trainer.step_cfg, trainer.spec
    seen: Counter = Counter()
    with phase7_tf32():
        with Phase("float16 battery (25a)"):
            specs, f32 = build_attr_losses(trainer.tc, device="cuda")
            z = torch.from_numpy(np.random.default_rng(9).standard_normal((F16_CALIBRATION_ROWS, cfg.style_dim))
                                 .astype(np.float32)).cuda()
            with torch.no_grad():
                images, _ = ts._gen_images(st, cfg, spec, (z,), None, None, arrange=False)
            calibrate_battery(f32, images.float())
            bf16 = cast_predictor_params(battery_copies(f32, "cuda"), "bfloat16")
            f16 = cast_predictor_params(f32, "float16")
            before = {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in distinct_predictors(f16).items()}
            overflowed = [f"{n}.{k}" for n, sd in before.items() for k, v in sd.items()
                          if v.is_floating_point() and not torch.isfinite(v).all()]
            trainer.predictors, trainer.attr_losses = f16, tuple(specs)
            trainer.step_cfg = f16_cfg = dataclasses.replace(cfg, predictor_dtype="float16")
            log(f"float16 storage (25a): {sum(len(sd) for sd in before.values())} tensors of {len(before)} nets, "
                f"resident {bs.battery_bytes(f16) / 1e6:.2f} MB (bf16 {bs.battery_bytes(bf16) / 1e6:.2f} MB); "
                f"batch-norm statistics from {F16_CALIBRATION_ROWS} G images; tensors past float16's range "
                f"(stored as inf, as the JAX cast stores them): {overflowed or 'none'}")

        per_kind = expected_step_counts(st.generator, st.discriminator, len(spec.groups))
        with Phase("float16 main path (25a)"):
            by_kind, restore = count_by_kind(gt)
            remove = install_launch_recorder(seen)
            history = len(trainer.metrics_history)
            torch.cuda.reset_peak_memory_stats()
            try:
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                trainer.train(F16_ITERS)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
            finally:
                remove()
                restore()
            peak = torch.cuda.max_memory_allocated()
            log(f"float16 main path: launches over train({F16_ITERS}) {counts}")
            runs = {k: len(v) for k, v in by_kind.items()}
            if runs != {"d_step": F16_ITERS, "d_reg_step": 1, "g_step": F16_ITERS, "g_reg_step": 1}:
                fail(f"float16: step kinds run {runs}")
            for kind in gt.STEP_KINDS:
                for got in by_kind[kind]:
                    if got != per_kind[kind]:
                        fail(f"float16 {kind}: launches {got}, expected {per_kind[kind]}")
            attr_names = [f"g_{al.name}" for al in specs]
            for h in trainer.metrics_history[history:]:
                if not all(math.isfinite(v) for v in h.values()) or not all(n in h for n in attr_names):
                    fail(f"float16: losses not finite or missing: {h}")
                log(f"float16 train losses, iteration {h['iter']}: "
                    + ", ".join(f"{n} {h[n]:.6g}" for n in attr_names) + f"; g_loss {h['g_loss']:.6g}")
            bad = [n for n, q in st.generator.named_parameters() if q.grad is None or not torch.isfinite(q.grad).all()]
            if bad:
                fail(f"float16: G gradients missing or not finite after train({F16_ITERS}): {bad[:5]}")
            for n, m in distinct_predictors(f16).items():
                sd = m.state_dict()
                if any(not torch.equal(v, before[n][k]) or v.dtype != before[n][k].dtype for k, v in sd.items()):
                    fail(f"float16: {n} changed in training")
                if any(v.is_floating_point() and v.dtype != torch.float16 for v in sd.values()):
                    fail(f"float16: {n} holds {sorted({str(v.dtype) for v in sd.values()})}")
            log(f"float16: G gradients finite; the battery unchanged and in float16; peak memory "
                f"{peak / 2**30:.2f} GiB")

        with Phase("float16 against bf16 (25a)"):
            zt = torch.from_numpy(np.random.default_rng(0).standard_normal((cfg.batch, cfg.style_dim))
                                  .astype(np.float32)).cuda()
            legs = {}
            for name, leg_cfg, s_, preds in (("g_step_battery_f16", f16_cfg, specs, f16),
                                            ("g_step_battery_bf16", dataclasses.replace(cfg, predictor_dtype="bfloat16"),
                                             specs, bf16),
                                            ("g_step_adv_only", cfg, (), {})):
                def run(c=leg_cfg, sp=s_, pr=preds):
                    return ts.g_step(st, c, spec, (zt,), attr_losses=sp, predictors=pr,
                                     augment_fn=trainer.augment_fn)

                legs[name] = bs.Leg(tm.Exe(run, 1.0, cfg.batch), bs.battery_bytes(preds))
            rows = bs.measure(legs, "cuda", F16_ROUNDS)
            for r in rows:
                log("float16 against bf16 " + bs.line(r) + f" (steps {[round(t, 2) for t in r['times_ms']]} ms)")
            if not all(math.isfinite(r["ms"]) and r["ms"] > 0 and r["peak_bytes"] > 0 for r in rows):
                fail(f"float16 against bf16: bad rows {rows}")
    trainer.step_cfg = cfg
    del f16, bf16, legs, before
    torch.cuda.empty_cache()
    return seen, counts


def notebook_phase(build_root: Path, seen: Counter) -> dict:
    """25d: ``gan_control_torch/examples/gan_control_inference_example.ipynb``'s
    code cells in order on the card (``examples/notebook.py``), against
    phase 13's controller directory (random weights: the age and
    orientation heads, the generator's args enabling the predictor losses,
    so cell 4 runs ``ControlExtractor``), with the counters set to 0 just
    before and read just after. Returns the counts."""
    from gan_control_torch.examples import notebook
    from gan_control_torch.ops import kernels

    out = build_root / "notebook"
    if out.exists():
        import shutil

        shutil.rmtree(out)
    env = {"GANCTL_CONTROLLER_DIR": str(build_root / "phase2" / "controller"), "GANCTL_OUT": str(out),
           "GANCTL_DEVICE": "cuda"}
    saved = {k: os.environ.get(k) for k in env}
    with Phase("notebook (25d)"):
        os.environ.update(env)
        remove = install_launch_recorder(seen)
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            ns = notebook.run()
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        finally:
            remove()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        files = sorted(p.name for p in out.iterdir())
        want = ["controlled.jpg", f"interp_{sorted(ns['ctrl'].fc_controls)[0]}.gif", "recovered_controls.jpg",
                "samples.jpg"]
        log(f"notebook: {len(notebook.code_cells())} code cells on the card, controllable groups "
            f"{sorted(ns['ctrl'].fc_controls)}; wrote {files}; launches {counts}")
        if files != sorted(want) or any((out / f).stat().st_size == 0 for f in files):
            fail(f"notebook: wrote {files}, expected {sorted(want)}")
        if not all(counts[n] for n in INFER_KERNELS) or any(counts[n] for n in KERNELS if n not in INFER_KERNELS):
            fail(f"notebook: launches {counts}")
    del ns
    torch.cuda.empty_cache()
    return counts


def collective_scaling_start(build_root: Path, iteration_ms: float) -> dict:
    """25c: ``python -m gan_control_torch.tools.collective_scaling`` started
    (its Part A on gloo ranks on the CPU), given phase 7's plain iteration."""
    out = build_root / "tools" / "collective_scaling.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    run = start_cli("gan_control_torch.tools.collective_scaling",
                    ["--iteration_ms", f"{iteration_ms:.3f}", "--out", str(out)],
                    build_root / "tools" / "collective_scaling.log")
    return {"run": run, "out": out, "iteration_ms": iteration_ms}


def collective_scaling_finish(started: dict, card: str) -> None:
    """25c to its end: its lines logged; its JSON names this card and its
    power limit, its parameter bytes are the JAX tool's, every step's
    gradients are all-reduced once at exactly their bytes, and the
    projection has its five rows."""
    with Phase("collective_scaling (25c)"):
        for line in finish_cli(started["run"], 600):
            if not line.startswith("[W"):
                log(f"collective_scaling: {line}")
        rec = json.loads(started["out"].read_text())
        ok = (rec["card"] or {}).get("nvidia_smi") == card and rec["flagship_param_bytes"] == JAX_FLAGSHIP_PARAM_BYTES \
            and [r["chips"] for r in rec["projection"]] == [1, 2, 4, 8, 16] \
            and rec["inputs"]["iteration_ms"]["value"] == round(started["iteration_ms"], 3) \
            and all(st["gradient_all_reduces"] == 1 and st["gradient_ratio"] == 1.0
                    for c in rec["collectives"] for st in c["steps"].values())
        log(f"collective_scaling: worlds {[c['world'] for c in rec['collectives']]}, traffic ratio "
            f"{rec['traffic_ratio']:.3f}, card {rec['card'] and rec['card'].get('nvidia_smi')}, parameter bytes "
            f"{rec['flagship_param_bytes']} (the JAX tool's {JAX_FLAGSHIP_PARAM_BYTES}); {started['out']}")
        if not ok:
            fail(f"collective_scaling: its record is wrong: {json.dumps(rec)[:2000]}")



def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU only")
    needed = [REPO / "gan_control_torch" / "ops" / "kernels.py", CONFIGS / "ffhq.json"]
    missing = [str(p) for p in needed if not p.exists()]
    if missing:
        fail(f"run from the root of a checkout; missing {missing}")
    build_root = REPO / "build" / "gan_control_torch"
    build_root.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("TRITON_CACHE_DIR", str(build_root / "triton_cache"))

    from gan_control_torch.ops import kernels

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    with Phase("build"):
        report = kernels.build()
        for lib, r in report.items():
            regs = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]
            log(f"build {lib}: nvcc {r['seconds']:.1f} s; " + " | ".join(regs))
        probe = torch.ones(4, 8, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            p = probe.to(dt)
            kernels.fused_bias_act(p, torch.zeros(8, device="cuda"))
            kernels.fused_bias_act_grad(p, p, torch.zeros(8, device="cuda"))
        kernels.blur2x_up(probe.view(1, 2, 2, 8))
        kernels.blur2x_down(probe.view(1, 2, 2, 8))
        kernels.blur_sep(probe.view(1, 2, 2, 8), (0.5, 0.5), (0.5, 0.5), (1, 0))
        block = kernels.DEQUANT_BLOCK
        for dt in (torch.float32, torch.bfloat16):
            kernels.dequant_int8(torch.zeros(block, dtype=torch.int8, device="cuda"), torch.ones(1, device="cuda"),
                                 torch.zeros(1, dtype=torch.int32, device="cuda"), [(0, block)], dt)
        torch.cuda.synchronize()

    # 3-6. inference
    infer_totals, infer_counts = inference_phases(build_root)
    for n in INFER_KERNELS:
        log(f"inference totals {n}: launches {infer_counts[n]} " + totals_text(infer_totals[n]))

    # 7-9. training
    seen, counts, synthetic, (seen9, counts9) = train_phase(build_root)
    # 7b's preempted command line runs beside phase 9, which times nothing
    folder_started = image_folder_start(build_root)
    with Phase("train card vs cpu (with the predictors on their own)"):
        int8_started = int8_cpu_start(build_root, *train_card_vs_cpu())
    ffhq_run = image_folder_phase(build_root, synthetic, folder_started)
    with Phase("train kernels"):
        totals = train_kernel_phase(seen)
        blur_sep_variant_check()
    for n in GD_KERNELS:
        log(f"train({TRAIN_ITERS}) totals {n}: launches {counts[n]} " + totals_text(totals[n]))
    # the blur2x pair against the one PyTorch call that computes each
    for label, tot in (("blur2x_up over one generation call", infer_totals["blur2x_up"]),
                       (f"blur2x_up over train({TRAIN_ITERS})", totals["blur2x_up"]),
                       (f"blur2x_down over train({TRAIN_ITERS})", totals["blur2x_down"])):
        log(f"blur2x vs library: {label}: host-rate {tot['ms']:.4f} ms vs {tot['library_ms']:.4f} ms "
            f"({tot['ms'] / tot['library_ms']:.2f}x); device {tot['device_ms']:.4f} ms vs "
            f"{tot['library_device_ms']:.4f} ms; bound {tot['bound_ms']:.4f} ms")

    # 10-14. phase 2
    seen2, counts2 = phase2(build_root)
    with Phase("phase 2 kernels"):
        totals2 = train_kernel_phase(seen2, "phase 2", both_dtypes=False)
    for n in GD_KERNELS:
        log(f"phase 2 totals {n}: launches {counts2[n]} " + totals_text(totals2[n]))
    merge_totals(totals, totals2)

    # 15. serving
    seen3, counts3, seen32 = serving_phase(build_root)
    with Phase("serving kernels"):
        totals3 = train_kernel_phase(seen3, "serving", both_dtypes=False)
        train_kernel_phase(seen32, "the serving f32 check", both_dtypes=False)
    for n in INFER_KERNELS:
        log(f"serving totals {n}: launches {counts3[n]} " + totals_text(totals3[n]))
    if any(counts3[n] for n in KERNELS if n not in INFER_KERNELS) or not all(counts3[n] for n in INFER_KERNELS):
        fail(f"the serving path launched {counts3}")
    merge_totals(totals, totals3)

    # 16. evaluation; 18 (a) and (b), AFHQ's and MetFaces' command lines,
    # run beside phase 16's (which time nothing) and end before its
    # in-process part
    eval_folder = evaluation_folder(build_root)
    started18 = afhq_metfaces_start(build_root, ffhq_run, eval_folder)
    seen4, counts4 = evaluation_phase(build_root, eval_folder, lambda: afhq_metfaces_wait(started18))
    with Phase("evaluation kernels"):
        totals4 = train_kernel_phase(seen4, "evaluation", both_dtypes=False)
    for n in INFER_KERNELS:
        log(f"evaluation totals {n}: launches {counts4[n]} " + totals_text(totals4[n]))
    if any(counts4[n] for n in KERNELS if n not in INFER_KERNELS) or not all(counts4[n] for n in INFER_KERNELS):
        fail(f"the evaluation path launched {counts4}")
    merge_totals(totals, totals4)

    # 18. AFHQ and MetFaces: ADA, the three new nets, transfer learning
    seen5, counts5 = afhq_metfaces_phase(started18)
    with Phase("afhq and metfaces kernels"):
        totals5 = train_kernel_phase(seen5, f"AFHQ and MetFaces train({NEW_ITERS})", both_dtypes=False)
    for n in GD_KERNELS:
        log(f"afhq and metfaces totals {n}: launches {counts5[n]} " + totals_text(totals5[n]))
    if counts5 != {n: sum(c for key, c in seen5.items() if key[0] == n) for n in KERNELS}:
        fail(f"the AFHQ and MetFaces launch hooks disagree with the counters {counts5}")
    merge_totals(totals, totals5)

    # 22b, the control-fidelity harness (its phase 1 is the longest of the
    # blob world's trainings), starts here and trains beside phases 19-22
    blob_procs = start_blob_children(build_root, ("fidelity",))

    # 19-20. alignment in the phase-2a sweep, and projection
    seen6: Counter = Counter()
    counts6: dict = {n: 0 for n in KERNELS}
    model_dir = build_root / "phase2" / "controller" / "generator"
    unaligned = re.search(r"\(([\d.]+) rows/s", (build_root / "make_attributes_df.log").read_text())
    alignment_phase(build_root, model_dir, float(unaligned[1]) if unaligned else None, seen6, counts6)
    projection_phase(build_root, model_dir, seen6, counts6)
    with Phase("alignment and projection kernels"):
        totals6 = train_kernel_phase(seen6, "alignment and projection", both_dtypes=False)
    for n in GD_KERNELS:
        log(f"alignment and projection totals {n}: launches {counts6[n]} " + totals_text(totals6[n]))
    if counts6 != {n: sum(c for key, c in seen6.items() if key[0] == n) for n in KERNELS} or counts6["blur_sep"]:
        fail(f"the alignment and projection launch hooks disagree with the counters {counts6}")
    merge_totals(totals, totals6)

    # 21. data parallelism across processes
    seen7, counts7 = distributed_phase(build_root)
    with Phase("distributed kernels"):
        totals7 = train_kernel_phase(seen7, f"two-rank train_generator --iters {DIST_ITERS}",
                                     both_dtypes=False)
    for n in GD_KERNELS:
        log(f"distributed totals {n}: launches {counts7[n]} " + totals_text(totals7[n]))
    merge_totals(totals, totals7)

    # 22. the blob world, the marge mapping and meshed serving; the
    # convergence harness trains in a process of its own meanwhile, beside
    # the control-fidelity one
    seen8: Counter = Counter()
    counts8: dict = {n: 0 for n in KERNELS}
    blob_procs = {**start_blob_children(build_root, ("convergence",)), **blob_procs}
    # 25c: collective_scaling on phase 7's plain iteration, its Part A on
    # the CPU, read at the end
    scaling = collective_scaling_start(build_root, synthetic["median"])
    marge_phase(build_root, seen8, counts8)
    meshed_serving_phase(build_root, seen8, counts8)
    # 23b-c meanwhile: the measuring tools' untimed work; and 24a-b, 24d,
    # 24e, 25b and 25d, which time no step
    measuring = measuring_start(build_root)
    seen10, counts10, (t_dq, tb_dq, by_dq, err_dq), int8_trainer = int8_train_phase(build_root)
    with Phase("int8 card vs cpu (24d)"):
        int8_card_vs_cpu(int8_started)
    with Phase("float16 card vs cpu (25b)"):
        float16_card_vs_cpu(int8_started)
    developer_probes_phase()
    seen11: Counter = Counter()
    counts_nb = notebook_phase(build_root, seen11)
    blob_phase(build_root, blob_procs, seen8, counts8)
    with Phase("phase 22 kernels"):
        totals8 = train_kernel_phase(seen8, "phase 22", both_dtypes=False)
    for n in GD_KERNELS:
        log(f"phase 22 totals {n}: launches {counts8[n]} " + totals_text(totals8[n]))
    merge_totals(totals, totals8)

    # 23d. the measuring tools (23a ran on phase 7's trainer, 23b-c beside
    # phase 22's blob-world processes)
    measuring_finish(build_root, measuring, seen9, counts9)
    with Phase("phase 23 kernels"):
        totals9 = train_kernel_phase(seen9, "phase 23", both_dtypes=False)
    for n in GD_KERNELS:
        log(f"phase 23 totals {n}: launches {counts9[n]} " + totals_text(totals9[n]))
    merge_totals(totals, totals9)

    # 24. int8 storage of the battery (24a-b, 24d and 24e ran beside phase
    # 22's blob-world processes) and battery_share's four legs
    with Phase("phase 24 kernels"):
        totals10 = train_kernel_phase(Counter({k: c for k, c in seen10.items() if k[0] != "dequant_int8"}),
                                      f"int8 train({INT8_ITERS})", both_dtypes=False)
    add_to_totals(totals10["dequant_int8"], counts10["dequant_int8"], t_dq, tb_dq, by_dq)
    totals10["dequant_int8"]["max_abs_err"] = err_dq
    for n in KERNELS:
        log(f"phase 24 totals {n}: launches {counts10[n]} " + totals_text(totals10[n]))
    merge_totals(totals, totals10)
    battery_share_phase()

    # 25. float16 storage of the battery on 24b's trainer (25a; 25b and the
    # notebook, 25d, ran beside phase 22's blob-world processes) and
    # collective_scaling (25c)
    seen25a, counts25a = float16_train_phase(int8_trainer)
    int8_trainer.close()
    del int8_trainer
    torch.cuda.empty_cache()
    collective_scaling_finish(scaling, card)
    seen11.update(seen25a)
    counts11 = {n: counts_nb[n] + counts25a[n] for n in KERNELS}
    if counts11 != {n: sum(c for key, c in seen11.items() if key[0] == n) for n in KERNELS}:
        fail(f"phase 25: the launch hooks disagree with the counters {counts11}")
    with Phase("phase 25 kernels"):
        totals11 = train_kernel_phase(seen11, "phase 25", both_dtypes=False)
    for n in KERNELS:
        log(f"phase 25 totals {n}: launches {counts11[n]} " + totals_text(totals11[n]))
    merge_totals(totals, totals11)

    entries = []
    for n, (route, src, replaces) in KERNELS.items():
        tot = totals[n]
        entries.append({
            "name": n, "route": route, "source": src, "replaces": replaces,
            "launches": counts[n] + counts2[n] + counts3[n] + counts4[n] + counts5[n] + counts6[n]
            + counts7[n] + counts8[n] + counts9[n] + counts10[n] + counts11[n],
            "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "device_ms": tot["device_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
            "library_ms": tot["library_ms"],
        })
    slowest = sorted(PHASE_SECONDS, key=lambda kv: -kv[1])[:12]
    log("phase seconds, the slowest: " + "; ".join(f"{name} {sec:.1f}" for name, sec in slowest))
    log(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
