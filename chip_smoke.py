#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each timed on its own line:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: every CUDA source of the port, one nvcc each, all at once;
  3. kernels: ``corr_fwd`` against ``correlation_plain`` on the card at the
     five level shapes of Sintel's 448x1024 working size, batch 4 (md=4
     and md=2), of the FlyingChairs train step (batch 8, 320x448; md=4)
     and of the cascade's train step (batch 4, 320x768; md=4 and md=2),
     and ``corr_bwd_f1``/``corr_bwd_f2`` against their plain versions at
     the five level shapes of the FlyingChairs train step (md=4) and of
     the cascade's (md=2); each plus odd shapes and the edges of the
     tiling (``CORR_EDGES``: md 1-4, N=1, W below the tile and not a
     multiple of 8, a partial last channel chunk, 7 cluster ranks), f32
     and bf16, LeakyReLU on and off, f16 once (``CORR_F16_CASES``); the
     gradients also on a cotangent that is a channel slice of a larger
     tensor (bitwise equal to the contiguous result), at a batch past the
     65535 of a grid's y and z dimensions (``BIG_BATCH``), and through
     ``correlation`` and ``torch.cat`` without a copy of it; then every
     level of every main path in bf16 (``CORR_PATHS``): each kernel with
     the L2 flushed before each call, back to back, the wrapper's host
     time a call, the plain version's time, the bound and the tiling
     ``corr_plan`` gives (blocks, threads, cluster size);
  4. deform: ``deform_fwd`` and ``deform_bwd`` (each set of gradients the
     paths ask for: dweight; dflow and dweight; all three) against the
     plain pair ``deform_fwd_plain``/``deform_bwd_plain`` at the four
     deformable convs of the MaskFlownet_S train step (batch 8, 320x448),
     the inference levels (batch 4, 448x1024; deform6 the widest, 196
     channels at 7x16) and the cascade train step's five (batch 4,
     320x768), an odd shape whose windows lie wholly outside the image
     (flow +-50) or sit at integer flows or whose w9 is compact, and the
     tiling's edges (a partial last K chunk in a K split, Cout past a
     column tile and off w9's 8-element pitch), f32 and bf16; the deform
     kernels' registers, spills and shared memory from ``nvcc -Xptxas
     -v``; then each level's bf16 time with the L2 flushed before each
     call (the backward whole and its data and weight kernels alone),
     beside its bound, achieved TFLOP/s, block counts, the plain pair's
     and ``warpconv``'s (forward, and forward + backward), and kernels
     against ``warpconv`` at every deformable conv of both models;
  5. slice: ``Predictor.do_batch`` on 4 Sintel-sized pairs (436x1024) with
     seeded weights at the published widths: f32 with the kernel against
     f32 with the plain correlation, the card against the CPU on a small
     pair, then the main path in bf16 with its launch counts (5
     ``corr_fwd``, 4 ``deform_fwd``: ``ModelConfig.deform``'s ``"auto"``
     takes the deform kernels on the card), and its time per frame;
  6. train: ``Trainer.train_batch`` on a synthetic FlyingChairs-sized batch
     (image 2 is image 1 shifted by a known flow) with the same weights:
     an f32 step on the card against the same step on the CPU, an f32
     step with the kernels against one with the plain correlation (batch
     2, 320x448), then the main path -- bf16, batch 8, 320x448 -- with
     the launch count of each kernel, ms/step, samples/s, peak memory, and
     a loss after 30 steps below the first;
  7. augment: ``affine_sample`` (the sampler of geometric augmentation)
     against ``affine_sample_plain`` at both of the FlyingChairs step's
     launches (batch 8, 384x512 sources sampled at 320x448, coordinates
     from ``draw_geometry`` with the chairs presets) and at an odd shape
     whose coordinates leave the image, f32 and bf16 input; its time
     with the L2 flushed before each call, beside its bound (the source
     pixels the coordinates touch, read once), the plain version's and
     ``F.grid_sample``'s; an
     f32 augmented step on the card against the same step on the CPU with
     the same draws (batch 1, 96x128 -> 64x128); then the main path --
     ``Trainer.train_batch`` with colour and geometry on, bf16, batch 8,
     384x512 -> 320x448 -- with the launch count of every kernel, ms/step,
     samples/s, peak memory and a finite loss, after checking that the
     step draws and augments without waiting for the card;
  8. cascade: the MaskFlownet cascade with ``deform="kernel"``.
     ``Predictor.do_batch``: f32 card vs CPU (64x128), f32 kernel vs
     ``warpconv`` on 4 Sintel-sized pairs (448x1024 working size), then
     the main path in bf16 with its launch counts (15 ``corr_fwd``, 9
     ``deform_fwd``) and the ms/frame of both methods. The frozen-head
     train step (``fix_head``, aug-off, a shifted batch): f32 card vs CPU,
     f32 kernel vs ``warpconv`` (batch 2, 320x768), then the main path --
     bf16, batch 4, 320x768 -- with the launch count of every kernel, the
     gradients each ``deform_bwd`` is asked for (never dx; dweight only at
     level 6), the head bitwise unchanged, a finite loss, ms/step,
     samples/s and peak memory. Then one f32 MaskFlownet_S step with
     ``deform="kernel"`` (the full deform backward) against ``warpconv``;
  9. input: the FlyingChairs input path. A FlyingChairs tree of 16
     synthetic pairs at 384x512 (``data.synthetic``, ``data.codecs``) in a
     temporary directory, read back by ``data.chairs`` bitwise; the CLI's
     ``TrainLoader([Dataset(train)] * 8, 8, (384, 512))`` into a
     ``DeviceBatchCache`` of 8 slots with the (B,1,1,1) mask appended, and
     the chairs presets' augmented bf16 S step (384x512 -> 320x448)
     through ``Trainer.train_batch_device``: warm-up launches checked, no
     synchronisation from ``cache.get()`` through ``prepare`` (whether the
     whole step synchronises is printed), then ms/step, samples/s and
     peak memory with exact launch counts through the cache while it
     refreshes (``echo_factor``, ``transfers``), through the cache only
     serving, through ``train_batch`` on host NCHW batches (a pageable
     copy each step) and through ``DevicePrefetcher``; served tensors
     checked against the host's checksums of their transfer index while
     2 slots (and a prefetcher of depth 2) are replaced under the steps;
     an f32 step of ``train_batch_device`` on a cached batch against
     ``train_batch`` on the same host batch with the same draws (loss and
     epe bitwise), and the card's against the CPU's on a 96x128 corner;
     a batch's bytes and its pinned and pageable copy times;
 10. cli: the training CLI, ``maskflownet_torch.cli.main.main`` called in
     this process at the published widths and shapes (the stock chairs
     config: batch 8, 384x512 sources, 320x448 crops; copies of the stock
     ``MaskFlownet_S.yaml`` and ``MaskFlownet.yaml`` with their schedules
     cut to a few steps) on trees written in a temporary directory: the
     chairs tree of phase 9, a Sintel tree at 436x1024 (2 training
     sequences x 4 frames in clean and final with flow, invalid masks and
     a split file; a test sequence of 3 frames) and KITTI 2012/2015 trees
     at 370x1224 (3 training pairs with flow_occ, 2 testing pairs), their
     8-bit PNGs written by a small zlib writer here (every row filter,
     several IDAT chunks). The S stage through the device cache (20 steps,
     ``--aug device``), the S stage through host geometry (10 steps, the
     CLI's default ``--aug host``: the prefetcher and the numpy warp on its
     thread), the augmented cascade stage from the first S run's
     checkpoint with ``--clear_steps`` (10 steps: ``load_head``, the frozen
     head, its parameters required bitwise those of the S checkpoint),
     each validating on chairs and Sintel at steps 1 and every 10;
     ``--valid`` with the cascade's checkpoint in f32 at 128x256 on the
     card and on the CPU (every logged EPE and Fl-all within 1e-4
     relative); ``--predict`` with it, its ``.flo`` files bitwise and its
     PNG16 files equal to ``Trainer.predict`` on the same frames after
     ``kitti_flow_encode``. Each run: exit code 0, finite loss and epe at
     every logged step, its checkpoint read back through ``interop``, the
     exact launch count of every kernel (the steps' and each validation
     forward's), and no thread ``main`` started still alive when it
     returns; then every launch shape the runs recorded that no earlier
     check covered is held against the plain versions. It prints each
     stage's ms/step and samples/s from the log's moving averages
     (``total_time``, ``loading_time``), the cache's ``echo_factor`` and
     the validation sweeps' ms/frame;
 11. tools: the published-checkpoint tools at the published widths, on
     phase 10's Sintel and KITTI trees. Gluon ``.params`` files of
     MaskFlownet_S and the cascade (seeded, He-scale weights; the keys
     and layouts Gluon writes) through ``tools.import_mxnet``: the read,
     the conversion and the ``.npz`` write timed with their bytes, the
     ``.npz`` read back by ``interop`` bitwise the in-memory import, and
     the ``bgr`` import on channel-reversed images against the ``rgb``
     import (f32, 64x128). ``tools.infer``: ``-i`` on a 436x1024 pair with
     each checkpoint and ``--frames`` on 5 frames (``--batch 4``), bf16,
     its ``.flo`` bitwise and its PNGs equal to ``Trainer.predict`` on the
     same frames; ``--video`` without OpenCV raises ``ImportError``.
     ``tools.parity_eval`` with the S ``.params`` file: all four rows
     computed, an absent root SKIPPED, nothing mounted exit code 2, and
     the card against the CPU in f32 (one pair a row, KITTI read at
     256x128) within 1e-4 relative. Exact launch counts a tool run; the
     import's seconds, ``infer``'s ms/frame beside ``do_batch``'s and
     ``parity_eval``'s ms per frame per row;
 12. parallel: data parallelism over processes and the H-sharded forward,
     each rank a process of its own (this script with
     ``--parallel-worker``; a rank that fails fails the phase). The
     machine has one card, so two ranks share it over gloo, which reduces
     CUDA tensors through the host: its times are gloo-on-one-card times,
     not NCCL's. Two gloo ranks: the f32 augmented chairs S step (384x512
     -> 320x448) as 2 ranks x 1 sample against one process x 2 with the
     same draws (loss and all-reduced gradients as they run and on the
     one process's branches, the parameters after 3 steps, the replicas'
     gradients and parameters bitwise equal), the S gradients' all-reduce
     time, one data-parallel step of the frozen-head cascade (bf16,
     320x768, 1 a rank; the head bitwise unchanged, exact launches), and
     the row-sharded forwards of both models at 896x2048, batch 1, f32
     and bf16, against the whole forward (launch counts, ms/frame and
     peak memory a rank beside the whole forward's). Then ``python -m
     maskflownet_torch.cli.main`` as two gloo processes on phase 10's
     chairs tree (the stock chairs config, global batch 8, 4 a rank, a
     device cache, 10 steps): rank 0 alone writes the log and the
     checkpoint, which reads back; exact launches a rank; ms/step a rank
     beside phase 10's one-process stage. Then the bf16 augmented S step
     in a one-rank NCCL group, in turns with the same step without a
     group: no synchronisation with the host, ms/step of both, the
     all-reduce's time; NCCL across cards only where the machine has two
     (else "not run"). Every launch shape the ranks recorded is held
     against the plain versions as in phase 10.
 13. native (after phase 11, on its trees): the port's C++ host runtime
     (``maskflownet_torch/native/``): a fresh ``g++`` build on this host
     timed; ``png_unfilter`` bitwise against the plain ``codecs._unfilter``
     on random rows filtered by every filter id and by all five in turn,
     at a Sintel frame (436x1024, 8-bit RGB, stride 3072), a KITTI flow
     PNG (370x1224, 16-bit RGB, stride 7344) and 1, 2, 4 and 8 bytes a
     pixel; filter 5 refused; the unfilter's ms/frame native and plain, ``image_load``/``png16_load`` through each; and
     ``infer -i``'s ms/frame past ``load_trainer`` from phase 11, which
     decoded and encoded through it, beside ``do_batch``'s;
 14. twopass: the JAX package's TPU sampler of geometric augmentation
     (``TrainSettings.aug_sampler="twopass"``, the CLI's
     ``--aug_sampler``), card vs CPU with the same draws (f32, then as
     the step samples: bf16 images, f16 labels) and its labels against
     the exact sampler at ~300 px flow; then bf16 ms/step of the
     augmented S step, chairs batch 8, ``affine_sample`` vs ``twopass``
     in alternating windows, exact launch counts in every window.
The card-vs-CPU comparisons run the deform kernels' form on both sides
(``deform="kernel"``: its plain pair on the CPU), so that both take the
same sample coordinates.
Two f32 steps held against each other (card vs CPU, the kernels vs
``warpconv``) are compared as they run, and again with the second taking
the first's side of every kink (LeakyReLU inputs, fused cost-volume
activations and, card vs CPU, the deform coordinates' floors) where the
two fall on different sides: the gradient behind such a value jumps by the
difference of the slopes. Without a flipped branch both readings are held
to the tolerance, with one only the second.
The warm-up of every bf16 main path records each correlation and deform
launch by kernel, shape, dtype (and the gradients a deform backward asks
for) and requires each to be one that phase 3 or 4 held against the plain
version (phases 10 and 11 hold the shapes their runs launched after
them). Then
one JSON line describing the kernels, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
import zlib
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

import maskflownet_torch.cli.main as cli_module
import maskflownet_torch.models.maskflownet as model_module
import maskflownet_torch.ops.correlation as corr_module
import maskflownet_torch.ops.deform as deform_module
import maskflownet_torch.tools.import_mxnet as imx_module
import maskflownet_torch.tools.infer as infer_module
import maskflownet_torch.tools.parity_eval as parity_module
from maskflownet_torch import native
from maskflownet_torch.augment import draw_geometry, geometry_augmentation
from maskflownet_torch.augment.geometry import _maps as geometry_maps
from maskflownet_torch.augment.geometry import sample_grids
from maskflownet_torch import interop
from maskflownet_torch.config import CONFIG_DIR, load_config, presets
from maskflownet_torch.data import (Dataset, DeviceBatchCache, TrainLoader,
                                    chairs, codecs, kitti, sintel, synthetic,
                                    with_mask)
from maskflownet_torch.inference import Predictor, centralize
from maskflownet_torch.models import (HEAD_SCOPE, ModelConfig, build_model,
                                      init_params, param_shapes)
from maskflownet_torch.nn import apply_ctx
from maskflownet_torch.ops import _build
from maskflownet_torch.ops.affine import affine_sample, affine_sample_plain
from maskflownet_torch.ops.affine2pass import affine_sample_twopass
from maskflownet_torch.ops.correlation import (corr_bwd_f1, corr_bwd_f2,
                                               corr_fwd, correlation,
                                               correlation_bwd_f1_plain,
                                               correlation_bwd_f2_plain,
                                               correlation_plain)
from maskflownet_torch.ops.deform import (_warpconv, deform_bwd,
                                          deform_bwd_plain, deform_fwd,
                                          deform_fwd_plain, weight_to_w9)
from maskflownet_torch.ops.warp import base_grid, normalized_to_pixels
from maskflownet_torch.ops.resample import upsample
from maskflownet_torch.parallel import (DevicePrefetcher, all_reduce_mean,
                                        batch_sharding, make_mesh,
                                        make_spatial_forward,
                                        make_spatial_mesh)
from maskflownet_torch.tools import grad_parity
from maskflownet_torch.tools.flow_vis import flow_to_color
from maskflownet_torch.training import (TrainSettings, Trainer,
                                        find_checkpoints, nchw_batch)

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,       # f32 outside the tensor cores
              torch.bfloat16: 989e12,     # dense bf16 / f16 tensor cores
              torch.float16: 989e12}
# (level, (N, C, H, W)) of MaskFlownet_S at 448x1024, batch 4
LEVELS = [(2, (4, 32, 112, 256)), (3, (4, 64, 56, 128)), (4, (4, 96, 28, 64)),
          (5, (4, 128, 14, 32)), (6, (4, 196, 7, 16))]
EXTRA_CASES = [(2, (4, 64, 56, 128)), (4, (1, 8, 9, 13)), (2, (1, 8, 9, 13))]
# (level, (N, C, H, W)) of the MaskFlownet_S train step: FlyingChairs crop
# 320x448, batch 8
TRAIN_LEVELS = [(2, (8, 32, 80, 112)), (3, (8, 64, 40, 56)),
                (4, (8, 96, 20, 28)), (5, (8, 128, 10, 14)),
                (6, (8, 196, 5, 7))]
TRAIN_EXTRA = [(2, (8, 64, 40, 56)), (4, (1, 8, 9, 13)), (2, (1, 8, 9, 13))]
# (level, (N, C, H, W)) of the cascade's frozen-head train step: 320x768,
# batch 4 (its inference works at LEVELS' shapes, 448x1024, batch 4)
CASCADE_TRAIN_LEVELS = [(2, (4, 32, 80, 192)), (3, (4, 64, 40, 96)),
                        (4, (4, 96, 20, 48)), (5, (4, 128, 10, 24)),
                        (6, (4, 196, 5, 12))]
# the correlation kernels' cases at the edges of their tiling, (md, (N, C,
# H, W)), held in f32 and bf16 like the levels: md 1-4; N = 1; W below the
# 16-column tile and W not a multiple of 8 (copies of 4, 2 and 1 element);
# C = 20, 36, 100 with a partial last 32-channel chunk, and C = 196 at N =
# 1 split over 7 cluster ranks
CORR_EDGES = [(1, (1, 20, 6, 7)), (2, (3, 100, 6, 12)), (3, (2, 40, 5, 18)),
              (4, (2, 36, 7, 33)), (4, (1, 196, 5, 7)), (1, (2, 24, 4, 40))]
# f16, run once for the three tensor-core kernels: the S step's level 2 and
# one edge
CORR_F16_CASES = [(4, TRAIN_LEVELS[0][1]), (4, (2, 36, 7, 33))]
# the gradients at a batch whose N * ceil(C / 8) = 66560 passes the 65535 of
# a grid's y and z dimensions (corr_bwd_f1's first design carried it there)
BIG_BATCH = (4, (1040, 512, 2, 3))
# f32: kernel and plain version sum over C in different orders; bf16 and
# f16: the kernel's output is one rounding (<= 2^-8, 2^-11 relative) of the
# f32 value
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=8e-3, atol=1e-5),
       torch.float16: dict(rtol=1e-3, atol=1e-5)}
# the correlation timing rows, (path, md, levels): every level of the three
# main paths at each md it runs (the cascade's stage 2 at md=2); the
# gradients where a backward runs: the S step (md=4) and the frozen cascade
# step, whose backward reaches only stage 2 (md=2)
CORR_PATHS = [("S step", 4, TRAIN_LEVELS), ("inference", 4, LEVELS),
              ("cascade inference", 2, LEVELS),
              ("cascade step", 4, CASCADE_TRAIN_LEVELS),
              ("cascade step", 2, CASCADE_TRAIN_LEVELS)]
CORR_BWD_PATHS = [("S step", 4, TRAIN_LEVELS),
                  ("cascade step", 2, CASCADE_TRAIN_LEVELS)]
SLICE_BATCH, SLICE_HW = 4, (436, 1024)
# f32 slice, kernel path vs plain path: both f32 with TF32 off, differing
# only in the correlation's summation order (~1e-7 relative), which the
# following convs carry to the flow far below a thousandth of a pixel
FLOW_TOL_PX = 1e-3
TRAIN_BATCH, TRAIN_HW, TRAIN_LR = 8, (320, 448), 1e-4
# f32 steps, card vs CPU and kernel vs plain: the loss within rtol 1e-5 and
# every parameter's gradient within 1e-3 of its norm (summation order
# only; the same bounds hold the CPU step against JAX in the tests)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
# the augmented FlyingChairs step: sources at the chairs preset's native
# size, crops at TRAIN_HW; the card-vs-CPU check at a small size
AUG_SRC_HW = presets.ORIG_SHAPE["chairs"]
AUG_SMALL_SRC_HW, AUG_SMALL_HW = (96, 128), (64, 128)
# the sampler: f32 weights and sums on both sides, in another order (FMA
# contraction), on values of order 1 to 10 (images, flow * mask)
AFFINE_TOL = dict(rtol=1e-5, atol=1e-5)
# augmented inputs, card vs CPU: images and mask 1e-5; the flow, the
# difference of two pixel coordinates of up to ~127 (f32 ulp 7.6e-6) whose
# sin/cos-derived maps may round differently on the two devices, 1e-4 px
# where the mask is solidly inside
AUG_IMAGE_TOL, AUG_FLOW_TOL_PX = 1e-5, 1e-4
# (name, launcher, plain version, feature the gradient is taken against):
# corr_bwd_f1 reads f2, corr_bwd_f2 reads f1
BWD = [("corr_bwd_f1", corr_bwd_f1, correlation_bwd_f1_plain, 1),
       ("corr_bwd_f2", corr_bwd_f2, correlation_bwd_f2_plain, 0)]
# (level, (N, Cin, H, W), Cout) of the deformable convs: the four of the
# MaskFlownet_S train step (FlyingChairs 320x448, batch 8), then the
# cascade's widest, deform6 at Sintel's 448x1024, batch 4
DEFORM_LEVELS = [(5, (8, 128, 10, 14), 128), (4, (8, 96, 20, 28), 96),
                 (3, (8, 64, 40, 56), 64), (2, (8, 32, 80, 112), 32)]
DEFORM_L6 = (6, (4, 196, 7, 16), 196)
# ((N, Cin, H, W), Cout) at the edges of the kernels' tiling: a K split
# whose last chunk is partial, Cout past one column tile and not a multiple
# of 8, 189 and 132 pixels
DEFORM_EDGES = [((3, 20, 7, 9), 40), ((2, 24, 6, 11), 150)]
# the gradient subsets the paths ask for (dx, dflow, dweight): the frozen
# cascade's level 6, its levels 5-2, and the S step
DEFORM_NEEDS = [(False, False, True), (False, True, True), (True, True, True)]
# kernel vs plain deform, as max |diff| over max |plain| of each output: f32
# results (every forward in f32, every gradient) sum the same f32 products
# in another order (and dx with atomics), 1e-5; a bf16 forward output is one
# bf16 rounding of the f32 value, <= 2^-8 relative
DEFORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# the cascade: inference on SLICE_BATCH Sintel-sized pairs; the frozen-head
# train step at bench.py's cascade row, batch 4 at 320x768
CASCADE_BATCH, CASCADE_TRAIN_HW = 4, (320, 768)
# kernel launches of one cascade forward (5 cost volumes at md=4 in the
# head, 10 at md=2 in stage 2; 4 + 5 deformable convs), and of one
# frozen-head step, whose backward reaches only stage 2: corru's f1 is a
# head feature, corrv's two pyramids are stage 2's; every deform's x is a
# head feature, deform6's flow is the head's
CASCADE_FWD = {"corr_fwd": 15, "deform_fwd": 9}
# kernel launches of one MaskFlownet_S forward and step, its 4 deformable
# convs on the kernels (ModelConfig's "auto" on the card)
S_FWD = {"corr_fwd": 5, "deform_fwd": 4}
S_STEP = {"corr_fwd": 5, "corr_bwd_f1": 5, "corr_bwd_f2": 5,
          "deform_fwd": 4, "deform_bwd": 4}
# the deformable conv's two forms, forced: card-vs-CPU comparisons run the
# kernels' form on both (the CPU its plain pair), A/B runs warpconv
KERNEL_CFG, WARP_CFG = ModelConfig(deform="kernel"), ModelConfig(
    deform="warpconv")
CASCADE_STEP = {"corr_fwd": 15, "corr_bwd_f1": 5, "corr_bwd_f2": 10,
                "deform_fwd": 9, "deform_bwd": 5}
KERNELS = (corr_fwd, corr_bwd_f1, corr_bwd_f2, deform_fwd, deform_bwd,
           affine_sample)
# the branch values a step comparison replays (grad_parity.branches);
# kernel vs warpconv leaves out the coordinates, which warpconv takes one
# pixel further on
BRANCHES = ("coords", "leaky", "corr")
# the input phase: a FlyingChairs tree of INPUT_SAMPLES synthetic pairs,
# the CLI's loader ([Dataset(train)] * batch) into a cache of INPUT_SLOTS
# slots, INPUT_TIMED timed steps a way of feeding the step;
# INTEGRITY_STEPS steps on 2 slots replaced as fast as the refresh thread
# can (``integrity``), the compute stream sleeping SLEEP_CYCLES (~10 ms at
# the H100's 1.98 GHz) between a step and the checksums of its batch, so
# that a slot whose memory a later copy took would be read after that copy
INPUT_SAMPLES, INPUT_SLOTS, INPUT_TIMED = 16, 8, 20
INTEGRITY_STEPS, SLEEP_CYCLES = 30, 20_000_000
# the cli phase: the S stage through the device cache (CLI_S_STEPS steps),
# through host geometry (CLI_HOST_STEPS), the cascade from the first
# (CLI_CASCADE_STEPS), validating at steps 1 and every CLI_VAL_STEPS; a
# Sintel tree of 2 training sequences of CLI_SINTEL_FRAMES frames (the
# first in the split's training1, the second in training2) and a test
# sequence of CLI_SINTEL_TEST frames, KITTI trees of CLI_KITTI_TRAIN
# training and CLI_KITTI_TEST testing pairs an edition, at the datasets'
# native sizes; --valid on the card and on the CPU at CLI_RESIZE, their
# metrics within CLI_VALID_RTOL of each other (f32, the same forms: only
# summation orders differ)
CLI_S_STEPS, CLI_HOST_STEPS, CLI_CASCADE_STEPS, CLI_VAL_STEPS = 20, 10, 10, 10
CLI_SLOTS = 8
CLI_SINTEL_FRAMES, CLI_SINTEL_TEST = 4, 3
CLI_KITTI_TRAIN, CLI_KITTI_TEST, CLI_KITTI_HW = 3, 2, (370, 1224)
CLI_RESIZE, CLI_VALID_RTOL = "128,256", 1e-4
# the tools phase: Gluon checkpoints of both networks at the published
# widths, drawn from TOOLS_SEED; ``infer -i`` on one Sintel pair with
# each, ``--frames`` on TOOLS_FRAMES frames, TOOLS_BATCH pairs a batch;
# the bgr import on channel-reversed images against the rgb import at
# TOOLS_SMALL_HW (f32), within BGR_REL of the outputs' scale;
# ``parity_eval`` on the cli phase's trees, and the card against the CPU
# (f32, one pair a row, KITTI read at PARITY_KITTI_CUT, width x height)
# within PARITY_RTOL; ``do_batch`` timed over TOOLS_REPS calls
TOOLS_SEED, TOOLS_FRAMES, TOOLS_BATCH, TOOLS_REPS = 11, 5, 4, 10
TOOLS_SMALL_HW, BGR_REL = (64, 128), 2e-5
PARITY_KITTI_CUT, PARITY_RTOL = (256, 128), 1e-4
# every (kernel, shape, md or Cout, dtype[, needs]) that a check held
# against its plain version (keys as ``launch_key`` makes them); each main
# path's launches must lie in it
CHECKED = set()


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def corr_bound_ms(shape, md: int, dtype: torch.dtype):
    """Least time for one cost volume: each input read once, the output
    written once, against the multiply-adds at the dtype's peak."""
    n, c, h, w = shape
    dd = (2 * md + 1) ** 2
    size = torch.tensor([], dtype=dtype).element_size()
    bytes_ms = (2 * n * c * h * w + n * dd * h * w) * size / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * c * h * w * dd / PEAK_FLOPS[dtype] * 1e3
    return bytes_ms, ops_ms


def bwd_bound_ms(shape, md: int, dtype: torch.dtype, leaky: bool):
    """Least time for one gradient kernel: g (and, with the LeakyReLU, the
    saved output) and one feature map read once, the gradient written
    once, against its multiply-adds at the dtype's peak."""
    n, c, h, w = shape
    dd = (2 * md + 1) ** 2
    size = torch.tensor([], dtype=dtype).element_size()
    maps = (2 if leaky else 1) * n * dd * h * w
    bytes_ms = (maps + 2 * n * c * h * w) * size / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * c * h * w * dd / PEAK_FLOPS[dtype] * 1e3
    return bytes_ms, ops_ms


def plan_note(shape, md: int, kernel: str) -> str:
    """The tiling ``corr_plan`` gives a correlation kernel on this card, as
    a short string, its shared memory held against the library's own
    count."""
    plan = corr_module.corr_plan(*shape, md, torch.cuda.get_device_properties(
        0).multi_processor_count)
    lib = corr_module._lib()
    if kernel == "corr_fwd":
        for es in (2, 4):
            require(lib.mfn_corr_smem_bytes(
                0, es, md, plan.fwd_th, plan.fwd_wj, plan.fwd_ndg,
                plan.fwd_kc) == corr_module.fwd_smem_bytes(
                    es, md, plan.fwd_th, plan.fwd_wj, plan.fwd_ndg,
                    plan.fwd_kc), "corr_fwd shared memory: library and plan "
                    "disagree")
        return (f"{plan.fwd_blocks} blocks of {plan.fwd_threads} threads, "
                f"cluster {plan.fwd_cs} (th {plan.fwd_th}, wj {plan.fwd_wj}, "
                f"ndg {plan.fwd_ndg}, kc {plan.fwd_kc}"
                f"{', at its floor' if plan.fwd_floor else ''})")
    pre = "bwd" if kernel == "corr_bwd_f2" else "f1"
    th, wj, cpb, blocks, threads, floor = (
        getattr(plan, f"{pre}_{k}")
        for k in ("th", "wj", "cpb", "blocks", "threads", "floor"))
    runs = corr_module.f1_runs(shape[3], wj)
    for es in (2, 4):
        if kernel == "corr_bwd_f2":
            smem = lib.mfn_corr_smem_bytes(1, es, md, th, wj, cpb, 0)
            mirror = corr_module.bwd_smem_bytes(es, md, th, wj, cpb)
        else:
            smem = lib.mfn_corr_smem_bytes(2, es, md, th, wj, cpb, runs)
            mirror = corr_module.bwd_f1_smem_bytes(es, md, th, wj, cpb, runs)
        require(smem == mirror,
                f"{kernel} shared memory: library and plan disagree")
    return (f"{blocks} blocks of {threads} threads, cluster 1 (th {th}, wj "
            f"{wj}, cpb {cpb}, {smem} B shared memory in f32"
            f"{', at its floor' if floor else ''})")


def check_corr_fwd_case(md, shape, gen) -> dict:
    """corr_fwd vs the plain version at one (md, shape), f32 and bf16 (and
    f16 at CORR_F16_CASES), LeakyReLU on and off; records each dtype in
    CHECKED; returns the largest error of each dtype."""
    worst = {}
    base1 = torch.randn(shape, generator=gen, device="cuda")
    base2 = torch.randn(shape, generator=gen, device="cuda")
    dtypes = (torch.float32, torch.bfloat16) + (
        (torch.float16,) if (md, shape) in CORR_F16_CASES else ())
    for dtype in dtypes:
        f1, f2 = base1.to(dtype), base2.to(dtype)
        for leaky in (None, 0.1):
            got = corr_fwd(f1, f2, md, leaky)
            torch.cuda.synchronize()
            want = correlation_plain(f1.float(), f2.float(), md, leaky)
            require(got.dtype == dtype and got.shape == want.shape,
                    f"corr_fwd output {got.dtype} {tuple(got.shape)}")
            torch.testing.assert_close(got.float(), want, **TOL[dtype])
            err = (got.float() - want).abs().max().item()
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        CHECKED.add(("corr_fwd", tuple(shape), md, dtype))
    print(f"corr_fwd check md={md} {shape} "
          f"{'/'.join(str(d).split('.')[1] for d in dtypes)}: ok; "
          f"{plan_note(shape, md, 'corr_fwd')}", flush=True)
    return worst


def check_kernel(gen):
    """corr_fwd vs the plain version on every case: md=4 at the level
    shapes of every main path, md=2 at the cascade's, the extra cases and
    the tiling's edges, f32 and bf16; f16 at CORR_F16_CASES; returns the
    largest f32 error."""
    worst = {dt: 0.0 for dt in TOL}
    cases = ([(4, s) for _, s in LEVELS + TRAIN_LEVELS + CASCADE_TRAIN_LEVELS]
             + [(2, s) for _, s in LEVELS + CASCADE_TRAIN_LEVELS]
             + EXTRA_CASES + CORR_EDGES)
    for md, shape in cases:
        for dtype, err in check_corr_fwd_case(md, shape, gen).items():
            worst[dtype] = max(worst[dtype], err)
    print("corr_fwd max |err|: " + ", ".join(
        f"{str(dt).split('.')[1]} {worst[dt]:.3e} (tol {TOL[dt]})"
        for dt in TOL), flush=True)
    return worst[torch.float32]


def _bwd_inputs(shape, md, dtype, leaky, gen):
    """f1, f2, the cotangent g and the saved output (None without leaky)."""
    n, c, h, w = shape
    f1 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    f2 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn((n, (2 * md + 1) ** 2, h, w), generator=gen,
                    device="cuda").to(dtype)
    out = None if leaky is None else correlation_plain(f1, f2, md, leaky)
    return (f1, f2), g, out


def channel_slice(g):
    """g as the channel slice of a larger tensor that a concatenation's
    gradient hands the correlation (3 channels before it, 4 after): each
    image one dense block, the images further apart."""
    n, dd, h, w = g.shape
    big = torch.zeros((n, dd + 7, h, w), dtype=g.dtype, device=g.device)
    big[:, 3:3 + dd] = g
    return big[:, 3:3 + dd]


def check_corr_bwd_case(md, shape, gen) -> dict:
    """corr_bwd_f1/f2 vs their plain versions at one (md, shape), f32 and
    bf16 (and f16 at CORR_F16_CASES), LeakyReLU on and off, each also on
    the cotangent as a channel slice of a larger tensor, required bitwise
    equal to the result on a contiguous copy; records each in CHECKED;
    returns the largest error of each (kernel, dtype)."""
    worst = {}
    f16 = (md, shape) in CORR_F16_CASES
    for dtype in (torch.float32, torch.bfloat16) + (
            (torch.float16,) if f16 else ()):
        for leaky in (None, 0.1):
            feats, g, out = _bwd_inputs(shape, md, dtype, leaky, gen)
            if leaky is not None:
                require(bool((out < 0).any() and (out > 0).any()),
                        "the saved output holds both signs")
            gs = channel_slice(g)
            require(corr_module.dense_per_image(gs) and (
                shape[0] == 1 or not gs.is_contiguous()),
                "the channel slice is dense per image, not contiguous")
            for name, kernel, plain, which in BWD:
                got = kernel(g, feats[which], out, md, leaky)
                got_s = kernel(gs, feats[which], out, md, leaky)
                torch.cuda.synchronize()
                want = plain(g.float(), feats[which].float(),
                             None if out is None else out.float(), md,
                             leaky)
                require(got.dtype == dtype and got.shape == want.shape,
                        f"{name} output {got.dtype} {tuple(got.shape)}")
                torch.testing.assert_close(got.float(), want,
                                           **TOL[dtype])
                require(torch.equal(got_s, got), f"{name} on a channel "
                        "slice of the cotangent differs from the "
                        "contiguous result")
                err = (got.float() - want).abs().max().item()
                worst[(name, dtype)] = max(worst.get((name, dtype), 0.0),
                                           err)
                CHECKED.add((name, tuple(shape), md, dtype))
    print(f"corr_bwd_f1/f2 check md={md} {shape}{' (+f16)' if f16 else ''}"
          f" (cotangent contiguous and a channel slice): ok; corr_bwd_f1 "
          f"{plan_note(shape, md, 'corr_bwd_f1')}; corr_bwd_f2 "
          f"{plan_note(shape, md, 'corr_bwd_f2')}", flush=True)
    return worst


def check_bwd_kernels(gen):
    """corr_bwd_f1/f2 vs their plain versions (``check_corr_bwd_case``) at
    the S train step's level shapes (md=4), the cascade step's (md=2), the
    extra cases, the tiling's edges and BIG_BATCH. Returns the largest f32
    error of each."""
    worst = {(name, dt): 0.0 for name, *_ in BWD for dt in TOL}
    cases = ([(4, s) for _, s in TRAIN_LEVELS]
             + [(2, s) for _, s in CASCADE_TRAIN_LEVELS] + TRAIN_EXTRA
             + CORR_EDGES + [BIG_BATCH])
    for md, shape in cases:
        for key, err in check_corr_bwd_case(md, shape, gen).items():
            worst[key] = max(worst[key], err)
    for name, *_ in BWD:
        print(f"{name} max |err|: " + ", ".join(
            f"{str(dt).split('.')[1]} {worst[(name, dt)]:.3e}" for dt in TOL),
            flush=True)
    return {name: worst[(name, torch.float32)] for name, *_ in BWD}


def check_cotangent_not_copied(gen):
    """Through ``correlation`` and a concatenation, as the dense blocks use
    it: the backward hands both gradient kernels the concatenation's
    gradient slice itself, not a copy."""
    shape, md = TRAIN_LEVELS[1][1], 4
    f1, f2 = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
              .requires_grad_() for _ in range(2))
    other = torch.randn((shape[0], 5, *shape[2:]), generator=gen,
                        device="cuda").bfloat16()
    seen = []
    spies = []
    for real in (corr_bwd_f1, corr_bwd_f2):
        def spy(g, *args, _real=real):
            seen.append((_real.__name__, g.data_ptr(), g.stride()))
            return _real(g, *args)
        spy.launches = real.launches
        spies.append((real, spy))
    with contextlib.ExitStack() as stack:
        for real, spy in spies:
            stack.enter_context(mock.patch.object(corr_module, real.__name__,
                                                  spy))
        y = torch.cat([other, correlation(f1, f2, md, 0.1), other], 1)
        gy = torch.randn(y.shape, generator=gen, device="cuda").bfloat16()
        y.backward(gy)
    for real, spy in spies:
        real.launches = spy.launches
    torch.cuda.synchronize()
    want_ptr = gy.data_ptr() + 5 * gy.stride(1) * gy.element_size()
    require(len(seen) == 2 and all(ptr == want_ptr and st == gy.stride()
                                   for _, ptr, st in seen),
            f"the gradient kernels got a copy of the cotangent: {seen}")
    print(f"cotangent through torch.cat: both gradient kernels read the "
          f"slice in place (strides {gy.stride()}, no copy)", flush=True)


def host_ms(fn, calls: int = 100) -> float:
    """Host time of one call of ``fn`` (a launch well inside the queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return t


def time_corr(gen):
    """bf16 with the LeakyReLU (the paths' case), every level of every main
    path (CORR_PATHS; the gradients at CORR_BWD_PATHS): each kernel with
    the L2 flushed before the call, back to back (L2-warm), the wrapper's
    host time a call, the plain version (L2 flushed), the bound and the
    plan. Returns the rows."""
    rows = []
    for kernels, paths in ((("corr_fwd",), CORR_PATHS),
                           (("corr_bwd_f1", "corr_bwd_f2"), CORR_BWD_PATHS)):
        for path, md, levels in paths:
            for lvl, shape in levels:
                (f1, f2), g, out = _bwd_inputs(shape, md, torch.bfloat16,
                                               0.1, gen)
                for name in kernels:
                    if name == "corr_fwd":
                        def kern():
                            return corr_fwd(f1, f2, md, 0.1)

                        def plain():
                            return correlation_plain(f1, f2, md, 0.1)
                        bytes_ms, ops_ms = corr_bound_ms(shape, md,
                                                         torch.bfloat16)
                    else:
                        _, kernel, plain_fn, which = next(
                            b for b in BWD if b[0] == name)
                        f = (f1, f2)[which]

                        def kern(kernel=kernel, f=f):
                            return kernel(g, f, out, md, 0.1)

                        def plain(plain_fn=plain_fn, f=f):
                            return plain_fn(g, f, out, md, 0.1)
                        bytes_ms, ops_ms = bwd_bound_ms(shape, md,
                                                        torch.bfloat16, True)
                    row = dict(kernel=name, path=path, md=md, level=lvl,
                               shape=list(shape), ms=cuda_ms_cold(kern),
                               warm_ms=cuda_ms(kern), host_ms=host_ms(kern),
                               plain_ms=cuda_ms_cold(plain, reps=5),
                               bound_ms=max(bytes_ms, ops_ms),
                               bound_by="bytes" if bytes_ms >= ops_ms
                               else "operations",
                               plan=plan_note(shape, md, name))
                    rows.append(row)
                    print(f"{name} {path} md={md} level {lvl} {shape} bf16: "
                          f"kernel {row['ms']:.5f} ms L2 flushed (warm "
                          f"{row['warm_ms']:.5f}, host {row['host_ms']:.5f} "
                          f"a call), plain {row['plain_ms']:.5f} ms, bound "
                          f"{row['bound_ms']:.5f} ms ({row['bound_by']}), "
                          f"kernel/bound {row['ms'] / row['bound_ms']:.2f}; "
                          f"{row['plan']}", flush=True)
    return rows


def corr_timing(rows, name, path="S step"):
    """One kernel's rows of one path summed (the S step's five levels), as
    the ``kernels`` line takes them."""
    sel = [r for r in rows if r["kernel"] == name and r["path"] == path]
    by = {kind: sum(r["bound_ms"] for r in sel if r["bound_by"] == kind)
          for kind in ("bytes", "operations")}
    return {"ms": sum(r["ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "warm_ms": sum(r["warm_ms"] for r in sel),
            "host_ms": sum(r["host_ms"] for r in sel),
            "bound_ms": sum(r["bound_ms"] for r in sel),
            "bound_by": max(by, key=by.get), "library_ms": None}


def deform_inputs(gen, shape, cout, dtype, flow=None):
    """x, the sample coordinates (sy, sx), w9 and a cotangent g for one
    deformable conv: x ~ N(0, 1), weights N(0, 1/(9 Cin)) so the outputs
    are of order 1, the flow ~ N(0, 3^2) pixels unless given."""
    n, cin, h, w = shape
    x = torch.randn(shape, generator=gen, device="cuda")
    if flow is None:
        flow = 3 * torch.randn((n, 2, h, w), generator=gen, device="cuda")
    weight = torch.randn((cout, cin, 3, 3), generator=gen,
                         device="cuda") / math.sqrt(9 * cin)
    g = torch.randn((n, cout, h, w), generator=gen, device="cuda")
    sy, sx = base_grid(flow)
    return (x.to(dtype), flow, weight.to(dtype), sy.contiguous(),
            sx.contiguous(), weight_to_w9(weight, dtype), g.to(dtype))


def abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 when both are 0)."""
    scale = want.abs().max().item()
    err = abs_err(got, want)
    return err / scale if scale else err


def deform_cases(gen):
    """(name, shape, cout, flow or None, padded) of every kernel check: the
    S train step's levels, the cascade inference's (level 6 first), the
    cascade step's, an odd shape with its windows pushed fully outside
    (flow +-50), the same at integer flows, and the tiling's edges: Cin not
    a multiple of the 16-channel K chunk with a K split (20, 24), Cout not a
    multiple of the column tile or of w9's 8-element row pitch (40, 150),
    pixel counts not a multiple of any pixel tile. ``padded`` False hands
    the kernels a compact w9 (Cout 7), which the wrapper pads."""
    n, cin, h, w = 2, 5, 9, 13
    ints = torch.randint(-3, 4, (n, 2, h, w), generator=gen, device="cuda")
    cases = [(f"L{lvl}", shape, cout, None, True)
             for lvl, shape, cout in DEFORM_LEVELS + [DEFORM_L6]]
    cases += [(f"cascade inference L{lvl}", shape, shape[1], None, True)
              for lvl, shape in LEVELS if lvl != DEFORM_L6[0]]
    cases += [(f"cascade step L{lvl}", shape, shape[1], None, True)
              for lvl, shape in CASCADE_TRAIN_LEVELS]
    for mag in (50.0, -50.0):
        cases.append((f"odd flow {mag:+g}", (n, cin, h, w), 7,
                      torch.full((n, 2, h, w), mag, device="cuda"), True))
    cases.append(("odd integer flow", (n, cin, h, w), 7, ints.float(), True))
    cases.append(("odd, compact w9", (n, cin, h, w), 7, None, False))
    cases += [("edge", shape, cout, None, True)
              for shape, cout in DEFORM_EDGES]
    return cases


def check_deform_case(gen, name, shape, cout, flow, padded, dtype,
                      needs_list=DEFORM_NEEDS) -> dict:
    """deform_fwd and deform_bwd (each gradient subset of ``needs_list``)
    against the plain pair at one case and dtype; records each in CHECKED;
    returns, for each kernel, (largest error relative to max |plain|,
    largest absolute error)."""
    worst = {}

    def note(kernel, got, want):
        rel, ab = worst.get(kernel, (0.0, 0.0))
        worst[kernel] = (max(rel, rel_err(got, want)),
                         max(ab, abs_err(got, want)))

    x, _, _, sy, sx, w9, g = deform_inputs(gen, shape, cout, dtype, flow)
    if not padded:
        w9 = w9.contiguous()
        require(deform_module.w9_pitch(w9) is None,
                "a compact w9 at Cout 7 is not in the kernels' pitch")
    got = deform_fwd(x, sy, sx, w9)
    torch.cuda.synchronize()
    want = deform_fwd_plain(x, sy, sx, w9)
    require(got.dtype == dtype and got.shape == want.shape,
            f"deform_fwd output {got.dtype} {tuple(got.shape)}")
    err = rel_err(got, want)
    require(err <= DEFORM_TOL[dtype], f"deform_fwd {name} {dtype}: "
            f"relative error {err:.3e}")
    note("deform_fwd", got, want)
    CHECKED.add(("deform_fwd", tuple(shape), cout, dtype))
    if name.startswith("odd flow"):
        require(want.abs().max().item() == 0 and
                got.abs().max().item() == 0,
                "windows wholly outside the image give zero")
    for needs in needs_list:
        got = deform_bwd(x, sy, sx, w9, g, needs)
        torch.cuda.synchronize()
        want = deform_bwd_plain(x, sy, sx, w9, g, needs)
        asked = (needs[0], needs[1], needs[1], needs[2])
        for what, a, b, on in zip(("dx", "dsy", "dsx", "dw"), got,
                                  want, asked):
            require((a is not None) == on and (b is not None) == on,
                    f"deform_bwd {needs}: {what} returned "
                    f"{a is not None}, asked {on}")
            if not on:
                continue
            require(a.dtype == torch.float32 and a.shape == b.shape,
                    f"deform_bwd {what} {a.dtype} {tuple(a.shape)}")
            err = rel_err(a, b)
            require(err <= DEFORM_TOL[torch.float32],
                    f"deform_bwd {name} {dtype} {needs} {what}: "
                    f"relative error {err:.3e}")
            note("deform_bwd", a, b)
        CHECKED.add(("deform_bwd", tuple(shape), cout, dtype, needs))
    return worst


def check_deform(gen):
    """deform_fwd and deform_bwd (each gradient subset) against the plain
    pair on every case, f32 and bf16 (``check_deform_case``); returns, for
    each, the largest f32 error as (absolute, relative to max |plain|)."""
    worst = {(k, dt): 0.0 for k in ("deform_fwd", "deform_bwd") for dt in TOL}
    worst_abs = dict(worst)
    for name, shape, cout, flow, padded in deform_cases(gen):
        for dtype in (torch.float32, torch.bfloat16):
            errs = check_deform_case(gen, name, shape, cout, flow, padded,
                                     dtype)
            for k, (rel, ab) in errs.items():
                worst[(k, dtype)] = max(worst[(k, dtype)], rel)
                worst_abs[(k, dtype)] = max(worst_abs[(k, dtype)], ab)
        print(f"deform check {name} {shape} -> {cout}: ok", flush=True)
    for k in ("deform_fwd", "deform_bwd"):
        print(f"{k} max |err|/max|plain|: f32 "
              f"{worst[(k, torch.float32)]:.3e}, bf16 "
              f"{worst[(k, torch.bfloat16)]:.3e} (tol {DEFORM_TOL[torch.float32]}"
              f" f32 results, {DEFORM_TOL[torch.bfloat16]} a bf16 forward); "
              f"max |err|: f32 {worst_abs[(k, torch.float32)]:.3e}, bf16 "
              f"{worst_abs[(k, torch.bfloat16)]:.3e}", flush=True)
    return {k: (worst_abs[(k, torch.float32)], worst[(k, torch.float32)])
            for k in ("deform_fwd", "deform_bwd")}


def deform_bound_ms(shape, cout, dtype, backward: bool):
    """Least time for one deformable conv: bytes of x, flow, w and out (the
    backward: x, flow, w, g in, dx, dflow, dw out in f32), each moved once,
    against 2*N*H*W*9*Cin*Cout flops (twice that backward) at the dtype's
    peak."""
    n, cin, h, w = shape
    size = torch.tensor([], dtype=dtype).element_size()
    pix = n * h * w
    wts = 9 * cin * cout
    flow = 2 * pix * 4
    if backward:
        nbytes = ((pix * cin + wts + pix * cout) * size + flow
                  + (pix * cin + wts) * 4 + flow)
    else:
        nbytes = (pix * cin + wts + pix * cout) * size + flow
    ops = 2 * pix * 9 * cin * cout * (2 if backward else 1)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[dtype] * 1e3


def deform_tflops(shape, cout, ms: float, backward: bool) -> float:
    """Achieved TFLOP/s of one call: 2*N*H*W*9*Cin*Cout flops (twice that
    backward: dtap and dweight) over ``ms``."""
    n, cin, h, w = shape
    return 2 * n * h * w * 9 * cin * cout * (2 if backward else 1) / (
        ms * 1e-3) / 1e12


def time_deform(gen):
    """Per level, bf16: the kernels (forward; full backward, and its data
    kernel (dx, dflow) and weight kernel (dweight) alone), the plain pair
    and warpconv (forward, and forward + full backward), each a single call
    after an L2 flush, beside the bounds, the achieved TFLOP/s and each
    kernel's block count (``deform_plan``); and the wrappers' host time a
    call. Returns per-level rows and the sums over the train step's four
    levels."""
    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for lvl, shape, cout in DEFORM_LEVELS + [DEFORM_L6]:
        x, flow, weight, sy, sx, w9, g = deform_inputs(gen, shape, cout,
                                                       torch.bfloat16)
        xg = x.detach().requires_grad_()
        fg = flow.detach().requires_grad_()
        wg = weight.detach().requires_grad_()

        def wc_fwd():
            with torch.no_grad():
                return _warpconv(x, flow, weight, None)

        def wc_fwd_bwd():
            torch.autograd.grad(_warpconv(xg, fg, wg, None), (xg, fg, wg), g)

        plan = deform_module.deform_plan(*shape, cout, sms)
        r = dict(level=lvl, shape=shape, cout=cout,
                 blocks={"fwd": plan.fwd_blocks, "data": plan.data_blocks,
                         "weight": plan.dw_blocks},
                 splits={"fwd": plan.fwd_splits, "weight": plan.dw_splits})
        for key, fn in (("fwd", lambda: deform_fwd(x, sy, sx, w9)),
                        ("bwd", lambda: deform_bwd(x, sy, sx, w9, g))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):         # well inside the launch queue
                fn()
            r[f"host_{key}_ms"] = (time.perf_counter() - t0) * 1e3 / 50
            torch.cuda.synchronize()
        r["fwd_ms"] = cuda_ms_cold(lambda: deform_fwd(x, sy, sx, w9))
        r["bwd_ms"] = cuda_ms_cold(lambda: deform_bwd(x, sy, sx, w9, g))
        r["bwd_data_ms"] = cuda_ms_cold(
            lambda: deform_bwd(x, sy, sx, w9, g, (True, True, False)))
        r["bwd_weight_ms"] = cuda_ms_cold(
            lambda: deform_bwd(x, sy, sx, w9, g, (False, False, True)))
        r["plain_fwd_ms"] = cuda_ms_cold(
            lambda: deform_fwd_plain(x, sy, sx, w9), reps=11)
        r["plain_bwd_ms"] = cuda_ms_cold(
            lambda: deform_bwd_plain(x, sy, sx, w9, g), reps=11)
        r["warpconv_fwd_ms"] = cuda_ms_cold(wc_fwd)
        r["warpconv_fwd_bwd_ms"] = cuda_ms_cold(wc_fwd_bwd)
        for key, bwd in (("fwd", False), ("bwd", True)):
            b, o = deform_bound_ms(shape, cout, torch.bfloat16, bwd)
            r[f"{key}_bytes_ms"], r[f"{key}_ops_ms"] = b, o
            r[f"{key}_bound_ms"] = max(b, o)
            r[f"{key}_tflops"] = deform_tflops(shape, cout, r[f"{key}_ms"],
                                               bwd)
        print(f"deform level {lvl} {shape} -> {cout} bf16, L2 flushed before "
              f"each call: fwd kernel {r['fwd_ms']:.5f} ms (bound "
              f"{r['fwd_bound_ms']:.5f}, "
              f"{'bytes' if r['fwd_bytes_ms'] >= r['fwd_ops_ms'] else 'operations'}"
              f"; kernel/bound {r['fwd_ms'] / r['fwd_bound_ms']:.1f}; "
              f"{r['fwd_tflops']:.2f} TFLOP/s; {plan.fwd_blocks} blocks, "
              f"{plan.fwd_splits} K splits), plain "
              f"{r['plain_fwd_ms']:.5f}, warpconv {r['warpconv_fwd_ms']:.5f}; "
              f"full bwd kernel {r['bwd_ms']:.5f} ms (bound "
              f"{r['bwd_bound_ms']:.5f}, "
              f"{'bytes' if r['bwd_bytes_ms'] >= r['bwd_ops_ms'] else 'operations'}"
              f"; kernel/bound {r['bwd_ms'] / r['bwd_bound_ms']:.1f}; "
              f"{r['bwd_tflops']:.2f} TFLOP/s): data kernel (dx, dflow) "
              f"{r['bwd_data_ms']:.5f} ms, {plan.data_blocks} blocks; weight "
              f"kernel + reduction {r['bwd_weight_ms']:.5f} ms, "
              f"{plan.dw_blocks} blocks, {plan.dw_splits} pixel splits; "
              f"plain {r['plain_bwd_ms']:.5f}; fwd+bwd kernel "
              f"{r['fwd_ms'] + r['bwd_ms']:.5f} vs warpconv "
              f"{r['warpconv_fwd_bwd_ms']:.5f} ms; the wrappers' host time "
              f"a call: fwd {r['host_fwd_ms']:.5f}, bwd "
              f"{r['host_bwd_ms']:.5f} ms", flush=True)
        rows.append(r)
    train = rows[:len(DEFORM_LEVELS)]
    total = {k: sum(r[k] for r in train) for k in rows[0]
             if k.endswith("_ms")}
    print(f"deform, the train step's 4 levels summed: fwd kernel "
          f"{total['fwd_ms']:.5f} ms (bound {total['fwd_bound_ms']:.5f}), "
          f"bwd kernel {total['bwd_ms']:.5f} ms (bound "
          f"{total['bwd_bound_ms']:.5f}; data {total['bwd_data_ms']:.5f}, "
          f"weight {total['bwd_weight_ms']:.5f}), warpconv fwd "
          f"{total['warpconv_fwd_ms']:.5f}, fwd+bwd "
          f"{total['warpconv_fwd_bwd_ms']:.5f}", flush=True)
    return rows, total


def deform_vs_warpconv(gen):
    """Kernels against warpconv at every deformable conv of both models,
    bf16, single calls after an L2 flush: the forward at the inference
    levels (batch 4 at 448x1024: MaskFlownet_S's L5..L2, the cascade's
    L6..L2) and at the cascade step's head levels (no gradient); forward +
    backward at the cascade frozen step's stage-2 levels (the gradients it
    asks: dflow and dweight, dweight alone at level 6) and at the S step's
    (all three; ``time_deform``'s rows). Returns rows and whether the
    kernels won at every level."""
    rows = []
    cases = [("inference", lvl, shape, shape[1], None) for lvl, shape in LEVELS]
    cases += [("cascade step head", lvl, shape, shape[1], None)
              for lvl, shape in CASCADE_TRAIN_LEVELS if lvl != 6]
    cases += [("cascade step", lvl, shape, shape[1],
               (False, lvl != 6, True)) for lvl, shape in CASCADE_TRAIN_LEVELS]
    for what, lvl, shape, cout, needs in cases:
        x, flow, weight, sy, sx, w9, g = deform_inputs(gen, shape, cout,
                                                       torch.bfloat16)
        if needs is None:
            def kern():
                return deform_fwd(x, sy, sx, w9)

            def wc():
                with torch.no_grad():
                    return _warpconv(x, flow, weight, None)
        else:
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip((x, flow, weight), needs)]
            wanted = [t for t in ins if t.requires_grad]

            def kern():
                deform_fwd(x, sy, sx, w9)
                return deform_bwd(x, sy, sx, w9, g, needs)

            def wc():
                torch.autograd.grad(_warpconv(*ins, None), wanted, g)
        r = dict(what=what, level=lvl, shape=shape, cout=cout,
                 needs=needs, kernel_ms=cuda_ms_cold(kern),
                 warpconv_ms=cuda_ms_cold(wc))
        rows.append(r)
        print(f"deform vs warpconv, {what} L{lvl} {shape} -> {cout}"
              f"{'' if needs is None else f' fwd+bwd {needs}'}: kernel "
              f"{r['kernel_ms']:.5f} ms, warpconv {r['warpconv_ms']:.5f} ms "
              f"({r['warpconv_ms'] / r['kernel_ms']:.2f}x)", flush=True)
    return rows, all(r["kernel_ms"] < r["warpconv_ms"] for r in rows)


def check_outputs(outs, b, hw, what):
    """Predictor.do_batch's (flow, occ, warped): shapes, finite."""
    flow, occ, warped = outs
    for t, c in ((flow, 2), (occ, 1), (warped, 3)):
        require(t.shape == (b, c) + tuple(hw), f"{what}: output shape "
                f"{tuple(t.shape)}")
        require(bool(torch.isfinite(t).all()), f"{what}: non-finite output")


def drive_slice(gen):
    """Returns (launches in one bf16 main-path forward, ms per frame)."""
    params = init_params(0)
    h, w = SLICE_HW
    img1 = torch.rand((SLICE_BATCH, 3, h, w), generator=gen, device="cuda")
    img2 = torch.rand((SLICE_BATCH, 3, h, w), generator=gen, device="cuda")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    p32 = Predictor(params, device="cuda", dtype=torch.float32)
    reset_counts()
    kern = p32.do_batch(img1, img2)
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    require(got == S_FWD, f"one forward launched {got}, not {S_FWD}")
    with mock.patch.object(model_module, "correlation", correlation_plain):
        plain = p32.do_batch(img1, img2)
    torch.cuda.synchronize()
    require(corr_fwd.launches == 5, "the plain path launched the kernel")
    check_outputs(kern, SLICE_BATCH, (h, w), "f32 kernel path")
    check_outputs(plain, SLICE_BATCH, (h, w), "f32 plain path")
    dflow = (kern[0] - plain[0]).abs().max().item()
    print(f"slice f32 kernel vs plain correlation: max |dflow| {dflow:.3e} px "
          f"(tol {FLOW_TOL_PX}), |flow| max {kern[0].abs().max().item():.3f} "
          f"px", flush=True)
    require(dflow <= FLOW_TOL_PX, "f32 kernel path vs plain path")

    # the card against the CPU path (the one the tests hold against JAX)
    small1, small2 = img1[:1, :, :64, :96], img2[:1, :, :64, :96]
    card = p32.do_batch(small1, small2)[0].cpu()
    cpu = Predictor(params, device="cpu", dtype=torch.float32,
                    cfg=KERNEL_CFG).do_batch(small1.cpu(), small2.cpu())[0]
    dcpu = (card - cpu).abs().max().item()
    print(f"slice f32 card vs CPU at 64x96: max |dflow| {dcpu:.3e} px "
          f"(tol {FLOW_TOL_PX})", flush=True)
    require(dcpu <= FLOW_TOL_PX, "card vs CPU")
    del p32, kern, plain

    pbf = Predictor(params, device="cuda", dtype=torch.bfloat16)
    with record_launches() as calls:
        for _ in range(3):                         # warm-up
            pbf.do_batch(img1, img2)
    torch.cuda.synchronize()
    require_checked(calls, "slice bf16 main path")
    reset_counts()
    out = pbf.do_batch(img1, img2)                 # the main path, counted
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    require(launches == S_FWD, f"the main-path forward launched {launches}, "
            f"not {S_FWD}")
    check_outputs(out, SLICE_BATCH, (h, w), "bf16 main path")
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(20):
        t0 = time.perf_counter()
        pbf.do_batch(img1, img2)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_frame = statistics.median(times) / SLICE_BATCH
    print(f"slice bf16 do_batch {SLICE_BATCH}x{h}x{w}: "
          f"{statistics.median(times):.3f} ms/batch (min {min(times):.3f}, "
          f"max {max(times):.3f}), {per_frame:.3f} ms/frame, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches, per_frame


def shifted_batch(gen, b: int, hw, shift=(3, -2)):
    """A FlyingChairs-like batch: smooth random images in [0, 255], image 2
    image 1 moved by the integer flow ``shift`` = (dy, dx), so that
    ``img2(p + shift) = img1(p)``; the label is that flow everywhere, the
    mask all valid. Made on the card from ``gen``."""
    h, w = hw
    m = 8                                           # margin for the shift
    coarse = torch.rand((b, 3, (h + 2 * m) // 8, (w + 2 * m) // 8),
                        generator=gen, device="cuda")
    big = 255 * torch.nn.functional.interpolate(
        coarse, size=(h + 2 * m, w + 2 * m), mode="bilinear",
        align_corners=False)
    img1 = big[:, :, m:m + h, m:m + w].contiguous()
    img2 = big[:, :, m - shift[0]:m - shift[0] + h,
               m - shift[1]:m - shift[1] + w].contiguous()
    flow = torch.tensor(shift, dtype=torch.float32, device="cuda")
    flow = flow[None, :, None, None].expand(b, 2, h, w).contiguous()
    return img1, img2, flow


# (loss, grads, branch values) of one step, with or without another
# step's branches replayed (``grad_parity.branches``: the deformable convs'
# sample coordinates, the LeakyReLUs' inputs, the cost volumes' outputs)
step_grads = grad_parity.step


def step_errors(what, got, want):
    """The loss's relative difference and the worst parameter's
    ``|dgrad| / |grad|`` with its name, of two step_grads results."""
    (lg, gg, _), (lw, gw, _) = got, want
    require(gg.keys() == gw.keys(), f"{what}: different parameters have "
            "gradients")
    worst, name = max((((gg[k] - gw[k]).norm() / gw[k].norm()).item(), k)
                      for k in gw if gw[k].norm() > 0)
    return abs(lg - lw) / abs(lw), worst, name


def compare_steps(what, got, want):
    """Require step_grads result ``got`` within LOSS_RTOL / GRAD_RTOL of
    ``want``; print the worst relative gradient error."""
    loss_rel, worst, name = step_errors(what, got, want)
    print(f"train {what}: loss {got[0]:.7f} vs {want[0]:.7f} (rel "
          f"{loss_rel:.3e}, tol {LOSS_RTOL}); worst parameter "
          f"|dgrad|/|grad| {worst:.3e} ({name}; tol {GRAD_RTOL})",
          flush=True)
    require(loss_rel <= LOSS_RTOL, f"{what}: loss")
    require(worst <= GRAD_RTOL, f"{what}: gradients")


def compare_on_branches(what, got_step, want_step, keys=BRANCHES):
    """Hold one step, ``got_step(replay)``, against another,
    ``want_step(replay)`` (each a step_grads result). A value within
    rounding of a kink -- a LeakyReLU's 0, a sample coordinate's integer
    -- may fall on different sides in the two runs, and the gradient
    behind it then jumps by the whole difference of the slopes (PERF.md
    §6; ``tools/grad_parity.py``). So the two are compared as they run,
    the loss held to LOSS_RTOL and the gradients to GRAD_RTOL unless a
    branch of ``keys`` differs; then the second again on the first's
    branches of ``keys``, held to both. Returns the first's result."""
    got, want = got_step(None), want_step(None)
    flipped = {k: v for k, v in grad_parity.flips(got[2], want[2]).items()
               if k in keys and v}
    loss_rel, worst, name = step_errors(what, got, want)
    print(f"train {what}, as they run: loss rel {loss_rel:.3e}, worst "
          f"parameter |dgrad|/|grad| {worst:.3e} ({name}); branches on "
          f"different sides: {flipped or 'none'}", flush=True)
    require(loss_rel <= LOSS_RTOL, f"{what}: loss")
    require(worst <= GRAD_RTOL or bool(flipped),
            f"{what}: gradients, with every branch on the same side")
    compare_steps(f"{what}, on the first's branches", got,
                  want_step({k: got[2][k] for k in keys}))
    return got


def drive_train(gen):
    """Returns (launches of each kernel in the main-path run, ms/step,
    samples/s)."""
    params = init_params(0)
    f32 = TrainSettings(compute_dtype="float32", model_cfg=KERNEL_CFG)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # an f32 step on the card against the same step on the CPU (the path
    # the tests hold against JAX); 64x128, the smallest x64 shape with W
    # and H unequal
    small = shifted_batch(gen, 1, (64, 128))
    card_trainer = Trainer(f32, device="cuda", params=params)
    cpu_trainer = Trainer(f32, device="cpu", params=params)
    compare_on_branches(
        "f32 card vs CPU at 64x128",
        lambda replay: step_grads(card_trainer, small),
        lambda replay: step_grads(cpu_trainer, [t.cpu() for t in small],
                                  replay=replay))
    del card_trainer, cpu_trainer

    # the kernels against the plain correlation, f32, 320x448
    batch = shifted_batch(gen, 2, TRAIN_HW)
    trainer = Trainer(f32, device="cuda", params=params)
    kern = step_grads(trainer, batch)
    counts = [k.launches for k in (corr_fwd, corr_bwd_f1, corr_bwd_f2)]
    with mock.patch.object(model_module, "correlation", correlation_plain):
        plain = step_grads(trainer, batch)
    require([k.launches for k in (corr_fwd, corr_bwd_f1, corr_bwd_f2)]
            == counts, "the plain path launched a kernel")
    compare_steps("f32 kernels vs plain correlation, 2x320x448", kern, plain)
    del trainer, kern, plain

    # the main path: bf16, batch 8, 320x448
    batch = shifted_batch(gen, TRAIN_BATCH, TRAIN_HW)
    trainer = Trainer(TrainSettings(), device="cuda", params=params)
    with record_launches() as calls:
        losses = [trainer.train_batch(*batch, lr=TRAIN_LR, sync=True)["loss"]
                  for _ in range(3)]                # warm-up
    torch.cuda.synchronize()
    require_checked(calls, "train bf16 main path")
    torch.cuda.reset_peak_memory_stats()
    timed = 20
    reset_counts()
    t0 = time.perf_counter()
    metrics = [trainer.train_batch(*batch, lr=TRAIN_LR)
               for _ in range(timed)]
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / timed
    launches = {k: v for k, v in launch_counts().items() if v}
    print(f"train main path: {timed} steps launched {launches}", flush=True)
    require(launches == {k: v * timed for k, v in S_STEP.items()},
            f"{timed} steps launched {launches}, not {timed} x {S_STEP}")
    losses += [m["loss"].item() for m in metrics]
    losses += [trainer.train_batch(*batch, lr=TRAIN_LR, sync=True)["loss"]
               for _ in range(30 - len(losses))]
    require(all(map(math.isfinite, losses)), f"non-finite loss: {losses}")
    print(f"train bf16 {TRAIN_BATCH}x{TRAIN_HW[0]}x{TRAIN_HW[1]}: "
          f"{ms_step:.3f} ms/step, {TRAIN_BATCH * 1e3 / ms_step:.2f} "
          f"samples/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss step "
          f"1 {losses[0]:.4f}, step 30 {losses[-1]:.4f}", flush=True)
    require(losses[-1] < losses[0], "the loss after 30 steps is not below "
            "the first")
    return launches, ms_step, TRAIN_BATCH * 1e3 / ms_step


def cuda_ms_cold(fn, reps: int = 25) -> float:
    """Median over ``reps`` of one call's time by CUDA events, each call
    after a read of a buffer four times the L2's size, so that the call
    reads its inputs from HBM as it does in the step, not from the L2 that
    a back-to-back launch left them in. A read leaves clean lines, so the
    call pays no write-back of the flush. Between the flush and the start
    event the card sleeps for twice the host time of one call (at up to 2
    GHz, longer at a lower clock), so the host has queued the whole call
    before the card starts it: the events time the device, not the
    host's launches."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0)
    # as many f32 elements as the L2 has bytes: four times its size
    flush = torch.ones(max(l2, 50 * 2 ** 20), dtype=torch.float32,
                       device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int(max(host_s, 1e-4) * 2 * 2e9)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.sum()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def touched_source_pixels(img, sy, sx) -> int:
    """Source pixels of one channel plane, summed over the batch, that the
    bilinear samples at (sy, sx) read: every in-image corner of every
    point, each pixel counted once."""
    n, _, h, w = img.shape
    y0 = torch.floor(sy).long()
    x0 = torch.floor(sx).long()
    base = (torch.arange(n, device=img.device) * (h * w)).view(n, 1, 1)
    hit = torch.zeros(n * h * w, dtype=torch.bool, device=img.device)
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            hit[(base + yy * w + xx)[inside]] = True
    return int(hit.sum().item())


def affine_bound_ms(img, sy, sx):
    """Least time for one sampling: the source pixels this run's
    coordinates touch read once in every channel, both coordinate maps
    read once and the f32 output written once, against ~8 flops a channel
    and 10 a pixel at the f32 peak. Returns (bytes ms, operations ms, the
    touched share of the source)."""
    n, c, h, w = img.shape
    ho, wo = sy.shape[1:]
    pixels = n * ho * wo
    touched = touched_source_pixels(img, sy, sx)
    nbytes = (touched * c * img.element_size() + 2 * pixels * 4
              + pixels * c * 4)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            pixels * (8 * c + 10) / PEAK_FLOPS[torch.float32] * 1e3,
            touched / (n * h * w))


def affine_cases(gen):
    """(name, img, sy, sx) of both sampling launches of one augmented
    FlyingChairs step -- packed img1 + mask + flow*mask (6 channels), then
    img2 (3) -- at coordinates from the chairs presets' own draws, and an
    odd shape whose coordinates leave the image on every side."""
    cfg = presets.geometry_aug_config("chairs", TRAIN_HW, AUG_SRC_HW)
    (g1x, g1y), (g2x, g2y) = sample_grids(
        draw_geometry(gen, TRAIN_BATCH, cfg, "cuda"), cfg)
    h, w = AUG_SRC_HW
    packed = torch.rand((TRAIN_BATCH, 6, h, w), generator=gen, device="cuda")
    packed[:, 4:] = 20 * packed[:, 4:] - 10               # flow * mask
    img2 = torch.rand((TRAIN_BATCH, 3, h, w), generator=gen, device="cuda")
    odd = torch.rand((1, 5, 9, 13), generator=gen, device="cuda")
    sy = torch.rand((1, 7, 11), generator=gen, device="cuda") * 14 - 3
    sx = torch.rand((1, 7, 11), generator=gen, device="cuda") * 19 - 3
    return [("packed", packed, *normalized_to_pixels(g1x, g1y, h, w)),
            ("img2", img2, *normalized_to_pixels(g2x, g2y, h, w)),
            ("odd", odd, sy, sx)]


def check_affine(cases):
    """affine_sample vs affine_sample_plain on every case, f32 and bf16
    input; returns the largest f32 error."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, img, sy, sx in cases:
        out_of_image = ((sy < 0) | (sy > img.shape[2] - 1) | (sx < 0)
                        | (sx > img.shape[3] - 1)).float().mean().item()
        for dtype in (torch.float32, torch.bfloat16):
            x = img.to(dtype)
            got = affine_sample(x, sy, sx)
            torch.cuda.synchronize()
            want = affine_sample_plain(x.float(), sy, sx)
            require(got.dtype == torch.float32 and got.shape == want.shape,
                    f"affine_sample output {got.dtype} {tuple(got.shape)}")
            torch.testing.assert_close(got, want, **AFFINE_TOL)
            worst[dtype] = max(worst[dtype],
                               (got - want).abs().max().item())
        print(f"affine_sample check {name} {tuple(img.shape)} -> "
              f"{tuple(sy.shape[1:])}, {out_of_image:.3f} of the points "
              f"outside the image: ok", flush=True)
    print(f"affine_sample max |err|: f32 {worst[torch.float32]:.3e}, bf16 "
          f"input {worst[torch.bfloat16]:.3e} (tol {AFFINE_TOL})", flush=True)
    return worst[torch.float32]


def time_affine(cases):
    """The two launches of one step: the kernel, its plain version and
    ``F.grid_sample`` (the same function in one PyTorch call, on grids
    normalized beforehand), each with the L2 flushed before the call,
    summed, with the bound; the kernel also back to back, and the host
    time of one call of its wrapper."""
    total = dict(ms=0.0, warm_ms=0.0, host_ms=0.0, plain_ms=0.0,
                 library_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    for name, img, sy, sx in cases[:2]:
        h, w = img.shape[2:]
        grid = torch.stack([sx * (2.0 / (w - 1)) - 1,
                            sy * (2.0 / (h - 1)) - 1], -1)

        def library():
            return torch.nn.functional.grid_sample(
                img, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True)

        dlib = (library() - affine_sample(img, sy, sx)).abs().max().item()
        warm_ms = cuda_ms(lambda: affine_sample(img, sy, sx))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):            # well inside the launch queue
            affine_sample(img, sy, sx)
        host_ms = (time.perf_counter() - t0) * 1e3 / 100
        torch.cuda.synchronize()
        ms = cuda_ms_cold(lambda: affine_sample(img, sy, sx))
        plain_ms = cuda_ms_cold(lambda: affine_sample_plain(img, sy, sx),
                                reps=11)
        library_ms = cuda_ms_cold(library)
        bytes_ms, ops_ms, share = affine_bound_ms(img, sy, sx)
        bound = max(bytes_ms, ops_ms)
        print(f"affine_sample {name} {tuple(img.shape)} -> "
              f"{tuple(sy.shape[1:])} f32, L2 flushed before each call: "
              f"kernel {ms:.5f} ms (back to back, L2-warm: {warm_ms:.5f}; "
              f"the wrapper's host time a call {host_ms:.5f}), "
              f"plain {plain_ms:.5f} ms, F.grid_sample {library_ms:.5f} ms "
              f"(max |diff| {dlib:.2e}), bound {bound:.5f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; bytes "
              f"{bytes_ms:.5f} with {share:.3f} of the source touched, ops "
              f"{ops_ms:.5f}), kernel/bound {ms / bound:.2f}", flush=True)
        for key, v in (("ms", ms), ("warm_ms", warm_ms),
                       ("host_ms", host_ms), ("plain_ms", plain_ms),
                       ("library_ms", library_ms),
                       ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            total[key] += v
    return total


def drive_augment(gen):
    """Returns (launches of each kernel in the main-path run, ms/step,
    samples/s)."""
    params = init_params(0)
    color = presets.color_aug_config("chairs")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # an f32 augmented step on the card against the same step, with the
    # same draws, on the CPU
    small = TrainSettings(compute_dtype="float32", color=color,
                          geo=presets.geometry_aug_config(
                              "chairs", AUG_SMALL_HW, AUG_SMALL_SRC_HW),
                          model_cfg=KERNEL_CFG)
    batch = shifted_batch(gen, 1, AUG_SMALL_SRC_HW)
    card_trainer = Trainer(small, device="cuda", params=params)
    cpu_trainer = Trainer(small, device="cpu", params=params)
    cpu_batch = [t.cpu() for t in batch]
    draws = card_trainer.draw(1, AUG_SMALL_SRC_HW)
    card = [t.cpu() for t in card_trainer.prepare(*batch, draws=draws)]
    cpu = cpu_trainer.prepare(*cpu_batch, draws=draws)
    derr = max((card[i] - cpu[i]).abs().max().item() for i in (0, 1, 3))
    inside = cpu[3][:, 0] > 0.99
    dflow = (card[2] - cpu[2]).abs().amax(1)[inside].max().item()
    print(f"augment f32 card vs CPU at {AUG_SMALL_SRC_HW} -> {AUG_SMALL_HW}: "
          f"images and mask max |diff| {derr:.3e} (tol {AUG_IMAGE_TOL}), "
          f"flow {dflow:.3e} px where the mask > 0.99 (tol "
          f"{AUG_FLOW_TOL_PX}), {inside.float().mean().item():.2f} of the "
          f"pixels", flush=True)
    require(derr <= AUG_IMAGE_TOL, "augmented images card vs CPU")
    require(dflow <= AUG_FLOW_TOL_PX, "augmented flow card vs CPU")
    compare_on_branches(
        "f32 augmented card vs CPU",
        lambda replay: step_grads(card_trainer, batch, draws=draws),
        lambda replay: step_grads(cpu_trainer, cpu_batch, replay,
                                  draws=draws))
    del card_trainer, cpu_trainer

    # the main path: chairs presets, bf16, batch 8, 384x512 -> 320x448
    settings = TrainSettings(color=color, geo=presets.geometry_aug_config(
        "chairs", TRAIN_HW, AUG_SRC_HW))
    batch = shifted_batch(gen, TRAIN_BATCH, AUG_SRC_HW)
    trainer = Trainer(settings, device="cuda", params=params)
    with record_launches() as calls:
        losses = [trainer.train_batch(*batch, lr=TRAIN_LR, sync=True)["loss"]
                  for _ in range(3)]                # warm-up
    require_checked(calls, "augment bf16 main path")
    # the step draws and augments without waiting for the card
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.prepare(*batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = 20
    reset_counts()
    t0 = time.perf_counter()
    metrics = [trainer.train_batch(*batch, lr=TRAIN_LR)
               for _ in range(timed)]
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / timed
    launches = {k: v for k, v in launch_counts().items() if v}
    print(f"augment main path: {timed} steps launched {launches}", flush=True)
    per_step = {**S_STEP, "affine_sample": 2}
    require(launches == {k: v * timed for k, v in per_step.items()},
            f"{timed} augmented steps launched {launches}, not {timed} x "
            f"{per_step}")
    losses += [m["loss"].item() for m in metrics]
    require(all(map(math.isfinite, losses)), f"non-finite loss: {losses}")
    print(f"augment bf16 {TRAIN_BATCH}x{AUG_SRC_HW[0]}x{AUG_SRC_HW[1]} -> "
          f"{TRAIN_HW[0]}x{TRAIN_HW[1]}: {ms_step:.3f} ms/step, "
          f"{TRAIN_BATCH * 1e3 / ms_step:.2f} samples/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss step 1 "
          f"{losses[0]:.4f}, step {len(losses)} {losses[-1]:.4f}", flush=True)
    return launches, ms_step, TRAIN_BATCH * 1e3 / ms_step


def launch_counts():
    return {k.__name__: k.launches for k in KERNELS}


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def launch_key(name: str, args) -> tuple:
    """(kernel, shape, md or Cout, dtype[, needs]) of one wrapper call, as
    the checks key what they held against the plain versions: a cost
    volume by its features, a deformable conv by x, Cout and the
    gradients asked for."""
    if name == "corr_fwd":                  # (f1, f2, md, leaky)
        return name, tuple(args[0].shape), args[2], args[0].dtype
    if name.startswith("corr_bwd"):         # (g, feature, out, md, leaky)
        return name, tuple(args[1].shape), args[3], args[1].dtype
    x, w9 = args[0], args[3]                # (x, sy, sx, w9[, g, needs])
    key = (name, tuple(x.shape), w9.shape[2], x.dtype)
    if name == "deform_bwd":
        needs = args[5] if len(args) > 5 else (True, True, True)
        key += (tuple(bool(v) for v in needs),)
    return key


@contextlib.contextmanager
def record_launches():
    """Record the ``launch_key`` of every correlation and deform kernel
    launch inside the block, in order."""
    calls = []
    spies = []
    with contextlib.ExitStack() as stack:
        for module, real in ((corr_module, corr_fwd),
                             (corr_module, corr_bwd_f1),
                             (corr_module, corr_bwd_f2),
                             (deform_module, deform_fwd),
                             (deform_module, deform_bwd)):
            def spy(*args, _real=real):
                calls.append(launch_key(_real.__name__, args))
                return _real(*args)

            # a wrapper counts its launches under its module name, the
            # spy's while it stands there
            spy.launches = real.launches
            spies.append((real, spy))
            stack.enter_context(mock.patch.object(module, real.__name__,
                                                  spy))
        try:
            yield calls
        finally:
            for real, spy in spies:
                real.launches = spy.launches


def deform_bwd_asks(calls):
    """(Cin, needs) of every recorded deform_bwd launch."""
    return [(key[1][1], key[4]) for key in calls if key[0] == "deform_bwd"]


def require_checked(calls, what: str) -> None:
    """Require every recorded launch to be one that the checks held
    against its plain version."""
    missing = sorted({c for c in calls if c not in CHECKED}, key=str)
    require(not missing, f"{what} launched kernels at unchecked shapes: "
            f"{missing}")
    print(f"{what}: all {len(set(calls))} kernel launch shapes "
          f"({len(calls)} launches) were held against the plain versions",
          flush=True)


def drive_cascade_infer(gen):
    """The cascade's Predictor.do_batch with deform="kernel": f32 card vs
    CPU (64x128), f32 kernel vs warpconv (Sintel pairs at the 448x1024
    working size), then the bf16 main path with its launch counts and the
    ms/frame of both methods. Returns (launches of one forward, ms/frame
    of kernel and of warpconv)."""
    params = init_params(0, model="MaskFlownet")
    h, w = SLICE_HW
    b = CASCADE_BATCH
    img1 = torch.rand((b, 3, h, w), generator=gen, device="cuda")
    img2 = torch.rand((b, 3, h, w), generator=gen, device="cuda")
    kern_cfg, warp_cfg = KERNEL_CFG, WARP_CFG
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def predictor(device, dtype, cfg):
        return Predictor(params, device=device, dtype=dtype, cfg=cfg,
                         model="MaskFlownet")

    small1, small2 = img1[:1, :, :64, :128], img2[:1, :, :64, :128]
    card = predictor("cuda", torch.float32, kern_cfg).do_batch(small1, small2)
    cpu = predictor("cpu", torch.float32, kern_cfg).do_batch(small1.cpu(),
                                                             small2.cpu())
    dflow = (card[0].cpu() - cpu[0]).abs().max().item()
    docc = (card[1].cpu() - cpu[1]).abs().max().item()
    print(f"cascade f32 card vs CPU at 64x128: max |dflow| {dflow:.3e} px, "
          f"|docc| {docc:.3e} (tol {FLOW_TOL_PX} px; occ is flow2 / 20)",
          flush=True)
    require(dflow <= FLOW_TOL_PX and docc <= FLOW_TOL_PX / 20,
            "cascade card vs CPU")

    reset_counts()
    kern = predictor("cuda", torch.float32, kern_cfg).do_batch(img1, img2)
    torch.cuda.synchronize()
    counts = launch_counts()
    warp = predictor("cuda", torch.float32, warp_cfg).do_batch(img1, img2)
    torch.cuda.synchronize()
    require(launch_counts() == {**counts, "corr_fwd": 2 * counts["corr_fwd"]},
            "warpconv launched a deform kernel")
    check_outputs(kern, b, (h, w), "cascade f32 kernel")
    check_outputs(warp, b, (h, w), "cascade f32 warpconv")
    dflow = (kern[0] - warp[0]).abs().max().item()
    print(f"cascade f32 kernel vs warpconv {b}x{h}x{w}: max |dflow| "
          f"{dflow:.3e} px (tol {FLOW_TOL_PX}), |flow| max "
          f"{kern[0].abs().max().item():.3f} px", flush=True)
    require(dflow <= FLOW_TOL_PX, "cascade kernel vs warpconv")
    del kern, warp, card, cpu

    per_frame = {}
    launches = None
    for name, cfg in (("kernel", kern_cfg), ("warpconv", warp_cfg)):
        pbf = predictor("cuda", torch.bfloat16, cfg)
        with record_launches() as calls:
            for _ in range(3):                         # warm-up
                pbf.do_batch(img1, img2)
        torch.cuda.synchronize()
        require_checked(calls, f"cascade bf16 inference, deform {name}")
        reset_counts()
        out = pbf.do_batch(img1, img2)                 # counted
        torch.cuda.synchronize()
        got = {k: v for k, v in launch_counts().items() if v}
        check_outputs(out, b, (h, w), f"cascade bf16 {name}")
        if name == "kernel":
            launches = got
            print(f"cascade bf16 main path: one forward launched {got}",
                  flush=True)
            require(got == CASCADE_FWD, f"cascade forward launched {got}, "
                    f"not {CASCADE_FWD}")
        times = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(20):
            t0 = time.perf_counter()
            pbf.do_batch(img1, img2)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        per_frame[name] = statistics.median(times) / b
        print(f"cascade bf16 do_batch {b}x{h}x{w}, deform {name}: "
              f"{statistics.median(times):.3f} ms/batch (min "
              f"{min(times):.3f}, max {max(times):.3f}), "
              f"{per_frame[name]:.3f} ms/frame, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        del pbf, out
    return launches, per_frame


def drive_cascade_train(gen):
    """The frozen-head cascade step (fix_head, aug-off) with
    deform="kernel": f32 card vs CPU, f32 kernel vs warpconv, then the
    bf16 main path (batch 4, 320x768) with its launch counts, the needs of
    every deform_bwd, the head unchanged, ms/step, samples/s and peak
    memory; then one f32 MaskFlownet_S step with deform="kernel" (the full
    deform backward, dx included) against warpconv. Returns (launches in
    the main-path run, ms/step, samples/s)."""
    params = init_params(0, model="MaskFlownet")
    kern_cfg = KERNEL_CFG
    f32 = TrainSettings(model="MaskFlownet", fix_head=True,
                        compute_dtype="float32", model_cfg=kern_cfg)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    small = shifted_batch(gen, 1, (64, 128))
    card_trainer = Trainer(f32, device="cuda", params=params)
    cpu_trainer = Trainer(f32, device="cpu", params=params)
    card = compare_on_branches(
        "cascade frozen-head f32 card vs CPU at 64x128",
        lambda replay: step_grads(card_trainer, small),
        lambda replay: step_grads(cpu_trainer, [t.cpu() for t in small],
                                  replay=replay))
    require(not any(k.startswith(HEAD_SCOPE + "/") for k in card[1]),
            "a frozen head parameter has a gradient")
    del card_trainer, cpu_trainer, card

    batch = shifted_batch(gen, 2, CASCADE_TRAIN_HW)
    kern_trainer = Trainer(f32, device="cuda", params=params)
    warp_trainer = Trainer(TrainSettings(
        model="MaskFlownet", fix_head=True, compute_dtype="float32",
        model_cfg=WARP_CFG), device="cuda", params=params)
    calls = []

    # reads kern_trainer, batch and calls as they stand when it runs: the
    # S step below reuses it
    def kern_step(replay):
        with record_launches() as recorded:
            got = step_grads(kern_trainer, batch)
        calls.extend(recorded)
        return got

    compare_on_branches(
        f"cascade frozen-head f32 kernel vs warpconv, 2x"
        f"{CASCADE_TRAIN_HW[0]}x{CASCADE_TRAIN_HW[1]}", kern_step,
        lambda replay: step_grads(warp_trainer, batch, replay=replay),
        keys=("leaky", "corr"))
    asked = deform_bwd_asks(calls)
    print(f"cascade frozen-head step: deform_bwd asked (Cin, (dx, dflow, "
          f"dweight)) {asked}", flush=True)
    require(len(asked) == CASCADE_STEP["deform_bwd"], "deform_bwd calls")
    require(all(needs == ((False, False, True) if cin == 196 else
                          (False, True, True)) for cin, needs in asked),
            "the frozen step asks dweight only at level 6, dflow and "
            "dweight elsewhere, dx nowhere")
    del kern_trainer, warp_trainer

    b = CASCADE_BATCH
    batch = shifted_batch(gen, b, CASCADE_TRAIN_HW)
    trainer = Trainer(TrainSettings(model="MaskFlownet", fix_head=True,
                                    model_cfg=kern_cfg), device="cuda",
                      params=params)
    head = {k: trainer.params[k].detach().clone() for k in trainer.frozen}
    with record_launches() as calls:
        losses = [trainer.train_batch(*batch, lr=TRAIN_LR, sync=True)["loss"]
                  for _ in range(3)]                # warm-up
    torch.cuda.synchronize()
    require_checked(calls, "cascade bf16 frozen-head step")
    torch.cuda.reset_peak_memory_stats()
    timed = 20
    reset_counts()
    t0 = time.perf_counter()
    metrics = [trainer.train_batch(*batch, lr=TRAIN_LR)
               for _ in range(timed)]
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / timed
    launches = {k: v for k, v in launch_counts().items() if v}
    print(f"cascade train main path: {timed} steps launched {launches}",
          flush=True)
    require(launches == {k: v * timed for k, v in CASCADE_STEP.items()},
            f"the frozen-head steps launched {launches}, not "
            f"{timed} x {CASCADE_STEP}")
    losses += [m["loss"].item() for m in metrics]
    require(all(map(math.isfinite, losses)), f"non-finite loss: {losses}")
    require(all(torch.equal(trainer.params[k], v) for k, v in head.items()),
            "the frozen head moved")
    print(f"cascade train bf16 {b}x{CASCADE_TRAIN_HW[0]}x"
          f"{CASCADE_TRAIN_HW[1]}, head frozen: {ms_step:.3f} ms/step, "
          f"{b * 1e3 / ms_step:.2f} samples/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss step 1 "
          f"{losses[0]:.4f}, step {len(losses)} {losses[-1]:.4f}; the head's "
          f"{len(head)} parameters bitwise unchanged", flush=True)
    del trainer

    # MaskFlownet_S with the kernels: the full deform backward
    s_params = init_params(0)
    batch = shifted_batch(gen, 2, TRAIN_HW)
    kern_trainer = Trainer(TrainSettings(compute_dtype="float32",
                                         model_cfg=kern_cfg), device="cuda",
                           params=s_params)
    warp_trainer = Trainer(TrainSettings(compute_dtype="float32",
                                         model_cfg=WARP_CFG),
                           device="cuda", params=s_params)
    calls = []
    compare_on_branches(
        f"MaskFlownet_S f32 deform kernel vs warpconv, 2x"
        f"{TRAIN_HW[0]}x{TRAIN_HW[1]}", kern_step,
        lambda replay: step_grads(warp_trainer, batch, replay=replay),
        keys=("leaky", "corr"))
    asked = deform_bwd_asks(calls)
    require(sorted(asked) == [(c, (True, True, True)) for c in (32, 64, 96, 128)],
            f"the S step's deform_bwd calls {asked}")
    return launches, ms_step, b * 1e3 / ms_step


def write_chairs_tree(root: str):
    """INPUT_SAMPLES synthetic pairs (``data.synthetic``, seed 0) at the
    FlyingChairs size written as a FlyingChairs tree under ``root``: the
    fixed-header ``.ppm`` images, ``.flo`` flow in (u, v) order, and a split
    file whose last line is a validation sample. Returns the pairs as
    written ((img1s, img2s, flows (dy, dx))) and the split file's path."""
    h, w = chairs.SHAPE
    img1s, img2s, flows, _ = synthetic.make_dataset(
        np.random.RandomState(0), INPUT_SAMPLES, h, w)
    for i, (a, b, f) in enumerate(zip(img1s, img2s, flows), 1):
        for j, img in ((1, a), (2, b)):
            with open(os.path.join(root, "%05d_img%d.ppm" % (i, j)),
                      "wb") as fp:
                fp.write(b"P6 %d %d 255\n" % (w, h) + img.tobytes())
        codecs.flo_save(f[..., ::-1], os.path.join(root, "%05d_flow.flo" % i))
    split = os.path.join(root, "FlyingChairs_train_val.txt")
    with open(split, "w") as fp:
        fp.write("1\n" * (INPUT_SAMPLES - 1) + "2\n")
    return (img1s, img2s, flows), split


def _int_view(x):
    """The integers of a uint8 or f16 tensor or array (f16 as its bits)."""
    if x.dtype in (torch.float16, np.float16):
        return x.view(torch.int16 if torch.is_tensor(x) else np.int16)
    return x


def host_checksum(a) -> int:
    """sum_k x_k * (k % 251 + 1) over the integers of ``a``, flattened."""
    flat = _int_view(a).reshape(-1).astype(np.int64)
    return int((flat * (np.arange(flat.size) % 251 + 1)).sum())


def device_checksum(t, weights):
    """:func:`host_checksum` on the device, on the current stream."""
    flat = _int_view(t).reshape(-1).to(torch.int64)
    return (flat * weights[:flat.numel()]).sum()


class TaggedSource:
    """Host batches, each a copy of one of ``bases`` whose img1 carries its
    transfer index in its first three bytes (little-endian); keeps every
    index's checksums (:func:`host_checksum` of each array) in ``sums``.
    Never waits: a refresh thread replaces slots as fast as it can."""

    def __init__(self, bases):
        self.bases = bases
        self.base_sums = [[host_checksum(x) for x in b] for b in bases]
        self.sums: list[list[int]] = []

    def __call__(self):
        i = len(self.sums)
        k = i % len(self.bases)
        img1 = self.bases[k][0].copy()
        flat = img1.reshape(-1)
        tag = np.array([i & 255, (i >> 8) & 255, (i >> 16) & 255], np.int64)
        delta = int(((tag - flat[:3].astype(np.int64))
                     * (np.arange(3) + 1)).sum())
        flat[:3] = tag
        sums = list(self.base_sums[k])
        sums[0] += delta
        self.sums.append(sums)
        return (img1, *self.bases[k][1:])


def integrity(feed, source: TaggedSource, trainer, steps: int):
    """Drive ``steps`` train steps from ``feed`` (a cache or prefetcher of
    ``source``'s batches). At each serve the compute stream copies the
    batch's tag; after the step it sleeps SLEEP_CYCLES and then takes the
    checksum of every served tensor; the host's reference drops right
    after. A served tensor whose memory a later copy reused before the
    checksums read it disagrees with the host's checksums of its index.
    Stops ``feed``; returns (the served indices, the (index, device
    checksums) that disagree, the transfers made)."""
    numel = max(x.size for x in source.bases[0])
    weights = torch.arange(numel, device="cuda", dtype=torch.int64) % 251 + 1
    rows = []
    for _ in range(steps):
        batch = feed.get()
        tag = batch[0].reshape(-1)[:3].to(torch.int64)
        trainer.train_batch_device(batch, lr=TRAIN_LR)
        torch.cuda._sleep(SLEEP_CYCLES)
        rows.append(torch.cat([tag, torch.stack(
            [device_checksum(t, weights) for t in batch])]))
        del batch
    feed.stop()
    served = [(r[0] + 256 * r[1] + 65536 * r[2], r[3:])
              for r in torch.stack(rows).cpu().tolist()]
    bad = [(i, sums) for i, sums in served if source.sums[i] != sums]
    return [i for i, _ in served], bad, len(source.sums)


def check_integrity(what, feed, source, trainer, steps: int) -> int:
    """:func:`integrity`: ``steps`` steps from ``feed`` while its slots are
    replaced; requires every served tensor to match the host's checksums
    of its transfer index after the step. Returns the transfers made.
    ``tools/input_probe.py`` runs it with the guards taken out."""
    served, bad, transfers = integrity(feed, source, trainer, steps)
    print(f"input integrity {what}: {steps} steps served transfer indices "
          f"{min(served)}..{max(served)} of {transfers} transfers, "
          f"{len(bad)} with a checksum that differs from the host's",
          flush=True)
    require(not bad, f"{what}: served tensors changed under the step "
            f"(index, device checksums): {bad[:3]}")
    return transfers


def whole_step(make_trainer, run, draws, metrics):
    """A ``compare_on_branches`` side made of a whole train step:
    ``run(trainer)`` (a ``train_batch_device`` or ``train_batch`` call) on
    a fresh ``make_trainer()`` that draws ``draws``, giving what
    ``step_grads`` gives -- the loss, each parameter's gradient (on the
    CPU) as the step hands it to ``apply_gradients``, and the branch
    values (``grad_parity.branches``, replaying ``replay``'s) -- and
    appending the step's metrics to ``metrics``."""
    def step(replay):
        trainer = make_trainer()
        seen, patches = grad_parity.branches(trainer.device.type, replay)
        grads = {}
        apply = trainer.apply_gradients

        def record(lr):
            grads.update({k: p.grad.detach().cpu()
                          for k, p in trainer.params.items()
                          if p.grad is not None})
            apply(lr)

        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            stack.enter_context(mock.patch.object(trainer, "apply_gradients",
                                                  record))
            stack.enter_context(mock.patch.object(
                trainer, "draw", lambda b, hw: draws))
            out = run(trainer)
        metrics.append({k: v.item() for k, v in out.items()})
        return out["loss"].item(), grads, seen
    return step


def timed_steps(step, n: int):
    """ms/step of ``n`` calls of ``step()`` ended by one synchronize, with
    the launch counts and the peak memory of the run."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    launches = {k: v for k, v in launch_counts().items() if v}
    return ms, launches, torch.cuda.max_memory_allocated() / 2**30


def wait_until_full(loader) -> None:
    """Wait until the loader's producers and mixer block on full queues,
    so that no loader thread runs beside what is timed next."""
    t0 = time.perf_counter()
    while not (loader.batch_queue.full()
               and all(q.full() for q in loader._queues)):
        require(time.perf_counter() - t0 < 120, "the loader did not fill")
        time.sleep(0.05)


def copy_ms(batch, pinned: bool) -> float:
    """Median of 10 host-to-device copies of the whole ``batch``, by CUDA
    events: from pinned memory without blocking, or from the pageable
    arrays."""
    host = [torch.from_numpy(np.ascontiguousarray(x)) for x in batch]
    if pinned:
        host = [t.pin_memory() for t in host]
    times = []
    for _ in range(11):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dev = [t.to("cuda", non_blocking=pinned) for t in host]
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        del dev
    return statistics.median(times[1:])


def drive_input(smi: str):
    """The FlyingChairs input path, from files to the augmented bf16 S step
    through ``Trainer.train_batch_device``. Returns (launches of each
    kernel in the run through the refreshing cache, the phase's numbers)."""
    params = init_params(0)
    per_step = {**S_STEP, "affine_sample": 2}
    want = {k: v * INPUT_TIMED for k, v in per_step.items()}
    out = {}

    # a FlyingChairs tree on disk, read back
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        written, split = write_chairs_tree(root)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        train, val = chairs.read_trainval(split)
        tr = chairs.load_set(train, root)
        va = chairs.load_set(val, root)
        read_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(root, f))
                   for f in os.listdir(root))
    require((train, val) == (list(range(1, INPUT_SAMPLES)), [INPUT_SAMPLES]),
            f"the split reads back as {train}, {val}")
    for col, got in enumerate(zip(tr, va)):
        for i, arr in enumerate(got[0] + got[1]):
            require(arr.dtype == written[col][i].dtype
                    and np.array_equal(arr, written[col][i]),
                    f"sample {i + 1}, column {col}: read back differs")
    print(f"input: wrote a FlyingChairs tree of {INPUT_SAMPLES} synthetic "
          f"pairs at {chairs.SHAPE[0]}x{chairs.SHAPE[1]} ({size / 1e6:.1f} "
          f"MB) in {write_s:.2f} s, read it back with read_trainval and "
          f"load_set in {read_s:.2f} s: images and flow (dy, dx) bitwise "
          f"equal", flush=True)

    # the CLI's loader and device cache, the chairs presets' augmented
    # bf16 S step
    b = TRAIN_BATCH
    loader = TrainLoader([Dataset(tr)] * b, b, AUG_SRC_HW, seed=0)
    cache = DeviceBatchCache(loader.get, slots=INPUT_SLOTS,
                             transform=with_mask)
    settings = TrainSettings(color=presets.color_aug_config("chairs"),
                             geo=presets.geometry_aug_config(
                                 "chairs", TRAIN_HW, AUG_SRC_HW))
    trainer = Trainer(settings, device="cuda", params=params)
    with record_launches() as calls:
        losses = [trainer.train_batch_device(cache.get(), lr=TRAIN_LR)[
            "loss"].item() for _ in range(3)]       # warm-up
    require_checked(calls, "input bf16 main path")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.prepare(*nchw_batch(cache.get()))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.train_batch_device(cache.get(), lr=TRAIN_LR)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    print(f"input: cache.get() and prepare queue without a synchronisation; "
          f"the whole train_batch_device step: {len(syncs)} "
          f"synchronisations{': ' + syncs[0] if syncs else ''}", flush=True)

    def report(name, ms, launches, peak, extra=""):
        require(launches == want, f"{name}: {INPUT_TIMED} steps launched "
                f"{launches}, not {INPUT_TIMED} x {per_step}")
        out[name] = {"ms_per_step": ms, "samples_per_s": b * 1e3 / ms,
                     "peak_gib": peak}
        print(f"input {name}, bf16 {b}x{AUG_SRC_HW[0]}x{AUG_SRC_HW[1]} -> "
              f"{TRAIN_HW[0]}x{TRAIN_HW[1]}: {ms:.3f} ms/step, "
              f"{b * 1e3 / ms:.2f} samples/s, peak memory {peak:.2f} GiB"
              f"{extra} ({smi})", flush=True)

    # through the cache while it refreshes (the loader's 8 producers, its
    # mixer and the refresh thread running beside the step)
    cache.reset_stats()
    metrics = []
    ms, launches, peak = timed_steps(lambda: metrics.append(
        trainer.train_batch_device(cache.get(), lr=TRAIN_LR)), INPUT_TIMED)
    main_launches = launches
    out["echo_factor"], out["transfers"] = cache.echo_factor, cache.transfers
    report("cache refreshing", ms, launches, peak,
           f"; echo_factor {cache.echo_factor:.3f}, {cache.transfers} "
           f"transfers in {INPUT_TIMED} serves")
    losses += [m["loss"].item() for m in metrics]

    # the cache only serving: refresh stopped, the loader's queues full
    cache.stop()
    require(not cache._thread.is_alive(), "the refresh thread did not stop")
    wait_until_full(loader)
    cache.reset_stats()
    ms, launches, peak = timed_steps(
        lambda: trainer.train_batch_device(cache.get(), lr=TRAIN_LR),
        INPUT_TIMED)
    report("cache serving only", ms, launches, peak,
           f"; echo_factor {cache.echo_factor:.3f}")

    # train_batch on host batches: a pageable copy each step
    batches = iter([[np.ascontiguousarray(x.transpose(0, 3, 1, 2))
                     for x in with_mask(loader.get())]
                    for _ in range(INPUT_TIMED)])
    wait_until_full(loader)
    ms, launches, peak = timed_steps(
        lambda: trainer.train_batch(*next(batches), lr=TRAIN_LR),
        INPUT_TIMED)
    report("train_batch on host batches", ms, launches, peak)

    # through the prefetcher
    pre = DevicePrefetcher(loader.get, depth=2, transform=with_mask)
    for _ in range(2):
        trainer.train_batch_device(pre.get(), lr=TRAIN_LR)
    ms, launches, peak = timed_steps(
        lambda: trainer.train_batch_device(pre.get(), lr=TRAIN_LR),
        INPUT_TIMED)
    pre.stop()
    report("prefetcher", ms, launches, peak)
    require(all(map(math.isfinite, losses)), f"non-finite loss: {losses}")
    print(f"input: loss step 1 {losses[0]:.4f}, step {len(losses)} "
          f"{losses[-1]:.4f}", flush=True)

    # slots replaced under the steps that read them
    bases = [with_mask(loader.get()) for _ in range(2)]
    source = TaggedSource(bases)
    n = check_integrity("cache (2 slots)", DeviceBatchCache(
        source, slots=2), source, trainer, INTEGRITY_STEPS)
    out["integrity_cache_transfers"] = n
    source = TaggedSource(bases)
    n = check_integrity("prefetcher (depth 2)", DevicePrefetcher(
        source, depth=2), source, trainer, INPUT_TIMED)
    out["integrity_prefetcher_transfers"] = n

    # a cached batch against the same host batch, f32, the same draws:
    # train_batch_device against train_batch on the card (loss and epe
    # bitwise, the gradients each step hands to apply_gradients within
    # GRAD_RTOL), then the card's train_batch_device against the CPU's
    # train_batch on a corner of the batch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    host = bases[0]
    one = DeviceBatchCache(lambda it=iter([host]): next(it, None), slots=1)
    cached = one.get()
    require(all(np.array_equal(t.cpu().numpy(), x)
                for t, x in zip(cached, host)), "the cached batch differs "
            "from the host batch")
    f32 = dataclasses.replace(settings, compute_dtype="float32",
                              model_cfg=KERNEL_CFG)
    card_host = [torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))).to("cuda") for x in host]
    draws = Trainer(f32, device="cuda", params=params,
                    seed=5).draw(b, AUG_SRC_HW)
    got, want = [], []
    compare_on_branches(
        f"input f32 train_batch_device on the cached batch vs train_batch "
        f"on the host batch, the card, {b}x{AUG_SRC_HW[0]}x{AUG_SRC_HW[1]}",
        whole_step(lambda: Trainer(f32, device="cuda", params=params),
                   lambda t: t.train_batch_device(cached, lr=TRAIN_LR),
                   draws, got),
        whole_step(lambda: Trainer(f32, device="cuda", params=params),
                   lambda t: t.train_batch(*card_host, lr=TRAIN_LR),
                   draws, want))
    print(f"input f32 train_batch_device vs train_batch, the card: loss "
          f"{got[0]['loss']:.7f} vs {want[0]['loss']:.7f}, epe "
          f"{got[0]['epe']:.7f} vs {want[0]['epe']:.7f}", flush=True)
    require(got[0] == want[0], "train_batch_device and train_batch differ "
            f"in loss or epe: {got[0]} vs {want[0]}")
    del card_host
    small = dataclasses.replace(f32, geo=presets.geometry_aug_config(
        "chairs", AUG_SMALL_HW, AUG_SMALL_SRC_HW))
    sh, sw = AUG_SMALL_SRC_HW
    corner = tuple(t[:1, :sh, :sw] for t in cached)
    cpu_batch = [torch.from_numpy(np.ascontiguousarray(x[:1, :sh, :sw]
                                                       .transpose(0, 3, 1, 2)))
                 for x in host]
    draws = Trainer(small, device="cuda", params=params,
                    seed=5).draw(1, AUG_SMALL_SRC_HW)
    compare_on_branches(
        f"input f32 train_batch_device on a cached corner, the card, vs "
        f"train_batch on the host's, the CPU, {AUG_SMALL_SRC_HW} -> "
        f"{AUG_SMALL_HW}",
        whole_step(lambda: Trainer(small, device="cuda", params=params),
                   lambda t: t.train_batch_device(corner, lr=TRAIN_LR),
                   draws, []),
        whole_step(lambda: Trainer(small, device="cpu", params=params),
                   lambda t: t.train_batch(*cpu_batch, lr=TRAIN_LR),
                   draws, []))
    one.stop()
    del cached, corner, one

    # one batch's bytes and its copy to the card
    nbytes = sum(x.nbytes for x in host)
    pinned, pageable = copy_ms(host, True), copy_ms(host, False)
    out.update(batch_bytes=nbytes, copy_pinned_ms=pinned,
               copy_pageable_ms=pageable)
    rates = [nbytes / ms / 1e6 for ms in (pinned, pageable)]
    print(f"input: one batch is {nbytes} bytes ({nbytes / 1e6:.2f} MB); its "
          f"host-to-device copy {pinned:.3f} ms pinned ({rates[0]:.2f} "
          f"GB/s), {pageable:.3f} ms pageable ({rates[1]:.2f} GB/s) ({smi})",
          flush=True)
    return main_launches, out


def filter_rows(body, bpp: int, filters=(0, 1, 2, 3, 4)):
    """The PNG filter bytes and filtered rows of ``body`` (h, stride) uint8,
    row y filtered by ``filters[y % len(filters)]`` (None, Sub, Up,
    Average, Paeth) with ``bpp`` bytes a pixel: ``((h,) uint8, (h,
    stride) uint8)``."""
    raw = body.astype(np.int16)
    h = raw.shape[0]
    a = np.pad(raw, ((0, 0), (bpp, 0)))[:, :-bpp]             # left
    b = np.concatenate([np.zeros_like(raw[:1]), raw[:-1]])      # up
    c = np.pad(b, ((0, 0), (bpp, 0)))[:, :-bpp]               # up-left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(raw), a, b, (a + b) >> 1, paeth])
    ft = np.array([filters[y % len(filters)] for y in range(h)], np.uint8)
    return ft, ((raw - preds[ft, np.arange(h)]) % 256).astype(np.uint8)


def png_file(path: str, ft, rows, w: int, depth: int, ctype: int) -> None:
    """A PNG of filtered rows (``filter_rows``), written with zlib (the
    card's machine has no image library), its data in IDAT chunks of 64
    KiB."""
    h = rows.shape[0]
    data = zlib.compress(np.concatenate([ft[:, None], rows], 1).tobytes(), 1)

    def chunk(typ: bytes, payload: bytes) -> bytes:
        return (len(payload).to_bytes(4, "big") + typ + payload
                + (zlib.crc32(typ + payload) & 0xFFFFFFFF).to_bytes(4, "big"))

    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n")
        fp.write(chunk(b"IHDR", w.to_bytes(4, "big") + h.to_bytes(4, "big")
                       + bytes([depth, ctype, 0, 0, 0])))
        for i in range(0, len(data), 1 << 16):
            fp.write(chunk(b"IDAT", data[i:i + (1 << 16)]))
        fp.write(chunk(b"IEND", b""))


def png8_save(path: str, arr) -> None:
    """An 8-bit PNG of (H, W) gray or (H, W, 3) RGB uint8, its rows filtered
    None, Sub, Up, Average and Paeth in turn and its data in several IDAT
    chunks, so that ``codecs.image_load`` decodes every filter and several
    chunks."""
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else arr.shape[2]
    ft, rows = filter_rows(arr.reshape(h, w * bpp), bpp)
    png_file(path, ft, rows, w, 8, 0 if bpp == 1 else 2)


def write_sintel_tree(root: str, rng) -> dict:
    """A Sintel tree at its native 436x1024 under ``root``: training
    sequences alley_1 and ambush_2 of CLI_SINTEL_FRAMES frames in clean and
    final, their flow (u, v) and invalid masks, a split file giving
    alley_1 to training1 and ambush_2 to training2, and a test sequence of
    CLI_SINTEL_TEST frames in final. Returns the readers' environment."""
    h, w = sintel.SHAPE
    seqs = ("alley_1", "ambush_2")
    for seq in seqs:
        for part in ("clean", "final", "flow", "invalid"):
            os.makedirs(os.path.join(root, "training", part, seq))
        for i in range(1, CLI_SINTEL_FRAMES + 1):
            for part in ("clean", "final"):
                png8_save(os.path.join(root, "training", part, seq,
                                       f"frame_{i:04d}.png"),
                          rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
            if i < CLI_SINTEL_FRAMES:
                codecs.flo_save(
                    (rng.randn(h, w, 2) * 4).astype(np.float32),
                    os.path.join(root, "training", "flow", seq,
                                 f"frame_{i:04d}.flo"))
                png8_save(os.path.join(root, "training", "invalid", seq,
                                       f"frame_{i:04d}.png"),
                          (rng.rand(h, w) < 0.1).astype(np.uint8) * 255)
    test = os.path.join(root, "test", "final", "market_1")
    os.makedirs(test)
    for i in range(1, CLI_SINTEL_TEST + 1):
        png8_save(os.path.join(test, f"frame_{i:04d}.png"),
                  rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
    split = os.path.join(root, "Sintel_train_val_maskflownet.txt")
    with open(split, "w") as fp:
        fp.write("1\n" * (CLI_SINTEL_FRAMES - 1)
                 + "2\n" * (CLI_SINTEL_FRAMES - 1))
    return {"MFN_SINTEL_ROOT": root, "MFN_SINTEL_SPLIT": split}


def write_kitti_tree(root: str, rng) -> dict:
    """KITTI 2012 and 2015 trees at 370x1224 under ``root``:
    CLI_KITTI_TRAIN training pairs with a flow_occ PNG16 each (70% of the
    pixels valid), CLI_KITTI_TEST testing pairs. Returns the readers'
    environment."""
    path = kitti.default_paths(root)
    for d in path.values():
        os.makedirs(d)
    h, w = CLI_KITTI_HW
    for ed in ("2012", "2015"):
        for n, key in ((CLI_KITTI_TRAIN, "image"), (CLI_KITTI_TEST,
                                                    "testing")):
            for k in range(n):
                for s in (10, 11):
                    png8_save(os.path.join(path[ed + key],
                                           f"{k:06d}_{s}.png"),
                              rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        for k in range(CLI_KITTI_TRAIN):
            enc = codecs.kitti_flow_encode(
                (rng.randn(h, w, 2) * 6).astype(np.float32))
            enc[..., 2] = rng.rand(h, w) < 0.7
            codecs.png16_save(enc, os.path.join(path[ed + "flow_occ"],
                                                f"{k:06d}_10.png"))
    return {"MFN_KITTI_ROOT": root}


def cut_yaml(name: str, path: str, steps: int | None = None,
             **settings) -> str:
    """A copy of the stock config ``name`` at ``path``: its learning-rate
    schedule cut to its first rate for ``steps`` steps, or the top-level
    ``settings`` replaced. Returns ``path``."""
    with open(os.path.join(CONFIG_DIR, name)) as fp:
        lines = fp.read().splitlines()
    if steps is not None:
        first = load_config(name).optimizer.learning_rate.value[0][1]
        cut = lines.index("  learning_rate:") + 1
        lines = lines[:cut] + [f"    - [{steps}, {first!r}]"]
    for key, value in settings.items():
        lines = [f"{key}: {value}" if ln.startswith(key + ":") else ln
                 for ln in lines]
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")
    return path


def cli_want(steps: int, per_step: dict, forwards: int,
             per_forward: dict) -> dict:
    """Launch counts of ``steps`` train steps and ``forwards`` inference
    forwards."""
    want = {k: v * steps for k, v in per_step.items()}
    for k, v in per_forward.items():
        want[k] = want.get(k, 0) + v * forwards
    return {k: v for k, v in want.items() if v}


def run_cli(argv, what: str, want: dict | None):
    """``cli.main(argv)`` in this process, its launch counts zeroed just
    before and read just after, every correlation and deform launch
    recorded; requires exit code 0, ``want``'s launch counts (unless
    None) and no thread that ``main`` started still alive. Returns (the
    counts, the recorded launches, the DeviceBatchCache it made or None,
    the validation sweeps' (seconds, frames), seconds)."""
    caches, sweeps = [], []

    class RecordedCache(DeviceBatchCache):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            caches.append(self)

    real_validation = cli_module.run_validation

    def timed_validation(trainer, validation, batch_size, resize):
        t0 = time.perf_counter()
        out = real_validation(trainer, validation, batch_size, resize)
        sweeps.append((time.perf_counter() - t0,
                       sum(len(v[0]) for v in validation.values())))
        return out

    before = set(threading.enumerate())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(cli_module, "DeviceBatchCache",
                                              RecordedCache))
        stack.enter_context(mock.patch.object(cli_module, "run_validation",
                                              timed_validation))
        calls = stack.enter_context(record_launches())
        rc = cli_module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    alive = [t.name for t in threading.enumerate()
             if t not in before and t.is_alive()]
    require(rc == 0, f"cli {what}: main returned {rc}")
    require(not alive, f"cli {what}: threads still alive after main "
            f"returned: {alive}")
    if want is not None:
        require(launches == want, f"cli {what}: launched {launches}, "
                f"not {want}")
    print(f"cli {what}: main returned 0 in {seconds:.3f} s, no thread it "
          f"started alive; launches {launches}", flush=True)
    return launches, calls, (caches[0] if caches else None), sweeps, seconds


def train_log(root: str, run_id: str, steps: int, what: str) -> list[dict]:
    """The log's step lines, required finite in loss and epe at every step
    1..``steps``."""
    rows = []
    with open(os.path.join(root, "logs", run_id + ".log")) as fp:
        for line in fp:
            body = line.split("] ", 1)[1].strip()
            if ", loss=" in body:
                rows.append({k: float(v) for k, v in (
                    kv.split("=", 1) for kv in body.split(", "))})
    require([int(r["steps"]) for r in rows] == list(range(1, steps + 1)),
            f"cli {what}: logged steps {[r['steps'] for r in rows]}")
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["epe"])
                for r in rows), f"cli {what}: non-finite loss or epe")
    return rows


def checkpoint_of(root: str, run_id: str, steps: int, model: str) -> str:
    """The run's checkpoint at ``steps``, required to read back through
    ``interop`` with ``model``'s parameter names and shapes."""
    cks = dict((s, p) for p, s in find_checkpoints(root, run_id))
    require(steps in cks, f"cli: no checkpoint of {run_id} at {steps}: "
            f"{cks}")
    state = interop.read_npz(cks[steps], param_shapes(model=model))
    require(state["step"] == steps and all(
        bool(torch.isfinite(v).all()) for v in state["params"].values()),
        f"cli: checkpoint {cks[steps]} reads back wrong")
    return cks[steps]


def check_uncovered(calls, gen, what: str) -> None:
    """Hold every correlation and deform launch shape in ``calls`` that no
    check has covered yet against the plain versions (the case checks of
    phases 3 and 4), then require them all covered."""
    for key in sorted(set(calls), key=str):
        if key in CHECKED:
            continue
        name, shape, arg, dtype = key[:4]
        if name == "corr_fwd":
            check_corr_fwd_case(arg, shape, gen)
        elif name.startswith("corr_bwd"):
            check_corr_bwd_case(arg, shape, gen)
        else:
            needs = list(DEFORM_NEEDS) + [
                k[4] for k in calls if k[:4] == ("deform_bwd",) + key[1:4]
                and k[4] not in DEFORM_NEEDS]
            check_deform_case(gen, what, shape, arg, None, True, dtype,
                              needs)
            print(f"deform check {what} {shape} -> {arg} {dtype}: ok",
                  flush=True)
    require_checked(calls, what)


def drive_cli(smi: str, gen, tmp: str):
    """The training CLI (``python -m maskflownet_torch.cli.main``) in this
    process on FlyingChairs, Sintel and KITTI trees it writes under
    ``tmp``: the S stage through the device cache and through host
    geometry, the augmented cascade from the first S run with its head
    frozen, ``--valid`` on the card and the CPU, ``--predict`` against
    ``Trainer.predict``. Returns (the launches of each stage, the phase's
    numbers, the readers' environment of the trees)."""
    b = presets.BATCH_SIZE["chairs"]
    out, launches, all_calls = {}, {}, []
    per_cached = {**S_STEP, "affine_sample": 2}
    per_cascade = {**CASCADE_STEP, "affine_sample": 2}
    # a validation's forwards: chairs' one sample, Sintel training2's
    # clean and final (CLI_SINTEL_FRAMES - 1 pairs each), one batch each
    val_forwards = 1 + 2 * math.ceil((CLI_SINTEL_FRAMES - 1) / b)

    def validations(steps):
        return 1 + steps // CLI_VAL_STEPS

    t0 = time.perf_counter()
    rng = np.random.RandomState(7)
    chairs_dir = os.path.join(tmp, "chairs")
    os.makedirs(chairs_dir)
    _, chairs_split = write_chairs_tree(chairs_dir)
    env = {"MFN_CHAIRS_DIR": chairs_dir, "MFN_CHAIRS_SPLIT": chairs_split,
           **write_sintel_tree(os.path.join(tmp, "sintel"), rng),
           **write_kitti_tree(os.path.join(tmp, "kitti"), rng)}
    s20 = cut_yaml("MaskFlownet_S.yaml", os.path.join(tmp, "s.yaml"),
                   CLI_S_STEPS)
    s10 = cut_yaml("MaskFlownet_S.yaml", os.path.join(tmp, "s_host.yaml"),
                   CLI_HOST_STEPS)
    c10 = cut_yaml("MaskFlownet.yaml", os.path.join(tmp, "cascade.yaml"),
                   CLI_CASCADE_STEPS)
    ds_s = cut_yaml("chairs.yaml", os.path.join(tmp, "chairs_s.yaml"),
                    validation_steps=CLI_VAL_STEPS,
                    checkpoint_steps=CLI_S_STEPS)
    ds_10 = cut_yaml("chairs.yaml", os.path.join(tmp, "chairs_10.yaml"),
                     validation_steps=CLI_VAL_STEPS,
                     checkpoint_steps=CLI_VAL_STEPS)
    print(f"cli: chairs ({INPUT_SAMPLES} pairs), Sintel (2 x "
          f"{CLI_SINTEL_FRAMES} frames x clean/final, {CLI_SINTEL_TEST} "
          f"test) and KITTI ({CLI_KITTI_TRAIN} + {CLI_KITTI_TEST} pairs "
          f"an edition) trees written in {time.perf_counter() - t0:.3f} "
          f"s", flush=True)
    root, root_host = os.path.join(tmp, "exp"), os.path.join(tmp, "host")
    with mock.patch.dict(os.environ, env):
        # 1. the S stage through the device cache (--aug device)
        launches["s"], calls, cache, sweeps, _ = run_cli(
            [s20, "--dataset_cfg", ds_s, "--root", root,
             "--device_cache", str(CLI_SLOTS)], "S stage, device cache",
            cli_want(CLI_S_STEPS, per_cached,
                     validations(CLI_S_STEPS) * val_forwards, S_FWD))
        all_calls += calls
        (s_run,) = [f[:-4] for f in os.listdir(os.path.join(root, "logs"))
                    if f.endswith(".log")]
        rows = train_log(root, s_run, CLI_S_STEPS, "S stage")
        s_ck = checkpoint_of(root, s_run, CLI_S_STEPS, "MaskFlownet_S")
        out["s"] = {"echo_factor": cache.echo_factor,
                    "transfers": cache.transfers}
        stages = [("s", "S stage, device cache", rows, sweeps)]

        # 2. the S stage through host geometry (--aug host, the
        # prefetcher), in a root of its own
        launches["s_host"], calls, _, sweeps, _ = run_cli(
            [s10, "--dataset_cfg", ds_10, "--root", root_host],
            "S stage, host geometry",
            cli_want(CLI_HOST_STEPS, S_STEP,
                     validations(CLI_HOST_STEPS) * val_forwards, S_FWD))
        all_calls += calls
        (h_run,) = [f[:-4] for f in os.listdir(
            os.path.join(root_host, "logs")) if f.endswith(".log")]
        rows = train_log(root_host, h_run, CLI_HOST_STEPS, "host stage")
        checkpoint_of(root_host, h_run, CLI_HOST_STEPS, "MaskFlownet_S")
        out["s_host"] = {}
        stages.append(("s_host", "S stage, host geometry", rows, sweeps))

        # 3. the cascade from the S run: load_head, the frozen head,
        # the augmented cascade step
        launches["cascade"], calls, cache, sweeps, _ = run_cli(
            [c10, "--dataset_cfg", ds_10, "--root", root, "-c",
             f"{s_run}:{CLI_S_STEPS}", "--clear_steps", "--device_cache",
             str(CLI_SLOTS)], "cascade stage, device cache",
            cli_want(CLI_CASCADE_STEPS, per_cascade,
                     validations(CLI_CASCADE_STEPS) * val_forwards,
                     CASCADE_FWD))
        all_calls += calls
        (c_run,) = [f[:-4] for f in os.listdir(os.path.join(
            root, "logs")) if f.endswith(".log") and f[:-4] != s_run]
        rows = train_log(root, c_run, CLI_CASCADE_STEPS, "cascade stage")
        c_ck = checkpoint_of(root, c_run, CLI_CASCADE_STEPS,
                             "MaskFlownet")
        with np.load(s_ck) as sz, np.load(c_ck) as cz:
            head = [k for k in sz.files if k.startswith("p:")]
            require(head and all(np.array_equal(
                cz[f"p:{HEAD_SCOPE}/{k[2:]}"], sz[k]) for k in head),
                "cli cascade: the head's parameters changed")
        print(f"cli cascade stage: the head's {len(head)} parameters "
              f"bitwise those of the S run's step-{CLI_S_STEPS} "
              f"checkpoint", flush=True)
        out["cascade"] = {"echo_factor": cache.echo_factor,
                          "transfers": cache.transfers}
        stages.append(("cascade", "cascade stage, device cache", rows,
                       sweeps))
        for key, what, rows, sweeps in stages:
            last = rows[-1]
            ms, load_ms = last["total_time"] * 1e3, \
                last["loading_time"] * 1e3
            val_s, frames = map(sum, zip(*sweeps))
            out[key].update(ms_per_step=ms, loading_ms_per_step=load_ms,
                            samples_per_s=b * 1e3 / ms,
                            validation_ms_per_frame=val_s * 1e3 / frames)
            echo = (f", echo_factor {out[key]['echo_factor']:.3f} "
                    f"({out[key]['transfers']} transfers)"
                    if "echo_factor" in out[key] else "")
            print(f"cli {what}, bf16 {b}x{AUG_SRC_HW[0]}x{AUG_SRC_HW[1]}"
                  f" -> {TRAIN_HW[0]}x{TRAIN_HW[1]}: the log's moving "
                  f"averages at step {int(last['steps'])}: total_time "
                  f"{ms:.0f} ms/step ({b * 1e3 / ms:.2f} samples/s), "
                  f"loading_time {load_ms:.0f} ms/step{echo}; "
                  f"validation {val_s * 1e3 / frames:.3f} ms/frame "
                  f"({len(sweeps)} sweeps, {frames} frames) ({smi})",
                  flush=True)

        # 4. --valid, f32, on the card and on the CPU (the deform
        # kernels' form on both: their plain pair on the CPU)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        valid = [c10, "--dataset_cfg", ds_10, "--root", root, "-c",
                 c_run, "--valid", "--compute_dtype", "float32",
                 "--resize", CLI_RESIZE]
        sintel_batches = 2 * math.ceil((CLI_SINTEL_FRAMES - 1) / b) + \
            2 * math.ceil(2 * (CLI_SINTEL_FRAMES - 1) / b)
        kitti_batches = 2 * math.ceil((CLI_KITTI_TRAIN - 1) / b)
        launches["valid"], calls, _, _, card_s = run_cli(
            valid, "--valid, the card",
            cli_want(0, {}, sintel_batches + kitti_batches, CASCADE_FWD))
        all_calls += calls
        val_log = os.path.join(root, "logs", "val", c_run + ".val.log")

        def val_values():
            with open(val_log) as fp:
                return [ln.split("] ", 1)[1].split(", ", 1)[1].strip()
                        .split("=") for ln in fp]

        card = val_values()
        with mock.patch.object(
                deform_module, "resolve_method",
                lambda method, device: "kernel" if method == "auto"
                else method):
            _, _, _, _, cpu_s = run_cli(valid + ["--device", "cpu"],
                                        "--valid, the CPU", {})
        cpu = val_values()[len(card):]
        require([k for k, _ in card] == [k for k, _ in cpu] and
                len(card) == 8, f"cli --valid logged {card} and {cpu}")
        worst = max(abs(float(a) - float(c)) / abs(float(c))
                    for (_, a), (_, c) in zip(card, cpu))
        print("cli --valid f32 at " + CLI_RESIZE + ", card vs CPU: " +
              ", ".join(f"{k} {a} vs {c}" for (k, a), (_, c) in
                        zip(card, cpu)) + f"; worst relative difference "
              f"{worst:.3e} (tol {CLI_VALID_RTOL}); card {card_s:.3f} "
              f"s, CPU {cpu_s:.3f} s", flush=True)
        require(worst <= CLI_VALID_RTOL, "cli --valid: card and CPU "
                "disagree")
        out["valid_worst_rel"] = worst

        # 5. --predict, and Trainer.predict on the same frames with the
        # same weights (cuDNN held to its deterministic algorithms:
        # its default transposed convs may sum in another order)
        torch.backends.cudnn.deterministic = True
        try:
            launches["predict"], calls, _, _, _ = run_cli(
                [c10, "--dataset_cfg", ds_10, "--root", root, "-c",
                 c_run, "--predict"], "--predict",
                cli_want(0, {}, 3, CASCADE_FWD))
            all_calls += calls
            trainer = Trainer(cli_module.build_settings(
                cli_module.parse_args([c10, "--dataset_cfg", ds_10]),
                load_config(c10), load_config(ds_10))[0], device="cuda")
            trainer.load(c_ck, load_states=False)
            flows_dir = os.path.join(root, "flows", os.path.basename(
                c_ck)[:-4])
            test = sintel.list_data()["test"]["final"]
            files = 0
            for (img1, _), (flow, _, _) in zip(test, trainer.predict(
                    [sintel.load(p) for p, _ in test],
                    [sintel.load(p) for _, p in test], batch_size=b,
                    resize=(448, 1024))):
                got = codecs.flo_load(os.path.join(
                    flows_dir, "final", os.path.basename(
                        os.path.dirname(img1)),
                    os.path.basename(img1)[:-4] + ".flo"))
                require(np.array_equal(got, flow[..., ::-1]),
                        f"cli --predict: {img1}'s .flo differs from "
                        f"Trainer.predict")
                files += 1
            testing = kitti.read_dataset_testing()
            for ed in ("2012", "2015"):
                flows = list(trainer.predict(
                    testing[ed]["image_0"], testing[ed]["image_1"],
                    batch_size=b, resize=(512, 1152)))
                names = sorted(os.listdir(os.path.join(
                    flows_dir, "kitti_" + ed)))
                require(names == ["%06d_10.png" % k
                                  for k in range(len(flows))] and flows,
                        f"cli --predict: KITTI {ed} wrote {names}")
                for k, (flow, _, _) in enumerate(flows):
                    require(np.array_equal(codecs.png16_load(
                        os.path.join(flows_dir, "kitti_" + ed,
                                     names[k])),
                        codecs.kitti_flow_encode(flow)),
                        f"cli --predict: KITTI {ed} {names[k]} differs "
                        f"from Trainer.predict")
                    files += 1
            del trainer
        finally:
            torch.backends.cudnn.deterministic = False
        require(files == CLI_SINTEL_TEST - 1 + 2 * (
            (2 * CLI_KITTI_TEST - 1) // 2), f"cli --predict: {files} "
            "files")
        print(f"cli --predict: {files} files (Sintel .flo, KITTI PNG16) "
              f"equal to Trainer.predict on the same frames", flush=True)
    check_uncovered(all_calls, gen, "cli")
    return launches, out, env


def gluon_params(network: str, rng) -> dict:
    """A Gluon checkpoint of ``network`` at the published widths: the keys
    Gluon 1.5's ``save_parameters`` writes (``.0.`` child indices; bare
    ``pred_*``, ``deform*`` and ``dc_conv7``; the cascade's head under
    ``MaskFlownet_S.``), MXNet's layouts (a deconv's (Cin, Cout, kh, kw)),
    weights at He scale and biases at 0.05 so that activations stay finite
    through the network (as ``tests/test_parity_oracle.py`` draws them)."""
    out = {}
    for key, shape in sorted(param_shapes(model=network).items()):
        scope, name = "", key
        if key.startswith(HEAD_SCOPE + "/"):
            scope, name = HEAD_SCOPE + ".", key[len(HEAD_SCOPE) + 1:]
        block, leaf = name.split("/")
        bare = block.startswith(("pred_", "deform")) or block == "dc_conv7"
        gluon_key = (scope + block + ("." if bare else ".0.")
                     + ("weight" if leaf == "w" else "bias"))
        if leaf == "b":
            arr = rng.randn(*shape) * 0.05
        else:
            cout, cin, kh, kw = shape               # the port's OIHW
            if block.startswith("upfeat"):
                shape = (cin, cout, kh, kw)
            arr = rng.randn(*shape) / np.sqrt(kh * kw * cin)
        out[gluon_key] = arr.astype(np.float32)
    return out


def run_tool(fn, what: str, want: dict):
    """``fn()`` with the launch counts zeroed just before and read just
    after, every correlation and deform launch recorded; requires
    ``want``'s counts. Returns (what ``fn`` returned, the counts, the
    recorded launches, seconds)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with record_launches() as calls:
        result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    require(launches == want, f"tools {what}: launched {launches}, not "
            f"{want}")
    print(f"tools {what}: {seconds:.3f} s; launches {launches}", flush=True)
    return result, launches, calls, seconds


def do_batch_ms(predictor, img1, img2) -> float:
    """Median wall time of TOOLS_REPS ``do_batch`` calls, each ended by a
    synchronize, after one warm-up call."""
    predictor.do_batch(img1, img2)
    times = []
    for _ in range(TOOLS_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.do_batch(img1, img2)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def frames_nchw(frames) -> torch.Tensor:
    """(H, W, 3) uint8 frames -> (B, 3, H, W) f32 in [0, 1] on the card."""
    return torch.from_numpy(np.stack(frames)).permute(0, 3, 1, 2).to(
        "cuda").float().div(255).contiguous()


def run_infer(argv, what: str, want: dict):
    """``infer.main(argv)`` through ``run_tool``; returns (the trainer its
    ``load_trainer`` built, seconds in ``load_trainer``, seconds in
    ``main``, the recorded launches)."""
    made = []
    real = infer_module.load_trainer

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        trainer = real(*args, **kwargs)
        made.append((trainer, time.perf_counter() - t0))
        return trainer

    with mock.patch.object(infer_module, "load_trainer", timed):
        rc, _, calls, seconds = run_tool(lambda: infer_module.main(argv),
                                         what, want)
    require(rc == 0 and len(made) == 1, f"tools {what}: main returned {rc}")
    return made[0][0], made[0][1], seconds, calls


def drive_tools(smi: str, gen, tmp: str, env: dict):
    """The published-checkpoint tools at the published widths: Gluon
    ``.params`` files of both networks through ``tools.import_mxnet``,
    ``tools.infer`` on a Sintel pair (each network) and on a directory of
    frames, ``tools.parity_eval`` on the cli phase's Sintel and KITTI trees
    under ``tmp`` (``env``). Returns (each tool run's launches, the phase's
    numbers)."""
    root = os.path.join(tmp, "tools")
    os.makedirs(root)
    rng = np.random.RandomState(TOOLS_SEED)
    out = {"import": {}, "bgr_rel": {}, "infer": {}}
    launches, all_calls, files = {}, [], {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    per_fwd = {"MaskFlownet_S": S_FWD, "MaskFlownet": CASCADE_FWD}

    # 1-2. the synthetic checkpoints, imported; the bgr import against the
    # rgb one
    for network in ("MaskFlownet_S", "MaskFlownet"):
        src = os.path.join(root, f"synthetic_{network}.params")
        npz = os.path.join(root, f"synthetic_{network}.npz")
        imx_module.write_mxnet_params(src, gluon_params(network, rng))
        t0 = time.perf_counter()
        imx_module.read_mxnet_params(src)
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = imx_module.import_checkpoint(src, network)
        import_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        imx_module.save_as_npz(params, npz)
        write_s = time.perf_counter() - t0
        os.remove(npz)
        t0 = time.perf_counter()
        rc = imx_module.main([src, npz, "--network", network])
        main_s = time.perf_counter() - t0
        back = interop.read_npz(npz, param_shapes(model=network))
        require(rc == 0 and back["step"] == 0 and back["mu"] is None
                and set(back["params"]) == set(params) and all(
                    torch.equal(back["params"][k], v)
                    for k, v in params.items()),
                f"tools import {network}: the .npz does not read back as "
                f"the in-memory import")
        nums = {"tensors": len(params),
                "parameters": sum(v.numel() for v in params.values()),
                "params_bytes": os.path.getsize(src),
                "npz_bytes": os.path.getsize(npz), "read_s": read_s,
                "convert_s": import_s - read_s, "write_s": write_s,
                "main_s": main_s}
        out["import"][network] = nums
        print(f"tools import {network}: {nums['tensors']} tensors, "
              f"{nums['parameters']} parameters; the .params file "
              f"({nums['params_bytes']} bytes) read in {read_s:.3f} s, "
              f"converted and checked in {import_s - read_s:.3f} s, the "
              f".npz ({nums['npz_bytes']} bytes) written in {write_s:.3f} "
              f"s; import_mxnet.main {main_s:.3f} s; the .npz read back "
              f"bitwise the in-memory import ({smi})", flush=True)

        bgr = imx_module.import_checkpoint(src, network,
                                           input_channel_order="bgr")
        h, w = TOOLS_SMALL_HW
        x1 = torch.rand((1, 3, h, w), generator=gen, device="cuda")
        x2 = torch.rand((1, 3, h, w), generator=gen, device="cuda")
        (rgb_out, bgr_out), _, calls, _ = run_tool(
            lambda: (Predictor(params, device="cuda", dtype=torch.float32,
                               model=network).do_batch(x1, x2),
                     Predictor(bgr, device="cuda", dtype=torch.float32,
                               model=network).do_batch(x1.flip(1),
                                                       x2.flip(1))),
            f"{network} bgr import vs rgb import, f32 {h}x{w}",
            cli_want(0, {}, 2, per_fwd[network]))
        all_calls += calls
        check_outputs(rgb_out, 1, (h, w), f"tools {network} rgb import")
        errs = [(a - b).abs().max().item() / max(1.0, a.abs().max().item())
                for a, b in zip(rgb_out, (bgr_out[0], bgr_out[1],
                                          bgr_out[2].flip(1)))]
        out["bgr_rel"][network] = max(errs)
        print(f"tools {network}: the bgr import on channel-reversed images "
              f"vs the rgb import, f32 at {h}x{w}: flow, occ, warped "
              f"relative {errs[0]:.3e}, {errs[1]:.3e}, {errs[2]:.3e} (tol "
              f"{BGR_REL}); |flow| max {rgb_out[0].abs().max().item():.3f} "
              f"px", flush=True)
        require(max(errs) <= BGR_REL, f"tools {network}: the bgr import "
                f"disagrees with the rgb import")
        files[network] = (src, npz)
        del params, bgr, back

    # 3. infer: -i with each checkpoint, --frames, --video without OpenCV
    sintel_root = env["MFN_SINTEL_ROOT"]
    pair = [os.path.join(sintel_root, "training", "clean", "alley_1",
                         f"frame_{i:04d}.png") for i in (1, 2)]
    img1, img2 = (codecs.image_load(p) for p in pair)
    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir)
    names = [f"frame_{k:02d}.png" for k in range(TOOLS_FRAMES)]
    for name in names:
        codecs.png8_save(rng.randint(0, 256, sintel.SHAPE + (3,),
                                     dtype=np.uint8),
                         os.path.join(frames_dir, name))
    frames = [codecs.image_load(os.path.join(frames_dir, n)) for n in names]
    torch.backends.cudnn.deterministic = True
    try:
        for network, config in (("MaskFlownet_S", "MaskFlownet_S.yaml"),
                                ("MaskFlownet", "MaskFlownet.yaml")):
            key = f"i_{network}"
            out_dir = os.path.join(root, key)
            trainer, load_s, seconds, calls = run_infer(
                [config, "-c", files[network][1], "-i", *pair, "-o",
                 out_dir], f"infer -i {network} (bf16, 436x1024)",
                per_fwd[network])
            launches[key] = per_fwd[network]
            all_calls += calls
            flow, _, warped = next(trainer.predict([img1], [img2],
                                                   batch_size=1))
            require(np.array_equal(codecs.flo_load(os.path.join(
                out_dir, "flow.flo")), flow[..., ::-1]),
                f"tools infer -i {network}: flow.flo is not Trainer.predict's")
            require(np.array_equal(codecs.image_load(os.path.join(
                out_dir, "flow.png")), flow_to_color(flow)) and
                np.array_equal(codecs.image_load(os.path.join(
                    out_dir, "warped.png")), (np.clip(warped, 0, 1) * 255)
                    .astype(np.uint8)),
                f"tools infer -i {network}: a PNG differs")
            ms = do_batch_ms(trainer.predictor(), frames_nchw([img1]),
                             frames_nchw([img2]))
            out["infer"][key] = {
                "seconds": seconds, "load_trainer_s": load_s, "frames": 1,
                "ms_per_frame": (seconds - load_s) * 1e3,
                "do_batch_ms_per_frame": ms}
            del trainer

        forwards = math.ceil((TOOLS_FRAMES - 1) / TOOLS_BATCH)
        out_dir = os.path.join(root, "frames_out")
        trainer, load_s, seconds, calls = run_infer(
            ["MaskFlownet_S.yaml", "-c", files["MaskFlownet_S"][1],
             "--frames", frames_dir, "--batch", str(TOOLS_BATCH), "-o",
             out_dir], f"infer --frames MaskFlownet_S ({TOOLS_FRAMES} "
            f"frames, bf16, 436x1024)", cli_want(0, {}, forwards, S_FWD))
        launches["frames"] = cli_want(0, {}, forwards, S_FWD)
        all_calls += calls
        flows = [f for f, _, _ in trainer.predict(
            frames[:-1], frames[1:], batch_size=TOOLS_BATCH)]
        require(sorted(os.listdir(out_dir)) == [n[:-4] + "_flow.png"
                                                for n in names[:-1]]
                and all(np.array_equal(codecs.image_load(os.path.join(
                    out_dir, n[:-4] + "_flow.png")), flow_to_color(f))
                    for n, f in zip(names, flows)),
                "tools infer --frames: the PNGs are not Trainer.predict's")
        ms = do_batch_ms(trainer.predictor(), frames_nchw(frames[:-1]),
                         frames_nchw(frames[1:]))
        out["infer"]["frames"] = {
            "seconds": seconds, "load_trainer_s": load_s,
            "frames": TOOLS_FRAMES - 1,
            "ms_per_frame": (seconds - load_s) * 1e3 / (TOOLS_FRAMES - 1),
            "do_batch_ms_per_frame": ms / (TOOLS_FRAMES - 1)}
        del trainer
    finally:
        torch.backends.cudnn.deterministic = False
    for key, nums in out["infer"].items():
        print(f"tools infer {key}: main {nums['seconds']:.3f} s, of it "
              f"load_trainer {nums['load_trainer_s']:.3f} s; the rest "
              f"(read, predict, write) {nums['ms_per_frame']:.3f} ms/frame "
              f"over {nums['frames']} frames; Predictor.do_batch "
              f"{nums['do_batch_ms_per_frame']:.3f} ms/frame at the same "
              f"model, batch and shape ({smi})", flush=True)
    with mock.patch.dict(sys.modules, {"cv2": None}):
        try:
            run_tool(lambda: infer_module.main(
                ["MaskFlownet_S.yaml", "-c", files["MaskFlownet_S"][1],
                 "--video", "in.mp4", "out.mp4", "-o", root]),
                "infer --video without OpenCV", {})
            require(False, "tools infer --video ran without OpenCV")
        except ImportError as e:
            require("--frames" in str(e), f"tools infer --video: {e}")
            print(f"tools infer --video without OpenCV: ImportError, no "
                  f"launch: {e}", flush=True)

    # 4. parity_eval on the cli phase's trees
    src = files["MaskFlownet_S"][0]
    trees = {"sintel_root": sintel_root,
             "sintel_split": env["MFN_SINTEL_SPLIT"],
             "kitti_root": env["MFN_KITTI_ROOT"]}
    absent = os.path.join(root, "absent")
    pairs, kitti_pairs = CLI_SINTEL_FRAMES - 1, CLI_KITTI_TRAIN - 1
    row_frames = {"sintel.trainval": 2 * 2 * pairs, "sintel.val": 2 * pairs,
                  "kitti.2012": kitti_pairs, "kitti.2015": kitti_pairs}
    forwards = (2 * math.ceil(2 * pairs / 4) + 2 * math.ceil(pairs / 4)
                + 2 * math.ceil(kitti_pairs / 4))
    row_s = {}
    real_sintel = parity_module.eval_sintel
    real_kitti = parity_module.eval_kitti

    def timed_sintel(trainer, division, *args, **kwargs):
        t0 = time.perf_counter()
        got = real_sintel(trainer, division, *args, **kwargs)
        row_s["sintel.val" if division == "training2"
              else "sintel.trainval"] = time.perf_counter() - t0
        return got

    def timed_kitti(trainer, edition, *args, **kwargs):
        t0 = time.perf_counter()
        got = real_kitti(trainer, edition, *args, **kwargs)
        row_s[f"kitti.{edition}"] = time.perf_counter() - t0
        return got

    sintel.load.cache_clear()           # the rows read their frames
    with mock.patch.object(parity_module, "eval_sintel", timed_sintel), \
            mock.patch.object(parity_module, "eval_kitti", timed_kitti):
        summary, _, calls, seconds = run_tool(
            lambda: parity_module.run(src, batch_size=4, **trees),
            "parity_eval MaskFlownet_S .params (f32, Sintel 436x1024, "
            "KITTI 1224x370)", cli_want(0, {}, forwards, S_FWD))
    launches["parity_eval"] = cli_want(0, {}, forwards, S_FWD)
    all_calls += calls
    require(summary["status"] == "computed" and not summary["skipped"]
            and len(summary["results"]) == 8 and all(
                math.isfinite(v) for v in summary["results"].values()),
            f"tools parity_eval: {summary}")
    out["parity_eval"] = {
        "seconds": seconds, "results": summary["results"],
        "ms_per_frame": {r: row_s[r] * 1e3 / n
                         for r, n in row_frames.items()},
        "frames": row_frames}
    print("tools parity_eval rows, f32, ms per frame (the frames read, "
          "resized and evaluated): " + ", ".join(
              f"{r} {v:.3f} ({row_frames[r]} frames)" for r, v in
              out["parity_eval"]["ms_per_frame"].items()) + f" ({smi})",
          flush=True)

    summary, _, calls, _ = run_tool(
        lambda: parity_module.run(
            src, batch_size=1, samples=1, sintel_root=sintel_root,
            sintel_split=trees["sintel_split"], kitti_root=absent,
            rows=("sintel.val", "kitti.2012", "kitti.2015")),
        "parity_eval with the KITTI root absent", cli_want(0, {}, 2, S_FWD))
    launches["parity_eval_absent"] = cli_want(0, {}, 2, S_FWD)
    all_calls += calls
    require(summary["skipped"] == ["kitti.2012", "kitti.2015"] and
            summary["status"] == "computed" and set(summary["results"]) ==
            {"sintel.val.clean", "sintel.val.final"},
            f"tools parity_eval, KITTI absent: {summary}")
    rc, _, _, _ = run_tool(lambda: parity_module.main(
        [src, "--expect", "none", "--sintel_root", absent, "--sintel_split",
         absent + ".txt", "--kitti_root", absent]),
        "parity_eval with nothing mounted", {})
    require(rc == 2, f"tools parity_eval with nothing mounted returned {rc}")
    print("tools parity_eval: an absent root SKIPPED, nothing mounted "
          "'no-data' and exit code 2", flush=True)

    # card vs CPU, f32, the deform kernels' form on both (their plain pair
    # on the CPU)
    cut = dict(batch_size=1, samples=1, kitti_resize=PARITY_KITTI_CUT,
               **trees)
    card, _, calls, card_s = run_tool(
        lambda: parity_module.run(src, **cut),
        "parity_eval f32 one pair a row, the card", cli_want(0, {}, 6, S_FWD))
    launches["parity_eval_cut"] = cli_want(0, {}, 6, S_FWD)
    all_calls += calls
    t0 = time.perf_counter()
    with mock.patch.object(deform_module, "resolve_method",
                           lambda method, device: "kernel"
                           if method == "auto" else method):
        cpu = parity_module.run(src, device="cpu", **cut)
    cpu_s = time.perf_counter() - t0
    keys = sorted(card["results"])
    require(keys == sorted(cpu["results"]) and len(keys) == 8,
            f"tools parity_eval card vs CPU: {keys}, {sorted(cpu['results'])}")
    worst = max(abs(card["results"][k] - cpu["results"][k])
                / abs(cpu["results"][k]) for k in keys)
    out["parity_eval"].update(card_vs_cpu_worst_rel=worst, card_s=card_s,
                              cpu_s=cpu_s)
    print("tools parity_eval f32, card vs CPU (one pair a row, KITTI at "
          f"{PARITY_KITTI_CUT[0]}x{PARITY_KITTI_CUT[1]}): " + ", ".join(
              f"{k} {card['results'][k]} vs {cpu['results'][k]}"
              for k in keys) + f"; worst relative difference {worst:.3e} "
          f"(tol {PARITY_RTOL}); card {card_s:.3f} s, CPU {cpu_s:.3f} s",
          flush=True)
    require(worst <= PARITY_RTOL, "tools parity_eval: card and CPU disagree")
    shutil.rmtree(root)
    check_uncovered(all_calls, gen, "tools")
    return launches, out


# ---------------------------------------------------------------------------
# phase 12, parallel: data parallelism over processes and the H-sharded
# forward, each rank a process of its own (``--parallel-worker``)
# ---------------------------------------------------------------------------

# the command that starts a rank: this script with ``--parallel-worker``
WORKER_CMD = [sys.executable, os.path.abspath(__file__)]
PAR_WORLD, PAR_TIMEOUT_S = 2, 300
# the f32 equivalence: PAR_WORLD ranks of one sample against one process of
# PAR_DP_BATCH, the augmented chairs step (384x512 -> 320x448), the first
# step's loss, epe and gradients, then the parameters after PAR_DP_STEPS
# steps, each parameter tensor's difference within PAR_UPDATE_RTOL of the
# norm of its update (Adam divides each element by its gradient's scale,
# so an element whose gradient is near zero takes the gradient's rounding
# whole)
PAR_DP_BATCH, PAR_DP_STEPS, PAR_UPDATE_RTOL = 2, 3, 5e-2
# the CLI as PAR_WORLD processes: the stock chairs config (global batch 8)
# for PAR_CLI_STEPS steps through a device cache of CLI_SLOTS slots
PAR_CLI_STEPS = 10
# one data-parallel step of the frozen-head cascade: one sample a rank at
# the cascade step's 320x768, bf16
# the H-sharded forward: Sintel at twice its working size, batch 1, over
# PAR_WORLD spatial ranks on the card, SPATIAL_REPS timed forwards; f32
# within SPATIAL_F32_TOL_PX of the whole forward; bf16 rounds at other
# places in the two (the halo tiles' sums, the all-reduced mean colour),
# about 2^-8 relative a layer over some 60 layers as a random walk
# (~3e-2): the mean |diff| within SPATIAL_BF16_REL of the mean |flow|
SPATIAL_HW, SPATIAL_REPS = (896, 2048), 5
SPATIAL_F32_TOL_PX, SPATIAL_BF16_REL = 1e-3, 5e-2
# timed steps of the one-rank NCCL step and of the same step without a
# group, in turns
NCCL_STEPS = 10
DTYPES = {str(d): d for d in (torch.float32, torch.bfloat16, torch.float16)}


def par_settings(dtype: str) -> TrainSettings:
    """The augmented chairs S step (384x512 sources, 320x448 crops)."""
    return TrainSettings(compute_dtype=dtype,
                         color=presets.color_aug_config("chairs"),
                         geo=presets.geometry_aug_config(
                             "chairs", TRAIN_HW, AUG_SRC_HW))


def keys_out(calls) -> list:
    """Recorded launch keys as JSON."""
    return [[k[0], list(k[1]), k[2], str(k[3])] + [list(x) for x in k[4:]]
            for k in calls]


def keys_in(rows) -> list:
    return [(r[0], tuple(r[1]), r[2], DTYPES[r[3]])
            + tuple(tuple(x) for x in r[4:]) for r in rows]


def tensor_digest(tensors) -> str:
    """A digest of the bytes of ``tensors`` (a dict), for replicas."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].detach().float().cpu().contiguous()
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def rank_branches(values, rank: int, world: int, b: int):
    """Rank ``rank``'s part of a global batch of ``b``'s branch values
    (``grad_parity.branches``): a pair pass's value (the pyramids', 2b
    rows: image 1's batch, then image 2's) keeps the rank's rows of each
    half, the others its rows."""
    per = b // world
    mine = list(range(rank * per, (rank + 1) * per))

    def part(t):
        if t.shape[0] == 2 * b:
            return t[mine + [b + i for i in mine]]
        require(t.shape[0] == b, f"branch value of batch {t.shape[0]}")
        return t[mine]

    return {"coords": [tuple(part(a) for a in p) for p in values["coords"]],
            "leaky": [part(t) for t in values["leaky"]],
            "corr": [part(t) for t in values["corr"]]}


def merge_branches(parts):
    """The global batch's branch values from each rank's, in rank order
    (the inverse of :func:`rank_branches`)."""
    per = parts[0]["corr"][0].shape[0]

    def merge(ts):
        if ts[0].shape[0] == 2 * per:
            return torch.cat([t[:per] for t in ts] + [t[per:] for t in ts])
        return torch.cat(ts)

    return {"coords": [tuple(merge([p["coords"][i][j] for p in parts])
                             for j in range(2))
                       for i in range(len(parts[0]["coords"]))],
            "leaky": [merge([p["leaky"][i] for p in parts])
                      for i in range(len(parts[0]["leaky"]))],
            "corr": [merge([p["corr"][i] for p in parts])
                     for i in range(len(parts[0]["corr"]))]}


def dp_step(trainer, batch, replay, draws):
    """``step_grads`` of a data-parallel rank: the step's loss and
    gradients after the all-reduce (the global batch's), and the rank's
    branch values."""
    seen, patches = grad_parity.branches("cuda", replay)
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        loss, epe = trainer.loss(*batch, draws=draws)
        loss.backward()
    loss, _ = trainer.reduce_gradients(loss.detach(), epe)
    grads = {k: p.grad.detach().cpu() for k, p in trainer.params.items()
             if p.grad is not None}
    trainer.opt.zero_grad(set_to_none=True)
    return loss.item(), grads, seen


def whole_forward(model, params, im1, im2, dtype):
    """The forward ``make_spatial_forward`` shards, whole: centralize, the
    model (the deformable convs in their ``warpconv`` form, as the
    sharded forward takes them), the 4x upsampled flow and first visual."""
    a, b = centralize(im1, im2)
    preds, occs, _ = build_model(model)(apply_ctx(params, dtype), a, b,
                                        WARP_CFG)
    return upsample(preds[-1], 4), upsample(occs[0].float(), 4)


def spatial_images():
    """The sharded forward's pair: seeded noise at SPATIAL_HW in [0, 1]."""
    g = torch.Generator().manual_seed(12)
    return [torch.rand((1, 3) + SPATIAL_HW, generator=g) for _ in range(2)]


def timed_forwards(fn, reps: int):
    """ms a call of ``fn`` over ``reps`` calls after one warm-up, ended by
    synchronize, with the peak memory above what was allocated before."""
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    return out, ms, (torch.cuda.max_memory_allocated() - base) / 2**30


def worker_gloo(rank: int, world: int, out: str) -> dict:
    """A gloo rank on the card: the f32 equivalence (as it runs, on the
    one-process step's branches, PAR_DP_STEPS steps), the frozen-head
    cascade step, the S gradients' all-reduce time, the H-sharded
    forwards. Tensors for the parent go to ``out``/gloo<r>.pt."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh("cuda")
    res, tensors = {"device": str(mesh.device)}, {}
    inp = torch.load(os.path.join(out, "dp_in.pt"))
    local = batch_sharding(mesh, PAR_DP_BATCH)
    batch = [t[local].cuda() for t in inp["batch"]]
    params = init_params(0)
    settings = par_settings("float32")
    with record_launches() as calls:
        asrun = dp_step(Trainer(settings, params=params, mesh=mesh), batch,
                        None, inp["draws"][0])
        replay = dp_step(Trainer(settings, params=params, mesh=mesh), batch,
                         rank_branches(inp["replay"], mesh.rank, world,
                                       PAR_DP_BATCH), inp["draws"][0])
        trainer = Trainer(settings, params=params, mesh=mesh)
        metrics = [trainer.train_batch(*batch, lr=TRAIN_LR, sync=True,
                                       draws=d) for d in inp["draws"]]
    res["dp"] = {"losses": [asrun[0], replay[0]], "metrics": metrics,
                 "grad_digest": tensor_digest(asrun[1]),
                 "param_digest": tensor_digest(trainer.params)}
    tensors["seen"] = asrun[2]
    if mesh.rank == 0:
        tensors.update(asrun_grads=asrun[1], replay_grads=replay[1],
                       params={k: v.detach().cpu()
                               for k, v in trainer.params.items()})
    del asrun, replay, trainer

    # the all-reduce of the S step's gradients: one flat f32 buffer of
    # every parameter, over gloo through the host
    grads = [torch.ones(s, device=mesh.device)
             for s in param_shapes().values()]
    torch.cuda.synchronize()
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        all_reduce_mean(mesh, grads)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res["allreduce_ms"] = statistics.median(times[1:])
    res["allreduce_bytes"] = 4 * sum(g.numel() for g in grads)
    del grads

    # one data-parallel step of the frozen-head cascade, bf16, 1 a rank
    cgen = torch.Generator(device="cuda").manual_seed(3)
    cbatch = [t[local] for t in shifted_batch(cgen, PAR_DP_BATCH,
                                              CASCADE_TRAIN_HW)]
    start = init_params(0, model="MaskFlownet")
    trainer = Trainer(TrainSettings(model="MaskFlownet", fix_head=True),
                      params=start, mesh=mesh)
    with record_launches() as ccalls:
        trainer.train_batch(*cbatch, lr=TRAIN_LR, sync=True)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    m = trainer.train_batch(*cbatch, lr=TRAIN_LR, sync=True)
    torch.cuda.synchronize()
    head = [k for k in start if k.startswith(HEAD_SCOPE + "/")]
    res["cascade"] = {
        "launches": {k: v for k, v in launch_counts().items() if v},
        "finite": all(map(math.isfinite, m.values())),
        "head_unchanged": all(torch.equal(trainer.params[k].detach().cpu(),
                                          start[k]) for k in head),
        "rest_moved": sum(not torch.equal(trainer.params[k].detach().cpu(),
                                          start[k])
                          for k in start if k not in head),
        "rest": len(start) - len(head), "head": len(head),
        "digest": tensor_digest(trainer.params)}
    del trainer

    # the H-sharded forwards, f32 and bf16, of both models
    smesh = make_spatial_mesh(1, world, "cuda")
    rows = smesh.rows
    hl = SPATIAL_HW[0] // world
    im1, im2 = (t[:, :, rows.index * hl:(rows.index + 1) * hl].contiguous()
                .cuda() for t in spatial_images())
    res["spatial"] = {}
    scalls = []
    for model in ("MaskFlownet_S", "MaskFlownet"):
        for dtype in (torch.float32, torch.bfloat16):
            p = {k: v.to(mesh.device, dtype) for k, v in
                 init_params(0, model=model).items()}
            fwd = make_spatial_forward(build_model(model), ModelConfig(),
                                       smesh, dtype)
            with torch.no_grad():
                with record_launches() as warm:
                    fwd(p, im1, im2)
                scalls += warm
                torch.cuda.synchronize()
                reset_counts()
                fwd(p, im1, im2)
                torch.cuda.synchronize()
                launched = {k: v for k, v in launch_counts().items() if v}
                (flow, occ), ms, peak = timed_forwards(
                    lambda: fwd(p, im1, im2), SPATIAL_REPS)
            key = f"{model} {str(dtype).split('.')[1]}"
            res["spatial"][key] = {"launches": launched, "ms": ms,
                                   "peak_gib": peak}
            tensors[key] = (flow.cpu(), occ.cpu())
            del p, flow, occ
    res["calls"] = keys_out(calls + ccalls + scalls)
    torch.save(tensors, os.path.join(out, f"gloo{mesh.rank}.pt"))
    return res


def worker_cli(rank: int, world: int, out: str) -> dict:
    """A rank of ``python -m maskflownet_torch.cli.main`` (run as ``-m``
    runs it) with the argv in ``out``/cli_argv.json: its exit code, its
    launch counts and recorded launches, the host time between its steps
    that no validation falls in."""
    import runpy
    with open(os.path.join(out, "cli_argv.json")) as fp:
        argv = json.load(fp)
    stamps = []
    real = Trainer.train_batch_device

    def timed(self, batch, lr=1e-4):
        metrics = real(self, batch, lr)
        stamps.append(time.perf_counter())
        return metrics

    reset_counts()
    with mock.patch.object(Trainer, "train_batch_device", timed), \
            mock.patch.object(sys, "argv", ["-m"] + argv), \
            record_launches() as calls:
        try:
            runpy.run_module("maskflownet_torch.cli.main", run_name="__main__",
                             alter_sys=True)
            rc = 0
        except SystemExit as e:
            rc = e.code
    torch.cuda.synchronize()
    # the gaps before steps 3..PAR_CLI_STEPS: validation runs after
    # steps 1 and CLI_VAL_STEPS
    gaps = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    return {"rc": rc, "steps": len(stamps),
            "launches": {k: v for k, v in launch_counts().items() if v},
            "ms_per_step": statistics.median(gaps) if gaps else None,
            "calls": keys_out(calls)}


def worker_nccl(rank: int, world: int, out: str) -> dict:
    """A NCCL rank: the bf16 augmented S step (batch 8 a rank) with the
    all-reduce, in turns with the same step without a group: warm-up
    launches, whether a step synchronises with the host, ms/step of both,
    the all-reduce's time by CUDA events."""
    mesh = make_mesh("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = shifted_batch(gen, TRAIN_BATCH, AUG_SRC_HW)
    params = init_params(0)
    nccl = Trainer(par_settings("bfloat16"), params=params, mesh=mesh)
    alone = Trainer(par_settings("bfloat16"), params=params,
                    device=mesh.device)
    with record_launches() as calls:
        for t in (nccl, alone):
            for _ in range(3):
                t.train_batch(*batch, lr=TRAIN_LR, sync=True)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            nccl.train_batch(*batch, lr=TRAIN_LR)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    ms = {"nccl": [], "alone": []}
    launches = {}
    for name, t in (("alone", alone), ("nccl", nccl), ("nccl", nccl),
                    ("alone", alone)):
        step_ms, launched, _ = timed_steps(
            lambda t=t: t.train_batch(*batch, lr=TRAIN_LR), NCCL_STEPS)
        ms[name].append(step_ms)
        launches[name] = launched
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in nccl.params.values()]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    all_reduce_mean(mesh, grads)
    start.record()
    for _ in range(20):
        all_reduce_mean(mesh, grads)
    end.record()
    end.synchronize()
    return {"device": str(mesh.device), "syncs": syncs,
            "ms_per_step": {k: statistics.mean(v) for k, v in ms.items()},
            "launches": launches,
            "allreduce_ms": start.elapsed_time(end) / 20,
            "calls": keys_out(calls)}


WORKERS = {"gloo": worker_gloo, "cli": worker_cli, "nccl": worker_nccl}


def parallel_worker(task: str, rank: int, world: int, port: int,
                    out: str) -> int:
    """``--parallel-worker TASK RANK WORLD PORT OUT``: one rank of a phase
    12 task; writes its result to ``out``/<task><rank>.json."""
    backend = {"gloo": "gloo", "nccl": "nccl"}.get(task)
    if backend is not None:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://localhost:"
                                f"{port}", world_size=world, rank=rank)
    try:
        res = WORKERS[task](rank, world, out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out, f"{task}{rank}.json"), "w") as fp:
        json.dump(res, fp)
    return 0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(task: str, world: int, out: str, env=None) -> list[dict]:
    """Start ``world`` ranks of ``task``, wait for all of them (killing
    them all past PAR_TIMEOUT_S), require each to exit 0, return their
    results in rank order."""
    port = free_port()
    procs = []
    for rank in range(world):
        penv = {**os.environ, **(env or {})}
        if task == "cli":
            penv.update(MFN_COORDINATOR=f"localhost:{port}",
                        MFN_NUM_PROCESSES=str(world),
                        MFN_PROCESS_ID=str(rank), MFN_DIST_BACKEND="gloo")
        log = open(os.path.join(out, f"{task}{rank}.log"), "w")
        procs.append((subprocess.Popen(
            WORKER_CMD + ["--parallel-worker", task, str(rank), str(world),
                          str(port), out],
            stdout=log, stderr=subprocess.STDOUT, env=penv), log))
    t0 = time.perf_counter()
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, PAR_TIMEOUT_S - (time.perf_counter()
                                                     - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    results = []
    for rank, (p, _) in enumerate(procs):
        if p.returncode:
            with open(os.path.join(out, f"{task}{rank}.log")) as fp:
                print(fp.read()[-6000:], flush=True)
        require(p.returncode == 0, f"parallel {task} rank {rank} exited "
                f"{p.returncode}")
        with open(os.path.join(out, f"{task}{rank}.json")) as fp:
            results.append(json.load(fp))
    print(f"parallel {task}: {world} ranks exited 0 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return results


def drive_parallel(smi: str, gen, tmp: str, env: dict, one_process: dict):
    """Phase 12. ``tmp`` holds phase 10's trees (``env`` points the
    readers at them); ``one_process``: phase 10's S stage numbers. Returns
    (each rank's launches by run, the phase's numbers)."""
    out = os.path.join(tmp, "parallel")
    os.makedirs(out)
    numbers, launches, calls = {}, {}, []
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. the one-process side of the f32 equivalence, and its branches
    params = init_params(0)
    batch = shifted_batch(gen, PAR_DP_BATCH, AUG_SRC_HW)
    trainer = Trainer(par_settings("float32"), params=params)
    draws = [trainer.draw(PAR_DP_BATCH, AUG_SRC_HW)
             for _ in range(PAR_DP_STEPS)]
    cpu_draws = [tuple(None if d is None else {
        k: None if v is None else v.cpu() for k, v in d.items()}
        for d in dr) for dr in draws]
    one = step_grads(trainer, batch, draws=draws[0])
    trainer = Trainer(par_settings("float32"), params=params)
    one_metrics = [trainer.train_batch(*batch, lr=TRAIN_LR, sync=True,
                                       draws=d) for d in draws]
    one_params = {k: v.detach().cpu() for k, v in trainer.params.items()}
    del trainer
    torch.save({"batch": [t.cpu() for t in batch], "draws": cpu_draws,
                "replay": one[2]}, os.path.join(out, "dp_in.pt"))

    # the whole forwards the sharded ones are held against
    ims = [t.cuda() for t in spatial_images()]
    whole = {}
    for model in ("MaskFlownet_S", "MaskFlownet"):
        for dtype in (torch.float32, torch.bfloat16):
            p = {k: v.to("cuda", dtype) for k, v in
                 init_params(0, model=model).items()}
            with torch.no_grad():
                (flow, occ), ms, peak = timed_forwards(
                    lambda: whole_forward(model, p, *ims, dtype),
                    SPATIAL_REPS)
            whole[f"{model} {str(dtype).split('.')[1]}"] = (
                flow.cpu(), occ.cpu(), ms, peak)
            del p, flow, occ
    del ims
    torch.cuda.empty_cache()

    # 2. PAR_WORLD gloo ranks on the card
    ranks = run_ranks("gloo", PAR_WORLD, out)
    per = [torch.load(os.path.join(out, f"gloo{r}.pt"))
           for r in range(PAR_WORLD)]
    for r, res in enumerate(ranks):
        calls += keys_in(res["calls"])
        require(res["device"] == "cuda:0", f"gloo rank {r} on "
                f"{res['device']}")
    dps = [res["dp"] for res in ranks]
    require(all(d == dps[0] for d in dps[1:]), "the gloo ranks' losses, "
            f"metrics or digests differ: {dps}")
    want_asrun = (dps[0]["losses"][0], per[0]["asrun_grads"],
                  merge_branches([p["seen"] for p in per]))
    want_replay = (dps[0]["losses"][1], per[0]["replay_grads"], None)
    compare_on_branches(
        f"f32 {PAR_WORLD} gloo ranks x {PAR_DP_BATCH // PAR_WORLD} vs 1 "
        f"process x {PAR_DP_BATCH}, augmented {AUG_SRC_HW} -> {TRAIN_HW}",
        lambda replay: one,
        lambda replay: want_asrun if replay is None else want_replay)
    # the first step's metrics: the same parameters and draws, summed in
    # another order; the later steps' run on parameters that a branch on
    # the other side may have moved, held through the parameters below
    for k in ("loss", "epe"):
        a, b = dps[0]["metrics"][0][k], one_metrics[0][k]
        require(abs(a - b) <= LOSS_RTOL * abs(b), f"parallel step 1 {k}: "
                f"{a} vs {b}")
    start = init_params(0)
    upd = {k: ((per[0]["params"][k] - one_params[k]).norm()
               / (one_params[k] - start[k]).norm()).item()
           for k in start if (one_params[k] - start[k]).norm() > 0}
    name = max(upd, key=upd.get)
    total = (sum(((per[0]["params"][k] - one_params[k]) ** 2).sum()
                 for k in start) ** 0.5 / sum(
        ((one_params[k] - start[k]) ** 2).sum() for k in start) ** 0.5)
    print(f"parallel f32 equivalence: the {PAR_DP_STEPS} steps' losses "
          f"{[m['loss'] for m in dps[0]['metrics']]} vs "
          f"{[m['loss'] for m in one_metrics]}, epe "
          f"{[m['epe'] for m in dps[0]['metrics']]} vs "
          f"{[m['epe'] for m in one_metrics]}; parameters after "
          f"{PAR_DP_STEPS} steps: |diff|/|update| {total.item():.3e} over "
          f"all, worst tensor {upd[name]:.3e} ({name}; tol "
          f"{PAR_UPDATE_RTOL}); the {PAR_WORLD} replicas' gradients and "
          f"parameters bitwise equal", flush=True)
    require(upd[name] <= PAR_UPDATE_RTOL, "parallel: parameters after "
            f"{PAR_DP_STEPS} steps")
    numbers["dp_equivalence"] = {"params_rel": total.item(),
                                 "params_worst_rel": upd[name]}
    numbers["allreduce_gloo_ms"] = [r["allreduce_ms"] for r in ranks]
    print(f"parallel all-reduce of the S gradients ("
          f"{ranks[0]['allreduce_bytes'] / 2**20:.1f} MiB f32), gloo through "
          f"the host, {PAR_WORLD} ranks on one card: "
          f"{numbers['allreduce_gloo_ms']} ms ({smi})", flush=True)

    cascades = [r["cascade"] for r in ranks]
    for c in cascades:
        require(c["finite"] and c["head_unchanged"]
                and c["rest_moved"] == c["rest"] > 0,
                f"parallel cascade step: {c}")
        require(c["launches"] == CASCADE_STEP, f"parallel cascade step "
                f"launched {c['launches']}, not {CASCADE_STEP}")
    require(cascades[0]["digest"] == cascades[1]["digest"],
            "parallel cascade: the replicas differ")
    launches["cascade_step"] = cascades[0]["launches"]
    print(f"parallel frozen-head cascade, bf16, {PAR_WORLD} gloo ranks x 1 "
          f"at {CASCADE_TRAIN_HW}: the head's {cascades[0]['head']} "
          f"parameters bitwise unchanged, the other {cascades[0]['rest']} "
          f"moved, replicas equal; launches a rank "
          f"{cascades[0]['launches']}", flush=True)

    numbers["spatial"] = {}
    hl = SPATIAL_HW[0] // PAR_WORLD
    for key, (flow, occ, ms, peak) in whole.items():
        got_flow = torch.cat([p[key][0] for p in per], 2)
        got_occ = torch.cat([p[key][1] for p in per], 2)
        require(got_flow.shape == flow.shape and bool(
            torch.isfinite(got_flow).all()), f"spatial {key}: flow "
            f"{tuple(got_flow.shape)}")
        diff = (got_flow - flow).abs()
        occ_diff = (got_occ - occ).abs().max().item()
        rel = (diff.mean() / flow.abs().mean()).item()
        rows = [r["spatial"][key] for r in ranks]
        model = key.split()[0]
        want = {"corr_fwd": 15 if model == "MaskFlownet" else 5}
        for r in rows:
            require(r["launches"] == want, f"spatial {key} launched "
                    f"{r['launches']}, not {want}")
        numbers["spatial"][key] = {
            "max_abs_px": diff.max().item(), "mean_rel": rel,
            "occ_max_abs": occ_diff,
            "ms_per_frame_ranks": [r["ms"] for r in rows],
            "whole_ms_per_frame": ms,
            "peak_gib_ranks": [r["peak_gib"] for r in rows],
            "whole_peak_gib": peak}
        f32 = "float32" in key
        print(f"parallel spatial {key} at {SPATIAL_HW[0]}x{SPATIAL_HW[1]}, "
              f"batch 1, {PAR_WORLD} row ranks ({hl} rows each) over gloo "
              f"on one card vs whole: flow max |diff| "
              f"{diff.max().item():.3e} px, mean |diff| / mean |flow| "
              f"{rel:.3e} (tol "
              f"{'%g px max' % SPATIAL_F32_TOL_PX if f32 else '%g mean' % SPATIAL_BF16_REL}"
              f"), visual max |diff| {occ_diff:.3e}; ms/frame a rank "
              f"{[round(r['ms'], 3) for r in rows]} vs whole {ms:.3f}; peak "
              f"GiB a rank {[round(r['peak_gib'], 3) for r in rows]} vs "
              f"whole {peak:.3f}; launches a rank and forward "
              f"{rows[0]['launches']} ({smi})", flush=True)
        if f32:
            require(diff.max().item() <= SPATIAL_F32_TOL_PX,
                    f"spatial {key}: flow")
        else:
            require(rel <= SPATIAL_BF16_REL, f"spatial {key}: flow")
    launches["spatial"] = {k: r["launches"] for k, r in
                           ranks[0]["spatial"].items()}
    del per, whole

    # 3. the CLI as PAR_WORLD processes at the published widths
    b = presets.BATCH_SIZE["chairs"]
    s10 = cut_yaml("MaskFlownet_S.yaml", os.path.join(tmp, "par_s.yaml"),
                   PAR_CLI_STEPS)
    ds = cut_yaml("chairs.yaml", os.path.join(tmp, "par_chairs.yaml"),
                  validation_steps=CLI_VAL_STEPS,
                  checkpoint_steps=PAR_CLI_STEPS)
    root = os.path.join(tmp, "par_exp")
    with open(os.path.join(out, "cli_argv.json"), "w") as fp:
        json.dump([s10, "--dataset_cfg", ds, "--root", root,
                   "--device_cache", str(CLI_SLOTS)], fp)
    val_forwards = 1 + 2 * math.ceil((CLI_SINTEL_FRAMES - 1) / b)
    want = cli_want(PAR_CLI_STEPS, {**S_STEP, "affine_sample": 2},
                    (1 + PAR_CLI_STEPS // CLI_VAL_STEPS) * val_forwards,
                    S_FWD)
    clis = run_ranks("cli", PAR_WORLD, out, env)
    for r, res in enumerate(clis):
        calls += keys_in(res["calls"])
        require(res["rc"] == 0 and res["steps"] == PAR_CLI_STEPS,
                f"cli rank {r}: {res['rc']}, {res['steps']} steps")
        require(res["launches"] == want, f"cli rank {r} launched "
                f"{res['launches']}, not {want}")
    logs = [f[:-4] for f in os.listdir(os.path.join(root, "logs"))
            if f.endswith(".log")]
    require(len(logs) == 1, f"cli: {PAR_WORLD} processes wrote the logs "
            f"{logs}")
    train_log(root, logs[0], PAR_CLI_STEPS, "parallel S stage")
    checkpoint_of(root, logs[0], PAR_CLI_STEPS, "MaskFlownet_S")
    require(len(os.listdir(os.path.join(root, "weights"))) == 1,
            "cli: more than one checkpoint written")
    with open(os.path.join(root, "logs", logs[0] + ".log")) as fp:
        require(f"batch={b}, devices={PAR_WORLD}" in fp.read(),
                "cli: the log does not name the global batch and the "
                "processes")
    launches["cli"] = clis[0]["launches"]
    numbers["cli"] = {"ms_per_step_ranks": [r["ms_per_step"] for r in clis],
                      "one_process_ms_per_step":
                          one_process["s"]["ms_per_step"]}
    print(f"parallel cli: python -m maskflownet_torch.cli.main as "
          f"{PAR_WORLD} gloo processes on one card, the stock chairs config "
          f"(global batch {b}, {b // PAR_WORLD} a rank, bf16, a device cache "
          f"of {CLI_SLOTS}), {PAR_CLI_STEPS} steps: rank 0 alone wrote the "
          f"log and the step-{PAR_CLI_STEPS} checkpoint, which reads back; "
          f"launches a rank {want}; ms/step a rank (median host time of "
          f"steps 3..{PAR_CLI_STEPS}) "
          f"{[round(r['ms_per_step'], 1) for r in clis]} vs one process "
          f"{one_process['s']['ms_per_step']:.1f} (phase 10, the log's "
          f"average at step {CLI_S_STEPS}) ({smi})", flush=True)

    # 4. NCCL: one rank on the card; across cards only where there are two
    for world, what in ((1, "one rank"), (2, "across cards")):
        if world > torch.cuda.device_count():
            print(f"parallel NCCL {what}: not run ("
                  f"{torch.cuda.device_count()} card)", flush=True)
            continue
        res = run_ranks("nccl", world, out)
        for r in res:
            calls += keys_in(r["calls"])
            require(not r["syncs"], f"NCCL {what}: the step synchronises "
                    f"with the host: {r['syncs']}")
            per_step = {**S_STEP, "affine_sample": 2}
            for name in ("nccl", "alone"):
                require(r["launches"][name] == {
                    k: v * NCCL_STEPS for k, v in per_step.items()},
                    f"NCCL {what} {name}: launched {r['launches'][name]}")
        numbers[f"nccl_{world}"] = {
            "ms_per_step": [r["ms_per_step"] for r in res],
            "allreduce_ms": [r["allreduce_ms"] for r in res]}
        launches[f"nccl_{world}"] = res[0]["launches"]["nccl"]
        print(f"parallel NCCL {what}: the bf16 augmented S step, batch "
              f"{TRAIN_BATCH} a rank, {AUG_SRC_HW} -> {TRAIN_HW}: no "
              f"synchronisation with the host; ms/step with the all-reduce "
              f"{[round(r['ms_per_step']['nccl'], 3) for r in res]}, the "
              f"same step without a group "
              f"{[round(r['ms_per_step']['alone'], 3) for r in res]} (in "
              f"turns); the all-reduce of the S gradients "
              f"{[round(r['allreduce_ms'], 3) for r in res]} ms by CUDA "
              f"events ({smi})", flush=True)
    check_uncovered(calls, gen, "parallel")
    return launches, numbers



# ---------------------------------------------------------------------------
# phase 13: the native host runtime
# ---------------------------------------------------------------------------

# the unfilter at a Sintel frame (8-bit RGB, stride 3072) and a KITTI flow
# PNG (16-bit RGB, stride 7344), and at NATIVE_SMALL (rows, pixels) for the
# other byte widths a pixel, each with every filter alone and all five in
# turn; timings the median of NATIVE_REPS calls (the plain unfilter's and
# the loads through it of NATIVE_PLAIN_REPS)
NATIVE_FRAMES = (("Sintel 8-bit RGB", (436, 1024), 3),
                 ("KITTI 16-bit RGB", (370, 1224), 6))
NATIVE_BPPS, NATIVE_SMALL = (1, 2, 4, 8), (64, 96)
NATIVE_FILTERS = ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4))
NATIVE_REPS, NATIVE_PLAIN_REPS, NATIVE_SEED = 20, 3, 12


def host_median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def plain_unfilter(body, filters, bpp) -> None:
    """``native.png_unfilter``'s arguments, unfiltered by the plain numpy
    version into ``body``."""
    body[...] = codecs._unfilter(body, np.asarray(filters), bpp)


def drive_native(smi: str, tmp: str, tools_infer: dict) -> dict:
    """The port's C++ host runtime: a fresh ``g++`` build on this host,
    ``png_unfilter`` bitwise against ``codecs._unfilter``, the unfilter's
    and the loads' times, plain and native, and ``infer -i``'s ms/frame from phase 11 (which decoded and
    encoded through it). Returns the phase's numbers."""
    root = os.path.join(tmp, "native")
    so = native.build(build_dir=Path(root) / "build")
    out = {"gxx_s": native.build_seconds}
    print(f"native: g++ {' '.join(native.CXX_FLAGS)} png_filters.cpp on "
          f"this host: {native.build_seconds:.3f} s ({so.name})", flush=True)
    rng = np.random.RandomState(NATIVE_SEED)

    # png_unfilter and the plain unfilter, bitwise
    cases = list(NATIVE_FRAMES) + [(f"{bpp} bytes a pixel", NATIVE_SMALL,
                                    bpp) for bpp in NATIVE_BPPS]
    for name, (h, w), bpp in cases:
        body = rng.randint(0, 256, (h, w * bpp), dtype=np.uint8)
        for filters in NATIVE_FILTERS:
            ft, rows = filter_rows(body, bpp, filters)
            got = rows.copy()
            native.png_unfilter(got, ft, bpp)
            require(np.array_equal(got, body) and np.array_equal(
                codecs._unfilter(rows, ft, bpp), body),
                f"native: unfilter of {name}, filters {filters}")
    try:
        native.png_unfilter(np.zeros((2, 6), np.uint8),
                            np.array([1, 5], np.uint8), 3)
        refused = False
    except ValueError as err:
        refused = "unknown PNG filter 5" in str(err)
    require(refused, "native: filter 5 was not refused")
    print(f"native: png_unfilter bitwise codecs._unfilter at "
          f"{len(cases)} shapes x {len(NATIVE_FILTERS)} filter sets "
          f"(bpp {sorted({c[2] for c in cases})}); filter 5 refused",
          flush=True)

    # the unfilter and the loads, plain and native
    for name, (h, w), bpp in NATIVE_FRAMES:
        ft, rows = filter_rows(rng.randint(0, 256, (h, w * bpp),
                                           dtype=np.uint8), bpp)
        copies = [rows.copy() for _ in range(NATIVE_REPS)]
        native_ms = host_median_ms(
            lambda: native.png_unfilter(copies.pop(), ft, bpp), NATIVE_REPS)
        plain_ms = host_median_ms(lambda: codecs._unfilter(rows, ft, bpp),
                                  NATIVE_PLAIN_REPS)
        depth = 8 if bpp == 3 else 16
        path = os.path.join(root, f"frame{depth}.png")
        png_file(path, ft, rows, w, depth, 2)
        load = codecs.image_load if depth == 8 else codecs.png16_load
        got = load(path)
        load_ms = host_median_ms(lambda: load(path), NATIVE_REPS)
        with mock.patch.object(codecs.native, "png_unfilter",
                               plain_unfilter):
            require(np.array_equal(load(path), got), f"native: {name} "
                    "loads differently through the plain unfilter")
            load_plain_ms = host_median_ms(lambda: load(path),
                                           NATIVE_PLAIN_REPS)
        out[name] = {"unfilter_ms": native_ms, "unfilter_plain_ms": plain_ms,
                     "load_ms": load_ms, "load_plain_ms": load_plain_ms,
                     "file_bytes": os.path.getsize(path)}
        print(f"native {name} {h}x{w}: unfilter {native_ms:.3f} ms/frame "
              f"native vs {plain_ms:.3f} plain ({plain_ms / native_ms:.1f}x); "
              f"{load.__name__} {load_ms:.3f} ms/frame vs {load_plain_ms:.3f} "
              f"through the plain unfilter ({os.path.getsize(path)} bytes; "
              f"{smi})", flush=True)

    # infer -i as phase 11 ran it, through the native codec
    for key in ("i_MaskFlownet_S", "i_MaskFlownet"):
        nums = tools_infer[key]
        out[key] = {"ms_per_frame": nums["ms_per_frame"],
                    "do_batch_ms_per_frame": nums["do_batch_ms_per_frame"]}
        print(f"native: infer -i {key[2:]} (phase tools, 436x1024, bf16): "
              f"{nums['ms_per_frame']:.3f} ms/frame past load_trainer, "
              f"do_batch {nums['do_batch_ms_per_frame']:.3f} ms/frame "
              f"({smi})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: the two-pass sampler of geometric augmentation
# ---------------------------------------------------------------------------

# twopass card vs CPU in f32 within TWOPASS_REL (max |diff| over max |CPU|:
# summation orders only), and as the step samples (bf16 images, f16 labels)
# within four ulps of values in [0.5, 1) on the images and the mask (each
# device computes the pixel maps, whose sin and cos differ in their last
# bits, and a half-precision rounding of either pass's products or sums may
# then land an ulp apart) and the JAX package's label bound on the flow
# (``tests/test_augment.py:338-380``: max 1 px and median 0.15 px at ~300
# px flow, where both masks exceed 0.999, borders left out); twopass
# against the exact sampler: f32 labels within that test's 0.35 px, f16
# labels recorded (at the chairs shapes the f16 roundings, an ulp of 0.25
# at 300 px, magnified by the inverse zoom, up to 2, may pass 1 px, as
# they do in the JAX function); bf16 times in alternating windows of
# TWOPASS_STEPS steps, TWOPASS_PAIRS pairs
TWOPASS_REL, TWOPASS_PAIRS, TWOPASS_STEPS = 1e-5, 3, 10
TWOPASS_F16_MAX, TWOPASS_F16_MEDIAN, TWOPASS_F32_MAX = 1.0, 0.15, 0.35


def alternating_ms(steps: dict, per_step: dict, what: str) -> dict:
    """ms/step of each of ``steps`` (name -> one step), windows of
    TWOPASS_STEPS steps taken in turn TWOPASS_PAIRS times, the median
    window; each window's launches exactly ``per_step[name]`` a step."""
    times = {name: [] for name in steps}
    for _ in range(TWOPASS_PAIRS):
        for name, step in steps.items():
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            for _ in range(TWOPASS_STEPS):
                metrics = step()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3
                               / TWOPASS_STEPS)
            launches = {k: v for k, v in launch_counts().items() if v}
            want = {k: v * TWOPASS_STEPS for k, v in per_step[name].items()}
            require(launches == want, f"twopass {what} {name}: launched "
                    f"{launches}, not {want}")
            require(math.isfinite(metrics["loss"].item()),
                    f"twopass {what} {name}: non-finite loss")
    return {name: statistics.median(v) for name, v in times.items()}


def smooth_large_flow(b: int, hw):
    """A smooth flow of ~300 px, (dy, dx), as the JAX package's label bound
    test draws it."""
    yy, xx = torch.meshgrid(torch.arange(hw[0], dtype=torch.float32),
                            torch.arange(hw[1], dtype=torch.float32),
                            indexing="ij")
    flow = torch.stack([280.0 + torch.sin(yy / 9) * 30,
                        -310.0 + torch.cos(xx / 11) * 25])
    return flow[None].expand(b, 2, *hw).contiguous().to("cuda")


def interior_flow_err(got, want):
    """|dflow| (max over dy, dx) where both masks exceed 0.999, 3-pixel
    borders left out."""
    m = (got[3][:, 0] > 0.999) & (want[3][:, 0] > 0.999)
    m[:, :3] = m[:, -3:] = False
    m[:, :, :3] = m[:, :, -3:] = False
    return (got[2] - want[2]).abs().amax(1)[m].cpu()


def drive_twopass(smi: str, gen) -> dict:
    """The two-pass sampler on the card: against the CPU and the exact
    sampler, then the augmented step's bf16 times with each sampler in
    alternating windows. Returns the phase's numbers."""
    out = {}
    params = init_params(0)

    # card vs CPU with the same draws, f32, at the chairs step's shapes
    geo = presets.geometry_aug_config("chairs", TRAIN_HW, AUG_SRC_HW)
    b, (th, tw) = TRAIN_BATCH, TRAIN_HW
    draws = draw_geometry(gen, b, geo, "cuda")
    _, (m1, t1, m2, t2) = geometry_maps(draws, geo)
    m, t = torch.cat([m1, m2]), torch.cat([t1, t2])
    imgs = torch.rand((2 * b, 3) + AUG_SRC_HW, generator=gen, device="cuda")
    card = affine_sample_twopass(imgs, m, t, th, tw)
    cpu = affine_sample_twopass(imgs.cpu(), m.cpu(), t.cpu(), th, tw)
    out["f32_card_vs_cpu"] = rel_err(card.cpu(), cpu)
    print(f"twopass f32 {2 * b}x3x{AUG_SRC_HW} -> {TRAIN_HW}: card vs CPU "
          f"{out['f32_card_vs_cpu']:.3e} (tol {TWOPASS_REL})", flush=True)
    require(out["f32_card_vs_cpu"] <= TWOPASS_REL, "twopass f32 card vs CPU")

    # the augmentation as the step runs it (bf16 images, f16 labels) on
    # the card and on the CPU, and against the exact sampler on the card
    inputs = (imgs[:b], imgs[b:], smooth_large_flow(b, AUG_SRC_HW),
              torch.ones((b, 1) + AUG_SRC_HW, device="cuda"))
    cpu_draws = {k: v.cpu() for k, v in draws.items()}
    runs = {}
    for name, dev, kwargs in (
            ("f16 card", "cuda", dict(sampler="twopass")),
            ("f16 cpu", "cpu", dict(sampler="twopass")),
            ("f32 card", "cuda", dict(sampler="twopass",
                                      label_dtype=torch.float32)),
            ("exact card", "cuda", {})):
        runs[name] = [v.cpu() for v in geometry_augmentation(
            *(v.to(dev) for v in inputs),
            draws if dev == "cuda" else cpu_draws, geo, **kwargs)]
    card, cpu = runs["f16 card"], runs["f16 cpu"]
    flow_err = interior_flow_err(card, cpu)
    dev_err = [abs_err(card[0], cpu[0]), abs_err(card[1], cpu[1]),
               abs_err(card[3], cpu[3]), flow_err.max().item(),
               flow_err.median().item()]
    tols = (2 ** -6, 2 ** -6, 2 ** -9, TWOPASS_F16_MAX, TWOPASS_F16_MEDIAN)
    out["card_vs_cpu"] = dev_err
    print(f"twopass as the step samples (bf16 images, f16 labels) card vs "
          f"CPU: img1, img2, mask max |diff| {dev_err[0]:.3e}, "
          f"{dev_err[1]:.3e}, {dev_err[2]:.3e} (tol four ulps: "
          f"{tols[0]:.3e}, {tols[1]:.3e}, {tols[2]:.3e}); flow in the "
          f"interior max {dev_err[3]:.3e} px, median {dev_err[4]:.3e} (tol "
          f"{TWOPASS_F16_MAX}, {TWOPASS_F16_MEDIAN})", flush=True)
    require(all(e <= tol for e, tol in zip(dev_err, tols)),
            "twopass card vs CPU")
    f16_err = interior_flow_err(runs["f16 card"], runs["exact card"])
    f32_err = interior_flow_err(runs["f32 card"], runs["exact card"])
    out["label_px"] = {
        "f16_max": f16_err.max().item(),
        "f16_median": f16_err.median().item(),
        "f32_max": f32_err.max().item(),
        "interior": f16_err.numel() / (b * th * tw)}
    lab = out["label_px"]
    print(f"twopass flow labels vs the exact sampler at ~300 px flow, "
          f"{lab['interior']:.2f} of the pixels: f16 max "
          f"{lab['f16_max']:.3f} px, median {lab['f16_median']:.3f} "
          f"(recorded; the JAX test's {TWOPASS_F16_MAX}, "
          f"{TWOPASS_F16_MEDIAN} at its own shapes); f32 max "
          f"{lab['f32_max']:.3f} (tol {TWOPASS_F32_MAX})", flush=True)
    require(lab["f32_max"] < TWOPASS_F32_MAX,
            "twopass f32 labels vs the exact sampler")
    del runs, inputs, imgs, card, cpu

    # bf16 times of the augmented step, chairs batch 8, alternating
    aug = TrainSettings(color=presets.color_aug_config("chairs"), geo=geo)
    aug_batch = shifted_batch(gen, TRAIN_BATCH, AUG_SRC_HW)
    trainers = {sampler: Trainer(dataclasses.replace(
        aug, aug_sampler=sampler), device="cuda", params=params)
        for sampler in ("affine", "twopass")}

    def step(name):
        return lambda: trainers[name].train_batch(*aug_batch, lr=TRAIN_LR)

    with record_launches() as calls:
        for name in trainers:
            for _ in range(2):
                step(name)()
    torch.cuda.synchronize()
    check_uncovered(calls, gen, "twopass bf16 steps")
    per_step = {"affine": {**S_STEP, "affine_sample": 2}, "twopass": S_STEP}
    ms = alternating_ms({name: step(name) for name in trainers}, per_step,
                        "augmented step")
    out["ms_per_step"] = ms
    print(f"twopass bf16 augmented S step {TRAIN_BATCH}x{AUG_SRC_HW[0]}x"
          f"{AUG_SRC_HW[1]} -> {TRAIN_HW[0]}x{TRAIN_HW[1]}, alternating: "
          f"affine_sample {ms['affine']:.3f} ms/step, twopass "
          f"{ms['twopass']:.3f} ({smi})", flush=True)
    return out


def print_deform_ptxas(log: str) -> None:
    """One line a deform kernel from ``nvcc -Xptxas -v``: registers, spill
    stores and loads, and the dynamic shared memory it is launched with
    (``mfn_deform_smem_bytes``; ptxas counts only static shared memory)."""
    demangled = subprocess.run(["c++filt"], input=log, capture_output=True,
                               text=True).stdout or log
    lib = deform_module._lib()
    name, spill = None, ""
    for line in demangled.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'", 2)[1].replace("(anonymous namespace)::",
                                                  "")
            name = name.removeprefix("void ").split("(", 1)[0]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            smem = ""
            args = [int(v) for v in name[name.find("<") + 1:-1].split(",")[1:]
                    if v.strip().lstrip("-").isdigit()]
            kind = {"deform_fwd_kernel": 0, "deform_bwd_data_kernel": 1,
                    "deform_bwd_weight_kernel": 2}.get(name.split("<")[0])
            if kind is not None:
                dtype = 1 if "bfloat16" in name else 0
                # template <T, MI, NI>, <T, MI> and <T, NWN, WM>
                a, b = (args[1], 0) if kind == 0 else (
                    (196, 0) if kind == 1 else (args[0], args[1]))
                smem = (f", {lib.mfn_deform_smem_bytes(kind, dtype, a, b)} B "
                        f"dynamic shared memory"
                        f"{' at Cout 196' if kind == 1 else ''}")
            print(f"  {name}: {regs}; {spill}{smem}", flush=True)
            name, spill = None, ""


def main() -> int:
    if sys.argv[1:2] == ["--parallel-worker"]:
        task, rank, world, port, out = sys.argv[2:7]
        return parallel_worker(task, int(rank), int(world), int(port), out)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1

    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(f"device: {kind}, torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, count {torch.cuda.device_count()}")
        print(smi, flush=True)

    with phase("build"):
        _build.build()
        for name, info in _build.build_log.items():
            print(f"nvcc {name}.cu: {info['seconds']:.2f} s", flush=True)
            if name == "deform":
                print_deform_ptxas(info["log"])
                continue
            for line in info["log"].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    with phase("kernels"):
        max_err = check_kernel(gen)
        bwd_err = check_bwd_kernels(gen)
        check_cotangent_not_copied(gen)
        corr_rows = time_corr(gen)

    with phase("deform"):
        deform_err = check_deform(gen)
        deform_rows, deform_total = time_deform(gen)
        vs_rows, kernels_ahead = deform_vs_warpconv(gen)
        ahead = kernels_ahead and all(
            r["fwd_ms"] < r["warpconv_fwd_ms"] and r["fwd_ms"] + r["bwd_ms"]
            < r["warpconv_fwd_bwd_ms"] for r in deform_rows)
        print(f"deform kernels ahead of warpconv at every level of both "
              f"models, forward and forward + backward: {ahead}", flush=True)

    with phase("slice"):
        infer_launches, per_frame = drive_slice(gen)

    with phase("train"):
        launches, ms_step, samples_s = drive_train(gen)

    with phase("augment"):
        cases = affine_cases(gen)
        affine_err = check_affine(cases)
        affine_timing = time_affine(cases)
        del cases
        aug_launches, aug_ms_step, aug_samples_s = drive_augment(gen)

    with phase("cascade"):
        cascade_fwd_launches, cascade_per_frame = drive_cascade_infer(gen)
        (cascade_launches, cascade_ms_step,
         cascade_samples_s) = drive_cascade_train(gen)

    with phase("input"):
        input_launches, input_numbers = drive_input(smi)

    with tempfile.TemporaryDirectory() as trees:
        with phase("cli"):
            cli_launches, cli_numbers, env = drive_cli(smi, gen, trees)
        with phase("tools"):
            tools_launches, tools_numbers = drive_tools(smi, gen, trees, env)
        with phase("native"):
            native_numbers = drive_native(smi, trees, tools_numbers["infer"])
        with phase("parallel"):
            par_launches, par_numbers = drive_parallel(smi, gen, trees, env,
                                                       cli_numbers)
    with phase("twopass"):
        twopass_numbers = drive_twopass(smi, gen)
    # each rank's launches in each run of phase 12, by run
    par_runs = {k: v for k, v in par_launches.items() if k != "spatial"}
    par_runs.update({f"spatial {k}": v
                     for k, v in par_launches["spatial"].items()})

    def entry(name, source, replaces, timing, err, launched, shapes,
              **extra):
        if "bound_ms" in timing:
            bound, bound_by = timing["bound_ms"], timing["bound_by"]
        else:
            bound = max(timing["bytes_ms"], timing["ops_ms"])
            bound_by = ("bytes" if timing["bytes_ms"] >= timing["ops_ms"]
                        else "operations")
        return {
            "name": name, "route": "cuda",
            "source": f"maskflownet_torch/csrc/{source}.cu",
            "replaces": ", ".join(f"maskflownet_tpu/ops/pallas/"
                                  f"{source}.py:{line}" for line in replaces),
            "launches": launched, "max_abs_err": err,
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": timing.get("library_ms"), "shapes": shapes,
            "train_ms_per_step": ms_step,
            "train_samples_per_s": samples_s,
            "aug_train_ms_per_step": aug_ms_step,
            "aug_train_samples_per_s": aug_samples_s,
            "cascade_ms_per_frame": cascade_per_frame["kernel"],
            "cascade_warpconv_ms_per_frame": cascade_per_frame["warpconv"],
            "cascade_train_ms_per_step": cascade_ms_step,
            "cascade_train_samples_per_s": cascade_samples_s,
            "input_train": input_numbers,
            "launches_input_train": input_launches[name],
            "cli": cli_numbers,
            "launches_cli_s": cli_launches["s"].get(name, 0),
            "launches_cli_s_host": cli_launches["s_host"].get(name, 0),
            "launches_cli_cascade": cli_launches["cascade"].get(name, 0),
            "tools": tools_numbers,
            "launches_tools": sum(v.get(name, 0)
                                  for v in tools_launches.values()),
            "parallel": par_numbers,
            "launches_parallel_per_rank": {
                run: counts.get(name, 0) for run, counts in
                par_runs.items()},
            "native": native_numbers, "twopass": twopass_numbers,
            **extra}

    def deform_timing(key):
        """The sums over the train step's four levels; the bound is the sum
        of each level's bound, named after the kind that bounds the larger
        part of it."""
        rows = deform_rows[:len(DEFORM_LEVELS)]
        by = {kind: sum(r[f"{key}_bound_ms"] for r in rows
                        if (r[f"{key}_bytes_ms"] >= r[f"{key}_ops_ms"])
                        == (kind == "bytes")) for kind in ("bytes",
                                                           "operations")}
        return {"ms": deform_total[f"{key}_ms"],
                "plain_ms": deform_total[f"plain_{key}_ms"],
                "bound_ms": deform_total[f"{key}_bound_ms"],
                "bound_by": max(by, key=by.get), "library_ms": None}

    def per_level(key):
        return [{"level": r["level"], "shape": list(r["shape"]),
                 "cout": r["cout"], "ms": r[f"{key}_ms"],
                 "bound_ms": r[f"{key}_bound_ms"],
                 "plain_ms": r[f"plain_{key}_ms"],
                 "warpconv_ms": r["warpconv_fwd_ms" if key == "fwd" else
                                  "warpconv_fwd_bwd_ms"],
                 "tflops": r[f"{key}_tflops"], "blocks": r["blocks"],
                 **({"data_ms": r["bwd_data_ms"],
                     "weight_ms": r["bwd_weight_ms"]} if key == "bwd"
                    else {})}
                for r in deform_rows]

    def corr_entry(name, lines, err, launched, **extra):
        timing = corr_timing(corr_rows, name)
        return entry(
            name, "correlation", lines, timing, err, launched,
            "sum over the 5 level shapes of one bf16 S train step (batch 8 "
            "at 320x448, md=4), ms with the L2 flushed before each call; "
            "launches in 20 S train steps; per_level: every level of every "
            "main path", ms_l2_warm=timing["warm_ms"],
            host_ms_per_call=timing["host_ms"],
            per_level=[r for r in corr_rows if r["kernel"] == name], **extra)

    print(json.dumps({"kernels": [
        corr_entry("corr_fwd", (62, 191), max_err, launches["corr_fwd"],
                   launches_infer_forward=infer_launches["corr_fwd"],
                   launches_cascade_forward=cascade_fwd_launches["corr_fwd"],
                   launches_cascade_train=cascade_launches["corr_fwd"],
                   launches_aug_train=aug_launches["corr_fwd"],
                   slice_ms_per_frame=per_frame),
        corr_entry("corr_bwd_f1", (104, 232), bwd_err["corr_bwd_f1"],
                   launches["corr_bwd_f1"],
                   launches_aug_train=aug_launches["corr_bwd_f1"],
                   launches_cascade_train=cascade_launches["corr_bwd_f1"]),
        corr_entry("corr_bwd_f2", (127, 253), bwd_err["corr_bwd_f2"],
                   launches["corr_bwd_f2"],
                   launches_aug_train=aug_launches["corr_bwd_f2"],
                   launches_cascade_train=cascade_launches["corr_bwd_f2"]),
        entry("affine_sample", "affine", (52,), affine_timing, affine_err,
              aug_launches["affine_sample"],
              "sum over the 2 launches of one augmented step, f32, batch 8: "
              "(8,6,384,512) and (8,3,384,512) sampled at 320x448; "
              "launches in 20 augmented steps; ms with the L2 flushed "
              "before each call", ms_l2_warm=affine_timing["warm_ms"],
              host_ms_per_call=affine_timing["host_ms"]),
        entry("deform_fwd", "deform", (99,), deform_timing("fwd"),
              deform_err["deform_fwd"][0], cascade_launches["deform_fwd"],
              "sum over the 4 deformable convs of the MaskFlownet_S train "
              "step, bf16, batch 8 at 320x448, ms with the L2 flushed "
              "before each call; launches in 20 frozen-head cascade steps; "
              "library: none (no single PyTorch call), warpconv beside it",
              max_rel_err=deform_err["deform_fwd"][1],
              warpconv_ms=deform_total["warpconv_fwd_ms"],
              per_level=per_level("fwd"),
              launches_cascade_forward=cascade_fwd_launches["deform_fwd"],
              launches_infer_forward=infer_launches["deform_fwd"],
              launches_train=launches["deform_fwd"],
              launches_aug_train=aug_launches["deform_fwd"]),
        entry("deform_bwd", "deform", (155,), deform_timing("bwd"),
              deform_err["deform_bwd"][0], cascade_launches["deform_bwd"],
              "sum over the 4 full backwards (dx, dflow, dweight) of the "
              "MaskFlownet_S train step, bf16, batch 8 at 320x448, ms with "
              "the L2 flushed before each call; launches in 20 frozen-head "
              "cascade steps (dflow and dweight, level 6 dweight only); "
              "library: none (no single PyTorch call), warpconv's "
              "forward + backward beside the kernels' forward + backward",
              max_rel_err=deform_err["deform_bwd"][1],
              warpconv_fwd_bwd_ms=deform_total["warpconv_fwd_bwd_ms"],
              ahead_of_warpconv_everywhere=ahead, vs_warpconv=vs_rows,
              fwd_bwd_ms=deform_total["fwd_ms"] + deform_total["bwd_ms"],
              launches_train=launches["deform_bwd"],
              launches_aug_train=aug_launches["deform_bwd"],
              per_level=per_level("bwd"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
