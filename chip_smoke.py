#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rectpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json] [--check3 on|off]

Run from the root of a checkout; it needs one CUDA card, the CUDA toolkit
(nvcc) and nothing of JAX or of the rectpu package. Phases, in order; any
failed check raises, and the script exits nonzero without the final line:

1. Build: compile every CUDA kernel from rectpu_torch/kernels/csrc (one
   nvcc per source, all started together, sm_90a), and the native host
   library from rectpu_torch/io/native (g++; a failed build fails the run).
2. Serving kernels against their plain PyTorch versions, on the card: the
   lookup on [4224, W] tables, W in {1, 5, 65, 128, 256}, fp32, bf16 and fp32
   rows rounded to bf16, at B in {1, 7, 37, 512, 4096} x 26 fields (bitwise
   and bitwise across launches, NaN and infinities planted in the table,
   out-of-range ids give zero rows) and the FM forward at K in {64, 4,
   100}, B in {1, 7, 37, 512, 4096, 8192} on the strided view
   looked[..., :K], the contiguous [B, F+2, K], a view whose start is not
   16-byte aligned, one of every other row and looked[..., :K] of 2K
   columns (the fast step's), in fp32 and bf16 (a bf16 v's logit in bf16
   and in fp32), then one field and one row too wide to stage: bitwise the
   in-order sums (ops/fm.py::fm_fwd_in_order) and across launches, within
   fm_tolerance of the plain version. The lookup's int8 mode (int8 rows and
   fp32 row scales from serve/quant.py, rows of very different scales and a
   zero row) at W in {65, 64, 5, 1, 13000}, fp32 and bf16 out: bitwise its
   plain version (dequant_take) and across launches, out-of-range ids give
   zero rows.
3. Training kernels against their plain versions: the scatter at [6144, 65]
   with 4096 x 26 ml-100k ids and at the flagship [311296, 65] with
   8192 x 26 ids, fp32 and bf16, with out-of-range ids and DROP_SENTINEL,
   within a stated fp32 tolerance of an fp64 oracle and bitwise equal
   across two launches; then streams that stress its sort and its pieces:
   every id on one row (ml-100k's R at every chunk the autotuner sweeps, the
   flagship's R), no valid id, no update, and the reference default's
   narrow rows (W=4 and 5, fp32, and W=5 bf16); the FM backward at K in
   {64, 4, 100}, B in {1, 7, 37, 4096, 8192} on the strided view, the
   contiguous [B, F+2, K], a view whose start is not 16-byte aligned and one
   of every other row, bitwise the in-order sums (and across launches) and
   within FM_BWD_RTOL of the plain version, and one row too wide to stage;
   fused Adam at both table sizes with fp32 slots and
   with bf16 m / stochastically rounded bf16 v, fp32 and bf16 masters,
   within 1 ulp of the plain version and bitwise equal across two launches.
   DLRM and xDeepFM kernels against their plain versions: the pair-dot
   interaction at B in {1, 7, 512, 8192} x 26 or 27 vectors (a numeric one
   appended) and 17 or 33 (off the kernel's 16-row tiles), K=64, and 27
   vectors at K=4 (the element-load staging), fp32 and bf16, itself both
   ways, exact and rounded products; the CIN contraction at H in {26, 64},
   M=26, O=64, K=64, B=37, 128 and 8192 (rows 0-511 against the plain
   version, which forms the expansion), and at B=37 with K=12 and K=24 (row
   counts off the weight gradient's 64-row chunk and the contraction's
   32-row tile), forward and both transposed-weight calls (at B=8192 the
   six call shapes of a xDeepFM zoo step: (H', M', O') = (26, 26, 64),
   (64, 26, 26) twice, (64, 26, 64) twice, (64, 64, 26)), legacy and K-major
   strided views (and K-major memory at K=12, 24); the CIN weight gradient at the same shapes (1, 2
   and 128 slices) against an fp64 oracle built in 512-row blocks, within
   a per-element fp32 bound of the kernel's order and DW_REL_L2 relative L2,
   and bitwise equal across two launches; in fp32 (3xTF32 on the tensor
   cores) the same checks and tolerances, and the largest error as a share
   of its tolerance is printed. A contraction with M=80 (no mma.sync plan:
   the tile kernel) in bf16 and fp32.
   The sparse fast step's kernels: the row set (scatter_rows_dma) with
   25,088 deduplicated rows (sentinels among them) into the full-width
   [6,000,640, 128] fp32 table and the [6,000,640, 256] m|v slab, fp32 and
   bf16, and at narrow widths (65, 2, 1 fp32; 3, 1 bf16): bitwise equal to
   the plain version, every row outside the update unchanged; the dedupe's
   segment sum (R=212,992 x 128 -> [25,088, 128]) within the fp32 bound of
   an fp64 oracle and bitwise equal across launches and dedupe runs.
3d. The autotuner's kernels: the flat FM forward (the fp32 logit and S in
   v2's type) and backward (from the kernel's S) against their plain
   versions, fp32 and bf16, at B=8192 F=26 K=64 and at ragged shapes (rows
   padded by 8 for the 16-byte path, by 1 and K=37 for the scalar path); the
   scatter at every chunk the autotuner sweeps (16, 32, 64), within the fp32
   bound of an fp64 oracle and bitwise equal across launches.
4. Serving path: DeepFM at the flagship widths (K=64, hidden [256, 128])
   from a seeded torch.Generator, in bf16 and in fp32, written by the port's
   export_model and served by the port's HTTP server (micro-batching on) on
   127.0.0.1. /predict bodies of 1, 8 and 64 instances plus a concurrent
   burst, /healthz and /metrics, each checked against a device="cpu"
   ServingModel of the same export; both kernels' launch counts must grow.
   Then /predict latency, the host/device split of one 512-instance request
   and the device's busy time in one forward (torch.profiler). The same for
   a DLRM export (one numeric column through a [64] bottom MLP; lookup and
   interaction counts must grow) and an xDeepFM export (CIN (64, 64),
   packed table; lookup and CIN counts), bf16 and fp32. Every request body
   but one has the native JSON parser's shape (asserted: it returns
   columns); one body of ragged keys takes json.loads. The request
   breakdown gives parse and encode through the native host library and
   through the Python path (the same model inputs). Each export's write
   time (with its apply.pt2 program) is printed.
4b. int8 tables: the DeepFM bf16 and fp32 exports and the DLRM and xDeepFM
   fp32 exports quantized by the port's CLI (serve/quant.py) and served over
   HTTP, and the fp32 DeepFM export served with --table-quant int8: each
   against a device="cpu" ServingModel of the same int8 model at the
   serving tolerances and against the float model within INT8_PROB_ATOL on
   probabilities; the int8 gather and the family's kernel must launch.
   Serialized programs: the DeepFM bf16 and fp32, DLRM bf16 and xDeepFM fp32
   exports' apply.pt2 served with --serialized (its size and load seconds
   printed), against the eager model on the CPU at the serving tolerances;
   the lookup and the family's kernel must launch and be named in the trace
   of the program's forward. Batch prediction: the batch_predict CLI's
   main with --label-col rating on a 20,000-row synthetic test CSV with the
   fp32 DeepFM export, then with --table-quant int8: every row written, the
   AUC in [0, 1], the kernels launched, each logit equal to the online
   ServingModel's on the card within the fp32 serving tolerance.
5. Training path: the trainer CLI (rectpu_torch.trainers.deep_fm,
   --preset scaled, K=64, [256, 128], batch 4096) on a synthetic ml-100k
   CSV written by the port's generator: every step's loss finite, the last
   steps' mean loss below the first steps', the final AUC in [0, 1], and the
   lookup, FM, FM-backward and scatter launch counts grown. The export it
   writes is then served on the card and answers one /predict. Then the
   DLRM and xDeepFM trainer CLIs the same way (lookup, scatter and
   interaction, or CIN and CIN-dw counts grown).
5c. The Linear, DNN and Wide&Deep trainer CLIs (rectpu_torch.trainers.linear
   at its defaults; .deep and .linear_deep with --preset scaled, K=64,
   [256, 128]; .linear_deep also with the packed table padded to 128
   columns, --preset scaled's flags without the flat layout), batch 4096, 40
   steps, each with its default optimizer (FTRL; Adagrad; FTRL + Adagrad
   on the packed table's columns), on the same CSV: the same checks, the
   lookup and scatter counts grown; each export is served over HTTP and
   held against a device="cpu" ServingModel of it at the serving
   tolerances. Then one DNN and one Wide&Deep step (the flagship widths on
   the ml-100k table, batch 4096, the default optimizer) against a CPU copy:
   the loss within 1e-2 relative, each leaf's update within GRAD_REL_L2.
5e. The DCN and AutoInt trainer CLIs (rectpu_torch.trainers.dcn with
   --streaming-io --exporter best, and with --fast-step on --sparse-scatter
   dma; rectpu_torch.trainers.autoint), --preset scaled, K=64, [256, 128],
   batch 4096, 40 steps in one logging window, Adam, on the same CSV: the
   same checks, the lookup and scatter counts grown (the fast step's: the
   lookup, the row set and the segment sum; the streaming run's windows
   encoded by the native host library, counted); each run's event file holds the
   loss and eval/auc, the best exporter's best_metric.json its final AUC;
   each export is served over HTTP and held against a device="cpu"
   ServingModel. Then AutoInt's three attention forms ("broadcast", "bf16",
   "grouped"; the zoo model below) on the card against a CPU copy at B=64.
5f. The dispatch modes (TrainConfig.dispatch_mode): "scan", each step a
   replay of a CUDA graph of the step captured after 3 eager warm-up steps,
   against "pipelined", each from the same weights and data, bit for bit in
   every step's loss, every parameter and optimizer-state leaf (and the
   CLIs' eval metrics): the parity config (the reference defaults, K=4
   [16, 16], dropout 0.1, batch 32) through the DeepFM CLI, 120 steps in
   loops of 50, 50 and 20 (a checkpoint, eval and export after each of the
   first two), hash and threefry dropout, the scan run with
   --profile-dir (its trace must name the lookup, FM and scatter kernels);
   the same config (loops of 50, 50 and 20), the flagship step (phase 6's:
   fused Adam on the table, bf16 m, bf16-SR v) and the full-width fast step
   (phase 6c's, threefry dropout; both 40 steps in loops of 10, 10 and 20),
   driven loop by loop through the Trainer's loop runner: the first loop
   warms up (and captures), the wall ms a step of the middle loop, the last
   loop profiled (the device's busy ms and the host's aten ops a step,
   at most SCAN_HOST_OPS_MAX under scan); the same launches of every kernel
   both ways (a replay's launches counted as its capture's); then the DLRM,
   xDeepFM, Linear (also with --streaming-io: batches staged from the
   host), DNN and Wide&Deep CLIs at batch 512, 20 steps, their default
   optimizers. Under a plan on the card "auto" must follow rectpu's batch
   rule (scan below batch 2048).
5d. Check (3)(b), with --check3 on only (it takes longer than the rest of
   the script, 138 s on an H100): the DeepFM trainer CLI at the reference
   defaults (K=4, [16, 16], dropout 0.1, batch 32, 20,000 steps) at --seed
   42 on the data `python -m rectpu_torch.data.ml_100k local --synthetic`
   writes: the streaming AUC beside rectpu's pin 0.8124665 and the wall
   time.
5b. The DeepFM trainer CLI with --autotune and --profile-dir (--preset
   scaled, K=64, batch 4096, 20 steps in windows of 5): the autotuner times
   the port's kernels at the trainer's shapes (the flat FM kernels' launch
   counts must grow) and logs its picks; the second window's trace is
   written and names fm.cu's kernels. The pins are put back afterwards.
6. Flagship step: bench.py's configuration (310k-row table, batch 8192,
   bf16 towers and table gradient, hash dropout, Adam with bf16 m and
   stochastically rounded v, the table on the fused kernel): the step's
   median time and examples/s, launches per step (the fused-Adam count must
   grow), and one step's table and MLP gradients against the same step on
   a CPU copy of the port (dropout 0, same weights). Then the DLRM-flat and
   xDeepFM zoo steps (benchmarks/_bench_zoo.py:79-112, batch 8192): median
   wall, examples/s, launches per step, the device's busy time, and one
   step's gradients against a CPU copy (xDeepFM on 512 rows). Then the
   xDeepFM zoo step in fp32 (fp32 towers, table cotangent and Adam slots,
   the trainer CLIs' default type): the same numbers, the CIN kernels'
   share of the busy time, and one step's gradients on 512 rows against a
   CPU copy within FP32_GRAD_REL_L2 per leaf.
6d. The DCN and AutoInt zoo steps (benchmarks/_bench_zoo.py:82-88, 113-119:
   the flagship's table and widths, batch 8192, bf16, flat layout, mxu
   scatter; DCN with two full-rank cross layers, DCN with two of rank 256,
   AutoInt with 2 layers of 2 heads and a packed table): median wall,
   launches per step, peak device memory, the device's busy time and, for
   DCN, the CUDA-event time of its cross layers (fp32 GEMMs of bf16 values,
   forward and backward) beside their bound; one step's gradients on 512
   rows against a CPU copy within GRAD_REL_L2 per leaf.
6c. Sparse fast step at full width (benchmarks/_ablate_bigtable.py's
   run_sparse(packed=True, scatter_backend="dma"): DeepFM K=64 [256, 128],
   6,000,640-row table lane-padded to 128 columns, fp32 m|v slab [.., 256],
   batch 8192): one step changes the rows its batch touched and no other;
   the median of BIG_STEPS steps, examples/s, launches per step (the row set
   exactly twice: table and m|v) and the device's busy share; one step
   against a CPU copy at bench.py's 311,296-row table (each leaf's update
   and the m|v rows). Then the trainer CLI with --preset scaled --fast-step
   on --sparse-scatter dma (batch 4096) trains and its export is served.
8. Sharded training (rectpu_torch/parallel), every rank a process on the one
   card (NCCL takes no two ranks on one device, so the ranks run over Gloo,
   which parallel/mesh.py chooses; the port hands Gloo CUDA tensors, which
   Gloo copies through host memory itself; these times say nothing of NCCL
   across cards):
   (a) each collective once in a world-size-1 NCCL group on cuda:0; then,
       over Gloo with 2 ranks, each autograd collective's forward and
       backward exactly against its definition;
   (b) the flagship step (phase 6's config, K=64, 311,296 rows, batch 8192,
       hash dropout, flat layout, mxu backward, fused Adam on the table)
       SHARD_STEPS steps on mesh 1x2 under 2d, 2d with bf16 rows, dedup
       (lossless capacity), dedup with int8 rows and 1d, and on mesh 2x2
       under 2d, against the single-process step from the same params,
       every run through the Trainer's batches of one resident train set
       (each rank's block of every global batch, checked): per-step losses
       and each leaf's update, as the sharded save gathers it and rank 0's
       checkpoint holds it, within SHARD_LOSS_RTOL / SHARD_UPDATE_REL_L2
       (int8: rectpu's loss bound and INT8_UPDATE_REL_L2; a control run
       with a 4-bit grid planted on the int8 wire must fail that check);
       the sharded eval against one process's eval of the same params; the
       median step beside phase 6's, the kernels the ranks launched;
   (c) the full-width fast step (phase 6c's table, 3,000,320 rows a rank)
       on mesh 1x2 under dedup against the single-process fast step on the
       same card, both through the Trainer's batches, each rank's table and
       m|v rows;
   (d) the DeepFM CLI under torchrun at 2 ranks (--num-model-shards 2
       --ep-mode dedup --ep-row-placement freq --ep-peer-capacity auto, the
       CLI's defaults with hash dropout, batch 64, 200 steps: rectpu's
       multi-process configuration; batch 64 resolves to scan) against the
       CLI at 1 rank with the same row placement (rectpu's _assert_matches
       tolerances on the eval metrics and the parameter digest); its export
       is served;
   (e) the tensor-parallel towers (--tp-mlp: each tower's kernels column-
       and row-sharded over 'model', rectpu's _tp_spec): the flagship step as
       in (b) on mesh 1x2 under 1d and 2d and on mesh 2x2 under 2d, and the
       DLRM zoo step with 13 numeric columns (its top MLP and its bottom MLP
       tensor-parallel; the interaction kernel launched) on mesh 1x2 under
       2d, each held to (b)'s exact-mode bounds against its single-process
       step, its sharded eval against one process's, and rank 0's checkpoint
       read back with every parameter and optimizer-state leaf in its global
       shape; then the DeepFM CLI of (d) with --tp-mlp at 2 torchrun ranks
       against the same 1-rank run, its export served;
   (f) scan dispatch under a plan (each step after WARMUP_STEPS eager ones a
       replay of the step's graph segments, cut at its collectives, with the
       collectives run eagerly between them) against pipelined, from the
       same params and batches, loops of SCAN_LOOPS: the flagship at 1x2
       under 1d, 2d, dedup, 2d with the unflattened [B, F, K+1] exchange and
       2d with --tp-mlp, at 2x2 under 2d, and (c)'s full-width fast step at
       1x2 under dedup, bit for bit in every loss share, each rank's
       parameter and optimizer-state leaves and the sharded eval; every step
       after the warm-up a replay, the same launches of every kernel both
       ways, the host's aten ops a rank and step under scan below
       SCAN_HOST_OPS_SHARE of pipelined's; segments and collectives a step,
       the wall ms a step both ways. Then (d)'s 2-rank CLI again, pipelined
       (a script that sets the built Trainer's dispatch), bit for bit the
       scan run in the eval and every checkpoint leaf, both runs traced
       (--profile-dir: rank 0's second logging window) for the host's aten
       ops a step and the port's kernels by name, the same both ways.
7. Times: CUDA-event times of every kernel at the path's shapes (inputs cold
   in device memory, and L2-warm) beside its plain version, its bound and,
   where one PyTorch call computes the same function, that call (for the
   interaction, torch.bmm forming the full z, a superset of the work; for
   the row set, index_copy_ of the valid rows): the interaction in both
   product modes, the CIN contraction at the six call shapes of a xDeepFM
   zoo step (bf16 and fp32; an fp32 row also gives the 3xTF32 route's
   bound), the CIN weight gradient also with the model's strided y. The
   lookup also at the flagship step's shape (its fp32 [311296, 65] table
   gathered as bf16, beside the whole-table cast then the kernel) and at
   the fast step's three (the batch's rows and the lazy-Adam rows of the
   table and of the m|v slab). The int8 gather at the int8 DeepFM serving
   shape ([4224, 65] int8, B=4096, bf16 out) beside its plain version, the
   four-op PyTorch composite and the fp32 gather of the same rows. The FM
   forward at B=512 and 4096 in bf16 and fp32, at the flagship step's shape
   (bf16 B=8192, the logit in fp32) and at the fast step's (fp32
   looked[..., :64] of 128 columns, B=8192). The fast step's dedupe and
   lazy-Adam row update are timed whole beside them. The flat FM forward
   and backward at B=8192, F=26, K=64. Then the device operations of one scatter call (its
   sort and its sums) and of one segment sum, by name, with their count a
   call (torch.profiler).

The second-to-last lines are the kernels' JSON summary and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import inspect
import json
import logging
import math
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
from pathlib import Path

import numpy as np
import torch

from rectpu_torch.convert import flat_params, flatten_tree, load_params, params_tree
from rectpu_torch.data.synthetic import write_synthetic_dataset
from rectpu_torch.device import resolve_device
from rectpu_torch.features.schema import (
    GENRE,
    BucketizedFeature,
    FeatureSet,
    HashFeature,
    IdentityFeature,
    NumericFeature,
    VocabFeature,
    ml_100k_feature_set,
)
from rectpu_torch.kernels import build
from rectpu_torch.data import ml_100k as ml_100k_etl
from rectpu_torch.io import native
from rectpu_torch.io.loader import CsvDataset, read_csv_columns
from rectpu_torch.io.native import build as native_build
from rectpu_torch.io.native import csv_bridge
from rectpu_torch.models import (
    AutoIntModel,
    DCNModel,
    DeepFMModel,
    DLRMModel,
    DNNModel,
    TowerConfig,
    WideDeepModel,
    XDeepFMModel,
)
from rectpu_torch.models.base import init_mlp
from rectpu_torch.ops import cin as cin_ops
from rectpu_torch.ops import embedding as emb_ops
from rectpu_torch.ops import fm as fm_ops
from rectpu_torch.ops import fused_adam as adam_ops
from rectpu_torch.ops import interaction as int_ops
from rectpu_torch.ops import scatter_dma as dma_ops
from rectpu_torch.ops import scatter_rows as scatter_ops
from rectpu_torch.ops.autotune import SCATTER_CHUNKS
from rectpu_torch.parallel import mesh as mesh_lib
from rectpu_torch.parallel.plan import ParallelPlan
from rectpu_torch.serve import batch_predict as batch_predict_cli
from rectpu_torch.serve import quant as quant_cli
from rectpu_torch.serve.export import (
    PROGRAM,
    SERVING_REQUIRED,
    export_model,
    latest_export,
    load_model,
)
from rectpu_torch.serve.quant import quantize_serving
from rectpu_torch.serve.server import instances_to_columns, make_server, parse_request_columns
from rectpu_torch.train import sparse as sparse_ops
from rectpu_torch.train.dispatch import WARMUP_STEPS
from rectpu_torch.train.fast_step import make_sparse_step
from rectpu_torch.train.loop import TrainConfig, Trainer
from rectpu_torch.train.optimizers import BF16_SR, adam
from rectpu_torch.trainers import autoint as autoint_cli
from rectpu_torch.trainers import common as trainers_common
from rectpu_torch.trainers import dcn as dcn_cli
from rectpu_torch.trainers import deep as deep_cli
from rectpu_torch.trainers import deep_fm as deep_fm_cli
from rectpu_torch.trainers import dlrm as dlrm_cli
from rectpu_torch.trainers import linear as linear_cli
from rectpu_torch.trainers import linear_deep as linear_deep_cli
from rectpu_torch.trainers import xdeep_fm as xdeep_fm_cli
from rectpu_torch.utils.hash32 import GlobalIndex
from rectpu_torch.utils.events import read_events
from rectpu_torch.utils.timing import event_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores
# fp32 products as 3xTF32: three TF32 products each at the dense TF32 rate (495)
TF32X3_FLOPS = 495e12 / 3
V_ROWS, WIDTH, FIELDS, K = 4224, 65, 26, 64  # served ml-100k table, flagship K

# tolerances against the plain version / the CPU reference, with reasons
FM_RTOL_OF_SCALE = 1e-5  # fp32 sums in another order; relative to 0.5*sum_k(S^2+Q)
BF16_REL_ULP = 2.0 ** -7  # one bf16 ulp, relative to the value (8-bit significand)
FP32_LOGIT_ATOL = 1e-4  # fp32 card vs CPU: 1,664-long dot products in another order
BF16_LOGIT_ATOL, BF16_LOGIT_RTOL = 2e-2, 1e-2  # bf16 activations may round one ulp apart
INT8_PROB_ATOL = 0.02  # int8 table vs the float one, on probabilities (rectpu's test_quant)
FP32_EPS = 2.0 ** -24  # unit roundoff of fp32
FM_BWD_RTOL = 1e-5  # fp32 S summed in another order; relative to |g| * sum_f |v|
GRAD_REL_L2 = 1e-2  # card vs CPU gradient, relative L2 per leaf: ~2 bf16 ulps (2^-8)
# the same for an fp32 step: fp32 sums in another order (cuBLAS, the CIN's
# tensor-core sums and 3xTF32 products, within ~2^-20 of each term), no bf16
FP32_GRAD_REL_L2 = 1e-4
# cin_dw vs its fp64 oracle, relative L2: the kernel's fp32 sums run 4096-row
# slices; on an H100 the bf16 tensor-core path truncates its fp32 adds, a
# systematic shrink of ~4e-6, while one dropped row of 524,288 moves it ~1.4e-3
DW_REL_L2 = 1e-5
TRAIN_BATCH, TRAIN_STEPS = 4096, 40  # the trainer CLI phase
BP_ROWS = 20_000  # the batch prediction phase's test CSV
AUTOTUNE_CLI_STEPS, AUTOTUNE_CLI_LOOP = 20, 5  # --autotune --profile-dir: window 2 traced
FLAGSHIP_BATCH, FLAGSHIP_STEPS = 8192, 20
CIN_O = 64  # xDeepFM's cin_units (64, 64)
ZOO_CLI_STEPS, ZOO_STEPS = 30, 10  # the DLRM / xDeepFM trainer CLIs and zoo steps
BIG_BATCH, BIG_STEPS = 8192, 25  # the sparse fast step at full width (_ablate_bigtable.py)
# fast step card vs CPU, relative L2 of the table rows' one-step update: twice
# the gradients' GRAD_REL_L2 (an Adam step from zero is ~lr * sign(g), so a
# gradient near 0 can take the other sign on the two sides, as the CPU tests
# of tests/test_torch_train.py allow). m = 0.1 g is held to GRAD_REL_L2 and
# v = 0.001 g^2, which doubles a relative error, to twice it.
FAST_UPDATE_REL_L2 = 2 * GRAD_REL_L2


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    check(bool(out), "nvidia-smi printed no name and power limit")
    return out.splitlines()[0]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def fm_tolerance(v: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|kernel - plain| allowed per row: fp32 rounding of sums taken in
    another order, relative to the magnitude of the summed terms, plus one
    bf16 ulp of the value when the output is bf16 (the two fp32 results may
    round to neighbouring bf16 values)."""
    v64 = v.double()
    scale = 0.5 * (v64.sum(1) ** 2 + (v64 * v64).sum(1)).sum(-1)
    tol = FM_RTOL_OF_SCALE * scale
    if want.dtype == torch.bfloat16:
        tol = tol + BF16_REL_ULP * want.double().abs()
    return tol


# --- phase 2: kernels against their plain versions --------------------------


LOOKUP_WIDTHS = (1, 5, WIDTH, 128, 256)  # the linear tower, K=4, K=64, the fast step's
LOOKUP_TYPES = ((torch.float32, None), (torch.bfloat16, None),
                (torch.float32, torch.bfloat16))  # table -> out (None: the table's)


def check_kernels(dev, gen) -> dict:
    errs = {"embedding_lookup": 0.0, "fm_cross": 0.0}
    for w in LOOKUP_WIDTHS:
        for in_dtype, out_dtype in LOOKUP_TYPES:
            table = (torch.randn(V_ROWS, w, generator=gen) * 0.1).to(in_dtype)
            # NaN and infinities go through bitwise, rounded or not
            table.view(-1)[[3, 5, 9]] = torch.tensor(
                [float("nan"), float("inf"), float("-inf")], dtype=in_dtype)
            table = table.to(dev)
            for b in (1, 7, 37, 512, 4096):  # 37 x 26 rows: a multiple of no tile
                ids = torch.randint(0, V_ROWS, (b, FIELDS), generator=gen, dtype=torch.int32)
                bad = torch.tensor([-1, V_ROWS, V_ROWS + 100, -2**31, 2**31 - 1],
                                   dtype=torch.int32)
                ids.view(-1)[:5] = bad
                # the rows that hold the NaN and the infinities
                ids.view(-1)[5:8] = torch.tensor([3 // w, 5 // w, 9 // w], dtype=torch.int32)
                ids = ids.to(dev)
                got = emb_ops.lookup_cuda(table, ids, out_dtype)
                again = emb_ops.lookup_cuda(table, ids, out_dtype)
                want = emb_ops.lookup_take(table, ids).to(out_dtype or in_dtype)
                torch.cuda.synchronize()
                check(got.shape == (b, FIELDS, w), f"lookup shape {tuple(got.shape)}")
                label = f"lookup W={w} {in_dtype}->{out_dtype or in_dtype} B={b}"
                check(same_bits(got, want), f"{label}: kernel != plain bitwise")
                check(same_bits(got, again), f"{label}: two launches differ")
                check(not got.reshape(-1, w)[:5].any(), "out-of-range ids gave nonzero rows")
        print(f"check: embedding_lookup W={w} fp32, bf16 and fp32->bf16, B=1,7,37,512,4096: "
              "bitwise equal to plain (NaN and infinities included), out-of-range ids -> zero "
              "rows")
    for dtype in (torch.float32, torch.bfloat16):
        # a bf16 v's logit in bf16 (the model's) or in fp32 (the flat layout's)
        out_dtypes = (None, torch.float32) if dtype == torch.bfloat16 else (None,)
        for k in (64, 4, 100):
            for b in (1, 7, 37, 512, 4096, FLAGSHIP_BATCH):
                for label, v in fm_fwd_views(b, k, dtype, dev, gen).items():
                    for out_dtype in out_dtypes:
                        check_fm_fwd(v, out_dtype, f"fm {dtype} B={b} K={k} {label}", errs)
        print(f"check: fm_cross {dtype} K=64,4,100 B=1,7,37,512,4096,8192 on the strided, "
              "contiguous [B, F+2, K], unaligned-start, every-other-row and 2K-column views, "
              f"out in {'bf16 and fp32' if dtype == torch.bfloat16 else 'fp32'}: bitwise the "
              "in-order sums and across launches, within tolerance of plain (max abs err so "
              f"far {errs['fm_cross']:.3g})")
    # one field; a row wider than any stage of shared memory (not staged)
    check_fm_fwd((torch.randn(37, 1, K + 1, generator=gen) * 0.3).to(dev)[..., :K], None,
                 "fm [37, 1, 64] fp32", errs)
    v = torch.randn(5, FIELDS, 3000, generator=gen).to(dev)
    check(fm_ops.fm_fwd_plan(5, FIELDS, 3000, v.stride(0), v.stride(1), 4, True).mode
          == "direct", "fm: a 312 KB row was planned for staging")
    check_fm_fwd(v, None, "fm [5, 26, 3000] fp32 (unstaged)", errs)
    errs["embedding_lookup_int8"] = check_int8_lookup(dev, gen)
    return errs


# the int8 gather: the packed K=64 row (K+1 = 65 int8 bytes, the tile path),
# K=64 unpacked, the K=4 packed row, W=1, and one row too wide for a tile
INT8_WIDTHS = ((WIDTH, (1, 7, 37, 512, 4096)), (K, (1, 37, 4096)), (5, (1, 37, 4096)),
               (1, (7, 4096)), (13000, (1, 3)))


def check_int8_lookup(dev, gen) -> float:
    """The gather's int8 mode against its plain version (dequant_take), bitwise,
    fp32 and bf16 out, on tables quantized by serve/quant.py (a zero row and
    rows of very different scales among them); bitwise across launches;
    out-of-range ids give zero rows."""
    for w, batches in INT8_WIDTHS:
        v_rows = V_ROWS if w < 1000 else 64
        table = torch.randn(v_rows, w, generator=gen) * torch.exp(
            torch.randn(v_rows, 1, generator=gen) * 3)
        table[1] = 0.0
        q, s = (torch.from_numpy(a).to(dev) for a in quant_cli.quantize_rows(table))
        for out_dtype in (torch.float32, torch.bfloat16):
            for b in batches:
                ids = torch.randint(0, v_rows, (b, FIELDS), generator=gen, dtype=torch.int32)
                ids.view(-1)[:3] = torch.tensor([-1, v_rows, 1], dtype=torch.int32)
                ids = ids.to(dev)
                got = emb_ops.dequant_lookup_cuda(q, s, ids, out_dtype)
                again = emb_ops.dequant_lookup_cuda(q, s, ids, out_dtype)
                want = emb_ops.dequant_take(q, s, ids, out_dtype)
                torch.cuda.synchronize()
                label = f"int8 lookup W={w} -> {out_dtype} B={b}"
                check(got.shape == (b, FIELDS, w) and got.dtype == out_dtype, label)
                check(same_bits(got, want), f"{label}: kernel != plain bitwise")
                check(same_bits(got, again), f"{label}: two launches differ")
                check(not got.reshape(-1, w)[:3].any(), f"{label}: out-of-range or zero row "
                                                        "not zero")
    print("check: embedding_lookup int8 mode W=65,64,5,1,13000 -> fp32 and bf16, "
          "B=1..4096: bitwise equal to plain (dequant_take) and across launches, "
          "out-of-range ids -> zero rows")
    return 0.0


def fm_fwd_views(b: int, k: int, dtype, dev, gen) -> dict:
    """The v the FM forward is handed: the backward's four views and the
    fast step's looked[..., :K] of a row twice as wide (128 columns at K=64,
    whose fields start on 16 bytes and carry K columns of pad)."""
    padded = (torch.randn(b, FIELDS, 2 * k, generator=gen) * 0.3).to(dtype).to(dev)
    return {**fm_bwd_views(b, k, dtype, dev, gen), "looked[:, :, :K] of 2K": padded[..., :k]}


def check_fm_fwd(v: torch.Tensor, out_dtype, what: str, errs: dict) -> None:
    """The FM forward on v: bitwise the in-order sums and across two
    launches, within fm_tolerance of the plain version."""
    got = fm_ops.fm_cross_cuda(v, out_dtype)
    again = fm_ops.fm_cross_cuda(v, out_dtype)
    want = fm_ops.fm_cross_xla(v, out_dtype)
    in_order = fm_ops.fm_fwd_in_order(v, out_dtype)
    torch.cuda.synchronize()
    what = f"{what} -> {out_dtype or v.dtype}"
    check(got.shape == (v.shape[0],) and got.dtype == want.dtype, f"{what}: shape/dtype")
    check(same_bits(got, again), f"{what}: two launches differ")
    check(same_bits(got, in_order), f"{what}: not bitwise the in-order sums")
    err = (got.double() - want.double()).abs()
    check(bool((err <= fm_tolerance(v, want)).all()), f"{what}: max err {err.max().item()}")
    errs["fm_cross"] = max(errs["fm_cross"], err.max().item())


# --- phase 3: training kernels against their plain versions ----------------


def bench_feature_set() -> FeatureSet:
    """bench.py's flagship feature set (bench.py:34-55): the ml-100k schema
    with user 100k, item 200k and zipcode 10k hash buckets (310,106 rows)."""
    feats = [
        HashFeature("user_id", 100_000, dtype="int32"),
        HashFeature("item_id", 200_000, dtype="int32"),
        BucketizedFeature("age", tuple(range(15, 66, 10))),
        VocabFeature("gender", ("F", "M"), num_oov_buckets=1),
        HashFeature("occupation", 50),
        HashFeature("zipcode", 10_000),
        BucketizedFeature("release_year", tuple(range(1930, 1991, 10))),
    ]
    feats.extend(IdentityFeature(g, 2) for g in GENRE)
    return FeatureSet(categorical=tuple(feats))


def random_ids(fs: FeatureSet, batch: int, rng) -> np.ndarray:
    """[batch, F] int32 global ids, uniform within each field (bench.py:58-67)."""
    offs, sizes = fs.offsets, fs.field_sizes
    return np.stack([offs[f] + rng.integers(0, sizes[f], size=batch)
                     for f in range(fs.num_fields)], axis=1).astype(np.int32)


def padded_rows(fs: FeatureSet, padding: int = 2048) -> int:
    return -(-fs.total_buckets // padding) * padding


def scatter_cases(rng):
    """(label, ids [R] int32, v_rows): the ml-100k and flagship streams, with
    out-of-range ids and DROP_SENTINEL among them."""
    cases = []
    for label, fs, batch in (("ml100k", ml_100k_feature_set(), 4096),
                             ("flagship", bench_feature_set(), 8192)):
        v_rows = padded_rows(fs)
        ids = random_ids(fs, batch, rng).reshape(-1)
        ids[:6] = [-1, v_rows, v_rows + 7, scatter_ops.DROP_SENTINEL, -2**31, 2**31 - 1]
        cases.append((label, torch.from_numpy(ids), v_rows))
    return cases


def scatter_oracle(ids: torch.Tensor, upd: torch.Tensor, v_rows: int):
    """(fp64 sums, fp64 sums of |u|, updates per row) by index_add_."""
    ids64 = ids.long()
    keep = (ids64 >= 0) & (ids64 < v_rows)
    idx, u = ids64[keep], upd[keep].double()
    w = upd.shape[1]
    exact = torch.zeros(v_rows, w, dtype=torch.float64, device=upd.device).index_add_(0, idx, u)
    mag = torch.zeros(v_rows, w, dtype=torch.float64, device=upd.device).index_add_(0, idx, u.abs())
    count = torch.bincount(idx, minlength=v_rows).double()
    return exact, mag, count


def scatter_tolerance(mag, count, out_dtype, exact) -> torch.Tensor:
    """|got - fp64 sum| allowed per element: recursive fp32 summation of n
    terms errs by at most n * u * sum|terms| (u = 2^-24; chunk partials add a
    few more roundings, covered by the factor 2), plus one bf16 ulp of the
    value when the output is bf16."""
    tol = 2.0 * (count[:, None] + 1.0) * FP32_EPS * mag
    if out_dtype == torch.bfloat16:
        tol = tol + BF16_REL_ULP * exact.abs()
    return tol


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two same-typed
    float tensors (bit patterns as ordered integers)."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    sign = 0x7FFFFFFF if a.dtype == torch.float32 else 0x7FFF

    def ordered(x):
        i = x.contiguous().view(view).long()
        return torch.where(i < 0, -(i & sign), i)

    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def check_scatter_edges(dev, gen, rng) -> float:
    """The scatter on streams that stress its ordering and its pieces: every
    id on one row (ml-100k's R at every chunk the autotuner sweeps, and the
    flagship's R), no valid id at all, no update at all, and the reference
    default's narrow rows (K=4: W=4 and the packed W=5) on ml-100k's ids.
    Each within the fp32 bound of the fp64 oracle, bitwise equal across two
    launches, untouched rows zero; returns the largest |kernel - plain|."""
    worst = 0.0
    ml_rows, fl_rows = padded_rows(ml_100k_feature_set()), padded_rows(bench_feature_set())
    n_ml, n_fl = TRAIN_BATCH * FIELDS, FLAGSHIP_BATCH * FIELDS
    bad = np.array([-1, ml_rows, scatter_ops.DROP_SENTINEL, -2**31, 2**31 - 1], np.int32)
    ml_ids = random_ids(ml_100k_feature_set(), TRAIN_BATCH, rng).reshape(-1)
    cases = [  # (label, ids, v_rows, width, dtypes, chunks)
        ("every id on row 7", np.full(n_ml, 7, np.int32), ml_rows, WIDTH,
         (torch.float32, torch.bfloat16), SCATTER_CHUNKS),
        ("every id on the last row", np.full(n_fl, fl_rows - 1, np.int32), fl_rows, WIDTH,
         (torch.bfloat16,), (scatter_ops.CHUNK,)),
        ("no valid id", bad[np.arange(n_ml) % len(bad)], ml_rows, WIDTH,
         (torch.float32, torch.bfloat16), (scatter_ops.CHUNK,)),
        ("no update", np.zeros(0, np.int32), ml_rows, WIDTH, (torch.float32,),
         (scatter_ops.CHUNK,)),
        ("W=4", ml_ids, ml_rows, 4, (torch.float32,), SCATTER_CHUNKS),
        ("W=5", ml_ids, ml_rows, 5, (torch.float32, torch.bfloat16), SCATTER_CHUNKS),
    ]
    for label, ids_np, v_rows, width, dtypes, chunks in cases:
        ids = torch.from_numpy(ids_np).to(dev)
        for dtype in dtypes:
            upd = torch.randn(ids.shape[0], width, generator=gen).to(dtype).to(dev)
            exact, mag, count = scatter_oracle(ids, upd, v_rows)
            tol = scatter_tolerance(mag, count, dtype, exact)
            plain = scatter_ops.scatter_rows_plain(ids, upd, v_rows)
            for chunk in chunks:
                got = scatter_ops.scatter_rows_cuda(ids, upd, v_rows, chunk=chunk)
                again = scatter_ops.scatter_rows_cuda(ids, upd, v_rows, chunk=chunk)
                torch.cuda.synchronize()
                what = f"scatter {label} [{v_rows}, {width}] R={ids.shape[0]} {dtype} chunk {chunk}"
                check(got.shape == (v_rows, width) and got.dtype == dtype, f"{what}: shape/dtype")
                check(same_bits(got, again), f"{what}: two launches differ")
                err = (got.double() - exact).abs()
                check(bool((err <= tol).all()), f"{what}: max err {err.max().item()} vs the "
                                                "fp64 oracle")
                check(not got[count == 0].any(), f"{what}: untouched rows not zero")
                worst = max(worst, (got.double() - plain.double()).abs().max().item())
        print(f"check: scatter_rows {label} [{v_rows}, {width}] R={ids.shape[0]} "
              f"{[str(d).split('.')[-1] for d in dtypes]} at chunks {list(chunks)}: within "
              "tolerance of the fp64 oracle, bitwise equal across launches, untouched rows zero")
    return worst


def fm_bwd_views(b: int, k: int, dtype, dev, gen) -> dict:
    """The v the FM backward is handed: the model's strided looked[..., :K];
    with numeric fields the contiguous [B, F+2, K] concatenation; a view
    whose start is not 16-byte aligned; rows that are not one span."""
    looked = (torch.randn(b + 1, FIELDS, k + 1, generator=gen) * 0.3).to(dtype).to(dev)
    other = (torch.randn(2 * b, FIELDS, k + 1, generator=gen) * 0.3).to(dtype).to(dev)
    return {"looked[:, :, :K]": looked[:b, :, :k],
            "[B, F+2, K]": (torch.randn(b, FIELDS + 2, k, generator=gen) * 0.3).to(dtype).to(dev),
            "looked[1:, :, :K]": looked[1:, :, :k],
            "looked[::2, :, :K]": other[::2, :, :k]}


def fm_bwd_in_order(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dv = g * (S - v) with S summed over f = 0 .. F-1 one fp32 add at a
    time, then g * (S - v) in fp32 and one rounding to v's type: the
    kernel's order, so its bits on finite inputs."""
    s = torch.zeros(v.shape[0], v.shape[2], dtype=torch.float32, device=v.device)
    for f in range(v.shape[1]):
        s = s + v[:, f, :].float()
    return (g.float()[:, None, None] * (s[:, None, :] - v.float())).to(v.dtype)


# a table shard's first global row whose flat index passes 2^32 (phase 3)
ADAM_SHARD_ROW0 = (1 << 32) // WIDTH + 12_345


def check_train_kernels(dev, gen) -> dict:
    errs = {"scatter_rows": 0.0, "fm_cross_bwd": 0.0, "fused_adam": 0.0}
    rng = np.random.default_rng(1)
    for label, ids, v_rows in scatter_cases(rng):
        ids = ids.to(dev)
        for in_dtype, out_dtype in ((torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)):
            upd = torch.randn(ids.shape[0], WIDTH, generator=gen).to(in_dtype).to(dev)
            got = scatter_ops.scatter_rows_cuda(ids, upd, v_rows, out_dtype)
            again = scatter_ops.scatter_rows_cuda(ids, upd, v_rows, out_dtype)
            plain = scatter_ops.scatter_rows_plain(ids, upd, v_rows, out_dtype)
            exact, mag, count = scatter_oracle(ids, upd, v_rows)
            torch.cuda.synchronize()
            check(got.shape == (v_rows, WIDTH) and got.dtype == out_dtype, "scatter shape/dtype")
            check(same_bits(got, again), f"scatter {label} {in_dtype}->{out_dtype}: two "
                                         "launches differ")
            tol = scatter_tolerance(mag, count, out_dtype, exact)
            err = (got.double() - exact).abs()
            check(bool((err <= tol).all()), f"scatter {label} {in_dtype}->{out_dtype}: max "
                                            f"err {err.max().item()} vs the fp64 oracle")
            check(bool(((plain.double() - exact).abs() <= tol).all()),
                  f"scatter {label}: the plain version is outside the tolerance")
            check(not got[count == 0].any(), f"scatter {label}: untouched rows not zero")
            errs["scatter_rows"] = max(errs["scatter_rows"],
                                       (got.double() - plain.double()).abs().max().item())
        print(f"check: scatter_rows {label} [{v_rows}, {WIDTH}] R={ids.shape[0]} "
              "fp32/bf16: within tolerance of the fp64 oracle, bitwise equal across launches, "
              f"out-of-range ids dropped (max |kernel - plain| {errs['scatter_rows']:.3g})")

    errs["scatter_rows"] = max(errs["scatter_rows"], check_scatter_edges(dev, gen, rng))

    for dtype in (torch.float32, torch.bfloat16):
        for k in (64, 4, 100):
            for b in (1, 7, 37, 4096, FLAGSHIP_BATCH):
                for label, v in fm_bwd_views(b, k, dtype, dev, gen).items():
                    g = torch.randn(b, generator=gen).to(dev)
                    got = fm_ops.fm_cross_bwd_cuda(v, g)
                    again = fm_ops.fm_cross_bwd_cuda(v, g)
                    want = fm_ops.fm_cross_bwd_xla(v, g)
                    in_order = fm_bwd_in_order(v, g)
                    torch.cuda.synchronize()
                    what = f"fm bwd {dtype} B={b} K={k} {label}"
                    check(got.shape == v.shape and got.dtype == dtype, f"{what}: shape/dtype")
                    check(same_bits(got, again), f"{what}: two launches differ")
                    check(same_bits(got, in_order), f"{what}: not bitwise the in-order sums")
                    scale = g.double().abs()[:, None, None] * v.double().abs().sum(1, keepdim=True)
                    tol = FM_BWD_RTOL * scale
                    if dtype == torch.bfloat16:
                        tol = tol + BF16_REL_ULP * want.double().abs()
                    err = (got.double() - want.double()).abs()
                    check(bool((err <= tol).all()), f"{what}: max err {err.max().item()}")
                    errs["fm_cross_bwd"] = max(errs["fm_cross_bwd"], err.max().item())
        print(f"check: fm_cross_bwd {dtype} K=64,4,100 B=1,7,37,4096,8192 on the strided, "
              "contiguous [B, F+2, K], unaligned-start and every-other-row views: bitwise the "
              "in-order sums and across launches, within tolerance of plain (max abs err so "
              f"far {errs['fm_cross_bwd']:.3g})")
    # a row wider than a stage of shared memory: not staged
    v = torch.randn(5, FIELDS, 3000, generator=gen).to(dev)
    g = torch.randn(5, generator=gen).to(dev)
    check(fm_ops.fm_bwd_plan(5, FIELDS, 3000, v.stride(0), v.stride(1), 4).mode == "direct",
          "fm bwd: a 312 KB row was planned for staging")
    check(same_bits(fm_ops.fm_cross_bwd_cuda(v, g), fm_bwd_in_order(v, g)),
          "fm bwd [5, 26, 3000] fp32 (unstaged): not bitwise the in-order sums")

    st = {None: torch.float32, torch.bfloat16: torch.bfloat16, BF16_SR: torch.bfloat16}
    for v_rows in (6144, padded_rows(bench_feature_set())):
        for p_dtype, m_dt, v_dt, g_dtype in ((torch.float32, None, None, torch.float32),
                                             (torch.float32, torch.bfloat16, BF16_SR,
                                              torch.bfloat16),
                                             (torch.bfloat16, torch.bfloat16, BF16_SR,
                                              torch.bfloat16)):
            p = torch.randn(v_rows, WIDTH, generator=gen).to(p_dtype).to(dev)
            m = (torch.randn(v_rows, WIDTH, generator=gen) * 0.1).to(st[m_dt]).to(dev)
            v = (torch.rand(v_rows, WIDTH, generator=gen) * 0.01).to(st[v_dt]).to(dev)
            g = torch.randn(v_rows, WIDTH, generator=gen).to(g_dtype).to(dev)
            kw = dict(lr=1e-3, m_sr=m_dt == BF16_SR, v_sr=v_dt == BF16_SR)
            for t in (1, 7, 12345, 2**31 - 1):
                want = adam_ops.fused_adam_plain(p, m, v, g, t, **kw)
                # the third launch reads t and lr_t from device memory, as a
                # step replayed from a CUDA graph does (scan dispatch)
                lr_t = torch.tensor(float(adam_ops.adam_lr_t(t, 1e-3, 0.9, 0.999)),
                                    dtype=torch.float32, device=dev)
                t_dev = torch.tensor(t, dtype=torch.int64, device=dev)
                # the fourth updates rows [r0, r0 + v_rows) of a larger table, as
                # a rank's shard does under a plan: its rounding keys on the
                # global flat index from base r0 * W (mod 2^32: r0 * W > 2^32)
                index = GlobalIndex(ADAM_SHARD_ROW0, 0, WIDTH)
                want_shard = adam_ops.fused_adam_plain(p, m, v, g, t, index=index, **kw)
                runs = []
                for t_arg, extra in ((t, {}), (t, {}), (t_dev, {"lr_t": lr_t}),
                                     (t, {"index": index})):
                    pc, mc, vc = p.clone(), m.clone(), v.clone()
                    runs.append(adam_ops.fused_adam_cuda(pc, mc, vc, g, t_arg, **kw, **extra))
                torch.cuda.synchronize()
                for name, a, sh, w in zip("pmv", runs[3], want_shard, want):
                    check(same_bits(a, sh), f"fused_adam {name} t={t}: the row shard at base "
                                            f"{adam_ops.index_base(p.shape, index)} is not "
                                            "bitwise its plain version")
                for name, a, b2, b3, w in zip("pmv", runs[0], runs[1], runs[2], want):
                    check(same_bits(a, b2), f"fused_adam {name} t={t}: two launches differ")
                    check(same_bits(a, b3), f"fused_adam {name} t={t}: t and lr_t read from "
                                            "device memory differ from the launch arguments")
                    check(a.dtype == w.dtype, f"fused_adam {name} dtype")
                    d = ulp_distance(a, w)
                    check(d <= 1, f"fused_adam {name} p={p_dtype} m={m_dt} v={v_dt} t={t} "
                                  f"rows={v_rows}: {d} ulp from the plain version")
                    errs["fused_adam"] = max(errs["fused_adam"],
                                             (a.double() - w.double()).abs().max().item())
        print(f"check: fused_adam [{v_rows}, {WIDTH}] fp32/bf16 masters, fp32 and bf16-SR "
              "slots, t=1,7,12345,2^31-1: within 1 ulp of plain, bitwise equal across "
              "launches and with t and lr_t read from device memory; as the row shard from "
              f"global row {ADAM_SHARD_ROW0} (index base "
              f"{adam_ops.index_base((v_rows, WIDTH), GlobalIndex(ADAM_SHARD_ROW0, 0, WIDTH))}) "
              f"bitwise its plain version (max abs err {errs['fused_adam']:.3g})")
    return errs


# --- phase 3b: the DLRM and xDeepFM kernels against their plain versions -----


def interaction_tolerance(x: torch.Tensor, n: int, itself: bool) -> torch.Tensor:
    """|kernel - plain| allowed per output: both sum K products in fp32 in
    other orders, each within K * 2^-24 * sum_k |a_k b_k| of the exact sum."""
    v = x.double().reshape(x.shape[0], n, -1)
    iu, ju = (torch.from_numpy(a).to(x.device) for a in int_ops.pairs(n, itself))
    return 2 * v.shape[2] * FP32_EPS * (v[:, iu].abs() * v[:, ju].abs()).sum(-1)


def cin_tolerance(a, c, w, layout, want, n_terms) -> torch.Tensor:
    """|kernel - plain| allowed per output of the contraction: both sum the
    same rounded products in fp32 in other orders (n_terms each, within
    n * 2^-24 * sum |terms| of the exact sum), plus one bf16 ulp of the
    value when the result is bf16 (the two fp32 sums may round apart)."""
    mag = cin_ops.cin_plain(a.float().abs(), c.float().abs(), w.float().abs(), layout)
    tol = 2 * n_terms * FP32_EPS * mag.double()
    if want.dtype == torch.bfloat16:
        tol = tol + BF16_REL_ULP * want.double().abs()
    return tol


def dw_oracle(x, y, g, layout, block: int = 512):
    """(fp64 sums, fp64 sums of |terms|) of the weight gradient, from the
    products rounded to x's dtype as the kernel rounds them, summed over
    batch blocks of ``block`` rows so the [block, H, M, K] expansion stays
    small at B=8192."""
    xb, yb, gb = (cin_ops._bok(t, layout) for t in (x, y, g))
    exact = mag = 0.0
    for s in range(0, xb.shape[0], block):
        z = cin_ops._expand(xb[s:s + block], yb[s:s + block]).double()
        g64 = gb[s:s + block].double()
        exact = exact + torch.einsum("bhmk,bok->hmo", z, g64)
        mag = mag + torch.einsum("bhmk,bok->hmo", z.abs(), g64.abs())
    return exact, mag


def check_dw(got, x, y, g, layout, label: str) -> tuple[float, float]:
    """Hold one cin_dw result to the fp64 oracle, element by element and as
    a whole; returns (largest absolute error, relative L2 error)."""
    exact, mag = dw_oracle(x, y, g, layout)
    slices, per = cin_ops.dw_slices(x.shape[0] * cin_ops._bok(x, layout).shape[2])
    err = (got.double() - exact).abs()
    # each term goes through one fp32 product and at most per + slices fp32
    # adds in the kernel's order; 2^-23 an operation, as tensor cores may
    # truncate their fp32 adds instead of rounding to nearest
    tol = (per + slices + 1) * 2 * FP32_EPS * mag
    check(bool((err <= tol).all()), f"cin_dw {label}: max err {err.max().item()} beyond "
                                    "its per-element bound")
    rel = (torch.linalg.vector_norm(err) / torch.linalg.vector_norm(exact)).item()
    check(rel <= DW_REL_L2, f"cin_dw {label}: relative L2 error {rel} > {DW_REL_L2}")
    return err.max().item(), rel


# (n, K) of the interaction checks: F fields and a numeric vector appended,
# n off the kernel's 16-row tiles, and the DLRM CLI's default K=4 (8-byte bf16
# vectors: the kernel's element-load staging)
INTERACTION_CASES = ((FIELDS, K), (FIELDS + 1, K), (17, K), (33, K), (FIELDS + 1, 4))
# (B, K) of the CIN checks: the path's K=64 at 1, 2 and 128 dw slices, then
# row counts B*K off dw's 64-row chunk: K=12 (element loads) and K=24 (16-byte
# copies with a partial last chunk)
CIN_CASES = ((37, K), (128, K), (FLAGSHIP_BATCH, K), (37, 12), (37, 24))


def check_zoo_kernels(dev, gen) -> dict:
    errs = {"interaction": 0.0, "cin": 0.0, "cin_dw": 0.0, "cin_dw_rel_l2": 0.0,
            "cin_fp32": 0.0, "cin_dw_fp32": 0.0, "cin_dw_fp32_rel_l2": 0.0,
            "cin_fp32_of_tolerance": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for n, k in INTERACTION_CASES:
            for b in (1, 7, 512, FLAGSHIP_BATCH):
                x = torch.randn(b, n * k, generator=gen).to(dtype).to(dev)
                for itself in (False, True):
                    tol = interaction_tolerance(x, n, itself)
                    for rounded in (False, True):
                        got = int_ops.interact_cuda(x, n, k, itself, rounded)
                        want = int_ops.interact_plain(x, n, k, itself, rounded)
                        torch.cuda.synchronize()
                        check(got.shape == want.shape and got.dtype == torch.float32,
                              f"interaction shape/dtype {tuple(got.shape)} {got.dtype}")
                        err = (got.double() - want.double()).abs()
                        check(bool((err <= tol).all()),
                              f"interaction {dtype} B={b} n={n} K={k} itself={itself} "
                              f"rounded={rounded}: max err {err.max().item()}")
                        errs["interaction"] = max(errs["interaction"], err.max().item())
        print(f"check: interaction {dtype} B=1,7,512,{FLAGSHIP_BATCH} (n, K) in "
              f"{list(INTERACTION_CASES)}, itself both ways, exact and rounded products: "
              f"within tolerance of plain (max abs err so far {errs['interaction']:.3g})")

    rows = slice(0, 512)  # the plain version forms the expansion: compare a slice at B=8192
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "_fp32" if dtype == torch.float32 else ""
        for h in (FIELDS, CIN_O):
            w = (torch.randn(h, FIELDS, CIN_O, generator=gen)
                 * (2.0 / (h * FIELDS + CIN_O)) ** 0.5).to(dtype).to(dev)
            for b, k in CIN_CASES:
                x = torch.randn(b, h, k, generator=gen).to(dtype).to(dev)
                # y as the model hands it over: looked[..., :K] of the fused gather
                y = torch.randn(b, FIELDS, k + 1, generator=gen).to(dtype).to(dev)[..., :k]
                g = torch.randn(b, CIN_O, k, generator=gen).to(dtype).to(dev)
                variants = [("legacy", x, y, g)]
                # [B, K, *] views, as x0 = emb.transpose(1, 2)
                variants.append(("kmajor", *(t.transpose(1, 2) for t in (x, y, g))))
                if k != K:  # K-major memory, as a K-major layer's output and gradient
                    variants.append(("kmajor", *(t.transpose(1, 2).contiguous()
                                                 for t in (x, y, g))))
                for layout, xa, ya, ga in variants:
                    calls = {"forward": (xa, ya, w), "dx": (ga, ya, w.permute(2, 1, 0)),
                             "dy": (ga, xa, w.permute(2, 0, 1))}
                    for name, (a, c, ww) in calls.items():
                        got = cin_ops.cin_cuda(a, c, ww, layout)
                        want = cin_ops.cin_plain(a[rows], c[rows], ww, layout)
                        torch.cuda.synchronize()
                        check(got.dtype == dtype and got.shape[0] == b, "cin shape/dtype")
                        tol = cin_tolerance(a[rows], c[rows], ww, layout, want,
                                            ww.shape[0] * ww.shape[1])
                        err = (got[rows].double() - want.double()).abs()
                        check(bool((err <= tol).all()),
                              f"cin {name} {dtype} {layout} H={h} B={b} K={k}: max err "
                              f"{err.max().item()}")
                        errs["cin" + sfx] = max(errs["cin" + sfx], err.max().item())
                        if sfx:
                            errs["cin_fp32_of_tolerance"] = max(errs["cin_fp32_of_tolerance"],
                                                                (err / tol).max().item())
                    got = cin_ops.cin_dw_cuda(xa, ya, ga, layout)
                    again = cin_ops.cin_dw_cuda(xa, ya, ga, layout)
                    torch.cuda.synchronize()
                    check(got.shape == (h, FIELDS, CIN_O) and got.dtype == torch.float32,
                          "cin_dw shape/dtype")
                    check(same_bits(got, again), f"cin_dw {dtype} {layout} H={h} B={b} K={k}: "
                                                 "two launches differ")
                    err, rel = check_dw(got, xa, ya, ga, layout,
                                        f"{dtype} {layout} H={h} B={b} K={k}")
                    errs["cin_dw" + sfx] = max(errs["cin_dw" + sfx], err)
                    errs["cin_dw" + sfx + "_rel_l2"] = max(errs["cin_dw" + sfx + "_rel_l2"], rel)
        print(f"check: cin {dtype} H={FIELDS},{CIN_O} M={FIELDS} O={CIN_O} (B, K) in "
              f"{list(CIN_CASES)} (rows 0-511 against plain), forward and both transposed-"
              f"weight calls, legacy and K-major strided views (and K-major memory off K=64): "
              f"within tolerance (max abs err "
              f"{errs['cin' + sfx]:.3g}); cin_dw in 1, 2 and 128 slices within its per-element "
              f"fp32 bound and {DW_REL_L2:g} relative L2 of the fp64 oracle, bitwise equal "
              f"across launches (max abs err {errs['cin_dw' + sfx]:.3g}, max relative L2 "
              f"{errs['cin_dw' + sfx + '_rel_l2']:.3g})")
    print(f"check: cin float32 (3xTF32): largest error {errs['cin_fp32_of_tolerance']:.3g} of "
          "its tolerance")
    # a contraction with M > 64 has no mma.sync plan (y's m values would not
    # fit in registers): it takes the tile kernel, in either type
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(37, 8, 12, generator=gen).to(dtype).to(dev)
        y = torch.randn(37, 80, 12, generator=gen).to(dtype).to(dev)
        w = (torch.randn(8, 80, 8, generator=gen) * 0.05).to(dtype).to(dev)
        check(cin_ops.contraction_plan(8, 80, 8) is None
              and cin_ops.contraction_plan_tf32(8, 80, 8) is None,
              "cin: M=80 should take the tile kernel")
        got, want = cin_ops.cin_cuda(x, y, w), cin_ops.cin_plain(x, y, w)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs()
        check(bool((err <= cin_tolerance(x, y, w, "legacy", want, 8 * 80)).all()),
              f"cin {dtype} M=80 (tile kernel): max err {err.max().item()}")
        key = "cin" if dtype == torch.bfloat16 else "cin_fp32"
        errs[key] = max(errs[key], err.max().item())
        print(f"check: cin {dtype} H=8 M=80 O=8 B=37 K=12 (no mma.sync plan: the tile kernel) "
              f"within tolerance (max abs err {err.max().item():.3g})")
    return errs


# --- phase 3c: the sparse fast step's kernels against their plain versions --


def big_feature_set() -> FeatureSet:
    """benchmarks/_ablate_bigtable.py:13-27: the ml-100k schema with user 3M,
    item 2.5M and zipcode 500k hash buckets (6,000,106 ids)."""
    feats = [
        HashFeature("user_id", 3_000_000, dtype="int32"),
        HashFeature("item_id", 2_500_000, dtype="int32"),
        BucketizedFeature("age", tuple(range(15, 66, 10))),
        VocabFeature("gender", ("F", "M"), num_oov_buckets=1),
        HashFeature("occupation", 50),
        HashFeature("zipcode", 500_000, dtype="int32"),
        BucketizedFeature("release_year", tuple(range(1930, 1991, 10))),
    ]
    feats.extend(IdentityFeature(g, 2) for g in GENRE)
    return FeatureSet(categorical=tuple(feats))


def update_rows(ids: torch.Tensor, cap: int, sentinel: int) -> torch.Tensor:
    """[cap] int32: the sorted unique ids (torch.unique, independent of the
    port's dedupe), then ``sentinel`` in the unused slots."""
    uniq = torch.unique(ids.reshape(-1))
    rows = torch.full((cap,), sentinel, dtype=torch.int32, device=ids.device)
    rows[:uniq.numel()] = uniq
    return rows


def check_set_rows(base, rows, vals, v_valid: int, label: str) -> None:
    """The row-set kernel on a copy of ``base`` against the plain version on
    another: bitwise equal, every valid row its val row, every other row
    (untouched, pad, sentinel) the base's."""
    got = dma_ops.scatter_rows_dma_cuda(base.clone(), rows, vals, v_valid=v_valid)
    want = dma_ops.scatter_rows_dma_plain(base.clone(), rows, vals, v_valid=v_valid)
    torch.cuda.synchronize()
    check(same_bits(got, want), f"scatter_rows_dma {label}: kernel != plain bitwise")
    valid = (rows >= 0) & (rows < v_valid)
    idx = rows[valid].long()
    check(same_bits(got[idx], vals[valid]), f"scatter_rows_dma {label}: an updated row is not "
                                            "its val row")
    view = torch.int32 if base.dtype == torch.float32 else torch.int16
    changed = (got.view(view) != base.view(view)).any(1)
    changed[idx] = False
    check(not bool(changed.any()), f"scatter_rows_dma {label}: rows outside the update changed")


def check_fast_kernels(dev, gen) -> dict:
    """The row set at the fast step's full width (25,088 rows into the
    [6,000,640, 128] table and the [.., 256] m|v slab, fp32 and bf16) and at
    narrow widths, and the dedupe's segment sum over a full-width batch."""
    errs = {"scatter_rows_dma": 0.0, "segment_sum": 0.0}
    cgen = torch.Generator(device=dev).manual_seed(int(torch.randint(2**31, (1,), generator=gen)))
    fs = big_feature_set()
    v_rows, v_valid = padded_rows(fs), fs.total_buckets
    ids = torch.from_numpy(random_ids(fs, BIG_BATCH, np.random.default_rng(8))).to(dev)
    cap = sparse_ops.unique_capacity(fs.field_sizes, BIG_BATCH, ids.numel())
    rows = update_rows(ids, cap, v_rows)
    n_valid = int((rows < v_valid).sum())
    for label, width, dtype in (("table", 128, torch.float32), ("m|v", 256, torch.float32),
                                ("m|v", 256, torch.bfloat16)):
        base = torch.randn(v_rows, width, generator=cgen, device=dev).to(dtype)
        vals = torch.randn(cap, width, generator=cgen, device=dev).to(dtype)
        check_set_rows(base, rows, vals, v_valid, f"{label} [{v_rows}, {width}] {dtype}")
        del base, vals
    # narrow widths take the 8-, 4- and 2-byte copies; a row past v_valid, one
    # between v_valid and the slab's end and one far past it are dropped
    small_ids = torch.from_numpy(random_ids(ml_100k_feature_set(), 128,
                                            np.random.default_rng(9))).to(dev)
    small = update_rows(small_ids, 1024, 6144)
    n_small = int((small < 6144).sum())
    small[n_small:n_small + 2] = torch.tensor([4106, 4200], dtype=torch.int32)
    small[-1] = 2**31 - 1
    for width, dtype in ((65, torch.float32), (2, torch.float32), (1, torch.float32),
                         (3, torch.bfloat16), (1, torch.bfloat16)):
        base = torch.randn(6144, width, generator=cgen, device=dev).to(dtype)
        vals = torch.randn(1024, width, generator=cgen, device=dev).to(dtype)
        check_set_rows(base, small, vals, 4106, f"[6144, {width}] {dtype}")
    print(f"check: scatter_rows_dma {cap} rows ({n_valid} valid) into [{v_rows}, 128] fp32 and "
          f"[{v_rows}, 256] fp32 and bf16, and [6144, 65|2|1] fp32, [6144, 3|1] bf16: bitwise "
          "equal to plain, every other row unchanged")

    grads = torch.randn(ids.numel(), 128, generator=cgen, device=dev)
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
    new_run = torch.ones_like(sorted_ids, dtype=torch.bool)
    new_run[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(new_run, 0, dtype=torch.int32) - 1
    got = scatter_ops.segment_sum_cuda(seg, order, grads, cap)
    again = scatter_ops.segment_sum_cuda(seg, order, grads, cap)
    plain = scatter_ops.segment_sum_plain(seg, order, grads, cap)
    exact, mag, count = scatter_oracle(seg, grads[order], cap)
    torch.cuda.synchronize()
    check(got.shape == (cap, 128) and got.dtype == torch.float32, "segment_sum shape/dtype")
    check(same_bits(got, again), "segment_sum: two launches differ")
    tol = scatter_tolerance(mag, count, torch.float32, exact)
    check(bool(((got.double() - exact).abs() <= tol).all()),
          f"segment_sum: max err {(got.double() - exact).abs().max().item()} vs the fp64 oracle")
    check(bool(((plain.double() - exact).abs() <= tol).all()),
          "segment_sum: the plain version is outside the tolerance")
    errs["segment_sum"] = (got.double() - plain.double()).abs().max().item()
    # the dedupe as the fast step runs it: the same rows and bits, launch after launch
    runs = [sparse_ops.dedupe_rows(ids.reshape(-1), grads, v_rows, cap) for _ in range(2)]
    check(torch.equal(runs[0][0], rows) and torch.equal(runs[1][0], rows),
          "dedupe_rows: rows differ from the sorted unique ids")
    check(same_bits(runs[0][1], got) and same_bits(runs[1][1], got),
          "dedupe_rows: sums differ between launches")
    print(f"check: segment_sum (dedupe_rows) R={ids.numel()} W=128 -> [{cap}, 128] within "
          "tolerance of the fp64 oracle, bitwise equal across launches and dedupe runs (max "
          f"|kernel - plain| {errs['segment_sum']:.3g}, max segment {int(count.max())} rows)")
    return errs


# --- phase 3d: the autotuner's kernels against their plain versions ---------


# (B, F, K, extra row stride, std): the bench's and the autotuner's full
# width (the autotuner's v2 is std-1 [TRAIN_BATCH, F*K]) and ragged shapes,
# rows padded so that the 16-byte path (+8) and the scalar path (+1, K=37) run
FLAT_CASES = ((FLAGSHIP_BATCH, FIELDS, K, 0, 0.3), (TRAIN_BATCH, FIELDS, K, 0, 1.0),
              (37, FIELDS, K, 8, 0.3), (37, FIELDS, K, 1, 0.3), (37, 3, 37, 0, 0.3))


def flat_input(b: int, f: int, k: int, pad: int, std: float, dtype, dev,
               gen) -> torch.Tensor:
    """v2 [b, f*k] of normal values with ``std``, in ``dtype`` on ``dev``, as
    a view of rows ``pad`` wider."""
    rows = (torch.randn(b, f * k + pad, generator=gen) * std).to(dtype).to(dev)
    return rows[:, :f * k]


def check_flat_kernels(dev, gen) -> dict:
    """The flat FM forward (out, S) and backward against their plain versions,
    and the scatter at every chunk the autotuner sweeps."""
    errs = {"fm_cross_flat": 0.0, "fm_cross_flat_bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for b, f, k, pad, std in FLAT_CASES:
            v2 = flat_input(b, f, k, pad, std, dtype, dev, gen)
            g = torch.randn(b, generator=gen).to(dev)
            out, s = fm_ops.fm_cross_flat_cuda(v2, f, k)
            want_out, want_s = fm_ops.fm_cross_flat_plain(v2, f, k)
            dv = fm_ops.fm_cross_flat_bwd_cuda(v2, s, g, f, k)
            want_dv = fm_ops.fm_cross_flat_bwd_plain(v2, s, g, f, k)  # the kernel's S
            torch.cuda.synchronize()
            label = f"fm_cross_flat {dtype} B={b} F={f} K={k} row stride {v2.stride(0)}"
            check(out.shape == (b,) and out.dtype == torch.float32, f"{label}: out shape/dtype")
            check(s.shape == (b, k) and s.dtype == dtype, f"{label}: S shape/dtype")
            check(dv.shape == (b, f * k) and dv.dtype == dtype, f"{label}: dv shape/dtype")
            err = (out.double() - want_out.double()).abs()
            check(bool((err <= fm_tolerance(v2.reshape(b, f, k), want_out)).all()),
                  f"{label}: out max err {err.max().item()}")
            # S: fp32 sums of F values in another order, plus one bf16 ulp
            s_tol = FM_BWD_RTOL * v2.double().abs().reshape(b, f, k).sum(1)
            if dtype == torch.bfloat16:
                s_tol = s_tol + BF16_REL_ULP * want_s.double().abs()
            s_err = (s.double() - want_s.double()).abs()
            check(bool((s_err <= s_tol).all()), f"{label}: S max err {s_err.max().item()}")
            # dv from the same S: the same fp32 operations, within one ulp
            d = ulp_distance(dv, want_dv)
            check(d <= 1, f"{label}: dv {d} ulp from the plain version")
            errs["fm_cross_flat"] = max(errs["fm_cross_flat"], err.max().item(),
                                        s_err.max().item())
            errs["fm_cross_flat_bwd"] = max(errs["fm_cross_flat_bwd"],
                                            (dv.double() - want_dv.double()).abs().max().item())
        print(f"check: fm_cross_flat {dtype} forward (out, S) and backward at (B, F, K, "
              f"row pad, std) {FLAT_CASES} within tolerance of plain (max abs err so far: forward "
              f"{errs['fm_cross_flat']:.3g}, backward {errs['fm_cross_flat_bwd']:.3g})")

    rng = np.random.default_rng(6)
    for label, ids, v_rows in scatter_cases(rng):
        ids = ids.to(dev)
        upd = torch.randn(ids.shape[0], WIDTH, generator=gen).to(dev)
        exact, mag, count = scatter_oracle(ids, upd, v_rows)
        tol = scatter_tolerance(mag, count, torch.float32, exact)
        for chunk in SCATTER_CHUNKS:
            got = scatter_ops.scatter_rows_cuda(ids, upd, v_rows, chunk=chunk)
            again = scatter_ops.scatter_rows_cuda(ids, upd, v_rows, chunk=chunk)
            torch.cuda.synchronize()
            check(same_bits(got, again), f"scatter {label} chunk {chunk}: two launches differ")
            err = (got.double() - exact).abs()
            check(bool((err <= tol).all()), f"scatter {label} chunk {chunk}: max err "
                                            f"{err.max().item()} vs the fp64 oracle")
        print(f"check: scatter_rows {label} R={ids.shape[0]} fp32 at chunks {SCATTER_CHUNKS}: "
              "within tolerance of the fp64 oracle, bitwise equal across launches")
    return errs


# --- phase 4: the serving path ----------------------------------------------


def make_export(job_dir: Path, compute_dtype, gen) -> Path:
    cfg = TowerConfig(feature_set=ml_100k_feature_set(), embedding_size=K,
                      hidden_units=(256, 128), compute_dtype=compute_dtype,
                      packed_linear=True, fm_impl="pallas" if compute_dtype else "auto")
    model = DeepFMModel(cfg)
    params = model.init(gen)
    # random linear weights and bias (the initializer's zeros would hide the
    # linear column of the fused gather)
    params["table"][:, K] = torch.randn(params["table"].shape[0], generator=gen) * 0.05
    params["linear"]["b"] = torch.tensor(0.1)
    return export_model(params, model, job_dir, step=1)


def make_zoo_export(job_dir: Path, family: str, compute_dtype, gen) -> Path:
    """A DLRM or xDeepFM export at the flagship widths (K=64, hidden [256, 128])
    from a seeded generator: DLRM with one numeric column through a [64]
    bottom MLP (27 interacting vectors), xDeepFM with CIN (64, 64) and a
    packed table with random linear weights."""
    if family == "dlrm":
        cfg = TowerConfig(feature_set=ml_100k_feature_set(numeric=("action",)),
                          embedding_size=K, hidden_units=(256, 128),
                          compute_dtype=compute_dtype)
        model = DLRMModel(cfg, bot_hidden_units=(64,))
        params = model.init(gen)
    else:
        cfg = TowerConfig(feature_set=ml_100k_feature_set(), embedding_size=K,
                          hidden_units=(256, 128), compute_dtype=compute_dtype,
                          packed_linear=True)
        model = XDeepFMModel(cfg, cin_units=(CIN_O, CIN_O))
        params = model.init(gen)
        params["table"][:, K] = torch.randn(params["table"].shape[0], generator=gen) * 0.05
        params["linear"]["b"] = torch.tensor(0.1)
    return export_model(params, model, job_dir, step=1)


def make_instances(rng, n: int, ragged: bool = False) -> list[dict]:
    """n serving instances. Every instance of a body gives the same keys: the
    seven required features and a few genre flags chosen for the body (the
    other genres are absent and default to 0), the shape the native JSON
    parser takes. ``ragged``: each instance its own genre flags (every third
    none), a body the native parser refuses and json.loads parses."""
    occupations = ["student", "writer", "engineer", "none", "artist", "doctor", "other"]
    body_genres = rng.choice(GENRE, size=int(rng.integers(1, 4)), replace=False)
    out = []
    for i in range(n):
        inst = {
            "user_id": int(rng.integers(1, 944)),
            "item_id": int(rng.integers(1, 1683)),
            "age": int(rng.integers(7, 74)),
            "gender": str(rng.choice(["F", "M", "X"])),
            "occupation": str(rng.choice(occupations)),
            "zipcode": f"{int(rng.integers(0, 100000)):05d}",  # string, leading zeros kept
            "release_year": int(rng.integers(1922, 1999)),
        }
        if not ragged:
            for g in body_genres:
                inst[str(g)] = int(rng.integers(0, 2))
        elif i % 3:  # every third instance has no genre flags at all (they default to 0)
            for g in rng.choice(GENRE, size=int(rng.integers(1, 4)), replace=False):
                inst[str(g)] = 1
        out.append(inst)
    return out


def post(base: str, path: str, body: dict) -> dict:
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        check(r.status == 200, f"{path} returned {r.status}")
        return json.loads(r.read())


def get(base: str, path: str) -> bytes:
    with urllib.request.urlopen(base + path, timeout=120) as r:
        check(r.status == 200, f"{path} returned {r.status}")
        return r.read()


def check_predictions(preds: list, instances: list, ref, label: str, atol, rtol) -> float:
    check(len(preds) == len(instances), f"{label}: {len(preds)} predictions for "
                                        f"{len(instances)} instances")
    logits = np.array([p["logits"] for p in preds], np.float64)
    probs = np.array([p["probabilities"] for p in preds], np.float64)
    check(bool(np.isfinite(logits).all() and np.isfinite(probs).all()), f"{label}: non-finite")
    check(bool(((probs >= 0) & (probs <= 1)).all()), f"{label}: probability outside [0, 1]")
    want = ref.predict(instances_to_columns(instances))
    err = np.abs(logits - want["logits"])
    check(bool((err <= atol + rtol * np.abs(want["logits"])).all()),
          f"{label}: logits differ from the CPU reference by up to {err.max():.3g}")
    return float(err.max())


def serve_and_check(export_dir: Path, label: str, seed: int, latency_sizes,
                    counters=(emb_ops.launches, fm_ops.launches), ref=None,
                    server_kwargs=None, prob_ref=None, kernel_names=()) -> dict:
    """Serve one export on the card, drive /predict, hold it against the CPU
    (``ref``, default a device="cpu" ServingModel of the export); every
    kernel in ``counters`` must be launched by the requests. ``server_kwargs``
    go to make_server (--serialized, --table-quant); ``prob_ref``, a second
    CPU model (the unquantized one of an int8 export), must agree on every
    probability within INT8_PROB_ATOL; ``kernel_names`` must each name a
    kernel of the device trace of one forward."""
    ref = ref or load_model(export_dir, device="cpu")
    httpd, served = make_server(export_dir=str(export_dir), port=0, device="cuda",
                                batch_window_ms=2.0, **(server_kwargs or {}))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(seed)
    atol, rtol = ((BF16_LOGIT_ATOL, BF16_LOGIT_RTOL) if "bf16" in label
                  else (FP32_LOGIT_ATOL, 0.0))
    out = {"max_logit_err": 0.0}
    try:
        for c in counters:
            c.reset()
        bodies = [make_instances(rng, n) for n in (1, 8, 64)]
        for b in bodies:  # the server's parse takes the native path for these bodies
            check(native.parse_json_instances(json.dumps({"instances": b}).encode())
                  is not None, f"{label}: the native parser refused a request body")
        # and json.loads the ragged one
        bodies.append(make_instances(rng, 8, ragged=True))
        check(native.parse_json_instances(json.dumps({"instances": bodies[-1]}).encode())
              is None, f"{label}: the native parser took a body of ragged keys")
        replies = [post(base, "/predict", {"instances": b})["predictions"] for b in bodies]
        # a concurrent burst, which the micro-batcher coalesces
        burst = [make_instances(rng, 8) for _ in range(8)]
        burst_replies = [None] * len(burst)

        def one(i):
            burst_replies[i] = post(base, "/predict", {"instances": burst[i]})["predictions"]

        workers = [threading.Thread(target=one, args=(i,)) for i in range(len(burst))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        check(all(r is not None for r in burst_replies), f"{label}: burst request failed")
        check(get(base, "/healthz") == b"ok", "/healthz")
        metrics = json.loads(get(base, "/metrics"))
        out["launches"] = {c.name: c.value for c in counters}
        out["metrics"] = metrics
        for name, n in out["launches"].items():
            check(n > 0, f"{label}: kernel {name} was not launched on the main path")
        for b, r in zip(bodies + burst, replies + burst_replies):
            out["max_logit_err"] = max(out["max_logit_err"],
                                       check_predictions(r, b, ref, label, atol, rtol))
            if prob_ref is not None:
                probs = np.array([p["probabilities"] for p in r])
                want = prob_ref.predict(instances_to_columns(b))["probabilities"]
                err = float(np.abs(probs - want).max())
                out["max_prob_err_vs_float"] = max(out.get("max_prob_err_vs_float", 0.0), err)
                check(err <= INT8_PROB_ATOL, f"{label}: probabilities {err:.3g} from the "
                                             "unquantized model")
        check(metrics.get("requests_served") == len(bodies) + len(burst),
              f"{label}: /metrics {metrics}")
        out["latency_ms"] = {}
        for n in latency_sizes:
            body = {"instances": make_instances(rng, n)}
            post(base, "/predict", body)
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                post(base, "/predict", body)
                times.append((time.perf_counter() - t0) * 1e3)
            out["latency_ms"][n] = statistics.median(times)
        out["breakdown_ms"] = request_breakdown(served.served, make_instances(rng, 512))
        out["forward_profile"] = profile_forward(served.served, make_instances(rng, 512))
        for name in kernel_names:
            check(any(name in k for k in out["forward_profile"]["kernels"]),
                  f"{label}: no {name} kernel in the forward's trace "
                  f"{out['forward_profile']['kernels']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        served.close()
        thread.join(timeout=30)
    check(not thread.is_alive(), f"{label}: server thread did not stop")
    return out


def request_breakdown(model, instances: list, reps: int = 20) -> dict:
    """Median host-clock ms of each step of one /predict outside HTTP: JSON
    parse to columns and request encode (FarmHash, CPU), each through the
    native host library and through the Python path (json.loads, the Python
    FarmHash), and the forward on the card including the host->device and
    device->host copies. Both encodes give the same model inputs."""
    raw = json.dumps({"instances": instances}).encode()
    steps = {"parse": [], "encode": [], "parse_python": [], "encode_python": [],
             "forward": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        columns, n = parse_request_columns(raw)
        t1 = time.perf_counter()
        batch = model.encode_request(columns)
        t2 = time.perf_counter()
        model.apply_encoded(batch, n)  # ends in a device->host copy: synchronous
        t3 = time.perf_counter()
        py_columns, _ = parse_request_columns(raw, use_native=False)
        t4 = time.perf_counter()
        py_batch = model.encode_request(py_columns, use_native=False)
        t5 = time.perf_counter()
        for k, dt in zip(steps, (t1 - t0, t2 - t1, t4 - t3, t5 - t4, t3 - t2)):
            steps[k].append(dt * 1e3)
    check(np.array_equal(batch["cat_ids"], py_batch["cat_ids"]),
          "the native and the Python request encodes differ")
    return {"instances": len(instances), **{k: statistics.median(v) for k, v in steps.items()}}


def profile_forward(model, instances: list, reps: int = 20) -> dict:
    """Wall ms of one synchronous forward (host clock, profiler off) beside the
    device's busy ms in it (torch.profiler, CUPTI), and the kernels that take
    the most device time. Busy time is the sum of the device-side events'
    times (kernels and copies)."""
    from torch.profiler import ProfilerActivity, profile

    batch = model.encode_request(instances_to_columns(instances))
    n = len(instances)
    model.apply_encoded(batch, n)
    t0 = time.perf_counter()
    for _ in range(reps):
        model.apply_encoded(batch, n)
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            model.apply_encoded(batch, n)
    # device-side events only (kernels, copies): an operator's own entry
    # repeats the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / reps / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return {"instances": n, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if events else None,
            "top_kernels_ms": [(e.key[:60], e.self_device_time_total / reps / 1e3)
                               for e in top],
            "kernels": sorted({e.key[:90] for e in events})}


# --- phase 4b: int8 tables, serialized programs, batch prediction ---------------

# label -> (the kernels a forward must launch, the kernel names its trace must hold)
SERVING_KERNELS = {
    "deep_fm": ((fm_ops.launches,), ("lookup_", "fm_fwd")),
    "dlrm": ((int_ops.launches,), ("lookup_", "interact_kernel")),
    "xdeep_fm": ((cin_ops.launches,), ("lookup_", "cin_")),
}


def _family_kernels(label: str):
    family = label.split("_k64")[0]
    counters, names = SERVING_KERNELS[family]
    if family == "xdeep_fm" and "fp32" in label:
        counters = (cin_ops.launches_fp32,)
    return counters, names


def int8_serving(work: Path, seed: int, exports: dict) -> dict:
    """The DeepFM bf16 and fp32 exports, quantized by the port's CLI
    (``python -m rectpu_torch.serve.quant <dir> --out <dir>``), served over
    HTTP; the fp32 export served with --table-quant int8; the DLRM and
    xDeepFM fp32 exports quantized and served. Each against a device="cpu"
    ServingModel of the same quantized model at the serving tolerances and
    against the unquantized one within INT8_PROB_ATOL; the int8 gather and
    the family's kernel must launch."""
    out = {}
    for label in ("deep_fm_k64_bf16", "deep_fm_k64_fp32", "dlrm_k64_fp32", "xdeep_fm_k64_fp32"):
        dest = work / f"{label}_int8"
        t0 = time.perf_counter()
        quant_cli.main([str(exports[label]), "--out", str(dest)])
        quant_s = time.perf_counter() - t0
        meta = json.loads((dest / "model.json").read_text())
        check(meta["table_quant"] == "int8" and not (dest / PROGRAM).exists(),
              f"{label}: the quantized export {meta}")
        counters, _ = _family_kernels(label)
        res = out[f"{label}_int8"] = serve_and_check(
            dest, f"{label}_int8", seed, (1, 512), (emb_ops.int8_launches, *counters),
            prob_ref=load_model(exports[label], device="cpu"))
        res["quantize_s"] = quant_s
        res["npz_bytes"] = {"float": (exports[label] / "arrays.npz").stat().st_size,
                            "int8": (dest / "arrays.npz").stat().st_size}
    label = "deep_fm_k64_fp32"
    float_ref = load_model(exports[label], device="cpu")
    out[f"{label}_table_quant"] = serve_and_check(
        exports[label], f"{label}_table_quant", seed, (1, 512),
        (emb_ops.int8_launches, fm_ops.launches), ref=quantize_serving(float_ref),
        server_kwargs={"table_quant": "int8"}, prob_ref=float_ref)
    return out


def serialized_serving(work: Path, seed: int, exports: dict) -> dict:
    """Each export's apply.pt2 served with --serialized: its load seconds and
    size, the predictions against the eager model on the CPU at the serving
    tolerances, the family's kernels launched and named in the trace of the
    program's forward."""
    out = {}
    for label in ("deep_fm_k64_bf16", "deep_fm_k64_fp32", "dlrm_k64_bf16", "xdeep_fm_k64_fp32"):
        d = exports[label]
        meta = json.loads((d / "model.json").read_text())
        check(meta.get("serialized_apply_torch") is True and (d / PROGRAM).exists(),
              f"{label}: no program in the export: {meta.get('serialized_apply_torch_error')}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_model(d, use_serialized=True, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        counters, names = _family_kernels(label)
        res = out[f"{label}_serialized"] = serve_and_check(
            d, f"{label}_serialized", seed, (1, 512), (emb_ops.launches, *counters),
            server_kwargs={"use_serialized": True}, kernel_names=names)
        res.update(load_s=load_s, program_bytes=(d / PROGRAM).stat().st_size,
                   npz_bytes=(d / "arrays.npz").stat().st_size)
    return out


def batch_prediction(work: Path, seed: int, export_dir: Path) -> dict:
    """``python -m rectpu_torch.serve.batch_predict --label-col rating`` (its
    main) on a synthetic test CSV with the fp32 DeepFM export, then with
    --table-quant int8: every row written, the AUC in [0, 1], the kernels
    launched, and each prediction equal to the online ServingModel's on the
    card for the same rows (within the fp32 serving tolerance: other batch
    sizes may take other matmul algorithms)."""
    data = work / "bp_data"
    files = write_synthetic_dataset(data, train_rows=1000, test_rows=BP_ROWS, seed=seed)
    with open(files["test"], newline="") as f:
        header = f.readline().strip().split(",")
    columns = read_csv_columns(files["test"], SERVING_REQUIRED + [g for g in GENRE if g in header])
    out = {}
    for tag, flags, counters in (
            ("fp32", (), (emb_ops.launches, fm_ops.launches)),
            ("int8", ("--table-quant", "int8"), (emb_ops.int8_launches, fm_ops.launches))):
        dest = work / f"bp_{tag}.jsonl"
        for c in counters:
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n, metrics = batch_predict_cli.main([
            "--export-dir", str(export_dir), "--input-csv", files["test"], "--output",
            str(dest), "--label-col", "rating", "--batch-size", "4096", *flags])
        seconds = time.perf_counter() - t0
        launches = {c.name: c.value for c in counters}
        for name, k in launches.items():
            check(k > 0, f"batch prediction {tag}: kernel {name} was not launched")
        records = [json.loads(line) for line in open(dest)]
        check(n == len(records) == BP_ROWS, f"batch prediction {tag}: {n} rows, "
                                            f"{len(records)} records")
        check(0.0 <= metrics["auc"] <= 1.0 and metrics["count"] == BP_ROWS,
              f"batch prediction {tag}: metrics {metrics}")
        online = load_model(export_dir, device="cuda")
        if flags:
            online = quantize_serving(online)
        want = online.predict(dict(columns))["logits"]
        got = np.array([r["logits"] for r in records])
        err = float(np.abs(got - want).max())
        check(err <= FP32_LOGIT_ATOL, f"batch prediction {tag}: logits {err:.3g} from the "
                                      "online model")
        out[tag] = {"rows": n, "metrics": metrics, "seconds": seconds,
                    "rows_per_s": n / seconds, "launches": launches, "max_logit_err": err}
    return out


# --- phase 5: the training path (the trainer CLI) -------------------------


# the model flags of the trainer CLI phases: --preset scaled at the flagship widths
SCALED_ARGS = ("--preset", "scaled", "--embedding-size", str(K), "--hidden-units", "256", "128")


def train_cli(work: Path, seed: int, cli=deep_fm_cli, label: str = "deep_fm",
              counters=(emb_ops.launches, fm_ops.launches, fm_ops.bwd_launches,
                        scatter_ops.launches), steps: int = TRAIN_STEPS,
              extra_args: tuple = (), steps_per_loop: int = 10,
              model_args: tuple = SCALED_ARGS) -> dict:
    """Train through a trainer CLI on the card, then serve its export."""
    data_dir = work / "data"
    if not (data_dir / "train.csv").exists():
        write_synthetic_dataset(data_dir, train_rows=100_000, test_rows=10_000, seed=seed)
    job_dir = work / f"train_job_{label}"
    argv = [*model_args,
            "--batch-size", str(TRAIN_BATCH), "--train-steps", str(steps),
            "--save-checkpoints-steps", str(steps), "--steps-per-loop", str(steps_per_loop),
            "--train-csv", str(data_dir / "train.csv"), "--test-csv", str(data_dir / "test.csv"),
            "--job-dir", str(job_dir), "--device", "cuda", "--seed", str(seed), *extra_args]
    args = cli.build_parser().parse_args(argv)
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, trainer = cli.train_and_evaluate(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {c.name: c.total for c in counters}
    losses = trainer.step_losses
    check(len(losses) == steps, f"{label} trainer CLI recorded {len(losses)} step losses")
    check(all(np.isfinite(losses)), f"{label} trainer CLI: a non-finite loss in {losses}")
    head, tail = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(tail < head, f"{label} trainer CLI: loss did not fall (first 10 steps {head:.4f}, "
                       f"last 10 {tail:.4f})")
    auc = metrics["auc"]
    check(bool(np.isfinite(auc)) and 0.0 <= auc <= 1.0, f"{label} trainer CLI: final AUC {auc}")
    for name, n in launches.items():
        check(n > 0, f"{label} trainer CLI: kernel {name} was not launched on the training path")

    export_dir = latest_export(job_dir)
    check(export_dir is not None, "trainer CLI wrote no export")
    httpd, served = make_server(export_dir=str(export_dir), port=0, device="cuda",
                                batch_window_ms=1.0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        instances = make_instances(np.random.default_rng(seed), 1)
        preds = post(f"http://127.0.0.1:{httpd.server_address[1]}", "/predict",
                     {"instances": instances})["predictions"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        served.close()
        thread.join(timeout=30)
    check(not thread.is_alive(), f"{label} trained-export server thread did not stop")
    check(len(preds) == 1 and 0.0 <= preds[0]["probabilities"] <= 1.0
          and np.isfinite(preds[0]["logits"]), f"{label} trained export /predict: {preds}")
    return {"launches": launches, "losses": losses, "loss_first10": head, "loss_last10": tail,
            "metrics": metrics, "seconds": seconds, "export": export_dir.name,
            "predict": preds[0]}


# --- phase 5c: the Linear, DNN and Wide&Deep trainer CLIs --------------------

# --preset scaled without its flat layout, which (as rectpu's lookup_flat)
# takes no lane-padded table, and with the packed table padded to 128 columns
PADDED_ARGS = ("--embedding-size", str(K), "--hidden-units", "256", "128",
               "--compute-dtype", "bfloat16", "--table-grad-dtype", "bfloat16",
               "--scatter-impl", "mxu", "--dropout-impl", "hash", "--packed-linear",
               "--packed-col-pad", "128")
# (label, CLI, model flags): each trains with its default optimizer
FAMILY_CLIS = (("linear", linear_cli, ()),
               ("deep_bf16", deep_cli, SCALED_ARGS),
               ("linear_deep_bf16", linear_deep_cli, SCALED_ARGS),
               ("linear_deep_padded_bf16", linear_deep_cli, PADDED_ARGS))


def family_clis(work: Path, seed: int) -> dict:
    """The three families' trainer CLIs on the card (linear at its defaults,
    the others at the flagship widths), batch 4096, 40 steps, with their
    default optimizers: the lookup and scatter counts must grow; each export
    is then served over HTTP and held against a device="cpu" ServingModel
    of it (the gather's count must grow)."""
    out = {}
    for label, cli, model_args in FAMILY_CLIS:
        res = train_cli(work, seed, cli, label, (emb_ops.launches, scatter_ops.launches),
                        model_args=model_args)
        res["serving"] = serve_and_check(latest_export(work / f"train_job_{label}"), label,
                                         seed, (1, 512), (emb_ops.launches,))
        out[label] = res
    return out


def family_model(family: str, device, gen=None, params=None):
    """DNN or Wide&Deep at --preset scaled's flagship widths on the ml-100k
    table (K=64, [256, 128], bf16 towers and table cotangent, flat layout,
    packed Wide&Deep table with random wide weights), dropout 0."""
    cfg = TowerConfig(feature_set=ml_100k_feature_set(), embedding_size=K,
                      hidden_units=(256, 128), compute_dtype="bfloat16",
                      table_grad_dtype="bfloat16", flat_layout=True, scatter_impl="mxu",
                      table_padding=2048, dropout_impl="hash", packed_linear=True)
    model = DNNModel(cfg) if family == "deep" else WideDeepModel(cfg)
    if params is None:
        params = model.init(gen)
        if family == "linear_deep":
            params["table"][:, K] = torch.randn(params["table"].shape[0], generator=gen) * 0.05
    return load_params(model, params, device)


def check_family_step(family: str, dev, gen, work: Path) -> dict:
    """One train step (forward, backward and the default optimizer's update:
    Adagrad, or FTRL + Adagrad on the packed table's columns) on the card
    against the same step on a CPU copy, same weights and batch: the loss
    within 1e-2 relative, each leaf's update within GRAD_REL_L2 relative L2
    (the updates are smooth in the gradient, which may move by about two bf16
    ulps, as check_flagship_grads allows)."""
    card = family_model(family, dev, gen=gen)
    cpu = family_model(family, "cpu", params=params_tree(card))
    batch = random_batch(ml_100k_feature_set(), np.random.default_rng(4), dev, TRAIN_BATCH)
    out, before, after = {}, params_tree(card), {}
    for name, model, b in (("cuda", card, batch),
                           ("cpu", cpu, {k: v.cpu() for k, v in batch.items()})):
        opt = model.default_optimizer()
        trainer = Trainer(model, opt, None, None, work / f"step_{family}_{name}",
                          TrainConfig(batch_size=TRAIN_BATCH, seed=0),
                          device=next(model.parameters()).device)
        trainer.opt_state = opt.init(flat_params(model))
        out[f"loss_{name}"] = float(trainer.train_step(b, 0))
        out["optimizer"] = opt.name
        after[name] = {k: p.detach().cpu().double() for k, p in flat_params(model).items()}
    check(abs(out["loss_cuda"] - out["loss_cpu"]) <= 1e-2 * abs(out["loss_cpu"]),
          f"{family} step loss card {out['loss_cuda']} vs CPU {out['loss_cpu']}")
    start = {k: p.double() for k, p in flatten_tree(before).items()}
    out["rel_l2"] = {}
    for k, p_cpu in after["cpu"].items():
        d_cpu, d_card = p_cpu - start[k], after["cuda"][k] - start[k]
        rel = float((d_card - d_cpu).norm() / max(d_cpu.norm(), 1e-30))
        out["rel_l2"][k] = rel
        check(rel <= GRAD_REL_L2, f"{family} step update {k}: relative L2 {rel:.3g} card vs CPU")
    return out


# --- phase 5e: the DCN and AutoInt trainer CLIs ------------------------------

# (label, CLI, flags beside SCALED_ARGS, counters): DCN dense through the
# streaming input and the best exporter, DCN on the sparse fast step, AutoInt
ZOO2_CLIS = (
    # csv_windows: the streaming input's windows encoded by the native library
    ("dcn_bf16_streaming_best", dcn_cli, ("--streaming-io", "--exporter", "best"),
     (emb_ops.launches, scatter_ops.launches, csv_bridge.windows)),
    ("dcn_bf16_fast_step", dcn_cli, ("--fast-step", "on", "--sparse-scatter", "dma"),
     (emb_ops.launches, dma_ops.launches, scatter_ops.segment_launches)),
    ("autoint_bf16", autoint_cli, (), (emb_ops.launches, scatter_ops.launches)),
)


def zoo2_clis(work: Path, seed: int) -> dict:
    """The DCN and AutoInt trainer CLIs on the card (--preset scaled, K=64,
    [256, 128], batch 4096, 40 steps in one logging window, Adam): the
    train_cli checks and counts; the event file holds the loss and the final
    eval's eval/auc; the best exporter wrote best_metric.json; each export is
    served over HTTP and held against a device="cpu" ServingModel of it."""
    out = {}
    for label, cli, extra, counters in ZOO2_CLIS:
        res = train_cli(work, seed, cli, label, counters, extra_args=extra,
                        steps_per_loop=TRAIN_STEPS + 10)
        job_dir = work / f"train_job_{label}"
        files = sorted(job_dir.glob("events.out.tfevents.*"))
        check(len(files) == 1, f"{label}: {len(files)} event files in the job dir")
        records = read_events(files[0])
        tags = {t for _, ts in records for t in ts}
        check({"loss", "examples_per_sec", "eval/auc"} <= tags,
              f"{label}: event file tags {sorted(tags)}")
        res["event_records"] = [(step, len(ts)) for step, ts in records]
        if "best" in extra:
            best = json.loads((job_dir / "best_metric.json").read_text())
            check(best["step"] == TRAIN_STEPS and np.isfinite(best["auc"]),
                  f"{label}: best_metric.json {best}")
            res["best_metric"] = best
        res["serving"] = serve_and_check(latest_export(job_dir), label, seed, (1, 512),
                                         (emb_ops.launches,))
        out[label] = res
    return out


AUTOINT_FORMS_ROWS = 64


def autoint_forms(dev, gen) -> dict:
    """AutoInt's three attention forms (the zoo model, bf16) on the card
    against a CPU copy at B=64 (8 groups of 8 for "grouped"): max |logit|
    difference within the bf16 serving tolerance."""
    out = {}
    batch = random_batch(bench_feature_set(), np.random.default_rng(9), dev, AUTOINT_FORMS_ROWS)
    for impl in ("broadcast", "bf16", "grouped"):
        card = zoo_model("autoint", 0.0, dev, gen=gen, att_impl=impl)
        cpu = zoo_model("autoint", 0.0, "cpu", params=params_tree(card), att_impl=impl)
        with torch.no_grad():
            got = card(batch["cat_ids"], batch["num_vals"]).double().cpu()
            want = cpu(batch["cat_ids"].cpu(), batch["num_vals"].cpu()).double()
        err = (got - want).abs()
        check(bool(torch.isfinite(got).all()) and bool(
            (err <= BF16_LOGIT_ATOL + BF16_LOGIT_RTOL * want.abs()).all()),
              f"autoint {impl}: logits card vs CPU differ by up to {float(err.max()):.3g}")
        out[impl] = float(err.max())
    return out


# --- check (3): the reference-default DeepFM run on the synthetic ml-100k -------

CHECK3_PIN_AUC, CHECK3_GATE = 0.8124665, 0.002  # rectpu's pin (RESULTS.md:1640), BASELINE.md


def check3_default_run(work: Path, seed: int = 42) -> dict:
    """Check (3)(b) of ROADMAP.md: the DeepFM trainer CLI at the reference
    defaults (K=4, [16, 16], dropout 0.1, batch 32, Adam 1e-3, 20,000 steps,
    an eval every 60 s) on the card, on the data of ``python -m
    rectpu_torch.data.ml_100k local --synthetic`` (90,570 / 9,057 rows), at
    ``--seed 42``: the final streaming AUC beside rectpu's pin and the wall
    time. The seed spread (sd 0.0035 over seeds) is wider than the 0.002
    gate, so the gap is reported; the AUC must be finite and above 0.5."""
    ml_100k_etl.local_main(argparse.Namespace(synthetic=True, dest=str(work / "ml100k"),
                                              synthetic_rows=90570))
    data = work / "ml100k" / "ml-100k"
    args = deep_fm_cli.build_parser().parse_args(
        ["--train-csv", str(data / "train.csv"), "--test-csv", str(data / "test.csv"),
         "--job-dir", str(work / "check3"), "--device", "cuda", "--seed", str(seed)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, trainer = deep_fm_cli.train_and_evaluate(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    auc = metrics["auc"]
    check(bool(np.isfinite(auc)) and 0.5 < auc < 1.0, f"check (3): AUC {auc}")
    check(len(trainer.step_losses) == args.train_steps, "check (3): steps recorded")
    return {"auc": auc, "pin": CHECK3_PIN_AUC, "gap": auc - CHECK3_PIN_AUC,
            "within_gate": abs(auc - CHECK3_PIN_AUC) <= CHECK3_GATE, "seconds": seconds,
            "steps": args.train_steps, "seed": seed, "metrics": metrics}


# --- phase 5f: the dispatch modes, scan (a CUDA graph of the step) against pipelined ---

PARITY_STEPS, PARITY_LOOP = 120, 50  # loops of 50, 50 and a ragged 20
# the flagship and the fast step: 40 steps, the warm-up loop (with the
# capture), one timed loop, one profiled loop
DISPATCH_LOOPS = (10, 10, 20)
FAMILY_DISPATCH_BATCH, FAMILY_DISPATCH_STEPS = 512, 20
# aten ops a step that the host issues in a scan loop: the copies into the
# fixed buffers, once a loop (the replays issue none)
SCAN_HOST_OPS_MAX = 10
# (label, CLI, model flags) of the families' scan-against-pipelined runs
# (the streaming run stages its batches from the host: scan's stacked copies)
FAMILY_DISPATCH = (("dlrm", dlrm_cli, SCALED_ARGS), ("xdeep_fm", xdeep_fm_cli, SCALED_ARGS),
                   ("linear", linear_cli, ()), ("deep", deep_cli, SCALED_ARGS),
                   ("linear_deep", linear_deep_cli, SCALED_ARGS),
                   ("linear_streaming", linear_cli, ("--streaming-io",)))


def _tensor_leaves(tree, prefix: str = ""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensor_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensor_leaves(v, f"{prefix}/{i}")


def check_same_training(runs: dict, label: str) -> int:
    """Scan against pipelined, bit for bit: every step's loss, every
    parameter and every optimizer-state leaf. ``runs``: mode -> (losses,
    trainer). Returns the number of leaves compared."""
    (la, a), (lb, b) = runs["scan"], runs["pipelined"]
    check(len(la) == len(lb) and la == lb,
          f"{label}: scan's losses differ from pipelined's at steps "
          f"{[i for i, (x, y) in enumerate(zip(la, lb)) if x != y][:5]}")
    pa, pb = flat_params(a.model), flat_params(b.model)
    sa, sb = dict(_tensor_leaves(a.opt_state)), dict(_tensor_leaves(b.opt_state))
    check(pa.keys() == pb.keys() and sa.keys() == sb.keys(), f"{label}: different trees")
    bad = [k for k in pa if not torch.equal(pa[k].detach(), pb[k].detach())]
    bad += [k for k in sa if not torch.equal(sa[k], sb[k])]
    check(not bad, f"{label}: scan differs from pipelined in {bad[:6]}")
    return len(pa) + len(sa)


def drive_loops(trainer: Trainer, loops, counters, device_trace: bool = True) -> dict:
    """The trainer's train loop in its dispatch mode (``loop_runner``) over
    loops of ``loops`` steps from step 0, on its resident train set: the
    first loop warms up (under scan: eager steps, then the capture), the
    middle ones are timed on the host clock to the losses on the host, the
    last one is profiled (the host alone without ``device_trace``). Returns
    the losses, the wall ms a step, the device's busy ms a step, the host's
    aten ops a step, the top kernels and the launches that ran
    (``LaunchCount.total``: replays included)."""
    from torch.profiler import ProfilerActivity, profile

    resident = trainer._resident()
    batches = trainer._host_batches(None, resident)
    run = trainer.loop_runner(resident)
    for c in counters:
        c.reset()
    step, losses, timed_s, timed_steps = 0, [], 0.0, 0
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if device_trace else []))
    for i, k in enumerate(loops):
        last = i == len(loops) - 1
        torch.cuda.synchronize()
        if last:
            prof.start()
        t0 = time.perf_counter()
        out, _ = run(batches, step, k)
        vals = out.cpu().tolist()
        seconds = time.perf_counter() - t0
        if last:
            torch.cuda.synchronize()
            prof.stop()
        elif i > 0:
            timed_s, timed_steps = timed_s + seconds, timed_steps + k
        losses += vals
        step += k
    batches.close()
    torch.cuda.synchronize()
    k = loops[-1]
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    ops = [e for e in averages if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")]
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    graph = trainer.step_graph
    return {"losses": losses, "wall_ms": 1e3 * timed_s / timed_steps,
            "busy_ms": (sum(e.self_device_time_total for e in events) / k / 1e3
                        if events else None),
            "device_launches": sum(e.count for e in events) / k,
            "host_aten_ops": sum(e.count for e in ops) / k,
            "top_kernels_ms": [(e.key[:48], round(e.self_device_time_total / k / 1e3, 4))
                               for e in top],
            "top_host_ops": [(e.key, round(e.count / k, 2))
                             for e in sorted(ops, key=lambda e: e.count, reverse=True)[:6]],
            "launches": {c.name: c.total for c in counters},
            "replays": graph.replays if graph is not None else 0,
            "segments": len(graph.graphs) if graph is not None else 0,
            "collectives": len(graph.collectives) if graph is not None else 0,
            "per_replay": ({c.name: n for c, n in graph.per_replay}
                           if graph is not None else {})}


def dispatch_pair(label: str, make_trainer, loops, counters) -> dict:
    """``make_trainer(mode)`` (a Trainer with its weights and optimizer state
    set, the same each call) driven by ``drive_loops`` in pipelined then scan
    dispatch: bitwise equal, the same launches of every kernel, the scan
    step a CUDA graph replayed every step after the warm-up."""
    runs, out = {}, {}
    for mode in ("pipelined", "scan"):
        trainer = make_trainer(mode)
        check(trainer.dispatch == mode, f"{label}: the trainer dispatches {trainer.dispatch}")
        res = drive_loops(trainer, loops, counters)
        runs[mode] = (res.pop("losses"), trainer)
        out[mode] = res
    check(all(np.isfinite(runs["scan"][0])), f"{label}: a non-finite loss")
    out["leaves_compared"] = check_same_training(runs, label)
    scan, pipe = out["scan"], out["pipelined"]
    check(scan["replays"] == sum(loops) - WARMUP_STEPS,
          f"{label}: {scan['replays']} graph replays for {sum(loops)} steps")
    check(scan["launches"] == pipe["launches"] and all(n > 0 for n in scan["launches"].values()),
          f"{label}: launches under scan {scan['launches']} vs pipelined {pipe['launches']}")
    check(scan["host_aten_ops"] <= SCAN_HOST_OPS_MAX,
          f"{label}: {scan['host_aten_ops']} host aten ops a step under scan")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cli_in_mode(cli, args, mode: str):
    """``cli.train_and_evaluate(args)`` with the Trainer's dispatch set to
    ``mode`` (the CLIs take no dispatch flag, as rectpu's: "auto")."""
    build = trainers_common.build_trainer

    def build_in_mode(*a, **kw):
        trainer = build(*a, **kw)
        trainer.config.dispatch_mode = mode
        return trainer

    trainers_common.build_trainer = build_in_mode
    try:
        return cli.train_and_evaluate(args)
    finally:
        trainers_common.build_trainer = build


def cli_pair(cli, work: Path, label: str, argv, profile_dir: Path | None = None) -> dict:
    """One trainer CLI run (``train_and_evaluate``) in each mode, the same
    flags and seed: bitwise equal in every loss, leaf and eval metric; the
    scan run optionally with ``--profile-dir``."""
    runs, out = {}, {}
    for mode in ("pipelined", "scan"):
        args = cli.build_parser().parse_args(
            ["--train-csv", str(work / "data" / "train.csv"),
             "--test-csv", str(work / "data" / "test.csv"), "--job-dir",
             str(work / f"dispatch_{label}_{mode}"), "--device", "cuda",
             "--save-checkpoints-steps", "1000000", *map(str, argv)])
        if mode == "scan" and profile_dir is not None:
            args.profile_dir = str(profile_dir)
        metrics, trainer = cli_in_mode(cli, args, mode)
        check(trainer.dispatch == mode, f"{label}: the CLI dispatched {trainer.dispatch}")
        runs[mode] = (trainer.step_losses, trainer)
        out[f"metrics_{mode}"] = metrics
    out["leaves_compared"] = check_same_training(runs, label)
    check(out["metrics_scan"] == out["metrics_pipelined"],
          f"{label}: eval {out['metrics_scan']} vs {out['metrics_pipelined']}")
    graph = runs["scan"][1].step_graph
    out["replays"], out["per_replay"] = graph.replays, {c.name: n for c, n in graph.per_replay}
    check(graph.captured and graph.replays == len(runs["scan"][0]) - WARMUP_STEPS,
          f"{label}: {graph.replays} replays")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dispatch_phase(work: Path, seed: int) -> dict:
    """Phase 5f (module docstring): scan against pipelined on the card."""
    dev = torch.device("cuda", 0)
    out = {}
    # the parity config (the reference defaults: K=4 [16, 16], dropout 0.1,
    # batch 32, Adam 1e-3) through the DeepFM CLI, both dropout impls, 120
    # steps in loops of 50, 50 and 20 with a checkpoint, eval and export
    # after each of the first two; the scan run traces its second loop
    argv = ("--train-steps", PARITY_STEPS, "--steps-per-loop", PARITY_LOOP, "--seed", seed,
            "--save-checkpoints-steps", PARITY_LOOP)
    for impl in ("hash", "threefry"):
        prof_dir = work / f"dispatch_profile_{impl}"
        res = out[f"parity_cli_{impl}"] = cli_pair(deep_fm_cli, work, f"parity_{impl}",
                                                   (*argv, "--dropout-impl", impl), prof_dir)
        traces = sorted(prof_dir.glob("*.pt.trace.json"))
        check(len(traces) == 1, f"parity {impl}: --profile-dir under scan wrote {len(traces)}")
        text = traces[0].read_text()
        res["trace_kernels"] = [n for n in ("lookup_", "fm_fwd", "fm_bwd", "scatter")
                                if n in text]
        check(len(res["trace_kernels"]) == 4,
              f"parity {impl}: the scan window's trace names {res['trace_kernels']}")
    # the same config driven loop by loop for its times
    fs = ml_100k_feature_set()
    data = CsvDataset(str(work / "data" / "train.csv"), fs)

    def parity(mode):
        model = DeepFMModel(TowerConfig(feature_set=fs, embedding_size=4, hidden_units=(16, 16),
                                        dropout=0.1, dropout_impl="hash"))
        load_params(model, model.init(torch.Generator().manual_seed(seed)), dev)
        trainer = Trainer(model, adam(1e-3), data, None, work / f"dispatch_parity_{mode}",
                          TrainConfig(batch_size=32, steps_per_loop=PARITY_LOOP, seed=seed,
                                      dispatch_mode=mode), device=dev)
        trainer.opt_state = trainer.optimizer.init(flat_params(model))
        return trainer

    out["parity"] = dispatch_pair("parity", parity, (PARITY_LOOP, PARITY_LOOP, 20),
                                  (emb_ops.launches, fm_ops.launches, fm_ops.bwd_launches,
                                   scatter_ops.launches))
    # the flagship step (bench.py's: fused Adam on the table, bf16 m, bf16-SR v)
    gen = torch.Generator().manual_seed(seed)
    p0 = params_tree(flagship_model(0.1, dev, gen=gen))  # host copies
    rng = np.random.default_rng(seed + 5)
    rows = sum(DISPATCH_LOOPS) * FLAGSHIP_BATCH
    data = CsvDataset.from_arrays(random_ids(bench_feature_set(), rows, rng),
                                  (rng.random(rows) < 0.2).astype(np.float32))

    def flagship(mode):
        trainer = flagship_trainer(flagship_model(0.1, dev, params=p0), work, train_ds=data)
        trainer.config.dispatch_mode = mode
        return trainer

    out["flagship"] = dispatch_pair("flagship", flagship, DISPATCH_LOOPS,
                                    (emb_ops.launches, fm_ops.launches, fm_ops.bwd_launches,
                                     scatter_ops.launches, adam_ops.launches))
    del p0, data
    # the full-width fast step (threefry dropout: the graph's generators)
    fs = big_feature_set()
    p0 = params_tree(fast_model(fs, 0.1, dev, seed))
    rows = sum(DISPATCH_LOOPS) * BIG_BATCH
    data = CsvDataset.from_arrays(random_ids(fs, rows, rng),
                                  (rng.random(rows) < 0.2).astype(np.float32))

    def fast(mode):
        model = fast_model(fs, 0.1, dev, params=p0)
        step = make_sparse_step(model, learning_rate=1e-3, scatter_backend="dma")
        trainer = Trainer(model, adam(1e-3), data, None, work / f"dispatch_fast_{mode}",
                          TrainConfig(batch_size=BIG_BATCH, seed=0, dispatch_mode=mode,
                                      steps_per_loop=max(DISPATCH_LOOPS)),
                          device=dev, fast_step=step)
        trainer.opt_state = step[0](flat_params(model))
        return trainer

    out["fast_step"] = dispatch_pair("fast_step", fast, DISPATCH_LOOPS,
                                     (emb_ops.launches, fm_ops.launches, fm_ops.bwd_launches,
                                      scatter_ops.segment_launches, dma_ops.launches))
    del p0, data
    gc.collect()
    torch.cuda.empty_cache()
    # the families through their CLIs at batch 512, default optimizers
    for label, cli, model_args in FAMILY_DISPATCH:
        out[f"family_{label}"] = cli_pair(
            cli, work, label, (*model_args, "--batch-size", FAMILY_DISPATCH_BATCH,
                               "--train-steps", FAMILY_DISPATCH_STEPS, "--steps-per-loop", 10,
                               "--seed", seed))
    # under a plan on the card "auto" follows rectpu's batch rule (phase 8f
    # runs the sharded scans)
    plan = types.SimpleNamespace(mesh=types.SimpleNamespace(device=dev), lookup_fn=None,
                                 batch_index=0, batch_shards=1, tp_mlp=False)
    model = DeepFMModel(TowerConfig(feature_set=ml_100k_feature_set()))
    out["plan_auto"] = {b: Trainer(model, adam(1e-3), None, None, work / "dispatch_plan",
                                   TrainConfig(batch_size=b), plan=plan).dispatch
                        for b in (32, 2047, 2048, 4096)}
    check(out["plan_auto"] == {32: "scan", 2047: "scan", 2048: "pipelined", 4096: "pipelined"},
          f"auto under a plan on the card: {out['plan_auto']}")
    return out


# --- phase 5b: --autotune and --profile-dir through the trainer CLI --------


class LogLines(logging.Handler):
    """The messages logged under the port's root logger while attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def autotune_pins() -> list[tuple[dict, dict]]:
    """(pin dict, a copy of it) for every pin the autotuner may set."""
    pins = (fm_ops._FLAT_AUTO, int_ops._INTERACT_AUTO, scatter_ops._AUTO_CHUNK)
    return [(p, dict(p)) for p in pins]


def autotune_cli(work: Path, seed: int) -> dict:
    """The DeepFM trainer CLI with --autotune and --profile-dir: the
    autotuner launches the flat FM kernels at the trainer's shapes and logs
    its picks; the second logging window is traced and the trace names the
    FM kernels of fm.cu that the flat-layout step runs. The pins are put back
    afterwards, so that later phases run as before."""
    prof_dir = work / "profile"
    saved = autotune_pins()
    log = LogLines()
    root = logging.getLogger("rectpu_torch")
    root.addHandler(log)
    try:
        res = train_cli(work, seed, deep_fm_cli, "deep_fm_autotune",
                        (emb_ops.launches, fm_ops.launches, fm_ops.bwd_launches,
                         scatter_ops.launches, fm_ops.flat_launches, fm_ops.flat_bwd_launches),
                        steps=AUTOTUNE_CLI_STEPS, steps_per_loop=AUTOTUNE_CLI_LOOP,
                        extra_args=("--autotune", "--profile-dir", str(prof_dir)))
    finally:
        root.removeHandler(log)
        for pin, copy in saved:
            pin.clear()
            pin.update(copy)
    picks = [m for m in log.lines if m.startswith("autotune on cuda:")]
    check(len(picks) == 1, f"the autotuner logged {len(picks)} pick lines, not 1")
    check(any(m.startswith("profile trace written to") for m in log.lines),
          "the trainer logged no profile trace")
    traces = sorted(prof_dir.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"--profile-dir holds {len(traces)} traces, not 1")
    text = traces[0].read_text()
    for name in ("fm_fwd_kernel", "fm_bwd_kernel"):
        check(name in text, f"the profile trace does not name fm.cu's {name}")
    res["autotune_log"] = picks[0]
    res["trace"] = {"file": traces[0].name, "bytes": len(text),
                    "fm_kernels": [n for n in ("fm_fwd_kernel", "fm_bwd_kernel",
                                               "fm_flat_fwd_kernel", "fm_flat_bwd_kernel")
                                   if n in text]}
    return res


# --- phase 6: the flagship step ---------------------------------------------


def flagship_model(dropout: float, device, gen=None, params=None,
                   flat_layout: bool = True) -> DeepFMModel:
    """bench.py's model (bench.py:83-111), from ``params`` or a fresh seeded
    init with random linear weights; ``flat_layout`` False: its [B, F, K+1]
    lookup (the unflattened EP exchanges under a plan)."""
    cfg = TowerConfig(feature_set=bench_feature_set(), embedding_size=K,
                      hidden_units=(256, 128), dropout=dropout, compute_dtype="bfloat16",
                      packed_linear=True, table_grad_dtype="bfloat16", flat_layout=flat_layout,
                      scatter_impl="mxu", table_padding=2048, dropout_impl="hash")
    model = DeepFMModel(cfg)
    if params is None:
        params = model.init(gen)
        params["table"][:, K] = torch.randn(params["table"].shape[0], generator=gen) * 0.05
    return load_params(model, params, device)


def flagship_trainer(model, work: Path, plan=None, train_ds=None, eval_ds=None) -> Trainer:
    opt = adam(learning_rate=1e-3, slot_dtype={"m": torch.bfloat16, "v": BF16_SR},
               fused_leaves=("table",))
    trainer = Trainer(model, opt, train_ds, eval_ds, work / "flagship",
                      TrainConfig(batch_size=FLAGSHIP_BATCH, seed=0),
                      device=next(model.parameters()).device, plan=plan)
    trainer.opt_state = opt.init(flat_params(model))
    return trainer


def random_batch(fs: FeatureSet, rng, dev, rows: int) -> dict:
    """[rows, F] uniform ids per field, no numeric features, 20 % positives."""
    return {"cat_ids": torch.from_numpy(random_ids(fs, rows, rng)).to(dev),
            "num_vals": torch.zeros(rows, 0, device=dev),
            "labels": torch.from_numpy((rng.random(rows) < 0.2).astype(np.float32)).to(dev)}


def flagship_batch(rng, dev, rows: int | None = None) -> dict:
    return random_batch(bench_feature_set(), rng, dev, rows or FLAGSHIP_BATCH)


def flagship_step(dev, gen, work: Path) -> dict:
    """bench.py's step on the card: median step time, launches per step."""
    model = flagship_model(0.1, dev, gen=gen)
    trainer = flagship_trainer(model, work)
    rng = np.random.default_rng(2)
    batches = [flagship_batch(rng, dev) for _ in range(4)]
    for i in range(3):  # warm-up: builds nothing new, fills the allocator
        trainer.train_step(batches[i % 4], i)
    torch.cuda.synchronize()
    counters = (emb_ops.launches, fm_ops.launches, fm_ops.bwd_launches, scatter_ops.launches,
                adam_ops.launches)
    for c in counters:
        c.reset()
    times, losses = [], []
    for i in range(FLAGSHIP_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step(batches[i % 4], 3 + i))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = {c.name: c.value for c in counters}
    losses = torch.stack(losses).float().cpu().tolist()
    check(all(np.isfinite(losses)), f"flagship step: non-finite loss {losses}")
    check(launches["fused_adam"] > 0, "flagship step: the fused Adam kernel was not launched")
    for name, n in launches.items():
        check(n > 0, f"flagship step: kernel {name} was not launched")
    profile = profile_step(trainer, batches[0])
    ms = statistics.median(times)
    return {"step_ms": ms, "examples_per_s": FLAGSHIP_BATCH / (ms / 1e3),
            "launches": launches,
            "launches_per_step": {k: v / FLAGSHIP_STEPS for k, v in launches.items()},
            "losses": losses, "profile": profile}


def profile_step(trainer, batch, reps: int = 5) -> dict:
    """Device busy ms in one flagship step (torch.profiler), the device ms of
    the CIN, lookup, FM-forward and FM-backward kernels and of elementwise
    copies, and the top device kernels by time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            trainer.train_step(batch, 1000 + i)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / reps / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    # the host side: operators by their own CPU time, and how many there are
    ops = [e for e in averages if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")]
    host = sorted(ops, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    def named(*parts: str) -> float:
        return sum(e.self_device_time_total for e in events
                   if any(p in e.key for p in parts)) / reps / 1e3

    return {"device_busy_ms": busy if events else None,
            "cin_device_ms": named("cin"),
            "lookup_device_ms": named("lookup_"), "fm_fwd_device_ms": named("fm_fwd_"),
            "fm_bwd_device_ms": named("fm_bwd_kernel"),
            # elementwise copies and casts (the table's cast to the compute type among them)
            "copy_device_ms": named("copy_kernel", "elementwise_kernel"),
            "device_launches": sum(e.count for e in events) / reps,
            "top_kernels_ms": [(e.key[:60], e.self_device_time_total / reps / 1e3)
                               for e in top],
            "host_aten_ops": sum(e.count for e in ops) / reps,
            "top_host_ops_ms": [(e.key, e.count // reps, e.self_cpu_time_total / reps / 1e3)
                                for e in host]}


def check_flagship_grads(dev, gen, work: Path) -> dict:
    """One step's gradients on the card against a CPU copy of the port, same
    weights, same batch, dropout 0. Both sides round the bf16 towers, but
    cuBLAS and the CPU sum the bf16 matmuls in other orders, so an
    activation may land one bf16 ulp apart and move the gradients behind
    it; the check is a relative L2 distance per leaf (GRAD_REL_L2) and the
    loss within 1e-2 relative."""
    card = flagship_model(0.0, dev, gen=gen)
    cpu = flagship_model(0.0, "cpu", params=params_tree(card))
    batch = flagship_batch(np.random.default_rng(3), dev)
    return grads_card_vs_cpu(card, cpu, batch, lambda m: flagship_trainer(m, work), "flagship")


def grads_card_vs_cpu(card, cpu, batch: dict, make_trainer, label: str,
                      rel_l2: float = GRAD_REL_L2) -> dict:
    """Loss and gradients of one step of the same model on the card and on
    the CPU (the plain versions), held to ``rel_l2`` per leaf."""
    out = {}
    grads = {}
    for name, model, b in (("cuda", card, batch),
                           ("cpu", cpu, {k: v.cpu() for k, v in batch.items()})):
        trainer = make_trainer(model)
        for p in flat_params(model).values():
            p.grad = None
        loss = trainer.loss(b, train=True, step=0)
        loss.backward()
        out[f"loss_{name}"] = float(loss.detach())
        grads[name] = {k: p.grad.detach().cpu().double() for k, p in flat_params(model).items()}
    check(abs(out["loss_cuda"] - out["loss_cpu"]) <= 1e-2 * abs(out["loss_cpu"]),
          f"{label} loss card {out['loss_cuda']} vs CPU {out['loss_cpu']}")
    out["rel_l2"] = {}
    for k, g_cpu in grads["cpu"].items():
        g_card = grads["cuda"][k]
        rel = float((g_card - g_cpu).norm() / max(g_cpu.norm(), 1e-30))
        out["rel_l2"][k] = rel
        check(rel <= rel_l2, f"{label} grad {k}: relative L2 {rel:.3g} card vs CPU")
    return out


# --- phase 6b: the DLRM and xDeepFM zoo steps --------------------------------


# the zoo's model families (benchmarks/_bench_zoo.py:82-119): DCN with two
# full-rank cross layers or two of rank 256, AutoInt with 2 layers of 2 heads
ZOO_FAMILIES = {"dlrm": DLRMModel, "xdeep_fm": XDeepFMModel,
                "dcn": lambda cfg: DCNModel(cfg, num_cross_layers=2),
                "dcn_low_rank": lambda cfg: DCNModel(cfg, num_cross_layers=2, low_rank=256),
                "autoint": lambda cfg, att_impl="broadcast": AutoIntModel(
                    cfg, num_layers=2, num_heads=2, att_impl=att_impl)}
PACKED_ZOO = ("xdeep_fm", "autoint")  # the families with a packed linear column


def zoo_model(family: str, dropout: float, device, gen=None, params=None, fp32=False,
              **model_kwargs):
    """The scaled zoo configuration of benchmarks/_bench_zoo.py:79-119 (the
    310k-row hashed table, K=64, [256, 128], bf16 towers and table
    cotangent, flat layout, DLRM's [64] bottom MLP, xDeepFM's CIN (64, 64)
    with a packed table, DCN's cross layers or AutoInt's attention with a
    packed table), from ``params`` or a fresh seeded init; with ``fp32``,
    fp32 towers and table cotangent (the trainer CLIs' default).
    ``model_kwargs`` go to the family's constructor (AutoInt's ``att_impl``)."""
    cfg = TowerConfig(feature_set=bench_feature_set(), embedding_size=K,
                      hidden_units=(256, 128), dropout=dropout,
                      compute_dtype=None if fp32 else "bfloat16",
                      table_grad_dtype=None if fp32 else "bfloat16", flat_layout=True,
                      scatter_impl="mxu",
                      table_padding=2048, packed_linear=family in PACKED_ZOO)
    model = ZOO_FAMILIES[family](cfg, **model_kwargs)
    if params is None:
        params = model.init(gen)
        if family in PACKED_ZOO:
            params["table"][:, K] = torch.randn(params["table"].shape[0], generator=gen) * 0.05
    return load_params(model, params, device)


def zoo_trainer(model, work: Path, batch: int, fp32=False) -> Trainer:
    """The zoo's optimizer: Adam with bf16 m and stochastically rounded bf16 v
    (with ``fp32``, fp32 slots)."""
    slots = None if fp32 else {"m": torch.bfloat16, "v": BF16_SR}
    opt = adam(learning_rate=1e-3, slot_dtype=slots)
    device = next(model.parameters()).device
    tag = "_fp32" if fp32 else ""
    trainer = Trainer(model, opt, None, None, work / f"zoo_{model.name}{tag}_{device.type}",
                      TrainConfig(batch_size=batch, seed=0), device=device)
    trainer.opt_state = opt.init(flat_params(model))
    return trainer


def zoo_counters(family: str, fp32=False) -> tuple:
    if family == "dlrm":
        own = (int_ops.launches,)
    elif family != "xdeep_fm":  # DCN and AutoInt: the gather and the scatter alone
        own = ()
    elif fp32:
        own = (cin_ops.launches_fp32, cin_ops.dw_launches_fp32)
    else:
        own = (cin_ops.launches, cin_ops.dw_launches)
    return (emb_ops.launches, *own, scatter_ops.launches)


def zoo_step(family: str, dev, gen, work: Path, fp32=False) -> dict:
    """The zoo step on the card: median step time, launches per step, the
    device's busy time (and the CIN kernels' share of it)."""
    trainer = zoo_trainer(zoo_model(family, 0.1, dev, gen=gen, fp32=fp32), work,
                          FLAGSHIP_BATCH, fp32)
    rng = np.random.default_rng(6)
    batches = [flagship_batch(rng, dev) for _ in range(4)]
    for i in range(3):
        trainer.train_step(batches[i % 4], i)
    torch.cuda.synchronize()
    counters = zoo_counters(family, fp32)
    for c in counters:
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(ZOO_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step(batches[i % 4], 3 + i))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = {c.name: c.value for c in counters}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses).float().cpu().tolist()
    check(all(np.isfinite(losses)), f"{family} zoo step: non-finite loss {losses}")
    for name, n in launches.items():
        check(n > 0, f"{family} zoo step: kernel {name} was not launched")
    profile = profile_step(trainer, batches[0])
    ms = statistics.median(times)
    out = {"step_ms": ms, "examples_per_s": FLAGSHIP_BATCH / (ms / 1e3), "launches": launches,
           "launches_per_step": {k: v / ZOO_STEPS for k, v in launches.items()},
           "losses": losses, "profile": profile, "peak_mem_gib": peak_gib}
    if family.startswith("dcn"):
        out["cross"] = time_cross_layers(trainer.model)
    return out


def time_cross_layers(model) -> dict:
    """CUDA-event ms of a DCN model's cross layers, forward and backward, on
    a [8192, D] bf16 x0 (the zoo step's): each layer's products are fp32
    GEMMs of bf16 values (x W, or (x V) U^T); bound by their operations at
    the fp32 rate."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.randn(FLAGSHIP_BATCH, model.d, device=dev, generator=gen).to(torch.bfloat16)
    x0.requires_grad_(True)
    g = torch.randn(FLAGSHIP_BATCH, model.d, device=dev, generator=gen).to(torch.bfloat16)

    def fwd_bwd():
        x = x0
        for layer in model.cross:
            x = model._cross(layer, x0, x)
        x.backward(g)

    ms = event_ms(fwd_bwd, iters=10)
    for p in model.parameters():
        p.grad = None
    x0.grad = None
    # forward x W (or x V, then xV U^T); backward twice that (dx and dW)
    inner = model.d if model.low_rank is None else 2 * model.low_rank
    flops = 3 * 2 * FLAGSHIP_BATCH * model.d * inner * len(model.cross)
    return {"ms": ms, "flops": flops, "bound_ms": flops / FP32_FLOPS * 1e3}


def check_zoo_grads(family: str, dev, gen, work: Path, rows: int, fp32=False) -> dict:
    """One step's gradients on the card against a CPU copy of the port, same
    weights, same ``rows``-row batch, dropout 0 (see check_flagship_grads);
    in fp32 held to FP32_GRAD_REL_L2."""
    card = zoo_model(family, 0.0, dev, gen=gen, fp32=fp32)
    cpu = zoo_model(family, 0.0, "cpu", params=params_tree(card), fp32=fp32)
    batch = flagship_batch(np.random.default_rng(7), dev, rows=rows)
    return grads_card_vs_cpu(card, cpu, batch, lambda m: zoo_trainer(m, work, rows, fp32),
                             family + (" fp32" if fp32 else ""),
                             FP32_GRAD_REL_L2 if fp32 else GRAD_REL_L2)


# --- phase 6c: the sparse fast step at full width --------------------------


def fast_model(fs: FeatureSet, dropout: float, device, seed: int = 0, params=None,
               dropout_impl: str = "threefry"):
    """benchmarks/_ablate_bigtable.py:78-96's model (``run_sparse(packed=True,
    scatter_backend="dma")``): DeepFM K=64 [256, 128], bf16 towers, one
    packed table lane-padded to 128 columns, table_padding 2048; from
    ``params`` or random weights made on ``device`` from ``seed`` (K columns
    N(0, 1/K), the linear column N(0, 0.05^2), zero pad, glorot MLP)."""
    cfg = TowerConfig(feature_set=fs, embedding_size=K, hidden_units=(256, 128),
                      dropout=dropout, compute_dtype="bfloat16", table_padding=2048,
                      packed_linear=True, packed_col_pad=128, dropout_impl=dropout_impl)
    model = DeepFMModel(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        table = torch.zeros(cfg.padded_buckets, 128, device=device)
        table[:, :K] = torch.randn(cfg.padded_buckets, K, generator=gen, device=device) * K ** -0.5
        table[:, K] = torch.randn(cfg.padded_buckets, generator=gen, device=device) * 0.05
        params = {"table": table, "linear": {"b": torch.zeros(())},
                  "mlp": init_mlp(torch.Generator().manual_seed(seed), cfg.num_fields * K,
                                  cfg.hidden_units)}
    return load_params(model, params, device)


def fast_trainer(model, work: Path, batch: int) -> Trainer:
    """A Trainer on the sparse fast step with the dma row set, as
    ``--fast-step on --sparse-scatter dma`` builds it (fp32 m|v slab)."""
    fast = make_sparse_step(model, learning_rate=1e-3, scatter_backend="dma")
    device = next(model.parameters()).device
    trainer = Trainer(model, adam(learning_rate=1e-3), None, None, work / f"fast_{device.type}",
                      TrainConfig(batch_size=batch, seed=0), device=device, fast_step=fast)
    trainer.opt_state = fast[0](flat_params(model))
    return trainer


def touched_rows(ids: torch.Tensor, v_rows: int) -> torch.Tensor:
    touched = torch.zeros(v_rows, dtype=torch.bool, device=ids.device)
    touched[ids.reshape(-1).long()] = True
    return touched


def fast_counters() -> tuple:
    return (emb_ops.launches, fm_ops.launches, fm_ops.bwd_launches,
            scatter_ops.segment_launches, dma_ops.launches, scatter_ops.launches)


def fast_step_full_width(dev, seed: int, work: Path) -> dict:
    """The fast step at full width on the card: untouched table rows bitwise
    unchanged by a step, then the median of BIG_STEPS steps, launches per
    step (the row set twice: table and m|v) and the device's busy time."""
    fs = big_feature_set()
    v_rows = padded_rows(fs)
    model = fast_model(fs, 0.1, dev, seed)
    trainer = fast_trainer(model, work, BIG_BATCH)
    mv = trainer.opt_state["mv_sparse"]["table"]
    check(tuple(model.table.shape) == (v_rows, 128) and tuple(mv.shape) == (v_rows, 256)
          and mv.dtype == torch.float32, f"fast step: table {tuple(model.table.shape)}, m|v "
                                         f"{tuple(mv.shape)} {mv.dtype}")
    cap = sparse_ops.unique_capacity(fs.field_sizes, BIG_BATCH, BIG_BATCH * fs.num_fields)
    rng = np.random.default_rng(2)
    batches = [random_batch(fs, rng, dev, BIG_BATCH) for _ in range(4)]
    for i in range(3):  # warm-up
        trainer.train_step(batches[i % 4], i)
    before = model.table.detach().clone()
    trainer.train_step(batches[3], 3)
    changed = (model.table.detach().view(torch.int32) != before.view(torch.int32)).any(1)
    touched = touched_rows(batches[3]["cat_ids"], v_rows)
    n_changed, n_touched = int(changed.sum()), int(touched.sum())
    check(not bool(changed[~touched].any()), "fast step: a row outside the batch changed")
    check(n_changed >= 0.99 * n_touched, f"fast step: {n_changed} of {n_touched} touched rows "
                                         "changed")
    del before, changed, touched
    torch.cuda.synchronize()
    counters = fast_counters()
    for c in counters:
        c.reset()
    times, losses = [], []
    for i in range(BIG_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step(batches[i % 4], 4 + i))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = {c.name: c.value for c in counters}
    losses = torch.stack(losses).float().cpu().tolist()
    check(all(np.isfinite(losses)), f"fast step: non-finite loss {losses}")
    check(launches["scatter_rows_dma"] == 2 * BIG_STEPS,
          f"fast step: {launches['scatter_rows_dma']} row-set launches in {BIG_STEPS} steps")
    check(launches["scatter_rows"] == 0, "fast step: a dense table gradient was built")
    for name, n in launches.items():
        check(n > 0 or name == "scatter_rows", f"fast step: kernel {name} was not launched")
    profile = profile_step(trainer, batches[0])
    ms = statistics.median(times)
    busy = profile["device_busy_ms"]
    return {"step_ms": ms, "step_ms_all": times, "examples_per_s": BIG_BATCH / (ms / 1e3),
            "launches": launches,
            "launches_per_step": {k: v / BIG_STEPS for k, v in launches.items()},
            "losses": losses, "profile": profile, "v_rows": v_rows, "capacity": cap,
            "device_busy_share": None if busy is None else busy / ms,
            "rows_changed_by_a_step": n_changed, "rows_touched_by_a_step": n_touched}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def check_fast_step_vs_cpu(dev, seed: int, work: Path) -> dict:
    """One fast step on the card against a CPU copy of the port at bench.py's
    flagship table (311,296 rows), same weights and batch, dropout 0: the
    loss within 1e-2 relative; the table's update on the touched rows within
    FAST_UPDATE_REL_L2 relative L2; m (0.1 g on step 1) of the m|v rows and
    of every other leaf within GRAD_REL_L2, v within twice that; untouched
    rows unchanged and their m|v zero on both sides."""
    fs = bench_feature_set()
    card = fast_model(fs, 0.0, dev, seed)
    cpu = fast_model(fs, 0.0, "cpu", params=params_tree(card))
    batch = random_batch(fs, np.random.default_rng(3), dev, BIG_BATCH)
    res = {}
    for name, model, b in (("cuda", card, batch),
                           ("cpu", cpu, {k: v.cpu() for k, v in batch.items()})):
        trainer = fast_trainer(model, work, BIG_BATCH)
        # a copy: on the CPU the parameter's storage, which the step updates in place
        before = model.table.detach().cpu().clone()
        loss = float(trainer.train_step(b, 0))
        state = trainer.opt_state
        res[name] = (loss, before, model.table.detach().cpu(),
                     state["mv_sparse"]["table"].detach().cpu(),
                     {f"{mv} {k}": t.detach().cpu() for mv in ("m", "v")
                      for k, t in state[mv]["rest"].items()})
    out = {"loss_cuda": res["cuda"][0], "loss_cpu": res["cpu"][0], "rel_l2": {}}
    check(abs(out["loss_cuda"] - out["loss_cpu"]) <= 1e-2 * abs(out["loss_cpu"]),
          f"fast step loss card {out['loss_cuda']} vs CPU {out['loss_cpu']}")
    touched = touched_rows(batch["cat_ids"].cpu(), card.table.shape[0])
    for name in ("cuda", "cpu"):
        _, before, after, mv, _ = res[name]
        check(same_bits(after[~touched], before[~touched]),
              f"fast step ({name}): an untouched table row changed")
        check(not bool(mv[~touched].any()), f"fast step ({name}): untouched m|v rows not zero")
    before = res["cpu"][1][touched].double()
    check(bool((res["cpu"][2][touched].double() != before).any(1).all()),
          "fast step (cpu): a touched table row did not move")
    rel = rel_l2(res["cuda"][2][touched].double() - before,
                 res["cpu"][2][touched].double() - before)
    out["rel_l2"]["update table"] = rel
    check(rel <= FAST_UPDATE_REL_L2, f"fast step table update: relative L2 {rel:.3g} card "
                                     "vs CPU")
    mv_card, mv_cpu = res["cuda"][3][touched], res["cpu"][3][touched]
    pairs = {"m table": (mv_card[:, :K + 1], mv_cpu[:, :K + 1]),
             "v table": (mv_card[:, 128:128 + K + 1], mv_cpu[:, 128:128 + K + 1])}
    pairs.update({k: (t, res["cpu"][4][k]) for k, t in res["cuda"][4].items()})
    for key, (a, b) in pairs.items():
        rel = rel_l2(a, b)
        out["rel_l2"][key] = rel
        limit = GRAD_REL_L2 if key.startswith("m ") else 2 * GRAD_REL_L2
        check(rel <= limit, f"fast step {key}: relative L2 {rel:.3g} card vs CPU")
    return out


# --- phase 7: times ---------------------------------------------------------


def time_kernels(dev, gen) -> tuple[float, list[dict]]:
    """(floor, rows): the floor is the same timing of a one-element add, the
    least any launch reads by this method; rows time each kernel."""
    flush = torch.ones(64 * 2**20 // 4, dtype=torch.float32, device=dev)  # > 50 MB L2
    one = torch.zeros(1, device=dev)
    floor = event_ms(lambda: one.add_(1.0), None)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.empty((), dtype=dtype).element_size()
        table = (torch.randn(V_ROWS, WIDTH, generator=gen) * 0.1).to(dtype).to(dev)
        for b in (512, 4096):
            ids = torch.randint(0, V_ROWS, (b, FIELDS), generator=gen,
                                dtype=torch.int32).to(dev)
            ids_long = ids.reshape(-1).long()
            n = b * FIELDS
            nbytes = n * 4 + V_ROWS * WIDTH * es + n * WIDTH * es
            rows.append({
                "name": "embedding_lookup", "dtype": str(dtype).split(".")[-1], "batch": b,
                "ms": event_ms(lambda: emb_ops.lookup_cuda(table, ids), flush),
                "warm_ms": event_ms(lambda: emb_ops.lookup_cuda(table, ids), None),
                "plain_ms": event_ms(lambda: emb_ops.lookup_take(table, ids), flush),
                "library_ms": event_ms(lambda: torch.index_select(table, 0, ids_long), flush),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            })
            looked = (torch.randn(b, FIELDS, K + 1, generator=gen) * 0.3).to(dtype).to(dev)
            v = looked[..., :K]
            ms_b, by = bound(b * FIELDS * K * es + b * es, 3 * b * FIELDS * K)
            rows.append({
                "name": "fm_cross", "dtype": str(dtype).split(".")[-1], "batch": b,
                "ms": event_ms(lambda: fm_ops.fm_cross_cuda(v), flush),
                "warm_ms": event_ms(lambda: fm_ops.fm_cross_cuda(v), None),
                "plain_ms": event_ms(lambda: fm_ops.fm_cross_xla(v), flush),
                "library_ms": None, "bound_ms": ms_b, "bound_by": by,
            })
    rows.append(time_int8_lookup(dev, gen, flush))
    # the flagship step's: its bf16 gather, the logit in fp32; the fast
    # step's: looked[..., :64] of its 128-column fp32 rows (the bound counts
    # the K used columns, read once)
    b = FLAGSHIP_BATCH
    flagship = (torch.randn(b, FIELDS, K + 1, generator=gen) * 0.3).to(torch.bfloat16).to(dev)
    fast = (torch.randn(b, FIELDS, 2 * K, generator=gen) * 0.3).to(dev)
    for v, out_dtype, dtype, shape in (
            (flagship[..., :K], torch.float32, "bfloat16->float32", "flagship"),
            (fast[..., :K], None, "float32", f"fast step [{b}, {FIELDS}, {2 * K}][..., :{K}]")):
        ms_b, by = bound(v.numel() * v.element_size() + b * 4, 3 * v.numel())
        rows.append({
            "name": "fm_cross", "dtype": dtype, "batch": b, "shape": shape,
            "ms": event_ms(lambda: fm_ops.fm_cross_cuda(v, out_dtype), flush),
            "warm_ms": event_ms(lambda: fm_ops.fm_cross_cuda(v, out_dtype), None),
            "plain_ms": event_ms(lambda: fm_ops.fm_cross_xla(v, out_dtype), flush),
            "library_ms": None, "bound_ms": ms_b, "bound_by": by,
        })
    return floor, rows


def time_int8_lookup(dev, gen, flush, b: int = 4096) -> dict:
    """The int8 gather at the int8 DeepFM serving shape: the packed [4224, 65]
    int8 table and its scales, 4096 x 26 ids, bf16 out (the bf16 export's
    compute dtype). Beside it: the plain version (dequant_take), the
    four-op PyTorch composite (index_select of the rows and of the scales, a
    cast, a multiply, then the cast to bf16), and the fp32 gather of the same
    rows from the float table rounded to bf16 (the unquantized export's)."""
    table = torch.randn(V_ROWS, WIDTH, generator=gen) * 0.1
    q, s = (torch.from_numpy(a).to(dev) for a in quant_cli.quantize_rows(table))
    table = table.to(dev)
    ids = torch.randint(0, V_ROWS, (b, FIELDS), generator=gen, dtype=torch.int32).to(dev)
    ids_long, bf16 = ids.reshape(-1).long(), torch.bfloat16

    def composite():
        return (q.index_select(0, ids_long).float()
                * s.index_select(0, ids_long)[:, None]).to(bf16)

    n = ids.numel()
    # ids read once, each distinct row's int8 values and scale read once, out written once
    ms_b, by = bound(n * 4 + torch.unique(ids).numel() * (WIDTH + 4) + n * WIDTH * 2, 0)
    return {"name": "embedding_lookup_int8", "dtype": "int8->bfloat16", "batch": b,
            "shape": f"[{V_ROWS}, {WIDTH}] int8",
            "ms": event_ms(lambda: emb_ops.dequant_lookup_cuda(q, s, ids, bf16), flush),
            "warm_ms": event_ms(lambda: emb_ops.dequant_lookup_cuda(q, s, ids, bf16), None),
            "plain_ms": event_ms(lambda: emb_ops.dequant_take(q, s, ids, bf16), flush),
            "composite_ms": event_ms(composite, flush),
            "fp32_gather_ms": event_ms(lambda: emb_ops.lookup_cuda(table, ids, bf16), flush),
            "library_ms": None, "bound_ms": ms_b, "bound_by": by}


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple[float, str]:
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over ``peak`` operations per second (default: the fp32 rate)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_fused_lookup(dev, gen, ids: torch.Tensor, v_rows: int, flush) -> dict:
    """The flagship step's gather: its fp32 [v_rows, 65] table gathered as
    bf16 at B=8192 x 26 ids, rounded in the kernel; beside it the route of
    earlier trees, the whole table cast to bf16 and then gathered (the time
    of a tree whose kernel does not round is that route's)."""
    table = torch.randn(v_rows, WIDTH, generator=gen).to(dev)
    n, bf16 = ids.numel(), torch.bfloat16
    ids_long = ids.long()

    def cast_then_gather():
        return emb_ops.lookup_cuda(table.to(bf16), ids)

    fused = "out_dtype" in inspect.signature(emb_ops.lookup_cuda).parameters
    # the rows read: each distinct row of these ids once
    ms_b, by = bound(n * 4 + torch.unique(ids).numel() * WIDTH * 4 + n * WIDTH * 2, 0)
    row = {"name": "embedding_lookup", "dtype": "float32->bfloat16", "batch": FLAGSHIP_BATCH,
           "shape": f"flagship [{v_rows}, {WIDTH}]",
           "route": "rounded in the kernel" if fused else "cast, then the kernel",
           "ms": event_ms((lambda: emb_ops.lookup_cuda(table, ids, bf16)) if fused
                          else cast_then_gather, flush),
           "cast_then_gather_ms": event_ms(cast_then_gather, flush),
           "plain_ms": event_ms(lambda: emb_ops.lookup_take(table, ids).to(bf16), flush),
           "library_ms": event_ms(lambda: torch.index_select(table, 0, ids_long).to(bf16), flush),
           "library": "index_select, then .to(bfloat16)", "bound_ms": ms_b, "bound_by": by}
    row["warm_ms"] = event_ms((lambda: emb_ops.lookup_cuda(table, ids, bf16)) if fused
                              else cast_then_gather, None)
    return row


def time_train_kernels(dev, gen) -> list[dict]:
    """CUDA-event times of the training kernels at the path's shapes."""
    flush = torch.ones(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(4)
    rows = []
    for label, fs, batch in (("ml100k", ml_100k_feature_set(), TRAIN_BATCH),
                             ("flagship", bench_feature_set(), FLAGSHIP_BATCH)):
        v_rows = padded_rows(fs)
        ids = torch.from_numpy(random_ids(fs, batch, rng).reshape(-1)).to(dev)
        ids_long = ids.long()
        n = ids.shape[0]
        if label == "flagship":
            rows.append(time_fused_lookup(dev, gen, ids, v_rows, flush))
        for dtype in (torch.bfloat16, torch.float32):
            es = torch.empty((), dtype=dtype).element_size()
            upd = torch.randn(n, WIDTH, generator=gen).to(dtype).to(dev)
            zeros = torch.zeros(v_rows, WIDTH, dtype=dtype, device=dev)
            ms_b, by = bound(n * 4 + n * WIDTH * es + v_rows * WIDTH * es, n * WIDTH)
            rows.append({
                "name": "scatter_rows", "dtype": str(dtype).split(".")[-1], "shape": label,
                "v_rows": v_rows, "updates": n,
                "ms": event_ms(lambda: scatter_ops.scatter_rows_cuda(ids, upd, v_rows), flush),
                "warm_ms": event_ms(lambda: scatter_ops.scatter_rows_cuda(ids, upd, v_rows), None),
                "plain_ms": event_ms(lambda: scatter_ops.scatter_rows_plain(ids, upd, v_rows),
                                     flush),
                "library_ms": event_ms(lambda: torch.index_add(zeros, 0, ids_long, upd), flush),
                "bound_ms": ms_b, "bound_by": by,
            })
            looked = (torch.randn(batch, FIELDS, K + 1, generator=gen) * 0.3).to(dtype).to(dev)
            v = looked[..., :K]
            g = torch.randn(batch, generator=gen).to(dev)
            ms_b, by = bound(2 * batch * FIELDS * K * es + batch * 4, 3 * batch * FIELDS * K)
            rows.append({
                "name": "fm_cross_bwd", "dtype": str(dtype).split(".")[-1], "shape": label,
                "batch": batch,
                "ms": event_ms(lambda: fm_ops.fm_cross_bwd_cuda(v, g), flush),
                "warm_ms": event_ms(lambda: fm_ops.fm_cross_bwd_cuda(v, g), None),
                "plain_ms": event_ms(lambda: fm_ops.fm_cross_bwd_xla(v, g), flush),
                "library_ms": None, "bound_ms": ms_b, "bound_by": by,
            })
        for p_dt, m_dt, v_dt, g_dt in ((torch.float32, torch.bfloat16, torch.bfloat16,
                                        torch.bfloat16),
                                       (torch.float32, torch.float32, torch.float32,
                                        torch.float32)):
            p = torch.randn(v_rows, WIDTH, generator=gen).to(p_dt).to(dev)
            m = (torch.randn(v_rows, WIDTH, generator=gen) * 0.1).to(m_dt).to(dev)
            vv = (torch.rand(v_rows, WIDTH, generator=gen) * 0.01).to(v_dt).to(dev)
            gg = torch.randn(v_rows, WIDTH, generator=gen).to(g_dt).to(dev)
            sr = v_dt == torch.bfloat16
            kw = dict(lr=1e-3, v_sr=sr)
            es = sum(torch.empty((), dtype=d).element_size() for d in (p_dt, m_dt, v_dt))
            es_g = torch.empty((), dtype=g_dt).element_size()
            nel = v_rows * WIDTH
            ms_b, by = bound(nel * (2 * es + es_g), 12 * nel)
            rows.append({
                "name": "fused_adam", "dtype": "m bf16, v bf16-SR" if sr else "fp32 slots",
                "shape": label, "v_rows": v_rows,
                "ms": event_ms(lambda: adam_ops.fused_adam_cuda(p, m, vv, gg, 7, **kw), flush),
                "warm_ms": event_ms(lambda: adam_ops.fused_adam_cuda(p, m, vv, gg, 7, **kw), None),
                # a rank's shard: the rounding keyed from a nonzero index base
                "index_ms": event_ms(lambda: adam_ops.fused_adam_cuda(
                    p, m, vv, gg, 7, index=GlobalIndex(ADAM_SHARD_ROW0, 0, WIDTH), **kw), flush),
                "plain_ms": event_ms(lambda: adam_ops.fused_adam_plain(p, m, vv, gg, 7, **kw),
                                     flush, iters=10),
                "library_ms": None, "bound_ms": ms_b, "bound_by": by,
            })
    return rows


def time_zoo_kernels(dev, gen) -> list[dict]:
    """CUDA-event times of the DLRM and xDeepFM kernels at the zoo step's
    shapes (B=8192, K=64: the interaction over 26 fields, the CIN's two
    layers and their weight gradients)."""
    flush = torch.ones(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    b = FLAGSHIP_BATCH
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.empty((), dtype=dtype).element_size()
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        name = str(dtype).split(".")[-1]
        x = torch.randn(b, FIELDS * K, generator=gen).to(dtype).to(dev)
        v3 = x.reshape(b, FIELDS, K)
        p = int_ops.num_pairs(FIELDS, False)
        ms_b, by = bound(b * FIELDS * K * es + b * p * 4, 2 * b * p * K)
        library_ms = event_ms(lambda: torch.bmm(v3, v3.transpose(1, 2)), flush)
        # rounded products (the zoo step's and the CLI's "auto"), then exact
        # (DLRM serving and the autotuner's "pallas")
        for rounded in (True, False):
            rows.append({
                "name": "interaction", "dtype": name, "batch": b,
                "mode": "rounded" if rounded else "exact", "shape": f"F={FIELDS} K={K}",
                "ms": event_ms(lambda: int_ops.interact_cuda(x, FIELDS, K, False, rounded),
                               flush),
                "warm_ms": event_ms(lambda: int_ops.interact_cuda(x, FIELDS, K, False, rounded),
                                    None),
                "plain_ms": event_ms(lambda: int_ops.interact_plain(x, FIELDS, K, False, rounded),
                                     flush, iters=10),
                "library_ms": library_ms,
                "library": "torch.bmm forming the full z (a superset of the work)",
                "bound_ms": ms_b, "bound_by": by,
            })
        for h in (FIELDS, CIN_O):  # layer 1 (x = x0) and layer 2 of CIN (64, 64)
            xx = torch.randn(b, h, K, generator=gen).to(dtype).to(dev)
            yy = torch.randn(b, FIELDS, K, generator=gen).to(dtype).to(dev)
            w = (torch.randn(h, FIELDS, CIN_O, generator=gen) * 0.05).to(dtype).to(dev)
            gg = torch.randn(b, CIN_O, K, generator=gen).to(dtype).to(dev)
            flops = 2 * b * K * h * FIELDS * CIN_O
            # the step's three contraction calls of this layer: the forward,
            # then dx = cin(g, y, w^(2,1,0)) and dy = cin(g, x, w^(2,0,1)),
            # whose (H', M', O') differ from it
            calls = [("", xx, yy, w), (" dx", gg, yy, w.permute(2, 1, 0)),
                     (" dy", gg, xx, w.permute(2, 0, 1))]
            for call, a, c, ww in calls:
                out_numel = b * ww.shape[2] * K
                nbytes = (a.numel() + c.numel() + ww.numel() + out_numel) * es
                ms_b, by = bound(nbytes, flops, peak)
                # fp32 on the tensor cores as 3xTF32: the bound of that route
                tf32 = {} if dtype == torch.bfloat16 else {
                    "bound_3xtf32_ms": bound(nbytes, flops, TF32X3_FLOPS)[0]}
                rows.append({
                    "name": "cin", "dtype": name, "batch": b, "shape": f"H={h}{call}",
                    "call": f"(H', M', O') = {tuple(ww.shape)}",
                    "ms": event_ms(lambda: cin_ops.cin_cuda(a, c, ww), flush),
                    "warm_ms": event_ms(lambda: cin_ops.cin_cuda(a, c, ww), None),
                    "plain_ms": event_ms(lambda: cin_ops.cin_plain(a, c, ww), flush, iters=3),
                    "library_ms": event_ms(lambda: torch.einsum("bhk,bmk,hmo->bok", a, c, ww),
                                           flush, iters=10),
                    "library": "torch.einsum of the same contraction",
                    "bound_ms": ms_b, "bound_by": by, **tf32,
                })
            nbytes = (xx.numel() + yy.numel() + gg.numel()) * es + h * FIELDS * CIN_O * 4
            ms_b, by = bound(nbytes, flops, peak)
            tf32 = {} if dtype == torch.bfloat16 else {
                "bound_3xtf32_ms": bound(nbytes, flops, TF32X3_FLOPS)[0]}
            rows.append({
                "name": "cin_dw", "dtype": name, "batch": b, "shape": f"H={h}",
                "ms": event_ms(lambda: cin_ops.cin_dw_cuda(xx, yy, gg), flush),
                "warm_ms": event_ms(lambda: cin_ops.cin_dw_cuda(xx, yy, gg), None),
                "plain_ms": event_ms(lambda: cin_ops.cin_dw_plain(xx, yy, gg), flush, iters=3),
                "library_ms": event_ms(lambda: torch.einsum("bhk,bmk,bok->hmo", xx, yy, gg),
                                       flush, iters=10),
                "library": "torch.einsum of the same contraction",
                "bound_ms": ms_b, "bound_by": by, **tf32,
            })
            # y as the model hands it over (looked[..., :K], rows K+1 apart),
            # which the wrapper copies into 16-byte runs
            ys = torch.cat([yy, yy[..., :1]], dim=2)[..., :K]
            rows.append({
                "name": "cin_dw", "dtype": name, "batch": b, "shape": f"H={h} y=looked[..., :K]",
                "ms": event_ms(lambda: cin_ops.cin_dw_cuda(xx, ys, gg), flush),
                "warm_ms": event_ms(lambda: cin_ops.cin_dw_cuda(xx, ys, gg), None),
                "plain_ms": event_ms(lambda: cin_ops.cin_dw_plain(xx, ys, gg), flush, iters=3),
                "library_ms": event_ms(lambda: torch.einsum("bhk,bmk,bok->hmo", xx, ys, gg),
                                       flush, iters=10),
                "library": "torch.einsum of the same contraction",
                "bound_ms": ms_b, "bound_by": by, **tf32,
            })
    return rows


def time_fast_kernels(dev, gen) -> list[dict]:
    """CUDA-event times at the fast step's full width: the row set into the
    [6,000,640, 128] table and the [.., 256] m|v slab (fp32, and bf16 for a
    bf16 slab), the dedupe's segment sum, and (as "times" rows with no kernel
    of their own) the whole dedupe and the lazy-Adam row update."""
    flush = torch.ones(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    cgen = torch.Generator(device=dev).manual_seed(int(torch.randint(2**31, (1,), generator=gen)))
    fs = big_feature_set()
    v_rows, v_valid = padded_rows(fs), fs.total_buckets
    ids = torch.from_numpy(random_ids(fs, BIG_BATCH, np.random.default_rng(10))).to(dev)
    cap = sparse_ops.unique_capacity(fs.field_sizes, BIG_BATCH, ids.numel())
    rows = update_rows(ids, cap, v_rows)
    valid = rows < v_valid
    n_valid, idx = int(valid.sum()), rows[valid].long()
    out = []
    for label, width, dtype in (("table C=128", 128, torch.float32),
                                ("m|v C=256", 256, torch.float32),
                                ("m|v C=256", 256, torch.bfloat16)):
        es = torch.empty((), dtype=dtype).element_size()
        slab = torch.randn(v_rows, width, generator=cgen, device=dev).to(dtype)
        vals = torch.randn(cap, width, generator=cgen, device=dev).to(dtype)
        kept = vals[valid]
        ms_b, by = bound(cap * 4 + 2 * n_valid * width * es, 0)
        out.append({
            "name": "scatter_rows_dma", "dtype": str(dtype).split(".")[-1], "shape": label,
            "v_rows": v_rows, "updates": cap, "valid_updates": n_valid,
            "ms": event_ms(lambda: dma_ops.scatter_rows_dma_cuda(slab, rows, vals,
                                                                 v_valid=v_valid), flush),
            "warm_ms": event_ms(lambda: dma_ops.scatter_rows_dma_cuda(slab, rows, vals,
                                                                      v_valid=v_valid), None),
            "plain_ms": event_ms(lambda: dma_ops.scatter_rows_dma_plain(slab, rows, vals,
                                                                        v_valid=v_valid), flush),
            "library_ms": event_ms(lambda: slab.index_copy_(0, idx, kept), flush),
            "library": "index_copy_ of the valid rows", "bound_ms": ms_b, "bound_by": by,
        })
        del slab, vals, kept

    # the fast step's three gathers: the batch's rows of the table, then the
    # lazy-Adam rows of the table and of the m|v slab at the deduplicated ids
    table = torch.randn(v_rows, 128, generator=cgen, device=dev)
    mv = torch.randn(v_rows, 256, generator=cgen, device=dev)
    # the rows read: each distinct row of the batch once (the update rows are
    # distinct already)
    n_batch = torch.unique(ids).numel()
    for label, src, at, n_read in (("batch rows of the table [.., 128]", table, ids, n_batch),
                                   ("update rows of the table [.., 128]", table, rows, n_valid),
                                   ("update rows of m|v [.., 256]", mv, rows, n_valid)):
        width = src.shape[1]
        at_long = at.reshape(-1).long().clamp(max=v_rows - 1)
        ms_b, by = bound(at.numel() * 4 + n_read * width * 4 + at.numel() * width * 4, 0)
        out.append({
            "name": "embedding_lookup", "dtype": "float32", "shape": f"fast step: {label}",
            "v_rows": v_rows, "updates": at.numel(),
            "ms": event_ms(lambda: emb_ops.lookup_cuda(src, at), flush),
            "warm_ms": event_ms(lambda: emb_ops.lookup_cuda(src, at), None),
            "plain_ms": event_ms(lambda: emb_ops.lookup_take(src, at), flush),
            "library_ms": event_ms(lambda: torch.index_select(src, 0, at_long), flush),
            "library": "index_select (sentinel ids clamped)", "bound_ms": ms_b, "bound_by": by,
        })
    del table, mv

    r = ids.numel()
    grads = torch.randn(r, 128, generator=cgen, device=dev)
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
    new_run = torch.ones_like(sorted_ids, dtype=torch.bool)
    new_run[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(new_run, 0, dtype=torch.int32) - 1
    seg_l, g_sorted = seg.long(), grads[order]
    zeros = torch.zeros(cap, 128, device=dev)
    ms_b, by = bound(r * (4 + 8) + r * 128 * 4 + cap * 128 * 4, r * 128)
    out.append({
        "name": "segment_sum", "dtype": "float32", "shape": f"R={r} -> [{cap}, 128]",
        "updates": r,
        "ms": event_ms(lambda: scatter_ops.segment_sum_cuda(seg, order, grads, cap), flush),
        "warm_ms": event_ms(lambda: scatter_ops.segment_sum_cuda(seg, order, grads, cap), None),
        "plain_ms": event_ms(lambda: scatter_ops.segment_sum_plain(seg, order, grads, cap), flush),
        "library_ms": event_ms(lambda: torch.index_add(zeros, 0, seg_l, g_sorted), flush),
        "library": "index_add of the sorted rows (fp32 atomics)", "bound_ms": ms_b,
        "bound_by": by,
    })
    flat_ids = ids.reshape(-1)
    out.append({
        "name": "dedupe_rows", "dtype": "float32", "shape": f"R={r} -> [{cap}, 128]",
        "updates": r, "kernel": False,
        "ms": event_ms(lambda: sparse_ops.dedupe_rows(flat_ids, grads, v_rows, cap), flush,
                       iters=20),
        "warm_ms": None, "plain_ms": None, "library_ms": None, "bound_ms": ms_b,
        "bound_by": by,
    })
    table = torch.randn(v_rows, 128, generator=cgen, device=dev)
    mv = torch.zeros(v_rows, 256, device=dev)
    row_grads = grads[:cap]
    lr_t = sparse_ops.adam_lr_t(1e-3, 7)
    # reads p and m|v rows and the gradient rows, writes p and m|v rows
    ms_b, by = bound(cap * 4 + n_valid * (2 * (128 + 256) * 4 + 128 * 4), 12 * n_valid * 128)
    out.append({
        "name": "sparse_adam_rows_packed", "dtype": "float32",
        "shape": f"{cap} rows of [{v_rows}, 128] + m|v [{v_rows}, 256], dma", "updates": cap,
        "kernel": False,
        "ms": event_ms(lambda: sparse_ops.sparse_adam_rows_packed(
            table, mv, rows, row_grads, lr_t, scatter_backend="dma", v_valid=v_valid), flush,
            iters=20),
        "warm_ms": None, "plain_ms": None, "library_ms": None, "bound_ms": ms_b,
        "bound_by": by,
    })
    return out


def time_flat_kernels(dev, gen) -> list[dict]:
    """CUDA-event times of the flat FM forward and backward at bench's batch
    (B=8192, F=26, K=64), bf16 and fp32."""
    flush = torch.ones(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    b, f, k = FLAGSHIP_BATCH, FIELDS, K
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.empty((), dtype=dtype).element_size()
        v2 = flat_input(b, f, k, 0, 0.3, dtype, dev, gen)
        g = torch.randn(b, generator=gen).to(dev)
        _, s = fm_ops.fm_cross_flat_cuda(v2, f, k)
        # forward: read v2, write out (fp32) and S; 3 operations per value
        ms_b, by = bound(b * f * k * es + b * 4 + b * k * es, 3 * b * f * k)
        rows.append({
            "name": "fm_cross_flat", "dtype": str(dtype).split(".")[-1], "batch": b,
            "ms": event_ms(lambda: fm_ops.fm_cross_flat_cuda(v2, f, k), flush),
            "warm_ms": event_ms(lambda: fm_ops.fm_cross_flat_cuda(v2, f, k), None),
            "plain_ms": event_ms(lambda: fm_ops.fm_cross_flat_plain(v2, f, k), flush),
            "library_ms": None, "bound_ms": ms_b, "bound_by": by,
        })
        # backward: read v2, S and g (fp32), write dv2; 2 operations per value
        ms_b, by = bound(2 * b * f * k * es + b * k * es + b * 4, 2 * b * f * k)
        rows.append({
            "name": "fm_cross_flat_bwd", "dtype": str(dtype).split(".")[-1], "batch": b,
            "ms": event_ms(lambda: fm_ops.fm_cross_flat_bwd_cuda(v2, s, g, f, k), flush),
            "warm_ms": event_ms(lambda: fm_ops.fm_cross_flat_bwd_cuda(v2, s, g, f, k), None),
            "plain_ms": event_ms(lambda: fm_ops.fm_cross_flat_bwd_plain(v2, s, g, f, k),
                                 flush),
            "library_ms": None, "bound_ms": ms_b, "bound_by": by,
        })
    return rows


def profile_scatter(dev, gen) -> dict:
    """Device time of each device operation one scatter_rows_cuda call runs
    (kernels and memsets: the ordering, the sums), and the number of them a
    call, at both stream sizes in bf16 and fp32, and for segment_sum at the
    fast step's shape."""
    from torch.profiler import ProfilerActivity, profile

    def split(fn, reps: int = 10) -> dict:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        return {"ms_by_op": sorted(((e.key[:50], e.self_device_time_total / reps / 1e3)
                                    for e in events), key=lambda kv: -kv[1]),
                "ops_per_call": sum(e.count for e in events) / reps}

    out = {}
    rng = np.random.default_rng(5)
    for label, fs, batch in (("ml100k", ml_100k_feature_set(), TRAIN_BATCH),
                             ("flagship", bench_feature_set(), FLAGSHIP_BATCH)):
        v_rows = padded_rows(fs)
        ids = torch.from_numpy(random_ids(fs, batch, rng).reshape(-1)).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            upd = torch.randn(ids.shape[0], WIDTH, generator=gen).to(dtype).to(dev)
            out[f"{label} {str(dtype).split('.')[-1]}"] = split(
                lambda: scatter_ops.scatter_rows_cuda(ids, upd, v_rows))
    fs = big_feature_set()
    ids = torch.from_numpy(random_ids(fs, BIG_BATCH, np.random.default_rng(10))).to(dev)
    cap = sparse_ops.unique_capacity(fs.field_sizes, BIG_BATCH, ids.numel())
    grads = torch.randn(ids.numel(), 128, generator=gen).to(dev)
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
    new_run = torch.ones_like(sorted_ids, dtype=torch.bool)
    new_run[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(new_run, 0, dtype=torch.int32) - 1
    out["segment_sum"] = split(lambda: scatter_ops.segment_sum_cuda(seg, order, grads, cap))
    return out


def kernel_name(mangled: str) -> str:
    """A short name of a mangled kernel: its identifier and template
    arguments (integers and types; a type repeated from before is S)."""
    i, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while i < len(mangled) and mangled[i].isdigit():  # the nested name's parts
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    if i < len(mangled) and mangled[i] == "I":
        args, k, toks = mangled[i + 1:mangled.find("EEv", i)], 0, []
        letters = {"f": "f32", "i": "i32", "l": "i64", "b": "bool", "h": "u8", "t": "u16"}
        while k < len(args):
            lit, sub = re.match(r"Li(\d+)E", args[k:]), re.match(r"S\d*_", args[k:])
            if args.startswith("13__nv_bfloat16", k):
                toks, k = toks + ["bf16"], k + 15
            elif lit or sub:
                toks, k = toks + [lit.group(1) if lit else "S"], k + (lit or sub).end()
            else:
                toks, k = toks + [letters.get(args[k], args[k])], k + 1
        name += f"<{', '.join(toks)}>"
    return name


def ptxas_report(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, bytes spilled) for each kernel in nvcc's -Xptxas -v
    output."""
    out, name, spill = [], "?", 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name, spill = kernel_name(entry.group(1)), 0
        found = re.search(r"(\d+) bytes spill stores", line)
        if found:
            spill = int(found.group(1))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out.append((name, int(regs.group(1)), spill))
    return out


# --- phase 8: sharded training (rectpu_torch/parallel) on the one card --------
#
# One process a rank, every rank on cuda:0 (the machine has one card, and NCCL
# takes no two ranks on one device), over Gloo, which ``parallel/mesh.py``
# chooses. The port hands Gloo CUDA tensors; Gloo copies each payload through
# host memory itself.
# These phases test the code paths and the kernels on the card; their times
# say nothing of NCCL across cards.

SHARD_STEPS = 5
# (ep_mode, wire format); bf16 rows on the 2d wire round what the bf16 towers
# round anyway, so that run is held to the exact modes' bounds; "int8-control"
# plants a 4-bit grid on the int8 wire, and the int8 check must refuse it
FLAGSHIP_RUNS_1X2 = (("2d", None), ("2d", "bf16"), ("dedup", None), ("dedup", "int8"),
                     ("dedup", "int8-control"), ("1d", None))
FLAGSHIP_RUNS_2X2 = (("2d", None),)
# phase 8e, the tensor-parallel towers (--tp-mlp): the flagship at 1x2 under
# 1d and 2d and at 2x2 under 2d, the DLRM zoo step (its top and bottom MLPs)
# at 1x2 under 2d, each held to the exact modes' bounds below
TP_RUNS_1X2 = (("1d", None), ("2d", None))
TP_RUNS_2X2 = (("2d", None),)
TP_RUNS_DLRM = (("2d", None),)
# sharded vs single-process step on the card, exact wire formats. Not the
# fp32 bound of another order of sums alone: the towers are bf16, so each
# rank's weight gradient over its batch slice is a bf16 GEMM rounded once
# (2^-8 relative) before the fp32 sum over the ranks, where the single step
# rounds the whole batch's once; an Adam step from a near-zero gradient can
# then take the other sign (the flagship's stochastically rounded v keys on
# the global flat index, as one process's does). Per-step loss relative
# error, and each leaf's SHARD_STEPS-step update against the single-process
# update, relative L2: 2.5 times the one-step card-vs-CPU bound
# FAST_UPDATE_REL_L2, for five steps of it.
SHARD_LOSS_RTOL = 1e-3
SHARD_UPDATE_REL_L2 = 2.5 * FAST_UPDATE_REL_L2
# int8 rows on the wire: rectpu's loss bound for one compressed step
# (tests/test_comm_compress.py: rtol 5e-3), and each leaf's update against
# the single-process update, relative L2, within INT8_UPDATE_REL_L2, set
# between the card's readings (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the
# exact modes' largest leaf 0.022, int8's 0.085 (mlp/0/bias; table 0.032),
# the 4-bit control's 0.316 (table 0.244)
INT8_LOSS_RTOL, INT8_UPDATE_REL_L2 = 5e-3, 0.15
# the sharded eval of the trained params (each rank's rows [i::n], metric
# sums over the ranks) against one process's eval of the same params: its
# bf16 towers run GEMMs of another batch size, which may round an
# activation the other way (2^-8 relative); the int8 run's eval, whose rows
# ride the int8 wire, is held to INT8_LOSS_RTOL
SHARD_EVAL_ROWS, SHARD_EVAL_RTOL = 16384, 1e-3
# the CLI at 2 ranks vs 1: rectpu's _assert_matches (tests/test_multiprocess.py:76)
# at the configuration of its multi-process runs (tests/mp_worker.py: K=4,
# [16, 16], batch 64, 200 steps), the CLI's defaults but the batch
CLI_METRIC_RTOL, CLI_METRIC_ATOL, CLI_DIGEST_RTOL = 1e-4, 1e-5, 1e-5
SHARD_CLI_BATCH, SHARD_CLI_STEPS = 64, 200


def _rank_entry(rank, world, store, backend, jobs, out):
    """A spawned rank: join the group, run ``jobs`` [(function name, kwargs)]
    in order, pickle the results (or the traceback) to ``out``."""
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        resolve_device("cuda")
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world)
        try:
            result = [globals()[name](**kwargs) for name, kwargs in jobs]
        finally:
            dist.destroy_process_group()
    except BaseException:  # the parent raises it with the rank's traceback
        import traceback

        result = traceback.format_exc()
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_ranks(world: int, work: Path, jobs, backend: str | None = None,
              timeout: float = 600.0) -> list:
    """Spawn ``world`` ranks on cuda:0 running ``jobs``; their results, in rank
    order. The backend is ``parallel/mesh.choose_backend``'s unless named."""
    import multiprocessing as mp

    backend = backend or mesh_lib.choose_backend(torch.device("cuda", 0), world)
    tag = f"ranks_{len(list(work.glob('ranks_*')))}"
    d = work / tag
    d.mkdir()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(r, world, str(d / "store"), backend, jobs,
                                                     str(d / f"{r}.pkl")))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    results = []
    for r, p in enumerate(procs):
        path = d / f"{r}.pkl"
        check(path.exists(), f"rank {r} of {jobs[0][0]} wrote nothing (exit {p.exitcode})")
        with open(path, "rb") as f:
            got = pickle.load(f)  # written by the ranks above
        check(not isinstance(got, str), f"rank {r} of {[j[0] for j in jobs]} failed:\n{got}")
        results.append(got)
    return results


def nccl_world1() -> dict:
    """Each collective once in a world-size-1 NCCL group on cuda:0."""
    import torch.distributed as dist

    x = torch.arange(8.0, device="cuda").reshape(4, 2)
    outs = {"all_gather": torch.empty_like(x), "reduce_scatter": torch.empty_like(x),
            "all_to_all": torch.empty_like(x), "all_reduce": x.clone()}
    dist.all_gather_into_tensor(outs["all_gather"], x)
    dist.reduce_scatter_tensor(outs["reduce_scatter"], x)
    dist.all_to_all_single(outs["all_to_all"], x)
    dist.all_reduce(outs["all_reduce"])
    torch.cuda.synchronize()
    for name, y in outs.items():
        check(same_bits(y, x), f"NCCL world 1: {name} changed its input")
    return {"backend": dist.get_backend(), "ops": sorted(outs)}


def sharded_collectives() -> dict:
    """Each autograd collective of parallel/collectives.py over the 1 x world
    mesh on the card, forward and backward against its definition (both
    ranks' inputs are known to each)."""
    import torch.distributed as dist

    from rectpu_torch.parallel import collectives as coll

    world = dist.get_world_size()
    mesh = mesh_lib.make_mesh(1, world, "cuda")
    r = mesh.rank

    def x_of(i):
        return torch.arange(8 * world * 3, dtype=torch.float32, device="cuda").reshape(
            8 * world, 3) + 100.0 * i

    def g_of(i, shape):
        return torch.arange(math.prod(shape), dtype=torch.float32, device="cuda").reshape(
            shape) * (i + 1)

    xs = [x_of(i) for i in range(world)]
    n = xs[0].shape[0] // world
    want = {
        "all_gather": (torch.cat(xs), lambda: sum(g_of(i, (8 * world * world, 3))
                                                 for i in range(world))[r * 8 * world:
                                                                         (r + 1) * 8 * world]),
        "psum_scatter": (sum(xs)[r * n:(r + 1) * n],
                         lambda: torch.cat([g_of(i, (n, 3)) for i in range(world)])),
        "all_to_all": (torch.cat([x[r * n:(r + 1) * n] for x in xs]),
                       lambda: torch.cat([g_of(i, (8 * world, 3))[r * n:(r + 1) * n]
                                          for i in range(world)])),
        "psum": (sum(xs), lambda: g_of(r, (8 * world, 3))),
    }
    errs = {}
    for name, (y_want, dx_want) in want.items():
        x = xs[r].clone().requires_grad_()
        y = getattr(coll, name)(x, mesh.model)
        y.backward(g_of(r, tuple(y.shape)))
        errs[name] = max(float((y.detach() - y_want).abs().max()),
                         float((x.grad - dx_want()).abs().max()))
        check(errs[name] == 0.0, f"collective {name} on the card: max error {errs[name]}")
    return {"backend": mesh.backend, "max_err": errs}


def _update_rel_l2(got: dict, ref: dict, p0: dict) -> dict:
    """Per leaf: |(got - p0) - (ref - p0)| / |ref - p0| (L2)."""
    out = {}
    for k, r in ref.items():
        du = (got[k].float() - p0[k].float()) - (r.float() - p0[k].float())
        den = float((r.float() - p0[k].float()).norm())
        out[k] = float(du.norm()) / max(den, 1e-30)
    return out


def _host_copy(tree):
    """A tree of host tensors that no later in-place update reaches."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_copy(v) for v in tree]
    return tree.detach().cpu().clone()


def _flat_tree(model, plan=None) -> dict:
    tree = params_tree(model)
    if plan is not None:
        tree = plan.gather_params(tree)
    return flatten_tree(tree)


def _shard_counters() -> tuple:
    return (emb_ops.launches, fm_ops.launches, fm_ops.bwd_launches, scatter_ops.launches,
            scatter_ops.segment_launches, adam_ops.launches, dma_ops.launches,
            int_ops.launches)


def _flagship_data(seed: int, rows: int, numeric: int = 0):
    """A resident dataset of ``rows`` random flagship examples (20 % positives;
    ``numeric`` standard-normal numeric columns)."""
    rng = np.random.default_rng(seed)
    ids = random_ids(bench_feature_set(), rows, rng)
    labels = (rng.random(rows) < 0.2).astype(np.float32)
    num = rng.standard_normal((rows, numeric)).astype(np.float32) if numeric else None
    return CsvDataset.from_arrays(ids, labels, num)


# DLRM under --tp-mlp: the zoo configuration with Criteo's 13 numeric columns,
# so that its bottom MLP ([13, 64], [64, 64]) runs tensor-parallel beside the
# top MLP
DLRM_NUMERIC = 13


def dlrm_tp_model(dropout: float, device, gen=None, params=None) -> DLRMModel:
    """The zoo DLRM (``zoo_model``) with DLRM_NUMERIC numeric columns and the
    hash dropout masks, from ``params`` or a fresh seeded init."""
    base = bench_feature_set()
    fs = FeatureSet(categorical=base.categorical,
                    numeric=tuple(NumericFeature(f"dense_{i}") for i in range(DLRM_NUMERIC)))
    cfg = TowerConfig(feature_set=fs, embedding_size=K, hidden_units=(256, 128),
                      dropout=dropout, compute_dtype="bfloat16", table_grad_dtype="bfloat16",
                      flat_layout=True, scatter_impl="mxu", table_padding=2048,
                      dropout_impl="hash")
    model = DLRMModel(cfg)
    return load_params(model, model.init(gen) if params is None else params, device)


def dlrm_tp_trainer(model, work: Path, plan=None, train_ds=None, eval_ds=None) -> Trainer:
    """The flagship's optimizer on DLRM's table (``emb`` on the fused kernel)."""
    opt = adam(learning_rate=1e-3, slot_dtype={"m": torch.bfloat16, "v": BF16_SR},
               fused_leaves=("emb",))
    trainer = Trainer(model, opt, train_ds, eval_ds, work / "dlrm_tp",
                      TrainConfig(batch_size=FLAGSHIP_BATCH, seed=0),
                      device=next(model.parameters()).device, plan=plan)
    trainer.opt_state = opt.init(flat_params(model))
    return trainer


# family: (model, trainer, numeric columns, the kernels its sharded step must launch)
SHARDED_FAMILIES = {
    "deep_fm": (flagship_model, flagship_trainer, 0,
                ("embedding_lookup", "fm_cross", "fm_cross_bwd", "scatter_rows", "segment_sum",
                 "fused_adam")),
    "dlrm": (dlrm_tp_model, dlrm_tp_trainer, DLRM_NUMERIC,
             ("embedding_lookup", "interaction", "scatter_rows", "segment_sum", "fused_adam")),
}


def _coarse_int8_rows(x: torch.Tensor):
    """The control's faulty int8 wire: per-row scale amax/7, a 4-bit grid."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    return torch.round(xf / scale).to(torch.int8), scale


def sharded_flagship(num_data: int, num_model: int, runs, seed: int, work: str,
                     tp_mlp: bool = False, family: str = "deep_fm") -> dict:
    """The flagship step (bench.py's config, hash dropout 0.1) SHARD_STEPS
    times single-process, then under each (ep_mode, wire format) of ``runs``
    from the same params, each through the Trainer's own batches (a resident
    train set, each rank's block of every global batch, checked against the
    single run's), then the sharded eval against a single-process eval of
    the same params, and the sharded save (the table shards gathered, rank 0
    writes) read back, every leaf in its global shape: per-step losses, each
    leaf's update in the checkpoint against the single-process update,
    median step ms, kernel launches. The wire format "int8-control" is the
    int8 run with a 4-bit grid planted on the wire, which the int8 check
    must refuse. ``tp_mlp``: the plan's tensor-parallel towers (phase 8e);
    ``family`` "dlrm": the zoo DLRM with numeric columns (``dlrm_tp_model``)
    in place of the flagship DeepFM."""
    from rectpu_torch.parallel import embedding_ep
    from rectpu_torch.train.checkpoint import Checkpointer

    make_model, make_trainer, numeric, must_launch = SHARDED_FAMILIES[family]
    dev = torch.device("cuda", 0)
    work = Path(work)
    base = make_model(0.1, "cpu", gen=torch.Generator().manual_seed(seed))
    p0 = params_tree(base)
    train_ds = _flagship_data(seed + 1, SHARD_STEPS * FLAGSHIP_BATCH, numeric)
    eval_ds = _flagship_data(seed + 2, SHARD_EVAL_ROWS, numeric)
    single = make_model(0.1, dev, params=p0)
    trainer = make_trainer(single, work, train_ds=train_ds)
    batches = trainer._batches(None)
    ref_losses, ref_ids = [], []
    for i in range(SHARD_STEPS):
        b, _ = next(batches)
        ref_ids.append(b["cat_ids"].clone())
        ref_losses.append(float(trainer.train_step(b, i)))
    batches.close()
    ref = flatten_tree(params_tree(single))
    flat0 = flatten_tree(p0)
    del single, trainer
    out = {}
    for mode, cc in runs:
        control = cc == "int8-control"
        plan = ParallelPlan.create(num_data, num_model, device="cuda",
                                   table_rows=base.cfg.padded_buckets, ep_mode=mode,
                                   ep_comm_compress="int8" if control else cc,
                                   scatter_impl="mxu", tp_mlp=tp_mlp)
        name = (f"{num_data}x{num_model} {mode}" + (f" {cc}" if cc else "")
                + (" tp" if tp_mlp else "") + ("" if family == "deep_fm" else f" {family}"))
        job = work / f"flagship_{name.replace(' ', '_')}"
        model = make_model(0.1, dev, params=plan.shard_params(p0))
        trainer = make_trainer(model, job, plan, train_ds=train_ds, eval_ds=eval_ds)
        n, pos = plan.batch_shards, plan.batch_index
        rows = FLAGSHIP_BATCH // n
        batches = trainer._batches(None)
        torch.cuda.synchronize()
        for c in _shard_counters():
            c.reset()
        losses, times = [], []
        quantize = embedding_ep._quantize_rows_int8
        if control:
            embedding_ep._quantize_rows_int8 = _coarse_int8_rows
        try:
            for i in range(SHARD_STEPS):
                b, data_state = next(batches)
                check(same_bits(b["cat_ids"], ref_ids[i][pos * rows:(pos + 1) * rows]),
                      f"sharded flagship {name}: step {i}'s batch is not the rank's block")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss = trainer.train_step(b, i)
                end.record()
                losses.append(float(plan.global_value(loss)))
                end.synchronize()
                times.append(start.elapsed_time(end))
        finally:
            embedding_ep._quantize_rows_int8 = quantize
        batches.close()
        launches = {c.name: c.value for c in _shard_counters()}
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        res = {"backend": plan.mesh.backend, "losses": losses, "ref_losses": ref_losses,
               "loss_rel_err": loss_err, "step_ms": statistics.median(times[1:]),
               "step_ms_all": times, "launches": launches}
        if control:
            got = _flat_tree(model, plan)
        else:
            saved_tree = trainer._save(SHARD_STEPS, data_state)  # the gather is a collective
            got = flatten_tree(saved_tree)
            evaluated = trainer.evaluate()  # the metric sums are collectives
            if plan.mesh.rank == 0:
                trainer.ckpt.wait()
                restored = Checkpointer(trainer.job_dir).restore()[0]
                read = flatten_tree(restored["params"])
                check(sorted(read) == sorted(got)
                      and all(same_bits(read[k], got[k].cpu()) for k in got),
                      f"sharded flagship {name}: the checkpoint is not the gathered params")
                shapes = {k: tuple(v.shape) for k, v in flat0.items()}
                state = flatten_tree(restored["opt_state"])
                wrong = [k for k in read if tuple(read[k].shape) != shapes[k]] + [
                    k for k in state for p in shapes
                    if k.endswith("/" + p) and tuple(state[k].shape) != shapes[p]]
                check(not wrong, f"sharded flagship {name}: checkpoint leaves {wrong} are not "
                                 "in the global shapes")
                res["checkpoint_global_shapes"] = True
                alone = make_model(0.1, dev, params=_host_copy(saved_tree))
                res["eval"], res["eval_single"] = evaluated, make_trainer(
                    alone, job / "alone", eval_ds=eval_ds).evaluate()
                del alone
        rel = _update_rel_l2(got, ref, flat0)
        res["update_rel_l2"] = rel
        if control:
            res["refused"] = (loss_err > INT8_LOSS_RTOL
                              or any(v > INT8_UPDATE_REL_L2 for v in rel.values()))
            check(res["refused"], f"sharded flagship {name}: the int8 check passed a 4-bit "
                                  f"wire (loss rel err {loss_err}, update rel L2 {rel})")
        else:
            loss_bound, update_bound = ((INT8_LOSS_RTOL, INT8_UPDATE_REL_L2) if cc == "int8"
                                        else (SHARD_LOSS_RTOL, SHARD_UPDATE_REL_L2))
            check(loss_err <= loss_bound, f"sharded flagship {name}: loss rel err "
                                          f"{loss_err} > {loss_bound}")
            check(all(v <= update_bound for v in rel.values()),
                  f"sharded flagship {name}: update rel L2 {rel} > {update_bound}")
            if "eval" in res:
                # the int8 run's sharded eval rides the int8 wire too
                eval_bound = INT8_LOSS_RTOL if cc == "int8" else SHARD_EVAL_RTOL
                ev, ev1 = res["eval"], res["eval_single"]
                check(ev["count"] == ev1["count"] == SHARD_EVAL_ROWS,
                      f"sharded flagship {name}: eval count {ev['count']} vs {ev1['count']}")
                for key in ("auc", "average_loss", "accuracy"):
                    check(abs(ev[key] - ev1[key]) <= eval_bound * abs(ev1[key]),
                          f"sharded flagship {name}: eval {key} {ev[key]} vs one process "
                          f"{ev1[key]}")
        for kname in must_launch:
            check(launches[kname] > 0, f"sharded flagship {name}: {kname} was not launched")
        out[name] = res
        del model, trainer
        torch.cuda.empty_cache()
    return out


def _fast_trainer(model, data, job: Path, plan=None, eval_ds=None) -> Trainer:
    """A Trainer over ``make_sparse_step`` at lr 1e-3 on the resident ``data``."""
    fast = make_sparse_step(model, learning_rate=1e-3, plan=plan)
    trainer = Trainer(model, adam(1e-3), data, eval_ds, job,
                      TrainConfig(batch_size=BIG_BATCH, seed=0),
                      device=torch.device("cuda", 0), fast_step=fast, plan=plan)
    trainer.opt_state = fast[0](flat_params(model))
    return trainer


def sharded_fast_step(num_data: int, num_model: int, mode: str, seed: int, work: str) -> dict:
    """The full-width sparse fast step (6,000,640 x 128 fp32 table, fp32 m|v
    [.., 256], batch 8192, hash dropout) SHARD_STEPS times single-process on
    this rank, then sharded (``make_sparse_step(plan=...)``) from the same
    params, both through the Trainer's batches of one resident train set:
    losses, this shard's table and m|v update against the single-process
    rows, median step ms, launches."""
    dev = torch.device("cuda", 0)
    fs = big_feature_set()
    rng = np.random.default_rng(seed + 2)
    data = CsvDataset.from_arrays(random_ids(fs, SHARD_STEPS * BIG_BATCH, rng),
                                  (rng.random(SHARD_STEPS * BIG_BATCH) < 0.2).astype(np.float32))
    # hash dropout: its masks key on global rows, so the ranks draw the single run's
    single = fast_model(fs, 0.1, dev, seed, dropout_impl="hash")
    v_rows = single.cfg.padded_buckets
    v_shard = v_rows // num_model
    p0 = _host_copy(params_tree(single))
    trainer = _fast_trainer(single, data, Path(work) / "fast_single")
    batches = trainer._batches(None)
    ref_losses = [float(trainer.train_step(next(batches)[0], i)) for i in range(SHARD_STEPS)]
    batches.close()
    mi = torch.distributed.get_rank() % num_model
    rows = slice(mi * v_shard, (mi + 1) * v_shard)
    ref_table = single.table.detach()[rows].clone()
    ref_mv = trainer.opt_state["mv_sparse"]["table"][rows].clone()
    ref_rest = {k: v.detach().clone() for k, v in flat_params(single).items() if k != "table"}
    del single, trainer, batches
    torch.cuda.empty_cache()

    plan = ParallelPlan.create(num_data, num_model, device="cuda", table_rows=v_rows,
                               ep_mode=mode)
    model = fast_model(fs, 0.1, dev, params=plan.shard_params(p0), dropout_impl="hash")
    trainer = _fast_trainer(model, data, Path(work) / "fast_sharded", plan)
    state = trainer.opt_state
    check(tuple(model.table.shape) == (v_shard, 128)
          and tuple(state["mv_sparse"]["table"].shape) == (v_shard, 256),
          f"sharded fast step: shard {tuple(model.table.shape)}, m|v "
          f"{tuple(state['mv_sparse']['table'].shape)}")
    batches = trainer._batches(None)
    torch.cuda.synchronize()
    for c in _shard_counters():
        c.reset()
    losses, times = [], []
    for i in range(SHARD_STEPS):
        b, _ = next(batches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = trainer.train_step(b, i)
        end.record()
        losses.append(float(plan.global_value(loss)))
        end.synchronize()
        times.append(start.elapsed_time(end))
    batches.close()
    launches = {c.name: c.value for c in _shard_counters()}
    t0 = p0["table"][rows].to(dev)
    rel = _update_rel_l2({"table": model.table.detach(),
                          **{k: v.detach() for k, v in flat_params(model).items()
                             if k != "table"}},
                         {"table": ref_table, **ref_rest},
                         {"table": t0, **{k: v.to(dev) for k, v in flatten_tree(p0).items()
                                          if k != "table"}})
    mv = state["mv_sparse"]["table"]
    mv_rel = float((mv - ref_mv).norm()) / max(float(ref_mv.norm()), 1e-30)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    check(loss_err <= SHARD_LOSS_RTOL, f"sharded fast step: loss rel err {loss_err}")
    check(all(v <= SHARD_UPDATE_REL_L2 for v in rel.values()),
          f"sharded fast step: update rel L2 {rel} > {SHARD_UPDATE_REL_L2}")
    check(mv_rel <= SHARD_UPDATE_REL_L2, f"sharded fast step: m|v rel L2 {mv_rel}")
    for kname in ("embedding_lookup", "fm_cross", "fm_cross_bwd", "segment_sum",
                  "scatter_rows_dma"):
        check(launches[kname] > 0, f"sharded fast step: {kname} was not launched")
    return {"backend": plan.mesh.backend, "mode": mode, "v_shard": v_shard,
            "losses": losses, "ref_losses": ref_losses, "loss_rel_err": loss_err,
            "update_rel_l2": rel, "mv_rel_l2": mv_rel, "step_ms": statistics.median(times[1:]),
            "step_ms_all": times, "launches": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def _cli_argv(data_dir: Path, job: Path) -> list:
    return ["--dropout-impl", "hash", "--batch-size", str(SHARD_CLI_BATCH), "--train-steps",
            str(SHARD_CLI_STEPS), "--save-checkpoints-steps", str(SHARD_CLI_STEPS),
            "--steps-per-loop", "50",
            "--train-csv", str(data_dir / "train.csv"), "--test-csv",
            str(data_dir / "test.csv"), "--job-dir", str(job), "--device", "cuda"]


# the DeepFM CLI with the Trainer's dispatch forced to argv[1] (the CLI, as
# rectpu's, has no dispatch flag): a script for torchrun, written at run time
CLI_IN_MODE = """import sys
from rectpu_torch.trainers import common, deep_fm

mode = sys.argv.pop(1)
build = common.build_trainer


def build_in_mode(*args, **kwargs):
    trainer = build(*args, **kwargs)
    trainer.config.dispatch_mode = mode
    return trainer


common.build_trainer = build_in_mode
deep_fm.train_and_evaluate(deep_fm.build_parser().parse_args())
"""


def _run_cli(nproc: int, argv: list, script: Path | None = None) -> tuple[dict, float, str]:
    """The DeepFM CLI at ``nproc`` ranks (torchrun beyond 1), or ``script``
    (CLI_IN_MODE written out; ``argv`` then starts with the mode) -> (final
    metrics, seconds, log)."""
    import ast
    import os

    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    if script is None:
        entry = ["-m", "rectpu_torch.trainers.deep_fm", *argv]
    else:
        entry = [str(script), *argv]
        root = str(Path(__file__).resolve().parent)
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    cmd = ([sys.executable, *entry] if nproc == 1 else
           [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={nproc}", *entry])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"DeepFM CLI at {nproc} rank(s) failed:\n{log[-3000:]}")
    done = [line for line in log.splitlines() if "rectpu_torch.trainers :: done: " in line]
    check(len(done) == nproc, f"DeepFM CLI at {nproc} rank(s): {len(done)} 'done' lines")
    return ast.literal_eval(done[0].split("done: ", 1)[1]), seconds, log


def _digest(job: Path) -> float:
    from rectpu_torch.train.checkpoint import Checkpointer, _load_flat_npz

    step = Checkpointer(job).latest_step()
    flat = _load_flat_npz(job / f"ckpt-{step}" / "arrays.npz")
    return float(sum(v.double().abs().sum() for k, v in flat.items() if k.startswith("params/")))


def _serve_export(export_dir: Path, seed: int, label: str) -> int:
    """Serve an export on the card for a few /predict requests, checked
    against a CPU model of it; the number of predictions."""
    httpd, served = make_server(export_dir=str(export_dir), port=0, device="cuda",
                                batch_window_ms=1.0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        instances = make_instances(np.random.default_rng(seed), 8)
        preds = post(f"http://127.0.0.1:{httpd.server_address[1]}", "/predict",
                     {"instances": instances})["predictions"]
        one = post(f"http://127.0.0.1:{httpd.server_address[1]}", "/predict",
                   {"instances": instances[:1]})["predictions"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        served.close()
        thread.join(timeout=30)
    check(not thread.is_alive(), f"{label} export server thread did not stop")
    ref = load_model(export_dir, device="cpu")
    check_predictions(preds, instances, ref, f"{label} export", FP32_LOGIT_ATOL, 1e-4)
    check(abs(one[0]["logits"] - preds[0]["logits"]) <= FP32_LOGIT_ATOL,
          f"{label} export: one instance alone vs in a batch")
    return len(preds) + len(one)


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same dtype, shape and bytes (any dtype, 0-d included)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _checkpoint_arrays(job: Path) -> dict:
    from rectpu_torch.train.checkpoint import Checkpointer, _load_flat_npz

    return _load_flat_npz(job / f"ckpt-{Checkpointer(job).latest_step()}" / "arrays.npz")


def _kernel_ids() -> set:
    """The names of the port's CUDA kernels (``*_kernel``), from its sources."""
    return {m for src in (Path(__file__).resolve().parent / "rectpu_torch" / "kernels"
                          / "csrc").glob("*.cu")
            for m in re.findall(r"\b(\w+_kernel)\s*\(", src.read_text())}


def cli_trace(prof_dir: Path, steps: int) -> dict:
    """The trace ``--profile-dir`` wrote (rank 0's second logging window, of
    ``steps`` steps): the host's aten ops a step and the port's kernels by
    name in the window (a graph replay's kernels are traced one by one)."""
    from collections import Counter

    traces = sorted(prof_dir.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"{prof_dir}: {len(traces)} traces")
    events = json.loads(traces[0].read_text())["traceEvents"]
    ids, kernels = _kernel_ids(), Counter()
    for e in events:
        m = re.search(r"\b(\w+_kernel)\b", e.get("name", "")) if e.get("cat") == "kernel" else None
        if m and m.group(1) in ids:
            kernels[m.group(1)] += 1
    ops = sum(e.get("cat") == "cpu_op" and e.get("name", "").startswith("aten::")
              for e in events)
    return {"host_aten_ops": ops / steps, "kernels": dict(sorted(kernels.items()))}


def sharded_cli(work: Path, seed: int) -> dict:
    """The DeepFM CLI under torchrun at 2 ranks (dedup, freq placement, auto
    capacity; batch 64 resolves to scan), the same 2-rank CLI in pipelined
    dispatch (phase 8f: bit for bit the scan run in the eval and every
    checkpoint leaf; both trace their second logging window), and the same
    with --tp-mlp (phase 8e), against the same CLI at 1 rank with the same
    placement, then each 2-rank scan export served for a few requests."""
    data_dir = work / "data"
    if not (data_dir / "train.csv").exists():
        write_synthetic_dataset(data_dir, train_rows=100_000, test_rows=10_000, seed=seed)
    multi_job, pipe_job, single_job, tp_job = (work / "shard_cli_2", work / "shard_cli_2_pipe",
                                               work / "shard_cli_1", work / "tp_cli_2")
    ep_flags = ["--num-model-shards", "2", "--ep-mode", "dedup", "--ep-row-placement", "freq",
                "--ep-peer-capacity", "auto"]
    prof = {"scan": work / "shard_cli_prof_scan", "pipelined": work / "shard_cli_prof_pipe"}
    multi, multi_s, log = _run_cli(2, _cli_argv(data_dir, multi_job) + ep_flags
                                   + ["--profile-dir", str(prof["scan"])])
    cap = re.findall(r"ep_peer_capacity auto -> (\d+)", log)
    script = work / "cli_in_mode.py"
    script.write_text(CLI_IN_MODE)
    pipe, pipe_s, pipe_log = _run_cli(2, ["pipelined", *_cli_argv(data_dir, pipe_job), *ep_flags,
                                          "--profile-dir", str(prof["pipelined"])], script)
    for mode, text in (("scan", log), ("pipelined", pipe_log)):
        check(text.count(f"dispatch: {mode}") == 2, f"sharded CLI: not both ranks in {mode}")
    captured = re.findall(r"step captured: (\d+) graph segments around (\d+) collectives", log)
    check(len(captured) == 2, f"sharded CLI under scan: {len(captured)} ranks captured the step")
    a, b = _checkpoint_arrays(multi_job), _checkpoint_arrays(pipe_job)
    check(pipe == multi and sorted(a) == sorted(b) and all(same_bytes(a[k], b[k]) for k in a),
          f"sharded CLI: scan differs from pipelined (eval {multi} vs {pipe}, leaves "
          f"{[k for k in a if k in b and not same_bytes(a[k], b[k])][:5]})")
    traces = {mode: cli_trace(d, 50) for mode, d in prof.items()}
    check(traces["scan"]["kernels"] == traces["pipelined"]["kernels"]
          and len(traces["scan"]["kernels"]) >= 4,
          f"sharded CLI: the traced window's kernels {traces}")
    check(traces["scan"]["host_aten_ops"]
          < SCAN_HOST_OPS_SHARE * traces["pipelined"]["host_aten_ops"],
          f"sharded CLI: host aten ops a step {traces}")
    tp, tp_s, _ = _run_cli(2, _cli_argv(data_dir, tp_job) + ep_flags + ["--tp-mlp"])
    check(bool(np.array_equal(np.load(tp_job / "row_perm.npy"),
                              np.load(multi_job / "row_perm.npy"))),
          "sharded CLI: the --tp-mlp run placed its rows elsewhere")
    single_job.mkdir()
    shutil.copy(multi_job / "row_perm.npy", single_job / "row_perm.npy")
    single, single_s, _ = _run_cli(1, _cli_argv(data_dir, single_job) + ["--restore"])
    d_single = _digest(single_job)
    out = {"metrics_1": single, "digest_1": d_single, "seconds_1": single_s,
           "peer_capacity": cap, "seconds_2_pipelined": pipe_s, "trace_2": traces,
           "segments_2": [tuple(map(int, c)) for c in captured],
           "leaves_compared_2": len(a)}
    for tag, metrics, seconds, job in (("2", multi, multi_s, multi_job),
                                       ("tp_2", tp, tp_s, tp_job)):
        label = "sharded CLI" + (" --tp-mlp" if tag == "tp_2" else "")
        for key in ("auc", "average_loss", "accuracy"):
            check(bool(np.isclose(single[key], metrics[key], rtol=CLI_METRIC_RTOL,
                                  atol=CLI_METRIC_ATOL)),
                  f"{label}: {key} {metrics[key]} vs one rank {single[key]}")
        check(metrics["count"] == single["count"], f"{label}: eval count {metrics['count']}")
        digest = _digest(job)
        check(bool(np.isclose(digest, d_single, rtol=CLI_DIGEST_RTOL)),
              f"{label}: param digest {digest} vs one rank {d_single}")
        export_dir = latest_export(job)
        check(export_dir is not None and (export_dir / "row_perm.npy").exists(),
              f"{label}: no export with its row placement")
        out.update({f"metrics_{tag}": metrics, f"digest_{tag}": digest,
                    f"seconds_{tag}": seconds,
                    f"served_{tag}": _serve_export(export_dir, seed, label)})
    return out


# --- phase 8f: scan dispatch under a plan, against pipelined -------------------
#
# Each case's steps in both dispatch modes from the same params and batches:
# loops of WARMUP_STEPS + 1 (the warm-up and, under scan, the capture of the
# step as graph segments cut at its collectives), SHARD_STEPS (timed on the
# host clock) and 2 (the host's aten ops profiled).
SCAN_LOOPS = (WARMUP_STEPS + 1, SHARD_STEPS, 2)
SCAN_EVAL_ROWS = 4096
# (case, ep_mode, the flagship's flat layout, tp_mlp, the full-width fast step)
SCAN_CASES_1X2 = (("1d", "1d", True, False, False), ("2d", "2d", True, False, False),
                  ("dedup", "dedup", True, False, False),
                  ("2d unflat", "2d", False, False, False), ("2d tp", "2d", True, True, False),
                  ("dedup fast", "dedup", True, False, True))
SCAN_CASES_2X2 = (("2d", "2d", True, False, False),)
# under scan a rank's host aten ops a step stay below this share of pipelined's
SCAN_HOST_OPS_SHARE = 0.2
SCAN_MUST_LAUNCH = {False: ("embedding_lookup", "fm_cross", "fm_cross_bwd", "scatter_rows",
                            "fused_adam"),
                    True: ("embedding_lookup", "fm_cross", "fm_cross_bwd", "segment_sum",
                           "scatter_rows_dma")}


def _scan_case(num_data: int, num_model: int, case, seed: int, work: Path):
    """``make_trainer(mode)`` for one SCAN_CASES entry: a Trainer on this
    rank's shard of one seeded init, its resident train and eval sets."""
    _, mode, flat, tp, fast = case
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed + 7)
    fs = big_feature_set() if fast else bench_feature_set()
    batch = BIG_BATCH if fast else FLAGSHIP_BATCH
    rows = sum(SCAN_LOOPS) * batch
    data = CsvDataset.from_arrays(random_ids(fs, rows, rng),
                                  (rng.random(rows) < 0.2).astype(np.float32))
    eval_ds = CsvDataset.from_arrays(random_ids(fs, SCAN_EVAL_ROWS, rng),
                                     (rng.random(SCAN_EVAL_ROWS) < 0.2).astype(np.float32))
    if fast:  # the single model on the card, its table too large to make on the host
        base = fast_model(fs, 0.1, dev, seed, dropout_impl="hash")
    else:
        base = flagship_model(0.1, "cpu", gen=torch.Generator().manual_seed(seed),
                              flat_layout=flat)
    p0 = params_tree(base)
    plan = ParallelPlan.create(num_data, num_model, device="cuda",
                               table_rows=base.cfg.padded_buckets, ep_mode=mode,
                               scatter_impl="xla" if fast else "mxu", tp_mlp=tp)
    shard = plan.shard_params(p0)
    del base, p0

    def make_trainer(dispatch: str) -> Trainer:
        job = work / f"scan_{num_data}x{num_model}_{case[0].replace(' ', '_')}_{dispatch}"
        if fast:
            model = fast_model(fs, 0.1, dev, params=shard, dropout_impl="hash")
            trainer = _fast_trainer(model, data, job, plan, eval_ds=eval_ds)
        else:
            model = flagship_model(0.1, dev, params=shard, flat_layout=flat)
            trainer = flagship_trainer(model, job, plan, train_ds=data, eval_ds=eval_ds)
        trainer.config.dispatch_mode = dispatch
        trainer.config.steps_per_loop = max(SCAN_LOOPS)
        return trainer

    return make_trainer


def sharded_scan(num_data: int, num_model: int, cases, seed: int, work: str) -> dict:
    """Phase 8f on this rank: each of ``cases`` in pipelined then scan
    dispatch through ``drive_loops`` (SCAN_LOOPS), then its sharded eval;
    scan equal to pipelined bit for bit in every loss share, this rank's
    parameter and optimizer-state leaves and the eval, every step after the
    warm-up a replay of the step's segments, the same launches of every
    kernel, and the host's aten ops a step under scan below
    SCAN_HOST_OPS_SHARE of pipelined's."""
    out = {}
    for case in cases:
        label = f"{num_data}x{num_model} {case[0]}"
        make_trainer = _scan_case(num_data, num_model, case, seed, Path(work))
        runs, res = {}, {}
        for mode in ("pipelined", "scan"):
            trainer = make_trainer(mode)
            check(trainer.dispatch == mode, f"scan under a plan {label}: {trainer.dispatch}")
            r = drive_loops(trainer, SCAN_LOOPS, _shard_counters(), device_trace=False)
            r["eval"] = trainer.evaluate()  # the metric sums are collectives
            runs[mode] = (r.pop("losses"), trainer)
            res[mode] = r
        res["leaves_compared"] = check_same_training(runs, f"scan under a plan {label}")
        sc, pi = res["scan"], res["pipelined"]
        check(sc["eval"] == pi["eval"], f"scan under a plan {label}: eval {sc['eval']} vs "
                                        f"{pi['eval']}")
        check(sc["replays"] == sum(SCAN_LOOPS) - WARMUP_STEPS and sc["segments"] > 1
              and sc["segments"] == sc["collectives"] + 1,
              f"scan under a plan {label}: {sc['replays']} replays of {sc['segments']} "
              f"segments around {sc['collectives']} collectives")
        check(sc["launches"] == pi["launches"]
              and all(sc["launches"][k] > 0 for k in SCAN_MUST_LAUNCH[case[4]]),
              f"scan under a plan {label}: launches {sc['launches']} vs {pi['launches']}")
        check(sc["host_aten_ops"] < SCAN_HOST_OPS_SHARE * pi["host_aten_ops"],
              f"scan under a plan {label}: {sc['host_aten_ops']} host aten ops a step against "
              f"pipelined's {pi['host_aten_ops']}")
        out[label] = res
        del runs
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sharded_phases(work: Path, seed: int) -> dict:
    """Phases 8a-8f (see the module docstring)."""
    # the ranks allocate on this process's card: give back what earlier phases cached
    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    res["nccl"] = run_ranks(1, work, [("nccl_world1", {})], backend="nccl")[0][0]
    common = {"seed": seed, "work": str(work)}
    flag_jobs = [("sharded_collectives", {}),
                 ("sharded_flagship", {"num_data": 1, "num_model": 2,
                                       "runs": FLAGSHIP_RUNS_1X2, **common}),
                 ("sharded_flagship", {"num_data": 1, "num_model": 2, "runs": TP_RUNS_1X2,
                                       "tp_mlp": True, **common}),
                 ("sharded_flagship", {"num_data": 1, "num_model": 2, "runs": TP_RUNS_DLRM,
                                       "tp_mlp": True, "family": "dlrm", **common}),
                 ("sharded_scan", {"num_data": 1, "num_model": 2, "cases": SCAN_CASES_1X2,
                                   **common})]
    got = run_ranks(2, work, flag_jobs)
    res["collectives"] = got[0][0]
    got4 = run_ranks(4, work, [("sharded_flagship", {"num_data": 2, "num_model": 2,
                                                     "runs": FLAGSHIP_RUNS_2X2, **common}),
                               ("sharded_flagship", {"num_data": 2, "num_model": 2,
                                                     "runs": TP_RUNS_2X2, "tp_mlp": True,
                                                     **common}),
                               ("sharded_scan", {"num_data": 2, "num_model": 2,
                                                 "cases": SCAN_CASES_2X2, **common})])
    # phase 8f: rank 0's numbers, the host's aten ops of the busiest rank and
    # the launches of every rank
    res["scan"] = {}
    for ranks in (got, got4):
        for name, r in ranks[0][-1].items():
            for mode in ("pipelined", "scan"):
                r[mode]["host_aten_ops_max"] = max(rank[-1][name][mode]["host_aten_ops"]
                                                   for rank in ranks)
                r[mode]["launches"] = {k: sum(rank[-1][name][mode]["launches"][k]
                                              for rank in ranks) for k in r[mode]["launches"]}
            res["scan"][name] = r
    res["flagship"] = {}
    for ranks, first in ((got, 1), (got4, 0)):
        for j in range(first, len(ranks[0]) - 1):  # the last job is phase 8f's
            for name, r in ranks[0][j].items():
                # the kernels every rank launched
                r["launches"] = {k: sum(rank[j][name]["launches"][k] for rank in ranks)
                                 for k in r["launches"]}
                res["flagship"][name] = r
    fast = run_ranks(2, work, [("sharded_fast_step", {"num_data": 1, "num_model": 2,
                                                      "mode": "dedup", "seed": seed,
                                                      "work": str(work)})])
    res["fast_step"] = dict(fast[0][0])
    res["fast_step"]["launches"] = {k: sum(r[0]["launches"][k] for r in fast)
                                    for k in fast[0][0]["launches"]}
    res["fast_step"]["update_rel_l2_ranks"] = [r[0]["update_rel_l2"] for r in fast]
    res["fast_step"]["mv_rel_l2_ranks"] = [r[0]["mv_rel_l2"] for r in fast]
    res["cli"] = sharded_cli(work, seed)
    return res


KERNELS = {
    "embedding_lookup": ("rectpu_torch/kernels/csrc/embedding_lookup.cu",
                         "rectpu/ops/embedding.py:70"),
    # the gather's int8 mode; rectpu's dequantizing gather is XLA, not Pallas
    "embedding_lookup_int8": ("rectpu_torch/kernels/csrc/embedding_lookup.cu",
                              "rectpu/serve/quant.py:53"),
    "fm_cross": ("rectpu_torch/kernels/csrc/fm.cu", "rectpu/ops/fm.py:271"),
    "fm_cross_bwd": ("rectpu_torch/kernels/csrc/fm.cu", "rectpu/ops/fm.py:281"),
    "scatter_rows": ("rectpu_torch/kernels/csrc/scatter_rows.cu",
                     "rectpu/ops/scatter_rows.py:78, rectpu/ops/scatter_rows.py:123, "
                     "rectpu/ops/embedding.py:81"),
    "fused_adam": ("rectpu_torch/kernels/csrc/fused_adam.cu", "rectpu/ops/fused_adam.py:51"),
    "interaction": ("rectpu_torch/kernels/csrc/interaction.cu",
                    "rectpu/ops/interaction.py:55, rectpu/ops/interaction.py:77"),
    "cin": ("rectpu_torch/kernels/csrc/cin.cu", "rectpu/ops/cin.py:70, rectpu/ops/cin.py:88"),
    "cin_dw": ("rectpu_torch/kernels/csrc/cin.cu", "rectpu/ops/cin.py:101"),
    # the fp32 forms: 3xTF32 on mma.sync (cin_tf32_kernel, cin_dw_tf32_kernel)
    "cin_fp32": ("rectpu_torch/kernels/csrc/cin.cu",
                 "rectpu/ops/cin.py:70, rectpu/ops/cin.py:88"),
    "cin_dw_fp32": ("rectpu_torch/kernels/csrc/cin.cu", "rectpu/ops/cin.py:101"),
    "scatter_rows_dma": ("rectpu_torch/kernels/csrc/scatter_dma.cu",
                         "rectpu/ops/scatter_dma.py:49"),
    # the dedupe's segment sum runs the scatter kernel on segment ordinals; in
    # rectpu it is XLA's jax.ops.segment_sum, not a Pallas kernel
    "segment_sum": ("rectpu_torch/kernels/csrc/scatter_rows.cu", "rectpu/train/sparse.py:104"),
    "fm_cross_flat": ("rectpu_torch/kernels/csrc/fm.cu", "rectpu/ops/fm.py:146"),
    "fm_cross_flat_bwd": ("rectpu_torch/kernels/csrc/fm.cu", "rectpu/ops/fm.py:156"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the full results here as JSON")
    ap.add_argument("--check3", choices=["on", "off"], default="off",
                    help="also run check (3)(b), the 20,000-step reference-default DeepFM "
                         "run, which takes longer than the rest (default: %(default)s)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    gpu = gpu_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {gpu}")

    # 1. build
    t0 = time.perf_counter()
    for r in build.build():
        print(f"build: {r.name} -> {r.path.name} in {r.seconds:.2f} s")
        for kernel, regs, spill in ptxas_report(r.log):
            print(f"  ptxas {r.name}: {kernel}: {regs} registers, {spill} bytes spilled")
    print(f"build: all kernels in {time.perf_counter() - t0:.2f} s")
    lib_path, lib_s = native_build.build()
    native.load()
    print(f"build: native host library {lib_path.name} (g++) in {lib_s:.2f} s")

    # 2-3. kernels against their plain versions
    gen = torch.Generator().manual_seed(args.seed)
    errs = check_kernels(dev, gen)
    errs.update(check_train_kernels(dev, gen))
    errs.update(check_zoo_kernels(dev, gen))
    errs.update(check_fast_kernels(dev, gen))
    errs.update(check_flat_kernels(dev, gen))

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    main_path, exports, export_s = {}, {}, {}
    try:
        # 4. the serving path, bf16 then fp32
        for label, compute, sizes in (("deep_fm_k64_bf16", "bfloat16", (1, 64, 512)),
                                      ("deep_fm_k64_fp32", None, (1, 64, 512))):
            t0 = time.perf_counter()
            export_dir = exports[label] = make_export(work / label, compute, gen)
            export_s[label] = time.perf_counter() - t0
            main_path[label] = serve_and_check(export_dir, label, args.seed, sizes)
            res = main_path[label]
            print(f"serving path {label}: launches {res['launches']} over "
                  f"{res['metrics']['batches_dispatched']} device batches, max |logit - CPU| "
                  f"{res['max_logit_err']:.3g}; /predict median ms "
                  f"{ {n: round(t, 3) for n, t in res['latency_ms'].items()} }; one "
                  f"{res['breakdown_ms']['instances']}-instance request outside HTTP, median "
                  f"ms: parse {res['breakdown_ms']['parse']:.3f} native / "
                  f"{res['breakdown_ms']['parse_python']:.3f} Python, encode "
                  f"{res['breakdown_ms']['encode']:.3f} native / "
                  f"{res['breakdown_ms']['encode_python']:.3f} Python, forward "
                  f"{res['breakdown_ms']['forward']:.3f} [{gpu}]")
            prof = res["forward_profile"]
            busy = ("not measured (no device events in the trace)"
                    if prof["device_busy_ms"] is None else f"{prof['device_busy_ms']:.4f} ms")
            print(f"profile {label}: {prof['instances']}-row forward {prof['wall_ms']:.3f} ms "
                  f"wall, device busy {busy}; top kernels "
                  f"{[(k, round(t, 4)) for k, t in prof['top_kernels_ms']]} [{gpu}]")
        # DLRM (lookup + interaction) and xDeepFM (lookup + CIN) exports
        for family in ("dlrm", "xdeep_fm"):
            for compute, tag in (("bfloat16", "bf16"), (None, "fp32")):
                own = (int_ops.launches if family == "dlrm" else
                       cin_ops.launches if compute else cin_ops.launches_fp32)
                label = f"{family}_k64_{tag}"
                t0 = time.perf_counter()
                export_dir = exports[label] = make_zoo_export(work / label, family, compute, gen)
                export_s[label] = time.perf_counter() - t0
                res = main_path[label] = serve_and_check(export_dir, label, args.seed, (1, 512),
                                                         (emb_ops.launches, own))
                prof = res["forward_profile"]
                print(f"serving path {label}: launches {res['launches']} over "
                      f"{res['metrics']['batches_dispatched']} device batches, max |logit - "
                      f"CPU| {res['max_logit_err']:.3g}; /predict median ms "
                      f"{ {n: round(t, 3) for n, t in res['latency_ms'].items()} }; "
                      f"{prof['instances']}-row forward {prof['wall_ms']:.3f} ms wall, device "
                      f"busy {prof['device_busy_ms']} ms [{gpu}]")
        print(f"export: seconds to write each export (arrays.npz, model.json and the "
              f"apply.pt2 program) { {k: round(v, 3) for k, v in export_s.items()} }")
        main_path["export_s"] = export_s

        # 4b. int8 tables (the port's quantize CLI, --table-quant int8), the
        # serialized programs (--serialized) and batch prediction
        int8 = main_path["int8_serving"] = int8_serving(work, args.seed, exports)
        for label, res in int8.items():
            extra = (f"; quantized in {res['quantize_s']:.2f} s, arrays.npz {res['npz_bytes']}"
                     if "quantize_s" in res else "")
            print(f"serving path {label}: launches {res['launches']}, max |logit - CPU int8| "
                  f"{res['max_logit_err']:.3g}, max |probability - float model| "
                  f"{res['max_prob_err_vs_float']:.3g}; /predict median ms "
                  f"{ {n: round(t, 3) for n, t in res['latency_ms'].items()} }; 512-row "
                  f"forward {res['forward_profile']['wall_ms']:.3f} ms wall, device busy "
                  f"{res['forward_profile']['device_busy_ms']} ms{extra} [{gpu}]")
        ser = main_path["serialized_serving"] = serialized_serving(work, args.seed, exports)
        for label, res in ser.items():
            print(f"serving path {label}: apply.pt2 {res['program_bytes']} bytes (arrays.npz "
                  f"{res['npz_bytes']}), loaded on the card in {res['load_s']:.3f} s; launches "
                  f"{res['launches']}, max |logit - CPU eager| {res['max_logit_err']:.3g}; "
                  f"/predict median ms "
                  f"{ {n: round(t, 3) for n, t in res['latency_ms'].items()} }; 512-row "
                  f"forward {res['forward_profile']['wall_ms']:.3f} ms wall, device busy "
                  f"{res['forward_profile']['device_busy_ms']} ms; kernels in its trace "
                  f"{res['forward_profile']['kernels']} [{gpu}]")
        bp = main_path["batch_predict"] = batch_prediction(work, args.seed,
                                                           exports["deep_fm_k64_fp32"])
        for tag, res in bp.items():
            print(f"batch prediction {tag} (deep_fm_k64_fp32, --label-col rating, batch 4096): "
                  f"{res['rows']} rows in {res['seconds']:.3f} s ({res['rows_per_s']:.0f} "
                  f"rows/s); launches {res['launches']}; metrics {res['metrics']}; max |logit "
                  f"- online| {res['max_logit_err']:.3g} [{gpu}]")

        # 5. the training path: the trainer CLI, then its export served
        train = main_path["train_cli"] = train_cli(work, args.seed)
        print(f"training path (trainer CLI, preset scaled, K={K}, [256, 128], batch "
              f"{TRAIN_BATCH}, {TRAIN_STEPS} steps): launches {train['launches']}; mean loss "
              f"first 10 steps {train['loss_first10']:.5f}, last 10 {train['loss_last10']:.5f}; "
              f"final eval {train['metrics']}; {train['seconds']:.2f} s with data load and "
              f"evals; its export answered /predict {train['predict']} [{gpu}]")
        for family, cli in (("dlrm", dlrm_cli), ("xdeep_fm", xdeep_fm_cli)):
            train = main_path[f"train_cli_{family}"] = train_cli(
                work, args.seed, cli, family, zoo_counters(family), steps=ZOO_CLI_STEPS)
            print(f"training path ({family} trainer CLI, preset scaled, K={K}, [256, 128], "
                  f"batch {TRAIN_BATCH}, {ZOO_CLI_STEPS} steps): launches {train['launches']}; "
                  f"mean loss first 10 steps {train['loss_first10']:.5f}, last 10 "
                  f"{train['loss_last10']:.5f}; final eval {train['metrics']}; "
                  f"{train['seconds']:.2f} s with data load and evals; its export answered "
                  f"/predict {train['predict']} [{gpu}]")

        # 5c. the Linear, DNN and Wide&Deep trainer CLIs, their exports served,
        # and one DNN and one Wide&Deep step against a CPU copy
        fams = main_path["family_clis"] = family_clis(work, args.seed)
        for label, _, model_args in FAMILY_CLIS:
            res, srv = fams[label], fams[label]["serving"]
            print(f"training path ({label} trainer CLI, {' '.join(model_args) or 'defaults'}, "
                  f"batch {TRAIN_BATCH}, {TRAIN_STEPS} steps, its default optimizer): launches "
                  f"{res['launches']}; mean loss first 10 steps {res['loss_first10']:.5f}, "
                  f"last 10 {res['loss_last10']:.5f}; final eval {res['metrics']}; "
                  f"{res['seconds']:.2f} s with data load and evals; its export served: "
                  f"launches {srv['launches']}, max |logit - CPU| {srv['max_logit_err']:.3g}, "
                  f"/predict median ms "
                  f"{ {n: round(t, 3) for n, t in srv['latency_ms'].items()} } [{gpu}]")
        for family in ("deep", "linear_deep"):
            st = main_path[f"family_step_{family}"] = check_family_step(family, dev, gen, work)
            print(f"check: {family} step ({st['optimizer']}) card vs CPU: loss "
                  f"{st['loss_cuda']:.6f} vs {st['loss_cpu']:.6f}; update relative L2 per "
                  f"leaf { {k: float(f'{v:.3g}') for k, v in st['rel_l2'].items()} }")

        # 5e. the DCN and AutoInt trainer CLIs (DCN also through the streaming
        # input, the best exporter and the sparse fast step), their event files
        # and exports served, and AutoInt's three attention forms card vs CPU
        zoo2 = main_path["zoo2_clis"] = zoo2_clis(work, args.seed)
        for label, _, extra, _ in ZOO2_CLIS:
            res, srv = zoo2[label], zoo2[label]["serving"]
            print(f"training path ({label} trainer CLI, {' '.join(SCALED_ARGS + extra)}, batch "
                  f"{TRAIN_BATCH}, {TRAIN_STEPS} steps): launches {res['launches']}; mean loss "
                  f"first 10 steps {res['loss_first10']:.5f}, last 10 {res['loss_last10']:.5f}; "
                  f"final eval {res['metrics']}; {res['seconds']:.2f} s with data load and "
                  f"evals; event records (step, values) {res['event_records']}"
                  f"{'; best ' + str(res['best_metric']) if 'best_metric' in res else ''}; its "
                  f"export served: launches {srv['launches']}, max |logit - CPU| "
                  f"{srv['max_logit_err']:.3g}, /predict median ms "
                  f"{ {n: round(t, 3) for n, t in srv['latency_ms'].items()} } [{gpu}]")
        forms = main_path["autoint_forms"] = autoint_forms(dev, gen)
        print(f"check: autoint attention forms card vs CPU (zoo model, bf16, B="
              f"{AUTOINT_FORMS_ROWS}): max |logit difference| {forms}")

        # 5f. the dispatch modes: scan (a CUDA graph of the step) against pipelined
        disp = main_path["dispatch"] = dispatch_phase(work, args.seed)
        for label in ("parity_cli_hash", "parity_cli_threefry", *(
                f"family_{f}" for f, _, _ in FAMILY_DISPATCH)):
            r = disp[label]
            print(f"dispatch {label} (trainer CLI): scan equal to pipelined bit for bit in "
                  f"the losses, {r['leaves_compared']} leaves and the eval "
                  f"{r['metrics_scan']}; {r['replays']} graph replays of "
                  f"{sum(r['per_replay'].values())} launches of the port's kernels each "
                  f"{r['per_replay']}"
                  + (f"; --profile-dir's trace names {r['trace_kernels']}"
                     if "trace_kernels" in r else "") + f" [{gpu}]")
        for label in ("parity", "flagship", "fast_step"):
            r = disp[label]
            sc, pi = r["scan"], r["pipelined"]
            print(f"dispatch {label}: wall ms a step scan {sc['wall_ms']:.4f} vs pipelined "
                  f"{pi['wall_ms']:.4f}; device busy ms a step scan {sc['busy_ms']} vs "
                  f"pipelined {pi['busy_ms']} in {sc['device_launches']:.1f} vs "
                  f"{pi['device_launches']:.1f} device launches; host aten ops a step scan "
                  f"{sc['host_aten_ops']:.2f} vs pipelined {pi['host_aten_ops']:.2f}; "
                  f"{sc['replays']} replays, launches {sc['launches']} both ways, bitwise "
                  f"equal over {r['leaves_compared']} leaves; top kernels under scan "
                  f"{sc['top_kernels_ms']}; host ops a step under scan {sc['top_host_ops']} "
                  f"[{gpu}]")
        print(f"dispatch: under a plan on the card auto resolves by the batch "
              f"{disp['plan_auto']} (rectpu's rule)")

        # 5d. check (3)(b): the reference-default DeepFM run
        if args.check3 == "on":
            c3 = main_path["check3"] = check3_default_run(work)
            print(f"check (3)(b): DeepFM trainer CLI at the reference defaults, seed "
                  f"{c3['seed']}, {c3['steps']} steps on the synthetic ml-100k: streaming AUC "
                  f"{c3['auc']:.7f} beside rectpu's pin {c3['pin']} (gap {c3['gap']:+.7f}, "
                  f"{'within' if c3['within_gate'] else 'outside'} the {CHECK3_GATE} gate); "
                  f"{c3['seconds']:.1f} s wall with evals [{gpu}]")

        # 5b. --autotune and --profile-dir through the DeepFM trainer CLI
        train = main_path["train_cli_autotune"] = autotune_cli(work, args.seed)
        print(f"training path (deep_fm trainer CLI, preset scaled, --autotune --profile-dir, "
              f"batch {TRAIN_BATCH}, {AUTOTUNE_CLI_STEPS} steps, window "
              f"{AUTOTUNE_CLI_LOOP}): launches {train['launches']}; {train['autotune_log']}; "
              f"mean loss first 10 steps {train['loss_first10']:.5f}, last 10 "
              f"{train['loss_last10']:.5f}; final eval {train['metrics']}; "
              f"{train['seconds']:.2f} s with the autotuner, data load and evals; trace "
              f"{train['trace']} [{gpu}]")

        # 6. the flagship step
        flag = main_path["flagship_step"] = flagship_step(dev, gen, work)
        busy = flag["profile"]["device_busy_ms"]
        print(f"flagship step (bench.py config, batch {FLAGSHIP_BATCH}): median "
              f"{flag['step_ms']:.4f} ms, {flag['examples_per_s']:.0f} examples/s; launches per "
              f"step {flag['launches_per_step']}; device busy "
              f"{'not measured' if busy is None else f'{busy:.4f} ms'} per step in "
              f"{flag['profile']['device_launches']:.0f} device launches (FM forward "
              f"{flag['profile']['fm_fwd_device_ms']:.4f} ms, FM backward "
              f"{flag['profile']['fm_bwd_device_ms']:.4f} ms); top kernels "
              f"{[(k, round(t, 4)) for k, t in flag['profile']['top_kernels_ms']]}; host: "
              f"{flag['profile']['host_aten_ops']:.0f} aten ops per step, by own CPU ms "
              f"{[(k, n, round(t, 3)) for k, n, t in flag['profile']['top_host_ops_ms']]} "
              f"[{gpu}]")
        grads = main_path["flagship_grads"] = check_flagship_grads(dev, gen, work)
        print(f"check: flagship step gradients card vs CPU: loss {grads['loss_cuda']:.6f} vs "
              f"{grads['loss_cpu']:.6f}; relative L2 per leaf "
              f"{ {k: float(f'{v:.3g}') for k, v in grads['rel_l2'].items()} }")

        # 6b. the DLRM and xDeepFM zoo steps
        for family, rows in (("dlrm", FLAGSHIP_BATCH), ("xdeep_fm", 512)):
            zoo = main_path[f"zoo_step_{family}"] = zoo_step(family, dev, gen, work)
            busy = zoo["profile"]["device_busy_ms"]
            print(f"zoo step {family} (_bench_zoo.py config, batch {FLAGSHIP_BATCH}): median "
                  f"{zoo['step_ms']:.4f} ms, {zoo['examples_per_s']:.0f} examples/s; launches "
                  f"per step {zoo['launches_per_step']}; device busy "
                  f"{'not measured' if busy is None else f'{busy:.4f} ms'} per step in "
                  f"{zoo['profile']['device_launches']:.0f} device launches; top kernels "
                  f"{[(k, round(t, 4)) for k, t in zoo['profile']['top_kernels_ms']]}; host: "
                  f"{zoo['profile']['host_aten_ops']:.0f} aten ops per step [{gpu}]")
            grads = main_path[f"zoo_grads_{family}"] = check_zoo_grads(family, dev, gen, work,
                                                                       rows)
            print(f"check: {family} zoo step gradients card vs CPU ({rows} rows): loss "
                  f"{grads['loss_cuda']:.6f} vs {grads['loss_cpu']:.6f}; relative L2 per leaf "
                  f"{ {k: float(f'{v:.3g}') for k, v in grads['rel_l2'].items()} }")

        # 6b'. the xDeepFM zoo step in fp32 (the trainer CLIs' default type)
        zoo = main_path["zoo_step_xdeep_fm_fp32"] = zoo_step("xdeep_fm", dev, gen, work, fp32=True)
        prof = zoo["profile"]
        busy = prof["device_busy_ms"]
        share = ("not measured" if busy is None else
                 f"{prof['cin_device_ms']:.4f} ms ({100 * prof['cin_device_ms'] / busy:.1f} %)")
        print(f"zoo step xdeep_fm fp32 (_bench_zoo.py config with fp32 towers, table "
              f"cotangent and Adam slots, batch {FLAGSHIP_BATCH}): median {zoo['step_ms']:.4f} "
              f"ms, {zoo['examples_per_s']:.0f} examples/s; launches per step "
              f"{zoo['launches_per_step']}; device busy "
              f"{'not measured' if busy is None else f'{busy:.4f} ms'} per step in "
              f"{prof['device_launches']:.0f} device launches, the CIN kernels {share}; top "
              f"kernels {[(k, round(t, 4)) for k, t in prof['top_kernels_ms']]}; host: "
              f"{prof['host_aten_ops']:.0f} aten ops per step [{gpu}]")
        grads = main_path["zoo_grads_xdeep_fm_fp32"] = check_zoo_grads(
            "xdeep_fm", dev, gen, work, 512, fp32=True)
        print(f"check: xdeep_fm fp32 zoo step gradients card vs CPU (512 rows): loss "
              f"{grads['loss_cuda']:.6f} vs {grads['loss_cpu']:.6f}; relative L2 per leaf "
              f"(limit {FP32_GRAD_REL_L2:g}) "
              f"{ {k: float(f'{v:.3g}') for k, v in grads['rel_l2'].items()} }")

        # 6d. the DCN (full rank and rank 256) and AutoInt zoo steps
        for family in ("dcn", "dcn_low_rank", "autoint"):
            zoo = main_path[f"zoo_step_{family}"] = zoo_step(family, dev, gen, work)
            prof = zoo["profile"]
            busy = prof["device_busy_ms"]
            cross = ""
            if "cross" in zoo:
                c = zoo["cross"]
                share = ("" if busy is None else
                         f", {100 * c['ms'] / busy:.1f} % of the busy time")
                cross = (f"; the cross layers forward and backward {c['ms']:.4f} ms (fp32 "
                         f"GEMMs, bound {c['bound_ms']:.4f} ms by operations{share})")
            print(f"zoo step {family} (_bench_zoo.py config, batch {FLAGSHIP_BATCH}): median "
                  f"{zoo['step_ms']:.4f} ms, {zoo['examples_per_s']:.0f} examples/s; launches "
                  f"per step {zoo['launches_per_step']}; peak memory "
                  f"{zoo['peak_mem_gib']:.3f} GiB; device busy "
                  f"{'not measured' if busy is None else f'{busy:.4f} ms'} per step in "
                  f"{prof['device_launches']:.0f} device launches{cross}; top kernels "
                  f"{[(k, round(t, 4)) for k, t in prof['top_kernels_ms']]}; host: "
                  f"{prof['host_aten_ops']:.0f} aten ops per step [{gpu}]")
            grads = main_path[f"zoo_grads_{family}"] = check_zoo_grads(family, dev, gen, work,
                                                                       512)
            print(f"check: {family} zoo step gradients card vs CPU (512 rows): loss "
                  f"{grads['loss_cuda']:.6f} vs {grads['loss_cpu']:.6f}; relative L2 per leaf "
                  f"{ {k: float(f'{v:.3g}') for k, v in grads['rel_l2'].items()} }")

        # 6c. the sparse fast step at full width, against a CPU copy, and its CLI
        fast = main_path["fast_step"] = fast_step_full_width(dev, args.seed, work)
        busy = fast["profile"]["device_busy_ms"]
        busy_txt = ("not measured" if busy is None else
                    f"{busy:.4f} ms ({100 * fast['device_busy_share']:.1f} % of the step)")
        print(f"fast step (_ablate_bigtable.py run_sparse packed dma: table "
              f"[{fast['v_rows']}, 128] fp32, m|v [{fast['v_rows']}, 256] fp32, batch "
              f"{BIG_BATCH}, capacity {fast['capacity']} rows): median {fast['step_ms']:.4f} ms "
              f"over {BIG_STEPS} steps, {fast['examples_per_s']:.0f} examples/s; launches per "
              f"step {fast['launches_per_step']}; device busy {busy_txt} per step in "
              f"{fast['profile']['device_launches']:.0f} device launches (FM forward "
              f"{fast['profile']['fm_fwd_device_ms']:.4f} ms, FM backward "
              f"{fast['profile']['fm_bwd_device_ms']:.4f} ms); top kernels "
              f"{[(k, round(t, 4)) for k, t in fast['profile']['top_kernels_ms']]}; host: "
              f"{fast['profile']['host_aten_ops']:.0f} aten ops per step; one step changed "
              f"{fast['rows_changed_by_a_step']} of the {fast['rows_touched_by_a_step']} rows "
              f"its batch touched and no other [{gpu}]")
        grads = main_path["fast_step_vs_cpu"] = check_fast_step_vs_cpu(dev, args.seed, work)
        print(f"check: fast step card vs CPU at [{padded_rows(bench_feature_set())}, 128]: loss "
              f"{grads['loss_cuda']:.6f} vs {grads['loss_cpu']:.6f}; relative L2 "
              f"{ {k: float(f'{v:.3g}') for k, v in grads['rel_l2'].items()} }")
        train = main_path["train_cli_fast"] = train_cli(
            work, args.seed, deep_fm_cli, "deep_fm_fast_step",
            (emb_ops.launches, fm_ops.launches, fm_ops.bwd_launches, dma_ops.launches,
             scatter_ops.segment_launches),
            extra_args=("--fast-step", "on", "--sparse-scatter", "dma"))
        print(f"training path (deep_fm trainer CLI, preset scaled, --fast-step on "
              f"--sparse-scatter dma, batch {TRAIN_BATCH}, {TRAIN_STEPS} steps): launches "
              f"{train['launches']}; mean loss first 10 steps {train['loss_first10']:.5f}, last "
              f"10 {train['loss_last10']:.5f}; final eval {train['metrics']}; "
              f"{train['seconds']:.2f} s with data load and evals; its export answered "
              f"/predict {train['predict']} [{gpu}]")

        # 8. sharded training on the one card
        sh = main_path["sharded"] = sharded_phases(work, args.seed)
        nc, co = sh["nccl"], sh["collectives"]
        print(f"sharded (a) collectives: NCCL, world size 1 on cuda:0, ran {nc['ops']}; "
              f"{co['backend']}, 2 ranks on cuda:0: each autograd collective forward and "
              f"backward against its definition, max error {co['max_err']} (bound 0); the "
              f"port hands Gloo CUDA tensors, which Gloo copies through host memory itself "
              f"[{gpu}]")
        for name, r in sh["flagship"].items():
            control = name.endswith("int8-control")
            loss_bound, update_bound = ((INT8_LOSS_RTOL, INT8_UPDATE_REL_L2) if "int8" in name
                                        else (SHARD_LOSS_RTOL, SHARD_UPDATE_REL_L2))
            ev = (f"; eval {r['eval']} vs one process {r['eval_single']} (rtol "
                  f"{INT8_LOSS_RTOL if 'int8' in name else SHARD_EVAL_RTOL}), the checkpoint "
                  f"read back" if "eval" in r else "")
            tp = " tp" in name
            beside = ("" if name.endswith("dlrm") else f" beside the single-process step's "
                      f"{flag['step_ms']:.4f} ms (phase 6)")
            print(f"sharded ({'e' if tp else 'b'}) "
                  + ("tensor-parallel towers (--tp-mlp), " if tp else "")
                  + f"{'DLRM zoo' if name.endswith('dlrm') else 'flagship'} step mesh {name} "
                  f"({r['backend']}, every rank on cuda:0, the Trainer's batches): median "
                  f"{r['step_ms']:.4f} ms a step{beside}; per-step "
                  f"loss max relative error {r['loss_rel_err']:.3g} (bound {loss_bound}); each "
                  f"leaf's {SHARD_STEPS}-step update vs the single process, relative L2 (bound "
                  f"{update_bound}) { {k: float(f'{v:.3g}') for k, v in r['update_rel_l2'].items()} }"
                  + (" -- a control: the check refused it" if control else ev)
                  + ("; checkpoint leaves in the global shapes"
                     if r.get("checkpoint_global_shapes") else "")
                  + f"; launches on all ranks {r['launches']} [{gpu}]")
        fs_ = sh["fast_step"]
        print(f"sharded (c) fast step mesh 1x2 {fs_['mode']} ({fs_['backend']}, every rank on "
              f"cuda:0, [{fs_['v_shard']}, 128] fp32 table and [{fs_['v_shard']}, 256] m|v a "
              f"rank): median {fs_['step_ms']:.4f} ms a step beside the single-process "
              f"step's {fast['step_ms']:.4f} ms (phase 6c); per-step loss max relative error "
              f"{fs_['loss_rel_err']:.3g} (bound {SHARD_LOSS_RTOL}); update relative L2 per "
              f"rank {fs_['update_rel_l2_ranks']}, m|v {fs_['mv_rel_l2_ranks']} (bound "
              f"{SHARD_UPDATE_REL_L2}); launches on all ranks {fs_['launches']}; peak memory "
              f"of rank 0 {fs_['peak_mem_gib']:.2f} GiB [{gpu}]")
        for name, r in sh["scan"].items():
            sc, pi = r["scan"], r["pipelined"]
            print(f"sharded (f) scan under a plan, {name} (gloo, every rank on cuda:0, "
                  f"{SCAN_LOOPS} steps a loop): bitwise pipelined in every loss share, "
                  f"{r['leaves_compared']} parameter and state leaves a rank and the eval; "
                  f"{sc['segments']} graph segments around {sc['collectives']} collectives a "
                  f"step, {sc['replays']} replays; host aten ops a rank and step scan "
                  f"{sc['host_aten_ops']:.2f} (busiest rank {sc['host_aten_ops_max']:.2f}) vs "
                  f"pipelined {pi['host_aten_ops']:.2f} ({pi['host_aten_ops_max']:.2f}); wall "
                  f"ms a step scan {sc['wall_ms']:.4f} vs pipelined {pi['wall_ms']:.4f}; "
                  f"launches on all ranks, the same both ways {sc['launches']} [{gpu}]")
        cli = sh["cli"]
        tr = cli["trace_2"]
        print(f"sharded (d) DeepFM CLI under torchrun, 2 ranks (dedup, freq placement, "
              f"capacity auto -> {cli['peer_capacity']}), batch {SHARD_CLI_BATCH} (scan: "
              f"(segments, collectives) a rank {cli['segments_2']}), {SHARD_CLI_STEPS} steps, "
              f"{cli['seconds_2']:.1f} s, against 1 rank "
              f"({cli['seconds_1']:.1f} s): eval {cli['metrics_2']} vs {cli['metrics_1']}; "
              f"param digest {cli['digest_2']:.6f} vs {cli['digest_1']:.6f} (rtol "
              f"{CLI_METRIC_RTOL}, atol {CLI_METRIC_ATOL}; digest rtol {CLI_DIGEST_RTOL}); its "
              f"export answered {cli['served_2']} predictions [{gpu}]")
        print(f"sharded (f) the same 2-rank CLI pipelined, {cli['seconds_2_pipelined']:.1f} s: "
              f"bitwise the scan run in the eval and {cli['leaves_compared_2']} checkpoint "
              f"leaves; rank 0's traced window (steps 50-99): host aten ops a step scan "
              f"{tr['scan']['host_aten_ops']:.2f} vs pipelined "
              f"{tr['pipelined']['host_aten_ops']:.2f}; the port's kernels, the same both "
              f"ways {tr['scan']['kernels']} [{gpu}]")
        print(f"sharded (e) DeepFM CLI under torchrun, 2 ranks, the same flags and --tp-mlp, "
              f"{cli['seconds_tp_2']:.1f} s: eval {cli['metrics_tp_2']} vs one rank's; param "
              f"digest {cli['digest_tp_2']:.6f} vs {cli['digest_1']:.6f} (the same bounds); "
              f"its export answered {cli['served_tp_2']} predictions [{gpu}]")
        print(f"sharded: these times are 2 or 4 processes on one card over Gloo and say "
              f"nothing of NCCL across cards [{gpu}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 7. times
    floor, rows = time_kernels(dev, gen)
    train_rows = (time_train_kernels(dev, gen) + time_zoo_kernels(dev, gen)
                  + time_fast_kernels(dev, gen) + time_flat_kernels(dev, gen))
    scatter_parts = profile_scatter(dev, gen)
    print(f"time: floor of this method (a one-element add) {floor:.4f} ms [{gpu}]")
    for label, parts in scatter_parts.items():
        print(f"profile scatter_rows {label}: {parts['ops_per_call']:g} device operations a "
              f"call; device ms per call by operation "
              f"{[(k, round(t, 4)) for k, t in parts['ms_by_op']]} [{gpu}]")
    for r in rows + train_rows:
        if not r.get("kernel", True):
            print(f"time: {r['name']} {r['dtype']} {r['shape']} (plain PyTorch around the "
                  f"kernels): {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                  f"[{gpu}]")
            continue
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        if r.get("library"):
            lib += f" ({r['library']})"
        at = f"B={r['batch']}" if "batch" in r else f"rows={r.get('v_rows', r.get('updates'))}"
        if "mode" in r:
            at += f" {r['mode']} products"
        tf32 = (f", 3xTF32 bound {r['bound_3xtf32_ms']:.4f} ms" if "bound_3xtf32_ms" in r
                else "")
        if "index_ms" in r:
            tf32 += f", as a row shard (a nonzero index base) {r['index_ms']:.4f} ms"
        if "cast_then_gather_ms" in r:
            tf32 += f", the table cast then the kernel {r['cast_then_gather_ms']:.4f} ms"
        if "composite_ms" in r:
            tf32 += (f", the four-op composite {r['composite_ms']:.4f} ms, the fp32 gather of "
                     f"the same rows {r['fp32_gather_ms']:.4f} ms")
        print(f"time: {r['name']} {r['dtype']} {r.get('shape', '')} {r.get('call', '')} {at}: "
              f"kernel {r['ms']:.4f} ms (L2-warm {r['warm_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, library {lib} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}){tf32} [{gpu}]")

    # launches: the serving path for the serving kernels, the trainer CLIs for
    # the training kernels (DeepFM's; DLRM's for the interaction, xDeepFM's for
    # the CIN), the flagship step for fused Adam (the CLIs' Adam, like rectpu's,
    # names no fused leaves), the full-width fast step for the row set and the
    # dedupe's segment sum, the --autotune CLI for the flat FM (its autotuner)
    launches = {**main_path["deep_fm_k64_bf16"]["launches"],
                **main_path["train_cli"]["launches"],
                "fused_adam": main_path["flagship_step"]["launches"]["fused_adam"],
                "interaction": main_path["train_cli_dlrm"]["launches"]["interaction"],
                "cin": main_path["train_cli_xdeep_fm"]["launches"]["cin"],
                "cin_dw": main_path["train_cli_xdeep_fm"]["launches"]["cin_dw"],
                "cin_fp32": main_path["zoo_step_xdeep_fm_fp32"]["launches"]["cin_fp32"],
                "cin_dw_fp32": main_path["zoo_step_xdeep_fm_fp32"]["launches"]["cin_dw_fp32"],
                "scatter_rows_dma": main_path["fast_step"]["launches"]["scatter_rows_dma"],
                "segment_sum": main_path["fast_step"]["launches"]["segment_sum"],
                "fm_cross_flat": main_path["train_cli_autotune"]["launches"]["fm_cross_flat"],
                "fm_cross_flat_bwd":
                    main_path["train_cli_autotune"]["launches"]["fm_cross_flat_bwd"]}
    # the lookup and the scatter: the DeepFM CLI's and the families' CLIs' runs
    # (the DCN fast-step CLI's row sets and segment sums beside the fast step's)
    runs = [*main_path["family_clis"].values(), *main_path["zoo2_clis"].values()]
    for name in ("embedding_lookup", "scatter_rows", "scatter_rows_dma", "segment_sum"):
        launches[name] += sum(r["launches"].get(name, 0) for r in runs)
    # the sharded phases' ranks (phases 8b, 8c and 8e; not 8b's planted-fault control),
    sharded_runs = [*(r for name, r in main_path["sharded"]["flagship"].items()
                      if not name.endswith("control")),
                    main_path["sharded"]["fast_step"]]
    # and phase 8f's, both modes
    sharded_runs += [r[mode] for r in main_path["sharded"]["scan"].values()
                     for mode in ("scan", "pipelined")]
    for name in ("embedding_lookup", "fm_cross", "fm_cross_bwd", "scatter_rows", "segment_sum",
                 "fused_adam", "scatter_rows_dma", "interaction"):
        launches[name] += sum(r["launches"].get(name, 0) for r in sharded_runs)
    # phase 5f's drives, both modes (a graph replay's launches counted as its capture's)
    for case in ("parity", "flagship", "fast_step"):
        for mode in ("scan", "pipelined"):
            for name, n in main_path["dispatch"][case][mode]["launches"].items():
                launches[name] += n
    # the int8 gather: the int8 serving runs and the int8 batch prediction
    launches["embedding_lookup_int8"] = sum(
        r["launches"]["embedding_lookup_int8"]
        for r in [*main_path["int8_serving"].values(), main_path["batch_predict"]["int8"]])
    heads = {"embedding_lookup": ("bfloat16", 4096), "fm_cross": ("bfloat16", 4096),
             "embedding_lookup_int8": ("int8->bfloat16", 4096),
             "fm_cross_bwd": ("bfloat16", "flagship"), "scatter_rows": ("bfloat16", "flagship"),
             "fused_adam": ("m bf16, v bf16-SR", "flagship"),
             "interaction": ("bfloat16", FLAGSHIP_BATCH), "cin": ("bfloat16", f"H={CIN_O}"),
             "cin_dw": ("bfloat16", f"H={CIN_O}"),
             "cin_fp32": ("float32", f"H={CIN_O}"), "cin_dw_fp32": ("float32", f"H={CIN_O}"),
             "scatter_rows_dma": ("float32", "m|v C=256"), "segment_sum": ("float32", None),
             "fm_cross_flat": ("bfloat16", FLAGSHIP_BATCH),
             "fm_cross_flat_bwd": ("bfloat16", FLAGSHIP_BATCH)}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        dtype, at = heads[name]
        row_name = name.removesuffix("_fp32")
        head = next(r for r in rows + train_rows if r["name"] == row_name and r["dtype"] == dtype
                    and (at is None or at in (r.get("batch"), r.get("shape")))
                    and r.get("mode", "rounded") == "rounded")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "dtype": dtype, "at": at,
            **({"bound_3xtf32_ms": head["bound_3xtf32_ms"]} if "bound_3xtf32_ms" in head else {}),
            **{k: head[k] for k in ("composite_ms", "fp32_gather_ms") if k in head},
        })
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"gpu": gpu, "torch": torch.__version__, "kernels": kernels,
             "times": rows + train_rows, "floor_ms": floor, "scatter_profile": scatter_parts,
             "main_path": main_path, "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
