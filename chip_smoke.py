#!/usr/bin/env python3
"""Drive the PyTorch port's ``stream``, ``bench``, ``scaling``, ``eval``,
``quantize``, ``train`` and ``qat`` paths, its bf16 forwards, its
``parallel/`` paths, its per-stage breakdown, its stream variants, its
flagship pipeline and ``utils/profiler.py::trace`` on one NVIDIA GPU and
check them.

Usage, from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing JSON lines (``"phase": ...``):

1. device   -- the card's name and power limit (nvidia-smi), printed raw too.
2. build    -- compiles ``modulationdetectioncnn_torch/csrc/*.cu`` with nvcc
               for sm_90a (one nvcc per source, in parallel, then one link)
               and loads the library; build seconds and ptxas's report.
3. kernels  -- each of the eleven int8 kernels against its plain PyTorch
               version on the card, for six weight sets (the committed int8
               artifact, seeded random weights, the bench's own PTQ
               weights, a narrow model padded to the kernels' widths, a
               seeded model at the edge of the v9/v10 fold's contract
               (``scripts/probe.py::fold_edge_tree``: offsets to 16,711,680
               of the 2^24 bound, shifts 0 to 31), and a model the fold
               refuses, which runs on v7, v5, v6, v4, v3, v2 and v1 only,
               and which ``make_int8_predict`` refuses for v9 and v10 when
               it builds them), on 8192 seeded frames, on the stream
               demo's 1024 frames, at B=1, on a ragged 37-frame slice and on
               the bench's 4096 frames: 0 mismatching int8 activations over
               the whole valid map, 0 mismatching logits (v2's dense stage)
               and 0 mismatching labels, and every version giving the same
               labels. Rows 2 and 11 also at their edges
               (``scripts/probe.py::dense_edge_cases`` on the artifact):
               dense1 sums near 1.6e8 (a saturated map under +-127
               weights), a seeded map over all of [0, 127], and exact and
               one-ulp ties of the logits, each at B=4097 and 4095 (the
               last 128-frame tile ragged): 0 differing labels and logits.
               Where an earlier body of ``csrc/dense_argmax_int8.cu`` was
               copied to ``_build/dense_argmax_int8_old.cu`` (never
               committed), rows 2 and 11 are timed against it, old, new,
               new, old, at B=4096, 2048 and 16384, outputs bit for bit
               (``kernels.old_vs_new`` lines). The timing FIR against its
               plain version on the stream bench's 4096 normalized frames with their own timing
               estimates, on the demo's 1024 frames, at B=1, on a ragged
               37-frame slice, on the stream bench's 16384 frames and
               4095 and 4097 of them, at the wrap extremes of tau, with 1,
               3 and 9 taps (the window route), and on the general route
               (T 40 with 17 and 3 taps, T 300, frames 4 bytes past a
               16-byte boundary): 0 differing floats, each case on the
               route its widths give, the stream's widths on the window
               route alone. Where an earlier body of
               ``csrc/correct_timing.cu`` was copied to
               ``_build/correct_timing_old.cu`` (never committed), it is
               timed against it, old, new, new, old, at B=4096, 2048 and
               16384 beside the library call (``kernels.old_vs_new``). The five bf16 kernels (the v4, v2 and f32-conv1
               conv stages, the dense stage with labels and with logits)
               against their plain versions for three float weight sets
               (the bench's seeded model, the exported checkpoint, a
               narrow padded model) on the bench's 4096 frames, the demo's
               1024, B=1 and 37 frames: every map element within one bf16
               ulp plus 1e-3 of the map's largest magnitude (largest
               difference and bit-equal share printed), conv1 bit for bit
               through probe weights (demo and 37 frames), the v2 map
               equal to v4's bit for bit; labels >= 99.9 % equal with every
               difference a near-tie of the plain logits, logits within one
               bf16 ulp of every dense1 unit times |w4|, and the logits
               kernel's argmax equal to the labels kernel's labels. Rows 13
               and 16 also on ``scripts/probe.py::dense_bf16_edge_cases``
               (a map near 2^50 under +-max dense1 weights, exact and
               one-ulp ties, the narrow model) at B = 1, 37, 129, 2048,
               4095, 4096, 4097 and 16384 (tile and cluster edges), and the
               first 2048 frames' labels at B = 4096 and 16384 against
               B = 2048 (another cluster size, another order of dense1's
               sums: differences only at near-ties). Where an earlier body
               of ``csrc/dense_argmax_bf16.cu`` was copied to
               ``_build/dense_argmax_bf16_old.cu`` (never committed), rows
               13 and 16 are timed against it, old, new, new, old, at
               B=4096, 2048 and 16384 beside ``torch.matmul``'s dense1,
               outputs within the dense tolerances of each other.
               Row 1 (v7) also on ``scripts/probe.py::conv_v7_edge_cases``
               (quantize ties at exact halves, conv1 and conv2 sums at
               their largest of both signs, requantize shifts 0 to 23 with
               offsets at the clip's edges, the narrow model, a model the
               fold refuses) on 1031 frames each: 0 mismatching activations,
               and v5's and v1's maps (rows 5 and 10: v7's function from the
               same frames) equal to v7's there and on every weight set and
               input above. Where an earlier body of
               ``csrc/conv_stage_int8.cu`` was copied to
               ``_build/conv_stage_int8_old.cu`` (never committed), row 1
               is timed against it, old, new, new, old, at B=4096, 2048 and
               16384 beside ``_int_mm`` on conv2's im2col, maps bit for bit
               (``kernels.old_vs_new`` lines).
               The three bf16 conv stages (rows 15, 14, 12: 2-block
               clusters, one I/Q plane a block) also at the cluster edges
               B = 1, 2, 65, 66, 67, 131, 133, 4095 and 4097 on the bench's
               seeded model and the narrow one (maps within the bf16
               tolerance of the plain version, v2 equal to v4 bit for
               bit), and the same 2048 frames' map bit for bit at B = 2048,
               4096 and 16384. Where an earlier body of
               ``csrc/conv_stage_bf16_v4.cu`` was copied to
               ``_build/conv_stage_bf16_old.cu`` (never committed), rows
               15, 14 and 12 are timed against it, old, new, new, old, at
               B=4096, 2048 and 16384 beside ``torch.matmul``'s conv2, the
               maps within the bf16 tolerance of each other
               (``kernels.old_vs_new`` lines).
               Rows 3 and 4 (v10, v9: one body) also at B = 1, 37, 133,
               1031, 2048, 4095, 4096, 4097 and 16384 on the artifact, the
               seeded model and the fold-edge model, each map equal to the
               plain version's and to row 1's kernel map, and conv1's whole
               map on the artifact and the fold-edge model through 13
               pass-through probes of conv2
               (``scripts/probe.py::conv1_probe_trees``) at 1031 frames: 0
               mismatching activations; v5, v1, v9 and v10 equal to v7 map
               for map on every weight set and input above. Where an
               earlier body of ``csrc/conv_stage_int8_v10.cu`` was copied to
               ``_build/conv_stage_int8_v10_old.cu`` (never committed), rows
               3 and 4 are timed against it, old, new, new, old, at B=4096,
               2048 and 16384 beside row 1 and ``_int_mm`` on conv2's
               lane-packed product, maps bit for bit (``kernels.old_vs_new``
               lines).
               Rows 5 and 10 (v5, v1: one body, row 1's producers and
               consumer) also at B = 1, 37, 133, 1031, 2048, 4095, 4096,
               4097 and 16384 on the artifact, the seeded model and each
               of ``scripts/probe.py::conv_v7_edge_cases``'s models on its
               own frames, each map equal to the plain version's and to
               row 1's kernel map: 0 mismatching activations. Where an
               earlier body of ``csrc/conv_stage_int8_v5.cu`` was copied
               to ``_build/conv_stage_int8_v5_old.cu`` (never committed),
               rows 5 and 10 are timed against it, old, new, new, old, at
               B=4096, 2048 and 16384 beside row 1 and ``_int_mm`` on
               conv2's lane-packed product, maps bit for bit
               (``kernels.old_vs_new`` lines).
               Rows 6 and 7 (v6, v4: one body, row 1's producers reading
               tap planes and its consumer) also at B = 1, 37, 133, 1031,
               2048, 4095, 4096, 4097 and 16384 on the artifact, the seeded
               model and each of ``scripts/probe.py::conv_v7_edge_cases``'s
               models, on the tap planes of its own frames (each map equal
               to the plain version's and to row 1's kernel map of the
               frames) and on seeded random planes, all 8 planes and the two
               tail columns drawn (each map equal to the plain version's):
               0 mismatching activations. Where an earlier body of
               ``csrc/conv_stage_int8_v6.cu`` was copied to
               ``_build/conv_stage_int8_v6_old.cu`` (never committed, with
               the headers of its commit it includes beside it), rows
               6 and 7 are timed against it, old, new, new, old, at B=4096,
               2048 and 16384 beside rows 5 and 1 and ``_int_mm`` on
               conv2's lane-packed product, maps bit for bit
               (``kernels.old_vs_new`` lines).
               Rows 8 and 9 (v3, v2: one body, row 1's producers reading
               tap rows and its consumer) also at B = 1, 2, 37, 133, 1031,
               2048, 4095, 4096, 4097 and 16384 on the artifact, the seeded
               model and each of ``scripts/probe.py::conv_v7_edge_cases``'s
               models, on the tap rows of its own frames (each map equal
               to the plain version's and to row 1's kernel map of the
               frames) and on seeded random rows, all 8 lanes of every row
               drawn (each map equal to the plain version's): 0
               mismatching activations. Where an earlier body of
               ``csrc/conv_stage_int8_v3.cu`` was copied to
               ``_build/conv_stage_int8_v3_old.cu`` (never committed, with
               the ``conv_stage_int8_mma.cuh`` of its commit beside it),
               rows 8 and 9 are timed against it, old, new, new, old, at
               B=4096, 2048 and 16384 beside rows 6 and 1 and ``_int_mm``
               on conv2's lane-packed product, maps bit for bit
               (``kernels.old_vs_new`` lines).
               Times at the bench's sizes (CUDA events around runs
               of back-to-back launches, median of 5 runs), the plain
               version's, one torch call on the kernel's largest product as
               a yardstick, and the least time the card could take (bound);
               each kernel's device time from torch.profiler beside them
               (the timing FIR's "ms": its launches are shorter than the
               host's time to issue them).
4. stream   -- ``run_stream_demo`` on cuda with the committed artifact,
               launch counters zeroed just before each run: the default
               StreamConfig with the default v7 classifier, with
               ``eval.int8_kernel=v10`` and with ``eval.int8_kernel=v3``
               (subbands 1/5/11 must read BPSK/QPSK/GFSK); then
               ``stream.normalize_timing=true``, and the resampler with
               timing (``stream.resample_up=1 stream.resample_down=2
               stream.normalize_timing=true``), whose moved carriers are
               reported, not checked. Every run: streamed labels equal
               whole-stream labels, the path's kernels launched (the timing
               FIR where timing is on, on its window route alone), and the
               labels agree with the CPU plain path.
5. bench    -- the port's bench (``modulationdetectioncnn_torch.bench``) at
               its defaults: cnn mode at B=4096 with calibration over v7 and
               v10 and the stream_extra line; then stream mode, and stream
               mode with ``stream.normalize_timing=true``; then the v9, v3
               and v2 (``pallas_int8``) backends named explicitly, the
               bf16 v4 classifier (``pallas_bf16_v4``) and the bf16 v2
               forward (``bench.backend=pallas_bf16``: its conv and logits
               kernels once per iteration each). Counters zeroed before
               each run.
               Its stdout and stderr lines are printed as they came; the
               contract keys, ``fallback`` false, the winner among the
               candidates, every kernel of each run launched, and no
               ``stream_extra_error`` are required.
6. eval     -- ``eval eval.backend=int8`` with each of v5, v6, v4, v7, v10, v3,
               v2 and v1
               on 3520 frames (16 per class at 20 SNRs), counters zeroed
               before each: the version's conv kernel and its dense kernel
               launched and nothing else, the labels that run returned equal
               to the plain chain's, and results equal across versions (run
               through ``cli.cmd_eval``, which returns the labels; the
               command line runs the same function); then ``eval.backend=flax``
               and ``golden`` on the exported float checkpoint (880 frames),
               with their label agreement.
7. forwards -- the bf16 v4 classifier, ``make_bf16_forward_v2`` and
               ``make_bf16_forward`` on the eval phase's frames with the
               exported checkpoint, one call each with the counters zeroed
               just before: their two kernels launched once, labels against
               the torch float model's (>= 0.85, printed).
7b. float_predictor -- the stream predictor's float route
               (``_make_predictor`` on the exported checkpoint in bf16, as
               the benchmark's bf16 cells run it) on 16,384 frames: route
               ``bf16_v4``, the two bf16 v4 kernels launched once each a
               call and nothing else, labels >= 99.2 % the bf16 module's and
               at least as close as the bf16 module's to the float32
               module's; then the stream demo on that checkpoint (phase
               ``stream``'s checks, the occupied labels reported only).
7c. resnet_chain -- row 25, the residual classifier's fused chain
               (``ops/residual_chain_bf16.py``), against its plain version
               on the card, for a seeded model at the published widths and
               the committed checkpoint (``assets/ckpt_resnet_rml18``), on
               seeded frames at B = 1, 37 (also from frame 3), 133, 4095,
               4096, 4097 and 16384: every map element within ``MAP_TOL``
               of the plain map's largest magnitude, the head's labels on
               either map printed. Then the predictor on the benchmark's
               settings (``amc_bench/configs/resnet_rml18_bf16.json``):
               route ``resnet_chain_bf16``; two calls on 4096 frames under
               a profiler, with the counters zeroed just before, launch
               the chain once each and no other kernel of the port's,
               count ``amc.classifier.launches`` 2, give the same labels,
               and the labels of the chain and the head called directly;
               agreement with the bf16 and float32 modules (TF32 off)
               printed. Times at B = 4096 beside bound, plain and the bf16
               module's stacks on cuDNN, with ptxas's registers and spills.
8. quantize -- ``quantize`` of the exported float checkpoint into a
               temporary directory: agreement_vs_float, and per array the
               elements that differ from the committed artifact (reported).
9. train    -- ``train`` at full width and the default batch of 1024 for
               300 steps on 44,000 frames (0 to 18 dB) resident on the
               card, with checkpoints: records (samples/s), the loss
               falling, the checkpoints kept.
10. canary  -- the 2-class canary of tests/test_accuracy_regression.py in
               bf16 (>= 0.85), and a resume from step 30 to 60 that logs
               exactly steps 31..60.
11. trained_int8 -- ``quantize`` of what ``train`` wrote, then ``eval
               eval.int8_kernel=v1`` on it, counters zeroed just before the
               eval: v1 and the logits dense stage launched, labels equal to
               the plain chain's.
12. qat     -- ``qat`` (40 steps) on a copy of the exported checkpoint, then
               ``quantize`` of its ``_qat`` output and an int8 ``eval``
               beside the PTQ artifact's.
13. profile -- torch.profiler over 10 iterations of the v7 and the v10
               classifiers and of the stream chain with each at B=4096:
               device time by kernel and the
               device's busy share, counting device work alone (kernels and
               copies; reported, not checked).

The phases of ``parallel/``, of rows 17-20 of the kernel table and of the
last three JAX modules ported:

- trace (after build, in a process of its own: ``--trace-phase``, since
               a trace exported in this process makes the later phases'
               profiler sessions drop device records) --
               ``utils/profiler.py::trace`` around the v7
               classifier on the demo's frames, ``AMC_TRACE_DIR`` unset:
               ``trace(None)`` runs no profiler and writes nothing into an
               empty working directory; ``trace(<dir>)`` writes exactly one
               file, a Chrome trace holding a kernel's event (no count
               required: the profiler can drop records); labels equal to
               the untraced run's. Reported: where a trace of 3 iterations
               of the bench's stream chain (v7, B=4096) puts the host's
               time (top-level operators, time outside them, CUDA runtime
               calls, kernels).
- stream_variants (after bench) -- ``scripts/bench_stream_variants.py`` at
               the bench's defaults: the CNN-only rate and the six
               variants (default, timing_on, resample_2_3,
               cfo_off_timing_off, cfo_pad2, default_rerun), none failing,
               each rate > 0 with ``pct_of_cnn_only`` as computed; rows 1,
               2 and 21 (window route) launched; default / default_rerun
               printed, not checked.
- full (after trained_int8) -- ``scripts/train_eval_full.py`` at full width
               on the train phase's cut (400 frames per class at 0 to 18
               dB, 300 steps): the JAX summary's keys, agreement with the
               plain chain 1.0, ``int8_on_chip`` true, rows 1 and 2 and
               nothing else launched once per batch of the int8 sweep and
               once for the agreement, its outputs in a temporary
               directory and no file of the checkout touched.

- cnn_kernels (after kernels) -- the four ``ops/cnn_kernels.py`` kernels
               against their plain versions on the bench's 4096 frames, the
               demo's 1024, B=1, 37 frames, B = 4095, 4097 and 133 and three
               odd shapes (T 40, C 33, Co 7; T 300, C 48, Co 100; T 300 at
               the default C 256, Co 80: three row tiles on conv2's Hopper
               route), and conv2 on its edges (int8: a map all 127 under
               weights all +-127, sums near +-2.5e7, offsets across the
               clip; bf16: magnitudes near 2^50; float32: map channels
               spanning 2^-20 .. 2^20 under weights of both signs): float
               conv1 (bf16 and float32 out) and both int8 kernels bit for
               bit, float conv2 within 1e-5 of the map's largest magnitude
               (float32) or the bf16 map tolerance; row 19 -> row 20 equal
               to v7's map and, through the dense stage, its labels;
               conv2's launches per route (the default widths on the
               Hopper route in bf16 and int8, on the FFMA route in
               float32; float32 at T 40, C 33, Co 7 on the general route);
               row 19 also on ``scripts/probe.py::conv1_int8_edge_cases``
               (x at -128 and +127 under taps of -128 and +127, shifts 0
               .. 31, offsets at the clip's edges) at B = 1, 37, 4097 and
               16384 with C 16, 48, 256 and 33, at T 3, and on frames 1
               byte past a word, each on the route its widths give (the
               dp4a route at C a multiple of 16, and at the default
               widths; C 33 on the general route); row 17 (bf16 and
               float32 out) also at T 41 and on frames 4 bytes past a
               16-byte boundary, each case on the route its widths give
               (the register route but at T 40, C 33); times at B=4096
               beside bound, plain and library, with the registers and
               spills of rows 17, 19 and 21's new bodies and row 17's
               float32-out device time and bound. Where an
               earlier body of ``csrc/cnn_kernels.cu`` was copied to
               ``_build/cnn_kernels_old.cu`` (never committed), rows 18
               (bf16, float32), 20, 19 and 17 are timed against it, each
               against the copy's entry of its own route where the copy
               has one, else its general body, old, new, new, old, at B =
               4096, 2048 and 16384 (``cnn_kernels.old_vs_new`` lines).
- probe_kernels (after cnn_kernels) -- the two kernels of the JAX
               package's probe suite that no product kernel computes
               (``ops/probe_kernels.py``: the copy and the int8 prologue
               alone) against their plain versions bit for bit, on the
               probe's (4096, 16384) int8 and odd byte counts, and on the
               bench's, the demo's, B=1, 37 and T=40 frames and exact ties
               past the clip; times beside bound, plain and library (the
               library call's device time too, on the kernel's clock, and
               the two in turns, kernel, library, library, kernel, three
               rounds); 0 launches on the main path. Where an earlier body
               of ``csrc/probe_kernels.cu`` was copied to
               ``_build/probe_kernels_old.cu`` (never committed), the copy
               is timed against it, old, new, new, old, at B = 4096, 2048
               and 16384 rows of 16384 bytes (``probe_kernels.old_vs_new``).
- parallel (after stream) -- world size 1 on NCCL: the sharded v7 stream
               equal to the single-process labels with rows 1-2 launched,
               ``dryrun_multichip(1)``, ``train`` on a 1x1x1 mesh.
- scaling (after bench) -- ``python -m modulationdetectioncnn_torch
               scaling`` through ``cli.main``: the bench's calibration over
               v7 and v10 for the measured rate, then the report: the JAX
               report's keys (plus the devices and the links), a halo of
               112 samples, a rate > 0 under the card's name, the default
               policy's 2-host projection >= 0.85, rows 1, 3, 2 launched.
- breakdown (after scaling) -- ``scripts/bench_breakdown.py`` into
               ``chiprun_out/bench_breakdown.json``: v7 and v9 in full, the
               v9 conv stage (row 4) and the dense + argmax stage (row 2)
               on their own, against the int8 ceiling measured in the same
               run; every stage's time > 0, shares (of the card's busy time
               per call) summing to 1 within 1 %.
- parallel_gloo (before profile) -- two processes on the card in a gloo
               group (``--gloo-rank``): halo values, sharded labels equal to
               single-process labels with rows 1-2 launched in each, the
               (data=1, model=2) forward within 1e-5 (TF32 off); then,
               reported, what gloo's point-to-point does with a tensor on
               the card and what NCCL does with two ranks on it
               (``--probe-rank``).

Then one ``{"kernels": [...]}`` line (rows 1-21 of PERF.md's kernel
table, the two probe kernels of row 22 and row 25) and, last, the contract line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before the
last line. With no CUDA device, or outside a checkout of the repository, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096          # the bench batch of the JAX package (BenchConfig)
N_CHECK = 8192        # seeded frames held against the plain versions
SEED = 0
# Dense peaks from NVIDIA's data sheets: (int8 ops/s, bytes/s, float32
# FLOP/s outside the tensor cores, bf16 FLOP/s on the tensor cores).
PEAKS = {"SXM": (1979e12, 3.35e12, 67e12, 989e12), "PCIe": (1513e12, 2.0e12, 51e12, 756e12),
         "NVL": (1671e12, 3.9e12, 60e12, 835e12)}
TPU_KERNELS = {
    "conv_stage_int8_v7": "modulationdetectioncnn_tpu/ops/infer.py:1676",
    "dense_argmax_int8": "modulationdetectioncnn_tpu/ops/infer.py:631",
    "conv_stage_int8_v10": "modulationdetectioncnn_tpu/ops/infer.py:1247",
    "conv_stage_int8_v9": "modulationdetectioncnn_tpu/ops/infer.py:1103",
    "conv_stage_int8_v5": "modulationdetectioncnn_tpu/ops/infer.py:1515",
    "conv_stage_int8_v6": "modulationdetectioncnn_tpu/ops/infer.py:906",
    "conv_stage_int8_v4": "modulationdetectioncnn_tpu/ops/infer.py:780",
    "conv_stage_int8_v3": "modulationdetectioncnn_tpu/ops/infer.py:600",
    "conv_stage_int8_v2": "modulationdetectioncnn_tpu/ops/infer.py:459",
    "dense_int8": "modulationdetectioncnn_tpu/ops/infer.py:342",
    "correct_timing_fir": "modulationdetectioncnn_tpu/dsp/normalize.py:189",
    "conv_stage_int8_v1": "modulationdetectioncnn_tpu/ops/infer.py:317",
    "conv_stage_bf16_v4": "modulationdetectioncnn_tpu/ops/infer.py:1819",
    "dense_argmax_bf16": "modulationdetectioncnn_tpu/ops/infer.py:1848",
    "conv_stage_bf16_v2": "modulationdetectioncnn_tpu/ops/infer.py:199",
    "dense_logits_bf16": "modulationdetectioncnn_tpu/ops/infer.py:107",
    "conv_stage_bf16": "modulationdetectioncnn_tpu/ops/infer.py:82",
    "conv1_stacked": "modulationdetectioncnn_tpu/ops/cnn_kernels.py:78",
    "conv2_stacked": "modulationdetectioncnn_tpu/ops/cnn_kernels.py:129",
    "conv1_stacked_int8": "modulationdetectioncnn_tpu/ops/cnn_kernels.py:223",
    "conv2_stacked_int8": "modulationdetectioncnn_tpu/ops/cnn_kernels.py:268",
    "copy_bytes": "scripts/probe.py:1044",
    "quantize_tap_planes": "scripts/probe.py:2061",
}
_CSRC = "modulationdetectioncnn_torch/csrc/"
SOURCES = {
    "conv_stage_int8_v7": _CSRC + "conv_stage_int8.cu",
    "dense_argmax_int8": _CSRC + "dense_argmax_int8.cu",
    "conv_stage_int8_v10": _CSRC + "conv_stage_int8_v10.cu",
    "conv_stage_int8_v9": _CSRC + "conv_stage_int8_v10.cu",
    "conv_stage_int8_v5": _CSRC + "conv_stage_int8_v5.cu",
    "conv_stage_int8_v6": _CSRC + "conv_stage_int8_v6.cu",
    "conv_stage_int8_v4": _CSRC + "conv_stage_int8_v6.cu",
    "conv_stage_int8_v3": _CSRC + "conv_stage_int8_v3.cu",
    "conv_stage_int8_v2": _CSRC + "conv_stage_int8_v3.cu",
    "dense_int8": _CSRC + "dense_argmax_int8.cu",
    "correct_timing_fir": _CSRC + "correct_timing.cu",
    "conv_stage_int8_v1": _CSRC + "conv_stage_int8_v5.cu",
    "conv_stage_bf16_v4": _CSRC + "conv_stage_bf16_v4.cu",
    "dense_argmax_bf16": _CSRC + "dense_argmax_bf16.cu",
    "conv_stage_bf16_v2": _CSRC + "conv_stage_bf16_v4.cu",
    "dense_logits_bf16": _CSRC + "dense_argmax_bf16.cu",
    "conv_stage_bf16": _CSRC + "conv_stage_bf16_v4.cu",
    "conv1_stacked": _CSRC + "cnn_kernels.cu",
    "conv2_stacked": _CSRC + "cnn_kernels.cu",
    "conv1_stacked_int8": _CSRC + "cnn_kernels.cu",
    "conv2_stacked_int8": _CSRC + "cnn_kernels.cu",
    "copy_bytes": _CSRC + "probe_kernels.cu",
    "quantize_tap_planes": _CSRC + "probe_kernels.cu",
    "residual_chain_bf16": _CSRC + "residual_chain_bf16.cu",
}
# The kernel each wrapper launches, as the profiler names it.
KERNEL_SYMBOLS = {
    "conv_stage_int8_v7": "conv_stage_int8_v7_kernel",
    "dense_argmax_int8": "dense_argmax_int8_kernel<true>",
    "conv_stage_int8_v10": "conv_stage_folded_kernel",    # one body for v9 and v10
    "conv_stage_int8_v9": "conv_stage_folded_kernel",
    "conv_stage_int8_v5": "conv_stage_int8_v5_kernel",    # row 1's design, v5's weights
    "conv_stage_int8_v6": "conv_stage_int8_v6_kernel",    # row 1's design from tap planes
    "conv_stage_int8_v4": "conv_stage_int8_v6_kernel",    # v6's body
    "conv_stage_int8_v3": "conv_stage_int8_v3_kernel",    # row 1's design from tap rows
    "conv_stage_int8_v2": "conv_stage_int8_v3_kernel",    # v3's body
    "dense_int8": "dense_argmax_int8_kernel<false>",
    "conv_stage_int8_v1": "conv_stage_int8_v5_kernel",    # v5's body
    "conv_stage_bf16_v4": "conv_stage_bf16_kernel<0>",
    "conv_stage_bf16_v2": "conv_stage_bf16_kernel<1>",
    "conv_stage_bf16": "conv_stage_bf16_kernel<2>",
    "dense_argmax_bf16": "dense_argmax_bf16_kernel<true>",
    "dense_logits_bf16": "dense_argmax_bf16_kernel<false>",
    "conv1_stacked": "conv1_regs_kernel<__nv_bfloat16>",   # bf16 out, the register route
    "conv2_stacked": "conv2_wgmma_kernel<0",               # bf16, the Hopper route
    "conv1_stacked_int8": "conv1_int8_dp4a_kernel",        # the dp4a route
    "correct_timing_fir": "correct_timing_fir_window_kernel<8>",   # the window route
    "conv2_stacked_int8": "conv2_wgmma_kernel<1",
    "copy_bytes": "copy_bytes_kernel",
    "quantize_tap_planes": "tap_planes_kernel",
    "residual_chain_bf16": "residual_chain_bf16_kernel",
}
F32_CONV2_SYMBOL = "conv2_ffma_kernel<float>"               # row 18 float32, the FFMA route
F32_CONV1_SYMBOL = "conv1_regs_kernel<float>"               # row 17 float32 out, the register route
# ptxas's mangled names of row 17's register route, bf16 and float32 out.
CONV1_REGS_PTXAS = ("conv1_regs_kernelI13__nv_bfloat16E", "conv1_regs_kernelIfE")
CNN_KERNELS = ("conv1_stacked", "conv2_stacked", "conv1_stacked_int8", "conv2_stacked_int8")
PROBE_KERNELS = ("copy_bytes", "quantize_tap_planes")
CONV_VERSIONS = ("v7", "v9", "v10", "v5", "v6", "v4", "v3", "v2", "v1")
INTEGER_VERSIONS = ("v7", "v5", "v6", "v4", "v3", "v2", "v1")   # no bf16 fold
EVAL_VERSIONS = ("v5", "v6", "v4", "v7", "v10", "v3", "v2", "v1")
EVAL_PATH = ("v5", "v6", "v4", "v3", "v2")      # slices 3 and 4's kernels
# The bf16 maps' tolerance against their plain versions (v4, v2 and the
# f32-conv1 stage; row 18 in bf16) is scripts/probe.py's (bf16_map_outside,
# BF16_MAP_RTOL, BF16_MAP_ATOL_OF_MAX): one bf16 ulp relative plus 1e-3 of
# the map's largest magnitude (elements next to the ReLU edge). The dense
# stage's are scripts/probe.py's too (bf16_dense_misses): labels >= 99.9 %
# equal, and every difference a near-tie of the plain logits (top-2 gap <
# 1e-3 of the row's largest logit); logits within one bf16 ulp of every
# dense1 unit times |w4| (2^-7 * sum_d |d1_d| |w4_dc|) plus 1e-6 of the
# largest logit, the padded classes -inf in both.
# Frames per kind of row 1's edge inputs (scripts/probe.py::conv_v7_edge_cases):
# ragged against the 132 blocks, several frames a block.
V7_EDGE_FRAMES = 1031
# Rows 3 and 4 (v10, v9), 5 and 10 (v5, v1) and 6 and 7 (v6, v4), each one persistent block
# per SM: batches around one frame a block and ragged against the 132
# blocks, and the bench's sizes.
FOLD_BATCHES = (1, 37, 133, V7_EDGE_FRAMES, 2048, 4095, 4096, 4097, 16384)
FOLD_STAGES = ("conv_stage_int8_v10", "conv_stage_int8_v9")
# Rows 5 and 10 (v5, v1: one body, row 1's), checked at FOLD_BATCHES too.
V5_STAGES = ("conv_stage_int8_v5", "conv_stage_int8_v1")
# Rows 6 and 7 (v6, v4: one body, row 1's from tap planes), the same.
V6_STAGES = ("conv_stage_int8_v6", "conv_stage_int8_v4")
# Rows 8 and 9 (v3, v2: one body, row 1's from tap rows), at FOLD_BATCHES
# and B = 2 (two blocks of one frame each).
V3_STAGES = ("conv_stage_int8_v3", "conv_stage_int8_v2")
V3_BATCHES = tuple(sorted((2, *FOLD_BATCHES)))
# Row 19's edge batches (scripts/probe.py::conv1_int8_edge_cases): one
# frame, a ragged few, the persistent grid's ragged edge, the largest.
CONV1_EDGE_BATCHES = (1, 37, 4097, 16384)
# The dense stage's edge batches (scripts/probe.py::dense_bf16_edge_cases).
BF16_EDGE_BATCHES = (1, 37, 129, 2048, 4095, 4096, 4097, 16384)
# The bf16 conv stages' cluster edges: 66 clusters of 2 expected on the
# card's 132 SMs, so B around 1, 66 and 132 clusters' worth of frames.
BF16_CONV_EDGE_BATCHES = (1, 2, 65, 66, 67, 131, 133, 4095, 4097)
# The batches at which the same 2048 frames' bf16 conv maps must be equal.
BF16_CONV_SAME_BATCHES = (2048, 4096, 16384)
BF16_CONV = ("conv_stage_bf16_v4", "conv_stage_bf16_v2", "conv_stage_bf16")
# The eval phase's dataset: 16 frames per class at each of the 20 SNRs.
EVAL_DATA = ("data.frames_per_class_per_snr=16",)
# The train phase's dataset (11 classes at the 10 SNRs from 0 to 18 dB) and
# steps.
TRAIN_DATA = ("data.frames_per_class_per_snr=400", "data.snr_db_min=0")
TRAIN_STEPS = 300
FLOAT_CKPT = os.path.join(REPO, "modulationdetectioncnn_torch", "assets", "ckpt_rml11_r5")
RESNET_CKPT = os.path.join(REPO, "modulationdetectioncnn_torch", "assets", "ckpt_resnet_rml18")
# Row 25's batches: one frame, a ragged few, ragged against the persistent
# grid of one block an SM, around the benchmark cell's batch, four times it.
RESNET_BATCHES = (1, 37, 133, 4095, 4096, 4097, 16384)
CONTRACT_KEYS = {"metric", "value", "unit", "vs_baseline", "backend", "fallback"}


class CheckFailed(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def peaks_for(name: str) -> tuple[str, float, float, float, float]:
    part = "PCIe" if "PCIe" in name else "NVL" if "NVL" in name else "SXM"
    return (part, *PEAKS[part])


def time_ms(fn, iters: int, warmup: int = 3, reps: int = 5) -> float:
    """Median over ``reps`` runs of ``iters`` back-to-back launches, each run
    timed with one pair of CUDA events, per launch. Launches queue behind
    each other, so the host's time to issue one is hidden as long as it is
    shorter than the device's time to run one."""
    from modulationdetectioncnn_torch.utils.timing import launch_ms_samples

    return statistics.median(launch_ms_samples(fn, iters, warmup, reps))


def device_ms(fn, kernel: str, iters: int = 20) -> float | None:
    """The mean device time per launch of the CUDA kernel whose name holds
    ``kernel``, from ``torch.profiler`` over ``iters`` calls of ``fn`` after
    a warm-up: the kernel's own time, which ``time_ms`` cannot see when the
    host takes longer to issue a launch than the card to run it. None when
    the profiler shows no such kernel (``utils/profiler.py::device_records``
    takes a run again when the profiler dropped some of its records)."""
    from modulationdetectioncnn_torch.utils.profiler import device_records

    ev = [e for e in device_records(fn, iters) if kernel in e.key]
    if len(ev) != 1 or ev[0].count != iters:
        return None
    return ev[0].self_device_time_total / ev[0].count / 1e3


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    part, int8_peak, bw_peak, f32_peak, bf16_peak = peaks_for(name)
    info = {"phase": "device", "name": name, "nvidia_smi": smi,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "peaks_part": part,
            "int8_ops_per_s": int8_peak, "bytes_per_s": bw_peak,
            "f32_flops_per_s": f32_peak, "bf16_flops_per_s": bf16_peak}
    emit(info)
    return info


def phase_build() -> str:
    """Build and load the kernels; returns ptxas's report."""
    from modulationdetectioncnn_torch.ops import _build

    res = _build.build(force=True)
    _build.load_library()
    usage = [ln.strip() for ln in res["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(res["seconds"], 3),
          "nvcc": _build.find_nvcc(), "library": os.path.relpath(res["path"], REPO),
          "ptxas": usage})
    return res["log"]


def ptxas_usage(log: str, symbol: str) -> dict:
    """The registers and spill bytes ptxas reported for the first entry
    whose mangled name holds ``symbol``; {} when there is none."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and symbol in ln:
            rec = {}
            for nxt in lines[i + 1:i + 5]:
                if "Compiling entry" in nxt:
                    break
                if m := re.search(r"Used (\d+) registers", nxt):
                    rec["registers"] = int(m.group(1))
                if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt):
                    rec["spill_stores"], rec["spill_loads"] = int(m.group(1)), int(m.group(2))
            return rec
    return {}


def random_weights(art, rng: np.random.Generator):
    """Full-width int8 weights from a seed, with the artifact's requantize
    constants and each weight tensor's spread, so activations stay live."""
    from modulationdetectioncnn_torch.quant import int8_weights_from_numpy

    tree = art.tree()
    for k in ("w1p", "w2p", "w3", "w4"):
        std = float(tree[k].astype(np.float64).std())
        tree[k] = np.clip(np.rint(rng.normal(0, std, tree[k].shape)),
                          -127, 127).astype(np.int8)
    return int8_weights_from_numpy(tree, "cuda")


def narrow_weights():
    """A narrow model (conv1 32, conv2 16, dense 32, 2 classes; a seeded
    torch VT-CNN2 and the port's PTQ: ``scripts/probe.py::narrow_tree``),
    which the carry pads to the kernels' widths."""
    from modulationdetectioncnn_torch.quant import int8_weights_from_numpy
    from modulationdetectioncnn_torch.scripts.probe import narrow_tree

    return int8_weights_from_numpy(narrow_tree(SEED), "cuda")


def fold_refused_weights(art):
    """The artifact with one conv1 offset that is not bf16-exact: v7 and the
    integer tensor-core stages (v4, v5, v6) run it, the v9/v10 fold
    refuses it."""
    from modulationdetectioncnn_torch.quant import int8_weights_from_numpy

    tree = art.tree()
    tree["o1"] = tree["o1"].copy()
    tree["o1"][5] = 257
    return int8_weights_from_numpy(tree, "cuda")


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from modulationdetectioncnn_torch.dsp import normalize
    from modulationdetectioncnn_torch.ops import infer, infer_bf16
    from modulationdetectioncnn_torch.ops.residual_chain_bf16 import residual_chain_bf16

    infer.reset_launch_counts()
    infer_bf16.reset_launch_counts()
    normalize.reset_launch_counts()
    residual_chain_bf16.launches = 0


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launches, and the timing FIR's per route (as
    ``correct_timing_fir/<route>``)."""
    from modulationdetectioncnn_torch.dsp import normalize
    from modulationdetectioncnn_torch.ops import infer, infer_bf16
    from modulationdetectioncnn_torch.ops.residual_chain_bf16 import residual_chain_bf16

    fir = normalize.correct_timing_fir
    return {**infer.launch_counts(), **infer_bf16.launch_counts(),
            "residual_chain_bf16": residual_chain_bf16.launches,
            "correct_timing_fir": fir.launches,
            **{f"correct_timing_fir/{r}": n for r, n in fir.route_launches.items()}}


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> tuple[int, float]:
    """(mismatching elements, largest absolute difference); floats are equal
    when their values are (NaN equal to NaN), integers exactly."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    if got.is_floating_point():
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        diff = torch.where(same, 0.0, (got.double() - want.double()).abs())
        return int((~same).sum()), float(diff.max()) if diff.numel() else 0.0
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0


def conv_pairs(x: torch.Tensor, qw, versions) -> dict:
    """{kernel name: (its wrapper's valid map, its plain version's valid
    map)} on the same inputs (frames, their tap planes for v4/v6, or their
    tap rows for v3/v2)."""
    from modulationdetectioncnn_torch.ops import infer

    planes = infer.tap_planes(x, qw.inv_sx)
    rows = infer.expand_taps(x, qw.inv_sx)
    plain = {"v7": lambda: infer.conv_stage_int8_v7_plain(x, qw),
             "v9": lambda: infer.conv_stage_int8_folded_plain(x, qw),
             "v5": lambda: infer.conv_stage_int8_v5_plain(x, qw),
             "v6": lambda: infer.conv_stage_int8_planes_plain(planes, qw),
             "v3": lambda: infer.conv_stage_int8_taps_plain(rows, qw)}
    plain["v10"], plain["v4"], plain["v2"] = plain["v9"], plain["v6"], plain["v3"]
    plain["v1"] = plain["v5"]
    out = {}
    for v in versions:
        stage = getattr(infer, f"conv_stage_int8_{v}")
        inp = planes if v in ("v6", "v4") else rows if v in ("v3", "v2") else x
        out[stage.__name__] = (stage(inp, qw), plain[v]()[..., :qw.c2])
    return out


def v7_siblings(pairs: dict) -> dict[str, int]:
    """Mismatching activations of v5's, v1's, v9's and v10's maps (rows 5,
    10, 4 and 3: v7's function from the same frames) against v7's, among
    ``conv_pairs``'s."""
    v7 = pairs["conv_stage_int8_v7"][0]
    return {k: compare(k, pairs[k][0], v7)[0]
            for k in ("conv_stage_int8_v5", "conv_stage_int8_v1", *FOLD_STAGES) if k in pairs}


def _batch_check(recs: list, stages, plain, wname: str, xname: str, x: torch.Tensor, qw,
                 with_v7: bool, inp: torch.Tensor | None = None) -> None:
    """Append one record per kernel of ``stages`` (wrapper names) on
    ``inp`` (the frames ``x`` when None, else an input made from them, such
    as their tap planes) under ``qw``: its map against ``plain``'s on the
    same input (mismatching activations, largest difference) and,
    ``with_v7``, against row 1's kernel map of ``x``."""
    from modulationdetectioncnn_torch.ops import infer

    inp = x if inp is None else inp
    want = plain(inp, qw)[..., :qw.c2]
    v7 = infer.conv_stage_int8_v7(x, qw) if with_v7 else None
    for kname in stages:
        got = getattr(infer, kname)(inp, qw)
        torch.cuda.synchronize()
        mism, err = compare(kname, got, want)
        rec = {"kernel": kname, "weights": wname, "input": xname, "n": int(x.shape[0]),
               "mismatches": mism, "max_abs_err": err}
        if with_v7:
            rec["maps_vs_v7"] = compare(kname, got, v7)[0]
        recs.append(rec)


def fold_stage_checks(weights: dict, trees: dict, x_all: torch.Tensor) -> list[dict]:
    """Rows 3 and 4 (v10, v9) against their plain version on the card, one
    record per kernel, model and input: on each model of ``weights`` at
    FOLD_BATCHES frames of ``x_all`` (its map also against row 1's kernel
    map on the same frames), and, for each model of ``trees``, conv1's
    whole map through ``scripts/probe.py::conv1_probe_trees`` (conv2 a
    pass-through, so a fault of the folded conv1 that rq2 would clip away
    shows) at V7_EDGE_FRAMES frames."""
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.quant import int8_weights_from_numpy
    from modulationdetectioncnn_torch.scripts import probe

    recs = []
    plain = infer.conv_stage_int8_folded_plain
    for wname, qw in weights.items():
        for b in FOLD_BATCHES:
            _batch_check(recs, FOLD_STAGES, plain, wname, f"seeded_b{b}", x_all[:b], qw, True)
    for tname, tree in trees.items():
        for i, (pt, _, _) in enumerate(probe.conv1_probe_trees(tree)):
            _batch_check(recs, FOLD_STAGES, plain, f"{tname}_conv1_probe{i}",
                         f"seeded_b{V7_EDGE_FRAMES}", x_all[:V7_EDGE_FRAMES],
                         int8_weights_from_numpy(pt, "cuda"), False)
    return recs


def v5_stage_checks(weights: dict, x_all: torch.Tensor) -> list[dict]:
    """Rows 5 and 10 (v5, v1: row 1's producers and consumer under v5's
    arguments) against their plain version and row 1's kernel map on the
    card, one record per kernel, model and batch: at FOLD_BATCHES frames of
    ``x_all`` on each model of ``weights``, and of each of
    ``scripts/probe.py::conv_v7_edge_cases``'s models on its own frames
    (quantize ties, the largest sums, requantize edges, the narrow padded
    model, the fold-refused model)."""
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.quant import int8_weights_from_numpy
    from modulationdetectioncnn_torch.scripts import probe

    recs = []
    plain = infer.conv_stage_int8_v5_plain
    sets = {w: (qw, x_all) for w, qw in weights.items()}
    for kind, (tree, frames) in probe.conv_v7_edge_cases(SEED, max(FOLD_BATCHES)).items():
        sets[f"v7_edge_{kind}"] = (int8_weights_from_numpy(tree, "cuda"),
                                   torch.from_numpy(frames).cuda())
    for wname, (qw, x) in sets.items():
        for b in FOLD_BATCHES:
            _batch_check(recs, V5_STAGES, plain, wname, f"b{b}", x[:b], qw, True)
    return recs


def v6_stage_checks(weights: dict, x_all: torch.Tensor) -> list[dict]:
    """Rows 6 and 7 (v6, v4: row 1's producers and consumer, reading tap
    planes) against their plain version on the card, one record per kernel,
    model, input and batch, at FOLD_BATCHES frames: on each model of
    ``weights`` with ``x_all`` and on each of
    ``scripts/probe.py::conv_v7_edge_cases``'s models with its own frames,
    the frames' tap planes (the map also against row 1's kernel map of the
    frames), and seeded random int8 planes, all 8 planes and the two tail
    columns drawn, which the kernel must map as the plain version does while
    it reads only planes 0..5 and each plane's own block of w1e."""
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.quant import int8_weights_from_numpy
    from modulationdetectioncnn_torch.scripts import probe

    recs = []
    plain = infer.conv_stage_int8_planes_plain
    b_max = max(FOLD_BATCHES)
    random_planes = torch.from_numpy(np.random.default_rng(SEED + 6).integers(
        -128, 128, (b_max, 8, 128), dtype=np.int8)).cuda()
    sets = {w: (qw, x_all) for w, qw in weights.items()}
    for kind, (tree, frames) in probe.conv_v7_edge_cases(SEED, b_max).items():
        sets[f"v7_edge_{kind}"] = (int8_weights_from_numpy(tree, "cuda"),
                                   torch.from_numpy(frames).cuda())
    for wname, (qw, x) in sets.items():
        planes = infer.tap_planes(x, qw.inv_sx)
        for b in FOLD_BATCHES:
            _batch_check(recs, V6_STAGES, plain, wname, f"tap_planes_b{b}", x[:b], qw, True,
                         planes[:b])
            _batch_check(recs, V6_STAGES, plain, wname, f"random_planes_b{b}",
                         random_planes[:b], qw, False)
    return recs


def v3_stage_checks(weights: dict, x_all: torch.Tensor) -> list[dict]:
    """Rows 8 and 9 (v3, v2: row 1's producers and consumer, reading tap
    rows) against their plain version on the card, one record per kernel,
    model, input and batch, at V3_BATCHES frames: on each model of
    ``weights`` with ``x_all`` and on each of
    ``scripts/probe.py::conv_v7_edge_cases``'s models with its own frames,
    the frames' tap rows (the map also against row 1's kernel map of the
    frames), and seeded random int8 rows, all 8 lanes of every row drawn on
    their own, which the kernel must map as the plain version does while
    each producer lane reads lanes 0..5 of its own row only."""
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.quant import int8_weights_from_numpy
    from modulationdetectioncnn_torch.scripts import probe

    recs = []
    plain = infer.conv_stage_int8_taps_plain
    b_max = max(V3_BATCHES)
    random_rows = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        -128, 128, (b_max, 126, 8), dtype=np.int8)).cuda()
    sets = {w: (qw, x_all) for w, qw in weights.items()}
    for kind, (tree, frames) in probe.conv_v7_edge_cases(SEED, b_max).items():
        sets[f"v7_edge_{kind}"] = (int8_weights_from_numpy(tree, "cuda"),
                                   torch.from_numpy(frames).cuda())
    for wname, (qw, x) in sets.items():
        rows = infer.expand_taps(x, qw.inv_sx)
        for b in V3_BATCHES:
            _batch_check(recs, V3_STAGES, plain, wname, f"tap_rows_b{b}", x[:b], qw, True,
                         rows[:b])
            _batch_check(recs, V3_STAGES, plain, wname, f"random_rows_b{b}",
                         random_rows[:b], qw, False)
    return recs


def stream_bench_frames(n_frames: int) -> torch.Tensor:
    """The stream bench's normalized frames (power and CFO, the default
    StreamConfig) from its seeded wideband input of ``n_frames * 128``
    samples, on the card: (n_frames, 2, 128)."""
    from modulationdetectioncnn_torch.config import StreamConfig
    from modulationdetectioncnn_torch.dsp import pipeline
    from modulationdetectioncnn_torch.dsp.channelizer import design_prototype

    sc = StreamConfig()
    wide = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, n_frames * sc.frame_len)).astype(np.float32)).cuda()
    fr = pipeline.subband_frames(
        wide, design_prototype(sc.num_subbands, sc.taps_per_branch), sc)
    return fr.reshape(-1, 2, sc.frame_len).contiguous()


def timing_checks(demo: torch.Tensor, stream4096: torch.Tensor) -> tuple[list, dict]:
    """The timing FIR against its plain version, bit for bit, on both
    routes (``correct_timing_fir_route``): on frames with their own Oerder &
    Meyr estimates (the stream bench's 4096, the demo's 1024, B=1, a ragged
    37-frame slice, and the stream bench's 16384 frames whole, their first
    4095 and 4097 of them from frame 1), on seeded frames at the wrap
    extremes of tau (``probe.TIMING_TAU_EDGES``), with seeded filters of 1,
    3 and 9 taps at T 128 (the window route's other widths), and on the
    general route at T 40 (17 and 3 taps), T 300 and on frames that start
    4 bytes past a 16-byte boundary. Each case must take the route its
    widths give. Returns the check lines and the kernel's stats."""
    from modulationdetectioncnn_torch.config import StreamConfig
    from modulationdetectioncnn_torch.dsp import normalize
    from modulationdetectioncnn_torch.scripts import probe

    sc = StreamConfig()
    r = np.random.default_rng(SEED + 2)

    def seeded(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32)).cuda()

    x_seed = seeded(16, 2, 128)
    tau_ext = torch.tensor(probe.TIMING_TAU_EDGES, dtype=torch.float32).cuda()
    s16k = stream_bench_frames(16384)
    flat = seeded(37 * 256 + 1)
    misaligned = flat[1:].view(37, 2, 128)             # 4 bytes past the boundary
    # name: (frames, tau (None: their own estimate) or (B, taps) filters, route)
    cases = {"stream_bench_b4096": (stream4096, None, "window"),
             "stream_demo_b1024": (demo, None, "window"),
             "stream_bench_b1": (stream4096[:1], None, "window"),
             "stream_bench_b37_at3": (stream4096[3:40], None, "window"),
             "stream_bench_b16384": (s16k, None, "window"),
             "stream_bench_b4095": (s16k[:4095], None, "window"),
             "stream_bench_b4097_at1": (s16k[1:4098], None, "window"),
             "seeded_b16_tau_extremes": (x_seed, tau_ext, "window")}
    for taps in (1, 3, 9):
        cases[f"seeded_b37_taps{taps}"] = (seeded(37, 2, 128), seeded(37, taps), "window")
    for t, taps in ((40, 17), (40, 3), (300, 17)):
        cases[f"seeded_b37_t{t}_taps{taps}"] = (seeded(37, 2, t), seeded(37, taps), "general")
    cases["misaligned_b37"] = (misaligned, None, "general")
    checks, st = [], {"mismatches": 0, "max_abs_err": 0.0, "checked": 0}
    for name, (x, tau, route) in cases.items():
        if tau is None:
            tau = normalize.estimate_timing(x, sc.sps)
        c = tau if tau.dim() == 2 else normalize.timing_filters(tau, sc.sps, sc.timing_phases)
        want_route = normalize.correct_timing_fir_route(x.shape[-1], c.shape[1],
                                                        x.data_ptr() % 16 == 0)
        before = dict(normalize.correct_timing_fir.route_launches)
        got = normalize.correct_timing_fir(x, c)
        want = normalize.correct_timing_fir_plain(x, c)
        torch.cuda.synchronize()
        routes = [k for k, v in normalize.correct_timing_fir.route_launches.items()
                  if v != before[k]]
        mism, err = compare(name, got, want)
        st["mismatches"] += mism
        st["checked"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], err)
        checks.append({"kernel": "correct_timing_fir", "input": name,
                       "n": int(x.shape[0]), "t": int(x.shape[-1]), "taps": int(c.shape[1]),
                       "route": routes, "mismatches": mism,
                       "finite": bool(torch.isfinite(got).all())})
        require(bool(torch.isfinite(got).all()), f"timing FIR {name}: non-finite output")
        require(routes == [want_route] == [route],
                f"timing FIR {name}: took {routes}, its widths give {want_route}, want {route}")
    return checks, st


def bf16_weight_sets() -> dict:
    """The float weight sets the bf16 kernels are held on: the bench's
    seeded torch VT-CNN2, the exported float checkpoint, a narrow 2-class
    model padded to the kernels' widths (state dicts)."""
    from modulationdetectioncnn_torch.config import ModelConfig
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2
    from modulationdetectioncnn_torch.utils.checkpoint import restore_model

    narrow = VTCNN2.from_config(
        ModelConfig(num_classes=2, conv1_filters=32, conv2_filters=16, dense_units=32),
        generator=torch.Generator().manual_seed(SEED)).state_dict()
    ckpt_model = restore_model(FLOAT_CKPT, ModelConfig(), 128, "cuda")[0]
    return {"bench_seeded": VTCNN2(generator=torch.Generator().manual_seed(0)).state_dict(),
            "float_checkpoint": ckpt_model.state_dict(), "narrow_c32_c16_d32_nc2": narrow}


def conv1_probe_mismatches(x: torch.Tensor, bw) -> dict[str, int]:
    """conv1 of each bf16 conv kernel against its plain version, bit for
    bit, seen through conv2: probe weights hold one 1.0 per output channel
    co, on tap k (0 or 2) and conv1 channel p + co, and b2 = 0, so the
    kernel's map is exactly ``a1[t + k, p + co]`` (one exact product, the
    rest exact zeros, ReLU and bf16 of a non-negative bf16 value). Fourteen
    probes (k, p) cover all 126 rows and 512 channels. Returns each
    kernel's count of differing elements."""
    import dataclasses

    from modulationdetectioncnn_torch.ops import infer_bf16 as ib

    xe = ib.expand_taps_bf16(x)
    runs = {"conv_stage_bf16_v4": (ib.conv_stage_bf16_v4, x, ib.conv1_bf16_plain(x, bw)),
            "conv_stage_bf16_v2": (ib.conv_stage_bf16_v2, xe, ib.conv1_bf16_rows_plain(xe, bw)),
            "conv_stage_bf16": (ib.conv_stage_bf16, x,
                                torch.relu(ib.conv1_f32_plain(x, bw)).to(torch.bfloat16))}
    (n2, k1), c2 = bw.w2t.shape, bw.b2.shape[0]
    co = torch.arange(c2, device=x.device)
    mism = dict.fromkeys(runs, 0)
    for k in (0, 2):
        for p in range(0, k1, c2):
            valid = p + co < k1
            w2t = torch.zeros((n2, k1), dtype=torch.bfloat16, device=x.device)
            w2t[k * c2 + co[valid], p + co[valid]] = 1.0
            probe = dataclasses.replace(bw, w2t=w2t, b2=torch.zeros_like(bw.b2), c2=c2)
            for kname, (wrapper, inp, a1) in runs.items():
                t2 = a1.shape[1] - 2
                want = torch.where(valid, a1[:, k:k + t2, (p + co).clamp(max=k1 - 1)], 0)
                mism[kname] += int((wrapper(inp, probe) != want).sum())
    return mism


def bf16_checks(demo: torch.Tensor, x_seed: torch.Tensor, bench_x: torch.Tensor
                ) -> tuple[list, dict]:
    """The five bf16 kernels against their plain versions, for three weight
    sets (``bf16_weight_sets``), on the bench's 4096 frames, the stream
    demo's 1024, B=1 and a ragged 37-frame slice. The conv stages (v4; v2 on
    the frames' tap rows; the f32-conv1 stage): every map element within
    scripts/probe.py::bf16_map_outside's tolerance (largest difference
    and bit-equal share printed), and, on the demo's frames and the 37,
    conv1 bit for bit (``conv1_probe_mismatches``); v2's map equal to v4's
    bit for bit. The dense stages, given the plain map, under
    ``scripts/probe.py::bf16_dense_misses``' tolerances: labels >= 99.9 %
    equal with every difference a near-tie of the plain logits; logits
    within one bf16 ulp of every dense1 unit times |w4|; the argmax of the
    logits kernel's logits equal to the labels kernel's labels. Then the
    dense stages on ``scripts/probe.py::dense_bf16_edge_cases`` at
    BF16_EDGE_BATCHES, and the same 2048 frames' labels at B = 4096 and
    16384 against B = 2048 (the cluster size follows B, and with it the
    order of dense1's sums): differences only at near-ties. Returns the
    check lines and the kernels' stats."""
    from modulationdetectioncnn_torch.models.vtcnn2 import flax_params
    from modulationdetectioncnn_torch.ops import infer_bf16 as ib
    from modulationdetectioncnn_torch.scripts import probe

    inputs = {f"bench_frames_b{BATCH}": bench_x, "stream_frames": demo,
              "seeded_b1": x_seed[:1], "seeded_b37_at3": x_seed[3:40]}
    probed = ("stream_frames", "seeded_b37_at3")
    checks = []
    st = {k: {"mismatches": 0, "max_abs_err": 0.0, "checked": 0}
          for k in (*BF16_CONV, "dense_argmax_bf16", "dense_logits_bf16")}

    def record(kname, bad, err):
        st[kname]["mismatches"] += bad
        st[kname]["checked"] += 1
        st[kname]["max_abs_err"] = max(st[kname]["max_abs_err"], err)

    def dense_pair(wname, xname, h, bw, labels, logits_k, **extra):
        """Rows 16 and 13 on the map h against their plain versions."""
        lab = probe.bf16_dense_misses(h, bw, labels)
        lg = probe.bf16_dense_misses(h, bw, logits_k)
        argmax_vs_labels = int((ib.argmax_lowest(logits_k) != labels).sum())
        record("dense_argmax_bf16", 0 if lab["ok"] else max(1, lab["differing_not_near_tie"]),
               lab["max_abs_diff"])
        record("dense_logits_bf16", 0 if lg["ok"] else max(1, lg["outside_tolerance"]),
               lg["max_abs_diff"])
        checks.append({"kernel": "dense_argmax_bf16", "weights": wname, "input": xname, **lab})
        checks.append({"kernel": "dense_logits_bf16", "weights": wname, "input": xname, **lg,
                       "argmax_vs_dense_argmax_labels": argmax_vs_labels, **extra})
        require(lab["ok"], f"bf16 dense {wname}/{xname}: agreement {lab['label_agreement']}, "
                f"{lab['differing_not_near_tie']} differences that are not near-ties")
        require(lg["ok"], f"bf16 dense logits {wname}/{xname}: {lg['outside_tolerance']} "
                f"outside tolerance, max diff {lg['max_abs_diff']}")
        require(argmax_vs_labels == 0, f"bf16 {wname}/{xname}: {argmax_vs_labels} "
                "argmax(logits kernel) != labels kernel")

    sets = bf16_weight_sets()
    for wname, params in sets.items():
        bw = ib.make_bf16_weights(params, "cuda")
        for xname, x in inputs.items():
            xe = ib.expand_taps_bf16(x)
            plain_map = ib.conv_stage_bf16_v4_plain(x, bw)
            maps = {"conv_stage_bf16_v4": (ib.conv_stage_bf16_v4(x, bw), plain_map),
                    "conv_stage_bf16_v2": (ib.conv_stage_bf16_v2(xe, bw),
                                           ib.conv_stage_bf16_v2_plain(xe, bw)),
                    "conv_stage_bf16": (ib.conv_stage_bf16(x, bw),
                                        ib.conv_stage_bf16_plain(x, bw))}
            labels = ib.dense_argmax_bf16(plain_map, bw)
            logits_k = ib.dense_logits_bf16(plain_map, bw)
            probe_mism = conv1_probe_mismatches(x, bw) if xname in probed else {}
            torch.cuda.synchronize()
            for kname, (got, want) in maps.items():
                got, want = got.float(), want[..., :bw.c2].float()
                diff = (got - want).abs()
                outside = probe.bf16_map_outside(got, want)
                conv1_bad = probe_mism.get(kname, 0)
                record(kname, outside + conv1_bad, float(diff.max()))
                checks.append({"kernel": kname, "weights": wname, "input": xname,
                               "n": int(x.shape[0]), "outside_tolerance": outside,
                               "max_abs_diff": float(diff.max()),
                               "max_abs_map": float(want.abs().max()),
                               "bit_equal_share": float((got == want).float().mean()),
                               "conv1_bit_mismatches": probe_mism.get(kname)})
                require(outside == 0 and conv1_bad == 0,
                        f"bf16 {kname} {wname}/{xname}: {outside} elements outside "
                        f"tolerance (max diff {float(diff.max())}), conv1 {conv1_bad} "
                        "elements differ")
                require(bool(torch.isfinite(got).all()), f"{kname} {wname}/{xname}: non-finite")
            v2_vs_v4 = int((maps["conv_stage_bf16_v2"][0] != maps["conv_stage_bf16_v4"][0]).sum())
            dense_pair(wname, xname, plain_map, bw, labels, logits_k, v2_map_vs_v4_map=v2_vs_v4)
            require(v2_vs_v4 == 0, f"bf16 {wname}/{xname}: {v2_vs_v4} v2 map elements != v4's")
    # Rows 15, 14 and 12 at the cluster edges, on the bench's model and the
    # narrow one, and the same frames' maps at three batch sizes: the
    # pair's sum order does not depend on B, so they are equal bit for bit.
    for wname in ("bench_seeded", "narrow_c32_c16_d32_nc2"):
        bw = ib.make_bf16_weights(sets[wname], "cuda")
        for b in BF16_CONV_EDGE_BATCHES:
            x = x_seed[:b]
            xe = ib.expand_taps_bf16(x)
            maps = {"conv_stage_bf16_v4": (ib.conv_stage_bf16_v4(x, bw),
                                           ib.conv_stage_bf16_v4_plain(x, bw)),
                    "conv_stage_bf16_v2": (ib.conv_stage_bf16_v2(xe, bw),
                                           ib.conv_stage_bf16_v2_plain(xe, bw)),
                    "conv_stage_bf16": (ib.conv_stage_bf16(x, bw),
                                        ib.conv_stage_bf16_plain(x, bw))}
            torch.cuda.synchronize()
            for kname, (got, want) in maps.items():
                want = want[..., :bw.c2]
                outside = probe.bf16_map_outside(got, want)
                err = float((got.float() - want.float()).abs().max())
                record(kname, outside, err)
                checks.append({"kernel": kname, "weights": wname, "input": f"cluster_edge_b{b}",
                               "n": b, "outside_tolerance": outside, "max_abs_diff": err})
                require(outside == 0 and bool(torch.isfinite(got.float()).all()),
                        f"bf16 {kname} {wname} B={b}: {outside} elements outside tolerance")
            v2_vs_v4 = int((maps["conv_stage_bf16_v2"][0] != maps["conv_stage_bf16_v4"][0]).sum())
            checks.append({"weights": wname, "input": f"cluster_edge_b{b}",
                           "v2_map_vs_v4_map": v2_vs_v4})
            require(v2_vs_v4 == 0, f"bf16 {wname} B={b}: {v2_vs_v4} v2 map elements != v4's")
    bw = ib.make_bf16_weights(sets["bench_seeded"], "cuda")
    x_many = torch.from_numpy((0.7 * np.random.default_rng(SEED + 1).standard_normal(
        (max(BF16_CONV_SAME_BATCHES), 2, 128))).astype(np.float32)).cuda()
    for kname, wrapper, inp in (("conv_stage_bf16_v4", ib.conv_stage_bf16_v4, x_many),
                                ("conv_stage_bf16_v2", ib.conv_stage_bf16_v2,
                                 ib.expand_taps_bf16(x_many)),
                                ("conv_stage_bf16", ib.conv_stage_bf16, x_many)):
        first = {b: wrapper(inp[:b], bw)[:2048] for b in BF16_CONV_SAME_BATCHES}
        torch.cuda.synchronize()
        for b in BF16_CONV_SAME_BATCHES[1:]:
            differ = int((first[b] != first[BF16_CONV_SAME_BATCHES[0]]).sum())
            record(kname, differ, 0.0)
            checks.append({"kernel": kname, "weights": "bench_seeded",
                           "input": f"first_2048_frames_b{b}_vs_b2048", "differing": differ})
            require(differ == 0, f"bf16 {kname}: the first 2048 frames' map at B={b} differs "
                    f"from B=2048 in {differ} elements")
    del x_many
    # Rows 13 and 16 at their edges: tile and cluster edges (B = 1, 37,
    # 129, 4095, 4097: a ragged last tile, rows past B read as zeros; 16384:
    # one block per tile), maps near 2^50 under +-max weights, exact and
    # one-ulp ties, the narrow model.
    edges = probe.dense_bf16_edge_cases(flax_params(sets["bench_seeded"]),
                                        flax_params(sets["narrow_c32_c16_d32_nc2"]),
                                        max(BF16_EDGE_BATCHES), SEED)
    for kind, (tree, hmap) in edges.items():
        bw = ib.make_bf16_weights(tree, "cuda")
        h_all = torch.from_numpy(hmap.reshape(len(hmap), -1)).cuda().to(torch.bfloat16)
        first = {}
        for b in BF16_EDGE_BATCHES:
            hb = h_all[:b]
            labels, logits_k = ib.dense_argmax_bf16(hb, bw), ib.dense_logits_bf16(hb, bw)
            first[b] = labels[:2048]
            torch.cuda.synchronize()
            dense_pair(f"edge_{kind}", f"map_b{b}", hb, bw, labels, logits_k,
                       label_counts=torch.bincount(labels, minlength=11).tolist())
        for b in (4096, 16384):
            rec = probe.bf16_dense_misses(h_all[:2048], bw, first[b], first[2048])
            record("dense_argmax_bf16", 0 if rec["ok"] else max(1, rec["differing_not_near_tie"]),
                   rec["max_abs_diff"])
            checks.append({"kernel": "dense_argmax_bf16", "weights": f"edge_{kind}",
                           "input": f"first_2048_frames_b{b}_vs_b2048", **rec})
            require(rec["ok"], f"bf16 dense edge_{kind}: the first 2048 frames' labels at "
                    f"B={b} differ from B=2048 but at near-ties: {rec}")
        del h_all
    return checks, st


def phase_kernels(dev_info: dict, demo_frames: torch.Tensor) -> list[dict]:
    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.quant import (
        DEFAULT_ARTIFACT, QuantizedModel, int8_weights_from_numpy, load_int8)
    from modulationdetectioncnn_torch.scripts import probe

    rng = np.random.default_rng(SEED)
    art_np = QuantizedModel.from_npz(DEFAULT_ARTIFACT)
    # The bench's own PTQ weights and frames, as its int8 backends get them.
    bench_qw, bench_x = bench.make_int8_weights(AmcConfig(), BATCH)
    fold_edge = probe.fold_edge_tree(SEED)
    weights = {"artifact": load_int8(device="cuda"),
               "seeded": random_weights(art_np, rng), "bench_ptq": bench_qw,
               "narrow_c32_c16_d32_nc2": narrow_weights(),
               "fold_edge": int8_weights_from_numpy(fold_edge, "cuda"),
               "fold_refused": fold_refused_weights(art_np)}
    refused = weights["fold_refused"]
    try:
        refused.w1f
    except ValueError as e:
        emit({"phase": "kernels.fold_refused", "error": str(e)})
    else:
        raise CheckFailed("the fold accepted the fold_refused weights")
    for v in ("v9", "v10"):   # refused when the classifier is built, not at a batch
        try:
            infer.make_int8_predict(refused, v)
        except ValueError:
            pass
        else:
            raise CheckFailed(f"make_int8_predict built {v} for the fold_refused weights")
    x_seed = torch.from_numpy(
        (0.7 * rng.standard_normal((N_CHECK, 2, 128))).astype(np.float32)).cuda()
    # Ragged batches and a slice that starts inside the tensor too.
    inputs = {"stream_frames": demo_frames, f"seeded_b{N_CHECK}": x_seed,
              "seeded_b1": x_seed[:1], "seeded_b37_at3": x_seed[3:40],
              f"bench_frames_b{BATCH}": bench_x}

    checks, stats = [], {n: {"mismatches": 0, "max_abs_err": 0, "checked": 0}
                         for n in TPU_KERNELS if n not in CNN_KERNELS + PROBE_KERNELS}

    def record(pairs, wname, xname, n):
        for kname, (got, want) in pairs.items():
            mism, err = compare(kname, got, want)
            stats[kname]["mismatches"] += mism
            stats[kname]["checked"] += 1
            stats[kname]["max_abs_err"] = max(stats[kname]["max_abs_err"], err)
            checks.append({"kernel": kname, "weights": wname, "input": xname,
                           "n": n, "mismatches": mism})
    for wname, qw in weights.items():
        versions = CONV_VERSIONS if wname != "fold_refused" else INTEGER_VERSIONS
        for xname, x in inputs.items():
            conv_full = infer.conv_stage_int8_v7_plain(x, qw)   # carried width
            lab_p = infer.dense_argmax_int8_plain(conv_full, qw)
            pairs = conv_pairs(x, qw, versions)
            pairs["dense_argmax_int8"] = (infer.dense_argmax_int8(conv_full, qw), lab_p)
            pairs["dense_int8"] = (infer.dense_int8(conv_full, qw),
                                   infer.dense_int8_plain(conv_full, qw))
            labels = {v: infer.make_int8_predict(qw, v)(x) for v in versions}
            torch.cuda.synchronize()
            record(pairs, wname, xname, int(x.shape[0]))
            v7_same = v7_siblings(pairs)
            # Each classifier's labels (its conv kernel, then the dense
            # kernel) against the plain chain, every version equal, and
            # every plain version's map equal to the integer spec's.
            label_mism = {v: compare(v, lab, lab_p)[0] for v, lab in labels.items()}
            plain_mism = {k: compare(k, want, conv_full[..., :qw.c2])[0]
                          for k, (_, want) in pairs.items() if not k.startswith("dense")}
            checks.append({"weights": wname, "input": xname,
                           "maps_vs_v7": v7_same,
                           "label_mismatches_vs_plain": label_mism,
                           "plain_maps_vs_integer_spec": plain_mism,
                           "conv_live_fraction": round(float((conv_full > 0).float().mean()), 4),
                           "label_classes": int(torch.unique(lab_p).numel())})
            require(all(m == 0 for m in label_mism.values())
                    and all(m == 0 for m in plain_mism.values())
                    and all(m == 0 for m in v7_same.values()),
                    f"{wname}/{xname}: labels differ {label_mism}, "
                    f"plain maps vs the integer spec {plain_mism}, maps vs v7 {v7_same}")
    # Row 1 on its edges (scripts/probe.py::conv_v7_edge_cases), and rows 5
    # and 10 (v5, v1: v7's function from the same frames) held to it there.
    for kind, (tree, frames) in probe.conv_v7_edge_cases(SEED, V7_EDGE_FRAMES).items():
        qe = int8_weights_from_numpy(tree, "cuda")
        xe = torch.from_numpy(frames).cuda()
        pairs = conv_pairs(xe, qe, ("v7", "v5", "v1"))
        torch.cuda.synchronize()
        record(pairs, f"v7_edge_{kind}", f"frames_b{xe.shape[0]}", int(xe.shape[0]))
        v7_same = v7_siblings(pairs)
        v7_map = pairs["conv_stage_int8_v7"][1]
        checks.append({"weights": f"v7_edge_{kind}", "input": f"frames_b{xe.shape[0]}",
                       "maps_vs_v7": v7_same,
                       "conv_live_fraction": round(float((v7_map > 0).float().mean()), 4),
                       "conv_saturated_fraction": round(float((v7_map == 127).float().mean()), 4)})
        require(all(m == 0 for m in v7_same.values()), f"v7_edge_{kind}: maps vs v7 {v7_same}")
    # Rows 3 and 4 at their batch edges and the bench's sizes on the
    # artifact and two seeded models (the second at the fold's 2^24 edge),
    # each map also against v7's, and conv1's map whole on the artifact and
    # the edge model; rows 5 and 10 the same way on the artifact, the
    # seeded model and row 1's edge models (each on its own frames), rows 6
    # and 7 on the tap planes of the same and on random planes, and rows 8
    # and 9 on their tap rows and on random rows.
    x_fold = torch.from_numpy((0.7 * np.random.default_rng(SEED + 1).standard_normal(
        (max(FOLD_BATCHES), 2, 128))).astype(np.float32)).cuda()
    batch_recs = fold_stage_checks(
        {k: weights[k] for k in ("artifact", "seeded", "fold_edge")},
        {"artifact": art_np.tree(), "fold_edge": fold_edge}, x_fold)
    batch_recs += v5_stage_checks({k: weights[k] for k in ("artifact", "seeded")}, x_fold)
    batch_recs += v6_stage_checks({k: weights[k] for k in ("artifact", "seeded")}, x_fold)
    batch_recs += v3_stage_checks({k: weights[k] for k in ("artifact", "seeded")}, x_fold)
    for rec in batch_recs:
        st = stats[rec["kernel"]]
        st["mismatches"] += rec["mismatches"]
        st["checked"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], rec["max_abs_err"])
        checks.append(rec)
        require(rec.get("maps_vs_v7", 0) == 0, f"{rec}: map differs from v7's")
    del x_fold
    # Rows 2 and 11 at their edges (scripts/probe.py::dense_edge_cases):
    # dense1 sums near 1.6e8, a seeded map over all of [0, 127], exact and
    # one-ulp ties, each at B = 4097 and 4095 (the last 128-frame tile
    # ragged), the artifact's weights changed as each kind says.
    for kind, (tree, hmap) in probe.dense_edge_cases(art_np.tree(), BATCH + 1, SEED).items():
        qe = int8_weights_from_numpy(tree, "cuda")
        h_all = torch.from_numpy(hmap).cuda()
        for hb in (h_all, h_all[:BATCH - 1]):
            lab_p = infer.dense_argmax_int8_plain(hb, qe)
            logits_p = infer.dense_int8_plain(hb, qe)
            pairs = {"dense_argmax_int8": (infer.dense_argmax_int8(hb, qe), lab_p),
                     "dense_int8": (infer.dense_int8(hb, qe), logits_p)}
            torch.cuda.synchronize()
            record(pairs, f"edge_{kind}", f"map_b{hb.shape[0]}", int(hb.shape[0]))
            top2 = logits_p.topk(2, dim=-1).values
            checks.append({"weights": f"edge_{kind}", "input": f"map_b{hb.shape[0]}",
                           "label_counts": torch.bincount(lab_p, minlength=11).tolist(),
                           "top2_equal": int((top2[:, 0] == top2[:, 1]).sum())})
    timing_rows, stats["correct_timing_fir"] = timing_checks(
        demo_frames, stream_bench_frames(BATCH))
    checks += timing_rows
    bf16_rows, bf16_stats = bf16_checks(demo_frames, x_seed, bench_x)
    checks += bf16_rows
    stats.update(bf16_stats)
    for c in checks:
        emit({"phase": "kernels.check", **c})
    for kname, s in stats.items():
        require(s["mismatches"] == 0, f"{kname}: {s['mismatches']} mismatches vs plain")
        require(s["checked"] > 0, f"{kname}: never checked")

    # Timing at B=4096 with the artifact's weights.
    qw = weights["artifact"]
    b = BATCH
    x = x_seed[:b]
    planes = infer.tap_planes(x, qw.inv_sx)
    tap_rows = infer.expand_taps(x, qw.inv_sx)
    a1 = infer.conv1_int8_plain(x, qw)
    a1f = a1.reshape(-1, 512)                                    # (B*126, 512)
    conv = infer.conv_stage_int8_v7_plain(x, qw)
    im2col = torch.cat([a1[:, k:k + 124] for k in range(3)], dim=-1).reshape(-1, 1536)
    w2l_cm = qw.w2l.t().contiguous().t()                        # column-major
    h = conv.reshape(b, -1)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # The six conv stages compute one function (the same map from the same
    # model), so they share one count of operations: the function's int8
    # MACs (conv1 126*512*3 and conv2 124*80*1536 per frame, not the folded
    # form's padded lanes). Bytes: each input read once (frames, or v4/v6's
    # tap planes, v3/v2's tap rows), the map written once, the weights the
    # stage reads.
    conv_ops = 2 * b * (126 * 512 * 3 + 124 * 80 * 1536)
    conv_out = b * 124 * 80
    frames_in, planes_in, rows_in = nbytes(x), nbytes(planes), nbytes(tap_rows)
    dense_ops = 2 * b * (9920 * 256 + 256 * 11)
    dense_w = nbytes(qw.w3t, qw.m3, qw.o3, qw.w4, qw.s4, qw.b4)
    w_v7 = nbytes(qw.w1, qw.m1, qw.o1, qw.w2t, qw.m2, qw.o2)
    w_int = nbytes(qw.w1e, qw.m1, qw.o1, qw.w2l, qw.m2, qw.o2)
    w_fold = nbytes(qw.w1f, qw.w2l, qw.m2, qw.o2)
    work = {  # name: (int8 ops, bytes)
        "conv_stage_int8_v7": (conv_ops, frames_in + conv_out + w_v7),
        "conv_stage_int8_v9": (conv_ops, frames_in + conv_out + w_fold),
        "conv_stage_int8_v10": (conv_ops, frames_in + conv_out + w_fold),
        "conv_stage_int8_v5": (conv_ops, frames_in + conv_out + w_int),
        "conv_stage_int8_v6": (conv_ops, planes_in + conv_out + w_int),
        "conv_stage_int8_v4": (conv_ops, planes_in + conv_out + w_int),
        "conv_stage_int8_v3": (conv_ops, rows_in + conv_out + w_int),
        "conv_stage_int8_v2": (conv_ops, rows_in + conv_out + w_int),
        "conv_stage_int8_v1": (conv_ops, frames_in + conv_out + w_int),
        "dense_argmax_int8": (dense_ops, b * 9920 + b * 4 + dense_w),
        "dense_int8": (dense_ops, b * 9920 + b * 11 * 4 + dense_w),
    }
    int8_peak, bw_peak = dev_info["int8_ops_per_s"], dev_info["bytes_per_s"]

    def bound(int8_ops, nb):
        t_ops = int8_ops / int8_peak * 1e3
        t_bytes = nb / bw_peak * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    lane_packed = (lambda: torch._int_mm(a1f, w2l_cm),
                   "torch._int_mm, conv2 lane-packed (B*126, 512) x (512, 240)")
    im2col_mm = (lambda: torch._int_mm(im2col, qw.w2t.T), "torch._int_mm, conv2 im2col "
                 "(B*124, 1536) x (1536, 80)")
    plans = (
        ("conv_stage_int8_v7", infer.conv_stage_int8_v7, infer.conv_stage_int8_v7_plain,
         *im2col_mm, x),
        ("dense_argmax_int8", infer.dense_argmax_int8, infer.dense_argmax_int8_plain,
         lambda: torch._int_mm(h, qw.w3t.T), "torch._int_mm, dense1 (B, 9920) x "
         "(9920, 256)", h),
        ("conv_stage_int8_v10", infer.conv_stage_int8_v10,
         infer.conv_stage_int8_folded_plain, *lane_packed, x),
        ("conv_stage_int8_v9", infer.conv_stage_int8_v9,
         infer.conv_stage_int8_folded_plain, *lane_packed, x),
        ("conv_stage_int8_v5", infer.conv_stage_int8_v5,
         infer.conv_stage_int8_v5_plain, *lane_packed, x),
        ("conv_stage_int8_v6", infer.conv_stage_int8_v6,
         infer.conv_stage_int8_planes_plain, *lane_packed, planes),
        ("conv_stage_int8_v4", infer.conv_stage_int8_v4,
         infer.conv_stage_int8_planes_plain, *lane_packed, planes),
        ("conv_stage_int8_v3", infer.conv_stage_int8_v3,
         infer.conv_stage_int8_taps_plain, *im2col_mm, tap_rows),
        ("conv_stage_int8_v2", infer.conv_stage_int8_v2,
         infer.conv_stage_int8_taps_plain, *im2col_mm, tap_rows),
        ("dense_int8", infer.dense_int8, infer.dense_int8_plain,
         lambda: torch._int_mm(h, qw.w3t.T), "torch._int_mm, dense1 (B, 9920) x "
         "(9920, 256)", h),
        ("conv_stage_int8_v1", infer.conv_stage_int8_v1,
         infer.conv_stage_int8_v5_plain, *lane_packed, x),
    )
    rows = []
    for kname, kernel, plain, lib, lib_what, arg in plans:
        ms = time_ms(lambda: kernel(arg, qw), iters=20)
        dev_ms = device_ms(lambda: kernel(arg, qw), KERNEL_SYMBOLS[kname])
        plain_ms = time_ms(lambda: plain(arg, qw), iters=2, warmup=1, reps=3)
        library_ms = time_ms(lib, iters=20)
        int8_ops, nb = work[kname]
        bms, by = bound(int8_ops, nb)
        rows.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                     "replaces": TPU_KERNELS[kname], "launches": None,
                     "max_abs_err": stats[kname]["max_abs_err"],
                     "mismatches": stats[kname]["mismatches"],
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bms,
                     "bound_by": by, "library_ms": library_ms,
                     "library_call": lib_what, "batch": b,
                     "int8_ops": int8_ops, "bytes": nb})
    # Rows 2 and 11 against their earlier body, where a copy of it was put
    # at probe.OLD_DENSE_SRC (the package never holds one): old, new, new,
    # old in this run, outputs bit for bit.
    old_lib = probe.old_library(probe.OLD_DENSE_SRC, probe.DENSE_ENTRIES)
    if old_lib is None:
        emit({"phase": "kernels.old_vs_new",
              "skipped": f"no earlier body at {os.path.relpath(probe.OLD_DENSE_SRC, REPO)}"})
    else:
        for rec in probe.dense_old_vs_new(old_lib, qw):
            emit({"phase": "kernels.old_vs_new", **rec})
            require(rec["ok"], f"{rec['name']} B={rec['batch']}: new vs old body differ")
    # Row 1 against its earlier body, where a copy of it was put at
    # probe.OLD_CONV_V7_SRC: old, new, new, old in this run, maps bit for
    # bit, beside _int_mm on conv2's im2col.
    old_v7 = probe.old_library(probe.OLD_CONV_V7_SRC, probe.CONV_V7_ENTRIES)
    if old_v7 is None:
        emit({"phase": "kernels.old_vs_new",
              "skipped": f"no earlier body at {os.path.relpath(probe.OLD_CONV_V7_SRC, REPO)}"})
    else:
        for rec in probe.conv_v7_old_vs_new(old_v7, qw, batches=(4096, 2048, 16384)):
            emit({"phase": "kernels.old_vs_new", **rec})
            require(rec["ok"], f"{rec['name']} B={rec['batch']}: new vs old body differ")
    # Rows 5 and 10 against their earlier body, where a copy of it was put
    # at probe.OLD_CONV_V5_SRC: old, new, new, old in this run, maps bit for
    # bit, beside row 1 and _int_mm on conv2's lane-packed product.
    old_v5 = probe.old_library(probe.OLD_CONV_V5_SRC, probe.CONV_V5_ENTRIES)
    if old_v5 is None:
        emit({"phase": "kernels.old_vs_new",
              "skipped": f"no earlier body at {os.path.relpath(probe.OLD_CONV_V5_SRC, REPO)}"})
    else:
        for rec in probe.conv_v5_old_vs_new(old_v5, qw, batches=(4096, 2048, 16384)):
            emit({"phase": "kernels.old_vs_new", **rec})
            require(rec["ok"], f"{rec['name']} B={rec['batch']}: new vs old body differ")
    # Rows 6 and 7 against their earlier body, where a copy of it was put
    # at probe.OLD_CONV_V6_SRC: old, new, new, old in this run on the same
    # tap planes, maps bit for bit, beside rows 5 and 1 and _int_mm.
    old_v6 = probe.old_library(probe.OLD_CONV_V6_SRC, probe.CONV_V6_ENTRIES)
    if old_v6 is None:
        emit({"phase": "kernels.old_vs_new",
              "skipped": f"no earlier body at {os.path.relpath(probe.OLD_CONV_V6_SRC, REPO)}"})
    else:
        for rec in probe.conv_v6_old_vs_new(old_v6, qw, batches=(4096, 2048, 16384)):
            emit({"phase": "kernels.old_vs_new", **rec})
            require(rec["ok"], f"{rec['name']} B={rec['batch']}: new vs old body differ")
    # Rows 8 and 9 against their earlier body, where a copy of it was put
    # at probe.OLD_CONV_V3_SRC: old, new, new, old in this run on the same
    # tap rows, maps bit for bit, beside rows 6 and 1 and _int_mm.
    old_v3 = probe.old_library(probe.OLD_CONV_V3_SRC, probe.CONV_V3_ENTRIES)
    if old_v3 is None:
        emit({"phase": "kernels.old_vs_new",
              "skipped": f"no earlier body at {os.path.relpath(probe.OLD_CONV_V3_SRC, REPO)}"})
    else:
        for rec in probe.conv_v3_old_vs_new(old_v3, qw, batches=(4096, 2048, 16384)):
            emit({"phase": "kernels.old_vs_new", **rec})
            require(rec["ok"], f"{rec['name']} B={rec['batch']}: new vs old body differ")
    # Rows 3 and 4 against their earlier body, where a copy of it was put
    # at probe.OLD_CONV_FOLD_SRC: old, new, new, old in this run, maps bit
    # for bit, beside row 1 and _int_mm on conv2's lane-packed product.
    old_fold = probe.old_library(probe.OLD_CONV_FOLD_SRC, probe.CONV_FOLD_ENTRIES)
    if old_fold is None:
        emit({"phase": "kernels.old_vs_new", "skipped": "no earlier body at "
              f"{os.path.relpath(probe.OLD_CONV_FOLD_SRC, REPO)}"})
    else:
        for rec in probe.conv_fold_old_vs_new(old_fold, qw, batches=(4096, 2048, 16384)):
            emit({"phase": "kernels.old_vs_new", **rec})
            require(rec["ok"], f"{rec['name']} B={rec['batch']}: new vs old body differ")
    # The timing FIR on the stream bench's 4096 frames with their own
    # filters. Bytes: the frames read once (unpadded), the filters, the
    # output written once; operations: 17 multiplies and adds per output
    # over the float32 peak.
    import torch.nn.functional as F

    from modulationdetectioncnn_torch.config import StreamConfig
    from modulationdetectioncnn_torch.dsp import normalize
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call

    sc = StreamConfig()
    xt = stream_bench_frames(b)
    ct = normalize.timing_filters(normalize.estimate_timing(xt, sc.sps), sc.sps,
                                  sc.timing_phases)
    taps = ct.shape[1]
    xpad = F.pad(xt, ((taps - 1) // 2, (taps - 1) // 2))
    c4 = ct[:, None, :, None]
    t_ops, t_bytes = 2 * taps * xt.numel(), 2 * nbytes(xt) + nbytes(ct)
    t_bound = max(t_ops / dev_info["f32_flops_per_s"], t_bytes / bw_peak) * 1e3
    # A launch of this kernel is shorter than the host's time to issue one
    # through the wrapper, so back-to-back CUDA events time the host: its
    # "ms" is the profiler's device time, the events' time is reported too.
    # The stream's frames take the window route, and only it.
    fir = lambda: normalize.correct_timing_fir(xt, ct)  # noqa: E731
    normalize.reset_launch_counts()
    fir()
    fir_route = dict(normalize.correct_timing_fir.route_launches)
    require(fir_route == {"window": 1, "general": 0},
            f"the timing FIR at the stream's widths did not take the window route: {fir_route}")
    events_ms = time_ms(fir, iters=20)
    kernel_ms = device_ms(fir, KERNEL_SYMBOLS["correct_timing_fir"])
    fir_lib = lambda: torch.matmul(xpad.unfold(-1, taps, 1), c4)  # noqa: E731
    rows.append({"name": "correct_timing_fir", "route": "cuda", "fir_route": "window",
                 **ptxas_usage(dev_info["ptxas_log"], "correct_timing_fir_window_kernelILi8E"),
                 "source": SOURCES["correct_timing_fir"],
                 "replaces": TPU_KERNELS["correct_timing_fir"], "launches": None,
                 "max_abs_err": stats["correct_timing_fir"]["max_abs_err"],
                 "mismatches": stats["correct_timing_fir"]["mismatches"],
                 "ms": kernel_ms if kernel_ms is not None else events_ms,
                 "ms_from": "profiler" if kernel_ms is not None else "cuda_events",
                 "events_ms": events_ms,
                 "plain_ms": time_ms(lambda: normalize.correct_timing_fir_plain(xt, ct),
                                     iters=20),
                 "bound_ms": t_bound,
                 "bound_by": ("operations" if t_ops / dev_info["f32_flops_per_s"]
                              >= t_bytes / bw_peak else "bytes"),
                 "library_ms": time_ms(fir_lib, iters=20),
                 "library_device_ms": device_ms_per_call(fir_lib),
                 "library_call": "torch.matmul, (B, 2, 128, 17) unfolded frames x "
                                 "(B, 1, 17, 1) filters",
                 "batch": b, "f32_ops": t_ops, "bytes": t_bytes})
    # Row 21 against its earlier body, where a copy of it was put at
    # probe.OLD_TIMING_SRC: old, new, new, old in this run, outputs bit for
    # bit, beside the library call.
    old_fir = probe.old_library(probe.OLD_TIMING_SRC, probe.TIMING_ENTRIES)
    if old_fir is None:
        emit({"phase": "kernels.old_vs_new",
              "skipped": f"no earlier body at {os.path.relpath(probe.OLD_TIMING_SRC, REPO)}"})
    else:
        for rec in probe.timing_old_vs_new(old_fir):
            emit({"phase": "kernels.old_vs_new", **rec})
            require(rec["ok"], f"{rec['name']} B={rec['batch']}: new vs old body differ")
    # The bf16 stages on the bench's seeded float weights (what its
    # pallas_bf16_v4 and pallas_bf16 backends serve), at B=4096: operations
    # over the peak for their type, bytes as for the int8 rows. The v4 and
    # v2 conv stages and the dense stages count the function's MACs as bf16
    # (the products are of bf16 values; counted as for rows 1, 3-9); the
    # f32-conv1 stage's conv1 runs on the f32 pipes beside the tensor
    # cores, so its operations time is the larger of conv2's bf16 MACs over
    # the bf16 peak and conv1's f32 MACs over the f32 peak.
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2
    from modulationdetectioncnn_torch.ops import infer_bf16 as ib

    bw = ib.make_bf16_weights(VTCNN2(generator=torch.Generator().manual_seed(0)).state_dict(),
                              "cuda")
    bmap = ib.conv_stage_bf16_v4_plain(x, bw)
    xe = ib.expand_taps_bf16(x)
    a1b = ib.conv1_bf16_plain(x, bw).reshape(-1, 512)          # (B*126, 512) bf16
    w2_cm = bw.w2t.T                                            # (512, 240), column-major
    hb = bmap.reshape(b, -1)
    bf16_peak, f32_peak = dev_info["bf16_flops_per_s"], dev_info["f32_flops_per_s"]
    conv1_f32_ops = 2 * b * 126 * 512 * 3
    conv2_lib = (lambda: torch.matmul(a1b, w2_cm),
                 "torch.matmul bf16, conv2 lane-packed (B*126, 512) x (512, 240)")
    dense1_lib = (lambda: torch.matmul(hb, bw.w3t.T),
                  "torch.matmul bf16, dense1 (B, 9920) x (9920, 256)")
    dense_w = nbytes(bw.w3t, bw.b3, bw.w4, bw.b4)
    for kname, kernel, plain, (lib, lib_what), arg, ops, f32_ops, nb in (
            ("conv_stage_bf16_v4", ib.conv_stage_bf16_v4, ib.conv_stage_bf16_v4_plain,
             conv2_lib, x, conv_ops, 0,
             frames_in + nbytes(bmap) + nbytes(bw.w1e, bw.w2t, bw.b2)),
            ("dense_argmax_bf16", ib.dense_argmax_bf16, ib.dense_argmax_bf16_plain,
             dense1_lib, bmap, dense_ops, 0, nbytes(bmap) + b * 4 + dense_w),
            ("conv_stage_bf16_v2", ib.conv_stage_bf16_v2, ib.conv_stage_bf16_v2_plain,
             conv2_lib, xe, conv_ops, 0,
             nbytes(xe) + nbytes(bmap) + nbytes(bw.w1e, bw.w2t, bw.b2)),
            ("dense_logits_bf16", ib.dense_logits_bf16, ib.dense_logits_bf16_plain,
             dense1_lib, bmap, dense_ops, 0, nbytes(bmap) + b * 11 * 4 + dense_w),
            ("conv_stage_bf16", ib.conv_stage_bf16, ib.conv_stage_bf16_plain,
             conv2_lib, x, conv_ops - conv1_f32_ops, conv1_f32_ops,
             frames_in + nbytes(bmap) + nbytes(bw.w1p, bw.b1, bw.w2t, bw.b2))):
        t_ops = max(ops / bf16_peak, f32_ops / f32_peak) * 1e3
        t_bytes = nb / bw_peak * 1e3
        rows.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                     "replaces": TPU_KERNELS[kname], "launches": None,
                     "max_abs_err": stats[kname]["max_abs_err"],
                     "mismatches": stats[kname]["mismatches"],
                     "ms": time_ms(lambda: kernel(arg, bw), iters=20),
                     "device_ms": device_ms(lambda: kernel(arg, bw), KERNEL_SYMBOLS[kname]),
                     "plain_ms": time_ms(lambda: plain(arg, bw), iters=5, warmup=1, reps=3),
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "library_ms": time_ms(lib, iters=20), "library_call": lib_what,
                     "batch": b, "bf16_ops": ops, "f32_ops": f32_ops, "bytes": nb})
    # Rows 13 and 16 against their earlier body, where a copy of it was put
    # at probe.OLD_DENSE_BF16_SRC: old, new, new, old in this run, outputs
    # within the dense stage's tolerances of each other.
    old_bf16 = probe.old_library(probe.OLD_DENSE_BF16_SRC, probe.DENSE_BF16_ENTRIES)
    if old_bf16 is None:
        emit({"phase": "kernels.old_vs_new", "skipped": "no earlier body at "
              f"{os.path.relpath(probe.OLD_DENSE_BF16_SRC, REPO)}"})
    else:
        for rec in probe.dense_old_vs_new(old_bf16, bw, probe.DENSE_BF16_STAGES):
            emit({"phase": "kernels.old_vs_new", **rec})
            require(rec["ok"], f"{rec['name']} B={rec['batch']}: new vs old body differ: {rec}")
    # Rows 15, 14 and 12 against their earlier body, where a copy of it was
    # put at probe.OLD_CONV_BF16_SRC: old, new, new, old in this run, maps
    # within the bf16 tolerance of each other, beside torch.matmul's conv2.
    old_conv = probe.old_library(probe.OLD_CONV_BF16_SRC, probe.CONV_BF16_ENTRIES)
    if old_conv is None:
        emit({"phase": "kernels.old_vs_new", "skipped": "no earlier body at "
              f"{os.path.relpath(probe.OLD_CONV_BF16_SRC, REPO)}"})
    else:
        for rec in probe.conv_bf16_old_vs_new(old_conv, bw, batches=(4096, 2048, 16384)):
            emit({"phase": "kernels.old_vs_new", **rec})
            require(rec["ok"], f"{rec['name']} B={rec['batch']}: new vs old body differ: {rec}")
    prologue_ms = time_ms(lambda: infer.tap_planes(x, qw.inv_sx), iters=20)
    rows_ms = time_ms(lambda: infer.expand_taps(x, qw.inv_sx), iters=20)
    filters_ms = time_ms(lambda: normalize.timing_filters(
        normalize.estimate_timing(xt, sc.sps), sc.sps, sc.timing_phases), iters=20)
    bf16_rows_ms = time_ms(lambda: ib.expand_taps_bf16(x), iters=20)
    emit({"phase": "kernels", "timed": rows,
          "tap_planes_prologue_ms": prologue_ms, "expand_taps_prologue_ms": rows_ms,
          "expand_taps_bf16_prologue_ms": bf16_rows_ms,
          "timing_estimate_and_filters_ms": filters_ms})
    return rows


def phase_cnn_kernels(dev_info: dict, demo: torch.Tensor) -> list[dict]:
    """Rows 17-20 (``ops/cnn_kernels.py``) against their plain versions on
    the bench's 4096 seeded frames, the stream demo's 1024, B=1, a ragged
    37-frame slice, B = 4095, 4097 and 133 (frame counts the persistent
    grid does not divide), and on three odd shapes with seeded weights (T
    40, C 33, Co 7; T 300, C 48, Co 100, where conv2 takes three row tiles
    and two channel tiles; T 300 at C 256, Co 80, three row tiles on the
    Hopper route), and conv2 on its edges (``conv2_edge_cases``): rows 17
    (bf16 and float32 out), 19 and 20 bit for bit,
    row 18 within 1e-5 of the map's largest magnitude in float32 (on the
    FFMA route, and on the general route at T 40, C 33, Co 7) and within
    the bf16 map tolerance in bf16. Float weights: the bench's seeded model
    and the exported checkpoint; int8: the committed artifact. On the
    quantized frames row 19 -> row 20 must equal v7's map (row 1) bit for
    bit and, through the int8 dense stage, v7's labels. Each conv1 case
    must take the route its widths give (rows 17 and 19). Then times at
    B=4096. Returns the rows of the kernels line."""
    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.config import AmcConfig, ModelConfig
    from modulationdetectioncnn_torch.ops import cnn_kernels as ck
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.ops.requant import quantize_input
    from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, QuantizedModel, load_int8
    from modulationdetectioncnn_torch.scripts import probe
    from modulationdetectioncnn_torch.utils.checkpoint import restore_model

    ck.reset_launch_counts()
    bench_x, _, bench_model = bench._frames_and_model(AmcConfig(), BATCH)
    ckpt_model = restore_model(FLOAT_CKPT, ModelConfig(), 128, "cuda")[0]
    float_sets = {"bench_seeded": ck.float_conv_weights(bench_model.state_dict(), "cuda"),
                  "float_checkpoint": ck.float_conv_weights(ckpt_model.state_dict(), "cuda")}
    art = QuantizedModel.from_npz(DEFAULT_ARTIFACT)
    i8 = tuple(torch.from_numpy(np.asarray(getattr(art, k))).cuda()
               for k in ("w1p", "m1", "o1", "w2p", "m2", "o2"))
    qw = load_int8(device="cuda")
    extra = torch.from_numpy(np.random.default_rng(SEED + 4).standard_normal(
        (1, 2, 128)).astype(np.float32)).cuda()
    inputs = {f"bench_frames_b{BATCH}": bench_x, "stream_frames": demo,
              "bench_b1": bench_x[:1], "bench_b37_at3": bench_x[3:40],
              "bench_b4095": bench_x[:4095], "bench_b4097": torch.cat([bench_x, extra]),
              "bench_b133": bench_x[:133]}
    r = np.random.default_rng(SEED + 3)
    odd_shapes = {}      # seeded weights at widths the main path never gives
    for nb, nt, nc, nco in ((37, 40, 33, 7), (5, 300, 48, 100), (5, 302, 256, 80)):  # B, T, C, Co
        odd_shapes[f"t{nt}_c{nc}_co{nco}"] = (
            tuple(torch.from_numpy(a.astype(np.float32)).cuda() for a in (
                r.standard_normal((nb, 2, nt)), r.standard_normal((3, nc)) / np.sqrt(3),
                0.1 * r.standard_normal(nc),
                r.standard_normal((2 * nc, 3 * nco)) / np.sqrt(6 * nc),
                0.1 * r.standard_normal(nco))),
            tuple(torch.from_numpy(a).cuda() for a in (
                r.integers(-127, 128, (nb, 2, nt)).astype(np.int8),
                r.integers(-127, 128, (3, nc)).astype(np.int8),
                r.integers(4, 10, 2 * nc).astype(np.int32),
                r.integers(-2000, 2000, 2 * nc).astype(np.int32),
                r.integers(-127, 128, (2 * nc, 3 * nco)).astype(np.int8),
                r.integers(10, 16, nco).astype(np.int32),
                r.integers(-20000, 20000, nco).astype(np.int32))))
    stats = {k: {"mismatches": 0, "max_abs_err": 0.0, "checked": 0} for k in CNN_KERNELS}
    checks = []

    def record(kname, case, got, want, rtol=0.0, atol_of_max=0.0):
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{kname} {case}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
                f"{want.dtype}")
        # int8 maps in int32 (a B=16384 map is 1.06 G elements), floats in
        # float64.
        g, w = (got.double(), want.double()) if got.is_floating_point() \
            else (got.to(torch.int32), want.to(torch.int32))
        diff = (g - w).abs()
        bad = int((diff > rtol * w.abs() + atol_of_max * float(w.abs().max())).sum()) \
            if rtol or atol_of_max else int((g != w).sum())
        st = stats[kname]
        st["mismatches"] += bad
        st["checked"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], float(diff.max()) if diff.numel() else 0.0)
        checks.append({"kernel": kname, "case": case, "shape": list(got.shape),
                       "dtype": str(got.dtype), "outside_tolerance": bad,
                       "max_abs_diff": float(diff.max()) if diff.numel() else 0.0,
                       "bit_equal_share": float((g == w).sum()) / max(g.numel(), 1)})
        require(bool(torch.isfinite(g).all()), f"{kname} {case}: non-finite output")

    def conv1_check(case, x, w1p, b1, out):
        before = dict(ck.conv1_stacked.route_launches)
        a1 = ck.conv1_stacked(x, w1p, b1, out_dtype=out)
        record("conv1_stacked", case, a1, ck.conv1_stacked_plain(x, w1p, b1, out))
        conv1_f_routes[case] = ([r for r, c in ck.conv1_stacked.route_launches.items()
                                 if c != before[r]], ck.conv1_route(x.shape[-1], w1p.shape[1], out))
        return a1

    def float_pair(case, x, w1p, b1, w2p, b2):
        for out in (torch.bfloat16, torch.float32):
            a1 = conv1_check(f"{case}/{str(out)[6:]}", x, w1p, b1, out)
            w2 = w2p.to(out).contiguous()
            before = dict(ck.conv2_stacked.route_launches)
            got = ck.conv2_stacked(a1, w2, b2, out_dtype=out)
            want = ck.conv2_stacked_plain(a1, w2, b2, out)
            if out == torch.float32:
                f32_routes[case] = [r for r, c in ck.conv2_stacked.route_launches.items()
                                    if c != before[r]]
            if out == torch.bfloat16:
                record("conv2_stacked", f"{case}/bf16", got, want, probe.BF16_MAP_RTOL,
                       probe.BF16_MAP_ATOL_OF_MAX)
            else:
                record("conv2_stacked", f"{case}/float32", got, want, 0.0, 1e-5)

    def conv1_int8_check(case, xq, w1p, m1, o1):
        before = dict(ck.conv1_stacked_int8.route_launches)
        a1 = ck.conv1_stacked_int8(xq, w1p, m1, o1)
        record("conv1_stacked_int8", case, a1, ck.conv1_stacked_int8_plain(xq, w1p, m1, o1))
        conv1_routes[case] = ([r for r, c in ck.conv1_stacked_int8.route_launches.items()
                               if c != before[r]], ck.conv1_int8_route(xq.shape[-1], w1p.shape[1]))
        return a1

    def int8_pair(case, xq, w1p, m1, o1, w2p, m2, o2):
        a1 = conv1_int8_check(case, xq, w1p, m1, o1)
        a2 = ck.conv2_stacked_int8(a1, w2p, m2, o2)
        record("conv2_stacked_int8", case, a2, ck.conv2_stacked_int8_plain(a1, w2p, m2, o2))
        return a2

    chain = {}
    f32_routes = {}      # case: the routes its float32 conv2 launch counted
    conv1_routes = {}    # case: (the routes its int8 conv1 launch counted, its widths' route)
    conv1_f_routes = {}  # case: the same for the float conv1 (row 17)
    for xname, x in inputs.items():
        for wname, fw in float_sets.items():
            float_pair(f"{wname}/{xname}", x, *fw)
        a2 = int8_pair(f"artifact/{xname}", quantize_input(x, qw.inv_sx), *i8)
        v7_map = infer.conv_stage_int8_v7(x, qw)
        labels = infer.dense_argmax_int8(a2, qw)
        v7_labels = infer.make_int8_predict(qw, "v7")(x)
        torch.cuda.synchronize()
        chain[xname] = {"map_vs_v7": int((a2 != v7_map).sum()),
                        "labels_vs_v7": int((labels != v7_labels).sum()), "n": int(x.shape[0])}
    for name, (fl, i8_odd) in odd_shapes.items():
        float_pair(name, *fl)
        int8_pair(name, *i8_odd)
    for name, (a1, w2p, *rest) in conv2_edge_cases(SEED + 5).items():
        if a1.dtype == torch.int8:
            record("conv2_stacked_int8", name, ck.conv2_stacked_int8(a1, w2p, *rest),
                   ck.conv2_stacked_int8_plain(a1, w2p, *rest))
        elif a1.dtype == torch.float32:
            record("conv2_stacked", name, ck.conv2_stacked(a1, w2p, *rest, out_dtype=a1.dtype),
                   ck.conv2_stacked_plain(a1, w2p, *rest, a1.dtype), 0.0, 1e-5)
        else:
            record("conv2_stacked", name, ck.conv2_stacked(a1, w2p, *rest),
                   ck.conv2_stacked_plain(a1, w2p, *rest), probe.BF16_MAP_RTOL,
                   probe.BF16_MAP_ATOL_OF_MAX)
    # Row 19's edges (probe.conv1_int8_edge_cases: x at -128 and +127 under
    # taps of -128 and +127, shifts 0 .. 31, offsets at the clip's edges) at
    # B = 1, 37, 4097 and 16384, C = 16, 48 and 256 on the dp4a route and 33
    # on the general one; T 3; and frames that start 1 byte past a word (T
    # 41: each frame's first byte lands on every offset in a word).
    for nc in (16, 48, 256, 33):
        for nb in CONV1_EDGE_BATCHES:
            for kind, arrs in probe.conv1_int8_edge_cases(SEED + nc + nb, nb, 128, nc).items():
                conv1_int8_check(f"edge_{kind}/b{nb}_c{nc}",
                                 *(torch.from_numpy(a).cuda() for a in arrs))
    for kind, (xe, *rest) in probe.conv1_int8_edge_cases(SEED + 7, 37, 3, 16).items():
        conv1_int8_check(f"edge_{kind}/b37_t3_c16", torch.from_numpy(xe).cuda(),
                         *(torch.from_numpy(a).cuda() for a in rest))
    for kind, (xe, *rest) in probe.conv1_int8_edge_cases(SEED + 8, 37, 41, 48).items():
        flat = torch.zeros(xe.size + 1, dtype=torch.int8, device="cuda")
        flat[1:] = torch.from_numpy(xe.reshape(-1)).cuda()
        conv1_int8_check(f"edge_{kind}/b37_t41_c48_offset1", flat[1:].view(xe.shape),
                         *(torch.from_numpy(a).cuda() for a in rest))
    # Row 17 at T 41 (frames of 328 bytes: every other one starts 8 bytes
    # past a 16-byte boundary) and on the same frames 4 bytes further on
    # (starts 4 and 12 bytes past one), both on the register route, bf16
    # and float32 out.
    rf = np.random.default_rng(SEED + 9)
    for nc in (48, 256):
        xf = rf.standard_normal((37, 2, 41)).astype(np.float32)
        w1f = torch.from_numpy((rf.standard_normal((3, nc)) / np.sqrt(3)).astype(np.float32)).cuda()
        b1f = torch.from_numpy((0.1 * rf.standard_normal(nc)).astype(np.float32)).cuda()
        flat = torch.zeros(xf.size + 1, dtype=torch.float32, device="cuda")
        flat[1:] = torch.from_numpy(xf.reshape(-1)).cuda()
        for out in (torch.bfloat16, torch.float32):
            conv1_check(f"b37_t41_c{nc}/{str(out)[6:]}", torch.from_numpy(xf).cuda(), w1f, b1f,
                        out)
            conv1_check(f"b37_t41_c{nc}_offset1/{str(out)[6:]}", flat[1:].view(xf.shape), w1f,
                        b1f, out)
    check_launches = ck.launch_counts()
    check_routes = ck.route_launch_counts()
    for c in checks:
        emit({"phase": "cnn_kernels.check", **c})
    emit({"phase": "cnn_kernels.chain", "row19_row20_vs_v7": chain})
    emit({"phase": "cnn_kernels.routes", "check_launches_per_route": check_routes,
          "float32_routes": f32_routes, "conv1_int8_routes": conv1_routes,
          "conv1_routes": conv1_f_routes})
    for kname, st in stats.items():
        require(st["mismatches"] == 0, f"{kname}: {st['mismatches']} elements outside "
                "tolerance of the plain version")
    # float32 on both bodies: the FFMA route but at the narrow odd shape.
    require(all(r == (["general"] if c.startswith("t40_") else ["ffma"])
                for c, r in f32_routes.items()), f"float32 conv2 routes: {f32_routes}")
    # int8 conv1 on both bodies: the dp4a route at C a multiple of 16, the
    # general one at C 33.
    require(all(took == [want] == [("general" if "c33" in c else "dp4a")]
                for c, (took, want) in conv1_routes.items()),
            f"int8 conv1 routes: {conv1_routes}")
    # float conv1 on both bodies: the register route but at T 40, C 33.
    require(all(took == [want] == [("general" if c.startswith("t40_c33") else "regs")]
                for c, (took, want) in conv1_f_routes.items()),
            f"float conv1 routes: {conv1_f_routes}")
    require(all(c["map_vs_v7"] == 0 and c["labels_vs_v7"] == 0 for c in chain.values()),
            f"row 19 -> row 20 differs from v7: {chain}")

    # Times at B=4096: rows 17-18 with the bench's seeded float model, rows
    # 19-20 with the artifact. Bound: inputs read once, outputs written once,
    # over 3.35 TB/s; operations over the peak for their type.
    import torch.nn.functional as F

    x = bench_x
    w1p, b1, w2p, b2 = float_sets["bench_seeded"]
    w2b = w2p.to(torch.bfloat16)
    a1b = ck.conv1_stacked(x, w1p, b1)
    a1f = ck.conv1_stacked(x, w1p, b1, out_dtype=torch.float32)
    xq = quantize_input(x, qw.inv_sx)
    a1q = ck.conv1_stacked_int8(xq, *i8[:3])
    w2q_cm = i8[3].t().contiguous().t()                     # column-major for _int_mm
    conv1_w = bench_model.conv1.weight.float()
    conv1_b = bench_model.conv1.bias.float()
    b, t1 = x.shape[0], x.shape[-1] - 2

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    conv1_ops = 2 * b * t1 * 512 * 3
    conv2_ops = 2 * b * (t1 - 2) * 80 * 1536
    bw = dev_info["bytes_per_s"]
    peaks = {"f32": dev_info["f32_flops_per_s"], "bf16": dev_info["bf16_flops_per_s"],
             "int8": dev_info["int8_ops_per_s"]}
    plans = (  # name, kernel, plain, library (call, what) or None, (ops, type), bytes
        ("conv1_stacked", lambda: ck.conv1_stacked(x, w1p, b1),
         lambda: ck.conv1_stacked_plain(x, w1p, b1),
         (lambda: F.relu(F.conv2d(x[:, None], conv1_w, conv1_b)),
          "F.conv2d + ReLU, f32 NCHW out (B, 256, 2, 126): another layout"),
         (conv1_ops, "f32"), nbytes(x, w1p, b1, a1b)),
        ("conv2_stacked", lambda: ck.conv2_stacked(a1b, w2b, b2),
         lambda: ck.conv2_stacked_plain(a1b, w2b, b2),
         (lambda: torch.matmul(a1b.reshape(-1, 512), w2b),
          "torch.matmul bf16, z = (B*126, 512) x (512, 240)"),
         (conv2_ops, "bf16"), nbytes(a1b, w2b, b2) + b * (t1 - 2) * 80 * 2),
        ("conv1_stacked_int8", lambda: ck.conv1_stacked_int8(xq, *i8[:3]),
         lambda: ck.conv1_stacked_int8_plain(xq, *i8[:3]), None,
         (conv1_ops, "int8"), nbytes(xq, *i8[:3], a1q)),
        ("conv2_stacked_int8", lambda: ck.conv2_stacked_int8(a1q, *i8[3:]),
         lambda: ck.conv2_stacked_int8_plain(a1q, *i8[3:]),
         (lambda: torch._int_mm(a1q.reshape(-1, 512), w2q_cm),
          "torch._int_mm, z = (B*126, 512) x (512, 240)"),
         (conv2_ops, "int8"), nbytes(a1q, *i8[3:]) + b * (t1 - 2) * 80),
    )
    # The default widths take the Hopper route in bf16 and int8, the FFMA
    # route in float32.
    ck.reset_launch_counts()
    plans[1][1]()
    plans[3][1]()
    plans[2][1]()
    plans[0][1]()
    timed_routes = ck.route_launch_counts()
    conv1_timed_route = timed_routes.pop("conv1_stacked_int8")
    conv1_f_timed_route = timed_routes.pop("conv1_stacked")
    require(all(timed_routes[k] == {"wgmma": 1, "ffma": 0, "general": 0} for k in timed_routes),
            f"conv2 at the default widths did not take the Hopper route: {timed_routes}")
    # ... and int8 conv1 the dp4a route.
    require(conv1_timed_route == {"dp4a": 1, "general": 0},
            f"int8 conv1 at the default widths did not take the dp4a route: {conv1_timed_route}")
    # ... and float conv1 the register route, bf16 out and float32 out.
    require(conv1_f_timed_route == {"regs": 1, "general": 0},
            f"conv1 (bf16 out) at the default widths did not take the register route: "
            f"{conv1_f_timed_route}")
    ck.reset_launch_counts()
    ck.conv2_stacked(a1f, w2p, b2, out_dtype=torch.float32)
    ck.conv1_stacked(x, w1p, b1, out_dtype=torch.float32)
    f32_timed_route = ck.route_launch_counts()["conv2_stacked"]
    require(f32_timed_route == {"wgmma": 0, "ffma": 1, "general": 0},
            f"float32 conv2 at the default widths did not take the FFMA route: {f32_timed_route}")
    conv1_f32_timed_route = ck.route_launch_counts()["conv1_stacked"]
    require(conv1_f32_timed_route == {"regs": 1, "general": 0},
            f"conv1 (float32 out) at the default widths did not take the register route: "
            f"{conv1_f32_timed_route}")
    rows = []
    for kname, kernel, plain, lib, (ops, kind), nb in plans:
        t_ops, t_bytes = ops / peaks[kind] * 1e3, nb / bw * 1e3
        rows.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                     "replaces": TPU_KERNELS[kname], "launches": None,
                     "check_launches": check_launches[kname],
                     "max_abs_err": stats[kname]["max_abs_err"],
                     "mismatches": stats[kname]["mismatches"],
                     "ms": time_ms(kernel, iters=20),
                     "device_ms": device_ms(kernel, KERNEL_SYMBOLS[kname]),
                     "plain_ms": time_ms(plain, iters=2, warmup=1, reps=3),
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "library_ms": time_ms(lib[0], iters=20) if lib else None,
                     "library_call": lib[1] if lib else None,
                     "batch": b, f"{kind}_ops": ops, "bytes": nb})
        if kname in timed_routes:
            rows[-1]["conv2_route"] = "wgmma"
        if kname == "conv1_stacked_int8":
            rows[-1].update(conv1_int8_route="dp4a",
                            **ptxas_usage(dev_info["ptxas_log"], KERNEL_SYMBOLS[kname]))
        if kname == "conv1_stacked":
            rows[-1].update(conv1_route="regs",
                            **ptxas_usage(dev_info["ptxas_log"], CONV1_REGS_PTXAS[0]))
        require(rows[-1]["device_ms"] is not None,
                f"{kname}: the profiler shows no {KERNEL_SYMBOLS[kname]}")
    # Row 18's float32 form (CUDA cores), beside its bf16 row.
    f32_ops_ms = conv2_ops / peaks["f32"] * 1e3
    f32_bytes = nbytes(a1f, w2p, b2) + b * (t1 - 2) * 80 * 4
    rows[1]["float32"] = {
        "conv2_route": "ffma",
        "ms": time_ms(lambda: ck.conv2_stacked(a1f, w2p, b2, out_dtype=torch.float32), iters=5),
        "device_ms": device_ms(lambda: ck.conv2_stacked(a1f, w2p, b2, out_dtype=torch.float32),
                               F32_CONV2_SYMBOL, iters=5),
        "bound_ms": max(f32_ops_ms, f32_bytes / bw * 1e3),
        "bound_by": "operations" if f32_ops_ms >= f32_bytes / bw * 1e3 else "bytes",
        "library_ms": time_ms(lambda: torch.matmul(a1f.reshape(-1, 512), w2p), iters=5),
        "library_call": "torch.matmul f32 (TF32 off), z = (B*126, 512) x (512, 240)"}
    require(rows[1]["float32"]["device_ms"] is not None,
            f"conv2_stacked: the profiler shows no {F32_CONV2_SYMBOL}")
    # Row 17's float32 out (the register route too), beside its bf16 row.
    conv1_f32 = lambda: ck.conv1_stacked(x, w1p, b1, out_dtype=torch.float32)  # noqa: E731
    c1_ops_ms, c1_bytes_ms = conv1_ops / peaks["f32"] * 1e3, nbytes(x, w1p, b1, a1f) / bw * 1e3
    rows[0].update(float32_out_ms=time_ms(conv1_f32, iters=20),
                   float32_out_device_ms=device_ms(conv1_f32, F32_CONV1_SYMBOL),
                   float32_out_bound_ms=max(c1_ops_ms, c1_bytes_ms),
                   float32_out_bound_by="operations" if c1_ops_ms >= c1_bytes_ms else "bytes",
                   float32_out_ptxas=ptxas_usage(dev_info["ptxas_log"], CONV1_REGS_PTXAS[1]))
    require(rows[0]["float32_out_device_ms"] is not None,
            f"conv1_stacked: the profiler shows no {F32_CONV1_SYMBOL}")
    emit({"phase": "cnn_kernels", "timed": rows, "check_launches": check_launches})
    # Rows 18, 20, 19 and 17 against an earlier body, where a copy of it
    # was put at probe.OLD_CNN_SRC: old, new, new, old in this run.
    old_lib = probe.old_library(probe.OLD_CNN_SRC, probe.CNN_ENTRIES)
    if old_lib is None:
        emit({"phase": "cnn_kernels.old_vs_new",
              "skipped": f"no earlier body at {os.path.relpath(probe.OLD_CNN_SRC, REPO)}"})
    else:
        for rec in probe.conv2_old_vs_new(old_lib, w2p, b2, *i8[3:]):
            emit({"phase": "cnn_kernels.old_vs_new", **rec})
            require(rec["outputs_differing"] == 0,
                    f"{rec['name']} B={rec['batch']}: new vs old body differ")
        # Row 19 against the copy's amc_conv1_stacked_int8, the same way.
        for rec in probe.conv1_int8_old_vs_new(old_lib, *i8[:3], qw.inv_sx):
            emit({"phase": "cnn_kernels.old_vs_new", **rec})
            require(rec["ok"], f"{rec['name']} B={rec['batch']}: new vs old body differ")
        # Row 17 against the copy's amc_conv1_stacked, bf16 and float32 out.
        for rec in probe.conv1_old_vs_new(old_lib, w1p, b1):
            emit({"phase": "cnn_kernels.old_vs_new", **rec})
            require(rec["ok"], f"{rec['name']} B={rec['batch']}: new vs old body differ")
    ck.reset_launch_counts()          # from here on: the main path's launches
    return rows


def conv2_edge_cases(seed: int) -> dict:
    """conv2's edges at the default widths (B 133, T 126, K 512, Co 80), as
    {name: (a1s, w2p, ...the rest of the wrapper's arguments)}:

    - ``int8_saturated``: a map all 127 under weights all +127 or -127, the
      share of +127 in channel co's columns rising with co, so the sums
      127 * sum(w2p[:, k*80 + co]) run from about -2.5e7 to +2.5e7; shifts
      of 17-18 and offsets of +-2^22 put the requantized values below 0,
      inside [0, 127] and above it;
    - ``bf16_large``: a seeded bf16 map and weights near 2^50, sums near
      2^100 (float32 holds them; bf16 rounds them);
    - ``f32_wide_range``: float32 out of a map whose channels span 2^-20 ..
      2^20 under weights of both signs (``probe.conv2_f32_wide_range``):
      the largest channels' terms cancel in many sums, the ReLU cuts about
      half of them."""
    from modulationdetectioncnn_torch.scripts.probe import conv2_f32_wide_range

    r = np.random.default_rng(seed)
    b, t, k, co = 133, 126, 512, 80
    share = np.linspace(0.0, 1.0, co)
    plus = r.random((k, 3, co)) < share
    w2p = np.where(plus, 127, -127).astype(np.int8).reshape(k, 3 * co)
    m2 = r.integers(17, 19, co).astype(np.int32)
    o2 = r.integers(-(1 << 22), 1 << 22, co).astype(np.int32)
    a1f = r.standard_normal((b, t, k)).astype(np.float32) * 2.0 ** 50
    w2f = r.standard_normal((k, 3 * co)).astype(np.float32) * 2.0 ** 50 / np.sqrt(3 * k)
    bias = (0.1 * r.standard_normal(co)).astype(np.float32)

    def dev(a):
        return torch.from_numpy(a).cuda()

    return {"int8_saturated": (torch.full((b, t, k), 127, dtype=torch.int8, device="cuda"),
                               dev(w2p), dev(m2), dev(o2)),
            "bf16_large": (dev(a1f).to(torch.bfloat16), dev(w2f).to(torch.bfloat16), dev(bias)),
            "f32_wide_range": tuple(map(dev, conv2_f32_wide_range(b, seed + 1)))}


def phase_probe_kernels(dev_info: dict, demo: torch.Tensor) -> list[dict]:
    """The two probe kernels (``ops/probe_kernels.py``) against their plain
    versions, bit for bit: the copy on the probe's (4096, 16384) int8, the
    bench's frames, 1,000,003 and 37 bytes and an empty tensor; the
    prologue on the bench's 4096 frames (with the artifact's and with the
    bench's input scale), the demo's 1024, B=1, 37 frames, T=40, and on
    exact halves and out-of-range values (scale 2: exact products, ties
    and clipping). Then times at the probe's sizes. Returns the rows of the
    kernels line."""
    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.ops import probe_kernels as pk
    from modulationdetectioncnn_torch.ops.infer import tap_planes
    from modulationdetectioncnn_torch.quant import load_int8
    from modulationdetectioncnn_torch.scripts import probe
    from modulationdetectioncnn_torch.utils.profiler import device_ms_per_call

    pk.reset_launch_counts()
    qw = load_int8(device="cuda")
    bench_qw, bench_x = bench.make_int8_weights(AmcConfig(), BATCH)
    r = np.random.default_rng(SEED + 5)
    h16k = torch.from_numpy(r.integers(-128, 128, (BATCH, 16384)).astype(np.int8)).cuda()
    ties = torch.from_numpy(((np.arange(2 * 2 * 128) - 256) / 2.0).astype(np.float32)
                            .reshape(2, 2, 128) * np.float32(1.5)).cuda()
    stats = {k: {"mismatches": 0, "checked": 0} for k in PROBE_KERNELS}
    checks = []

    def record(kname, case, got, want):
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{kname} {case}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)}")
        bad = int((got != want).sum())
        stats[kname]["mismatches"] += bad
        stats[kname]["checked"] += 1
        checks.append({"kernel": kname, "case": case, "shape": list(got.shape),
                       "dtype": str(got.dtype), "mismatches": bad})

    for case, t in (("probe_b4096_16384_int8", h16k), ("bench_frames", bench_x),
                    ("bytes_1000003", h16k.reshape(-1)[:1_000_003]),
                    ("bytes_37", h16k.reshape(-1)[:37]), ("empty", h16k[:0])):
        record("copy_bytes", case, pk.copy_bytes(t), t.clone())
    frames = {f"bench_frames_b{BATCH}": bench_x, "stream_frames": demo,
              "bench_b1": bench_x[:1], "bench_b37_at3": bench_x[3:40],
              "t40_b5": torch.from_numpy(r.standard_normal((5, 2, 40)).astype(np.float32)).cuda()}
    for case, x in frames.items():
        for sname, inv in (("artifact", qw.inv_sx), ("bench_ptq", bench_qw.inv_sx)):
            record("quantize_tap_planes", f"{sname}/{case}", pk.quantize_tap_planes(x, inv),
                   tap_planes(x, inv))
    record("quantize_tap_planes", "ties_and_clipping_scale2",
           pk.quantize_tap_planes(ties, 2.0), tap_planes(ties, 2.0))
    check_launches = pk.launch_counts()
    for c in checks:
        emit({"phase": "probe_kernels.check", **c})
    for kname, st in stats.items():
        require(st["mismatches"] == 0, f"{kname}: {st['mismatches']} elements differ "
                "from the plain version")

    bw = dev_info["bytes_per_s"]
    out16k = torch.empty_like(h16k)
    plans = (  # name, kernel, plain, library (call, what) or None, bytes
        ("copy_bytes", lambda: pk.copy_bytes(h16k), lambda: h16k.clone(),
         (lambda: out16k.copy_(h16k), "Tensor.copy_ into a preallocated tensor"),
         2 * h16k.numel()),
        ("quantize_tap_planes", lambda: pk.quantize_tap_planes(bench_x, qw.inv_sx),
         lambda: tap_planes(bench_x, qw.inv_sx), None,
         bench_x.numel() * 4 + BATCH * 8 * 128),
    )
    rows = []
    for kname, kernel, plain, lib, nb in plans:
        rows.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                     "replaces": TPU_KERNELS[kname], "launches": None,
                     "check_launches": check_launches[kname], "max_abs_err": 0.0,
                     "mismatches": stats[kname]["mismatches"],
                     "ms": time_ms(kernel, iters=20),
                     "device_ms": device_ms(kernel, KERNEL_SYMBOLS[kname]),
                     "plain_ms": time_ms(plain, iters=20),
                     "bound_ms": nb / bw * 1e3, "bound_by": "bytes",
                     "library_ms": time_ms(lib[0], iters=20) if lib else None,
                     # the library call's device time, on the kernel's clock
                     "library_device_ms": device_ms_per_call(lib[0]) if lib else None,
                     "library_call": lib[1] if lib else None, "bytes": nb})
        if lib:
            # The kernel and the library call in turns on that clock:
            # kernel, library, library, kernel, three rounds.
            rows[-1]["device_ms_turns"] = [
                [device_ms(kernel, KERNEL_SYMBOLS[kname]), device_ms_per_call(lib[0]),
                 device_ms_per_call(lib[0]), device_ms(kernel, KERNEL_SYMBOLS[kname])]
                for _ in range(3)]
    emit({"phase": "probe_kernels", "timed": rows, "check_launches": check_launches})
    # Row 23 against an earlier body, where a copy of it was put at
    # probe.OLD_PROBE_SRC: old, new, new, old in this run.
    old_lib = probe.old_library(probe.OLD_PROBE_SRC, probe.PROBE_ENTRIES)
    if old_lib is None:
        emit({"phase": "probe_kernels.old_vs_new",
              "skipped": f"no earlier body at {os.path.relpath(probe.OLD_PROBE_SRC, REPO)}"})
    else:
        for rec in probe.copy_old_vs_new(old_lib):
            emit({"phase": "probe_kernels.old_vs_new", **rec})
            require(rec["ok"], f"{rec['name']} B={rec['batch']}: a copy differs from its input")
    pk.reset_launch_counts()          # from here on: the main path's launches
    return rows


def _demo_labels_sharded(tm, predict) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """(sharded labels, whole-stream labels, the sharded run's launch
    counts: zeroed just before it, read just after) of the stream demo's
    signal."""
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.dsp import framer, pipeline
    from modulationdetectioncnn_torch.parallel import halo

    cfg = AmcConfig()
    wide, _ = pipeline.make_demo_signal(cfg)
    x = framer.to_planes(wide, "cuda")
    reset_counts()
    got = halo.classify_stream_sharded(x, predict, cfg.stream, tm)
    torch.cuda.synchronize()
    counts = launch_counts()
    return got, pipeline.classify_stream(x, predict, cfg.stream), counts


def _labels_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """tests/test_halo.py's check: equal up to the sharded path's last frame."""
    f = got.shape[1]
    return got.shape[0] == want.shape[0] and f >= want.shape[1] - 1 \
        and torch.equal(got, want[:, :f])


def phase_parallel() -> dict[str, int]:
    """``parallel/`` at world size 1 on NCCL: ``classify_stream_sharded``
    with the v7 classifier on the stream demo's signal equals
    ``classify_stream`` (counters zeroed just before it: rows 1 and 2
    launched); ``dryrun_multichip(1)`` (one training step on a 1x1 mesh,
    then ``halo.dryrun``'s float and int8 streams, which it holds to the
    single-rank labels); ``train`` for two steps on a 1x1x1 mesh. Returns
    the sharded stream's launch counts."""
    import torch.distributed as dist

    from modulationdetectioncnn_torch.config import AmcConfig, MeshConfig, apply_overrides
    from modulationdetectioncnn_torch.data import synthetic
    from modulationdetectioncnn_torch.ops.infer import make_int8_predict
    from modulationdetectioncnn_torch.parallel import dryrun, halo
    from modulationdetectioncnn_torch.parallel import mesh as pmesh
    from modulationdetectioncnn_torch.quant import load_int8
    from modulationdetectioncnn_torch.train import loop

    pmesh.ensure_process_group("cuda")
    try:
        backend, world = dist.get_backend(), dist.get_world_size()
        require(backend == "nccl" and world == 1, f"parallel: {backend}, world {world}")
        predict = make_int8_predict(load_int8(device="cuda"), "v7")
        tm = halo.time_mesh(1, "cuda")
        t0 = time.perf_counter()
        got, want, counts = _demo_labels_sharded(tm, predict)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss = dryrun.dryrun_multichip(1, "cuda")
        dryrun_s = time.perf_counter() - t0
        cfg = apply_overrides(AmcConfig(), [*CANARY, "train.num_steps=2", "train.warmup_steps=1",
                                            "train.eval_every=1"])
        x, y, _ = synthetic.make_dataset(cfg.data)
        _, history = loop.train(cfg, (x, y), mesh=pmesh.make_mesh(MeshConfig(), "cuda"))
        emit({"phase": "parallel", "backend": backend, "world": world,
              "sharded_shape": list(got.shape), "single_shape": list(want.shape),
              "sharded_equals_single": _labels_equal(got, want),
              "wall_s_sharded_and_single": wall,
              "launches": counts, "dryrun_multichip_loss": loss, "dryrun_s": dryrun_s,
              "train_records": history})
        require(_labels_equal(got, want), "parallel: sharded labels != single-process labels")
        require(counts["conv_stage_int8_v7"] > 0 and counts["dense_argmax_int8"] > 0,
                f"parallel: rows 1-2 not launched: {counts}")
        require([h["step"] for h in history] == [1, 2]
                and all(np.isfinite(h["loss"]) for h in history), f"parallel train: {history}")
    finally:
        dist.destroy_process_group()
    return counts


GLOO_RANKS = 2
GLOO_TIME_LIMIT_S = 300


def gloo_rank(rank: int, world: int, store: str, out_dir: str) -> int:
    """One rank of phase parallel_gloo (a process of its own, on card 0,
    gloo from a file store): the exchanged halo, the sharded v7 labels of
    the stream demo against the single-process labels with the launch
    counts, and the (data=1, model=2) forward against the unsharded one
    with TF32 off. Writes ``out_dir/gloo_rank<rank>.json``."""
    from datetime import timedelta

    import torch.distributed as dist

    from modulationdetectioncnn_torch.config import MeshConfig
    from modulationdetectioncnn_torch.models.vtcnn2 import VTCNN2
    from modulationdetectioncnn_torch.ops.infer import make_int8_predict
    from modulationdetectioncnn_torch.parallel import halo
    from modulationdetectioncnn_torch.parallel import mesh as pmesh
    from modulationdetectioncnn_torch.quant import load_int8

    torch.cuda.set_device(0)
    # The comparison of two float forwards must not run cuDNN's convolutions
    # in TF32 (its default); matmuls are full float32 by default, stated.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        tm = halo.time_mesh(world, "cuda")
        t_local, h = 16, 3
        x = torch.arange(world * t_local, dtype=torch.float32, device="cuda")
        got = halo.left_halo_exchange(x[rank * t_local:(rank + 1) * t_local], h,
                                      tm.get_group("time")).cpu()
        want = torch.cat([torch.zeros(h) if rank == 0 else
                          torch.arange(rank * t_local - h, rank * t_local, dtype=torch.float32),
                          torch.arange(rank * t_local, (rank + 1) * t_local,
                                       dtype=torch.float32)])
        predict = make_int8_predict(load_int8(device="cuda"), "v7")
        labels, single, counts = _demo_labels_sharded(tm, predict)
        mesh = pmesh.make_mesh(MeshConfig(data=1, model=2), "cuda")
        model = VTCNN2(dtype="float32", generator=torch.Generator().manual_seed(SEED)).cuda()
        xf = torch.from_numpy(np.random.default_rng(SEED).standard_normal((256, 2, 128))
                              .astype(np.float32)).cuda()
        with torch.no_grad():
            ref = model.eval()(xf)
            tp = pmesh.shard_params(model, mesh).eval()(xf)
        res = {"rank": rank, "backend": dist.get_backend(), "device": str(xf.device),
               "halo_equal": bool(torch.equal(got, want)),
               "sharded_equals_single": _labels_equal(labels, single),
               "labels_shape": list(labels.shape), "launches": counts,
               "tp_max_abs_diff": float((tp - ref).abs().max()),
               "tp_within_1e-5": bool(((tp - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all()),
               "max_abs_logit": float(ref.abs().max())}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"gloo_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def probe_rank(backend: str, rank: int, store: str, out_dir: str) -> int:
    """One of two processes on card 0 that test the premises of the gloo
    staging (reported, not checked): on ``gloo``, a point-to-point send of
    a tensor on the card; on ``nccl``, an all-reduce of two ranks sharing
    the card. Writes ``out_dir/probe_<backend><rank>.json`` with what
    happened."""
    from datetime import timedelta

    import torch.distributed as dist

    torch.cuda.set_device(0)
    res = {"backend": backend, "rank": rank}
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=2, timeout=timedelta(seconds=30))
        t = torch.full((4,), float(rank + 1), device="cuda")
        if backend == "gloo":
            work = dist.isend(t, 1) if rank == 0 else dist.irecv(t, 0)
            work.wait(timeout=timedelta(seconds=10))
        else:
            dist.all_reduce(t)
        torch.cuda.synchronize()
        res["outcome"] = "completed"
        res["values"] = t.tolist()
    except Exception as e:  # noqa: BLE001 -- the probe reports whatever it raises
        res["outcome"] = f"{type(e).__name__}: {str(e)[:300]}"
    with open(os.path.join(out_dir, f"probe_{backend}{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _run_ranks(argvs: list[list[str]], tmp: str, tag: str, limit_s: float
               ) -> list[int | None]:
    """One ``chip_smoke.py`` process per argument list, joined within
    ``limit_s``; what is left then is killed. Returns the exit codes (None
    for a process that had to be killed); logs in ``tmp/<tag><i>.log``."""
    logs = [open(os.path.join(tmp, f"{tag}{i}.log"), "w") for i in range(len(argvs))]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv], cwd=REPO,
                              stdin=subprocess.DEVNULL, stdout=log, stderr=subprocess.STDOUT)
             for argv, log in zip(argvs, logs)]
    codes = []
    try:
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(1.0, limit_s - (time.perf_counter() - t0))))
            except subprocess.TimeoutExpired:
                codes.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return codes


def phase_parallel_gloo(tmp: str) -> None:
    """Two processes sharing the one card in a gloo group (``gloo_rank``),
    joined within GLOO_TIME_LIMIT_S: in each, the halo equals the left
    neighbour's tail, the sharded labels equal the single-process labels,
    rows 1 and 2 were launched, and the (data=1, model=2) forward is within
    1e-5 of the unsharded one. Then the premises of the staging through
    host memory, reported: two more pairs (``probe_rank``) try gloo's
    point-to-point on a tensor on the card and NCCL with two ranks on it."""
    store = os.path.join(tmp, "gloo_store")
    t0 = time.perf_counter()
    codes = _run_ranks([["--gloo-rank", str(r), str(GLOO_RANKS), store, tmp]
                        for r in range(GLOO_RANKS)], tmp, "gloo_rank", GLOO_TIME_LIMIT_S)
    wall = time.perf_counter() - t0
    results = []
    for r, code in enumerate(codes):
        with open(os.path.join(tmp, f"gloo_rank{r}.log")) as f:
            log_tail = f.read()[-3000:]
        require(code == 0, f"parallel_gloo rank {r} exited {code} (None: killed after "
                f"{GLOO_TIME_LIMIT_S} s): {log_tail}")
        with open(os.path.join(tmp, f"gloo_rank{r}.json")) as f:
            results.append(json.load(f))
    premises = {}
    for backend in ("gloo", "nccl"):
        codes = _run_ranks([["--probe-rank", backend, str(r), os.path.join(tmp, f"{backend}_probe"),
                             tmp] for r in range(2)], tmp, f"probe_{backend}", 90)
        premises[backend] = []
        for r, code in enumerate(codes):
            path = os.path.join(tmp, f"probe_{backend}{r}.json")
            if os.path.isfile(path):
                with open(path) as f:
                    premises[backend].append(json.load(f))
            else:
                premises[backend].append({"rank": r, "exit": code})
    emit({"phase": "parallel_gloo", "ranks": results, "wall_s": wall,
          "premises_two_ranks_one_card": premises})
    for res in results:
        require(res["backend"] == "gloo" and res["device"].startswith("cuda"),
                f"parallel_gloo: {res}")
        require(res["halo_equal"] and res["sharded_equals_single"] and res["tp_within_1e-5"],
                f"parallel_gloo rank {res['rank']}: {res}")
        require(res["launches"]["conv_stage_int8_v7"] > 0
                and res["launches"]["dense_argmax_int8"] > 0,
                f"parallel_gloo rank {res['rank']}: rows 1-2 not launched {res['launches']}")


def phase_stream(name: str, overrides: list[str], path: tuple[str, ...],
                 check_tops: bool = True) -> dict[str, int]:
    """The stream demo on cuda with ``overrides`` (the committed artifact);
    returns the launch counts of that run. With ``check_tops`` the occupied
    subbands must read the demo's modulations and equal the CPU's labels
    exactly; a resampled stream moves the carriers, so there they are
    reported only."""
    from collections import Counter

    from modulationdetectioncnn_torch.config import AmcConfig, RML_CLASSES, apply_overrides
    from modulationdetectioncnn_torch.dsp import framer, pipeline

    cfg = apply_overrides(AmcConfig(), overrides)          # device=cuda
    reset_counts()
    t0 = time.perf_counter()
    labels = pipeline.run_stream_demo(cfg)
    wall = time.perf_counter() - t0
    launches = launch_counts()

    wide, occupied = pipeline.make_demo_signal(cfg)
    predict = pipeline._make_predictor(cfg)
    batch = pipeline.classify_stream(framer.to_planes(wide, "cuda"), predict,
                                     cfg.stream).cpu().numpy()
    cpu_cfg = apply_overrides(cfg, ["device=cpu"])
    cpu = pipeline.classify_stream_blocked(
        framer.to_planes(wide, "cpu"), pipeline._make_predictor(cpu_cfg),
        cpu_cfg.stream).numpy()
    tops = {k: RML_CLASSES[Counter(labels[k].tolist()).most_common(1)[0][0]]
            for k in occupied}
    occ = sorted(occupied)
    agree_cpu = float((cpu == labels).mean())
    emit({"phase": "stream", "run": name, "overrides": overrides,
          "frames": int(labels.size), "shape": list(labels.shape), "wall_s": wall,
          "tops": tops, "launches": launches,
          "streamed_equals_batch": bool(np.array_equal(labels, batch[:, :labels.shape[1]])),
          "agreement_with_cpu_plain": agree_cpu,
          "occupied_equal_cpu_plain": bool(np.array_equal(labels[occ], cpu[occ]))})
    require(labels.shape[1] == batch.shape[1]
            and np.array_equal(labels, batch), f"stream {name}: streamed labels "
            "!= whole-stream labels")
    require(all(launches[k] > 0 for k in path),
            f"stream {name}: kernel not launched: {launches}")
    # CPU and GPU DSP floats differ in the last bits (matmul order), which
    # can flip CFO's argmax on noise-only frames: >= 99 % overall, exact on
    # the occupied subbands of the unresampled demo.
    require(agree_cpu >= 0.99, f"stream {name}: agreement with CPU plain path {agree_cpu}")
    if check_tops:
        require(tops == occupied, f"stream {name}: occupied subbands read {tops}, "
                f"want {occupied}")
        require(np.array_equal(labels[occ], cpu[occ]),
                f"stream {name}: occupied subbands differ from CPU")
    return launches


def run_bench(name: str, argv: list[str], path: tuple[str, ...]) -> tuple[dict, list, dict]:
    """One run of the port's bench (``bench.main(argv)``) with the counters
    zeroed just before it. Prints its stdout and stderr lines, each on a
    line of its own, and requires every kernel of ``path`` launched.
    Returns the contract line, the stderr JSON lines and the counts."""
    from modulationdetectioncnn_torch import bench

    out, err = io.StringIO(), io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(argv)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    out_lines = out.getvalue().strip().splitlines()
    err_lines = err.getvalue().strip().splitlines()
    for line in out_lines + err_lines:
        print(line, flush=True)
    emit({"phase": "bench", "run": name, "argv": argv, "rc": rc, "wall_s": wall,
          "launches": launches})
    require(rc == 0 and out_lines, f"bench {name}: rc {rc}, no stdout")
    result = json.loads(out_lines[-1])
    extra = [json.loads(ln) for ln in err_lines if ln.startswith("{")]
    require(set(result) == CONTRACT_KEYS, f"bench {name}: keys {sorted(result)}")
    require(result["fallback"] is False and result["value"] > 0,
            f"bench {name}: {result}")
    require(not any("stream_extra_error" in e for e in extra),
            f"bench {name}: stream_extra failed: {err.getvalue()[-2000:]}")
    require(all(launches[k] > 0 for k in path),
            f"bench {name}: kernel not launched: {launches}")
    return result, extra, launches


def phase_bench() -> dict[str, int]:
    """The bench path: cnn mode at the defaults, stream mode with timing
    correction off (the default) and on, and v9, v3 and v2 (``pallas_int8``)
    named explicitly, then the bf16 v4 classifier and the bf16 v2 forward
    (``pallas_bf16``). Returns the launch counts of v10, v9 and the four bf16
    kernels on it."""
    from modulationdetectioncnn_torch.config import BenchConfig

    cands = BenchConfig().calibration_candidates
    res, extra, cnn = run_bench(
        "cnn", [], ("conv_stage_int8_v7", "conv_stage_int8_v10", "dense_argmax_int8"))
    cal = [e for e in extra if "kernel_calibration" in e]
    require(res["metric"] == "classified_iq_samples_per_sec_per_chip"
            and res["backend"] in cands, f"bench cnn: {res}")
    require(len(cal) == 1 and set(cal[0]["kernel_calibration"]) == set(cands)
            and cal[0]["winner"] == res["backend"], f"bench cnn calibration: {cal}")
    require(any(e.get("mode") == "stream_extra" and e.get("value", 0) > 0
                for e in extra), "bench cnn: no stream_extra line")
    res, _, _ = run_bench("stream", ["stream"],
                          ("conv_stage_int8_v7", "dense_argmax_int8"))
    require(res["metric"] == "streamed_iq_samples_per_sec_per_chip",
            f"bench stream: {res}")
    res, _, tb = run_bench("stream_timing", ["stream", "stream.normalize_timing=true"],
                           ("conv_stage_int8_v7", "dense_argmax_int8", "correct_timing_fir",
                            "correct_timing_fir/window"))
    require(tb["correct_timing_fir/general"] == 0,
            f"bench stream timing took the timing FIR's general route: {tb}")
    require(res["metric"] == "streamed_iq_samples_per_sec_per_chip",
            f"bench stream timing: {res}")
    res, _, v9 = run_bench("v9", ["pallas_int8_v9", "bench.stream_extra=false"],
                           ("conv_stage_int8_v9", "dense_argmax_int8"))
    require(res["backend"] == "pallas_int8_v9", f"bench v9: {res}")
    for backend, path in (("pallas_int8_v3", ("conv_stage_int8_v3", "dense_argmax_int8")),
                          ("pallas_int8", ("conv_stage_int8_v2", "dense_int8"))):
        res, _, _ = run_bench(backend, [backend, "bench.stream_extra=false"], path)
        require(res["backend"] == backend, f"bench {backend}: {res}")
    # The bf16 v4 classifier, selectable by name only (as in the JAX bench).
    bf16 = ("conv_stage_bf16_v4", "dense_argmax_bf16")
    res, _, v4 = run_bench("pallas_bf16_v4", ["pallas_bf16_v4", "bench.stream_extra=false"], bf16)
    require(res["backend"] == "pallas_bf16_v4"
            and sum(v4.values()) == sum(v4[k] for k in bf16), f"bench bf16 v4: {res} {v4}")
    # The bf16 v2 forward (the JAX list's pallas_bf16): the tap-row prologue
    # in torch, then the v2 conv stage and the logits dense stage, each
    # launched once per iteration of the chained timing (a warm-up run of
    # n2, then 5 pairs of n1 and n2) and nothing else.
    bc = BenchConfig()
    n1, n2 = bc.warmup_iters, bc.warmup_iters + bc.timed_iters
    iters = n2 + 5 * (n1 + n2)
    v2_path = ("conv_stage_bf16_v2", "dense_logits_bf16")
    res, _, v2 = run_bench("pallas_bf16", ["bench.backend=pallas_bf16",
                                           "bench.stream_extra=false"], v2_path)
    require(res["backend"] == "pallas_bf16" and all(v2[k] == iters for k in v2_path)
            and sum(v2.values()) == 2 * iters, f"bench bf16: {res} {v2}, want {iters} each")
    return {"conv_stage_int8_v10": cnn["conv_stage_int8_v10"],
            "conv_stage_int8_v9": v9["conv_stage_int8_v9"],
            **{k: v4[k] for k in bf16}, **{k: v2[k] for k in v2_path}}


def phase_profile() -> None:
    """Where the time goes at B=4096: ``torch.profiler`` over 10 chained
    iterations of the v7 classifier (the default, and the calibration's
    winner) and the v10 one alone, and of the bench's stream
    chain (front end + the classifier) with each. Prints the device time by
    kernel (top 8) and the device's busy share of the profiled window. A
    measurement, not a check: a profiler that sees no device time is
    reported as such."""
    from torch.profiler import ProfilerActivity, profile

    from modulationdetectioncnn_torch import bench
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.dsp import pipeline
    from modulationdetectioncnn_torch.dsp.channelizer import design_prototype
    from modulationdetectioncnn_torch.utils.profiler import device_events

    cfg = AmcConfig()
    sc = cfg.stream
    h = design_prototype(sc.num_subbands, sc.taps_per_branch)
    wide = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (2, BATCH * sc.frame_len)).astype(np.float32)).cuda()

    def chained(fn):
        def step(xc):
            return xc + fn(xc).reshape(-1)[0].to(torch.float32) * 1e-38
        return step

    def stream_chain(classify):
        def labels(xc):
            fr = pipeline.subband_frames(xc, h, sc)
            return classify(fr.reshape(-1, 2, sc.frame_len))
        return labels

    windows = []
    for version in ("v7", "v10"):
        classify, (frames,) = bench.make_classifier(cfg, f"pallas_int8_{version}", BATCH)
        windows += [(f"classifier_{version}", chained(classify), frames),
                    (f"stream_chain_{version}", chained(stream_chain(classify)), wide)]
    for name, step, x in windows:
        with torch.no_grad():
            for _ in range(3):
                x = step(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(10):
                    x = step(x)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        ev = device_events(prof)
        busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
        emit({"phase": "profile", "window": name, "iterations": 10,
              "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "device_busy_share": busy_ms / wall_ms if ev else "not visible",
              # The sum over every entry, operators included: it counts an
              # operator's kernels twice (reported beside, not used).
              "all_entries_ms": sum(e.self_device_time_total
                                    for e in prof.key_averages()) / 1e3,
              "top_device_ms": {e.key[:80]: e.self_device_time_total / 1e3
                                for e in top}})


def phase_eval(tmp: str) -> dict[str, int]:
    """``eval`` on the card, through ``cli.cmd_eval`` (what ``python -m
    modulationdetectioncnn_torch eval`` runs on the parsed overrides): the
    int8 backend with each of v5, v6, v4, v7 and v10 on a small dataset (16
    frames per class at all 20 SNRs), counters zeroed just before each run
    and read just after; the labels that run returns must be identical
    across versions and equal to the plain chain's. Then the flax and golden
    backends on the exported float checkpoint, with their label agreement.
    Returns the launch counts of the v5/v6/v4/v3/v2 runs (v2's dense stage
    is the logits kernel)."""
    from modulationdetectioncnn_torch import cli
    from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.quant import load_int8

    def run_eval(overrides: list[str]) -> tuple[dict, np.ndarray, dict, float]:
        cfg = apply_overrides(AmcConfig(), overrides)
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result, labels = cli.cmd_eval(cfg)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        with open(cfg.eval.results_path) as f:
            require(json.load(f) == result, f"eval {overrides}: results file differs")
        require(json.loads(out.getvalue().strip().splitlines()[-1]) == result["headline"],
                f"eval {overrides}: printed headline differs")
        return result, labels, counts, wall

    base = [*EVAL_DATA, f"eval.results_path={tmp}/eval.json"]
    x = cli._build_dataset(apply_overrides(AmcConfig(), base))[0]
    qw = load_int8(device="cuda")
    xt = torch.from_numpy(x).cuda()
    want = torch.cat([infer.dense_argmax_int8_plain(infer.conv_stage_int8_v7_plain(
        xt[i:i + 1024], qw), qw) for i in range(0, len(x), 1024)]).cpu().numpy()
    launches, results = {}, {}
    for v in EVAL_VERSIONS:
        results[v], labels, counts, wall = run_eval(
            ["eval.backend=int8", f"eval.int8_kernel={v}", *base])
        mism = int((labels != want).sum())
        emit({"phase": "eval", "backend": "int8", "int8_kernel": v, "frames": len(x),
              "wall_s": wall, "launches": counts, "headline": results[v]["headline"],
              "overall_accuracy": results[v]["overall_accuracy"],
              "label_mismatches_vs_plain": mism})
        kname = f"conv_stage_int8_{v}"
        dname = "dense_int8" if v in ("v1", "v2") else "dense_argmax_int8"
        require(len(labels) == len(x) and counts[kname] > 0 and counts[dname] > 0
                and sum(counts.values()) == counts[kname] + counts[dname],
                f"eval {v}: {len(labels)} labels, launches {counts}")
        require(mism == 0, f"eval {v}: {mism} labels differ from the plain chain")
        require(results[v] == results[EVAL_VERSIONS[0]], f"eval {v}: results differ from v5's")
        if v in EVAL_PATH:
            launches[kname] = counts[kname]
        if v == "v2":
            launches[dname] = counts[dname]

    # The float backends on a quarter of the frames, in one batch: the
    # golden forward is float64 NumPy on the host.
    base = [*base, "data.frames_per_class_per_snr=4", "eval.batch_size=1024"]
    float_labels = {}
    for backend in ("flax", "golden"):
        res, float_labels[backend], _, wall = run_eval(
            [f"eval.backend={backend}", f"train.checkpoint_dir={FLOAT_CKPT}", *base])
        emit({"phase": "eval", "backend": backend, "frames": len(float_labels[backend]),
              "wall_s": wall, "headline": res["headline"],
              "overall_accuracy": res["overall_accuracy"]})
    agree = float((float_labels["flax"] == float_labels["golden"]).mean())
    emit({"phase": "eval", "frames": len(float_labels["flax"]),
          "flax_vs_golden_label_agreement": agree})
    return launches


def phase_forwards() -> dict[str, int]:
    """The bf16 family on the eval phase's 3520 frames with the exported
    float checkpoint, against the torch float model's labels: the v4
    classifier, ``make_bf16_forward_v2`` and ``make_bf16_forward`` (argmax
    of their logits), each called once on all the frames with the counters
    zeroed just before and read just after: its two kernels launched once
    each and nothing else, agreement >= 0.85 (printed). Returns the counts
    of the ``make_bf16_forward`` run."""
    from modulationdetectioncnn_torch import cli
    from modulationdetectioncnn_torch.config import AmcConfig, ModelConfig, apply_overrides
    from modulationdetectioncnn_torch.ops import infer_bf16 as ib
    from modulationdetectioncnn_torch.utils.checkpoint import restore_model

    model = restore_model(FLOAT_CKPT, ModelConfig(), 128, "cuda")[0]
    x = torch.from_numpy(cli._build_dataset(apply_overrides(AmcConfig(), list(EVAL_DATA)))[0]).cuda()
    with torch.no_grad():
        want = torch.cat([model(x[i:i + 1024]).argmax(-1) for i in range(0, len(x), 1024)])
    sd = model.state_dict()
    fwd_v2, fwd = ib.make_bf16_forward_v2(sd, "cuda"), ib.make_bf16_forward(sd, "cuda")
    runs = {"bf16_v4_classifier": (ib.make_bf16_classifier_v4(sd, "cuda"),
                                   ("conv_stage_bf16_v4", "dense_argmax_bf16")),
            "make_bf16_forward_v2": (lambda xb: ib.argmax_lowest(fwd_v2(xb)),
                                     ("conv_stage_bf16_v2", "dense_logits_bf16")),
            "make_bf16_forward": (lambda xb: ib.argmax_lowest(fwd(xb)),
                                  ("conv_stage_bf16", "dense_logits_bf16"))}
    counts = {}
    for name, (classify, path) in runs.items():
        reset_counts()
        got = classify(x)
        torch.cuda.synchronize()
        counts[name] = launch_counts()
        agree = float((got == want).float().mean())
        emit({"phase": "forwards", "run": name, "weights": "float_checkpoint",
              "frames": len(x), "label_agreement_vs_float_model": agree,
              "launches": counts[name]})
        require(all(counts[name][k] == 1 for k in path)
                and sum(counts[name].values()) == len(path),
                f"forwards {name}: launches {counts[name]}")
        require(agree >= 0.85, f"forwards {name} vs the float model: agreement {agree}")
    return counts["make_bf16_forward"]


def phase_float_predictor() -> dict[str, int]:
    """The product's float route: ``_make_predictor`` on the benchmark's
    bf16 settings (the exported checkpoint, ``model.dtype=bfloat16``, no
    int8 artifact) takes route ``bf16_v4``; on 16,384 frames of the dataset
    across the SNR grid, two calls with the counters zeroed just before
    launch ``conv_stage_bf16_v4`` and ``dense_argmax_bf16`` twice each and
    nothing else, and give the same labels. Those agree with the bf16
    module's on >= 99.2 % of the frames (99.29 % measured on an H100),
    and with the float32 module's (TF32 off) on at least as many as the
    bf16 module's do: the route rounds no
    more than the module, whose own bf16 rounding parts it from float32 on
    near-ties (printed, with each route's widest gap of its label's float32
    logit below the best). Then the stream demo on the same checkpoint
    (``phase_stream``). Returns the counts of the two calls."""
    from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
    from modulationdetectioncnn_torch.data.synthetic import make_dataset
    from modulationdetectioncnn_torch.dsp import pipeline
    from modulationdetectioncnn_torch.utils.checkpoint import restore_model

    overrides = [f"train.checkpoint_dir={FLOAT_CKPT}", "model.dtype=bfloat16"]
    cfg = apply_overrides(AmcConfig(), overrides)
    predict, said = quiet(pipeline._make_predictor, cfg)
    require(predict.route == "bf16_v4", f"float_predictor: route {predict.route}")
    x = make_dataset(cfg.data, frames_per_class_per_snr=75)[0][:16384]
    x = torch.from_numpy(x).cuda()
    reset_counts()
    got = [predict(x) for _ in range(2)]
    torch.cuda.synchronize()
    counts = launch_counts()
    path = ("conv_stage_bf16_v4", "dense_argmax_bf16")
    with torch.no_grad():
        module = restore_model(FLOAT_CKPT, cfg.model, 128, "cuda")[0]
        want = module(x).argmax(-1).to(torch.int32)
        f32 = apply_overrides(cfg, ["model.dtype=float32"]).model
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            logits = restore_model(FLOAT_CKPT, f32, 128, "cuda")[0](x)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    exact = logits.argmax(-1).to(torch.int32)

    def gap(labels):
        served = logits.gather(1, labels.long()[:, None])[:, 0]
        return float((logits.max(-1).values - served).max())

    agree = float((got[0] == want).float().mean())
    route_f32, module_f32 = (float((lab == exact).float().mean()) for lab in (got[0], want))
    emit({"phase": "float_predictor", "route": predict.route, "overrides": overrides,
          "warning": said, "frames": len(x), "launches": counts,
          "label_agreement_vs_bf16_module": agree,
          "route_vs_float32_module": route_f32, "bf16_module_vs_float32_module": module_f32,
          "route_logit_gap_max": gap(got[0]), "bf16_module_logit_gap_max": gap(want)})
    require(torch.equal(got[0], got[1]), "float_predictor: two calls differ")
    require(all(counts[k] == 2 for k in path) and sum(counts.values()) == 2 * len(path),
            f"float_predictor: launches {counts}")
    require(agree >= 0.992, f"float_predictor vs the bf16 module: agreement {agree}")
    require(route_f32 >= module_f32, f"float_predictor vs the float32 module: {route_f32} "
            f"against the bf16 module's {module_f32}")
    phase_stream("float_bf16", overrides, path, check_tops=False)
    return counts


# The JAX package's scaling report's keys (eval/scaling.py); the port adds
# the devices of its measured rates and the physical links.
SCALING_KEYS = {"measured_1chip_samples_per_sec", "measured_inputs", "assumptions",
                "projected"}
SCALING_INPUTS = {"train_samples_per_sec", "train_batch", "train_step_time_s",
                  "param_count", "device", "train_rate_device"}
SCALING_ASSUMPTIONS = {"ici_bw_Bps", "dcn_bw_Bps", "ici_lat_s", "dcn_lat_s",
                       "block_samples_per_device", "halo_samples", "grad_bytes",
                       "block_samples_per_device_dcn_policy", "links"}
SCALING_PROJECTED = {f"stream_eff_{link}_block_{b}" for link in ("2chip_ici", "2host_dcn")
                     for b in (1 << 15, 1 << 20, 1 << 22)} | {
    "stream_eff_2host_dcn_at_default_policy", "train_dp_eff_8chip_ici",
    "train_dp_eff_2host_dcn", "_note"}


def phase_scaling() -> dict[str, int]:
    """``python -m modulationdetectioncnn_torch scaling`` on the card
    (``cli.main``): the bench's calibration over v7 and v10 for the
    measured rate, then the report. Requires the JAX report's keys, the
    composed halo of 112 samples, a measured rate under the card's name and
    the default policy's projected 2-host efficiency >= 0.85; rows 1, 3 and
    2 launched. Returns the launch counts."""
    from modulationdetectioncnn_torch import cli

    reset_counts()
    t0 = time.perf_counter()
    rc, lines = quiet(cli.main, ["scaling"])
    wall = time.perf_counter() - t0
    launches = launch_counts()
    report = json.loads("\n".join(lines))
    emit({"phase": "scaling", "rc": rc, "wall_s": wall, "report": report,
          "launches": launches})
    name = torch.cuda.get_device_name(0)
    require(rc == 0 and set(report) == SCALING_KEYS
            and set(report["measured_inputs"]) == SCALING_INPUTS
            and set(report["assumptions"]) == SCALING_ASSUMPTIONS
            and set(report["projected"]) == SCALING_PROJECTED,
            f"scaling: keys {sorted(report)}")
    require(report["assumptions"]["halo_samples"] == 112, "scaling: halo")
    require(report["measured_1chip_samples_per_sec"] > 0
            and report["measured_inputs"]["device"].startswith(name),
            f"scaling: rate {report['measured_1chip_samples_per_sec']} on "
            f"{report['measured_inputs']['device']}")
    require(report["projected"]["stream_eff_2host_dcn_at_default_policy"] >= 0.85,
            "scaling: default DCN policy below 0.85")
    require(all(launches[k] > 0 for k in
                ("conv_stage_int8_v7", "conv_stage_int8_v10", "dense_argmax_int8")),
            f"scaling: kernel not launched: {launches}")
    return launches


def phase_breakdown() -> dict[str, int]:
    """``scripts/bench_breakdown.py`` at B=4096 into
    ``chiprun_out/bench_breakdown.json``: v7 and v9 in full, the v9 conv
    stage (row 4) and the dense + argmax stage (row 2) on their own.
    Requires every stage's time > 0, shares of the v9 forward (of the
    card's busy time per call) that sum to 1 within 1 %, and rows 1, 4 and 2
    launched. Returns the launch counts."""
    from modulationdetectioncnn_torch.scripts import bench_breakdown

    out_path = os.path.join(REPO, "chiprun_out", "bench_breakdown.json")
    reset_counts()
    rc, _ = quiet(bench_breakdown.main, [out_path])
    launches = launch_counts()
    with open(out_path) as f:
        res = json.load(f)
    res.pop("samples_ms")
    emit({"phase": "breakdown", "rc": rc, "out": os.path.relpath(out_path, REPO),
          **res, "launches": launches})
    stages = res["stages"]
    require(rc == 0 and all(stages[k]["ms"] > 0 for k in
                            ("v7_full", "v9_full", "conv_stage_v9", "dense_argmax_stage")),
            f"breakdown: stage times {stages}")
    require(abs(sum(res["stage_shares_of_v9_full"].values()) - 1) <= 0.01,
            f"breakdown: shares {res['stage_shares_of_v9_full']}")
    require(all(launches[k] > 0 for k in
                ("conv_stage_int8_v7", "conv_stage_int8_v9", "dense_argmax_int8")),
            f"breakdown: kernel not launched: {launches}")
    return launches


def phase_quantize(tmp: str) -> None:
    """``quantize`` of the exported float checkpoint on the card, written
    to a temporary directory: its agreement_vs_float, and for each array
    how many elements differ from the committed artifact (reported, not
    checked: the activation percentiles come from a bf16 forward, and the
    artifact's ran on a TPU)."""
    from modulationdetectioncnn_torch import cli
    from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
    from modulationdetectioncnn_torch.quant import DEFAULT_ARTIFACT, QuantizedModel

    cfg = apply_overrides(AmcConfig(), [f"train.checkpoint_dir={FLOAT_CKPT}"])
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        out_dir, agree = cli.cmd_quantize(cfg, out_dir=os.path.join(tmp, "ckpt_int8"))
    wall = time.perf_counter() - t0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    got = QuantizedModel.from_npz(os.path.join(out_dir, "int8.npz")).tree()
    ref = QuantizedModel.from_npz(DEFAULT_ARTIFACT).tree()
    differ = {k: int(np.sum(np.asarray(got[k]) != np.asarray(v))) for k, v in ref.items()}
    emit({"phase": "quantize", "wall_s": wall, "printed": line,
          "agreement_vs_float": agree, "elements_differing_from_artifact": differ,
          "s_x": float(got["s_x"]), "artifact_s_x": float(ref["s_x"])})
    require(set(line) == {"int8_artifact", "agreement_vs_float"}, f"quantize printed {line}")


def phase_resnet_chain(dev_info: dict) -> tuple[dict, int]:
    """Row 25: the fused residual chain against its plain version on the
    card, the predictor's route ``resnet_chain_bf16`` and its launches,
    then times (phase 7c of the docstring). Returns (the row of the kernels
    line, the route's launches of the chain)."""
    from torch.profiler import ProfilerActivity, profile

    from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
    from modulationdetectioncnn_torch.dsp import pipeline
    from modulationdetectioncnn_torch.models.resnet_rml18 import ResNetRML18, macs_per_frame
    from modulationdetectioncnn_torch.ops import residual_chain_bf16 as rc
    from modulationdetectioncnn_torch.utils import profiler
    from modulationdetectioncnn_torch.utils.checkpoint import restore_model

    kname = "residual_chain_bf16"
    overrides = ["model.arch=resnet_rml18", "model.num_classes=24", "data.frame_len=1024",
                 "stream.frame_len=1024", "stream.frame_hop=1024",
                 f"train.checkpoint_dir={RESNET_CKPT}", "model.dtype=bfloat16"]
    cfg = apply_overrides(AmcConfig(), overrides)
    module = restore_model(RESNET_CKPT, cfg.model, rc.FRAME_LEN, "cuda")[0]
    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    x = torch.randn((max(RESNET_BATCHES), 2, rc.FRAME_LEN), generator=g, device="cuda")
    states = {"seeded": ResNetRML18(generator=torch.Generator().manual_seed(SEED)).state_dict(),
              "checkpoint": module.state_dict()}
    inputs = {f"b{b}": x[:b] for b in RESNET_BATCHES}
    inputs["b37_at3"] = x[3:40]
    rc.residual_chain_bf16.launches = 0
    worst, unequal, outside = 0.0, 0, 0
    for wname, state in states.items():
        cw, hw = rc.make_chain_weights(state, "cuda"), rc.make_head_weights(state, "cuda")
        for xname, xb in inputs.items():
            got, want = rc.residual_chain_bf16(xb, cw), rc.residual_chain_bf16_plain(xb, cw)
            torch.cuda.synchronize()
            require(got.shape == want.shape and got.dtype == want.dtype,
                    f"{kname} {wname}/{xname}: {tuple(got.shape)} {got.dtype} vs "
                    f"{tuple(want.shape)} {want.dtype}")
            diff = (got.float() - want.float()).abs()
            scale = float(want.float().abs().max())
            err = float(diff.max()) / scale
            labels_equal = int((rc.head_labels(got, hw) == rc.head_labels(want, hw)).sum())
            emit({"phase": "resnet_chain.check", "weights": wname, "input": xname,
                  "frames": len(xb), "max_abs_diff": float(diff.max()), "map_absmax": scale,
                  "unequal": int((diff > 0).sum()), "elements": diff.numel(),
                  "labels_equal": labels_equal})
            require(err <= rc.MAP_TOL, f"{kname} {wname}/{xname}: map differs by {err} of its "
                    f"largest magnitude (tolerance {rc.MAP_TOL})")
            worst, unequal = max(worst, float(diff.max())), unequal + int((diff > 0).sum())
            outside += int((diff > rc.MAP_TOL * scale).sum())
    check_launches = rc.residual_chain_bf16.launches
    require(check_launches == len(states) * len(inputs),
            f"{kname}: {check_launches} launches for {len(states) * len(inputs)} checks")

    # The product's route on the benchmark's settings: one launch of the
    # chain a call, counted at the launch site and in the program's counter.
    predict, said = quiet(pipeline._make_predictor, cfg)
    require(predict.route == "resnet_chain_bf16", f"resnet_chain: route {predict.route}")
    xb = x[:BATCH]
    predict(xb)
    torch.cuda.synchronize()
    reset_counts()
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = [predict(xb) for _ in range(2)]
        torch.cuda.synchronize()
    counts, counters = launch_counts(), profiler.counters()
    cw, hw = rc.make_chain_weights(states["checkpoint"], "cuda"), rc.make_head_weights(
        states["checkpoint"], "cuda")
    direct = rc.head_labels(rc.residual_chain_bf16(xb, cw), hw)
    plain = rc.head_labels(rc.residual_chain_bf16_plain(xb, cw), hw)
    with torch.no_grad():
        bf16_module = module(xb).argmax(-1).to(torch.int32)
        f32 = restore_model(RESNET_CKPT, apply_overrides(cfg, ["model.dtype=float32"]).model,
                            rc.FRAME_LEN, "cuda")[0]
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            logits = f32(xb)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32

    def gap(labels):
        served = logits.gather(1, labels.long()[:, None])[:, 0]
        return float((logits.max(-1).values - served).max())

    exact = logits.argmax(-1).to(torch.int32)
    emit({"phase": "resnet_chain", "route": predict.route, "overrides": overrides,
          "warning": said, "frames": len(xb), "launches": counts,
          "counters": counters,
          "labels_equal_plain_chain": int((got[0] == plain).sum()),
          "labels_equal_bf16_module": int((got[0] == bf16_module).sum()),
          "route_vs_float32_module": float((got[0] == exact).float().mean()),
          "bf16_module_vs_float32_module": float((bf16_module == exact).float().mean()),
          "route_logit_gap_max": gap(got[0]), "bf16_module_logit_gap_max": gap(bf16_module)})
    require(counts[kname] == 2 and sum(counts.values()) == 2,
            f"resnet_chain: launches {counts}, one chain a call expected")
    require(counters.get("amc.classifier.launches") == 2,
            f"resnet_chain: counters {counters}, amc.classifier.launches 2 expected")
    require(torch.equal(got[0], got[1]), "resnet_chain: two calls differ")
    require(torch.equal(got[0], direct), "resnet_chain: the route's labels differ from the "
            "chain's and the head's called directly")

    part, _, bw, _, bf16_peak = peaks_for(dev_info["name"])
    ops = 2 * macs_per_frame()["stacks"] * BATCH
    nb = xb.numel() * 4 + BATCH * rc.MAP_LEN * rc.FILTERS * 2 + cw.blob.numel()
    t_ops, t_bytes = ops / bf16_peak * 1e3, nb / bw * 1e3
    with torch.no_grad():
        cudnn = lambda: module.features(xb)  # noqa: E731
        row = {"name": kname, "route": "cuda", "source": SOURCES[kname],
               "replaces": None, "launches": None, "check_launches": check_launches,
               "max_abs_err": worst, "mismatches": outside, "unequal": unequal,
               "map_tol_of_max": rc.MAP_TOL,
               "ms": time_ms(lambda: rc.residual_chain_bf16(xb, cw), iters=20),
               "device_ms": device_ms(lambda: rc.residual_chain_bf16(xb, cw),
                                      KERNEL_SYMBOLS[kname]),
               "plain_ms": time_ms(lambda: rc.residual_chain_bf16_plain(xb, cw), iters=2,
                                   warmup=1, reps=3),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": time_ms(cudnn, iters=5),
               "library_call": "the bf16 module's six stacks, F.conv1d (cuDNN) and max_pool1d",
               "batch": BATCH, "bf16_ops": ops, "bytes": nb,
               **ptxas_usage(dev_info["ptxas_log"], KERNEL_SYMBOLS[kname])}
    require(row["device_ms"] is not None, f"{kname}: the profiler shows no "
            f"{KERNEL_SYMBOLS[kname]}")
    emit({"phase": "resnet_chain.time", **row})
    return row, counts[kname]


def quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its stdout captured; returns (result, the
    stdout lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue().strip().splitlines()


def phase_train(tmp: str) -> str:
    """``train`` on the card (``cli.cmd_train``) at full width (conv1 256,
    conv2 80, dense 256, 11 classes, bf16 compute, float32 parameters) and
    the default ``train.batch_size=1024``, for TRAIN_STEPS steps on the
    configured dataset cut to 400 frames per class at the 10 SNRs from 0 to
    18 dB (44,000 frames, resident on the card), checkpointing every 100
    steps. Reports the records (samples/s over each window). The cut keeps
    the SNRs at which a few hundred steps learn: over all 20 SNRs Dense1's
    units die in the first hundred steps in both packages
    (scripts/train_liveness.py; the JAX package's own 11-class log,
    artifacts_train.log, reads loss 2.23 at step 500), and PTQ cannot scale
    a dead layer. Requires finite
    losses that fall, the parameters moved from step 100 to 300, and the 3
    checkpoints kept. Returns the checkpoint directory."""
    from modulationdetectioncnn_torch import cli
    from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides

    ck = os.path.join(tmp, "ck_train")
    overrides = [*TRAIN_DATA, f"train.num_steps={TRAIN_STEPS}", "train.eval_every=100",
                 "train.checkpoint_every=100"]
    cfg = apply_overrides(AmcConfig(), [*overrides, f"train.checkpoint_dir={ck}"])
    t0 = time.perf_counter()
    (_, history, held_out, _), lines = quiet(cli.cmd_train, cfg)
    wall = time.perf_counter() - t0
    saved = sorted(os.listdir(ck), key=lambda d: int(d) if d.isdigit() else -1)
    emit({"phase": "train", "overrides": overrides, "frames_held_out": len(held_out[0]),
          "records": history, "wall_s": wall, "saved_steps": saved,
          "samples_per_sec_last_window": history[-1]["samples_per_sec"],
          "printed": json.loads(lines[-1])})
    from modulationdetectioncnn_torch.utils.checkpoint import restore

    require([h["step"] for h in history] == list(range(100, TRAIN_STEPS + 1, 100))
            and all(np.isfinite(h["loss"]) for h in history)
            and history[-1]["loss"] < history[0]["loss"], f"train: {history}")
    require(saved == ["100", "200", "300"], f"train: saved steps {saved}")
    first, last = restore(ck, 100)[0], restore(ck, 300)[0]
    require(all(not torch.equal(first[k], last[k]) for k in first),
            "train: a parameter did not move between steps 100 and 300")
    return ck


CANARY = ("data.classes=BPSK,QPSK", "model.num_classes=2", "data.frames_per_class_per_snr=100",
          "data.snr_db_min=10", "data.snr_db_max=18", "data.snr_db_step=4",
          "train.batch_size=128")


def phase_canary(tmp: str) -> None:
    """The 2-class canary of tests/test_accuracy_regression.py on the card,
    in the default bf16: 120 steps of 128 must reach >= 0.85 on the first
    512 held-out frames. Then resume: a run stopped at step 30 and restarted
    with 60 steps must log exactly steps 31..60 (as the JAX package's resume
    test, warmup 5)."""
    from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
    from modulationdetectioncnn_torch.data import synthetic
    from modulationdetectioncnn_torch.train import loop
    from modulationdetectioncnn_torch.utils import checkpoint as ckpt

    cfg = apply_overrides(AmcConfig(), [*CANARY, "train.num_steps=120", "train.eval_every=120"])
    x, y, s = synthetic.make_dataset(cfg.data)
    (xtr, ytr, _), (xte, yte, _) = synthetic.train_test_split(x, y, s)
    t0 = time.perf_counter()
    model, history = loop.train(cfg, (xtr, ytr), (xte, yte))
    acc = float((loop.make_eval_step(model)(xte[:512]).cpu().numpy() == yte[:512]).mean())
    wall = time.perf_counter() - t0
    d = os.path.join(tmp, "ck_canary")
    resume = [*CANARY, "train.warmup_steps=5", f"train.checkpoint_dir={d}",
              "train.checkpoint_every=30"]
    loop.train(apply_overrides(AmcConfig(), [*resume, "train.num_steps=30",
                                             "train.eval_every=30"]), (xtr, ytr))
    count30 = ckpt.restore_train_state(d)[1].count
    _, resumed = loop.train(apply_overrides(AmcConfig(), [*resume, "train.num_steps=60",
                                                          "train.eval_every=1"]), (xtr, ytr))
    steps = [h["step"] for h in resumed]
    emit({"phase": "canary", "accuracy": acc, "gate": 0.85, "record": history[-1],
          "wall_s": wall, "resumed_first_step": steps[0] if steps else None,
          "resumed_last_step": steps[-1] if steps else None,
          "optimizer_count_at_30": count30, "saved_steps": sorted(os.listdir(d))})
    require(acc >= 0.85, f"canary: accuracy {acc} below the 0.85 gate")
    require(steps == list(range(31, 61)) and count30 == 30,
            f"canary resume: steps {steps[:3]}..{steps[-3:]}, count {count30}")


def phase_trained_int8(tmp: str, ck: str) -> dict[str, int]:
    """``quantize`` of the checkpoint ``train`` wrote, then ``eval
    eval.backend=int8 eval.int8_kernel=v1`` on it (the eval phase's 3520
    frames), counters zeroed just before the eval and read just after: v1
    and the logits dense stage launched and nothing else, the labels equal
    to the plain chain's. Returns that run's counts."""
    from modulationdetectioncnn_torch import cli
    from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides
    from modulationdetectioncnn_torch.ops import infer
    from modulationdetectioncnn_torch.quant import load_int8

    cfg = apply_overrides(AmcConfig(), [f"train.checkpoint_dir={ck}"])
    (art, agree), _ = quiet(cli.cmd_quantize, cfg)
    cfg = apply_overrides(AmcConfig(), [*EVAL_DATA, "eval.backend=int8", "eval.int8_kernel=v1",
                                        f"eval.int8_artifact={art}",
                                        f"eval.results_path={tmp}/eval_trained.json"])
    x = torch.from_numpy(cli._build_dataset(cfg)[0]).cuda()
    qw = load_int8(art, "cuda")
    want = torch.cat([infer.argmax_lowest(infer.dense_int8_plain(
        infer.conv_stage_int8_v5_plain(x[i:i + 1024], qw), qw)[:, :qw.nc])
        for i in range(0, len(x), 1024)]).cpu().numpy()
    reset_counts()
    t0 = time.perf_counter()
    (result, labels), _ = quiet(cli.cmd_eval, cfg)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    mism = int((labels != want).sum())
    emit({"phase": "trained_int8", "int8_artifact": os.path.relpath(art, tmp),
          "agreement_vs_float": agree, "frames": len(labels), "wall_s": wall,
          "launches": counts, "overall_accuracy": result["overall_accuracy"],
          "headline": result["headline"], "label_mismatches_vs_plain": mism})
    path = ("conv_stage_int8_v1", "dense_int8")
    require(all(counts[k] > 0 for k in path) and sum(counts.values()) == sum(
        counts[k] for k in path), f"trained int8 eval v1: launches {counts}")
    require(mism == 0, f"trained int8 eval v1: {mism} labels differ from the plain chain")
    return counts


def trace_summary(path: str) -> dict:
    """Where a Chrome trace put the host's time: the span of the host's
    events on the busiest thread, its top-level operators' time (top 8 by
    name), the time outside any operator (Python, and the port's kernel
    launches, which go through ctypes and not through an operator), the CUDA
    runtime calls, and the kernels' count and device time."""
    from collections import Counter

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")]
    tid = Counter(e["tid"] for e in host).most_common(1)[0][0]
    ops = sorted((e for e in host if e["tid"] == tid and e["cat"] == "cpu_op"),
                 key=lambda e: (e["ts"], -e["dur"]))
    by_name, end = Counter(), float("-inf")
    for e in ops:                                   # top level: not inside the last one
        if e["ts"] >= end:
            by_name[e["name"]] += e["dur"]
            end = e["ts"] + e["dur"]
    mine = [e for e in host if e["tid"] == tid]
    span = max(e["ts"] + e["dur"] for e in mine) - min(e["ts"] for e in mine)
    runtime = [e for e in host if e["cat"] == "cuda_runtime"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"host_span_ms": span / 1e3, "top_level_ops_ms": sum(by_name.values()) / 1e3,
            "outside_ops_ms": (span - sum(by_name.values())) / 1e3,
            "top_ops_ms": {k: v / 1e3 for k, v in by_name.most_common(8)},
            "cuda_runtime_calls": len(runtime),
            "cuda_runtime_ms": sum(e["dur"] for e in runtime) / 1e3,
            "kernels": len(kernels), "kernel_ms": sum(e["dur"] for e in kernels) / 1e3}


def phase_trace(tmp: str, demo: torch.Tensor) -> dict[str, int]:
    """``utils/profiler.py::trace`` around the v7 classifier on the demo's
    frames (after a warm-up), ``AMC_TRACE_DIR`` unset: under ``trace(None)``
    no profiler runs and nothing is written into the empty working
    directory; under ``trace(<dir>)`` exactly one file is written, which
    parses as JSON and holds a kernel's event (``"cat": "kernel"``; no count
    is required: the profiler can drop records). Then, reported only, where
    a trace of 3 iterations of the bench's stream chain (v7, B=4096) puts
    the host's time (``trace_summary``). Returns the counts of the traced
    classify."""
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.dsp import pipeline
    from modulationdetectioncnn_torch.dsp.channelizer import design_prototype
    from modulationdetectioncnn_torch.ops.infer import make_int8_predict
    from modulationdetectioncnn_torch.quant import load_int8
    from modulationdetectioncnn_torch.utils.profiler import trace

    classify = make_int8_predict(load_int8(device="cuda"), "v7")
    want = classify(demo)
    torch.cuda.synchronize()
    env = os.environ.pop("AMC_TRACE_DIR", None)
    empty, d, d_stream = (os.path.join(tmp, n) for n in ("trace_none", "trace", "trace_stream"))
    os.makedirs(empty)
    cwd = os.getcwd()
    try:
        os.chdir(empty)
        try:
            with trace(None):
                profiling = torch.autograd._profiler_enabled()
                got_none = classify(demo)
                torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        reset_counts()
        with trace(d):
            got = classify(demo)
        counts = launch_counts()
        sc = AmcConfig().stream
        h = design_prototype(sc.num_subbands, sc.taps_per_branch)
        wide = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
            (2, BATCH * sc.frame_len)).astype(np.float32)).cuda()

        def chain():
            return classify(pipeline.subband_frames(wide, h, sc).reshape(-1, 2, sc.frame_len))

        chain()
        torch.cuda.synchronize()
        with trace(d_stream):
            for _ in range(3):
                chain()
    finally:
        if env is not None:
            os.environ["AMC_TRACE_DIR"] = env
    files, none_files = sorted(os.listdir(d)), sorted(os.listdir(empty))
    require(not profiling and none_files == [],
            f"trace(None): profiler on {profiling}, files {none_files}")
    require(len(files) == 1 and files[0].endswith(".pt.trace.json"), f"trace: files {files}")
    try:
        with open(os.path.join(d, files[0])) as f:
            events = json.load(f)["traceEvents"]
    except (ValueError, KeyError) as e:
        raise CheckFailed(f"trace: {files[0]} is not a Chrome trace: {e!r}") from e
    kernels = [e for e in events if e.get("cat") == "kernel"]
    v7 = KERNEL_SYMBOLS["conv_stage_int8_v7"]
    stream_files = [f for f in os.listdir(d_stream) if f.endswith(".pt.trace.json")]
    emit({"phase": "trace", "file": files[0], "bytes": os.path.getsize(os.path.join(d, files[0])),
          "events": len(events), "kernel_events": len(kernels),
          "v7_kernel_events": sum(v7 in e.get("name", "") for e in kernels),
          "launches": counts, "stream_chain_v7_3_iterations": trace_summary(
              os.path.join(d_stream, stream_files[0])) if len(stream_files) == 1 else stream_files})
    require(kernels, f"trace: no kernel event among {len(events)} events")
    require(torch.equal(got, want) and torch.equal(got_none, want),
            "trace: labels under trace differ from the untraced run")
    require(counts["conv_stage_int8_v7"] == 1 and counts["dense_argmax_int8"] == 1,
            f"trace: launches {counts}")
    return counts


TRACE_TIME_LIMIT_S = 300


def phase_trace_process(tmp: str) -> None:
    """Phase ``trace`` in a process of its own (``--trace-phase``): a
    profiler session that exports a trace in this process makes the later
    phases' sessions drop most device records (11 and 14 of phase kernels'
    17 device times lost in two runs on the H100, against 1 without it;
    phase cnn_kernels then fails). Prints the child's lines; requires its trace line and exit
    code 0."""
    code = _run_ranks([["--trace-phase", tmp]], tmp, "trace", TRACE_TIME_LIMIT_S)[0]
    with open(os.path.join(tmp, "trace0.log")) as f:
        lines = f.read().splitlines()
    for line in lines:
        print(line, flush=True)
    require(code == 0 and any(ln.startswith('{"phase": "trace"') for ln in lines),
            f"trace: its process exited {code}")


def phase_stream_variants(tmp: str) -> dict[str, int]:
    """``scripts/bench_stream_variants.py`` at the bench's defaults (v7,
    B=4096, full width), written into ``tmp``, counters zeroed just before
    it: the CNN-only rate and all six variants in the JAX script's order,
    none with an error (the script's own keep-going stays; this check does
    not swallow an error), each rate > 0 and ``pct_of_cnn_only`` as
    computed; rows 1 and 2 launched, and row 21 on its window route alone
    (``timing_on``). ``default`` / ``default_rerun`` is printed, not
    checked: stream mode is host-noisy. Returns the counts."""
    from modulationdetectioncnn_torch.scripts import bench_stream_variants as bsv

    out = os.path.join(tmp, "bench_stream_variants.json")
    reset_counts()
    t0 = time.perf_counter()
    res, lines = quiet(bsv.main, [f"out={out}"])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    for line in lines:
        print(line, flush=True)
    variants = res["variants"]
    rate = {n: v.get("samples_per_sec") for n, v in variants.items()}
    ratio = (rate["default"] / rate["default_rerun"]
             if rate.get("default") and rate.get("default_rerun") else None)
    emit({"phase": "stream_variants", "wall_s": wall, "backend": res["backend"],
          "cnn_only_samples_per_sec": res["cnn_only_samples_per_sec"],
          "samples_per_sec": rate,
          "pct_of_cnn_only": {n: v.get("pct_of_cnn_only") for n, v in variants.items()},
          "default_over_default_rerun": ratio, "launches": counts})
    with open(out) as f:
        require(json.load(f) == res, "stream_variants: the file differs from the result")
    errors = {n: v["error"] for n, v in variants.items() if "error" in v}
    require(not errors, f"stream_variants: failed variants {errors}")
    cnn = res["cnn_only_samples_per_sec"]
    require(list(variants) == [n for n, _ in bsv.VARIANTS] and res["backend"] == "pallas_int8_v7"
            and cnn > 0, f"stream_variants: {res}")
    require(all(v["samples_per_sec"] > 0
                and v["pct_of_cnn_only"] == round(100 * v["samples_per_sec"] / cnn, 1)
                for v in variants.values()), f"stream_variants: {variants}")
    path = ("conv_stage_int8_v7", "dense_argmax_int8", "correct_timing_fir",
            "correct_timing_fir/window")
    require(all(counts[k] > 0 for k in path) and counts["correct_timing_fir/general"] == 0,
            f"stream_variants: launches {counts}")
    return counts


# The keys of the JAX script's summary (scripts/train_eval_full.py:135-145),
# for the default int8 kernel, v7.
FULL_SUMMARY_KEYS = ["float_headline", "int8_headline", "int8_minus_float", "int8_kernel",
                     "int8_on_chip", "pallas_v7_vs_golden_int8_agreement",
                     "generator_version", "train_history_tail"]


def repo_files(skip: str) -> dict[str, int]:
    """Every file of the checkout with its mtime, but byte code, the kernel
    build and anything under ``skip``."""
    found = {}
    for d, dirs, names in os.walk(REPO):
        dirs[:] = [n for n in dirs if n not in ("__pycache__", "_build", ".git")
                   and os.path.join(d, n) != skip]
        for n in names:
            path = os.path.join(d, n)
            found[os.path.relpath(path, REPO)] = os.stat(path).st_mtime_ns
    return found


def phase_full(tmp: str) -> dict[str, int]:
    """``scripts/train_eval_full.py`` at full width (conv1 256, conv2 80,
    dense 256, 11 classes) on the train phase's cut (TRAIN_DATA,
    TRAIN_STEPS), written into ``tmp``, counters zeroed just before it: the
    summary's keys the JAX script's, agreement with the plain chain exactly
    1.0, ``int8_on_chip`` true; rows 1 and 2 launched and nothing else,
    once per batch of the int8 sweep and once for the agreement's 512
    frames (no other stage launches a kernel of the port: training and the
    float sweep run torch's ops); its seven outputs in ``tmp``; no file of
    the checkout written or touched. Returns the counts."""
    from modulationdetectioncnn_torch.config import EvalConfig
    from modulationdetectioncnn_torch.scripts import train_eval_full as tef

    out = os.path.join(tmp, "train_eval_full")
    argv = [*TRAIN_DATA, f"train.num_steps={TRAIN_STEPS}", "train.eval_every=100", f"out={out}"]
    before = repo_files(tmp)
    reset_counts()
    t0 = time.perf_counter()
    summary, lines = quiet(tef.main, argv)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    after = repo_files(tmp)
    with open(os.path.join(out, "results_int8.json")) as f:
        held_out = int(sum(np.sum(c) for c in json.load(f)["confusion"].values()))
    calls = -(-held_out // EvalConfig().batch_size) + 1
    agree = summary.get("pallas_v7_vs_golden_int8_agreement")
    emit({"phase": "full", "argv": argv, "wall_s": wall, "outputs": sorted(os.listdir(out)),
          "frames_held_out": held_out, "launches": counts, "summary": summary,
          "printed_lines": len(lines)})
    require(list(summary) == FULL_SUMMARY_KEYS, f"full: summary keys {list(summary)}")
    require(agree == 1.0 and summary["int8_on_chip"] is True and summary["int8_kernel"] == "v7",
            f"full: agreement {agree}, on chip {summary['int8_on_chip']}")
    path = ("conv_stage_int8_v7", "dense_argmax_int8")
    require(all(counts[k] == calls for k in path)
            and sum(counts.values()) == 2 * calls, f"full: launches {counts}, want {calls} each")
    outputs = sorted(os.listdir(out))
    require(len(outputs) == 7 and {"results.json", "results_int8.json", "summary_rml11.json",
                                   "train_rml11.jsonl", "ckpt_rml11", "ckpt_rml11_int8"}
            < set(outputs), f"full: outputs {outputs}")
    changed = sorted(k for k in set(before) | set(after) if before.get(k) != after.get(k))
    require(not changed, f"full: wrote outside its directory: {changed[:20]}")
    return counts


def phase_qat(tmp: str) -> None:
    """``qat`` on a copy of the exported float checkpoint (40 steps of the
    default batch on the configured dataset cut to 50 frames per class and
    SNR), then ``quantize`` of its ``_qat`` output and ``eval`` of that
    artifact with int8 (v7) on the eval phase's frames, beside the PTQ
    artifact of the same checkpoint (phase quantize)."""
    import shutil

    from modulationdetectioncnn_torch import cli
    from modulationdetectioncnn_torch.config import AmcConfig, apply_overrides

    ck = os.path.join(tmp, "ckpt_rml11_r5")
    shutil.copytree(FLOAT_CKPT, ck)
    cfg = apply_overrides(AmcConfig(), ["data.frames_per_class_per_snr=50",
                                        "train.num_steps=40", f"train.checkpoint_dir={ck}"])
    t0 = time.perf_counter()
    qat_dir, lines = quiet(cli.cmd_qat, cfg)
    qat_wall = time.perf_counter() - t0
    (art, agree), _ = quiet(cli.cmd_quantize, apply_overrides(
        AmcConfig(), [f"train.checkpoint_dir={qat_dir}"]))
    acc = {}
    for name, artifact in (("qat", art), ("ptq", os.path.join(tmp, "ckpt_int8"))):
        (res, _), _ = quiet(cli.cmd_eval, apply_overrides(AmcConfig(), [
            *EVAL_DATA, "eval.backend=int8", f"eval.int8_artifact={artifact}",
            f"eval.results_path={tmp}/eval_{name}.json"]))
        acc[name] = res["overall_accuracy"]
    emit({"phase": "qat", "printed": json.loads(lines[-1]), "qat_wall_s": qat_wall,
          "int8_agreement_vs_float": agree, "overall_accuracy_int8": acc})
    require(os.path.isfile(os.path.join(qat_dir, "0", "params.npz"))
            and os.path.isfile(os.path.join(art, "int8.npz")), "qat: outputs missing")
    require(acc["qat"] > 2 / 11, f"qat: int8 accuracy {acc}")


def demo_frames() -> torch.Tensor:
    """The frames the stream path hands the classifier (1024 on cuda)."""
    from modulationdetectioncnn_torch.config import AmcConfig
    from modulationdetectioncnn_torch.dsp import framer, pipeline
    from modulationdetectioncnn_torch.dsp.channelizer import design_prototype

    cfg = AmcConfig()
    sc = cfg.stream
    wide, _ = pipeline.make_demo_signal(cfg)
    plan = pipeline.plan_frontend(sc)
    blocks = framer.overlap_save_blocks(framer.to_planes(wide, "cuda"),
                                        sc.block_len, plan.halo_in).transpose(0, 1)
    fr = pipeline.block_frontend(
        blocks, design_prototype(sc.num_subbands, sc.taps_per_branch), None, sc, plan)
    return fr.reshape(-1, 2, sc.frame_len).contiguous()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU machine",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "modulationdetectioncnn_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # The plain folded conv1 is a float32 product that must be exact: keep
    # TF32 off for matmuls (PyTorch's default, stated here).
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:2] == ["--gloo-rank"]:        # one rank of phase parallel_gloo
        return gloo_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    if sys.argv[1:2] == ["--probe-rank"]:       # one process of its premises' probe
        return probe_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5])
    if sys.argv[1:2] == ["--trace-phase"]:      # phase trace, in a process of its own
        try:
            phase_trace(sys.argv[2], demo_frames())
        except CheckFailed as e:
            emit({"ok": False, "failed": str(e)})
            return 1
        return 0
    t_start = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            dev = phase_device()
            dev["ptxas_log"] = phase_build()
            demo = demo_frames()
            # Before the phases that open many profiler sessions (the
            # profiler drops records late in a long process), and in a
            # process of its own, whose session leaves this one's intact.
            phase_trace_process(tmp)
            rows = phase_kernels(dev, demo)
            # Rows 17-20: no product path calls them (0 launches on the main
            # path, read at the end); their checks count their own.
            rows += phase_cnn_kernels(dev, demo)
            # The two probe kernels: no product path calls them either.
            rows += phase_probe_kernels(dev, demo)
            int8 = ("dense_argmax_int8",)
            # The stream path: v7 + dense.
            launches = phase_stream("v7", [], ("conv_stage_int8_v7", *int8))
            phase_stream("v10", ["eval.int8_kernel=v10"], ("conv_stage_int8_v10", *int8))
            phase_stream("v3", ["eval.int8_kernel=v3"], ("conv_stage_int8_v3", *int8))
            # The stream path with timing correction: the timing FIR.
            # The stream's 128-sample frames and 17 taps take the window
            # route alone.
            timing = ("conv_stage_int8_v7", *int8, "correct_timing_fir",
                      "correct_timing_fir/window")
            tl = phase_stream("timing", ["stream.normalize_timing=true"], timing,
                              check_tops=False)
            launches["correct_timing_fir"] = tl["correct_timing_fir"]
            rl = phase_stream("resample_timing", ["stream.resample_up=1",
                                                  "stream.resample_down=2",
                                                  "stream.normalize_timing=true"],
                              timing, check_tops=False)
            require(all(c["correct_timing_fir/general"] == 0 for c in (tl, rl)),
                    f"stream timing took the general route: {tl} {rl}")
            # parallel/ at world size 1 (NCCL): the sharded stream, the
            # dryrun, train on a 1x1x1 mesh.
            phase_parallel()
            launches.update(phase_bench())          # the bench path: v9, v10, bf16
            phase_stream_variants(tmp)              # the six front-end variants
            # This slice: the scaling command (rows 1, 3, 2 through the
            # bench's calibration) and the per-stage breakdown (rows 4, 2
            # on their own).
            phase_scaling()
            phase_breakdown()
            # The eval path: v5, v6, v4, v3, v2 and v2's dense stage.
            launches.update(phase_eval(tmp))
            # The bf16 forwards: make_bf16_forward's conv stage.
            launches["conv_stage_bf16"] = phase_forwards()["conv_stage_bf16"]
            phase_float_predictor()                 # the stream's float route
            # Row 25: the residual classifier's chain and its route.
            row, launches["residual_chain_bf16"] = phase_resnet_chain(dev)
            rows.append(row)
            phase_quantize(tmp)
            # This slice: train, the canary and resume, the trained
            # checkpoint through quantize and eval with v1, qat.
            ck = phase_train(tmp)
            phase_canary(tmp)
            launches["conv_stage_int8_v1"] = phase_trained_int8(tmp, ck)["conv_stage_int8_v1"]
            phase_full(tmp)                         # the flagship pipeline, cut
            phase_qat(tmp)
            phase_parallel_gloo(tmp)                # two gloo ranks on the card
            phase_profile()
        from modulationdetectioncnn_torch.ops import cnn_kernels

        from modulationdetectioncnn_torch.ops import probe_kernels

        launches.update(cnn_kernels.launch_counts())
        launches.update(probe_kernels.launch_counts())
        for row in rows:
            row["launches"] = launches[row["name"]]
    except CheckFailed as e:
        emit({"ok": False, "failed": str(e)})
        return 1
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
