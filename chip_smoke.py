#!/usr/bin/env python3
"""Drive the PyTorch port (``joint_vae_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, any failure raising (nonzero exit):

1. require a CUDA card; print ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``joint_vae_tpu_torch/csrc`` (one nvcc per
   source, all started together), print the build time, ptxas's register
   report and the tensor-core instructions of the conv library
   (``cuobjdump -sass``: HMMA/HGMMA by opcode and kernel), and fail
   unless it holds both TF32 and BF16 ones;
3. hold each kernel against its plain PyTorch version at the flagship's
   shapes and time kernel, plain version, library call and bound:
   the same-grid conv at its eight sites (N=512 features, L*N=8192
   decoder; the two stride-2 deconvs as their packed sub-pixel convs) in
   float32 and bfloat16, the co=3 head also zero-padded to co=8 (the
   8-wide tensor-core tile, against float32's CUDA-core path); the IWAE
   combine at L=16, N=512, C=100, K=128 in both modes, a ragged C=37,
   N=137 case, the OOD evaluation's ragged last batch N=272, the
   flagship's shape with prior means at the flagship's scale 17,
   L=128 at N=64 and N=512, C=1000, K=256, and C=1 at N=256 with means
   at the WIM alternate prior's scale 8 (``IWS_CASES``), each timed
   as called back to back and replayed from a CUDA graph, beside the
   composite of PyTorch calls that the JAX package's default path
   computes (``library_ms``, its deviation from the plain version
   printed, not gated); the conv at its eight sites for the OOD
   evaluation's ragged last batch (272 images: n=272 features, n=4352
   decoder), float32, against its plain version (``conv_tail`` lines);
4. serve the full-width flagship CVAE (random weights from a numpy seed)
   through the entry points: ``save_job``, the serve CLI on ``.npy``
   inputs, ``Scorer`` on 4 batches of 512 at L=16; check that the conv
   kernel was launched 8 times and the IWAE kernel once per batch on that
   run, that outputs are finite; then 2 ``Scorer`` batches of 64 at the
   reference's eval point L=128, with the same launch check; 8 inputs with
   injected noise agree between the card and the CPU (where the plain
   versions run); profile one batch by kernel and fail if cuDNN's
   transposed-conv kernel (``dgrad``) is in it;
5. train the full-width flagship on the card through the entry points
   (the training slice): the conv and its input gradient checked first
   at the train step's shapes (batch 1024: the forward at its eight
   sites, the dx at the seven whose input needs a gradient, both against
   their plain versions, with cuDNN's dgrad timed beside; the weight
   gradient, a float32 im2col product, against the same in float64, with
   cuDNN's wgrad and its error beside; the strided convs' cuDNN
   gradients against float64 on the CPU); ``new_job`` with
   ``bench.py``'s optimizer, ``train_model`` for 1 epoch of 16 batches
   of 1024 synthetic images with a 1024-image
   validation split and a test set, then ``save_job`` / ``load_job``,
   weights and optimizer state compared exactly; the launches of that
   run checked (8 forward and 7 dx per step, 8 forward per eval batch,
   no IWAE combine); 10 steps timed after 3 warm-up steps (8 forward and
   7 dx launches each), fed as ``train_model`` feeds them, the loader's
   and the copy's host time apart, then the same 10 batches again from
   the card; one step profiled by kernel; and the card against
   the CPU on a batch of 8 from one init with injected noise: the first
   step's gradients per tensor and the losses of 3 steps;
6. evaluate the flagship per class through the engines (the
   evaluation slice): phase 4's job, the registry's cifar100 test set
   and its companions cifar10, svhn and lsunc (10,000 images each, the
   synthetic substitutes where no data is at hand), batch 512, L=16:
   ``ood_detection_rates`` (compute tier; 8 conv and 1 combine launches
   per batch, the 272-image tail included), then ``accuracy`` and
   ``misclassification_detection_rates`` and a repeated OOD call, which
   the recorders and the json tier serve with no launch; the compute
   tier's images/s and ms per set, the record files' write ms, the
   ROC's ms per (set, method) on the card; the ROC on the card against
   the CPU over the same scores (rates and AUC within 1e-6, thresholds
   equal), and the engine replayed on the CPU from a copy of the record
   files, entry by entry against the card's results (rates and AUC
   within 1e-6; thresholds equal where the two derive equal scores from
   the records, else within their difference);
   the record file's native and Python writers on cifar100's file, bytes
   equal, each timed; one compute-tier evaluation profiled by kernel
   group; ODIN on a full-width vib (batch 64, 2 temperatures x 2
   epsilons: 6 forward and 4 dx launches, conv_0's 32 -> 3 dx among
   them), card against CPU with the same noise within 1e-4, then the dx
   at conv_0 against its plain version on the output gradient that ODIN
   gave it and on a random one (the conv's float32 form), timed;
   ``python -m joint_vae_tpu_torch.cli.train`` in a subprocess with
   the flagship's flags, one epoch on 2,048 images with cifar10 and svhn
   as OOD sets, its job dir checked and loaded (``ood`` line);
7. the bench's train path (``bench.py`` trains in bfloat16 from a set
   held on the device): the conv in bfloat16 at the train step's shapes
   first (phase 5's ``train_conv``/``dx`` checks in bfloat16:
   ``train_conv_bf16`` and ``dx_bf16`` lines, cuDNN bf16 beside, the
   weight gradient summed in float32 against float64); then the
   full-width flagship in bfloat16 for one epoch over a 50,000-image
   uint8 set held on the card (CIFAR-100-train's size), through
   ``train_model(device_data=True)`` at batch 1024 and
   ``train_epochs_on_device(fused=True)`` at 512, the launches of each
   epoch checked (8 forward and 7 dx per step, all of the bfloat16 build
   by ``same_grid_conv.py::bf16_launches``; no combine), then 10 timed
   device-fed steps of each and one profiled (``bench_train_bf16``
   lines); the float32
   step fed from the card beside phase 5's host-fed one; one device-fed
   epoch profiled (one gather of the set, no per-step copy); the
   bfloat16 gate on training (card bf16 against CPU float32 on a batch
   of 8, its reconstruction checked to be bfloat16; first-step gradients
   per tensor and every metric of 3 steps)
   and on a ``Scorer`` batch of 512 at L=16 (8 conv and 1 combine
   launches; scores against the card's float32 Scorer of the same
   weights and noise); ``cli.train --device-data --compute-dtype
   bfloat16`` in a subprocess, its job loaded, and ``cli.serve`` by the
   job's number naming cifar100's classes (``bench_train`` line);
8. fleet evaluation from the job store: phase 6's flagship job (its
   results saved back with ``save_job(save_state=False)``, its record
   files) and 63 jobs made from its JSON files (sigma and beta varied,
   1-3 epochs of history, results at the last two); the registry built
   cold (64 ghost loads) and warm (``flash``), its entries equal, the
   ghost loads leaving CUDA uninitialised in a fresh process; then
   ``cli.test.main([... '--compute', 'rehard', '--sets', 'cifar100',
   'cifar10', 'svhn', 'lsunc', '-M', '512'])`` in-process on the
   flagship alone (``--job 0``): accuracy, OOD and misclassification
   recomputed through the engines at L=16, its launches exactly 8 conv
   and 1 combine per batch of the six set passes (accuracy 1, OOD 4,
   misclassification 1; 20 batches each, the 272-image tail included:
   960 and 120), its saved OOD results against phase 6's (rates and AUC
   within 1e-6, thresholds as phase 6's replay holds them: the same
   noise, since the engines seed it from the epoch), its accuracy and
   misclassification results against the engines called directly with
   the same seeds (within 1e-6); the cheap tiers over the whole fleet
   (``--compute --early-stopping`` and ``--all-epochs``), which must
   launch nothing; their ``.tab``/``.tex`` tables parsed (no ``.tex``
   for ``--all-epochs``: its rows at two epochs of one job share an index
   tuple, which the JAX package's renderer, ported as it is, merges);
   ``python -m
   joint_vae_tpu_torch.cli.results`` in a subprocess on a
   comparison-mode INI over the fleet, one column pair per section
   (``fleet`` line: registry ms per job, the recompute's images/s and
   wall seconds, the cheap tiers' seconds);
9. WIM fine-tuning (the fine-tuning slice) on phase 6's flagship job
   with ``[wim-default]``'s alternate prior (an unconditional gaussian,
   init_mean 8; moving set 512, alpha 0.1, one epoch): first the card
   against the CPU on 8 inputs with injected noise (a both-prior
   evaluation at L=16: every loss, '@' twin and WIM score at the serving
   tolerance; the fine-tuning gradient of 8 in and 8 moving inputs per
   tensor at the training gate; 3 steps' metrics to 1e-4 relative; the
   prior and every buffer bit-equal after the steps); then
   ``cli.ft.main([...])`` in-process from a scratch working directory
   on a copy of the job, ``--oodsets cifar10 svhn --train-size 8192
   --batch-size 64 --test-batch-size 256 --inspection``: its launches
   exactly those worked out from the code (128 steps of 16 conv and 14
   dx; 8 conv and 1 combine per batch of the pre-tuning engines and of
   ``record_latents``, 16 conv and 1 combine per both-prior batch: 40
   batches per set), the new job (number 1 under ``wim/``, its
   ``wim_prior.npz``, ``init/ood.json``, record files with
   ``y_est_already``, ``inspection.json`` and ``proj2d-pca.csv``) and the
   source job byte-unchanged; a second run at ``--task 1 --train-size
   1024``; ``cli.ft --array --register`` over both jobs (no launch; its
   rates equal ``WIMArray.recompute_rates``); ``cli.test --compute re``
   over both jobs with the WIM methods, which replays them from the
   record files with no launch (rates, AUC and thresholds within 1e-6
   of those ``finetune`` saved); ``cli.ft --poscod`` (8 conv per batch,
   no combine; the head reloads); 10 fine-tuning steps timed after 3
   warm-up ones, fed from the host, and one profiled (``wim`` line);
10. trunks and drivers: the ResNet flagship (the flagship with
   ``features='resnet18'``: full width 64, 11,176,512 trunk parameters on
   cuDNN, the decoder's 6 same-grid sites) trained as phase 5 trains the
   flagship (``train_model`` for 16 batches of 1024, ``save_job`` /
   ``load_job`` with the BatchNorm statistics compared exactly, 6 forward
   and 6 dx launches per step and 6 forward per eval batch, 10 timed
   steps and one profiled, the trunk's cuDNN time apart from the conv
   kernel's; card against CPU at batch 64: 3 steps' losses, the first
   step's gradients and the running statistics after the steps
   reported),
   card against CPU on 8 inputs (every loss and score at
   the serving tolerance), ``Scorer`` on 4 batches of 512 at L=16 (6 conv
   and 1 combine launches per batch); ``resnet50`` and ``densenet121`` at
   full width, one forward of 8 images card against CPU in the conv's
   form; then the drivers over
   phase 6's flagship (job 1) and the ResNet flagship (job 2), cifar100's
   10,000-image test split: ``cli.sample`` (``--grids reco gen zsample
   --compare 2``; its launches those of its evaluate calls, counted, plus
   the generation grid's decode), ``cli.aggregate`` (``--combos 1 2
   --record``, the record and OOD sets cut to phase 6's cifar10, svhn and
   lsunc: 8 conv and 1 combine per batch of the flagship, 6 and 1 of the
   ResNet flagship, 160 batches each), ``cli.cascade`` flagship -> ResNet
   with ``--record`` (512 images: 28 conv, 4 combine),
   ``results.mutual_info`` on both record dirs (no launch) and
   ``cli.grid --run`` on a two-combination section of the ResNet
   flagship's flags with ``--pretrained-features`` on its job (beta 1e-4
   and 1e-3, one epoch on 2,048 images each: two ``cli.train``
   subprocesses; both jobs loaded, each with the trunk bit-equal to the
   donor's after training, every other trainable tensor moved and the
   untrainable ones kept) (``resnet`` and ``drivers`` lines);
11. reference-trained jobs imported and run (the interop slice): two
   job directories in moxime/joint-vae's PyTorch layout written by
   ``tests/torch_reference_layout.py`` (phase 6's job trained 3 steps at
   1024 with bench.py's Adam, saved at epoch 2 with ``state.pth``, its
   sigma as the reference's Sigma subclass, ``optimizer.pth`` and phase
   6's records as ``record-<set>.pth`` saved from the card; the ResNet
   flagship with a torchvision-layout resnet18 trunk from
   ``save_load/tv_resnet.py``) and a corrupt third; ``python -m
   joint_vae_tpu_torch.cli.import_ref --scan`` in a subprocess on the
   card and with ``--device cpu`` (``2 imported, 1 failed``, exit 1, the
   two trees byte-equal, ``.npz`` files member by member), each job
   imported in process and timed; the imported flagship's weights, Adam
   moments and count bit-equal to the source after ``load_job`` on the
   card, its records' ``.jvr`` bytes phase 6's; a ``Scorer`` batch (512,
   L=16) on the import against the source's on the same noise (the
   serving tolerance), traced by ``utils/profiling.py::trace``: 8 conv
   and 1 combine launches counted, and as the wrappers' launch spans in
   the Chrome trace, both kernels named among its kernel records (the
   trace of a long-lived process misses the first kernel records of a
   session: PERF.md §7); the imported ResNet trunk against tv_resnet's eval-mode
   forward (the conv form at 1e-4), its other weights bit-equal, a
   ``Scorer`` batch (6 conv, 1 combine); ``cli.test --compute re`` on the
   import (phase 6's OOD results cleared first: rebuilt from the imported
   records with no launch, AUCs within 1e-6 of phase 6's), then
   ``--compute rehard`` over cifar100 and cifar10 (4 passes of 20
   batches: 640 conv and 80 combine launches); 4 train steps at 1024
   resumed from the imported state (8 forward and 7 dx launches each),
   the first against the source's first on the same batch and noise
   (losses to 1e-4 relative); ``utils/device.py::compute_max_batch_size``
   on the Scorer at L=16 and on the train step from 512 until the card
   runs out of memory, with ``device_memory_stats`` before and after;
   then ``dump_crash`` of the imported job with a batch on the card, read
   back and reloaded (``interop`` line);
12. the device mesh (``joint_vae_tpu_torch/parallel``).  (a) A world of
   one rank over NCCL: ``train_model`` for 4 host-fed flagship steps of
   1024 on a (1, 1) mesh against the same steps without one, run twice,
   all under PyTorch's deterministic algorithms (the loss components
   within 1e-6 relative, or within twice the spread between the two
   plain runs where one is left), 8 forward and 7 dx launches per step; the step's ms with and without the mesh in turns
   and the gradient all-reduce's own ms (CUDA events); the job saved as
   a sharded checkpoint with and without ``AsyncCheckpointer`` (seconds
   and bytes) and restored into a run with no mesh, arrays and optimizer
   state byte-equal (``mesh_world1`` line).  (b) Two ranks spawned on the
   one card over gloo (``--mesh-rank``; NCCL refuses two ranks on one
   device), each under its own time limit: ``ood_detection_rates`` of
   phase 4's flagship job on cifar100's test set and cifar10 (10,000
   images each, batch 512, L=16) at ``model_axis=2`` (C=50 a rank: the
   combine on (50, N)) and at ``sample_axis=2`` (17 samples as 9 + 8),
   against this process's one-process card run (AUCs equal, means within
   rtol 1e-6), then 4 steps of 1024 at ``model_axis=2``, deterministic
   as in (a) (the losses within 1e-5 relative, or the spread as in (a)); each rank's launches of each
   run counted (320 conv and 40 combine per evaluation, 32 forward and 28
   dx for the steps), both kernels held against their plain versions on
   each rank at a rank's shapes, and all_reduce, all_gather, broadcast
   and barrier on the card's tensors over gloo (``mesh_gloo`` line; two
   processes share the card, so its times are no speed figure).  (c) The
   same over NCCL with one rank per card when the machine has two cards
   or more, else one line saying that it waits for such a machine;
13. export to moxime/joint-vae's job layout (the export slice): a stub
   reference checkout written by ``tests/torch_reference_stub.py`` (the
   reference's ``cvae.py``, ``module/vae_layers/conv.py`` with its
   densenet routing bug, ``utils/save_load/recorders.py``); copies of
   phase 5's trained flagship (Adam moments), phase 6's job (records,
   ``test.json``, ``ood.json``), phase 9's WIM and Poscod jobs, phase 10's
   ResNet flagship, a densenet121-trunk flagship at width 64 and a
   corrupt job; ``python -m joint_vae_tpu_torch.cli.export_ref --scan``
   in a subprocess on the card (``6 exported, 1 failed``, exit 1, the
   corrupt job named), each job exported in process and timed, the two
   trees equal (``.pth`` files as loaded, JSON as parsed); every export
   imported back on the card: weights, BatchNorm statistics, sigma,
   Adam's moments, count and learning rate bit-equal to the source after
   ``load_job`` (a WIM or Poscod job's moments are not imported back by
   either package, which is checked), record files' bytes equal; phase
   11's imported flagship exported again, its ``state.pth`` and
   ``optimizer.pth`` equal to phase 11's reference-layout source tensor
   by tensor, key order included; a ``Scorer`` batch (512, L=16) on the
   re-imported phase-5 flagship bit-equal to the source's on the same
   noise (8 conv and 1 combine launches), and both kernels against their
   plain versions at that batch's shapes (``export`` line: seconds per
   job and per ``--scan``, files, bytes and tensors written);
14. print one JSON line ``{"kernels": [...]}`` (``launches_test_cli``:
   phase 8's recompute; ``launches_wim_ft``: phase 9's first run;
   ``launches_resnet_step``, ``launches_resnet_serve`` and
   ``launches_drivers``: phase 10's; ``launches_interop_*``: phase 11's;
   ``launches_mesh_*``: phase 12's; ``launches_export``: phase 13's);
15. print ``{"ok": true, "device": {...}}`` as the last line.

Bounds: max(bytes / 3.35 TB/s, FLOPs / peak) with float32 at the 3xTF32
rate (3 x FLOPs / 495 TFLOP/s; the CUDA-core bound at 67 TFLOP/s beside
it), bfloat16 at 989 TFLOP/s, the IWAE combine on the CUDA cores.

Tolerances, all elementwise.  Conv, |kernel - plain| <= tol (|plain| +
rms(plain)): float32 tol 1e-4 (sums of up to 1,600 products in another
order, 3xTF32 products exact to ~2^-21), bfloat16 1.6e-2 (two bf16 ulps:
both round the float32 sum to bf16).  IWAE, elementwise
|kernel - plain| <= 1e-4 + 1e-6 |plain|, on inputs whose log-weights
spread over l so that the sum term (mean-exp or log-mean-exp, at least
1/L) carries the result; the check fails if it does not (at the prior
scale 17 it is read over each input's true class).  Card vs CPU
serving, elementwise on every loss and score: |card - cpu| <= 1e-4 +
2e-6 |cpu| (about 16 float32 ulps; the absolute term covers small
quantities such as var_kl, differences of per-latent sums over K=128).
The conv's input gradient and the weight gradients are held to the
conv's float32 form and tolerance.  Card vs CPU training, gradients of
the first step per tensor, elementwise: |card - cpu| <= 1e-4 (|cpu| +
rms(cpu)), the conv's form (the gradient runs through every layer back
to the first, each as precise as the conv gate; the rms term covers the
elements whose gradient cancels to near zero), except that up to 1/16 of
a tensor's elements may be within 5e-2 (|cpu| + rms(cpu)) instead: a
ReLU whose input lies within rounding of zero (the gate's batch has one
at 3e-8 in features conv_0) switches on one device and not the other,
and moves one position's term in the weight gradient of its output
channel (1/co of the layer's weights, co >= 32 for every ReLU layer) and
of its bias; the losses of 3 steps to 1e-4 relative (float32 sums over
3,072 pixels and 128 latents).
Weights are not compared after a step: Adam's first steps move every
weight by about lr whatever the size of its gradient, so a gradient that
is zero to rounding may move one way on the card and the other on the
CPU.

Phase 10's ResNet flagship: the serving tolerance on every loss and
score; in training, at batch 64 (batch statistics over 8 values at the
trunk's 1x1 maps make a step chaotic, tests/test_torch_resnet.py), the
3 steps' losses to 1e-4 relative.  Its first-step gradients (by their
rms-relative error) and its BatchNorm running statistics after the
steps (in the form |card - cpu| / (|cpu| + rms(cpu))) are reported and
not gated: in training mode cuDNN's float32 backward through the trunk
lies up to 4.96e-3 (rms-relative) from float64 on resnet18's full width
where the CPU's float32 lies within 7.1e-6 (in inference mode within
4.6e-6: training-mode BatchNorm amplifies it; scripts/
time_torch_trunk_grads.py on the H100, ROADMAP Queue 3), a ReLU flip in the
dense encoder moves 1/64 of a weight gradient's column, and the
statistics after the steps follow the weights those gradients moved.
The trunks alone (resnet50, densenet121) in inference: the conv form at
1e-4.

bfloat16 (phase 7).  The conv and its dx in the conv's form at 1.6e-2;
the weight gradient, summed in float32 and rounded once, within
2^-8 |want| + 1e-4 rms(want) of the float64 sum of the same inputs.  A
bfloat16 model is ~1e-3 from its float32 self, so it is held by the
bfloat16 gate, per tensor, metric or score, with err the rms-relative
error ||got - ref||_2 / ||ref||_2:
err(card bf16, CPU f32) <= a err(CPU bf16, CPU f32) + b, a = 2,
b = 2.5e-4, fixed on the tiny flagship against the JAX package before
any chip run (``tests/test_torch_bf16.py``: the port's error at most 1.4
times JAX's; b covers a scalar mean whose errors cancel in one run and
not the other).  The Scorer's scores: err(card bf16, card f32) over the
batch of 512 against the same right side from the CPU on its first 32
inputs.
"""

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, 'build', 'chip_smoke')

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
CUDA_CORE_FLOPS = 67e12            # float32 outside the tensor cores
TF32_FLOPS = 495e12                # dense TF32 tensor cores
# the least time of one product in each type: float32 runs as 3xTF32 (three
# TF32 products per product), bfloat16 one pass on the tensor cores
PEAK_FLOPS = {torch.float32: TF32_FLOPS / 3,
              torch.bfloat16: 989e12}
CONV_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
IWS_RTOL, IWS_ATOL = 1e-6, 1e-4
IWS_MIN_SPREAD = 0.05
SERVE_RTOL, SERVE_ATOL = 2e-6, 1e-4
BATCH, BATCHES = 512, 4
L_EVAL, BATCH_EVAL = 128, 64       # the reference's eval L (ref config.ini:28)
SITES_PER_BATCH = 8      # same-grid kernel launches per flagship serve batch
DX_PER_STEP = 7          # dx launches per train step: conv_0 reads the data
TRAIN_BATCH, TRAIN_BATCHES = 1024, 16     # bench.py's train batch (:56-59)
TRAIN_VALIDATION, TRAIN_TEST, TRAIN_TEST_BATCH = 1024, 1024, 512
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
TRAIN_LR = 1e-4                           # bench.py:100
GATE_BATCH, GATE_STEPS = 8, 3
GRAD_TOL, TRAIN_LOSS_RTOL = 1e-4, 1e-4
GRAD_FLIP_TOL, GRAD_FLIP_SHARE = 5e-2, 1.0 / 16
BN_STATS_RTOL = 1e-5
# the backward spans of SameGridConvFn (record_function)
SPANS = ('same_grid_conv_dx', 'same_grid_conv_dw')
METHODS = ('iws', 'elbo', 'zdist', 'mse', 'soft', 'iws-2s', 'elbo-2s')
# phase 6: the flagship's test set and three same-size companions, as
# the registry gives them (10,000 images each), at test batch 512
OOD_SETS = ('cifar10', 'svhn', 'lsunc')
OOD_SET_SIZE, OOD_BATCH = 10000, 512
ROC_TOL = 1e-6
ODIN_BATCH, ODIN_TEMPS, ODIN_EPS, ODIN_TOL = 64, [1, 1000], [0.0, 0.002], 1e-4
CLI_SIZE = 2048
# phase 7: bench.py's train path in bfloat16 (bench.py:99), fed from the
# card: CIFAR-100-train's size as uint8, batch 1024 (train) and 512
# (pipeline); the bfloat16 gate's constants (tests/test_torch_bf16.py)
BENCH_SET = 50000
BENCH_BATCHES = {'train': 1024, 'pipeline': 512}
GATE_A, GATE_B = 2.0, 2.5e-4
SERVE_GATE_N = 32
BF16_CLI_SIZE = 4096


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device ms per call over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def same_grid_sites(model, n_images: int, L: int):
    """Every launch site of the same-grid kernel on the serving path, as a
    dict: the stack's batch n, the input grid, the layer, its route
    ('same_grid' or 'subpixel') and the kernel's pad."""
    sites = []
    for stack_name, n in (('features_stack', n_images), ('imager', L * n_images)):
        stack = getattr(model, stack_name)
        c, h, w = stack.input_shape
        for i, pl in enumerate(stack.plans):
            if pl.ltype in ('conv', 'deconv'):
                layer = getattr(stack, '{}_{}'.format(pl.ltype, i))
                if layer.route in ('same_grid', 'subpixel'):
                    sites.append({'site': '{}.{}_{}'.format(stack_name, pl.ltype, i),
                                  'route': layer.route, 'layer': layer,
                                  'n': n, 'h': h, 'w': w, 'ci': c,
                                  'co': pl.out_channels, 'k': pl.kernel_size,
                                  'lo': layer.pads[0]})
            c, h, w = pl.out_shape
    return sites


def site_inputs(site, dt, g):
    """x (n, h, w, ci), the HWIO kernel and the kernel the site launches
    (for 'subpixel', the packed gather of the HWIO kernel)."""
    from joint_vae_tpu_torch.models.conv import _packed_kernel
    n, h, w, ci, co, k = (site[key] for key in ('n', 'h', 'w', 'ci', 'co', 'k'))
    x = torch.rand((n, h, w, ci), generator=g, device='cuda').to(dt)
    kern = (torch.randn((k, k, ci, co), generator=g, device='cuda')
            / (k * k * ci) ** 0.5).to(dt)
    if site['route'] == 'subpixel':
        tap = site['layer'].tap.to('cuda')
        return x, kern, _packed_kernel(kern, tap, tap).contiguous()
    return x, kern, kern


def check_conv(sites):
    """Each site in float32 and bfloat16: kernel vs plain version, then the
    kernel, the plain version and the library call timed.  The library
    call is F.conv2d for a same-grid site and F.conv_transpose2d of the
    true deconv for a sub-pixel site.  FLOPs count the packed conv as
    launched; the true (de)conv's FLOPs are printed beside them."""
    import torch.nn.functional as F
    from joint_vae_tpu_torch.ops.same_grid_conv import (same_grid_conv,
                                                        same_grid_conv_plain)
    g = torch.Generator(device='cuda').manual_seed(1)
    rows, total = [], {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0,
                       'bound_ms': 0.0, 'bound_ms_cuda_core': 0.0,
                       'max_abs_err': 0.0, 't_bytes': 0.0, 't_ops': 0.0}
    for site in sites:
        name, lo, lay = site['site'], site['lo'], site['layer']
        for dt in (torch.float32, torch.bfloat16):
            x, kern, kd = site_inputs(site, dt, g)
            n, h, w, ci = x.shape
            th, tw, _, co = kd.shape
            y = same_grid_conv(x, kd, lo, lo)
            ref = same_grid_conv_plain(x, kd, lo, lo)
            torch.cuda.synchronize()
            err, rel = rel_err(y, ref)
            tol = CONV_TOL[dt]
            torch.testing.assert_close(
                y.float(), ref.float(), rtol=tol,
                atol=tol * ref.float().square().mean().sqrt().item(),
                msg=lambda m: 'same_grid_conv {} {}: {}'.format(name, dt, m))
            xc = x.permute(0, 3, 1, 2)
            if site['route'] == 'subpixel':
                wc = torch.flip(kern, (0, 1)).permute(2, 3, 0, 1)
                lib_fn = lambda: F.conv_transpose2d(
                    xc, wc, stride=lay.stride, padding=lay.padding,
                    output_padding=lay.output_padding)
            else:
                wc = kern.permute(3, 2, 0, 1)
                lib_fn = lambda: F.conv2d(xc, wc, padding=lo)
            reps = 20 if n * h * w < 2 ** 20 else 5
            ms = time_ms(lambda: same_grid_conv(x, kd, lo, lo), reps)
            plain = time_ms(lambda: same_grid_conv_plain(x, kd, lo, lo), 3, 1)
            lib = time_ms(lib_fn, reps)
            es = x.element_size()
            nbytes = (x.numel() + kd.numel() + n * h * w * co) * es
            flops = 2.0 * n * h * w * th * tw * ci * co
            k, true_co = site['k'], site['co']
            true_flops = 2.0 * n * h * w * k * k * ci * true_co
            b, by = bound_ms(nbytes, flops, PEAK_FLOPS[dt])
            row = {'site': name, 'route': site['route'],
                   'dtype': str(dt).split('.')[-1],
                   'launched_shape': [n, h, w, ci, co, th, tw],
                   'ms': ms, 'plain_ms': plain, 'library_ms': lib,
                   'bound_ms': b, 'bound_by': by,
                   'gflop_launched': flops / 1e9, 'gflop_true': true_flops / 1e9,
                   'max_abs_err': err, 'rel_err': rel,
                   'tflops': flops / ms / 1e9}
            if dt == torch.float32:
                row['bound_ms_cuda_core'] = max(
                    nbytes / HBM_BYTES_PER_S, flops / CUDA_CORE_FLOPS) * 1e3
            if co < 8:
                # the path dispatched at co < 8 against the 8-wide
                # tensor-core tile: the kernel zero-padded to 8 channels
                kd8 = F.pad(kd, (0, 8 - co)).contiguous()
                y8 = same_grid_conv(x, kd8, lo, lo)[..., :co]
                torch.testing.assert_close(
                    y8.float(), ref.float(), rtol=tol,
                    atol=tol * ref.float().square().mean().sqrt().item())
                row['co8_tensor_core_ms'] = time_ms(
                    lambda: same_grid_conv(x, kd8, lo, lo), reps)
                del kd8, y8
            rows.append(row)
            print('conv', json.dumps(row), flush=True)
            if dt == torch.float32:       # the serving path is float32
                for key in ('ms', 'plain_ms', 'library_ms', 'bound_ms',
                            'bound_ms_cuda_core'):
                    total[key] += row[key]
                total['max_abs_err'] = max(total['max_abs_err'], err)
                total['t_bytes'] += nbytes / HBM_BYTES_PER_S * 1e3
                total['t_ops'] += flops / PEAK_FLOPS[dt] * 1e3
            del x, kern, kd, y, ref, xc, wc
            torch.cuda.empty_cache()
    return rows, total


def check_tail_conv(sites) -> float:
    """The conv at every site for the OOD evaluation's ragged last batch
    (10,000 = 19 x 512 + 272 images: n=272 at the features, 16 x 272 =
    4,352 at the decoder), float32, against its plain version in the
    conv's form.  Returns the largest error."""
    from joint_vae_tpu_torch.ops.same_grid_conv import (same_grid_conv,
                                                        same_grid_conv_plain)
    g = torch.Generator(device='cuda').manual_seed(6)
    worst = 0.0
    for site in sites:
        x, _, kd = site_inputs(site, torch.float32, g)
        lo = site['lo']
        y = same_grid_conv(x, kd, lo, lo)
        ref = same_grid_conv_plain(x, kd, lo, lo)
        conv_gate(y, ref, 'same_grid_conv at the ragged tail ' + site['site'])
        err = (y - ref).abs().max().item()
        worst = max(worst, err)
        print('conv_tail', json.dumps({
            'site': site['site'], 'launched_shape': list(x.shape) + list(kd.shape),
            'max_abs_err': err}), flush=True)
        del x, kd, y, ref
    torch.cuda.empty_cache()
    return worst


def sass_counts(name: str) -> dict:
    """Tensor-core instructions in the built library, by opcode and by
    kernel (``cuobjdump -sass``): HMMA (mma.sync) and HGMMA (wgmma)."""
    import re
    import shutil
    from joint_vae_tpu_torch.ops import cuda_lib
    tool = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin',
                        'cuobjdump')
    if not os.path.exists(tool):
        tool = shutil.which('cuobjdump')
    out = subprocess.run([tool, '-sass', cuda_lib.library_path(name)],
                         check=True, capture_output=True, text=True).stdout
    by_kernel, fn = {}, None
    for line in out.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            fn = m.group(1)
            by_kernel[fn] = {}
            continue
        m = re.search(r'\b(HG?MMA\.[\w.]+)', line)
        if m and fn is not None:
            op = m.group(1)
            by_kernel[fn][op] = by_kernel[fn].get(op, 0) + 1
    ops = {}
    for counts in by_kernel.values():
        for op, c in counts.items():
            ops[op] = ops.get(op, 0) + c
    return {'library': name, 'by_opcode': ops, 'by_kernel': by_kernel}


# the combine's cases: (L, N, C, K, mean scale, modes).  The flagship
# serve point in both modes, a ragged one, the ragged last batch of a
# 10,000-image set at batch 512 (the OOD evaluation's, N=272), the
# flagship's prior scale (init_mean=17), the reference's eval L=128 at a
# scorer batch of 64 and of 512, the imagenet64 geometry (C=1000,
# K=256), and C=1 at the WIM evaluation's batch of 256 with the
# alternate prior's scale (init_mean 8): a class-conditional one-mean
# alternate prior (force_conditional, which load_wim_job restores)
# reaches the kernel there
IWS_CASES = ((16, 512, 100, 128, 0.1, (True, False)),
             (16, 137, 37, 128, 0.1, (True, False)),
             (16, 272, 100, 128, 0.1, (True, False)),
             (16, 512, 100, 128, 17.0, (True, False)),
             (128, 64, 100, 128, 0.1, (True,)),
             (128, 512, 100, 128, 0.1, (True,)),
             (16, 512, 1000, 256, 0.1, (True,)),
             (16, 256, 1, 128, 8.0, (True, False)))
LANES_PER_SM, SM_CLOCK_HZ = 128, 1.98e9     # float32 lanes, H100 SXM boost


def iws_inputs(L: int, N: int, C: int, K: int, g: torch.Generator,
               mean_scale: float = 0.1) -> tuple:
    """Combine inputs whose log-weights spread by a few units over l, so
    that the online sum, not the max alone, carries the result: z within
    0.3 of its class mean (means ``mean_scale`` N(0,1) per latent: 0.1,
    or 17 as the flagship's prior draws them), log_pxq about -1e3 with
    noise of a scale drawn per input in [0.25, 2.5] (so that the sum term
    still spreads across inputs at L=128).  Returns the kernel's five
    inputs and each input's class."""
    mean = mean_scale * torch.randn((C, K), generator=g, device='cuda')
    y = torch.randint(0, C, (N,), generator=g, device='cuda')
    z = (mean[y][None] + 0.3 * torch.randn((L, N, K), generator=g,
                                           device='cuda')).contiguous()
    sd = 0.25 + 2.25 * torch.rand((N,), generator=g, device='cuda')
    lp = -1e3 + sd * torch.randn((L, N), generator=g, device='cuda')
    vp = 0.5 + torch.rand((C,), generator=g, device='cuda')
    return (z, lp, mean, vp * vp, -2.0 * K * torch.log(vp)), y


def graph_ms(fn, reps: int) -> float:
    """Mean device ms per call with the host taken out: ``reps`` calls
    captured in one CUDA graph, replayed and timed with CUDA events."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='relaxed'):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def iws_composite(z, lp, mean, s2, ldp, ref_mode=True):
    """What the JAX package's default path computes for this function: the
    all-classes prior density through the matmul expansion
    (``prior_log_density(all_classes=True)``), then amax / exp / mean as
    ``models/evaluate.py`` does off the kernel.  A yardstick only."""
    from joint_vae_tpu_torch.ops.priors import PriorConfig, prior_log_density
    C, K = mean.shape
    cfg = PriorConfig(dim=K, num_priors=C, var_dim='scalar',
                      force_conditional=True)
    params = {'mean': mean, 'var_param': torch.sqrt(s2)}
    liw = lp[:, None] + torch.movedim(
        prior_log_density(cfg, params, z, all_classes=True), 0, 1)
    m = torch.amax(liw, dim=0)
    d = torch.exp(liw - m[None])
    return (torch.mean(d, dim=0) + m) if ref_mode \
        else torch.log(torch.mean(d, dim=0)) + m


def time_iws(iws_combine, args, ref_mode) -> dict:
    """The kernel's device ms with the host taken out (``ms``) and the
    wrapper's ms per call launched back to back, host included, as a
    caller sees it (``call_ms``)."""
    fn = lambda: iws_combine(*args, ref_mode=ref_mode)
    return {'ms': graph_ms(fn, 50), 'call_ms': time_ms(fn, 50)}


def check_iws():
    from joint_vae_tpu_torch.ops.iws import (iws_combine, iws_combine_plain,
                                             iws_log_weights, kernel_splits)
    g = torch.Generator(device='cuda').manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, main = [], None
    for (L, N, C, K, scale, modes) in IWS_CASES:
        args, y = iws_inputs(L, N, C, K, g, scale)
        max_l = torch.amax(iws_log_weights(*args), dim=0)
        big = L * C * N * K > 2 ** 30
        for ref_mode in modes:
            out = iws_combine(*args, ref_mode=ref_mode)
            ref = iws_combine_plain(*args, ref_mode=ref_mode)
            torch.cuda.synchronize()
            # the sum term: mean-exp in [1/L, 1], or log-mean-exp in
            # [-log L, 0]; a wrong rescale, divisor or dropped sum is off
            # by a share of it, tens of times the tolerance.  At the prior
            # scale 17 only the true class's weights are close enough over
            # l to carry a sum term; the spread is read there
            sum_term = ref - max_l
            if scale > 1:
                sum_term = sum_term[y, torch.arange(N, device='cuda')]
            spread = sum_term.std().item()
            if not spread >= IWS_MIN_SPREAD:
                raise AssertionError('iws inputs: the sum term spreads by {} '
                                     '< {}'.format(spread, IWS_MIN_SPREAD))
            err = (out - ref).abs().max().item()
            torch.testing.assert_close(
                out, ref, rtol=IWS_RTOL, atol=IWS_ATOL,
                msg=lambda m: 'iws_combine {}: {}'.format(
                    (L, N, C, K, scale, ref_mode), m))
            comp = iws_composite(*args, ref_mode=ref_mode)
            comp_dev = (comp - ref).abs()
            t = time_iws(iws_combine, args, ref_mode)
            plain = time_ms(lambda: iws_combine_plain(*args, ref_mode=ref_mode),
                            3 if big else 10, 1)
            lib_call = time_ms(lambda: iws_composite(*args, ref_mode=ref_mode),
                               20)
            lib = graph_ms(lambda: iws_composite(*args, ref_mode=ref_mode),
                           5 if big else 20)
            nbytes = 4.0 * (sum(a.numel() for a in args) + C * N)
            flops = 3.0 * L * C * N * K         # (z - m), then an FMA
            b, by = bound_ms(nbytes, flops, CUDA_CORE_FLOPS)
            row = {'shape': [L, N, C, K], 'mean_scale': scale,
                   'ref_mode': ref_mode, 'splits': kernel_splits(L, N, K, C),
                   'ms': t['ms'], 'call_ms': t['call_ms'], 'plain_ms': plain,
                   'library_ms': lib, 'library_call_ms': lib_call,
                   'library': 'composite: prior_log_density(all_classes=True) '
                              '(matmul expansion) + amax/exp/mean',
                   'library_max_abs_dev': comp_dev.max().item(),
                   'library_max_rel_dev': (comp_dev / ref.abs().clamp_min(1e-30)
                                           ).max().item(),
                   'bound_ms': b, 'bound_by': by,
                   'share_of_bound': b / t['ms'],
                   'floor_2instr_ms': 2.0 * L * C * N * K / (
                       sms * LANES_PER_SM * SM_CLOCK_HZ) * 1e3,
                   'max_abs_err': err,
                   'sum_term': [sum_term.min().item(), sum_term.max().item()],
                   'sum_term_std': spread}
            rows.append(row)
            print('iws', json.dumps(row), flush=True)
            if (L, N, C, K, scale) == (16, 512, 100, 128, 0.1) and ref_mode:
                main = row                     # the flagship's mode
            del out, ref, comp, comp_dev
        del args, y, max_l
        torch.cuda.empty_cache()
    return rows, main


def profile_batch(scorer, x) -> dict:
    """Device time of one Scorer batch by kernel (torch.profiler), and the
    device's busy share of the batch's wall time."""
    from torch.profiler import ProfilerActivity, profile
    scorer(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue                # operators: their kernels are listed too
        dev_us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.key[:60], ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    dgrad = [k for _, k, _ in rows if 'dgrad' in k.lower()]
    if dgrad:
        raise AssertionError('the serve batch still runs a transposed conv '
                             'on cuDNN: {}'.format(dgrad))
    return {'wall_ms': wall_ms, 'device_ms': busy,
            'device_busy_share': busy / wall_ms if wall_ms else None,
            'top': [{'ms': ms, 'kernel': k, 'calls': c}
                    for ms, k, c in rows[:12]]}


def serve(card: str):
    """Phase 4: the flagship through save_job, the CLI and Scorer."""
    from joint_vae_tpu_torch.cli.serve import main as cli_main
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.models.evaluate import evaluate
    from joint_vae_tpu_torch.ops.iws import iws_combine
    from joint_vae_tpu_torch.ops.same_grid_conv import same_grid_conv
    from joint_vae_tpu_torch.save_load.jobs import load_job, new_job, save_job
    from joint_vae_tpu_torch.serve import Scorer

    cfg = flagship_config()
    job_dir = os.path.join(WORK, 'flagship_job')
    save_job(new_job(cfg, seed=0, device='cuda'), job_dir)
    job = load_job(job_dir)                   # default device: the card
    n_params = sum(p.numel() for p in job.model.parameters())
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 1, (BATCHES + 1, BATCH) + cfg.input_shape).astype(np.float32)
    npy = os.path.join(WORK, 'inputs.npy')
    np.save(npy, xs[0, :64])
    cli_out = os.path.join(WORK, 'cli.jsonl')

    same_grid_conv.launches = 0
    iws_combine.launches = 0
    # --- the main path: CLI then Scorer ---
    t0 = time.perf_counter()
    rc = cli_main([job_dir, npy, '--batch-size', '64', '--methods', 'iws',
                   'elbo', '--output', cli_out])
    cli_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError('serve CLI exited {}'.format(rc))
    with open(cli_out) as f:
        lines = [json.loads(s) for s in f]
    if len(lines) != 65 or not lines[-1].get('summary'):
        raise AssertionError('serve CLI wrote {} lines'.format(len(lines)))
    for rec in lines[:-1]:
        vals = [rec['confidence']] + list(rec['scores'].values())
        if not np.all(np.isfinite(vals)):
            raise AssertionError('non-finite CLI record {}'.format(rec))

    calib = Scorer(job, methods=METHODS,
                   thresholds={m: float('-inf') for m in METHODS})(xs[0])
    thresholds = {}
    for m in METHODS:
        s = calib['scores'][m]
        thresholds[m] = ((float(np.quantile(s, 0.05)), float(np.quantile(s, 0.95)))
                         if m.endswith('-2s') else float(np.quantile(s, 0.05)))
    scorer = Scorer(job, methods=METHODS, thresholds=thresholds)
    torch.cuda.synchronize()
    outs, batch_ms = [], []
    for b in range(BATCHES):        # Scorer returns host arrays: synchronous
        t0 = time.perf_counter()
        outs.append(scorer(xs[1 + b]))
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    serve_s = sum(batch_ms) / 1e3
    launches = {'same_grid_conv': same_grid_conv.launches,
                'iws_combine': iws_combine.launches}
    # --- end of the main path ---
    batches = 1 + 1 + BATCHES                # CLI (64 inputs), calibration, timed
    if (launches['same_grid_conv'] != SITES_PER_BATCH * batches
            or launches['iws_combine'] != batches):
        raise AssertionError('launch counts {} for {} serve batches'.format(
            launches, batches))
    for o in outs:
        for m in METHODS:
            if o['scores'][m].shape != (BATCH,) or not np.all(np.isfinite(o['scores'][m])):
                raise AssertionError('bad scores for {}'.format(m))
        if not (np.all(np.isfinite(o['confidence']))
                and o['label'].shape == (BATCH,)
                and np.all((o['label'] >= 0) & (o['label'] < cfg.num_labels))):
            raise AssertionError('bad labels/confidence')
    accept = float(np.mean([o['in_distribution'].mean() for o in outs]))
    img_s = BATCH * BATCHES / serve_s

    # --- the reference's eval point: Scorer batches of 64 at L=128 ---
    scorer128 = Scorer(job, methods=METHODS, thresholds=thresholds, L=L_EVAL)
    same_grid_conv.launches = 0
    iws_combine.launches = 0
    outs128, ms128 = [], []
    for _ in range(2):              # the first one meets new shapes
        t0 = time.perf_counter()
        outs128.append(scorer128(xs[2, :BATCH_EVAL]))
        ms128.append((time.perf_counter() - t0) * 1e3)
    launches128 = {'same_grid_conv': same_grid_conv.launches,
                   'iws_combine': iws_combine.launches}
    # --- end of the L=128 path ---
    if launches128 != {'same_grid_conv': 2 * SITES_PER_BATCH, 'iws_combine': 2}:
        raise AssertionError('launch counts {} for 2 batches at L={}'.format(
            launches128, L_EVAL))
    for o in outs128:
        for m in METHODS:
            if (o['scores'][m].shape != (BATCH_EVAL,)
                    or not np.all(np.isfinite(o['scores'][m]))):
                raise AssertionError('bad scores for {} at L={}'.format(m, L_EVAL))
        if not np.all(np.isfinite(o['confidence'])):
            raise AssertionError('bad confidence at L={}'.format(L_EVAL))
    eval128 = {'L': L_EVAL, 'batch': BATCH_EVAL, 'batch_ms': ms128,
               'launches': launches128}
    print('serve_l128', json.dumps(eval128), flush=True)

    breakdown = profile_batch(scorer, xs[1])

    # --- card vs CPU on 8 inputs with injected noise ---
    L, K, n8 = cfg.test_latent_sampling, cfg.latent_dim, 8
    eps = np.random.default_rng(3).standard_normal((L + 1, n8, K)).astype(np.float32)
    eps[0] = 0.0
    x8 = xs[1, :n8]
    cpu_job = load_job(job_dir, device='cpu')
    res = {}
    for name, j in (('cuda', job), ('cpu', cpu_job)):
        out = evaluate(j.model, torch.as_tensor(x8, device=j.device), None,
                       sigma_state=j.sigma_state, eps=torch.as_tensor(eps),
                       decode_mean=False)
        sc = Scorer(j, methods=METHODS, thresholds=thresholds)(
            x8, eps=torch.as_tensor(eps))
        res[name] = ({k: v.cpu().numpy() for k, v in out.losses.items()}, sc)
    worst, checked = {}, []
    for k, want in res['cpu'][0].items():
        checked.append(('loss ' + k, res['cuda'][0][k], want))
    for m in METHODS:
        checked.append(('score ' + m, res['cuda'][1]['scores'][m],
                        res['cpu'][1]['scores'][m]))
    for name, got, want in checked:
        err = np.abs(got.astype(np.float64) - want)
        worst[name] = float(np.max(err / np.maximum(np.abs(want), 1e-30)))
        np.testing.assert_allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL,
                                   err_msg='card vs CPU, ' + name)
    iws_cpu = res['cpu'][0]['iws']
    top2 = np.sort(iws_cpu, axis=0)[-2:]
    clear = (top2[1] - top2[0]) > 2 * (SERVE_ATOL + SERVE_RTOL * np.abs(top2[1]))
    if not np.array_equal(res['cpu'][1]['label'][clear],
                          res['cuda'][1]['label'][clear]):
        raise AssertionError('card and CPU labels differ')
    summary = {'params': n_params, 'cli_seconds': cli_s,
               'serve_images_per_s': img_s, 'batch_ms': batch_ms,
               'batch': BATCH, 'batches': BATCHES,
               'L': L, 'accept_rate': accept,
               'card_vs_cpu_worst_elementwise_rel_err': worst,
               'card': card, 'profile': breakdown, 'l128': eval128}
    print('serve', json.dumps(summary), flush=True)
    return launches, launches128, summary


def conv_gate(got, want, what, dt=torch.float32):
    """The conv's form: |got - want| <= tol (|want| + rms(want)), tol the
    float32 one unless ``dt`` says otherwise."""
    tol = CONV_TOL[dt]
    torch.testing.assert_close(
        got.float(), want.float(), rtol=tol,
        atol=tol * want.float().square().mean().sqrt().item(),
        msg=lambda m: '{}: {}'.format(what, m))


def cudnn_wgrad(x, g, th, tw, lo):
    """cuDNN's float32 weight gradient of the same-grid conv (the library
    call for dw), HWIO."""
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    w = x.new_empty((g.shape[3], x.shape[3], th, tw))
    _, dw, _ = torch.ops.aten.convolution_backward(
        gc, xc, w, None, (1, 1), (lo, lo), (1, 1), False, (0, 0), 1,
        (False, True, False))
    return dw.permute(2, 3, 1, 0)


def dw_gate(dw, dw64, what, dt):
    """The weight gradient against the float64 product of the same
    inputs: float32 in the conv's float32 form; bfloat16, summed in
    float32 and rounded once, within half a bfloat16 ulp (2^-8 |want|)
    plus the float32 form's absolute term."""
    if dt == torch.float32:
        conv_gate(dw, dw64, what)
        return
    bound = (2.0 ** -8 * dw64.abs()
             + CONV_TOL[torch.float32] * dw64.square().mean().sqrt())
    bad = int(((dw.double() - dw64).abs() > bound).sum())
    if bad:
        raise AssertionError('{}: {} elements beyond one bfloat16 rounding '
                             'of the float64 sum'.format(what, bad))


def check_train_conv(sites, dt=torch.float32):
    """The same-grid conv at the train step's shapes (batch 1024, L=1) in
    ``dt``: the forward at every site against its plain version (timed
    beside cuDNN's forward, ``F.conv2d`` of the launched kernel); at the
    sites whose input needs a gradient the dx kernel against its plain
    version (``library_ms``: cuDNN's data gradient of the same conv,
    ``torch.nn.grad.conv2d_input``), and the weight gradient (an im2col
    product summed in float32) against the same product in float64
    (:func:`dw_gate`), timed beside cuDNN's weight gradient in ``dt``,
    whose error against float64 is printed (not gated)."""
    import torch.nn.functional as F
    from joint_vae_tpu_torch.ops.same_grid_conv import (
        same_grid_conv, same_grid_conv_dw, same_grid_conv_dx,
        same_grid_conv_dx_plain, same_grid_conv_plain)
    g_cuda = torch.Generator(device='cuda').manual_seed(3)
    tag = '' if dt == torch.float32 else '_bf16'
    es = torch.empty((), dtype=dt).element_size()
    fwd_rows, dx_rows = [], []
    keys = ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'dw_ms',
            'dw_cudnn_ms', 't_bytes', 't_ops')
    total = {'fwd_ms': 0.0, 'fwd_max_abs_err': 0.0, 'max_abs_err': 0.0,
             'fwd_bound_ms': 0.0, 'fwd_t_bytes': 0.0, 'fwd_t_ops': 0.0,
             'fwd_plain_ms': 0.0, 'fwd_library_ms': 0.0,
             'dw_max_rel_err': 0.0, 'dw_cudnn_max_rel_err': 0.0,
             **{k: 0.0 for k in keys}}
    for j, site in enumerate(sites):
        name, lo = site['site'], site['lo']
        x, kern, kd = site_inputs(site, dt, g_cuda)
        n, h, w, ci = x.shape
        th, tw, _, co = kd.shape
        y = same_grid_conv(x, kd, lo, lo)
        ref = same_grid_conv_plain(x, kd, lo, lo)
        conv_gate(y, ref, 'train forward {} {}'.format(name, dt), dt)
        fwd_err = (y.float() - ref.float()).abs().max().item()
        fwd_ms = time_ms(lambda: same_grid_conv(x, kd, lo, lo), 10)
        fwd_plain = time_ms(lambda: same_grid_conv_plain(x, kd, lo, lo), 2, 1)
        xc, wk = x.permute(0, 3, 1, 2), kd.permute(3, 2, 0, 1)
        fwd_lib = time_ms(lambda: F.conv2d(xc, wk, padding=lo), 10)
        fwd_bytes = es * (x.numel() + kd.numel() + n * h * w * co)
        fwd_flops = 2.0 * n * h * w * th * tw * ci * co
        fb, fby = bound_ms(fwd_bytes, fwd_flops, PEAK_FLOPS[dt])
        fwd_rows.append({'site': name, 'launched_shape': [n, h, w, ci, co, th, tw],
                         'dtype': str(dt).split('.')[-1], 'ms': fwd_ms,
                         'plain_ms': fwd_plain, 'library_ms': fwd_lib,
                         'bound_ms': fb, 'bound_by': fby,
                         'max_abs_err': fwd_err})
        print('train_conv' + tag, json.dumps(fwd_rows[-1]), flush=True)
        total['fwd_ms'] += fwd_ms
        total['fwd_plain_ms'] += fwd_plain
        total['fwd_library_ms'] += fwd_lib
        total['fwd_bound_ms'] += fb
        total['fwd_t_bytes'] += fwd_bytes / HBM_BYTES_PER_S * 1e3
        total['fwd_t_ops'] += fwd_flops / PEAK_FLOPS[dt] * 1e3
        total['fwd_max_abs_err'] = max(total['fwd_max_abs_err'], fwd_err)
        del y, ref
        if j == 0:
            continue              # features conv_0 reads the data: no dx
        g = (0.05 * torch.randn((n, h, w, co), generator=g_cuda,
                                device='cuda')).to(dt)
        dx = same_grid_conv_dx(g, kd, lo, lo)
        dx_ref = same_grid_conv_dx_plain(g, kd, lo, lo)
        conv_gate(dx, dx_ref, 'dx {} {}'.format(name, dt), dt)
        dw = same_grid_conv_dw(x, g, th, tw, lo, lo)
        dw64 = same_grid_conv_dw(x.double(), g.double(), th, tw, lo, lo)
        dw_gate(dw, dw64, 'dw {} {}'.format(name, dt), dt)
        rms64 = dw64.square().mean().sqrt().item()
        dw_cudnn = cudnn_wgrad(x, g, th, tw, lo)
        wc = kd.permute(3, 2, 0, 1).contiguous()
        gc = g.permute(0, 3, 1, 2)
        ms = time_ms(lambda: same_grid_conv_dx(g, kd, lo, lo), 10)
        plain = time_ms(lambda: same_grid_conv_dx_plain(g, kd, lo, lo), 3, 1)
        lib = time_ms(lambda: torch.nn.grad.conv2d_input(
            (n, ci, h, w), wc, gc, padding=lo), 10)
        dw_ms = time_ms(lambda: same_grid_conv_dw(x, g, th, tw, lo, lo), 5)
        dw_cudnn_ms = time_ms(lambda: cudnn_wgrad(x, g, th, tw, lo), 5)
        nbytes = es * (g.numel() + kd.numel() + x.numel())
        flops = 2.0 * n * h * w * th * tw * ci * co
        b, by = bound_ms(nbytes, flops, PEAK_FLOPS[dt])
        row = {'site': name, 'dx_shape': [n, h, w, co, ci, th, tw],
               'dtype': str(dt).split('.')[-1],
               'ms': ms, 'plain_ms': plain, 'library_ms': lib,
               'bound_ms': b, 'bound_by': by, 'share_of_bound': b / ms,
               'max_abs_err': (dx.float() - dx_ref.float()).abs().max().item(),
               'tflops': flops / ms / 1e9,
               'dw_ms': dw_ms, 'dw_cudnn_ms': dw_cudnn_ms,
               'dw_max_rel_err': (dw.double() - dw64).abs().max().item() / rms64,
               'dw_cudnn_max_rel_err':
                   (dw_cudnn.double() - dw64).abs().max().item() / rms64}
        dx_rows.append(row)
        print('dx' + tag, json.dumps(row), flush=True)
        for key in ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'dw_ms',
                    'dw_cudnn_ms'):
            total[key] += row[key]
        total['t_bytes'] += nbytes / HBM_BYTES_PER_S * 1e3
        total['t_ops'] += flops / PEAK_FLOPS[dt] * 1e3
        for key in ('max_abs_err', 'dw_max_rel_err', 'dw_cudnn_max_rel_err'):
            total[key] = max(total[key], row[key])
        del x, kern, kd, g, dx, dx_ref, dw, dw64, dw_cudnn, wc, gc, xc, wk
        torch.cuda.empty_cache()
    if len(dx_rows) != DX_PER_STEP:
        raise AssertionError('{} dx sites'.format(len(dx_rows)))
    return fwd_rows, dx_rows, total


def check_library_convs(model, n: int) -> list:
    """The model's convs that stay on the library ('conv' route: the
    strided ones and conv_4) at the train step's shapes: cuDNN's float32
    data and weight gradients (what the port runs) against float64 on the
    CPU, held to the conv's float32 form, and timed."""
    import torch.nn.functional as F
    gen = torch.Generator(device='cuda').manual_seed(4)
    stack = model.features_stack
    c, h, w = stack.input_shape
    rows = []
    for i, pl in enumerate(stack.plans):
        layer = getattr(stack, 'conv_{}'.format(i), None)
        if layer is not None and layer.route == 'conv':
            k, s_, lo = pl.kernel_size, pl.stride, layer.pads[0]
            co, oh, ow = pl.out_shape
            x = torch.rand((n, c, h, w), generator=gen, device='cuda')
            wt = (torch.randn((co, c, k, k), generator=gen, device='cuda')
                  / (k * k * c) ** 0.5)
            g = 0.05 * torch.randn((n, co, oh, ow), generator=gen, device='cuda')

            def grads(dev, dt):
                xk = [x.to(dev, dt).requires_grad_(), wt.to(dev, dt).requires_grad_()]
                y = F.conv2d(xk[0], xk[1], stride=s_, padding=lo)
                return torch.autograd.grad(y, xk, g.to(dev, dt))
            dx, dw = grads('cuda', torch.float32)
            dx64, dw64 = (t.to('cuda') for t in grads('cpu', torch.float64))
            conv_gate(dx, dx64, 'library conv dx conv_{}'.format(i))
            conv_gate(dw, dw64, 'library conv dw conv_{}'.format(i))
            rel = lambda a, b: ((a - b).abs().max().item()
                                / b.square().mean().sqrt().item())
            row = {'site': 'features_stack.conv_{}'.format(i),
                   'shape': [n, h, w, c, co, k, s_],
                   'ms': time_ms(lambda: grads('cuda', torch.float32), 5),
                   'dx_max_rel_err': rel(dx, dx64),
                   'dw_max_rel_err': rel(dw, dw64)}
            rows.append(row)
            print('library_conv', json.dumps(row), flush=True)
            del x, g, dx, dw, dx64, dw64
            torch.cuda.empty_cache()
        c, h, w = pl.out_shape
    return rows


def _bucket(name: str) -> str:
    low = name.lower()
    if 'tc_conv_kernel' in low or 'simt_conv_kernel' in low:
        return 'same_grid_kernel'
    # cuDNN's convolution kernels before cuBLAS's: both hold 'xmma', and
    # cuDNN's forward is an implicit GEMM by name
    if any(k in low for k in ('fprop', 'dgrad', 'wgrad', 'cudnn', 'conv')):
        return 'cudnn'
    if 'gemm' in low or 'gemv' in low:
        return 'cublas_gemm'
    if 'multi_tensor' in low or 'foreach' in low:
        return 'optimizer_foreach'
    if 'memcpy' in low or 'memset' in low:
        return 'copies'
    return 'elementwise_and_reductions'


def profile_train_step(step, state, xb, yb) -> dict:
    """Device time of one train step by kernel (torch.profiler): each
    kernel launched by an operator is given to the backward span it ran
    in (SPANS: the same-grid dx and dw) or else to a group by its name —
    the same-grid kernel, cuDNN (the strided convs, both directions),
    cuBLAS, the optimizer's foreach kernels, copies, the rest (elementwise
    and reductions); the busy share; and the host's time by operator.
    The same-grid kernel's own launches come from outside PyTorch's
    operators (ctypes), so its forward and dx launches both land in the
    'same_grid_kernel' group; phase 5's per-site times split them."""
    from torch.profiler import ProfilerActivity, profile
    step(state, xb, yb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, xb, yb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_span = {}

    def walk(ev, span):
        span = ev.name if ev.name in SPANS else span
        for k in getattr(ev, 'kernels', ()):
            group = span or _bucket(k.name)
            by_span[group] = by_span.get(group, 0.0) + k.duration / 1e3
        for c in ev.cpu_children:
            walk(c, span)
    for ev in prof.events():
        if (ev.cpu_parent is None
                and ev.device_type != torch.autograd.DeviceType.CUDA):
            walk(ev, None)
    kernels = []
    for ev in prof.key_averages():
        dev_self = getattr(ev, 'self_device_time_total',
                           getattr(ev, 'self_cuda_time_total', 0)) / 1e3
        if (ev.device_type == torch.autograd.DeviceType.CUDA and dev_self > 0
                and ev.key not in SPANS):
            kernels.append((dev_self, ev.key[:80], ev.count))
    kernels.sort(reverse=True)
    by_name = {}
    for ms, key, _ in kernels:
        by_name[_bucket(key)] = by_name.get(_bucket(key), 0.0) + ms
    busy = sum(k[0] for k in kernels)
    host = sorted(((ev.self_cpu_time_total / 1e3, ev.key[:60], ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type != torch.autograd.DeviceType.CUDA),
                  reverse=True)
    return {'wall_ms': wall_ms, 'device_ms': busy,
            'device_busy_share': busy / wall_ms if wall_ms else None,
            'by_span_ms': by_span, 'by_name_ms': by_name,
            'top': [{'ms': ms, 'kernel': k, 'calls': c}
                    for ms, k, c in kernels[:16]],
            'host_self_ms': sum(h[0] for h in host),
            'top_host': [{'ms': ms, 'op': k, 'calls': c}
                         for ms, k, c in host[:16]]}


def check_grads(grads: dict) -> tuple:
    """Card against CPU gradients per tensor (the module docstring's
    training gate); returns the worst ratio and the tensors with elements
    beyond the strict tolerance."""
    worst, loose = 0.0, {}
    for k, want in grads['cpu'].items():
        got = grads['cuda'][k]
        rms = want.square().mean().sqrt().item()
        ratio = (got - want).abs() / (want.abs() + rms + 1e-30)
        worst = max(worst, ratio.max().item())
        n_loose = int((ratio > GRAD_TOL).sum())
        if n_loose:
            loose[k] = {'elements': n_loose, 'of': ratio.numel(),
                        'worst': ratio.max().item()}
        if (n_loose > GRAD_FLIP_SHARE * ratio.numel()
                or ratio.max().item() > GRAD_FLIP_TOL):
            raise AssertionError('card vs CPU gradient {}: {} of {} elements '
                                 'beyond {}, worst {}'.format(
                                     k, n_loose, ratio.numel(), GRAD_TOL,
                                     ratio.max().item()))
    return worst, loose


def _rms_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def train_gate(cfg, batch: int = GATE_BATCH, trunk: bool = False) -> dict:
    """The full-width model of ``cfg`` at ``batch`` from one init (a
    numpy seed), with the same batch and the same injected noise, on the
    card and on the CPU: the first step's gradients per tensor, then the
    losses of 3 steps and, for a model with BatchNorm, its running
    statistics after them.  ``trunk`` (a model with a cuDNN trunk): the
    gradients are reported by their rms-relative error, the trunk's and
    the rest's apart, and so are the statistics after the steps, which
    the gradients move; neither is gated (TRUNK_GRAD_NOTE); the losses
    are."""
    from joint_vae_tpu_torch.models.evaluate import evaluate
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.steps import make_train_step
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (batch,) + cfg.input_shape).astype(np.float32)
    y = rng.integers(0, cfg.num_labels, batch).astype(np.int64)
    eps = rng.standard_normal((cfg.latent_sampling + 1, batch,
                               cfg.latent_dim)).astype(np.float32)
    eps[0] = 0.0
    grads, losses, stats = {}, {}, {}
    relu0_min = None
    for dev in ('cuda', 'cpu'):
        job = new_job(cfg, OptimizerConfig(lr=TRAIN_LR), seed=1, device=dev)
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        et = torch.from_numpy(eps).to(dev)
        params = dict(job.model.named_parameters())
        out = evaluate(job.model, xt, yt, sigma_state=job.sigma_state,
                       train=True, with_beta=True, eps=et)
        got = torch.autograd.grad(torch.mean(out.losses['total']),
                                  list(params.values()), allow_unused=True)
        grads[dev] = {k: (torch.zeros_like(p) if g is None else g).cpu()
                      for (k, p), g in zip(params.items(), got)}
        if dev == 'cpu' and hasattr(job.model.features_stack, 'conv_0'):
            # the conv features' first ReLU input nearest 0
            with torch.no_grad():
                relu0_min = job.model.features_stack.conv_0(
                    xt.permute(0, 2, 3, 1).contiguous()).abs().min().item()
        step = make_train_step(job.model, job.opt_cfg)
        state, seq = job.state, []
        for _ in range(GATE_STEPS):
            state, m = step(state, xt, yt, eps=et)
            seq.append(m['total'].item())
        losses[dev] = seq
        stats[dev] = {k: v.cpu() for k, v in job.model.named_buffers()
                      if k.endswith(('running_mean', 'running_var'))}
    res = {'batch': batch, 'steps': GATE_STEPS}
    if trunk:
        errs = {k: _rms_rel(grads['cuda'][k], want)
                for k, want in grads['cpu'].items()}
        for part, keep in (('trunk', True), ('rest', False)):
            e = {k: v for k, v in errs.items()
                 if k.startswith('features_stack.') == keep}
            res['grad_rms_rel_err_' + part] = {
                'max': max(e.values()), 'median': float(np.median(
                    list(e.values()))),
                'top': sorted(e.items(), key=lambda kv: -kv[1])[:4]}
        res['grads_not_gated'] = TRUNK_GRAD_NOTE
    else:
        (res['grad_worst_err_over_abs_plus_rms'],
         res['grad_beyond_strict_tol']) = check_grads(grads)
    np.testing.assert_allclose(losses['cuda'], losses['cpu'],
                               rtol=TRAIN_LOSS_RTOL, atol=0,
                               err_msg='card vs CPU train losses')
    bn_worst = 0.0
    for k, want in stats['cpu'].items():
        rms = want.square().mean().sqrt().item()
        bn_worst = max(bn_worst, ((stats['cuda'][k] - want).abs()
                                  / (want.abs() + rms + 1e-30)).max().item())
    if bn_worst > BN_STATS_RTOL and not trunk:
        raise AssertionError('card vs CPU BatchNorm statistics: {} relative'
                             .format(bn_worst))
    res.update({'conv_0_relu_input_nearest_zero': relu0_min,
                'bn_stats': len(stats['cpu']),
                'bn_stats_worst_rel_err': bn_worst,
                'losses_cuda': losses['cuda'], 'losses_cpu': losses['cpu'],
                'loss_worst_rel_err': max(abs(a - b) / abs(b) for a, b in
                                          zip(losses['cuda'], losses['cpu']))})
    return res


def train(card: str, cfg=None, sites: int = SITES_PER_BATCH,
          dx: int = DX_PER_STEP, name: str = 'train',
          gate_batch: int = GATE_BATCH, gate_trunk: bool = False):
    """Phase 5: the full-width flagship (or ``cfg``, whose forward
    launches the conv ``sites`` times and its input gradient ``dx`` times
    per step) trained through new_job, train_model, save_job and
    load_job, weights, BatchNorm statistics and optimizer state compared;
    then timed steps, a profile and the card vs CPU gate at
    ``gate_batch``.  Returns the main path's launches, the summary and
    the job."""
    from joint_vae_tpu_torch.data.loaders import ArrayDataset, DataLoader
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.ops.iws import iws_combine
    from joint_vae_tpu_torch.ops.same_grid_conv import (same_grid_conv,
                                                        same_grid_conv_dx)
    from joint_vae_tpu_torch.save_load.jobs import load_job, new_job, save_job
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.steps import make_train_step, pull_metrics
    from joint_vae_tpu_torch.device import to_device
    from joint_vae_tpu_torch.train.trainer import train_model
    from joint_vae_tpu_torch.utils.print_log import EpochOutput

    cfg = cfg or flagship_config()
    rng = np.random.default_rng(7)
    n = TRAIN_BATCH * TRAIN_BATCHES + TRAIN_VALIDATION
    trainset = ArrayDataset(
        rng.uniform(0, 1, (n,) + cfg.input_shape).astype(np.float32),
        rng.integers(0, cfg.num_labels, n), 'synthetic')
    testset = ArrayDataset(
        rng.uniform(0, 1, (TRAIN_TEST,) + cfg.input_shape).astype(np.float32),
        rng.integers(0, cfg.num_labels, TRAIN_TEST), 'synthetic')
    job_dir = os.path.join(WORK, name + '_job')
    job = new_job(cfg, OptimizerConfig(lr=TRAIN_LR), seed=0)   # on the card

    same_grid_conv.launches = 0
    same_grid_conv_dx.launches = 0
    iws_combine.launches = 0
    # --- the main path: train_model, one epoch ---
    t0 = time.perf_counter()
    train_model(job, trainset, testset, epochs=1, batch_size=TRAIN_BATCH,
                test_batch_size=TRAIN_TEST_BATCH, validation=TRAIN_VALIDATION,
                save_dir=job_dir, final_test=False, final_ood=False,
                outputs=EpochOutput(stdout=False))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {'same_grid_conv': same_grid_conv.launches,
                'same_grid_conv_dx': same_grid_conv_dx.launches,
                'iws_combine': iws_combine.launches}
    # --- end of the main path ---
    eval_batches = 2 * (TRAIN_TEST // TRAIN_TEST_BATCH)   # validation + test
    want = {'same_grid_conv': sites * (TRAIN_BATCHES + eval_batches),
            'same_grid_conv_dx': dx * TRAIN_BATCHES,
            'iws_combine': 0}
    if launches != want:
        raise AssertionError('train launch counts {}, expected {}'.format(
            launches, want))
    hist = job.train_history.get(1)
    if job.train_history.get('epochs') != 1 or hist is None:
        raise AssertionError('no history for the epoch')
    for part in ('train_loss', 'validation_loss', 'test_loss'):
        vals = list(hist[part].values())
        if not vals or not np.all(np.isfinite(vals)):
            raise AssertionError('bad {}: {}'.format(part, hist[part]))
    if job.state.step != TRAIN_BATCHES:
        raise AssertionError('{} steps'.format(job.state.step))

    # --- save_job / load_job: weights and optimizer state exactly ---
    save_job(job, job_dir)
    back = load_job(job_dir)
    sd, sd2 = job.model.state_dict(), back.model.state_dict()
    if set(sd) != set(sd2) or not all(torch.equal(sd[k], sd2[k]) for k in sd):
        raise AssertionError('reloaded weights differ')
    o, o2 = job.state.opt_state, back.state.opt_state
    same = ((o.count, o.adam_count, o.learning_rate)
            == (o2.count, o2.adam_count, o2.learning_rate)
            and all(torch.equal(getattr(o, a)[k], getattr(o2, a)[k])
                    for a in ('mu', 'nu', 'trace') for k in getattr(o, a))
            and set(o.mu) == set(o2.mu) and set(o.nu) == set(o2.nu)
            and torch.equal(job.sigma_state.data, back.sigma_state.data)
            and (back.state.epoch, back.state.step)
            == (job.state.epoch, job.state.step))
    if not same:
        raise AssertionError('reloaded optimizer or train state differs')
    del back

    # --- timed steps, fed as train_model feeds them ---
    step = make_train_step(job.model, job.opt_cfg)
    state = job.state
    batches = iter(DataLoader(trainset, TRAIN_BATCH, shuffle=True, seed=1,
                              drop_last=True))
    dev = state.device
    for _ in range(TRAIN_WARMUP):
        xb, yb = next(batches)
        state, m = step(state, to_device(xb, dev), to_device(yb, dev))
    torch.cuda.synchronize()
    same_grid_conv.launches = 0
    same_grid_conv_dx.launches = 0
    pending, staged = [], []
    loader_s = copy_s = 0.0
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        t1 = time.perf_counter()
        xb, yb = next(batches)
        t2 = time.perf_counter()
        xy = (to_device(xb, dev), to_device(yb, dev))
        loader_s += t2 - t1
        copy_s += time.perf_counter() - t2
        state, m = step(state, *xy)
        pending.append(m)
        staged.append(xy)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    timed_launches = {'same_grid_conv': same_grid_conv.launches,
                      'same_grid_conv_dx': same_grid_conv_dx.launches}
    if timed_launches != {'same_grid_conv': sites * TRAIN_TIMED,
                          'same_grid_conv_dx': dx * TRAIN_TIMED}:
        raise AssertionError('timed steps launched {}'.format(timed_launches))
    got = pull_metrics(pending)
    if not all(np.isfinite(list(r.values())).all() for r in got):
        raise AssertionError('non-finite train metrics')
    t0 = time.perf_counter()             # the same batches, already on the card
    for xy in staged:
        state, m = step(state, *xy)
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    xb, yb = next(batches)
    breakdown = profile_train_step(step, state, to_device(xb, dev),
                                   to_device(yb, dev))
    gate = train_gate(cfg, gate_batch, gate_trunk)
    summary = {'batch': TRAIN_BATCH, 'epoch_batches': TRAIN_BATCHES,
               'epoch_seconds': epoch_s,
               'epoch_images_per_s': TRAIN_BATCH * TRAIN_BATCHES / epoch_s,
               'timed_steps': TRAIN_TIMED, 'warmup_steps': TRAIN_WARMUP,
               'ms_per_step': timed_s * 1e3 / TRAIN_TIMED,
               'train_images_per_s': TRAIN_BATCH * TRAIN_TIMED / timed_s,
               'loader_ms_per_batch': loader_s * 1e3 / TRAIN_TIMED,
               'to_device_ms_per_batch': copy_s * 1e3 / TRAIN_TIMED,
               'ms_per_step_batches_on_card': staged_s * 1e3 / TRAIN_TIMED,
               'launches': launches, 'timed_launches': timed_launches,
               'history': {k: hist[k] for k in ('train_loss', 'lr')},
               'last_metrics': got[-1], 'profile': breakdown,
               'card_vs_cpu': gate, 'card': card}
    print(name, json.dumps(summary), flush=True)
    return launches, summary, job


def _eval_bucket(name: str) -> str:
    """Kernel groups of an OOD evaluation: the two kernels of the port,
    the ROC's sorts and searches, then the train step's groups."""
    low = name.lower()
    if 'iws' in low:
        return 'iws_combine_kernel'
    if 'sort' in low or 'search' in low:
        return 'sort_and_search'
    return _bucket(name)


def profile_ood(ood_detection_rates, job, testset, oodsets) -> dict:
    """One compute-tier OOD evaluation of the test set against one OOD set
    under torch.profiler: device time by kernel group, the busy share of
    the wall time, and the host's top operators."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ood_detection_rates(job, testset, oodsets, batch_size=OOD_BATCH,
                            from_where=('compute',), update_self_ood=False,
                            recording=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, kernels = {}, []
    for ev in prof.key_averages():
        dev = getattr(ev, 'self_device_time_total',
                      getattr(ev, 'self_cuda_time_total', 0)) / 1e3
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev > 0:
            kernels.append((dev, ev.key[:80], ev.count))
            by_name[_eval_bucket(ev.key)] = by_name.get(_eval_bucket(ev.key), 0.0) + dev
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    host = sorted(((ev.self_cpu_time_total / 1e3, ev.key[:60], ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type != torch.autograd.DeviceType.CUDA),
                  reverse=True)
    return {'sets': 1 + len(oodsets), 'wall_ms': wall_ms, 'device_ms': busy,
            'device_busy_share': busy / wall_ms if wall_ms else None,
            'by_name_ms': by_name,
            'top': [{'ms': ms, 'kernel': k, 'calls': c}
                    for ms, k, c in kernels[:12]],
            'top_host': [{'ms': ms, 'op': k, 'calls': c}
                         for ms, k, c in host[:12]]}


def odin_gate(card: str) -> dict:
    """ODIN on the card: a vib with the flagship's conv32 features and
    widths, one batch of 64, a 2-temperature x 2-epsilon grid, its
    input gradient through the conv kernel's dx (conv_0's 32 -> 3
    included); the scores against the CPU with the same weights and the
    same latent noise.  Then the dx at conv_0 against its plain version,
    on the output gradient that ODIN's first backward gave conv_0 on the
    card and on a random one of the same shape, timed beside cuDNN's
    dgrad and the bound."""
    import dataclasses
    from joint_vae_tpu_torch.evals.odin import make_odin_scores
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.ops.priors import PriorConfig
    from joint_vae_tpu_torch.ops.same_grid_conv import (
        same_grid_conv, same_grid_conv_dx, same_grid_conv_dx_plain)
    from joint_vae_tpu_torch.save_load.jobs import load_job, new_job, save_job
    cfg = dataclasses.replace(flagship_config(), type='vib',
                              prior=PriorConfig(dim=128))
    job_dir = os.path.join(WORK, 'vib_job')
    save_job(new_job(cfg, seed=3, device='cuda'), job_dir)
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (ODIN_BATCH,) + cfg.input_shape).astype(np.float32)
    eps = rng.standard_normal((cfg.test_latent_sampling + 1, ODIN_BATCH,
                               cfg.latent_dim)).astype(np.float32)
    eps[0] = 0.0
    scores, launches = {}, None
    for dev in ('cuda', 'cpu'):
        job = load_job(job_dir, device=dev)
        odin = make_odin_scores(job.model, temps=ODIN_TEMPS, eps_grid=ODIN_EPS)
        xt = torch.from_numpy(x).to(job.device)
        et = torch.from_numpy(eps).to(job.device)
        if dev == 'cuda':
            # conv_0's output gradient (its bias add passes it through):
            # the g of the dx launch at conv_0, kept from the first backward
            conv_0 = job.model.features_stack.conv_0
            seen = []

            def keep_grad(module, inputs, y):
                if y.requires_grad and not seen:
                    y.register_hook(lambda gy: seen.append(
                        gy.detach().contiguous()) if not seen else None)
            hook = conv_0.register_forward_hook(keep_grad)
            same_grid_conv.launches = same_grid_conv_dx.launches = 0
            t0 = time.perf_counter()
        out = odin(xt, eps=et)
        if dev == 'cuda':
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {'same_grid_conv': same_grid_conv.launches,
                        'same_grid_conv_dx': same_grid_conv_dx.launches}
            hook.remove()
            k0 = conv_0.weight.detach().contiguous()
            lo0 = conv_0.pads[0]
        scores[dev] = {k: v.cpu().numpy() for k, v in out.items()}
    # per temperature: one backward through the features' two same-grid
    # sites (conv_0 and conv_2); forwards: the unperturbed batch, then one
    # batch of all epsilons per temperature
    want = {'same_grid_conv': 2 * (1 + len(ODIN_TEMPS)),
            'same_grid_conv_dx': 2 * len(ODIN_TEMPS)}
    if launches != want:
        raise AssertionError('ODIN launches {}, expected {}'.format(
            launches, want))
    worst, spread = 0.0, {}
    for k, want_s in scores['cpu'].items():
        got = scores['cuda'][k]
        if got.shape != (ODIN_BATCH,) or not np.all(np.isfinite(got)):
            raise AssertionError('bad ODIN scores for {}'.format(k))
        np.testing.assert_allclose(got, want_s, rtol=0, atol=ODIN_TOL,
                                   err_msg='card vs CPU, ' + k)
        worst = max(worst, float(np.max(np.abs(got - want_s))))
        spread[k] = float(np.ptp(want_s))
    # the dx at conv_0 (64 x 32 x 32, 32 -> 3 channels, 5x5) against its
    # plain version, in the conv's float32 form
    if len(seen) != 1 or not seen[0].abs().max().item() > 0:
        raise AssertionError('no output gradient reached conv_0')
    g_cuda = torch.Generator(device='cuda').manual_seed(12)
    g_rand = 0.05 * torch.randn(seen[0].shape, generator=g_cuda, device='cuda')
    dx_err = {}
    for what, g0 in (('odin', seen[0]), ('random', g_rand)):
        dx = same_grid_conv_dx(g0, k0, lo0, lo0)
        dx_ref = same_grid_conv_dx_plain(g0, k0, lo0, lo0)
        conv_gate(dx, dx_ref, 'dx conv_0 at ODIN\'s shape, {} g'.format(what))
        dx_err[what] = (dx - dx_ref).abs().max().item()
    n, h, w, co = g_rand.shape
    th, tw, ci, _ = k0.shape
    wc, gc = k0.permute(3, 2, 0, 1).contiguous(), g_rand.permute(0, 3, 1, 2)
    b, by = bound_ms(4.0 * (g_rand.numel() + k0.numel() + n * h * w * ci),
                     2.0 * n * h * w * th * tw * ci * co,
                     PEAK_FLOPS[torch.float32])
    conv_0_dx = {
        'dx_shape': [n, h, w, co, ci, th, tw], 'max_abs_err': dx_err,
        'odin_g_rms': seen[0].square().mean().sqrt().item(),
        'ms': time_ms(lambda: same_grid_conv_dx(g_rand, k0, lo0, lo0), 20),
        'plain_ms': time_ms(lambda: same_grid_conv_dx_plain(
            g_rand, k0, lo0, lo0), 5, 1),
        'library_ms': time_ms(lambda: torch.nn.grad.conv2d_input(
            (n, ci, h, w), wc, gc, padding=lo0), 20),
        'bound_ms': b, 'bound_by': by}
    return {'batch': ODIN_BATCH, 'temps': ODIN_TEMPS, 'eps': ODIN_EPS,
            'launches': launches, 'first_call_ms': ms,
            'card_vs_cpu_max_abs_err': worst, 'tol': ODIN_TOL,
            'score_spread': spread, 'conv_0_dx': conv_0_dx, 'card': card}


def train_cli(card: str) -> dict:
    """``python -m joint_vae_tpu_torch.cli.train`` in a subprocess with the
    flagship's flags, one epoch on 2,048 images with cifar10 and svhn as
    OOD sets; the job dir's files and ``load_job``."""
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.save_load.recorders import find_record
    jobs = os.path.join(WORK, 'cli_jobs')
    shutil.rmtree(jobs, ignore_errors=True)
    argv = [sys.executable, '-m', 'joint_vae_tpu_torch.cli.train',
            '--dataset', 'cifar100', '--type', 'cvae', '--features', 'conv32',
            '--upsampler', 'deconv32', '-K', '128', '--encoder', '512',
            '--decoder', '512', '--classifier', '--gamma', '500',
            '--beta', '1e-4', '--sigma', '0.1', '--latent-sampling', '1',
            '--test-latent-sampling', '16', '--prior', 'gaussian',
            '--prior-means', '17', '--learned-prior-means', '--lr', '1e-4',
            '--epochs', '1', '--batch-size', '256', '--test-batch-size', '512',
            '--dataset-size', str(CLI_SIZE), '--oodsets', 'cifar10', 'svhn',
            '--job-dir', jobs, '--job-number', '1']
    where = subprocess.run(argv + ['--where'], cwd=ROOT, check=True,
                           capture_output=True, text=True,
                           timeout=120).stdout.strip()
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError('train CLI exited {}:\n{}'.format(
            r.returncode, r.stderr[-4000:]))
    for f in ('params.json', 'train_params.json', 'state.npz',
              'optimizer.npz', 'test.json', 'ood.json', 'history.json',
              'output.out'):
        if not os.path.exists(os.path.join(where, f)):
            raise AssertionError('train CLI wrote no {}'.format(f))
    sdir = os.path.join(where, 'samples', '0001')
    for name in ('cifar100', 'cifar10', 'svhn'):
        if find_record(sdir, name) is None:
            raise AssertionError('no recorder for {} in {}'.format(name, sdir))
    job = load_job(where)
    ood = job.ood_results.get(1, {})
    if set(ood) != {'cifar10', 'svhn'} or job.trained != 1:
        raise AssertionError('train CLI job: epochs {}, ood sets {}'.format(
            job.trained, sorted(ood)))
    aucs = {s: {m: ood[s][m]['auc'] for m in ('iws', 'elbo')} for s in ood}
    if not all(np.isfinite(v) for r_ in aucs.values() for v in r_.values()):
        raise AssertionError('non-finite AUCs {}'.format(aucs))
    return {'seconds': seconds, 'job_dir': os.path.relpath(where, ROOT),
            'size': CLI_SIZE, 'accuracy': {m: r_['accuracy'] for m, r_ in
                                           job.testing.get(1, {}).items()},
            'auc': aucs, 'card': card}


def replay_gate(cpu_res: dict, res: dict, cpu_scores: dict,
                card_scores: dict) -> dict:
    """The engine replayed on the CPU from a copy of the card's record
    files against the card's results, entry by entry: AUC, fpr and
    precision within ROC_TOL.  A threshold is a score, and each side
    derives the scores from the recorded losses with its own exp, log
    and sums over the classes: where a method's scores are equal on
    both, its thresholds must be equal; else within the largest
    difference of its scores (printed per method)."""
    if set(cpu_res) != set(res):
        raise AssertionError('replayed sets {}'.format(sorted(cpu_res)))
    score_diff = {}
    for s_name, ms in cpu_scores.items():
        for m, v in ms.items():
            d = (v - card_scores[s_name][m].cpu()).abs().max().item()
            score_diff[m] = max(score_diff.get(m, 0.0), d)
    worst = {'auc': 0.0, 'fpr': 0.0, 'precision': 0.0, 'thresholds': {}}
    for s_name, ms in res.items():
        for m, r in ms.items():
            c = cpu_res[s_name][m]
            for k in ('auc', 'fpr', 'precision'):
                err = float(np.max(np.abs(np.subtract(c[k], r[k]))))
                worst[k] = max(worst[k], err)
                if not err <= ROC_TOL:
                    raise AssertionError('replayed {} {} {}: {}'.format(
                        s_name, m, k, err))
            for k in ('thresholds', 'thresholds_up'):
                a, b = np.asarray(c[k]), np.asarray(r[k])
                same = a == b
                err = float(np.max(np.abs(a[~same] - b[~same]), initial=0.0))
                worst['thresholds'][m] = max(worst['thresholds'].get(m, 0.0),
                                             err)
                if not err <= score_diff[m]:
                    raise AssertionError(
                        'replayed {} {} {}: {} vs {}, off by {} where the '
                        'scores differ by {}'.format(s_name, m, k, c[k], r[k],
                                                     err, score_diff[m]))
    return {**worst, 'scores_cpu_vs_card': score_diff}


def writer_check(path: str) -> dict:
    """The record file's two writers on one of the evaluation's record
    files (cifar100's, ~32 MB): the native library (``native/recstore.cpp``
    through ctypes) and the Python fallback, each writing the file's
    arrays twice, alternately; the bytes must equal the file's.  Wall ms
    of each write."""
    from joint_vae_tpu_torch.save_load import native_store
    meta, arrays = native_store.read_jvr(path, writeable=True)
    args = (arrays, meta['batch_size'], meta['recorded_batches'],
            meta['last_batch_size'], meta['seed'])
    with open(path, 'rb') as f:
        want = f.read()
    lib, ms = native_store.get_lib, {'native': [], 'python': []}
    if lib() is None:
        raise AssertionError('native/librecstore.so did not build')
    for name in ('native', 'python') * 2:
        out = os.path.join(WORK, 'writer-{}.jvr'.format(name))
        native_store.get_lib = lib if name == 'native' else (lambda: None)
        try:
            t0 = time.perf_counter()
            native_store.write_jvr(out, *args)
            ms[name].append((time.perf_counter() - t0) * 1e3)
        finally:
            native_store.get_lib = lib
        with open(out, 'rb') as f:
            if f.read() != want:
                raise AssertionError('the {} writer wrote other bytes than '
                                     '{}'.format(name, path))
        os.remove(out)
    return {'bytes': len(want), 'native_ms': ms['native'],
            'python_ms': ms['python']}


def ood_eval(card: str):
    """Phase 6: the flagship's per-class OOD and misclassification
    evaluation through the engines, ODIN on a vib, and the train CLI."""
    from joint_vae_tpu_torch.data.loaders import get_dataset
    from joint_vae_tpu_torch.evals import engines
    from joint_vae_tpu_torch.ops.iws import iws_combine
    from joint_vae_tpu_torch.ops.roc import roc_curve, two_sided_from_method
    from joint_vae_tpu_torch.ops.same_grid_conv import same_grid_conv
    from joint_vae_tpu_torch.save_load import native_store
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.save_load.recorders import LossRecorder, find_record

    job_dir = os.path.join(WORK, 'flagship_job')       # phase 4's job
    # record files of an earlier run of this script would serve the sets
    shutil.rmtree(os.path.join(job_dir, 'samples'), ignore_errors=True)
    job = load_job(job_dir)
    cfg = job.model_cfg
    _, testset = get_dataset('cifar100', splits=['test'])
    oodsets = [get_dataset(n, splits=['test'])[1] for n in OOD_SETS]
    sets = [testset] + oodsets
    if any(len(s) != OOD_SET_SIZE for s in sets):
        raise AssertionError('set sizes {}'.format([len(s) for s in sets]))
    batches = -(-OOD_SET_SIZE // OOD_BATCH)

    # the record files' native writer is built (g++) at its first use:
    # built here, outside the timed call
    t0 = time.perf_counter()
    have_writer = native_store.get_lib() is not None
    writer_build_s = time.perf_counter() - t0

    # per-set compute-tier times (the engine's per-set loop) and record
    # file writes, timed around
    set_ms, save_ms = {}, {}
    collect, save = engines._collect_scores, engines._save_recorder

    def timed_collect(job_, dataset, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = collect(job_, dataset, *a, **k)
        torch.cuda.synchronize()
        set_ms[dataset.name] = (time.perf_counter() - t0) * 1e3
        return out

    def timed_save(rec, path):
        t0 = time.perf_counter()
        save(rec, path)
        save_ms[os.path.basename(path)] = (time.perf_counter() - t0) * 1e3
    engines._collect_scores = timed_collect
    engines._save_recorder = timed_save
    try:
        same_grid_conv.launches = 0
        iws_combine.launches = 0
        # --- the main path: the three engines, in order ---
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engines.ood_detection_rates(job, testset, oodsets,
                                          batch_size=OOD_BATCH)
        torch.cuda.synchronize()
        ood_s = time.perf_counter() - t0
        launches = {'same_grid_conv': same_grid_conv.launches,
                    'iws_combine': iws_combine.launches}
        t0 = time.perf_counter()
        acc = engines.accuracy(job, testset, batch_size=OOD_BATCH)
        mis = engines.misclassification_detection_rates(
            job, testset, batch_size=OOD_BATCH)
        again = engines.ood_detection_rates(job, testset, oodsets,
                                            batch_size=OOD_BATCH,
                                            from_where=('json', 'recorders'))
        reuse_s = time.perf_counter() - t0
        reuse_launches = {'same_grid_conv': same_grid_conv.launches
                          - launches['same_grid_conv'],
                          'iws_combine': iws_combine.launches
                          - launches['iws_combine']}
        # --- end of the main path ---
    finally:
        engines._collect_scores = collect
        engines._save_recorder = save
    want = {'same_grid_conv': SITES_PER_BATCH * batches * len(sets),
            'iws_combine': batches * len(sets)}
    if launches != want:
        raise AssertionError('OOD launches {}, expected {} ({} sets of {} '
                             'batches)'.format(launches, want, len(sets),
                                               batches))
    if reuse_launches != {'same_grid_conv': 0, 'iws_combine': 0}:
        raise AssertionError('the recorder tier launched {}'.format(
            reuse_launches))
    if again != res or set(res) != set(OOD_SETS):
        raise AssertionError('the json tier changed the results')
    for s_name, ms in res.items():
        for m, r in ms.items():
            vals = [r['auc'], r['mean'], r['std']] + r['fpr'] + r['precision']
            if r['n'] != OOD_SET_SIZE or not np.all(np.isfinite(vals)):
                raise AssertionError('bad ood entry {} {}'.format(s_name, m))
    if (set(acc) != set(cfg.predict_methods)
            or job.testing[0]['iws']['n'] != OOD_SET_SIZE):
        raise AssertionError('accuracy {} / testing {}'.format(
            acc, job.testing.get(0)))
    if not mis or not all(np.isfinite(r['accuracy']) for r in mis.values()):
        raise AssertionError('misclassification results {}'.format(mis))

    # --- the ROC alone, per (set, method), on the card; then on the CPU
    # over the same scores ---
    sdir = os.path.join(job_dir, 'samples', '0000')
    scores = {s.name: engines._scores_from_recorder(
        job, LossRecorder.load(find_record(sdir, s.name)), cfg.ood_methods)
        for s in sets}
    roc_ms, worst = {}, {'auc': 0.0, 'fpr': 0.0, 'precision': 0.0}
    for s_name in OOD_SETS:
        for m in cfg.ood_methods:
            ins, outs = scores[testset.name][m], scores[s_name][m]
            geo = two_sided_from_method(m)
            roc_ms['{}/{}'.format(s_name, m)] = time_ms(
                lambda: roc_curve(ins, outs, two_sided=geo), 5)
            card_r = roc_curve(ins, outs, two_sided=geo)
            cpu_r = roc_curve(ins.cpu(), outs.cpu(), two_sided=geo)
            for k in ('auc', 'fpr', 'precision'):
                err = (card_r[k].cpu() - cpu_r[k]).abs().max().item()
                worst[k] = max(worst[k], err)
                if err > ROC_TOL:
                    raise AssertionError('card vs CPU ROC {} {} {}: {}'.format(
                        s_name, m, k, err))
            for k in ('thresholds_low', 'thresholds_up'):
                if not torch.equal(card_r[k].cpu(), cpu_r[k]):
                    raise AssertionError('card vs CPU thresholds {} {} {}'
                                         .format(s_name, m, k))
    # the whole engine replayed on the CPU from a copy of the recorders
    cpu_dir = os.path.join(WORK, 'flagship_job_cpu')
    shutil.rmtree(cpu_dir, ignore_errors=True)
    shutil.copytree(job_dir, cpu_dir)
    cpu_job = load_job(cpu_dir, device='cpu')
    cpu_job.ood_results.clear()
    cpu_res = engines.ood_detection_rates(cpu_job, testset, oodsets,
                                          batch_size=OOD_BATCH,
                                          from_where=('recorders',))
    replay_err = replay_gate(cpu_res, res, {
        s.name: engines._scores_from_recorder(
            cpu_job, LossRecorder.load(find_record(
                os.path.join(cpu_dir, 'samples', '0000'), s.name)),
            cfg.ood_methods) for s in sets}, scores)
    writers = writer_check(find_record(sdir, testset.name))
    breakdown = profile_ood(engines.ood_detection_rates, job, testset,
                            oodsets[:1])
    odin = odin_gate(card)
    cli = train_cli(card)
    n_images = OOD_SET_SIZE * len(sets)
    summary = {'sets': [s.name for s in sets], 'set_size': OOD_SET_SIZE,
               'synthetic': [s.synthetic for s in sets],
               'batch': OOD_BATCH, 'L': cfg.test_latent_sampling,
               'C': cfg.num_labels, 'methods': cfg.ood_methods,
               'ood_seconds': ood_s,
               'compute_ms_per_set': set_ms,
               'ood_images_per_s': n_images / (sum(set_ms.values()) / 1e3),
               'ood_images_per_s_with_roc': n_images / ood_s,
               'record_write_ms': save_ms,
               'record_writer': 'native' if have_writer else 'python',
               'record_writer_build_s': writer_build_s,
               'reuse_seconds': reuse_s,
               'roc_ms': roc_ms, 'roc_ms_total': sum(roc_ms.values()),
               'launches': launches, 'reuse_launches': reuse_launches,
               'auc': {s: {m: res[s][m]['auc'] for m in ('iws', 'elbo')}
                       for s in res},
               'accuracy': acc,
               'misclass_auc_iws': {pm: r.get('iws', {}).get('auc')
                                    for pm, r in mis.items()},
               'roc_card_vs_cpu_max_abs_err': worst,
               'engine_cpu_replay_max_abs_err': replay_err,
               'record_writers': writers,
               'profile': breakdown, 'odin': odin, 'train_cli': cli,
               'card': card}
    print('ood', json.dumps(summary), flush=True)
    return launches, odin['launches'], summary, job


def rel_rms(got, ref) -> float:
    """The bfloat16 gate's error: ||got - ref||_2 / ||ref||_2 (float64)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def bf16_gate(card, cpu_bf16, cpu_f32, what) -> float:
    """err(card bf16, cpu f32) <= GATE_A err(cpu bf16, cpu f32) + GATE_B;
    -> the ratio of the left side to the right."""
    want = GATE_A * rel_rms(cpu_bf16, cpu_f32) + GATE_B
    got = rel_rms(card, cpu_f32)
    if got > want:
        raise AssertionError('bf16 gate {}: err(card bf16, cpu f32) {:.3e} > '
                             '{} x err(cpu bf16, cpu f32) + {}'.format(
                                 what, got, GATE_A, GATE_B))
    return got / want


def _count_reset():
    from joint_vae_tpu_torch.ops.iws import iws_combine
    from joint_vae_tpu_torch.ops.same_grid_conv import (
        bf16_launches, same_grid_conv, same_grid_conv_dx)
    same_grid_conv.launches = 0
    same_grid_conv_dx.launches = 0
    iws_combine.launches = 0
    for k in bf16_launches:
        bf16_launches[k] = 0


def _check_bf16_counts(launches: dict, bf16: bool, what: str):
    """Every conv launch since ``_count_reset`` ran the bfloat16 build when
    ``bf16``, none of them when not."""
    from joint_vae_tpu_torch.ops.same_grid_conv import bf16_launches
    got = dict(bf16_launches)
    want = {k: launches[k] if bf16 else 0 for k in got}
    if got != want:
        raise AssertionError('{}: {} bf16 conv launches, want {}'.format(
            what, got, want))


def _counts() -> dict:
    from joint_vae_tpu_torch.ops.iws import iws_combine
    from joint_vae_tpu_torch.ops.same_grid_conv import (same_grid_conv,
                                                        same_grid_conv_dx)
    return {'same_grid_conv': same_grid_conv.launches,
            'same_grid_conv_dx': same_grid_conv_dx.launches,
            'iws_combine': iws_combine.launches}


def _want(steps: int, batches: int = 0) -> dict:
    """Launches of ``steps`` train steps and ``batches`` scored batches."""
    return {'same_grid_conv': SITES_PER_BATCH * (steps + batches),
            'same_grid_conv_dx': DX_PER_STEP * steps,
            'iws_combine': batches}


def time_device_steps(job, dd, batch: int) -> dict:
    """The epoch's gather and 10 device-fed steps after 3 warm-up ones,
    from a DeviceDataset, with their launches; then one step profiled
    (phase 5's breakdown)."""
    from joint_vae_tpu_torch.train.device_data import (epoch_permutation,
                                                       make_device_train_step)
    from joint_vae_tpu_torch.train.steps import pull_metrics
    step = make_device_train_step(job.model, job.opt_cfg, batch)
    state = job.state
    perm = epoch_permutation(dd.n, 1, 0, dd.x.device)
    shuffle_ms = time_ms(lambda: dd.shuffled(perm), 3, 1)
    ex, ey = dd.shuffled(perm)
    for i in range(TRAIN_WARMUP):
        state, m = step(state, ex, ey, i)
    torch.cuda.synchronize()
    _count_reset()
    pending = []
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_TIMED):
        state, m = step(state, ex, ey, i)
        pending.append(m)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    launches = _counts()
    if launches != _want(TRAIN_TIMED):
        raise AssertionError('device-fed steps launched {}'.format(launches))
    _check_bf16_counts(launches, job.model.cfg.compute_dtype == 'bfloat16',
                       'device-fed steps')
    got = pull_metrics(pending)
    if not all(np.isfinite(list(r.values())).all() for r in got):
        raise AssertionError('non-finite device-fed metrics')
    i = TRAIN_WARMUP + TRAIN_TIMED
    breakdown = profile_train_step(lambda st, a, b: step(st, a, b, i),
                                   state, ex, ey)
    return {'batch': batch, 'ms_per_step': s * 1e3 / TRAIN_TIMED,
            'images_per_s': batch * TRAIN_TIMED / s,
            'shuffle_ms': shuffle_ms, 'launches': launches,
            'last_total': got[-1]['total'], 'profile': breakdown}


def profile_device_epoch(cfg, trainset, batch: int) -> dict:
    """One fused ``train_epochs_on_device`` epoch over 4 batches under
    torch.profiler: the gathers of the set counted (one per epoch: x and
    y; none per step)."""
    from torch.profiler import ProfilerActivity, profile
    from joint_vae_tpu_torch.data.loaders import ArrayDataset
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.device_data import train_epochs_on_device
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    n = 4 * batch
    small = ArrayDataset(trainset.data[:n], trainset.targets[:n], 'small')
    job = new_job(cfg, OptimizerConfig(lr=TRAIN_LR), seed=2)
    train_epochs_on_device(job, small, 1, batch)          # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_epochs_on_device(job, small, 1, batch)
        torch.cuda.synchronize()
    ops = {ev.key: ev.count for ev in prof.key_averages()}
    gathers = ops.get('aten::index_select', 0)
    if gathers != 2:
        raise AssertionError('{} gathers in one device-fed epoch, want 2 '
                             '(x and y)'.format(gathers))
    return {'steps': 4, 'index_select': gathers}


def bf16_train_gate(cfg16) -> dict:
    """The full-width flagship at batch 8 from one init, with the same
    batch and noise: the card in bfloat16 against the CPU in float32,
    through the bfloat16 gate whose reference is the CPU's own bfloat16:
    the first step's gradients per tensor, every metric of 3 steps."""
    import dataclasses
    from joint_vae_tpu_torch.models.evaluate import evaluate
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.steps import make_train_step, pull_metrics
    cfg32 = dataclasses.replace(cfg16, compute_dtype='float32')
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (GATE_BATCH,) + cfg16.input_shape).astype(np.float32)
    y = rng.integers(0, cfg16.num_labels, GATE_BATCH).astype(np.int64)
    eps = rng.standard_normal((cfg16.latent_sampling + 1, GATE_BATCH,
                               cfg16.latent_dim)).astype(np.float32)
    eps[0] = 0.0
    runs = {}
    for name, cfg, dev in (('card_bf16', cfg16, 'cuda'),
                           ('cpu_f32', cfg32, 'cpu'),
                           ('cpu_bf16', cfg16, 'cpu')):
        job = new_job(cfg, OptimizerConfig(lr=TRAIN_LR), seed=1, device=dev)
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        et = torch.from_numpy(eps).to(dev)
        params = dict(job.model.named_parameters())
        out = evaluate(job.model, xt, yt, sigma_state=job.sigma_state,
                       train=True, with_beta=True, eps=et)
        want = torch.bfloat16 if cfg is cfg16 else torch.float32
        if out.x_reco.dtype != want:
            raise AssertionError('{}: x_reco in {}, want {}'.format(
                name, out.x_reco.dtype, want))
        got = torch.autograd.grad(torch.mean(out.losses['total']),
                                  list(params.values()), allow_unused=True)
        grads = {k: (torch.zeros_like(p) if g is None else g).double().cpu()
                 for (k, p), g in zip(params.items(), got)}
        step = make_train_step(job.model, job.opt_cfg)
        state, seq = job.state, []
        for _ in range(GATE_STEPS):
            state, m = step(state, xt, yt, eps=et)
            seq.append(m)
        runs[name] = (grads, pull_metrics(seq))
    ratios = {}
    for k, ref in runs['cpu_f32'][0].items():
        ratios['grad ' + k] = bf16_gate(runs['card_bf16'][0][k],
                                        runs['cpu_bf16'][0][k], ref, k)
    for k in runs['cpu_f32'][1][0]:
        vec = {n: [m[k] for m in r[1]] for n, r in runs.items()}
        ratios['metric ' + k] = bf16_gate(vec['card_bf16'], vec['cpu_bf16'],
                                          vec['cpu_f32'], k)
    worst = max(ratios, key=ratios.get)
    return {'batch': GATE_BATCH, 'steps': GATE_STEPS, 'checked': len(ratios),
            'worst': worst, 'worst_share_of_gate': ratios[worst],
            'total_card_bf16': [m['total'] for m in runs['card_bf16'][1]],
            'total_cpu_f32': [m['total'] for m in runs['cpu_f32'][1]],
            'total_cpu_bf16': [m['total'] for m in runs['cpu_bf16'][1]]}


def bf16_serve(cfg16) -> dict:
    """A bfloat16 Scorer batch of 512 at L=16 on the card (8 conv and 1
    combine launches) against the card's float32 Scorer of the same
    weights and noise, per method through the bfloat16 gate, whose
    reference is the CPU's bfloat16 against its float32 on the first
    SERVE_GATE_N inputs; then the batch timed."""
    import dataclasses
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.serve import Scorer
    cfg32 = dataclasses.replace(cfg16, compute_dtype='float32')
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 1, (BATCH,) + cfg16.input_shape).astype(np.float32)
    eps = rng.standard_normal((cfg16.test_latent_sampling + 1, BATCH,
                               cfg16.latent_dim)).astype(np.float32)
    eps[0] = 0.0
    free = {m: float('-inf') for m in METHODS}
    scores = {}
    for name, cfg, dev, n in (('card_bf16', cfg16, 'cuda', BATCH),
                              ('card_f32', cfg32, 'cuda', BATCH),
                              ('cpu_bf16', cfg16, 'cpu', SERVE_GATE_N),
                              ('cpu_f32', cfg32, 'cpu', SERVE_GATE_N)):
        job = new_job(cfg, seed=0, device=dev)
        scorer = Scorer(job, methods=METHODS, thresholds=free)
        et = torch.from_numpy(eps[:, :n]).to(dev)
        if name == 'card_bf16':
            _count_reset()
        out = scorer(x[:n], eps=et)
        if name == 'card_bf16':
            launches = _counts()
            if launches != _want(0, 1):
                raise AssertionError('bf16 Scorer launched {}'.format(launches))
            _check_bf16_counts(launches, True, 'bf16 Scorer')
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scorer(x, eps=et)
            batch_ms = (time.perf_counter() - t0) * 1e3
        scores[name] = out['scores']
    ratios = {}
    for m in METHODS:
        s = {k: np.asarray(v[m], np.float64) for k, v in scores.items()}
        if not np.all(np.isfinite(s['card_bf16'])):
            raise AssertionError('non-finite bf16 scores for ' + m)
        want = GATE_A * rel_rms(s['cpu_bf16'], s['cpu_f32']) + GATE_B
        got = rel_rms(s['card_bf16'], s['card_f32'])
        if got > want:
            raise AssertionError('bf16 Scorer {}: err(card bf16, card f32) '
                                 '{:.3e} > gate {:.3e}'.format(m, got, want))
        ratios[m] = {'err_card': got, 'err_cpu_ref': rel_rms(
            s['cpu_bf16'], s['cpu_f32']), 'card_vs_cpu_bf16': rel_rms(
                s['card_bf16'][:SERVE_GATE_N], s['cpu_bf16'])}
    return {'batch': BATCH, 'L': cfg16.test_latent_sampling,
            'launches': launches, 'batch_ms': batch_ms,
            'images_per_s': BATCH / batch_ms * 1e3, 'reference_inputs':
            SERVE_GATE_N, 'scores': ratios}


def bf16_cli(card: str) -> dict:
    """``cli.train --device-data --compute-dtype bfloat16`` in a
    subprocess with the flagship's flags; its job dir loaded; then
    ``cli.serve`` by the job's number, its records naming cifar100's
    classes."""
    from joint_vae_tpu_torch.cli.serve import main as serve_main
    from joint_vae_tpu_torch.data.registry import get_classes_by_name
    from joint_vae_tpu_torch.save_load.jobs import load_job
    jobs = os.path.join(WORK, 'cli_jobs_bf16')
    shutil.rmtree(jobs, ignore_errors=True)
    argv = [sys.executable, '-m', 'joint_vae_tpu_torch.cli.train',
            '--dataset', 'cifar100', '--type', 'cvae', '--features', 'conv32',
            '--upsampler', 'deconv32', '-K', '128', '--encoder', '512',
            '--decoder', '512', '--classifier', '--gamma', '500',
            '--beta', '1e-4', '--sigma', '0.1', '--latent-sampling', '1',
            '--test-latent-sampling', '16', '--prior', 'gaussian',
            '--prior-means', '17', '--learned-prior-means', '--lr', '1e-4',
            '--compute-dtype', 'bfloat16', '--device-data',
            '--epochs', '1', '--batch-size', '1024', '--test-batch-size',
            '512', '--dataset-size', str(BF16_CLI_SIZE), '--no-final-ood',
            '--job-dir', jobs, '--job-number', '2']
    where = subprocess.run(argv + ['--where'], cwd=ROOT, check=True,
                           capture_output=True, text=True,
                           timeout=120).stdout.strip()
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError('bf16 train CLI exited {}:\n{}'.format(
            r.returncode, r.stderr[-4000:]))
    job = load_job(where)
    if job.model_cfg.compute_dtype != 'bfloat16' or job.trained != 1:
        raise AssertionError('bf16 CLI job: dtype {}, epochs {}'.format(
            job.model_cfg.compute_dtype, job.trained))
    loss = job.train_history[1]['train_loss']['total']
    if not np.isfinite(loss) or job.state.step != BF16_CLI_SIZE // 1024:
        raise AssertionError('bf16 CLI job: loss {}, {} steps'.format(
            loss, job.state.step))
    npy = os.path.join(WORK, 'inputs_bf16.npy')
    np.save(npy, np.random.default_rng(4).uniform(
        0, 1, (16,) + job.model_cfg.input_shape).astype(np.float32))
    out = os.path.join(WORK, 'serve_by_number.jsonl')
    t0 = time.perf_counter()
    if serve_main(['2', npy, '--job-dir', jobs, '--batch-size', '16',
                   '--output', out]) != 0:
        raise AssertionError('serve CLI by job number failed')
    serve_s = time.perf_counter() - t0
    with open(out) as f:
        recs = [json.loads(s) for s in f][:-1]
    classes = get_classes_by_name('cifar100')
    if len(recs) != 16 or any(rec.get('class') != classes[rec['label']]
                              for rec in recs):
        raise AssertionError('serve CLI by number: records {}'.format(recs[:2]))
    return {'train_seconds': seconds, 'size': BF16_CLI_SIZE,
            'job_dir': os.path.relpath(where, ROOT), 'train_loss': loss,
            'serve_seconds': serve_s, 'classes': [r['class'] for r in recs[:3]],
            'card': card}


def bench_train(card: str, host_fed: dict):
    """Phase 7: the bench's train path.  The flagship in bfloat16 trained
    from a 50,000-image uint8 set held on the card: ``train_model(
    device_data=True)`` at batch 1024 and ``train_epochs_on_device`` at
    512, one epoch each, with their launches and images/s, then 10 timed
    steps of each; the float32 step fed from the card beside phase 5's
    host-fed one; one device-fed epoch profiled (one gather per epoch);
    the bfloat16 gates (training, Scorer); the bfloat16 CLI."""
    from joint_vae_tpu_torch.data.loaders import ArrayDataset
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.device_data import (DeviceDataset,
                                                       train_epochs_on_device)
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.trainer import train_model
    from joint_vae_tpu_torch.utils.print_log import EpochOutput

    cfg16 = flagship_config(compute_dtype='bfloat16')
    rng = np.random.default_rng(9)
    trainset = ArrayDataset(
        rng.integers(0, 256, (BENCH_SET,) + cfg16.input_shape, dtype=np.uint8),
        rng.integers(0, cfg16.num_labels, BENCH_SET).astype(np.int32),
        'synthetic')
    runs = {}
    for mode, batch in BENCH_BATCHES.items():
        job = new_job(cfg16, OptimizerConfig(lr=TRAIN_LR), seed=0)
        steps = BENCH_SET // batch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _count_reset()
        # --- the main path: one bf16 epoch fed from the card ---
        t0 = time.perf_counter()
        if mode == 'train':
            train_model(job, trainset, None, epochs=1, batch_size=batch,
                        final_test=False, final_ood=False, device_data=True,
                        outputs=EpochOutput(stdout=False))
            total = job.train_history[1]['train_loss']['total']
        else:
            total = train_epochs_on_device(job, trainset, 1, batch,
                                           fused=True)['total']
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = _counts()
        # --- end of the main path ---
        if launches != _want(steps):
            raise AssertionError('bf16 {} epoch launched {}, want {}'.format(
                mode, launches, _want(steps)))
        _check_bf16_counts(launches, True, 'bf16 {} epoch'.format(mode))
        if job.state.step != steps or not np.isfinite(total):
            raise AssertionError('bf16 {} epoch: {} steps, total {}'.format(
                mode, job.state.step, total))
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        dd = DeviceDataset(trainset)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        if dd.x.dtype != torch.uint8:
            raise AssertionError('the uint8 set is held as {}'.format(dd.x.dtype))
        timed = time_device_steps(job, dd, batch)
        runs[mode] = {'batch': batch, 'steps': steps, 'launches': launches,
                      'epoch_seconds': epoch_s,
                      'epoch_images_per_s': steps * batch / epoch_s,
                      'epoch_total_loss': total,
                      'peak_memory_gb': peak / 1e9,
                      'upload_seconds': upload_s,
                      'dataset_mb': dd.x.numel() / 1e6, 'timed': timed}
        del job, dd
        torch.cuda.empty_cache()
        print('bench_train_bf16', json.dumps({mode: runs[mode]}), flush=True)

    # --- the float32 step fed from the card, beside phase 5's host feed ---
    job32 = new_job(flagship_config(), OptimizerConfig(lr=TRAIN_LR), seed=0)
    dd = DeviceDataset(trainset)
    f32 = time_device_steps(job32, dd, TRAIN_BATCH)
    f32.update({'host_fed_ms_per_step': host_fed['ms_per_step'],
                'host_fed_images_per_s': host_fed['train_images_per_s'],
                'host_batches_on_card_ms_per_step':
                    host_fed['ms_per_step_batches_on_card']})
    del job32, dd
    torch.cuda.empty_cache()
    epoch_profile = profile_device_epoch(cfg16, trainset, TRAIN_BATCH)
    gate = bf16_train_gate(cfg16)
    serve16 = bf16_serve(cfg16)
    cli = bf16_cli(card)
    summary = {'bf16': runs, 'f32_device_fed': f32,
               'device_epoch_profile': epoch_profile, 'bf16_gate': gate,
               'bf16_serve': serve16, 'bf16_cli': cli,
               'gate': {'a': GATE_A, 'b': GATE_B}, 'card': card}
    print('bench_train', json.dumps(summary), flush=True)
    return summary


# phase 8: fleet evaluation from the job store: phase 6's flagship job and
# 63 more made from its JSON files (sigma and beta varied, epochs
# shifted); the test CLI recomputes the flagship alone over the four sets
FLEET_JOBS = 64
FLEET_SIGMAS = (0.1, 0.2, 0.5, 1.0)
FLEET_BETAS = (1e-4, 1e-3, 1e-2, 1e-1)
TEST_CLI_SETS = ('cifar100',) + OOD_SETS
RESULTS_INI = """[DEFAULT]
dataset = cifar100
ood = {ood}
tpr = 95
average = average {ood}
kept_index = sigma

[beta-1e-4]
beta = 0.0001

[beta-1e-2]
beta = 0.01
"""


def _build_fleet(flagship_dir: str, root: str) -> list:
    """The flagship job's directory copied under ``root``, and
    FLEET_JOBS - 1 more made from its JSON files alone: job numbers
    1..63, sigma and beta from FLEET_SIGMAS x FLEET_BETAS, trained for
    1-3 epochs of a history whose test losses come from a numpy seed,
    with the flagship's results at the last two of them (so that
    ``--early-stopping`` and ``--all-epochs`` have epochs to pick)."""
    from joint_vae_tpu_torch.save_load.checkpoint import load_json, save_json
    shutil.rmtree(root, ignore_errors=True)
    dirs = [os.path.join(root, 'cifar100', 'flagship', '000000')]
    shutil.copytree(flagship_dir, dirs[0])
    names = ('params.json', 'train_params.json', 'test.json', 'ood.json',
             'history.json')
    js = {n: load_json(os.path.join(flagship_dir, n)) for n in names}
    rng = np.random.default_rng(8)
    for n in range(1, FLEET_JOBS):
        sigma = FLEET_SIGMAS[n % len(FLEET_SIGMAS)]
        beta = FLEET_BETAS[(n // len(FLEET_SIGMAS)) % len(FLEET_BETAS)]
        d = os.path.join(root, 'cifar100', 'sigma={}--beta={}'.format(
            sigma, beta), '{:06d}'.format(n))
        e = 1 + n % 3
        tp = json.loads(json.dumps(js['train_params.json']))
        tp['sigma'].update(value=sigma, sigma0=sigma)
        tp.update(beta=beta, epochs=3)
        hist = {'epochs': e}
        for k in range(1, e + 1):
            hist[k] = {'test_loss': {'total': float(rng.uniform(100, 200))}}
        out = {'params.json': dict(js['params.json'], job_number=n),
               'train_params.json': tp, 'history.json': hist,
               'test.json': {k: js['test.json'][0] for k in {e - 1, e}},
               'ood.json': {k: js['ood.json'][0] for k in {e - 1, e}}}
        for name, v in out.items():
            save_json(v, os.path.join(d, name))
        dirs.append(d)
    return dirs


def _check_tex(path: str) -> int:
    """A tabular whose every row carries as many cells as its column
    format (multicolumns counted by width); returns the row count."""
    import re
    lines = open(path).read().splitlines()
    head = re.match(r'\\begin\{tabular\}\{(.*)\}$', lines[0])
    if not head or r'\end{tabular}' not in lines:
        raise AssertionError('{}: not a tabular'.format(path))
    ncol = len(re.sub(r'@\{[^}]*\}', '', head.group(1)))
    rows = [ln for ln in lines if ln.endswith(r' \\')]
    for ln in rows:
        cells = ln[:-3].split(' & ')
        width = sum(int(m.group(1)) if m else 1 for m in (
            re.match(r'\\multicolumn\{(\d+)\}', c) for c in cells))
        if width != ncol:
            raise AssertionError('{}: {} cells for {} columns in {!r}'
                                 .format(path, width, ncol, ln))
    return len(rows)


def _check_tab(path: str) -> int:
    """A whitespace table whose rows all have one length; returns the
    row count."""
    import csv
    with open(path, newline='') as f:
        rows = list(csv.reader(f, delimiter=' '))
    if not rows or len({len(r) for r in rows}) != 1:
        raise AssertionError('{}: ragged table'.format(path))
    return len(rows)


def fleet_eval(card: str, flagship):
    """Phase 8: fleet evaluation from the job store.  Phase 6's flagship
    job (its results saved back, its record files) and 63 jobs made from
    its JSON files: the registry cold and warm; ``cli.test --compute
    rehard`` on the flagship alone on the card, its launches against the
    engines' count and its saved OOD results against phase 6's; the
    cheap tiers over the whole fleet with no launch; tables written and
    parsed; ``cli.results`` on a comparison INI in a subprocess."""
    import copy
    from joint_vae_tpu_torch.cli import test as test_cli
    from joint_vae_tpu_torch.data.loaders import get_dataset
    from joint_vae_tpu_torch.evals import engines
    from joint_vae_tpu_torch.save_load import fetch
    from joint_vae_tpu_torch.save_load.jobs import load_job, save_job
    from joint_vae_tpu_torch.save_load.recorders import LossRecorder, find_record

    flagship_dir = os.path.join(WORK, 'flagship_job')     # phases 4 and 6
    flagship.training_parameters['set'] = 'cifar100'
    save_job(flagship, flagship_dir, save_state=False)
    stored_ood = copy.deepcopy(flagship.ood_results)
    root = os.path.join(WORK, 'fleet')
    dirs = _build_fleet(flagship_dir, root)
    out_dir = os.path.join(WORK, 'fleet_tables')
    shutil.rmtree(out_dir, ignore_errors=True)

    # --- the registry: cold (64 ghost loads), then warm (flash) ---
    t0 = time.perf_counter()
    cold = fetch.fetch_models(root, flash=False)
    cold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    warm = fetch.fetch_models(root)
    warm_ms = (time.perf_counter() - t0) * 1e3
    if (len(cold) != FLEET_JOBS
            or json.loads(json.dumps(warm)) != json.loads(json.dumps(cold))):
        raise AssertionError('registry: {} cold entries, warm ones differ: {}'
                             .format(len(cold), warm != cold))
    # CUDA is up in this process: the ghost loads' check runs in a fresh one
    code = ('import sys, torch; sys.path.insert(0, {r!r}); '
            'from joint_vae_tpu_torch.save_load import fetch; '
            'n = len(fetch.fetch_models({j!r}, flash=False)); '
            'print(n, torch.cuda.is_initialized())').format(r=ROOT, j=root)
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT, timeout=300,
                       capture_output=True, text=True)
    if r.returncode != 0 or r.stdout.split() != [str(FLEET_JOBS), 'False']:
        raise AssertionError('ghost registry build: {} {}'.format(
            r.stdout, r.stderr[-2000:]))

    # --- the recompute on the card: the flagship alone, every set ---
    _, testset = get_dataset('cifar100', splits=['test'])
    batches = -(-len(testset) // OOD_BATCH)
    # the compute tier's passes: accuracy over the test set, the OOD
    # engine over the test set and the three OOD sets, the
    # misclassification engine over the test set; 8 conv launches and 1
    # combine launch per batch of 512 (the 272-image tail included)
    passes = 1 + len(TEST_CLI_SETS) + 1
    want = _want(0, passes * batches)
    engine_s = {}

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            engine_s[name] = engine_s.get(name, 0.0) + time.perf_counter() - t0
            return res
        return call
    names = ('accuracy', 'ood_detection_rates',
             'misclassification_detection_rates')
    real = {n: getattr(test_cli, n) for n in names}
    for n in names:
        setattr(test_cli, n, timed(n, real[n]))
    # the OOD engine's scores per set (its pass comes before the
    # misclassification engine's over the test set)
    seen = {}
    collect = engines._collect_scores

    def keep_first(job_, dataset, *a, **k):
        out = collect(job_, dataset, *a, **k)
        seen.setdefault(dataset.name, {m: v.cpu() for m, v in out.items()})
        return out
    engines._collect_scores = keep_first
    argv = ['--job-dir', root, '--job', '0', '--compute', 'rehard',
            '--sets'] + list(TEST_CLI_SETS) + ['-M', str(OOD_BATCH)]
    try:
        _count_reset()
        # --- the main path of phase 8 ---
        t0 = time.perf_counter()
        with open(os.path.join(WORK, 'fleet_rehard.out'), 'w') as f, \
                contextlib.redirect_stdout(f):
            rc = test_cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = _counts()
        # --- end of the main path ---
    finally:
        for n in names:
            setattr(test_cli, n, real[n])
        engines._collect_scores = collect
    if rc != 0:
        raise AssertionError('cli.test --compute rehard exited {}'.format(rc))
    if launches != want:
        raise AssertionError('cli.test rehard launched {}, expected {} ({} '
                             'passes of {} batches)'.format(
                                 launches, want, passes, batches))
    job = load_job(dirs[0])
    got_ood = job.ood_results
    if set(got_ood.get(0, {})) != set(OOD_SETS):
        raise AssertionError('rehard ood sets {}'.format(sorted(got_ood)))
    # phase 6's OOD call wrote its scores' record files; the gate of its
    # replay holds the recompute's results to them (rates and AUC within
    # 1e-6; thresholds equal where the scores are, else within the
    # scores' difference)
    old_sdir = os.path.join(flagship_dir, 'samples', '0000')
    phase6_scores = {s: {m: v.cpu() for m, v in engines._scores_from_recorder(
        job, LossRecorder.load(find_record(old_sdir, s)),
        job.model_cfg.ood_methods).items()} for s in TEST_CLI_SETS}
    ood_err = replay_gate(got_ood[0], stored_ood[0],
                          {s: seen[s] for s in TEST_CLI_SETS}, phase6_scores)
    ood_err['scores_max_abs_diff'] = ood_err.pop('scores_cpu_vs_card')
    # accuracy and misclassification draw their own noise (seeds epoch + 1,
    # epoch + 2): held against the engines called with the same seeds
    direct = load_job(dirs[0])
    direct.saved_dir = None
    direct.testing.clear()
    engines.accuracy(direct, testset, batch_size=OOD_BATCH,
                     from_where=('compute',))
    engines.misclassification_detection_rates(
        direct, testset, batch_size=OOD_BATCH, from_where=('compute',))
    test_err = 0.0
    for pm, r_ in direct.testing[0].items():
        saved = job.testing[0][pm]
        for k, v in r_.items():
            if isinstance(v, dict):
                for kk in ('auc', 'fpr', 'precision', 'recall'):
                    test_err = max(test_err, float(np.max(np.abs(
                        np.subtract(v[kk], saved[k][kk])))))
            elif k == 'accuracy':
                test_err = max(test_err, abs(v - saved[k]))
    if not test_err <= ROC_TOL or set(direct.testing[0]) != set(
            job.testing[0]):
        raise AssertionError('rehard test.json vs the engines: {}'.format(
            test_err))
    images = passes * len(testset)

    # --- the cheap tiers over the whole fleet: no launch ---
    cheap = {}
    for name, extra in (
            ('recorder_early_stopping',
             ['--compute', '--early-stopping', '--sets']
             + list(TEST_CLI_SETS) + ['--results-file', 'fleet', '--latex',
                                      '--agg']),
            # no .tex here: rows of one job at two epochs share an index
            # tuple, and the .tex renderer (the JAX package's, ported as
            # it is) merges rows that share one
            ('json_all_epochs',
             ['--all-epochs', '-x', '-x', '--results-file', 'fleet-all'])):
        _count_reset()
        t0 = time.perf_counter()
        with open(os.path.join(WORK, 'fleet_{}.out'.format(name)), 'w') as f, \
                contextlib.redirect_stdout(f):
            rc = test_cli.main(['--job-dir', root, '--results-directory',
                                out_dir, '-M', str(OOD_BATCH)] + extra)
        cheap[name] = {'seconds': time.perf_counter() - t0,
                       'launches': _counts()}
        if rc != 0 or any(cheap[name]['launches'].values()):
            raise AssertionError('cheap tier {}: rc {}, launches {}'.format(
                name, rc, cheap[name]['launches']))
    tables = {}
    for f in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, f)
        tables[f] = (_check_tex(path) if f.endswith('.tex')
                     else _check_tab(path))
    if sorted(tables) != ['fleet-agg.tab', 'fleet-agg.tex', 'fleet-all.tab',
                          'fleet.tab', 'fleet.tex']:
        raise AssertionError('tables {}'.format(sorted(tables)))
    if tables['fleet.tex'] < FLEET_JOBS:
        raise AssertionError('fleet.tex has {} rows'.format(
            tables['fleet.tex']))

    # --- the results CLI on a comparison INI, in a subprocess ---
    ini = os.path.join(WORK, 'fleet_results.ini')
    with open(ini, 'w') as f:
        f.write(RESULTS_INI.format(ood=' '.join(OOD_SETS)))
    res_dir = os.path.join(WORK, 'fleet_results')
    shutil.rmtree(res_dir, ignore_errors=True)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, '-m', 'joint_vae_tpu_torch.cli.results',
                        ini, '--job-dir', root, '--out-dir', res_dir],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    results_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError('cli.results exited {}:\n{}'.format(
            r.returncode, r.stderr[-4000:]))
    tab = os.path.join(res_dir, 'fleet_results-tab.tab')
    tex = os.path.join(res_dir, 'fleet_results-tab.tex')
    sections = ['beta-1e-4', 'beta-1e-2']
    with open(tab) as f:
        header = f.readline().split()
    if header != (['set', 'sigma'] + ['{}-rate'.format(s) for s in sections]
                  + ['{}-auc'.format(s) for s in sections]):
        raise AssertionError('cli.results header {}'.format(header))
    results_rows = _check_tex(tex)

    summary = {
        'jobs': FLEET_JOBS,
        'registry_cold_ms_per_job': cold_ms / FLEET_JOBS,
        'registry_warm_ms_per_job': warm_ms / FLEET_JOBS,
        'ghost_cuda_initialized': False,
        'rehard': {'argv': argv, 'cli_seconds': cli_s,
                   'engine_seconds': engine_s, 'images': images,
                   'images_per_s': images / sum(engine_s.values()),
                   'images_per_s_cli': images / cli_s,
                   'launches': launches, 'expected': want,
                   'ood_vs_phase6_max_abs_err': ood_err,
                   'test_vs_engines_max_abs_err': test_err},
        'cheap': cheap, 'tables': tables,
        'results_cli': {'seconds': results_s, 'tex_rows': results_rows,
                        'header': header},
        'card': card}
    print('fleet', json.dumps(summary), flush=True)
    return launches, summary


# phase 9: WIM fine-tuning (the fine-tuning slice) on phase 6's flagship
# job, with [wim-default]'s alternate prior (configs/default.ini: an
# unconditional gaussian, init_mean 8), its moving set of 512 (half of it
# cifar10 and svhn), alpha 0.1 and one epoch: 8,192 training images at
# batch 64 (128 steps), the test and OOD sets at batch 256
WIM_SETS = ('cifar10', 'svhn')
WIM_TRAIN_SIZE, WIM_TRAIN_SIZE_2 = 8192, 1024
WIM_BATCH, WIM_TEST_BATCH = 64, 256
WIM_LATENT_BATCHES = 8                     # ft/job.py::record_latents
WIM_ALPHA = 0.1
WIM_PRIOR = dict(distribution='gaussian', init_mean=8.0, num_priors=1)
WIM_METHODS = ('zdist', 'zdist~', 'zdist@', 'zdist~@',
               'elbo', 'elbo~', 'elbo@', 'elbo~@')
WIM_MISCLASS = ('softzdist~', 'zdist~')
WIM_TIMED_STEPS, WIM_WARMUP_STEPS = 10, 3
WIM_REPLAY_TOL = 1e-6


def _ft_want(steps: int, pre_batches: int, both_batches: int,
             latent_batches: int = 0) -> dict:
    """Launches of a fine-tuning run: per step the conv forward at both
    halves' 8 sites and its dx at their 7, no combine; 8 conv and 1
    combine per batch of the pre-tuning engines and of record_latents; 16
    conv and 1 combine (the original prior's: the alternate one is
    unconditional) per both-prior batch."""
    return {'same_grid_conv': SITES_PER_BATCH * (
                2 * steps + pre_batches + 2 * both_batches + latent_batches),
            'same_grid_conv_dx': 2 * DX_PER_STEP * steps,
            'iws_combine': pre_batches + both_batches + latent_batches}


def _digest(d: str) -> dict:
    import hashlib
    out = {}
    for p, _, fs in os.walk(d):
        for f in fs:
            with open(os.path.join(p, f), 'rb') as fh:
                out[os.path.relpath(os.path.join(p, f), d)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def _job_dirs(root: str) -> list:
    return sorted(p for p, _, fs in os.walk(root) if 'params.json' in fs)


def _frozen(model) -> list:
    """What fine-tuning must not move: the prior and every buffer (the
    BatchNorm statistics where the model has them)."""
    return ([('prior.' + k, v) for k, v in model.prior().items()]
            + list(model.named_buffers()))


def wim_gate(job_dir: str) -> dict:
    """Card against CPU on phase 4's weights with the alternate prior
    drawn from one numpy seed: a both-prior evaluation of 8 inputs at
    L=16 (every loss and '@' twin, then every WIM score from them, at the
    serving tolerance), the fine-tuning gradient of 8 in and 8 moving
    inputs per tensor (the training gate), and 3 fine-tuning steps'
    metrics to 1e-4 relative; the prior and every buffer bit-equal after
    the steps on both devices."""
    from joint_vae_tpu_torch.ft.job import wim_scores_for_set
    from joint_vae_tpu_torch.ft.wim import WIMJob
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.train.optimizers import build_optimizer
    from joint_vae_tpu_torch.train.state import named_params
    cfg = flagship_config()
    rng = np.random.default_rng(9)
    n, K = GATE_BATCH, cfg.latent_dim
    x_in, x_mix, x_eval = rng.uniform(
        0, 1, (3, n) + cfg.input_shape).astype(np.float32)
    y = rng.integers(0, cfg.num_labels, n).astype(np.int64)
    eps = rng.standard_normal((cfg.latent_sampling + 1, n, K)
                              ).astype(np.float32)
    eps16 = rng.standard_normal((cfg.test_latent_sampling + 1, n, K)
                                ).astype(np.float32)
    eps[0] = eps16[0] = 0.0
    grads, metrics, evals, frozen = {}, {}, {}, {}
    for dev in ('cuda', 'cpu'):
        job = load_job(job_dir, device=dev)
        wim = WIMJob(job=job)
        wim.set_alternate_prior(seed=7, **WIM_PRIOR)
        t = lambda a: torch.from_numpy(a).to(dev)
        _, logits, losses, _ = wim.evaluate_on_both_priors(
            t(x_eval), sigma_state=job.sigma_state, decode_mean=False,
            eps=t(eps16))
        host = {k: v.cpu().numpy() for k, v in losses.items()}
        host['logits'] = logits.cpu().numpy()
        host['y_true'] = np.zeros(n, np.int32)
        evals[dev] = (host, wim_scores_for_set(wim, host,
                                               WIM_METHODS + WIM_MISCLASS))
        g, _, _ = wim.finetune_grads(job.state, t(x_in), t(y), t(x_mix),
                                     WIM_ALPHA, train_L=cfg.latent_sampling,
                                     eps=t(eps))
        grads[dev] = {k: v.cpu() for k, v in g.items()}
        keep = {k: v.detach().clone() for k, v in _frozen(job.model)}
        tx = build_optimizer(job.opt_cfg)
        job.state.opt_state = tx.init(named_params(job.model))
        seq = []
        for _ in range(GATE_STEPS):
            _, m = wim.finetune_batch(job.state, t(x_in), t(y), t(x_mix),
                                      WIM_ALPHA, tx=tx,
                                      train_L=cfg.latent_sampling, eps=t(eps))
            seq.append({k: v.item() for k, v in m.items()})
        metrics[dev] = seq
        now = dict(_frozen(job.model))
        moved = [k for k in keep if not torch.equal(now[k], keep[k])]
        if moved:
            raise AssertionError('{}: fine-tuning moved {}'.format(dev, moved))
        frozen[dev] = sorted(keep)
    grad_worst, loose = check_grads(grads)
    metric_worst = 0.0
    for a, b in zip(metrics['cuda'], metrics['cpu']):
        for k in b:
            err = abs(a[k] - b[k]) / abs(b[k])
            metric_worst = max(metric_worst, err)
            if err > TRAIN_LOSS_RTOL:
                raise AssertionError('card vs CPU fine-tune {}: {} vs {}'
                                     .format(k, a[k], b[k]))
    worst = {}
    (l_gpu, s_gpu), (l_cpu, s_cpu) = evals['cuda'], evals['cpu']
    checked = [('loss ' + k, l_gpu[k], v) for k, v in l_cpu.items()
               if k != 'y_true']
    checked += [('score ' + k, s_gpu[k], v) for k, v in s_cpu.items()]
    for name, got, want in checked:
        worst[name] = float(np.max(np.abs(got.astype(np.float64) - want)
                                   / np.maximum(np.abs(want), 1e-30)))
        np.testing.assert_allclose(got, want, rtol=SERVE_RTOL,
                                   atol=SERVE_ATOL,
                                   err_msg='card vs CPU both priors, ' + name)
    if not any(k.endswith('@') for k in l_cpu):
        raise AssertionError('no alternate-prior twin in {}'.format(l_cpu))
    return {'batch': n, 'steps': GATE_STEPS,
            'grad_worst_err_over_abs_plus_rms': grad_worst,
            'grad_beyond_strict_tol': loose,
            'metrics_cuda': metrics['cuda'], 'metrics_cpu': metrics['cpu'],
            'metric_worst_rel_err': metric_worst,
            'frozen_bit_equal': frozen['cuda'],
            'both_priors_worst_elementwise_rel_err': worst}


def time_finetune_steps(job_dir: str) -> dict:
    """10 fine-tuning steps after 3 warm-up ones, fed from the host as
    ``finetune`` feeds them (64 in and 64 moving images a step), their
    launches; then one step profiled by kernel group."""
    from joint_vae_tpu_torch.device import to_device
    from joint_vae_tpu_torch.ft.job import load_wim_job
    from joint_vae_tpu_torch.train.optimizers import build_optimizer
    from joint_vae_tpu_torch.train.state import named_params
    from joint_vae_tpu_torch.train.steps import pull_metrics
    wim = load_wim_job(job_dir, seed=7, **WIM_PRIOR)
    job = wim.job
    dev = job.device
    tx = build_optimizer(job.opt_cfg)
    state = job.state
    state.opt_state = tx.init(named_params(job.model))
    cfg = job.model_cfg
    rng = np.random.default_rng(11)
    n = WIM_WARMUP_STEPS + WIM_TIMED_STEPS + 1
    xs = rng.uniform(0, 1, (n, 2, WIM_BATCH) + cfg.input_shape
                     ).astype(np.float32)
    ys = rng.integers(0, cfg.num_labels, (n, WIM_BATCH)).astype(np.int32)

    def step(st, i):
        return wim.finetune_batch(st, to_device(xs[i, 0], dev),
                                  to_device(ys[i], dev),
                                  to_device(xs[i, 1], dev), WIM_ALPHA, tx=tx,
                                  train_L=cfg.latent_sampling)
    for i in range(WIM_WARMUP_STEPS):
        state, _ = step(state, i)
    torch.cuda.synchronize()
    _count_reset()
    pending = []
    t0 = time.perf_counter()
    for i in range(WIM_WARMUP_STEPS, WIM_WARMUP_STEPS + WIM_TIMED_STEPS):
        state, m = step(state, i)
        pending.append(m)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = _counts()
    if launches != _ft_want(WIM_TIMED_STEPS, 0, 0):
        raise AssertionError('timed fine-tune steps launched {}'.format(
            launches))
    if not all(np.isfinite(list(r.values())).all()
               for r in pull_metrics(pending)):
        raise AssertionError('non-finite fine-tune metrics')
    xm = to_device(xs[-1, 1], dev)
    breakdown = profile_train_step(
        lambda st, xb, yb: wim.finetune_batch(st, xb, yb, xm, WIM_ALPHA,
                                              tx=tx,
                                              train_L=cfg.latent_sampling),
        state, to_device(xs[-1, 0], dev), to_device(ys[-1], dev))
    return {'batch_in': WIM_BATCH, 'batch_mix': WIM_BATCH,
            'timed_steps': WIM_TIMED_STEPS, 'launches': launches,
            'ms_per_step': timed_s * 1e3 / WIM_TIMED_STEPS,
            'images_per_s': 2 * WIM_BATCH * WIM_TIMED_STEPS / timed_s,
            'profile': breakdown}


def _wim_results_gate(saved: dict, got: dict, what: str) -> float:
    """A replayed job's OOD results against the ones ``finetune`` saved:
    rates and AUC within 1e-6, thresholds within 1e-6 relative."""
    worst = 0.0
    for s, ms in saved.items():
        for m, r in ms.items():
            g = got[s][m]
            for k in ('auc', 'fpr', 'thresholds'):
                w, v = np.asarray(r[k], np.float64), np.asarray(g[k], np.float64)
                err = float(np.max(np.abs(v - w) / np.maximum(
                    1.0 if k != 'thresholds' else np.abs(w), 1e-30)))
                worst = max(worst, err)
                if err > WIM_REPLAY_TOL:
                    raise AssertionError('{} {} {} {}: replayed {} saved {}'
                                         .format(what, s, m, k, g[k], r[k]))
    return worst


def wim_finetune(card: str) -> tuple:
    """Phase 9: WIM fine-tuning through ``cli.ft`` on phase 6's flagship
    job: the card against the CPU first, then the CLI in-process in a
    scratch working directory (the scheduler writes ``grid/`` there) with
    ``--inspection``, its launches counted; the saved job checked and the
    source job byte-unchanged; a second run of another task; the array
    pass and the test CLI's replay of both jobs from their record files,
    neither launching anything; Poscod; the timed steps."""
    from joint_vae_tpu_torch.cli import ft as ft_cli
    from joint_vae_tpu_torch.cli import test as test_cli
    from joint_vae_tpu_torch.ft import job as ft_job
    from joint_vae_tpu_torch.ft.array import WIMArray
    from joint_vae_tpu_torch.ft.poscod import POSCOD_HEAD_FILE, load_poscod_job
    from joint_vae_tpu_torch.save_load.checkpoint import load_json
    from joint_vae_tpu_torch.save_load.recorders import LossRecorder, find_record

    flagship_dir = os.path.join(WORK, 'flagship_job')   # phases 4, 6 and 8
    gate = wim_gate(flagship_dir)
    root = os.path.join(WORK, 'ft_jobs')
    cwd = os.path.join(WORK, 'ft_cwd')
    arrays = [os.path.join(WORK, 'ft_array'), os.path.join(WORK, 'ft_array_direct')]
    for d in [root, cwd] + arrays:
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(cwd)
    src = os.path.join(root, 'cifar100', 'flagship', '000000')
    shutil.copytree(flagship_dir, src, ignore=shutil.ignore_patterns('samples'))
    if load_json(os.path.join(src, 'train_params.json'))['set'] != 'cifar100':
        raise AssertionError('the flagship job names no cifar100 set')
    before = _digest(src)
    batches = -(-OOD_SET_SIZE // WIM_TEST_BATCH)
    n_sets = 1 + len(WIM_SETS)
    common = ['--job-dir', root, '--oodsets'] + list(WIM_SETS) + [
        '--batch-size', str(WIM_BATCH), '--test-batch-size',
        str(WIM_TEST_BATCH)]

    # the engines' and the fine-tune's stages, timed around (synchronised)
    spent = {}

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return res
        return call
    patched = [(ft_job, '_both_prior_losses'), (ft_job, 'ood_detection_rates'),
               (ft_cli, 'record_latents'), (ft_cli, 'finetune')]
    real = {(m, n): getattr(m, n) for m, n in patched}
    old_cwd = os.getcwd()
    runs = {}
    try:
        os.chdir(cwd)
        for m, n in patched:
            setattr(m, n, timed(n, real[(m, n)]))
        for name, argv, want in (
                ('ft', ['0', '--train-size', str(WIM_TRAIN_SIZE),
                        '--inspection'],
                 _ft_want(WIM_TRAIN_SIZE // WIM_BATCH, n_sets * batches,
                          n_sets * batches,
                          2 * n_sets * WIM_LATENT_BATCHES)),
                ('ft_task1', ['0', '--train-size', str(WIM_TRAIN_SIZE_2),
                              '--task', '1'],
                 _ft_want(WIM_TRAIN_SIZE_2 // WIM_BATCH, n_sets * batches,
                          n_sets * batches))):
            spent.clear()
            seen = set(_job_dirs(os.path.join(root, 'wim')))
            _count_reset()
            t0 = time.perf_counter()
            with open(os.path.join(WORK, name + '.out'), 'w') as f, \
                    contextlib.redirect_stdout(f):
                # --- the main path of phase 9 (the first run) ---
                rc = ft_cli.main(argv + common)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts()
            # --- end of the main path ---
            if rc != 0 or launches != want:
                raise AssertionError('{}: exit {}, launches {}, want {}'
                                     .format(name, rc, launches, want))
            (d,) = set(_job_dirs(os.path.join(root, 'wim'))) - seen
            runs[name] = {'dir': d, 'wall_s': wall, 'launches': launches,
                          'stages_s': dict(spent)}
    finally:
        os.chdir(old_cwd)
        for (m, n), fn in real.items():
            setattr(m, n, fn)
    if _digest(src) != before:
        raise AssertionError('the source job changed')
    d1, d2 = runs['ft']['dir'], runs['ft_task1']['dir']
    for d, number in ((d1, 1), (d2, 2)):
        tp = load_json(os.path.join(d, 'train_params.json'))
        if (load_json(os.path.join(d, 'params.json'))['job_number'] != number
                or tp['from_job'] != 0 or tp['wim']['init_mean'] != 8.0):
            raise AssertionError('{}: job {} from {}'.format(
                d, number, tp.get('from_job')))
        edir = os.path.join(d, 'samples', '0000')
        for f in ('wim_prior.npz', 'state.npz', 'optimizer.npz'):
            if not os.path.exists(os.path.join(d, f)):
                raise AssertionError('{} has no {}'.format(d, f))
        if not os.path.exists(os.path.join(edir, 'init', 'ood.json')):
            raise AssertionError('no pre-tuning ood.json in ' + edir)
        for s in ('cifar100',) + WIM_SETS:
            rec = LossRecorder.load(find_record(edir, s))
            if ('y_est_already' not in rec or 'total@' not in rec
                    or rec.recorded_samples != OOD_SET_SIZE):
                raise AssertionError('record of {} in {}'.format(s, edir))
        ood = load_json(os.path.join(d, 'ood.json'))[0]
        aucs = [r['auc'] for ms in ood.values() for r in ms.values()]
        if len(aucs) != len(WIM_SETS) * len(WIM_METHODS) or not np.all(
                np.isfinite(aucs)):
            raise AssertionError('WIM results of {}: {}'.format(d, aucs))
    edir = os.path.join(d1, 'samples', '0000')
    for f in ('inspection.json', 'proj2d-pca.csv', 'sample-cifar100.npz',
              os.path.join('init', 'sample-cifar100.npz')):
        if not os.path.exists(os.path.join(edir, f)):
            raise AssertionError('--inspection wrote no ' + f)
    inspection = load_json(os.path.join(edir, 'inspection.json'))
    both_s = runs['ft']['stages_s']['_both_prior_losses']
    both_images = n_sets * OOD_SET_SIZE

    # --- the array pass and the test CLI's replay: no launch ---
    saved = {d: (load_json(os.path.join(d, 'ood.json'))[0],
                 load_json(os.path.join(d, 'test.json'))[0]['already'])
             for d in (d1, d2)}
    _count_reset()
    t0 = time.perf_counter()
    with open(os.path.join(WORK, 'ft_array.out'), 'w') as f, \
            contextlib.redirect_stdout(f):
        rc = ft_cli.main(['--array', arrays[0], '--register', d1, d2,
                          '--oodsets'] + list(WIM_SETS))
    array_s = time.perf_counter() - t0
    array_launches = _counts()
    direct = WIMArray(arrays[1])
    direct.register_jobs(d1, d2)
    want = direct.recompute_rates(ft_job.load_wim_job(d1), 'cifar100',
                                  list(WIM_SETS))
    got = load_json(os.path.join(arrays[0], 'ood.json'))
    if (rc != 0 or any(array_launches.values())
            or got != json.loads(json.dumps(want))):
        raise AssertionError('array pass: exit {}, launches {}, rates equal '
                             '{}'.format(rc, array_launches,
                                         got == json.loads(json.dumps(want))))
    _count_reset()
    t0 = time.perf_counter()
    with open(os.path.join(WORK, 'ft_replay.out'), 'w') as f, \
            contextlib.redirect_stdout(f):
        rc = test_cli.main(['--job-dir', os.path.join(root, 'wim'),
                            '--compute', 're', '--sets', 'cifar100']
                           + list(WIM_SETS) + ['--ood-methods']
                           + list(WIM_METHODS)
                           + ['--predict-methods', 'already',
                              '--misclass-methods'] + list(WIM_MISCLASS))
    replay_s = time.perf_counter() - t0
    replay_launches = _counts()
    if rc != 0 or any(replay_launches.values()):
        raise AssertionError('replay: exit {}, launches {}'.format(
            rc, replay_launches))
    replay_worst = 0.0
    for d, (ood, mis) in saved.items():
        replay_worst = max(replay_worst, _wim_results_gate(
            ood, load_json(os.path.join(d, 'ood.json'))[0], d))
        got_mis = load_json(os.path.join(d, 'test.json'))[0]['already']
        for m in WIM_MISCLASS:
            err = abs(got_mis[m]['auc'] - mis[m]['auc'])
            replay_worst = max(replay_worst, err)
            if err > WIM_REPLAY_TOL:
                raise AssertionError('replayed misclassification {} {}: {} '
                                     'vs {}'.format(d, m, got_mis[m]['auc'],
                                                    mis[m]['auc']))

    # --- Poscod: 8 conv per batch, no combine ---
    seen = set(_job_dirs(os.path.join(root, 'wim')))
    poscod_epochs = 1                         # [wim-default] epochs
    train_steps = min(-(-OOD_SET_SIZE // WIM_BATCH), 512 // WIM_BATCH)
    want = _ft_want(0, 0, 0)
    want['same_grid_conv'] = SITES_PER_BATCH * (
        2 * poscod_epochs * train_steps + n_sets * batches)
    old_cwd = os.getcwd()
    try:
        os.chdir(cwd)
        _count_reset()
        t0 = time.perf_counter()
        with open(os.path.join(WORK, 'ft_poscod.out'), 'w') as f, \
                contextlib.redirect_stdout(f):
            rc = ft_cli.main(['0', '--poscod'] + common)
        torch.cuda.synchronize()
        poscod_s = time.perf_counter() - t0
        poscod_launches = _counts()
    finally:
        os.chdir(old_cwd)
    (d3,) = set(_job_dirs(os.path.join(root, 'wim'))) - seen
    if rc != 0 or poscod_launches != want:
        raise AssertionError('poscod: exit {}, launches {}, want {}'.format(
            rc, poscod_launches, want))
    if _digest(src) != before:
        raise AssertionError('the source job changed')
    pc = load_poscod_job(d3)
    with np.load(os.path.join(d3, POSCOD_HEAD_FILE)) as z:
        if not all(np.array_equal(pc.head[k].cpu().numpy(), z[k])
                   for k in ('w', 'b')) or pc.head['w'].shape != (128,):
            raise AssertionError('the Poscod head does not reload')
    poscod_auc = {s: load_json(os.path.join(d3, 'ood.json'))[0][s]['llr']['auc']
                  for s in WIM_SETS}

    steps = time_finetune_steps(src)
    summary = {'card': card, 'gate': gate,
               'cli': {k: {'wall_s': r['wall_s'], 'launches': r['launches'],
                           'stages_s': r['stages_s']}
                       for k, r in runs.items()},
               'train_size': WIM_TRAIN_SIZE, 'steps': WIM_TRAIN_SIZE // WIM_BATCH,
               'both_prior_images_per_s': both_images / both_s,
               'both_prior_s': both_s, 'inspection': inspection,
               'array_s': array_s, 'array_launches': array_launches,
               'replay_s': replay_s, 'replay_launches': replay_launches,
               'replay_worst_err': replay_worst,
               'poscod_s': poscod_s, 'poscod_launches': poscod_launches,
               'poscod_auc': poscod_auc,
               'ood_auc': {s: {m: r['auc'] for m, r in ms.items()}
                           for s, ms in saved[d1][0].items()},
               'finetune_steps': steps}
    print('wim', json.dumps(summary), flush=True)
    return runs['ft']['launches'], poscod_launches, summary


# phase 10: trunks and drivers.  The ResNet flagship is the flagship with
# features='resnet18' (full width 64): its trunk's convs are cuDNN, so
# the same-grid conv runs at the decoder's six sites (deconv32: two
# stride-1 deconvs, two sub-pixel deconvs, the head; its 1x1 expansion
# is a matmul) and its input gradient at the same six per train step.
RESNET_SITES, RESNET_DX = 6, 6
# batch statistics over 8 values at the trunk's 1x1 maps make a training
# step chaotic in float32 (tests/test_torch_resnet.py); the gate takes 64
RESNET_GATE_BATCH = 64
TRUNK_GRAD_NOTE = ('cuDNN float32 backward through the trunk, amplified '
                   'by training-mode BatchNorm (ROADMAP Queue 3; scripts/'
                   'time_torch_trunk_grads.py), and ReLU flips of the '
                   'dense encoder at batch 64')
TRUNK_ARCHS = ('resnet50', 'densenet121')
DRIVER_SETS = ('cifar10', 'svhn', 'lsunc')     # phase 6's OOD sets


def resnet_config():
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    return dataclasses.replace(flagship_config(), features='resnet18')


def _sites(cfg) -> int:
    """Same-grid launches of one evaluate of a flagship-shaped model."""
    return RESNET_SITES if cfg.features.startswith('resnet') else SITES_PER_BATCH


def resnet_serve_gate(job_dir: str) -> dict:
    """Card against CPU on 8 inputs with injected noise: every per-class
    loss and every Scorer score at the serving tolerance."""
    from joint_vae_tpu_torch.models.evaluate import evaluate
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.serve import Scorer
    res = {}
    for dev in ('cuda', 'cpu'):
        j = load_job(job_dir, device=dev)
        cfg = j.model_cfg
        rng = np.random.default_rng(11)
        x8 = rng.uniform(0, 1, (8,) + cfg.input_shape).astype(np.float32)
        eps = rng.standard_normal((cfg.test_latent_sampling + 1, 8,
                                   cfg.latent_dim)).astype(np.float32)
        eps[0] = 0.0
        out = evaluate(j.model, torch.as_tensor(x8, device=j.device), None,
                       sigma_state=j.sigma_state, eps=torch.as_tensor(eps),
                       decode_mean=False)
        sc = Scorer(j, methods=METHODS,
                    thresholds={m: float('-inf') for m in METHODS})(
                        x8, eps=torch.as_tensor(eps))
        res[dev] = dict({'loss ' + k: v.cpu().numpy()
                         for k, v in out.losses.items()},
                        **{'score ' + m: sc['scores'][m] for m in METHODS})
    worst = {}
    for k, want in res['cpu'].items():
        got = res['cuda'][k]
        worst[k] = float(np.max(np.abs(got.astype(np.float64) - want)
                                / np.maximum(np.abs(want), 1e-30)))
        np.testing.assert_allclose(got, want, rtol=SERVE_RTOL,
                                   atol=SERVE_ATOL,
                                   err_msg='ResNet card vs CPU, ' + k)
    return worst


def resnet_scorer(job) -> dict:
    """The ResNet flagship through ``Scorer`` on BATCHES batches of 512 at
    L=16: 6 conv and 1 combine launches per batch."""
    from joint_vae_tpu_torch.serve import Scorer
    cfg = job.model_cfg
    xs = np.random.default_rng(12).uniform(
        0, 1, (BATCHES + 1, BATCH) + cfg.input_shape).astype(np.float32)
    scorer = Scorer(job, methods=METHODS,
                    thresholds={m: float('-inf') for m in METHODS})
    scorer(xs[0])                                 # meets its shapes first
    torch.cuda.synchronize()
    _count_reset()
    # --- the main path: Scorer batches ---
    t0 = time.perf_counter()
    outs = [scorer(xs[1 + b]) for b in range(BATCHES)]
    serve_s = time.perf_counter() - t0
    launches = _counts()
    # --- end of the main path ---
    if launches != {'same_grid_conv': RESNET_SITES * BATCHES,
                    'same_grid_conv_dx': 0, 'iws_combine': BATCHES}:
        raise AssertionError('ResNet Scorer launches {}'.format(launches))
    for o in outs:
        for m in METHODS:
            if not np.all(np.isfinite(o['scores'][m])):
                raise AssertionError('ResNet Scorer: non-finite {}'.format(m))
    return {'launches': launches, 'serve_seconds': serve_s,
            'serve_images_per_s': BATCH * BATCHES / serve_s}


def trunk_card_vs_cpu(arch: str) -> dict:
    """One inference forward of a full-width trunk (random weights and
    BatchNorm statistics from a numpy seed) on 8 images, card against
    CPU in the conv's form: |card - cpu| <= 1e-4 (|cpu| + rms(cpu))."""
    from joint_vae_tpu_torch.models.resnet import build_trunk
    trunk = build_trunk(arch, (3, 32, 32))
    rng = np.random.default_rng(13)
    with torch.no_grad():
        for name, t in trunk.state_dict().items():
            if name.endswith('running_var'):
                v = rng.uniform(0.5, 1.5, t.shape)
            elif name.endswith('running_mean') or name.endswith('bias'):
                v = 0.1 * rng.standard_normal(t.shape)
            elif t.ndim == 4:
                v = rng.standard_normal(t.shape) / np.sqrt(np.prod(t.shape[1:]))
            else:
                v = 1.0 + 0.1 * rng.standard_normal(t.shape)
            t.copy_(torch.from_numpy(v))
    x = torch.from_numpy(rng.uniform(0, 1, (8, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        want = trunk(x)
        got = trunk.to('cuda')(x.to('cuda')).cpu()
    rms = want.square().mean().sqrt().item()
    worst = ((got - want).abs() / (want.abs() + rms)).max().item()
    if worst > CONV_TOL[torch.float32]:
        raise AssertionError('{} card vs CPU: {}'.format(arch, worst))
    return {'output': list(want.shape[1:]),
            'params': sum(p.numel() for p in trunk.parameters()),
            'worst_err_over_abs_plus_rms': worst}


def transfer_checks(job, donor_dir: str) -> dict:
    """A job trained with ``--pretrained-features <ResNet job>``: it
    records the trunk frozen, its trunk parameters equal the donor's bit
    for bit after training, every other trainable tensor moved from its
    initial value (the seed-0 init) and the untrainable ones did not."""
    from joint_vae_tpu_torch.save_load.checkpoint import load_arrays
    from joint_vae_tpu_torch.save_load.from_jax import (param_paths,
                                                        state_dict_to_jax)
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.state import grad_mask
    tp = job.training_parameters
    if (tp.get('frozen_modules') != ['features_stack'] or job.trained != 1
            or tp.get('pretrained_features') != donor_dir):
        raise AssertionError('transfer job: {}'.format(
            {k: tp.get(k) for k in ('frozen_modules', 'pretrained_features')}))
    got = state_dict_to_jax(job.model)
    donor = load_arrays(os.path.join(donor_dir, 'state.npz'))
    init = state_dict_to_jax(new_job(job.model_cfg, seed=0, device='cpu').model)
    mask = grad_mask(job.model)
    trunk, trainable, fixed = [], [], []
    for name, path in param_paths(job.model).items():
        k = 'params/' + path
        (trunk if path.startswith('features_stack/') else
         trainable if mask[name] else fixed).append(k)
    if not trunk or not all(np.array_equal(got[k], donor[k]) for k in trunk):
        raise AssertionError('the transferred trunk moved')
    if (not all(not np.array_equal(got[k], init[k]) for k in trainable)
            or not all(np.array_equal(got[k], init[k]) for k in fixed)):
        raise AssertionError('transfer job: a trainable tensor did not move '
                             'or an untrainable one did')
    return {'trunk_tensors_equal': len(trunk),
            'trainable_tensors_moved': len(trainable),
            'untrainable_tensors_kept': len(fixed)}


def _driver_store(flagship_dir: str, resnet_dir: str) -> str:
    """A job store holding phase 6's flagship (job 1) and the ResNet
    flagship (job 2), both naming cifar100."""
    from joint_vae_tpu_torch.save_load.jobs import load_job, save_job
    store = os.path.join(WORK, 'driver_jobs')
    shutil.rmtree(store, ignore_errors=True)
    for n, src, name in ((1, flagship_dir, 'flagship'),
                         (2, resnet_dir, 'resnet')):
        d = os.path.join(store, 'cifar100', name, '{:06d}'.format(n))
        shutil.copytree(src, d, ignore=shutil.ignore_patterns('samples'))
        j = load_job(d, ghost=True)
        j.job_number = n
        j.training_parameters['set'] = 'cifar100'
        save_job(j, d, save_state=False)
    return store


def _quiet(fn, *args):
    """fn(*args) with its standard output captured; (result, text)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def drivers(store: str, resnet_dir: str) -> tuple:
    """The analysis drivers on the card over phase 6's flagship (job 1)
    and the ResNet flagship (job 2, trained in ``resnet_dir``), launches
    counted per tool; the grid's trainings transfer the ResNet flagship's
    trunk (``--pretrained-features``)."""
    from joint_vae_tpu_torch.cli import aggregate as agg_cli
    from joint_vae_tpu_torch.cli import cascade as cascade_cli
    from joint_vae_tpu_torch.cli import grid as grid_cli
    from joint_vae_tpu_torch.cli import sample as sample_cli
    from joint_vae_tpu_torch.data.registry import get_same_size_by_name
    from joint_vae_tpu_torch.evals import sample as sample_mod
    from joint_vae_tpu_torch.results import mutual_info
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.save_load.recorders import LossRecorder, find_record
    out, launches = {}, {}
    n_test = OOD_SET_SIZE
    batches = -(-n_test // OOD_BATCH)

    # sample: its evaluate calls counted by model, each launching the
    # model's sites and one combine; the generation grid decodes once
    calls = []
    real = sample_mod.evaluate
    sample_mod.evaluate = lambda model, *a, **k: (
        calls.append(_sites(model.cfg)) or real(model, *a, **k))
    try:
        _count_reset()
        t0 = time.perf_counter()
        rc, text = _quiet(sample_cli.main, ['1', '--job-dir', store, '--grids',
                                            'reco', 'gen', 'zsample',
                                            '--compare', '2'])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches['sample'] = _counts()
    finally:
        sample_mod.evaluate = real
    want = {'same_grid_conv': sum(calls) + RESNET_SITES,
            'same_grid_conv_dx': 0, 'iws_combine': len(calls)}
    if rc != 0 or launches['sample'] != want:
        raise AssertionError('sample: rc {}, launches {}, want {}'.format(
            rc, launches['sample'], want))
    grids = os.path.join(_job_dirs(store)[0], 'samples', 'grids')
    with np.load(os.path.join(grids, 'generation.npz')) as z:
        gen = z['x']
    with np.load(os.path.join(grids, 'comparison.npz')) as z:
        recos, mse = z['recos'], z['mse']
    with np.load(os.path.join(grids, 'reco-cifar100.npz')) as z:
        reco = {k: z[k] for k in z.files}
    if (gen.shape != (100, 8, 3, 32, 32) or recos.shape != (2, 8, 3, 32, 32)
            or mse.shape != (2, 2) or reco['samples'].shape != (8, 8, 3, 32, 32)
            or not all(np.all(np.isfinite(a)) for a in
                       (gen, recos, mse, reco['mean'], reco['average']))):
        raise AssertionError('sample: bad grids')
    images = 8 * len(calls)
    out['sample'] = {'seconds': seconds, 'evaluate_calls': len(calls),
                     'launches': launches['sample'],
                     'comparison_mse': mse.tolist()}

    # aggregate: both jobs over the test set, its record sets and its OOD
    # sets, batch 512; 6 or 8 conv and 1 combine per batch per job
    exclude = [s for s in get_same_size_by_name('cifar100')
               if s not in DRIVER_SETS]
    _count_reset()
    t0 = time.perf_counter()
    rc, text = _quiet(agg_cli.main, ['1', '2', '--job-dir', store, '--combos',
                                     '1', '2', '--record', '--batch-size',
                                     str(OOD_BATCH), '--sets-to-exclude']
                      + exclude)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches['aggregate'] = _counts()
    per_job = batches * (1 + (1 + len(DRIVER_SETS)) + len(DRIVER_SETS))
    want = {'same_grid_conv': per_job * (SITES_PER_BATCH + RESNET_SITES),
            'same_grid_conv_dx': 0, 'iws_combine': 2 * per_job}
    rows = [ln for ln in text.splitlines()
            if ln.startswith(('job ', 'ensemble ', 'combo ', 'ood '))]
    pcts = [float(ln.rsplit(' ', 1)[1].rstrip('%')) for ln in rows]
    if (rc != 0 or launches['aggregate'] != want
            or len(rows) != 2 + 4 + 2 + 4 + 4 * len(DRIVER_SETS)
            or not all(0 <= p <= 100 for p in pcts)):
        raise AssertionError('aggregate: rc {}, launches {}, want {}, rows '
                             '{}'.format(rc, launches['aggregate'], want, rows))
    rec_dir = os.path.join(store, 'cifar100', '1|2')
    for s in ('cifar100',) + DRIVER_SETS:
        r = LossRecorder.load(find_record(rec_dir, s))
        if (r.recorded_samples != n_test
                or not np.all(np.isfinite(r.get('Im-1')))):
            raise AssertionError('aggregate record {}'.format(s))
    out['aggregate'] = {'seconds': seconds, 'launches': launches['aggregate'],
                        'image_evaluations': 2 * per_job * n_test // batches,
                        'rows': rows[:8]}
    out['aggregate']['images_per_s'] = (2 * n_test * (per_job // batches)
                                        / seconds)

    # cascade flagship -> ResNet on 512 test images, with --record
    _count_reset()
    t0 = time.perf_counter()
    rc, text = _quiet(cascade_cli.main, ['1', '2', '--job-dir', store,
                                         '--record'])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches['cascade'] = _counts()
    want = {'same_grid_conv': 2 * (SITES_PER_BATCH + RESNET_SITES),
            'same_grid_conv_dx': 0, 'iws_combine': 4}
    if rc != 0 or launches['cascade'] != want or 'bayes-iterated' not in text:
        raise AssertionError('cascade: rc {}, launches {}, want {}'.format(
            rc, launches['cascade'], want))
    with open(os.path.join(_job_dirs(store)[0], 'samples', 'cascade',
                           'cascade.json')) as f:
        report = json.load(f)
    if report['n'] != OOD_BATCH or not np.all(np.isfinite(report['im_t'])):
        raise AssertionError('cascade report {}'.format(report))
    out['cascade'] = {'seconds': seconds, 'launches': launches['cascade'],
                      'images_per_s': 4 * OOD_BATCH / seconds,
                      'stages': report['stages']}

    # the Im(T) tables from both record dirs: host only
    _count_reset()
    t0 = time.perf_counter()
    rc, text = _quiet(mutual_info.main, [rec_dir, os.path.join(
        store, 'cifar100', '1-2')])
    seconds = time.perf_counter() - t0
    launches['mutual_info'] = _counts()
    if (rc != 0 or text.count('Im[ok]') != 2
            or any(launches['mutual_info'].values())):
        raise AssertionError('mutual_info: rc {}, launches {}'.format(
            rc, launches['mutual_info']))
    out['mutual_info'] = {'seconds': seconds, 'launches': launches['mutual_info']}

    # grid --run: two one-epoch trainings of the ResNet flagship with its
    # trunk transferred from job 2 (cli.train --pretrained-features), in
    # subprocesses
    grid_jobs = os.path.join(WORK, 'grid_jobs')
    shutil.rmtree(grid_jobs, ignore_errors=True)
    ini = os.path.join(WORK, 'grid.ini')
    with open(ini, 'w') as f:
        f.write('[resnet-beta]\n' + ''.join('{} = {}\n'.format(k, v) for k, v in (
            ('dataset', 'cifar100'), ('type', 'cvae'), ('features', 'resnet18'),
            ('upsampler', 'deconv32'), ('latent-dim', 128),
            ('encoder', 512), ('decoder', 512), ('classifier', ''),
            ('gamma', 500), ('beta', '1e-4 1e-3'), ('sigma', 0.1),
            ('latent-sampling', 1), ('test-latent-sampling', 16),
            ('prior', 'gaussian'), ('prior-means', 17),
            ('learned-prior-means', 'true'), ('lr', '1e-4'), ('epochs', 1),
            ('batch-size', 256), ('test-batch-size', 512),
            ('dataset-size', CLI_SIZE), ('oodsets', ''),
            ('no-final-ood', 'true'), ('pretrained-features', resnet_dir),
            ('job-dir', grid_jobs))))
    t0 = time.perf_counter()
    with contextlib.chdir(ROOT):
        rc, text = _quiet(grid_cli.main, [ini, '--run'])
    seconds = time.perf_counter() - t0
    done = [load_job(d) for d in _job_dirs(grid_jobs)]
    betas = sorted(j.model_cfg.beta for j in done)
    if (rc != 0 or betas != [1e-4, 1e-3] or any(j.trained != 1 for j in done)
            or 'joint_vae_tpu_torch.cli.train' not in text):
        raise AssertionError('grid --run: rc {}, betas {}'.format(rc, betas))
    out['grid'] = {'seconds': seconds, 'jobs': len(done),
                   'images_per_s': 2 * CLI_SIZE / seconds,
                   'transfer': [transfer_checks(j, resnet_dir) for j in done],
                   'note': 'two train CLIs in subprocesses; their launches '
                           'are not counted here'}
    out['sample']['images_per_s'] = images / out['sample']['seconds']
    return launches, out


def trunks_and_drivers(card: str) -> tuple:
    """Phase 10: the ResNet flagship trained, served and checked against
    the CPU; resnet50 and densenet121 on the card; pretrained transfer
    through the train CLI; the analysis drivers over phase 6's flagship
    and the ResNet flagship."""
    t_phase = time.perf_counter()
    cfg = resnet_config()
    train_launches, summary, job = train(
        card, cfg=cfg, sites=RESNET_SITES, dx=RESNET_DX, name='resnet_train',
        gate_batch=RESNET_GATE_BATCH, gate_trunk=True)
    resnet_dir = os.path.join(WORK, 'resnet_train_job')
    serve_gate = resnet_serve_gate(resnet_dir)
    serve = resnet_scorer(job)
    trunks = {arch: trunk_card_vs_cpu(arch) for arch in TRUNK_ARCHS}
    store = _driver_store(os.path.join(WORK, 'flagship_job'), resnet_dir)
    driver_launches, tools = drivers(store, resnet_dir)
    prof = summary['profile']
    resnet = {'trunk_params': sum(p.numel() for p in
                                  job.model.features_stack.parameters()),
              'ms_per_step': summary['ms_per_step'],
              'train_images_per_s': summary['train_images_per_s'],
              'serve_images_per_s': serve['serve_images_per_s'],
              'device_busy_share': prof['device_busy_share'],
              'step_device_ms': prof['device_ms'],
              'trunk_cudnn_ms': prof['by_name_ms'].get('cudnn'),
              'same_grid_kernel_ms': prof['by_name_ms'].get('same_grid_kernel'),
              'by_span_ms': prof['by_span_ms'],
              'launches_step': train_launches,
              'launches_serve': serve['launches'],
              'serve_card_vs_cpu_worst_rel': max(serve_gate.values()),
              'train_card_vs_cpu': summary['card_vs_cpu'],
              'trunks': trunks, 'card': card}
    print('resnet', json.dumps(resnet), flush=True)
    phase_s = time.perf_counter() - t_phase
    line = {'phase_seconds': phase_s, 'test_set': OOD_SET_SIZE,
            'aggregate_sets': ['cifar100'] + list(DRIVER_SETS),
            'cut': 'aggregate records and scores cifar100 and phase 6\'s '
                   'three OOD sets, not all 14 companions', 'card': card}
    line.update(tools)
    print('drivers', json.dumps(line), flush=True)
    return train_launches, serve['launches'], driver_launches, resnet, line


# phase 11: reference-trained jobs (moxime/joint-vae's PyTorch layout)
# imported and run on the card.  The flagship's reference job: phase 6's
# job trained 3 more steps at batch 1024 with bench.py's Adam (lr 1e-4),
# saved at epoch 2 with phase 6's results and record files; the ResNet
# flagship's: a torchvision-layout resnet18 trunk (save_load/tv_resnet.py)
# beside a port model's other weights; a third job whose params.json is
# corrupt
INTEROP_SOURCE_STEPS = 3
INTEROP_EPOCH = 2
INTEROP_RESUME_STEPS = 4
INTEROP_SETS = ('cifar100', 'cifar10')   # cli.test: the test set, one OOD set
INTEROP_JOBS = {'flagship': ('cifar100', 'flagship', 'adam', 21),
                'resnet': ('cifar100', 'resnet18', 'adam', 22),
                'corrupt': ('cifar100', 'flagship', 'adam', 23)}
PROBE_START, PROBE_CEILING = 512, 1 << 18
KERNEL_NAMES = {'same_grid_conv': ('tc_conv_kernel', 'simt_conv_kernel'),
                'iws_combine': ('iws_combine_kernel',)}


def _npz_members(path: str) -> dict:
    import zipfile
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _tree_differences(a: str, b: str) -> list:
    """Relative paths whose contents differ between two job trees: byte
    for byte, except that an ``.npz`` is compared member by member
    (``np.savez`` stamps each member with the time it was written)."""
    def files(root):
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(root) for f in fs}
    fa, fb = files(a), files(b)
    diff = sorted(fa ^ fb)
    for rel in sorted(fa & fb):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith('.npz'):
            same = _npz_members(pa) == _npz_members(pb)
        else:
            with open(pa, 'rb') as f, open(pb, 'rb') as g:
                same = f.read() == g.read()
        if not same:
            diff.append(rel)
    return diff


def _trace_kernels(log_dir: str) -> dict:
    """What the Chrome trace that ``trace`` wrote holds of the two
    kernels: the wrappers' launch spans (``<kernel>.launch``, recorded on
    the host) and the kernel records by name; beside them the trace's
    kernel records and launch calls of any kind."""
    files = [f for f in os.listdir(log_dir) if f.endswith('.json')]
    if len(files) != 1:
        raise AssertionError('trace files {}'.format(files))
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)['traceEvents']
    names = [e.get('name', '') for e in events if e.get('cat') == 'kernel']
    spans = [e.get('name', '') for e in events
             if e.get('cat') == 'user_annotation']
    return {'launch_spans': {k: spans.count(k + '.launch')
                             for k in KERNEL_NAMES},
            'kernel_records': {k: sum(any(s in n for s in subs)
                                      for n in names)
                               for k, subs in KERNEL_NAMES.items()},
            'all_kernel_records': len(names),
            'all_launch_calls': sum(
                e.get('cat') == 'cuda_runtime' and 'Launch' in
                e.get('name', '') for e in events)}


def _write_interop_sources(ref: str, src, phase6_dir: str) -> dict:
    """The three reference-layout job directories under ``ref``."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from torch_reference_layout import loss_record_dump, write_reference_job
    from joint_vae_tpu_torch.models.cvnet import CVNet, init_weights
    from joint_vae_tpu_torch.save_load import tv_resnet
    from joint_vae_tpu_torch.save_load.checkpoint import load_json
    from joint_vae_tpu_torch.save_load.from_jax import (opt_state_to_jax,
                                                        state_dict_to_jax)
    from joint_vae_tpu_torch.save_load.jobs import default_training_parameters
    from joint_vae_tpu_torch.save_load.recorders import LossRecorder, find_record
    dirs = {k: os.path.join(ref, *map(str, v)) for k, v in INTEROP_JOBS.items()}
    cfg = src.model_cfg
    tp = dict(default_training_parameters(cfg, src.opt_cfg), set='cifar100',
              epochs=INTEROP_EPOCH, batch_size=TRAIN_BATCH)
    results = {n: load_json(os.path.join(phase6_dir, n + '.json'))
               for n in ('test', 'ood')}
    sdir = os.path.join(phase6_dir, 'samples', '0000')
    sets = ('cifar100',) + OOD_SETS
    records = {str(INTEROP_EPOCH): {
        'record-{}.pth'.format(s): loss_record_dump(
            LossRecorder.load(find_record(sdir, s)), device='cuda')
        for s in sets}}
    arrays = state_dict_to_jax(src.model)
    arrays['sigma_state/data'] = src.sigma_state.data.cpu().numpy()
    t0 = time.perf_counter()
    write_reference_job(
        dirs['flagship'], dict(cfg.architecture,
                               job_number=INTEROP_JOBS['flagship'][-1]),
        arrays, training_parameters=tp,
        history={'epochs': INTEROP_EPOCH},
        test={INTEROP_EPOCH: results['test'].get(0, {})},
        ood={INTEROP_EPOCH: results['ood'].get(0, {})},
        opt_arrays=opt_state_to_jax(src.model, src.opt_cfg,
                                    src.state.opt_state),
        param_group={'lr': src.opt_cfg.lr}, records=records,
        sigma_subclass=True, device='cuda')
    write_s = {'flagship': time.perf_counter() - t0}
    # the ResNet flagship: a torchvision resnet18 trunk with random
    # running statistics, the rest from a port model of that config
    rcfg = resnet_config()
    torch.manual_seed(22)
    trunk = tv_resnet.resnet18().eval()
    g = torch.Generator().manual_seed(22)
    with torch.no_grad():
        for m in trunk.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                       generator=g))
                m.running_var.copy_(1 + 0.3 * torch.rand(
                    m.running_var.shape, generator=g))
    rest = init_weights(CVNet(rcfg), 22)
    rarrays = state_dict_to_jax(rest)
    t0 = time.perf_counter()
    write_reference_job(
        dirs['resnet'], dict(rcfg.architecture,
                             job_number=INTEROP_JOBS['resnet'][-1]),
        rarrays, training_parameters=dict(tp),
        history={'epochs': INTEROP_EPOCH}, trunk=trunk)
    write_s['resnet'] = time.perf_counter() - t0
    os.makedirs(dirs['corrupt'])
    with open(os.path.join(dirs['corrupt'], 'params.json'), 'w') as f:
        f.write('{ this is not json')
    return {'dirs': dirs, 'trunk': trunk, 'rest': rarrays,
            'write_seconds': write_s, 'sets': sets}


def _probe(name: str, step_fn) -> dict:
    """``compute_max_batch_size`` from PROBE_START up to PROBE_CEILING,
    with the batch that ran out, the seconds and the memory counters."""
    from joint_vae_tpu_torch.utils.device import compute_max_batch_size
    from joint_vae_tpu_torch.utils.profiling import device_memory_stats
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = device_memory_stats()
    ran_out, sizes = [], []

    def fn(n):
        sizes.append(n)
        try:
            step_fn(n)
            torch.cuda.synchronize()
        except torch.OutOfMemoryError:
            ran_out.append(n)
            raise
    t0 = time.perf_counter()
    best = compute_max_batch_size(fn, start=PROBE_START,
                                  ceiling=PROBE_CEILING, key=('interop', name))
    seconds = time.perf_counter() - t0
    after = device_memory_stats()
    if not ran_out or best < 1:
        raise AssertionError('{} probe: best {}, ran out at {}'.format(
            name, best, ran_out))
    return {'largest_batch': best, 'ran_out_at': ran_out, 'sizes': sizes,
            'seconds': seconds, 'memory_before': before,
            'memory_after': after}


def interop(card: str) -> tuple:
    """Phase 11: reference-trained jobs imported through the import CLI
    (on the card and on the CPU, the trees byte-compared), the imported
    state held against its source, ``cli.test`` on the imported flagship
    (the recorder tier, then a recompute), training resumed from the
    imported optimizer state, the OOM batch probe, a trace and a crash
    dump."""
    from joint_vae_tpu_torch.cli import test as test_cli
    from joint_vae_tpu_torch.device import to_device
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.checkpoint import load_json, save_json
    from joint_vae_tpu_torch.save_load.from_jax import state_dict_to_jax
    from joint_vae_tpu_torch.save_load.import_reference import \
        import_reference_job
    from joint_vae_tpu_torch.save_load.jobs import load_job, new_job
    from joint_vae_tpu_torch.save_load.recorders import find_record
    from joint_vae_tpu_torch.serve import Scorer
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.state import create_train_state
    from joint_vae_tpu_torch.train.steps import make_train_step
    from joint_vae_tpu_torch.utils.device import dump_crash
    from joint_vae_tpu_torch.utils.profiling import trace

    root = os.path.join(WORK, 'interop')
    shutil.rmtree(root, ignore_errors=True)
    phase6_dir = os.path.join(WORK, 'flagship_job')
    cfg = flagship_config()
    rng = np.random.default_rng(21)

    # --- the source: phase 6's job, 3 steps of bench.py's Adam ---
    src = load_job(phase6_dir)
    src.opt_cfg = OptimizerConfig(lr=TRAIN_LR)
    src.state = create_train_state(src.model, src.opt_cfg, seed=21)
    step = make_train_step(src.model, src.opt_cfg)
    xb = torch.as_tensor(rng.uniform(0, 1, (TRAIN_BATCH,) + cfg.input_shape)
                         .astype(np.float32), device='cuda')
    yb = torch.as_tensor(rng.integers(0, cfg.num_labels, TRAIN_BATCH),
                         device='cuda')
    for _ in range(INTEROP_SOURCE_STEPS):
        src.state, _ = step(src.state, xb, yb)
    torch.cuda.synchronize()
    made = _write_interop_sources(os.path.join(root, 'ref'), src, phase6_dir)
    dirs = made['dirs']
    rel = {k: os.path.join(*map(str, v)) for k, v in INTEROP_JOBS.items()}

    # --- the import CLI, on the card and on the CPU ---
    cli_s, trees = {}, {}
    for dev in ('cuda', 'cpu'):
        trees[dev] = os.path.join(root, 'jobs_' + dev)
        argv = [sys.executable, '-m', 'joint_vae_tpu_torch.cli.import_ref',
                '--scan', os.path.join(root, 'ref'), '-J', trees[dev]]
        if dev == 'cpu':
            argv += ['--device', 'cpu']
        t0 = time.perf_counter()
        r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
        cli_s[dev] = time.perf_counter() - t0
        if r.returncode != 1 or '2 imported, 1 failed' not in r.stdout:
            raise AssertionError('import CLI ({}) exited {}: {}\n{}'.format(
                dev, r.returncode, r.stdout, r.stderr[-3000:]))
        if rel['corrupt'] not in r.stderr:
            raise AssertionError('import CLI ({}) did not name the corrupt '
                                 'job: {}'.format(dev, r.stderr[-3000:]))
    diff = _tree_differences(trees['cuda'], trees['cpu'])
    if diff:
        raise AssertionError('card and CPU imports differ: {}'.format(diff))
    n_files = sum(len(fs) for _, _, fs in os.walk(trees['cuda']))
    # each job alone, in this process, on the card
    job_s = {}
    for k in ('flagship', 'resnet'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        import_reference_job(dirs[k], os.path.join(root, 'jobs_inproc',
                                                   rel[k]))
        job_s[k] = time.perf_counter() - t0
    diff = _tree_differences(os.path.join(root, 'jobs_inproc'), trees['cuda'])
    if diff:
        raise AssertionError('in-process and CLI imports differ: {}'.format(
            diff))

    # --- the imported state against its source, bit for bit ---
    fdir = os.path.join(trees['cuda'], rel['flagship'])
    imp = load_job(fdir)
    sd, sd2 = src.model.state_dict(), imp.model.state_dict()
    if set(sd) != set(sd2) or not all(torch.equal(sd[k], sd2[k]) for k in sd):
        raise AssertionError('imported weights differ from the source')
    o, o2 = src.state.opt_state, imp.state.opt_state
    if not (o.adam_count == o2.adam_count == INTEROP_SOURCE_STEPS
            and o.learning_rate == o2.learning_rate
            and set(o.mu) == set(o2.mu) == set(sd)
            and all(torch.equal(o.mu[k], o2.mu[k])
                    and torch.equal(o.nu[k], o2.nu[k]) for k in o.mu)
            and torch.equal(src.sigma_state.data, imp.sigma_state.data)
            and imp.trained == INTEROP_EPOCH
            and imp.job_number == INTEROP_JOBS['flagship'][-1]):
        raise AssertionError('imported optimizer or train state differs')
    # the imported records: phase 6's bytes
    for s in made['sets']:
        with open(find_record(os.path.join(phase6_dir, 'samples', '0000'),
                              s), 'rb') as f, \
                open(os.path.join(fdir, 'samples', '{:04d}'.format(
                    INTEROP_EPOCH), 'record-{}.jvr'.format(s)), 'rb') as g:
            if f.read() != g.read():
                raise AssertionError('imported record {} differs'.format(s))

    # --- a Scorer batch: imported against source, the same noise; the
    # imported batch traced (torch.profiler, a Chrome trace) ---
    x = rng.uniform(0, 1, (BATCH,) + cfg.input_shape).astype(np.float32)
    eps = torch.as_tensor(rng.standard_normal(
        (cfg.test_latent_sampling + 1, BATCH, cfg.latent_dim))
        .astype(np.float32), device='cuda')
    eps[0] = 0.0
    lows = {m: float('-inf') for m in METHODS}
    want = Scorer(src, methods=METHODS, thresholds=lows)(x, eps=eps)
    scorer = Scorer(imp, methods=METHODS, thresholds=lows)
    scorer(x, eps=eps)                            # meets its shapes first
    trace_dir = os.path.join(root, 'traces')
    torch.cuda.synchronize()
    _count_reset()
    # --- the main path: one traced Scorer batch on the imported job ---
    with trace(trace_dir):
        got = scorer(x, eps=eps)
    serve_launches = _counts()
    # --- end of the main path ---
    traced = _trace_kernels(trace_dir)
    if (serve_launches != _want(0, 1) or traced['launch_spans'] != {
            'same_grid_conv': SITES_PER_BATCH, 'iws_combine': 1}
            or not all(traced['kernel_records'].values())):
        raise AssertionError('imported Scorer batch: launches {}, traced '
                             '{}'.format(serve_launches, traced))
    serve_worst = 0.0
    for m in METHODS:
        np.testing.assert_allclose(got['scores'][m], want['scores'][m],
                                   rtol=SERVE_RTOL, atol=SERVE_ATOL,
                                   err_msg='imported vs source, ' + m)
        serve_worst = max(serve_worst, float(np.max(np.abs(
            got['scores'][m] - want['scores'][m]))))
    if not np.array_equal(got['label'], want['label']):
        raise AssertionError('imported and source labels differ')

    # --- the imported ResNet flagship: its trunk against tv_resnet's
    # eval-mode forward, its other weights bit-equal, a Scorer batch ---
    rimp = load_job(os.path.join(trees['cuda'], rel['resnet']))
    got_r = state_dict_to_jax(rimp.model)
    rest_equal = all(np.array_equal(got_r[k], v)
                     for k, v in made['rest'].items()
                     if '/features_stack/' not in k)
    xr = torch.as_tensor(x[:64], device='cuda')
    trunk = made['trunk'].cuda()
    with torch.no_grad():
        tv = torch.nn.Sequential(*list(trunk.children())[:-1])(xr)
        ours = rimp.model.features_stack(xr)
    trunk_err = ((ours - tv).abs() / (tv.abs() + tv.square().mean().sqrt())
                 ).max().item()
    bn0 = torch.equal(rimp.model.features_stack.BatchNorm_0.running_mean,
                      trunk.bn1.running_mean)
    if not (rest_equal and bn0 and trunk_err <= CONV_TOL[torch.float32]):
        raise AssertionError('imported ResNet flagship: rest equal {}, '
                             'stem statistics equal {}, trunk error {}'
                             .format(rest_equal, bn0, trunk_err))
    rscorer = Scorer(rimp, methods=METHODS, thresholds=lows)
    rscorer(x)
    torch.cuda.synchronize()
    _count_reset()
    # --- the main path: a Scorer batch on the imported ResNet flagship ---
    rout = rscorer(x)
    resnet_launches = _counts()
    # --- end of the main path ---
    if resnet_launches != {'same_grid_conv': RESNET_SITES,
                           'same_grid_conv_dx': 0, 'iws_combine': 1} or \
            not all(np.all(np.isfinite(rout['scores'][m])) for m in METHODS):
        raise AssertionError('imported ResNet Scorer: launches {}'.format(
            resnet_launches))
    del trunk, rimp, rscorer

    # --- cli.test on the imported flagship: the recorder tier, then a
    # recompute of accuracy, OOD and misclassification ---
    base = ['--job-dir', trees['cuda'], '--job',
            str(INTEROP_JOBS['flagship'][-1]), '--sets'] + list(
                INTEROP_SETS) + ['-M', str(OOD_BATCH)]
    # phase 6's OOD results, imported at epoch 2, are cleared, so that the
    # recorder tier must rebuild them from the imported record files
    stored = load_json(os.path.join(fdir, 'ood.json'))[INTEROP_EPOCH]
    save_json({}, os.path.join(fdir, 'ood.json'))
    _count_reset()
    with open(os.path.join(root, 'test_re.out'), 'w') as f, \
            contextlib.redirect_stdout(f):
        rc = test_cli.main(base + ['--compute', 're'])
    replay_launches = _counts()
    replayed = load_json(os.path.join(fdir, 'ood.json')).get(
        INTEROP_EPOCH, {})
    if rc != 0 or any(replay_launches.values()) or 'cifar10' not in replayed:
        raise AssertionError('cli.test --compute re: rc {}, launches {}, '
                             'sets {}'.format(rc, replay_launches,
                                              sorted(replayed)))
    replay_err = max(abs(replayed['cifar10'][m]['auc'] - r['auc'])
                     for m, r in stored['cifar10'].items()
                     if m in replayed['cifar10'])
    if not replay_err <= ROC_TOL:
        raise AssertionError('replayed AUCs vs phase 6\'s: {}'.format(
            replay_err))
    batches = -(-OOD_SET_SIZE // OOD_BATCH)
    # accuracy over the test set, the OOD engine over the test set and the
    # OOD set, misclassification over the test set: 8 conv and 1 combine
    # launches per batch of 512, the 272-image tail included
    passes = 1 + len(INTEROP_SETS) + 1
    want_test = _want(0, passes * batches)
    _count_reset()
    t0 = time.perf_counter()
    # --- the main path: cli.test --compute rehard ---
    with open(os.path.join(root, 'test_rehard.out'), 'w') as f, \
            contextlib.redirect_stdout(f):
        rc = test_cli.main(base + ['--compute', 'rehard'])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = _counts()
    # --- end of the main path ---
    recomputed = load_job(fdir, ghost=True)
    if rc != 0 or test_launches != want_test or 'cifar10' not in \
            recomputed.ood_results.get(INTEROP_EPOCH, {}):
        raise AssertionError('cli.test --compute rehard: rc {}, launches {} '
                             '(expected {})'.format(rc, test_launches,
                                                    want_test))

    # --- training resumed from the imported state: the first step beside
    # the source's first step on the same batch and noise ---
    eps_t = torch.as_tensor(rng.standard_normal(
        (cfg.latent_sampling + 1, TRAIN_BATCH, cfg.latent_dim))
        .astype(np.float32), device='cuda')
    eps_t[0] = 0.0
    xt = to_device(rng.uniform(0, 1, (TRAIN_BATCH,) + cfg.input_shape)
                   .astype(np.float32), torch.device('cuda'))
    yt = to_device(rng.integers(0, cfg.num_labels, TRAIN_BATCH),
                   torch.device('cuda'))
    step_i = make_train_step(imp.model, imp.opt_cfg)
    torch.cuda.synchronize()
    _count_reset()
    # --- the main path: 4 steps from the imported state ---
    t0 = time.perf_counter()
    state, first = step_i(imp.state, xt, yt, eps=eps_t)
    first = {k: v.item() for k, v in first.items()}
    t1 = time.perf_counter()
    for _ in range(INTEROP_RESUME_STEPS - 1):
        state, last = step_i(state, xt, yt)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t1
    resume_launches = _counts()
    # --- end of the main path ---
    first_s = t1 - t0
    imp.state = state
    if resume_launches != _want(INTEROP_RESUME_STEPS):
        raise AssertionError('resumed steps launched {}'.format(
            resume_launches))
    _, src_first = step(src.state, xt, yt, eps=eps_t)
    resume_err = {k: abs(first[k] - v.item()) / max(abs(v.item()), 1e-30)
                  for k, v in src_first.items()}
    if not (resume_err['total'] <= TRAIN_LOSS_RTOL
            and all(np.isfinite(v.item()) for v in last.values())):
        raise AssertionError('resumed first step vs the source\'s: {}'
                             .format(resume_err))
    del src, step, xb, yb, want, got

    # --- the card's memory: the largest Scorer batch at L=16 and the
    # largest train step; what runs after them must still run ---
    x_one = x[:1]

    def serve_n(n):
        scorer(np.ascontiguousarray(np.broadcast_to(
            x_one, (n,) + cfg.input_shape)))

    pjob = new_job(cfg, OptimizerConfig(lr=TRAIN_LR), seed=5)
    pstep = make_train_step(pjob.model, pjob.opt_cfg)
    pstate = [pjob.state]

    def train_n(n):
        xs = torch.rand((n,) + cfg.input_shape, device='cuda')
        ys = torch.randint(0, cfg.num_labels, (n,), device='cuda')
        pstate[0], _ = pstep(pstate[0], xs, ys)
    probes = {'scorer_l16': _probe('scorer_l16', serve_n),
              'train_step': _probe('train_step', train_n)}
    del pjob, pstep, pstate

    # --- after the probes: a crash dump of the imported job with a
    # batch on the card ---
    xd = torch.as_tensor(x[:64], device='cuda')
    yd = torch.as_tensor(rng.integers(0, cfg.num_labels, 64), device='cuda')
    d = dump_crash(imp, xd, yd, RuntimeError('phase 11 dump'),
                   log_dir=os.path.join(root, 'log'))
    with np.load(os.path.join(d, 'batch.npz')) as z:
        dumped = (np.array_equal(z['x'], xd.cpu().numpy())
                  and np.array_equal(z['y'], yd.cpu().numpy()))
    back = load_job(d)
    sd, sd2 = imp.model.state_dict(), back.model.state_dict()
    if not (dumped and all(torch.equal(sd[k], sd2[k]) for k in sd)):
        raise AssertionError('crash dump: batch read back {}'.format(dumped))
    out = {'import_cli_seconds': cli_s, 'import_job_seconds': job_s,
           'write_seconds': made['write_seconds'],
           'import_files': n_files, 'card_vs_cpu_tree': 'byte-equal',
           'serve_launches': serve_launches, 'trace': traced,
           'serve_imported_vs_source_max_abs_diff': serve_worst,
           'resnet_trunk_err_over_abs_plus_rms': trunk_err,
           'resnet_serve_launches': resnet_launches,
           'test_cli': {'argv': base + ['--compute', 'rehard'],
                        'seconds': test_s, 'launches': test_launches,
                        'images_per_s': passes * OOD_SET_SIZE / test_s,
                        'replay_launches': replay_launches,
                        'replay_auc_vs_phase6_max_abs_diff': replay_err},
           'resume': {'steps': INTEROP_RESUME_STEPS, 'batch': TRAIN_BATCH,
                      'first_step_ms': first_s * 1e3,
                      'ms_per_step': resume_s * 1e3
                      / (INTEROP_RESUME_STEPS - 1),
                      'launches': resume_launches,
                      'first_step_rel_err_vs_source': resume_err},
           'probe': probes, 'dump': d, 'card': card}
    print('interop', json.dumps(out), flush=True)
    return serve_launches, test_launches, resume_launches, resnet_launches, out


# ---------------------------------------------------------------------------
# phase 12: the device mesh (``joint_vae_tpu_torch/parallel``).  (a) A world
# of one rank over NCCL: the flagship's host-fed steps on a (1, 1) mesh
# against the same steps without one, the step and its all-reduce timed,
# the sharded checkpoint written with and without the asynchronous writer
# and restored into a run with no mesh.  (b) Two ranks on the one card over
# gloo (NCCL refuses two ranks on one device): the flagship's OOD
# evaluation on the 'model' and 'sample' axes and 4 steps on the 'model'
# axis against this process's one-process card run.  (c) The same over
# NCCL, one rank per card, when the machine has two cards or more.
# ---------------------------------------------------------------------------

MESH_STEPS, MESH_BATCH = 4, 1024
MESH_WARMUP, MESH_TIMED = 3, 10
MESH_WORLD1_RTOL = 1e-6          # a (1, 1) mesh against no mesh
MESH_STEP_RTOL = 1e-5            # two ranks against one process: losses
MESH_MEAN_RTOL = 1e-6            # two ranks against one process: OOD means
MESH_OOD = 'cifar10'
MESH_NOISE_SEED = 5
MESH_RANK_TIMEOUT = 420          # seconds, each spawned rank
MESH_RUNS = ({'name': 'model2', 'model_axis': 2},
             {'name': 'sample2', 'sample_axis': 2})


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _recorded_train(job, trainset, mesh, batch):
    """``train_model`` for one epoch of ``trainset`` (host-fed, no
    evaluation), recording each step's metrics."""
    from joint_vae_tpu_torch.train import trainer
    from joint_vae_tpu_torch.utils.print_log import EpochOutput
    steps = []
    real = trainer.make_train_step

    def recording(*a, **k):
        step = real(*a, **k)

        def run(state, x, y, eps=None):
            state, m = step(state, x, y, eps)
            steps.append({k_: float(v) for k_, v in m.items()})
            return state, m
        return run
    trainer.make_train_step = recording
    try:
        trainer.train_model(job, trainset, None, epochs=job.trained + 1,
                            batch_size=batch,
                            outputs=EpochOutput(stdout=False), seed=1,
                            final_test=False, final_ood=False, mesh=mesh)
    finally:
        trainer.make_train_step = real
    return steps


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms (warn-only: an op without one
    warns) around a comparison of training runs: the card's backward
    otherwise sums some gradients with atomics in no fixed order, and
    Adam's first steps turn such last-bit differences into moves of
    about lr (module docstring)."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _steps_gate(got, want, again, cfg, rtol: float, what: str) -> dict:
    """The loss components of a mesh run's steps against the same steps
    without a mesh: within ``rtol``, or within twice the spread of the
    steps run twice without a mesh where that is larger (the card's
    backward sums some gradients with atomics, in no fixed order).  Every
    metric's largest relative difference is reported, mesh against plain
    and plain against plain."""
    if not len(got) == len(want) == len(again):
        raise AssertionError('{}: {} steps, want {}'.format(
            what, len(got), len(want)))
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    out = {'max_rel_err': 0.0, 'max_rel_err_all': 0.0,
           'plain_spread_all': 0.0}
    for i, (g, w, a) in enumerate(zip(got, want, again)):
        for k, v in w.items():
            out['max_rel_err_all'] = max(out['max_rel_err_all'],
                                         rel(g[k], v))
            out['plain_spread_all'] = max(out['plain_spread_all'],
                                          rel(a[k], v))
            if k not in cfg.loss_components:
                continue
            out['max_rel_err'] = max(out['max_rel_err'], rel(g[k], v))
            lim = max(rtol * abs(v), 2 * abs(a[k] - v))
            if not abs(g[k] - v) <= lim:
                raise AssertionError(
                    '{} step {} {}: {} against {} (plain again {})'.format(
                        what, i, k, g[k], v, a[k]))
    return out


def _dir_bytes(d: str) -> int:
    return sum(os.path.getsize(os.path.join(p, f))
               for p, _, fs in os.walk(d) for f in fs)


def _job_arrays(job) -> dict:
    from joint_vae_tpu_torch.save_load.from_jax import (opt_state_to_jax,
                                                        state_dict_to_jax)
    out = dict(state_dict_to_jax(job.model))
    out.update({'opt/' + k: v for k, v in opt_state_to_jax(
        job.model, job.opt_cfg, job.state.opt_state).items()})
    return out


def mesh_world1(card: str, trainset, backend: str = 'nccl',
                device: str = 'cuda', cfg=None) -> tuple:
    """(a): the host-fed flagship steps on a (1, 1) mesh over one rank of
    ``backend`` against the same steps without a mesh; the steps and the
    all-reduce timed; the sharded checkpoint, synchronous and
    asynchronous, restored byte-equal into a run without a mesh."""
    import torch.distributed as dist
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.parallel.mesh import (all_reduce_mean_,
                                                   distributed_init,
                                                   make_mesh)
    from joint_vae_tpu_torch.parallel.shard_steps import reduce_over_data
    from joint_vae_tpu_torch.save_load.jobs import load_job, new_job, save_job
    from joint_vae_tpu_torch.save_load.sharded_checkpoint import (
        AsyncCheckpointer, is_sharded_checkpoint)
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.steps import make_train_step
    cuda = device == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    root = os.path.join(WORK, 'mesh_world1')
    shutil.rmtree(root, ignore_errors=True)
    src = new_job(cfg or flagship_config(), OptimizerConfig(lr=TRAIN_LR),
                  seed=0, device=device)
    save_job(src, os.path.join(root, 'src'))

    distributed_init('localhost:{}'.format(_free_port()), 1, 0,
                     backend=backend)
    try:
        mesh = make_mesh(device=device)
        if mesh.group('data') is None or dist.get_backend() != backend:
            raise AssertionError('no {} group on the mesh'.format(backend))
        # deterministic algorithms, and the same steps twice without the
        # mesh: the card's own spread, if any is left
        with _deterministic():
            plain = load_job(os.path.join(root, 'src'), device=device)
            want = _recorded_train(plain, trainset, None, MESH_BATCH)
            again = _recorded_train(load_job(os.path.join(root, 'src'),
                                             device=device), trainset, None,
                                    MESH_BATCH)
            meshed = load_job(os.path.join(root, 'src'), device=device)
            _count_reset()
            got = _recorded_train(meshed, trainset, mesh, MESH_BATCH)
            launches = _counts()
        if launches != _want(len(got)):
            raise AssertionError('world-1 mesh steps launched {}, want {}'
                                 .format(launches, _want(len(got))))
        if len(got) != MESH_STEPS:
            raise AssertionError('{} mesh steps'.format(len(got)))
        worst = _steps_gate(got, want, again, meshed.model_cfg,
                            MESH_WORLD1_RTOL, 'world-1 mesh')

        # the step with and without the mesh, in turns; the all-reduce
        x, y = trainset[:MESH_BATCH]
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        yd = torch.from_numpy(np.ascontiguousarray(y)).to(device)
        steps = {'plain': (plain.state, make_train_step(
                     plain.model, plain.opt_cfg)),
                 'mesh': (meshed.state, make_train_step(
                     meshed.model, meshed.opt_cfg, mesh=mesh))}

        def step_ms(kind):
            st, fn = steps[kind]
            for _ in range(MESH_WARMUP):
                fn(st, xd, yd)
            sync()
            t = time.perf_counter()
            for _ in range(MESH_TIMED):
                fn(st, xd, yd)
            sync()
            return (time.perf_counter() - t) * 1e3 / MESH_TIMED
        turns = [('plain', step_ms('plain')), ('mesh', step_ms('mesh')),
                 ('mesh', step_ms('mesh')), ('plain', step_ms('plain'))]
        n_params = sum(p.numel() for p in meshed.model.parameters())
        flat = torch.zeros(n_params, device=device)
        grads = {n: torch.zeros_like(p)
                 for n, p in meshed.model.named_parameters()}
        if cuda:
            ar_ms = time_ms(lambda: all_reduce_mean_(flat, mesh, 'data',
                                                     force=True), 20)
            red_ms = time_ms(lambda: reduce_over_data(grads, mesh), 20)
        else:
            ar_ms = red_ms = None

        # the sharded checkpoint: synchronous, then asynchronous
        ckpt = {}
        live = _job_arrays(meshed)
        for kind in ('sync', 'async'):
            d = os.path.join(root, kind)
            ck = AsyncCheckpointer() if kind == 'async' else None
            sync()
            t = time.perf_counter()
            save_job(meshed, d, sharded=True, checkpointer=ck)
            submit_s = time.perf_counter() - t
            if ck is not None:
                ck.wait()
            total_s = time.perf_counter() - t
            if not is_sharded_checkpoint(os.path.join(d, 'state.shards')):
                raise AssertionError('{}: no sharded checkpoint'.format(kind))
            back = _job_arrays(load_job(d, device=device))
            bad = [k for k in live if back[k].tobytes() != live[k].tobytes()]
            if bad or set(back) != set(live):
                raise AssertionError('{} checkpoint restored with other '
                                     'bytes: {}'.format(kind, bad[:5]))
            ckpt[kind] = {
                'seconds': round(total_s, 4), 'submit_s': round(submit_s, 4),
                'bytes': _dir_bytes(os.path.join(d, 'state.shards'))
                + _dir_bytes(os.path.join(d, 'optimizer.shards'))}
    finally:
        dist.destroy_process_group()
    summary = {'card': card, 'backend': backend, 'steps': len(got),
               'batch': MESH_BATCH, **worst,
               'step_ms_turns': [(k, round(v, 3)) for k, v in turns],
               'all_reduce_ms': ar_ms, 'all_reduce_floats': n_params,
               'reduce_over_data_ms': red_ms, 'checkpoint': ckpt,
               'launches': launches}
    print('mesh_world1', json.dumps(summary), flush=True)
    return launches, summary


def _mesh_sets(size=None):
    from joint_vae_tpu_torch.data.loaders import get_dataset
    _, testset = get_dataset('cifar100', splits=['test'])
    _, ood = get_dataset(MESH_OOD, splits=['test'])
    if size:
        testset = testset.subset(np.arange(size))
        ood = ood.subset(np.arange(size))
    return testset, ood


def _mesh_ood(job, testset, ood, batch, device, mesh=None):
    from joint_vae_tpu_torch.evals.engines import ood_detection_rates
    from joint_vae_tpu_torch.train.state import make_generator
    return ood_detection_rates(
        job, testset, [ood], batch_size=batch, recording=False,
        from_where=('compute',), update_self_ood=False,
        generator=make_generator(device, MESH_NOISE_SEED), mesh=mesh)


def _mesh_steps(job, trainset, device, mesh=None, batch=MESH_BATCH):
    """MESH_STEPS steps of the flagship on the first batches of
    ``trainset``; each rank feeds its rows (all of them on the 'model'
    axis)."""
    from joint_vae_tpu_torch.parallel.sharded_data import aligned_global_batch
    from joint_vae_tpu_torch.train.steps import make_train_step
    step = make_train_step(job.model, job.opt_cfg, mesh=mesh)
    out = []
    for i in range(MESH_STEPS):
        x, y = trainset[i * batch:(i + 1) * batch]
        if mesh is None:
            xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            yd = torch.from_numpy(np.ascontiguousarray(y)).to(device)
        else:
            xd, yd = aligned_global_batch(mesh, x, y)
        _, m = step(job.state, xd, yd)
        out.append({k: float(v) for k, v in m.items()})
    return out


def mesh_rank(argv):
    """One rank of phase 12 (b)/(c): ``chip_smoke.py --mesh-rank <spec
    json> <rank>``.  Writes ``<out>/rank-<r>.json``."""
    import torch.distributed as dist
    from joint_vae_tpu_torch.device import set_float32_math
    from joint_vae_tpu_torch.parallel.mesh import (distributed_init,
                                                   ensure_placed, make_mesh)
    from joint_vae_tpu_torch.save_load.jobs import load_job
    with open(argv[0]) as f:
        spec = json.load(f)
    rank = int(argv[1])
    device = spec['device']
    distributed_init('localhost:{}'.format(spec['port']), spec['world'],
                     rank, backend=spec['backend'])
    if device == 'cuda':
        set_float32_math()
        device = 'cuda:{}'.format(torch.cuda.current_device())
    out = {'rank': rank, 'device': device, 'runs': {}}
    testset, ood = _mesh_sets(spec.get('size'))
    for run in spec['runs']:
        mesh = make_mesh(model_axis=run.get('model_axis', 1),
                         sample_axis=run.get('sample_axis', 1),
                         device=device)
        job = load_job(spec['job_dir'], device=device)
        job.state = ensure_placed(job.state, mesh)
        _count_reset()
        t = time.perf_counter()
        if run.get('steps'):
            with _deterministic():
                got = _mesh_steps(job, testset, device, mesh,
                                  spec['step_batch'])
        else:
            got = _mesh_ood(job, testset, ood, spec['batch'], device, mesh)
        if device.startswith('cuda'):
            torch.cuda.synchronize()
        out['runs'][run['name']] = {
            'seconds': time.perf_counter() - t, 'launches': _counts(),
            'result': got, 'coords': mesh.coords}
    # the four collectives the port uses, on this device's tensors
    mesh = make_mesh(model_axis=spec['world'], device=device)
    g = mesh.group('model')
    t = torch.full((3,), float(rank + 1), device=device)
    dist.all_reduce(t, group=g)
    parts = [torch.empty(2, device=device) for _ in range(spec['world'])]
    dist.all_gather(parts, torch.full((2,), float(rank), device=device),
                    group=g)
    b = torch.full((2,), float(rank), device=device)
    dist.broadcast(b, src=0, group=g)
    dist.barrier()
    n = spec['world']
    out['collectives'] = {
        'all_reduce': t.tolist() == [n * (n + 1) / 2] * 3,
        'all_gather': [p.tolist() for p in parts]
        == [[float(r)] * 2 for r in range(n)],
        'broadcast': b.tolist() == [0.0, 0.0], 'barrier': True}
    if device.startswith('cuda'):
        out['kernels'] = mesh_kernel_checks(rank, spec['world'],
                                            spec['step_batch'])
    with open(os.path.join(spec['out'], 'rank-{}.json'.format(rank)),
              'w') as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def mesh_kernel_checks(rank: int, parts: int, step_batch: int) -> dict:
    """Both kernels on this rank against their plain versions at the
    shapes a rank of the mesh gives them: the combine on a block of
    C / parts classes (L=16, N=512, K=128); the conv at the decoder's
    last same-grid site at each batch this rank decodes: all L samples
    on the 'model' axis, its block of the L+1 samples less the mean one
    on the 'sample' axis (``mesh.py::sample_blocks``), and the train
    step's L=1 decode of its rows."""
    from joint_vae_tpu_torch.models.cvnet import CVNet, flagship_config
    from joint_vae_tpu_torch.ops.iws import iws_combine, iws_combine_plain
    from joint_vae_tpu_torch.ops.same_grid_conv import (same_grid_conv,
                                                        same_grid_conv_plain)
    from joint_vae_tpu_torch.parallel.mesh import sample_blocks
    g = torch.Generator(device='cuda').manual_seed(11)
    args, _ = iws_inputs(16, OOD_BATCH, 100 // parts, 128, g, mean_scale=17)
    got = iws_combine(*args)
    want = iws_combine_plain(*args)
    iws_err = (got - want).abs().max().item()
    if not torch.all((got - want).abs() <= IWS_ATOL + IWS_RTOL * want.abs()):
        raise AssertionError('iws_combine on a class block: {}'.format(
            iws_err))
    cfg = flagship_config()
    L = cfg.test_latent_sampling
    a, b = sample_blocks(L + 1, parts)[rank]
    decodes = {'model': L * OOD_BATCH,
               'sample': (max(b, 1) - max(a, 1)) * OOD_BATCH,
               'steps': cfg.latent_sampling * step_batch}
    model = CVNet(cfg)
    tol = CONV_TOL[torch.float32]
    conv = {}
    for axis, n in decodes.items():
        site = same_grid_sites(model, n, 1)[-1]
        x, _, kd = site_inputs(site, torch.float32, g)
        got = same_grid_conv(x, kd, site['lo'], site['lo'])
        want = same_grid_conv_plain(x, kd, site['lo'], site['lo'])
        err = (got - want).abs().max().item()
        if not torch.all((got - want).abs() <= tol * (
                want.abs() + want.square().mean().sqrt())):
            raise AssertionError('same_grid_conv at n={}: {}'.format(n, err))
        conv[axis] = {'max_abs_err': err, 'site': site['site'], 'n': n}
        del x, kd, got, want
    return {'iws_combine': {'max_abs_err': iws_err,
                            'shape': [16, OOD_BATCH, 100 // parts, 128]},
            'same_grid_conv': conv}


def mesh_ranks(backend: str, world: int, job_dir: str, device: str = 'cuda',
               size=None, batch: int = OOD_BATCH,
               step_batch: int = MESH_BATCH) -> list:
    """Spawn the ranks of (b)/(c), each under its own time limit; a rank
    that fails or hangs fails the phase."""
    out = os.path.join(WORK, 'mesh_{}'.format(backend))
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    spec = {'backend': backend, 'world': world, 'port': _free_port(),
            'device': device, 'job_dir': job_dir, 'out': out, 'size': size,
            'batch': batch, 'step_batch': step_batch,
            'runs': list(MESH_RUNS) + [{'name': 'steps2', 'model_axis': 2,
                                        'steps': MESH_STEPS}]}
    path = os.path.join(out, 'spec.json')
    with open(path, 'w') as f:
        json.dump(spec, f)
    logs = [open(os.path.join(out, 'rank-{}.log'.format(r)), 'w+')
            for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               '--mesh-rank', path, str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              cwd=ROOT) for r in range(world)]
    deadline = time.time() + MESH_RANK_TIMEOUT
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        text = []
        for r in bad:
            logs[r].seek(0)
            text.append('rank {} exit {}:\n{}'.format(
                r, procs[r].returncode, logs[r].read()[-3000:]))
        raise AssertionError('{} ranks failed or timed out:\n{}'.format(
            backend, '\n'.join(text)))
    res = []
    for r in range(world):
        logs[r].close()
        with open(os.path.join(out, 'rank-{}.json'.format(r))) as f:
            res.append(json.load(f))
    return res


def mesh_check_ranks(ranks, ref_ood, ref_steps, cfg, n_batches,
                     what) -> dict:
    """Each rank's runs against the one-process card run: OOD AUCs equal
    and means within MESH_MEAN_RTOL, the steps' losses within
    MESH_STEP_RTOL (``_steps_gate``; ``ref_steps`` holds the one-process
    steps twice), the launches of each run."""
    worst = {'mean_rel': 0.0, 'step_rel': 0.0, 'step_rel_all': 0.0,
             'plain_spread_all': 0.0}
    want_ood = {'same_grid_conv': SITES_PER_BATCH * n_batches,
                'same_grid_conv_dx': 0, 'iws_combine': n_batches}
    for r in ranks:
        if not all(r['collectives'].values()):
            raise AssertionError('{} rank {} collectives: {}'.format(
                what, r['rank'], r['collectives']))
        for name, run in r['runs'].items():
            if name == 'steps2':
                g = _steps_gate(run['result'], ref_steps[0], ref_steps[1],
                                cfg, MESH_STEP_RTOL,
                                '{} rank {} {}'.format(what, r['rank'], name))
                worst['step_rel'] = max(worst['step_rel'], g['max_rel_err'])
                worst['step_rel_all'] = max(worst['step_rel_all'],
                                            g['max_rel_err_all'])
                worst['plain_spread_all'] = g['plain_spread_all']
                want = _want(MESH_STEPS)
            else:
                got = run['result'][MESH_OOD]
                for m, e in ref_ood[MESH_OOD].items():
                    if got[m]['auc'] != e['auc']:
                        raise AssertionError('{} rank {} {} {}: AUC {} '
                                             'against {}'.format(
                                                 what, r['rank'], name, m,
                                                 got[m]['auc'], e['auc']))
                    err = abs(got[m]['mean'] - e['mean']) / max(
                        abs(e['mean']), 1e-30)
                    if not err <= MESH_MEAN_RTOL:
                        raise AssertionError('{} rank {} {} {}: mean {} '
                                             'against {}'.format(
                                                 what, r['rank'], name, m,
                                                 got[m]['mean'], e['mean']))
                    worst['mean_rel'] = max(worst['mean_rel'], err)
                want = want_ood
            if run['launches'] != want:
                raise AssertionError('{} rank {} {}: launches {}, want {}'
                                     .format(what, r['rank'], name,
                                             run['launches'], want))
    return worst


def _mesh_launch_keys(launches: dict, kernel: str) -> dict:
    """The kernels line's phase-12 launch counts of one kernel: the
    world-1 mesh's steps, and per gloo run each rank's."""
    return {'launches_mesh_world1': launches['world1'][kernel],
            'launches_mesh_gloo': {n: [c[kernel] for c in per_rank]
                                   for n, per_rank in launches['gloo'].items()}}


def mesh_phase(card: str) -> tuple:
    """Phase 12: (a), (b) and (c) of the section's comment."""
    from joint_vae_tpu_torch.save_load.jobs import load_job
    testset, ood = _mesh_sets()
    w1_launches, w1 = mesh_world1(card, testset.subset(
        np.arange(MESH_STEPS * MESH_BATCH)))

    job_dir = os.path.join(WORK, 'flagship_job')       # phase 4's job
    job = load_job(job_dir)
    t = time.perf_counter()
    ref_ood = _mesh_ood(job, testset, ood, OOD_BATCH, 'cuda')
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t
    with _deterministic():
        ref_steps = [_mesh_steps(load_job(job_dir), testset, 'cuda')
                     for _ in range(2)]
    n_batches = 2 * -(-len(testset) // OOD_BATCH)

    t = time.perf_counter()
    gloo = mesh_ranks('gloo', 2, job_dir)
    gloo_s = time.perf_counter() - t
    worst = mesh_check_ranks(gloo, ref_ood, ref_steps, job.model_cfg,
                             n_batches, 'gloo')
    line = {'card': card, 'world1': w1,
            'gloo': {'ranks': 2, 'seconds': round(gloo_s, 2),
                     'one_process_ood_s': round(ref_s, 3), **worst,
                     'runs': {r['rank']: {n: {'seconds': round(v['seconds'],
                                                               2),
                                              'launches': v['launches'],
                                              'coords': v['coords']}
                                          for n, v in r['runs'].items()}
                              for r in gloo},
                     'kernels': {r['rank']: r['kernels'] for r in gloo},
                     'note': 'two processes share one card: correctness '
                             'runs, their times are no speed figure'}}
    print('mesh_gloo', json.dumps(line['gloo']), flush=True)
    if torch.cuda.device_count() >= 2:
        nccl = mesh_ranks('nccl', 2, job_dir)
        line['nccl'] = mesh_check_ranks(nccl, ref_ood, ref_steps,
                                        job.model_cfg, n_batches, 'nccl')
        print('mesh_nccl', json.dumps(line['nccl']), flush=True)
    else:
        print('mesh_nccl: the NCCL run over two cards waits for a machine '
              'with two cards (this one has {})'.format(
                  torch.cuda.device_count()), flush=True)
    launches = {'world1': w1_launches,
                'gloo': {n: [r['runs'][n]['launches'] for r in gloo]
                         for n in gloo[0]['runs']}}
    return launches, line


# ---------------------------------------------------------------------------
# phase 13: export to moxime/joint-vae's job layout (the last module of the
# JAX package).  The jobs that earlier phases saved, and a densenet121-trunk
# job, exported through a stub reference checkout
# (tests/torch_reference_stub.py) and imported back bit-equal; phase 11's
# imported flagship exported back to its reference-layout source
# ---------------------------------------------------------------------------
EXPORT_JOBS = ('train', 'ood', 'wim', 'poscod', 'resnet', 'densenet')
EXPORT_REL = 'cifar100/{}/adam/{}'


def _same_loaded(a, b, where: str) -> list:
    """Paths where two loaded ``.pth`` objects differ: dict keys in their
    order, tensors by dtype, shape and bits (a Parameter subclass as its
    data), other values by ==."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        a, b = a.detach().cpu(), b.detach().cpu()
        same = (a.dtype == b.dtype and a.shape == b.shape
                and a.numpy().tobytes() == b.numpy().tobytes())
        return [] if same else [where]
    if type(a) is not type(b):
        return [where]
    if isinstance(a, dict):
        if list(a) != list(b):
            return [where + ' (keys)']
        return [d for k in a for d in _same_loaded(a[k], b[k],
                                                   '{}/{}'.format(where, k))]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [where]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _same_loaded(x, y, '{}[{}]'.format(where, i))]
    return [] if a == b else [where]


def _pth(path: str):
    return torch.load(path, map_location='cpu', weights_only=False)


def _export_tree_differences(a: str, b: str) -> list:
    """Relative paths that differ between two exported trees: ``.pth``
    files by their loaded contents (``torch.save`` zips may lay out equal
    contents apart), JSON files as parsed, others byte for byte."""
    def files(root):
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(root) for f in fs}
    fa, fb = files(a), files(b)
    diff = sorted(fa ^ fb)
    for rel in sorted(fa & fb):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith('.pth'):
            diff += _same_loaded(_pth(pa), _pth(pb), rel)
        elif rel.endswith('.json'):
            with open(pa) as f, open(pb) as g:
                if json.load(f) != json.load(g):
                    diff.append(rel)
        else:
            with open(pa, 'rb') as f, open(pb, 'rb') as g:
                if f.read() != g.read():
                    diff.append(rel)
    return diff


def _densenet_job(job_dir: str):
    """A densenet121-trunk flagship at a small width (encoder and decoder
    64) with random running statistics, saved."""
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job, save_job
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    cfg = dataclasses.replace(flagship_config(), features='densenet121',
                              encoder=(64,), decoder=(64,))
    job = new_job(cfg, OptimizerConfig(lr=TRAIN_LR), seed=13)
    rng = np.random.default_rng(13)
    with torch.no_grad():
        for name, b in job.model.named_buffers():
            if name.endswith(('running_mean', 'running_var')):
                b.copy_(torch.as_tensor(np.abs(rng.normal(
                    0.5, 0.2, tuple(b.shape))).astype(np.float32)))
    job.train_history = {'epochs': 1}
    save_job(job, job_dir)


def _round_trip(src: str, back: str) -> dict:
    """import(export(job)) against the job, on the card: weights,
    BatchNorm statistics, sigma, Adam's moments, count and learning rate
    bit-equal after ``load_job``, the record files' bytes equal, a Poscod
    head's arrays equal.  A WIM or Poscod job's moments are not imported
    back (its state.pth holds parameters that optimizer.pth does not
    index: ROADMAP Queue 3), which is checked too."""
    from joint_vae_tpu_torch.save_load.jobs import load_job
    a, b = load_job(src), load_job(back)
    sd, sd2 = a.model.state_dict(), b.model.state_dict()
    bad = [k for k in sd if k not in sd2 or not torch.equal(sd[k], sd2[k])]
    if not torch.equal(a.sigma_state.data, b.sigma_state.data):
        bad.append('sigma')
    o, o2 = a.state.opt_state, b.state.opt_state
    extra = any(os.path.exists(os.path.join(src, f))
                for f in ('wim_prior.npz', 'poscod_head.npz'))
    moments = o.adam_count > 0
    if moments and not extra:
        if (o.adam_count, o.learning_rate) != (o2.adam_count,
                                               o2.learning_rate):
            bad.append('adam count or learning rate')
        bad += ['mu/' + k for k in o.mu if not torch.equal(o.mu[k], o2.mu[k])]
        bad += ['nu/' + k for k in o.nu if not torch.equal(o.nu[k], o2.nu[k])]
    elif os.path.exists(os.path.join(back, 'optimizer.npz')):
        bad.append('optimizer.npz imported')
    records = 0
    for d, _, fs in os.walk(os.path.join(src, 'samples')):
        for f in fs:
            if f.endswith('.jvr'):
                rel = os.path.relpath(os.path.join(d, f), src)
                with open(os.path.join(d, f), 'rb') as x, \
                        open(os.path.join(back, rel), 'rb') as y:
                    if x.read() != y.read():
                        bad.append(rel)
                records += 1
    head = os.path.join(src, 'poscod_head.npz')
    if os.path.exists(head):
        with np.load(head) as x, np.load(os.path.join(
                back, 'poscod_head.npz')) as y:
            if not all(np.array_equal(x[k], y[k]) for k in x.files):
                bad.append('poscod_head.npz')
    if bad:
        raise AssertionError('import(export({})) differs at {}'.format(
            src, bad[:10]))
    return {'tensors': len(sd), 'moments': 'bit-equal' if moments and not
            extra else ('not re-imported' if moments else 'none'),
            'records': records}


def export_kernel_checks() -> dict:
    """Both kernels against their plain versions at the Scorer batch's
    shapes: the conv at the flagship's eight sites (512 images, 8,192
    decoded), the combine at L=16, N=512, C=100, K=128."""
    from joint_vae_tpu_torch.models.cvnet import CVNet, flagship_config
    from joint_vae_tpu_torch.ops.iws import iws_combine, iws_combine_plain
    from joint_vae_tpu_torch.ops.same_grid_conv import (same_grid_conv,
                                                        same_grid_conv_plain)
    g = torch.Generator(device='cuda').manual_seed(13)
    cfg = flagship_config()
    tol = CONV_TOL[torch.float32]
    conv = 0.0
    for site in same_grid_sites(CVNet(cfg), BATCH, cfg.test_latent_sampling):
        x, _, kd = site_inputs(site, torch.float32, g)
        got = same_grid_conv(x, kd, site['lo'], site['lo'])
        want = same_grid_conv_plain(x, kd, site['lo'], site['lo'])
        if not torch.all((got - want).abs() <= tol * (
                want.abs() + want.square().mean().sqrt())):
            raise AssertionError('same_grid_conv at {}: {}'.format(
                site['site'], (got - want).abs().max().item()))
        conv = max(conv, (got - want).abs().max().item())
        del x, kd, got, want
    args, _ = iws_inputs(cfg.test_latent_sampling, BATCH, cfg.num_labels,
                         cfg.latent_dim, g, mean_scale=17)
    got, want = iws_combine(*args), iws_combine_plain(*args)
    if not torch.all((got - want).abs() <= IWS_ATOL + IWS_RTOL * want.abs()):
        raise AssertionError('iws_combine: {}'.format(
            (got - want).abs().max().item()))
    return {'same_grid_conv_max_abs_err': conv,
            'iws_combine_max_abs_err': (got - want).abs().max().item()}


def export_phase(card: str) -> tuple:
    """Phase 13: the jobs of phases 5, 6, 9 and 10 and a densenet121-trunk
    job exported through the export CLI (a corrupt job beside them) and
    each in process, imported back bit-equal; phase 11's imported
    flagship exported back to its source; a Scorer batch on the
    re-imported flagship against the source's."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from torch_reference_stub import write_stub_checkout
    from joint_vae_tpu_torch.save_load.export_reference import \
        export_to_reference_job
    from joint_vae_tpu_torch.save_load.import_reference import \
        import_reference_job
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.serve import Scorer

    root = os.path.join(WORK, 'export')
    shutil.rmtree(root, ignore_errors=True)
    stub = write_stub_checkout(os.path.join(root, 'reference_stub'))
    jobs = os.path.join(root, 'jobs')
    ft = _job_dirs(os.path.join(WORK, 'ft_jobs', 'wim'))
    sources = {
        'train': os.path.join(WORK, 'train_job'),           # phase 5
        'ood': os.path.join(WORK, 'flagship_job'),          # phases 4, 6
        'wim': [d for d in ft if os.path.exists(
            os.path.join(d, 'wim_prior.npz'))][0],           # phase 9
        'poscod': [d for d in ft if os.path.exists(
            os.path.join(d, 'poscod_head.npz'))][0],         # phase 9
        'resnet': os.path.join(WORK, 'resnet_train_job')}   # phase 10
    rel = {k: EXPORT_REL.format(k, i + 1) for i, k in enumerate(EXPORT_JOBS)}
    for k, d in sources.items():
        shutil.copytree(d, os.path.join(jobs, rel[k]))
    _densenet_job(os.path.join(jobs, rel['densenet']))
    corrupt = os.path.join(jobs, EXPORT_REL.format('corrupt', 9))
    os.makedirs(corrupt)
    with open(os.path.join(corrupt, 'params.json'), 'w') as f:
        f.write('{ this is not json')

    # --- the export CLI in a subprocess, on the card ---
    cli_out = os.path.join(root, 'ref_cli')
    argv = [sys.executable, '-m', 'joint_vae_tpu_torch.cli.export_ref',
            '--scan', jobs, '--out', cli_out, '--reference', stub]
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    cli_s = time.perf_counter() - t0
    want_line = '{} exported, 1 failed'.format(len(EXPORT_JOBS))
    if r.returncode != 1 or want_line not in r.stdout:
        raise AssertionError('export CLI exited {}: {}\n{}'.format(
            r.returncode, r.stdout, r.stderr[-3000:]))
    if os.path.relpath(corrupt, jobs) not in r.stderr:
        raise AssertionError('the export CLI did not name the corrupt job: '
                             '{}'.format(r.stderr[-3000:]))

    # --- each job in process, timed; the same files as the CLI's ---
    inproc = os.path.join(root, 'ref_inproc')
    job_s, written = {}, {}
    for k in EXPORT_JOBS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst = export_to_reference_job(os.path.join(jobs, rel[k]),
                                      os.path.join(inproc, rel[k]),
                                      reference_path=stub)
        job_s[k] = time.perf_counter() - t0
        files = [os.path.join(d, f) for d, _, fs in os.walk(dst) for f in fs]
        written[k] = {
            'files': len(files),
            'bytes': sum(os.path.getsize(p) for p in files),
            'tensors': sum(len(_pth(p)) for p in files
                           if p.endswith('state.pth'))}
    diff = _export_tree_differences(inproc, cli_out)
    if diff:
        raise AssertionError('in-process and CLI exports differ: {}'.format(
            diff[:10]))

    # --- import(export(job)) == job, on the card ---
    back = os.path.join(root, 'back')
    round_trip = {}
    for k in EXPORT_JOBS:
        import_reference_job(os.path.join(inproc, rel[k]),
                             os.path.join(back, rel[k]))
        round_trip[k] = _round_trip(os.path.join(jobs, rel[k]),
                                    os.path.join(back, rel[k]))

    # --- export(import(ref)) == ref: phase 11's imported flagship ---
    iroot = os.path.join(WORK, 'interop')
    irel = os.path.join(*map(str, INTEROP_JOBS['flagship']))
    again = export_to_reference_job(
        os.path.join(iroot, 'jobs_cuda', irel), os.path.join(root, 'again'),
        reference_path=stub)
    ref_diff = []
    for name in ('state.pth', 'optimizer.pth'):
        ref_diff += _same_loaded(_pth(os.path.join(iroot, 'ref', irel, name)),
                                 _pth(os.path.join(again, name)), name)
    if ref_diff:
        raise AssertionError('export(import(ref)) differs from phase 11\'s '
                             'source at {}'.format(ref_diff[:10]))

    # --- a Scorer batch on the re-imported flagship against the source's,
    # the same noise: bit-equal ---
    cfg = load_job(os.path.join(jobs, rel['train']), ghost=True).model_cfg
    rng = np.random.default_rng(13)
    x = rng.uniform(0, 1, (BATCH,) + cfg.input_shape).astype(np.float32)
    eps = torch.as_tensor(rng.standard_normal(
        (cfg.test_latent_sampling + 1, BATCH, cfg.latent_dim))
        .astype(np.float32), device='cuda')
    eps[0] = 0.0
    lows = {m: float('-inf') for m in METHODS}
    want = Scorer(load_job(os.path.join(jobs, rel['train'])), methods=METHODS,
                  thresholds=lows)(x, eps=eps)
    scorer = Scorer(load_job(os.path.join(back, rel['train'])),
                    methods=METHODS, thresholds=lows)
    scorer(x, eps=eps)                            # meets its shapes first
    torch.cuda.synchronize()
    _count_reset()
    # --- the main path: a Scorer batch on the re-imported flagship ---
    got = scorer(x, eps=eps)
    launches = _counts()
    # --- end of the main path ---
    if launches != _want(0, 1):
        raise AssertionError('re-imported Scorer batch launched {}'.format(
            launches))
    unequal = [m for m in METHODS
               if got['scores'][m].tobytes() != want['scores'][m].tobytes()]
    if unequal or not np.array_equal(got['label'], want['label']):
        raise AssertionError('re-imported vs source scores differ: {}'.format(
            unequal))
    kernels = export_kernel_checks()
    out = {'card': card, 'cli_seconds': cli_s, 'cli_line': want_line,
           'job_seconds': job_s, 'written': written,
           'round_trip': round_trip,
           'export_of_import_vs_reference_source': 'equal',
           'serve_launches': launches, 'serve_vs_source': 'bit-equal',
           'kernels_at_serve_batch': kernels}
    print('export', json.dumps(out), flush=True)
    return launches, out


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is false')
    from joint_vae_tpu_torch.device import set_float32_math
    from joint_vae_tpu_torch.models.cvnet import CVNet, flagship_config
    from joint_vae_tpu_torch.ops import cuda_lib

    set_float32_math()
    t_start = time.perf_counter()
    phase_s = {}
    card = card_line()
    print(card, flush=True)
    print('torch', torch.__version__, 'cuda', torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)

    build_s = cuda_lib.build()
    print('build seconds', round(build_s, 3), flush=True)
    for name, log in cuda_lib.BUILD_LOG.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print('ptxas', name, line.strip())
    sass = sass_counts('same_grid_conv')
    print('sass', json.dumps(sass), flush=True)
    for kind in ('TF32', 'BF16'):
        if not any(kind in op for op in sass['by_opcode']):
            raise AssertionError('no {} tensor-core instruction in the '
                                 'same-grid kernel library'.format(kind))

    phase_s['1-2 build'] = time.perf_counter() - t_start
    t0 = time.perf_counter()
    cfg = flagship_config()
    sites = same_grid_sites(CVNet(cfg), BATCH, cfg.test_latent_sampling)
    if len(sites) != SITES_PER_BATCH:
        raise AssertionError('{} same-grid sites'.format(len(sites)))
    conv_rows, conv = check_conv(sites)
    tail_err = check_tail_conv(same_grid_sites(
        CVNet(cfg), OOD_SET_SIZE % OOD_BATCH, cfg.test_latent_sampling))
    iws_rows, iws = check_iws()
    train_sites = same_grid_sites(CVNet(cfg), TRAIN_BATCH, cfg.latent_sampling)
    fwd_rows, dx_rows, dxt = check_train_conv(train_sites)
    fwd16_rows, dx16_rows, dxt16 = check_train_conv(train_sites, torch.bfloat16)
    library_rows = check_library_convs(CVNet(cfg), TRAIN_BATCH)
    phase_s['3 kernels'] = time.perf_counter() - t0
    os.makedirs(WORK, exist_ok=True)
    # the loader's native batcher, built before the timed phases
    from joint_vae_tpu_torch.data import native
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise AssertionError('native/libjvtbatcher.so did not build')
    print('batcher build seconds', round(time.perf_counter() - t0, 3),
          flush=True)

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out
    launches, launches128, summary = timed('4 serve', serve, card)
    train_launches, train_summary, _ = timed('5 train', train, card)
    ood_launches, odin_launches, ood_summary, ood_job = timed(
        '6 ood', ood_eval, card)
    odin_conv_0 = ood_summary['odin']['conv_0_dx']
    bench = timed('7 bench_train', bench_train, card, train_summary)
    bench16 = {mode: r['launches'] for mode, r in bench['bf16'].items()}
    f32_fed = bench['f32_device_fed']['launches']
    serve16 = bench['bf16_serve']['launches']
    test_cli_launches, fleet = timed('8 fleet', fleet_eval, card, ood_job)
    wim_launches, poscod_launches, wim = timed('9 wim', wim_finetune, card)
    (resnet_step, resnet_serve, driver_launches, resnet,
     driver_line) = timed('10 trunks_and_drivers', trunks_and_drivers, card)
    (interop_serve, interop_test, interop_resume, interop_resnet,
     interop_line) = timed('11 interop', interop, card)
    mesh_launches, mesh_line = timed('12 mesh', mesh_phase, card)
    export_launches, export_line = timed('13 export', export_phase, card)
    phase_s['total'] = time.perf_counter() - t_start
    print('phases', json.dumps({k: round(v, 2) for k, v in phase_s.items()}),
          flush=True)

    kernels = [
        {'name': 'same_grid_conv', 'route': 'cuda',
         'source': 'joint_vae_tpu_torch/csrc/same_grid_conv.cu',
         'replaces': 'joint_vae_tpu/ops/pallas_conv.py:109',
         'launches': launches['same_grid_conv'],
         'launches_train': train_launches['same_grid_conv'],
         'launches_ood': ood_launches['same_grid_conv'],
         'launches_odin': odin_launches['same_grid_conv'],
         'launches_test_cli': test_cli_launches['same_grid_conv'],
         'launches_wim_ft': wim_launches['same_grid_conv'],
         'launches_wim_poscod': poscod_launches['same_grid_conv'],
         'launches_resnet_step': resnet_step['same_grid_conv'],
         'launches_resnet_serve': resnet_serve['same_grid_conv'],
         'launches_drivers': {t: c['same_grid_conv']
                              for t, c in driver_launches.items()},
         'launches_interop_serve': interop_serve['same_grid_conv'],
         'launches_interop_resnet_serve': interop_resnet['same_grid_conv'],
         'launches_interop_test_cli': interop_test['same_grid_conv'],
         'launches_interop_resume': interop_resume['same_grid_conv'],
         **_mesh_launch_keys(mesh_launches, 'same_grid_conv'),
         'launches_export': export_launches['same_grid_conv'],
         'max_abs_err': max(conv['max_abs_err'], dxt['fwd_max_abs_err'],
                            tail_err),
         'tail_max_abs_err': tail_err,
         'ms': conv['ms'], 'kernel_ms': conv['ms'],
         'train_step_ms': dxt['fwd_ms'],
         'train_step_bound_ms': dxt['fwd_bound_ms'],
         'train_step_bound_by': ('bytes' if dxt['fwd_t_bytes'] >= dxt['fwd_t_ops']
                                 else 'operations'),
         'plain_ms': conv['plain_ms'], 'bound_ms': conv['bound_ms'],
         'bound_by': 'bytes' if conv['t_bytes'] >= conv['t_ops'] else 'operations',
         'bound_ms_cuda_core': conv['bound_ms_cuda_core'],
         'library_ms': conv['library_ms'],
         'launches_bench_bf16': {m: c['same_grid_conv']
                                 for m, c in bench16.items()},
         'launches_device_fed_f32': f32_fed['same_grid_conv'],
         'launches_serve_bf16': serve16['same_grid_conv'],
         'train_step_bf16_ms': dxt16['fwd_ms'],
         'train_step_bf16_plain_ms': dxt16['fwd_plain_ms'],
         'train_step_bf16_library_ms': dxt16['fwd_library_ms'],
         'train_step_bf16_bound_ms': dxt16['fwd_bound_ms'],
         'train_step_bf16_bound_by': (
             'bytes' if dxt16['fwd_t_bytes'] >= dxt16['fwd_t_ops']
             else 'operations'),
         'train_step_bf16_max_abs_err': dxt16['fwd_max_abs_err'],
         'per': 'one serve batch: the eight float32 sites summed (bound at '
                'the 3xTF32 rate; library: F.conv2d, or F.conv_transpose2d '
                'of the true deconv at the sub-pixel sites); '
                'train_step_ms: the eight sites at the train step\'s shapes '
                '(batch 1024, L=1), with their bound (train_step_bound_ms); '
                'train_step_bf16_*: the same in bfloat16 (bound at 989 '
                'TFLOP/s; library: cuDNN F.conv2d in bfloat16); '
                'launches_bench_bf16: one bfloat16 epoch of 50,000 images '
                'fed from the card at batch 1024 (train_model) and 512 '
                '(train_epochs_on_device)',
         'sites': conv_rows, 'train_sites': fwd_rows,
         'train_sites_bf16': fwd16_rows},
        {'name': 'same_grid_conv_dx', 'route': 'cuda',
         'source': 'joint_vae_tpu_torch/csrc/same_grid_conv.cu',
         'replaces': 'joint_vae_tpu/ops/pallas_conv.py:109',
         'launches': train_launches['same_grid_conv_dx'],
         'launches_odin': odin_launches['same_grid_conv_dx'],
         'launches_test_cli': test_cli_launches['same_grid_conv_dx'],
         'launches_wim_ft': wim_launches['same_grid_conv_dx'],
         'launches_resnet_step': resnet_step['same_grid_conv_dx'],
         'launches_resnet_serve': resnet_serve['same_grid_conv_dx'],
         'launches_drivers': {t: c['same_grid_conv_dx']
                              for t, c in driver_launches.items()},
         'launches_interop_resume': interop_resume['same_grid_conv_dx'],
         **_mesh_launch_keys(mesh_launches, 'same_grid_conv_dx'),
         'max_abs_err': max([dxt['max_abs_err']] + list(
             odin_conv_0['max_abs_err'].values())),
         'odin_conv_0': odin_conv_0,
         'ms': dxt['ms'], 'kernel_ms': dxt['ms'],
         'plain_ms': dxt['plain_ms'], 'bound_ms': dxt['bound_ms'],
         'bound_by': 'bytes' if dxt['t_bytes'] >= dxt['t_ops'] else 'operations',
         'library_ms': dxt['library_ms'],
         'library': 'torch.nn.grad.conv2d_input (cuDNN dgrad, float32)',
         'dw_ms': dxt['dw_ms'], 'dw_cudnn_ms': dxt['dw_cudnn_ms'],
         'dw_max_rel_err': dxt['dw_max_rel_err'],
         'dw_cudnn_max_rel_err': dxt['dw_cudnn_max_rel_err'],
         'launches_bench_bf16': {m: c['same_grid_conv_dx']
                                 for m, c in bench16.items()},
         'launches_device_fed_f32': f32_fed['same_grid_conv_dx'],
         'bf16_ms': dxt16['ms'], 'bf16_plain_ms': dxt16['plain_ms'],
         'bf16_library_ms': dxt16['library_ms'],
         'bf16_bound_ms': dxt16['bound_ms'],
         'bf16_bound_by': ('bytes' if dxt16['t_bytes'] >= dxt16['t_ops']
                           else 'operations'),
         'bf16_max_abs_err': dxt16['max_abs_err'],
         'bf16_dw_ms': dxt16['dw_ms'], 'bf16_dw_cudnn_ms': dxt16['dw_cudnn_ms'],
         'bf16_dw_max_rel_err': dxt16['dw_max_rel_err'],
         'bf16_dw_cudnn_max_rel_err': dxt16['dw_cudnn_max_rel_err'],
         'per': 'one train step at batch 1024: the input gradient of the '
                'seven same-grid sites whose input needs one, the same '
                'kernel on the flipped, ci/co-swapped kernel (the TPU '
                'kernel\'s custom vjp leaves it to XLA, pallas_conv.py:'
                '164-170); bound at the 3xTF32 rate; dw: the weight '
                'gradient of the same sites as a float32 im2col product '
                '(not a port of a kernel), beside cuDNN\'s (dw_cudnn; '
                'errors relative to the float64 product\'s rms); bf16_*: '
                'the same in bfloat16 (dw summed in float32)',
         'sites': dx_rows, 'sites_bf16': dx16_rows},
        {'name': 'iws_combine', 'route': 'cuda',
         'source': 'joint_vae_tpu_torch/csrc/iws_combine.cu',
         'replaces': 'joint_vae_tpu/ops/pallas_kernels.py:99',
         'launches': launches['iws_combine'],
         'launches_l128': launches128['iws_combine'],
         'launches_ood': ood_launches['iws_combine'],
         'launches_test_cli': test_cli_launches['iws_combine'],
         'launches_wim_ft': wim_launches['iws_combine'],
         'launches_serve_bf16': serve16['iws_combine'],
         'launches_resnet_step': resnet_step['iws_combine'],
         'launches_resnet_serve': resnet_serve['iws_combine'],
         'launches_drivers': {t: c['iws_combine']
                              for t, c in driver_launches.items()},
         'launches_interop_serve': interop_serve['iws_combine'],
         'launches_interop_resnet_serve': interop_resnet['iws_combine'],
         'launches_interop_test_cli': interop_test['iws_combine'],
         'launches_bench_bf16': {m: c['iws_combine']
                                 for m, c in bench16.items()},
         **_mesh_launch_keys(mesh_launches, 'iws_combine'),
         'launches_export': export_launches['iws_combine'],
         'max_abs_err': max(r['max_abs_err'] for r in iws_rows),
         'ms': iws['ms'], 'kernel_ms': iws['ms'], 'call_ms': iws['call_ms'],
         'plain_ms': iws['plain_ms'], 'bound_ms': iws['bound_ms'],
         'bound_by': iws['bound_by'], 'library_ms': iws['library_ms'],
         'library': iws['library'],
         'per': 'one serve batch: L=16, N=512, C=100, K=128, reference mode '
                '(ms: device time, replayed from a CUDA graph; call_ms: '
                'calls back to back, host included; library: a composite '
                'of PyTorch calls); every case below',
         'cases': iws_rows},
    ]
    print(json.dumps({'kernels': kernels, 'serve': summary,
                      'train': train_summary, 'ood': ood_summary,
                      'bench_train': bench, 'fleet': fleet, 'wim': wim,
                      'resnet': resnet, 'drivers': driver_line,
                      'interop': interop_line, 'mesh': mesh_line,
                      'export': export_line,
                      'library_conv_grads': library_rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    if len(sys.argv) > 1 and sys.argv[1] == '--mesh-rank':
        mesh_rank(sys.argv[2:])
    else:
        main()
