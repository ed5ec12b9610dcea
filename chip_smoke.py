#!/usr/bin/env python3
"""Drive the PyTorch port (``joint_vae_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, any failure raising (nonzero exit).  A train or fine-tune step
runs as a CUDA graph (``train/graphs.py``): a graph's first step eager,
its second captured, every later one a replay.  A wrapper counts a
launch where it calls its kernel, which a replay does not: a check below
of launches "per step" counts them per eager or captured step (the
graphs' ``steps_run``); what a replay launches is its graph's kernel
nodes, held at capture against the capture's launches by function name,
and phase 15 counts them on the card in profiled replays.

1. require a CUDA card; print ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``joint_vae_tpu_torch/csrc`` (one nvcc per
   source, all started together), print the build time, ptxas's register
   report and the tensor-core instructions of the conv library
   (``cuobjdump -sass``: HMMA/HGMMA by opcode and kernel), and fail
   unless it holds both TF32 and BF16 ones and unless the tensor-core
   conv kernel (``tc_conv_kernel``, the flagship's tensor-core sites)
   holds HGMMA (wgmma) TF32 in each float32 instantiation and HGMMA BF16
   in each bfloat16 one (the ``hgmma`` line: counts by instantiation);
3. hold each kernel against its plain PyTorch version at the flagship's
   shapes and time kernel, plain version, library call and bound:
   the same-grid conv at its eight sites (N=512 features, L*N=8192
   decoder; the two stride-2 deconvs as their packed sub-pixel convs) in
   float32 and bfloat16, each row with the kernel its shape dispatches
   (``kernel``: ``ops/same_grid_conv.py::kernel_route``), the co=3 head
   also zero-padded to co=8 (the
   8-wide tensor-core tile, against float32's CUDA-core path); the IWAE
   combine at L=16, N=512, C=100, K=128 in both modes, a ragged C=37,
   N=137 case, the OOD evaluation's ragged last batch N=272, the
   flagship's shape with prior means at the flagship's scale 17,
   L=128 at N=64 and N=512, C=1000, K=256, C=1 at N=256 with means
   at the WIM alternate prior's scale 8, and past K=352 on the streamed
   kernel: [fashion]'s K=512 and [fashion-vgg16]'s K=1024 at L=128,
   C=10, scale 17, K=512 at C=100, a ragged K=353 and K=1025
   (``IWS_CASES``), each timed
   as called back to back and replayed from a CUDA graph, beside the
   composite of PyTorch calls that the JAX package's default path
   computes (``library_ms``, its deviation from the plain version
   printed, not gated); the conv at its eight sites for the OOD
   evaluation's ragged last batch (272 images: n=272 features, n=4352
   decoder), float32, against its plain version (``conv_tail`` lines);
4. serve the full-width flagship CVAE (random weights from a numpy seed)
   through the entry points: ``save_job``, the serve CLI on ``.npy``
   inputs, ``Scorer`` on 4 timed batches of 512 at L=16 after its
   graph's warm-up and capture; check that the conv kernel was launched 8
   times and the IWAE kernel once per eager or captured batch on that
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
   no IWAE combine); 10 steps timed after 3 warm-up steps (replays: no
   wrapper launch), fed as ``train_model`` feeds them, the loader's
   and the copy's host time apart, then the same 10 batches again from
   the card; one step profiled by kernel; and the card against
   the CPU on a batch of 8 from one init with injected noise (the
   training gate below): 3 graphed steps, each one's loss, gradient,
   parameter update, Adam state, BatchNorm and sigma state;
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
   epoch profiled (two gathers a step, x's and y's rows into the step
   graph's input buffers, none of the whole set); the
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
   tolerance; 3 fine-tuning steps of 8 in and 8 moving inputs at the
   training gate; the prior and every buffer bit-equal after the card's
   steps); then
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
   kernel's; the training gate at batch 64, the trunk convs' weight
   gradients at TRUNK_WGRAD_TOL, every other gradient at 1e-4),
   the float32 step repeated: 2 graphed steps of 1024 from one state,
   batch and noise, run twice, every gradient, tensor and metric
   bit-equal (``float32_repeat``),
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
   1024 on a (1, 1) mesh against the same steps without one, both
   graphed, run twice, all under PyTorch's deterministic algorithms (the
   loss components within 1e-6 relative, or within twice the spread
   between the two plain runs where one is left), 8 forward and 7 dx
   launches per eager or captured step; the eager step's ms with and
   without the mesh in turns and the gradient all-reduce's own ms (CUDA
   events), and the all-reduce and ``reduce_over_data`` each alone in a
   CUDA graph (nodes by type, replay ms); the mesh programs graphed
   against their eager selves from one state, bit for bit: the train
   step in float32 and bfloat16 (4 steps of 1024; 8 forward and 7 dx
   kernel nodes, as many NCCL kernel nodes as the all-reduce's own graph
   holds, and the all-reduce issued once in the warm-up and once inside
   the capture), the fine-tune step (3 steps of 128 + 128), and
   ``ood_detection_rates(mesh=)`` (1,296 images a set at 512: every
   entry equal, 8 conv and 1 combine kernel nodes a capture); then the
   mesh step graphed and eager and the step graphed off the mesh in
   turns (float32, bfloat16; the fine-tune step graphed and eager); the
   job saved as a sharded checkpoint with and without
   ``AsyncCheckpointer`` (seconds and bytes) and restored into a run with
   no mesh, arrays and optimizer state byte-equal (``mesh_world1``
   line).  (b) Two ranks spawned on the one card over gloo
   (``--mesh-rank``; NCCL refuses two ranks on one device), each under
   its own time limit, eager (gloo stages its collectives through host
   memory, which a graph cannot capture): ``ood_detection_rates`` of
   phase 4's flagship job on cifar100's test set and cifar10 (10,000
   images each, batch 512, L=16) at ``model_axis=2`` (C=50 a rank: the
   combine on (50, N)) and at ``sample_axis=2`` (17 samples as 9 + 8),
   against this process's one-process card run (AUCs equal, means within
   rtol 1e-6), then 4 steps of 1024 at ``model_axis=2``, deterministic
   as in (a) (the losses within 1e-5 relative, or the spread as in (a));
   then imagenet64 (a new job, seed 0: C=1000, K=256, its prior and
   class head split over 'model', 500 classes a rank) the same way:
   ``ood_detection_rates`` at ``model_axis=2`` on a test and an OOD set
   of 2,048 synthetic 3x64x64 images at batch 256, L=16 (the combine on
   (500, N)), and 2 steps of 256, each held to this process's
   one-process card run as the flagship's; each rank's launches of each
   run counted (per eager or captured step and batch: 8 conv and 1
   combine a flagship batch, 18 and 1 an imagenet64 batch, 8 forward and
   7 dx a flagship step, 18 and 17 an imagenet64 step), both kernels
   held against their plain versions on each rank at a rank's shapes of
   both geometries (imagenet64's combine at C=500, K=256, L=16, N=256;
   its 5x5 head at the OOD batch's and the step's decode), and
   all_reduce, all_gather, broadcast and barrier on the card's tensors
   over gloo (``mesh_gloo`` line; two processes share the card, so its
   times are no speed figure).  (c) The same, imagenet64 included, over
   NCCL with one rank per card, graphed, each capture holding NCCL
   kernel nodes, when the machine has two cards or more, else one line
   saying that it waits for such a machine (``mesh_nccl`` line);
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
14. the evidence scripts in rehearsal (the evidence slice): first the
   conv against its plain version at their shapes that no earlier phase
   gives it (the plain VAE's eight sites at L=1, n=128 and 256, forward
   and dx, float32 and bfloat16: ``evidence_conv`` lines); then, counted
   as one run, ``scripts/torch_wim_quality.py``, ``torch_wim_study.py``,
   ``torch_poscod_quality.py`` (float32) and
   ``torch_wim_inversion_study.py`` (bfloat16) through their ``main`` at
   1 pretrain epoch of 1,024 images, 256 images per evaluation set and one
   fine-tune epoch of 512, each record's keys those of the JAX package's
   record (``docs/WIM_QUALITY.json`` ...), the WIM quality run's launches
   by stage those worked out from the code (8 forward and 7 dx per step
   of pretraining and per half of a fine-tune step, 8 forward per batch of
   the pre-tuning engines, 16 per both-prior batch, no combine); then
   ``torch_prepare_data.py make-fixtures``, ``torch_reproduce_sota.py
   --fixtures`` (its table's rows, its sets and methods) and
   ``torch_prepare_data.py verify`` on the fixtures (every fixture set
   read back as real) (``evidence`` line: each script's seconds and
   launches);
15. the JAX package's one-program steps as CUDA graphs
   (``train/graphs.py``; every earlier phase already trains through
   them): the flagship's graphed train step against
   its eager step from one state (``new_job`` seed 4 twice), 3 host-fed
   steps of 1024 (the first the graph's eager warm-up, the second
   captured and replayed, the third replayed), bit for bit in float32
   and in bfloat16 under the port's defaults: every metric,
   parameter, BatchNorm buffer, Adam moment, the sigma state, the
   generator's state and the host counts; 8 forward and 7 dx launches
   per eager or captured step, and the capture's graph holding 15
   same-grid kernel nodes by function name; the same for phase 9's
   fine-tune step (64 + 64, 16 and 14 a step, 30 nodes); then graphed
   against eager in one process, in turns
   eager, graph, graph, eager: the bf16 device-fed step at 1024 on a
   50,000-image uint8 set, the float32 host-fed step at 1024 and the
   fine-tune step at 128 + 128 (10 timed steps after 3 warm-up ones each,
   one step of each profiled after a traced warm-up step: device time,
   busy share, and the step's same-grid kernel records on the card, 15
   a train step and 30 a fine-tune step in either mode), one bf16 fused
   epoch at 512 over the 50,000 images (wall seconds; a 4-batch epoch
   profiled); each graph's capture seconds, launches, kernel nodes and
   pool bytes (``graphs`` line);
16. the JAX package's scoring programs as CUDA graphs
   (``train/graphs.py::ScoreGraph``; every earlier phase already scores
   through them): bit gates, graph against eager from one job, on every
   output and on the generator's state after them: (a) the flagship
   ``Scorer`` at 512 / L=16, 64 / L=128 and on the 272-image tail, in
   float32 and bfloat16, three batches from a caller's generator and
   three with the default noise (two captures a Scorer); (b)
   ``ood_detection_rates`` in phase 6's setup: every score, ROC entry and
   record file's bytes; (c) ``ft/job.py::_both_prior_losses`` on phase
   9's WIM job over cifar10's test set at 256; each capture's graph
   holding 8 same-grid and 1 combine kernel nodes by function name (16
   and 1 a both-prior batch) and the wrappers counting them per eager or
   captured batch; then graphed against eager in one process: the
   Scorer at 512 and 64 (L=16), the OOD evaluation (its engine graphs
   held on the job across calls), ``cli.test --compute rehard`` (phase
   8's recompute; each call loads the job and captures anew) and one
   set's both-prior batches: the first calls' ms (the captures among
   them), then ms in turns eager, graph, graph, eager, wall ms, device
   ms and busy share of a profiled call (after a dropped traced one, its
   kernel records held to the batches' launches, but for ``cli.test``),
   capture seconds and the bytes each capture added to its graph's pool
   (``score_graphs`` line);
17. the JAX package's second geometry, imagenet64
   (``models/cvnet.py::imagenet64_config``: a cvae with vgg16 features on
   3x64x64, a [x4:2+1] sub-pixel upsampler with a 5x5 head, widths 2048,
   K=256, a learned 1000-class gaussian prior, test L=16; 40,566,355
   parameters) at full width, batch 512 (``bench.py:57``): its 18
   same-grid sites (13 vgg16 convs, 4 k=4, s=2 sub-pixel deconvs, the
   head) against their plain versions at a serve batch (n=512 features,
   8,192 decoder) in float32 and bfloat16 (``im64_conv`` lines) and at
   the train step's batch 512, forward at 18 and dx at 17 in both dtypes,
   the im2col dw against float64 with cuDNN's wgrad beside
   (``im64_train_conv``, ``im64_dx`` lines), each row with its kernel,
   ms, cuDNN ms and bound; the saved job served by its Scorer graph on 4
   batches of 512 at L=16 in both dtypes (18 conv and 1 combine
   launches per eager or captured batch, the capture's 18 + 1 kernel
   nodes, one batch profiled; in float32 the card against the CPU on 8
   inputs at phase 4's tolerance: ``im64_serve`` lines); phase 5's
   ``train`` at 512 in both dtypes (one epoch of 6 batches, a validation
   split and a test set of 512, save/load exact, 18 forward and 17 dx
   per eager or captured step, 10 timed steps, one profiled; in float32
   the card-vs-CPU gate at batch 8) and the graphed step bit for bit
   against eager over 3 steps (``im64_train_*``, ``im64_graph_bits``
   lines); one fused bfloat16 epoch fed from a 10,000-image uint8 set
   on the card and 10 timed device-fed steps (``im64_device_fed``
   line); ``ood_detection_rates`` at C=1000 on a test set and two OOD
   sets of 2,048 synthetic images (18 + 1 launches per eager or captured
   batch, (1000, N) per-class records, the json and recorders tiers
   with no launch, ROC ms per (set, method): ``im64_ood`` line); all on
   the ``imagenet64`` line;
18. the JAX package's last jitted programs as CUDA graphs, on phase 6's
   flagship job and phase 9's first WIM job (alone: a flagship job of
   another seed): the trainer's per-epoch losses over two epochs with
   train steps between (float32 and bfloat16), ``cli.aggregate``'s
   scores of both jobs, a Poscod fine-tune (the head, Adam's moments and
   counts) and its scores, the sampling driver's correct / incorrect
   scan and ``record_latents``' files, each graphed against eager from
   one job bit for bit, the generators' states after them too; 8 conv
   launches (and a combine where the program computes iws) per eager or
   captured batch and as kernel nodes in each capture, none of the
   port's in Poscod's head step; then graphed against eager in turns
   (one epoch's losses on the 10,000-image test set at 512, the scores
   of two jobs, a Poscod fine-tune and its scores, ``record_latents``):
   first call and ms per call, one profiled call of each mode, capture
   seconds and pool bytes (``jit_graphs`` line);
19. the JAX package's named training configurations
   (``configs/default.ini``; ``CONFIG_SECTIONS``, every section but
   [cifar100], the flagship, [wim-default], WIM's parameters, and
   [imagenet], which both packages refuse) at full width in float32 on
   the registry's synthetic sets: each trained by ``python -m
   joint_vae_tpu_torch.cli.train --config <section>`` in a subprocess
   (one epoch of 4 batches of its batch size, its validation split and
   final test; its OOD evaluation is the one below), four at once,
   while this process holds each same-grid site against its plain
   version with its route at the main path's shapes (the forward at the
   test batch and test L and at the train batch, the dx at the train
   batch; each distinct launch once over the sections) and runs the
   section's training gate (``train_gate``: 3 steps at batch 8 against
   the CPU in float64; a conv bias right before a training-mode
   BatchNorm within BN_BIAS_ROUNDING times the CPU's own float32
   residue); then each saved job: 4 steps trained, saved and loaded
   exactly, 10 graphed steps timed (the conv at each site and its dx per
   eager or captured step, the capture's kernel nodes), served through
   its Scorer's graph at its test batch and L (the conv at each site
   and, for a cvae, one combine per eager or captured batch, as kernel
   nodes in the capture too), card vs CPU at phase 4's tolerance on 8
   uniform inputs (the CPU in float32) and on 8 of its test images (the
   CPU in float64; ``section_card_vs_cpu``),
   ``ood_detection_rates`` on its test set and two same-size sets of
   1,024 with the same launches; on [tilted] WIM with [wim-default]'s
   alternate prior: ``wim_gate`` and ``cli.ft`` with 1,024 training
   images, its launches counted (``config`` lines, one per section, and
   the ``configs`` line);
20. print one JSON line ``{"kernels": [...]}`` (``launches_test_cli``:
   phase 8's recompute; ``launches_wim_ft``: phase 9's first run;
   ``launches_resnet_step``, ``launches_resnet_serve`` and
   ``launches_drivers``: phase 10's; ``launches_interop_*``: phase 11's;
   ``launches_mesh_*``: phase 12's; ``launches_export``: phase 13's;
   ``launches_evidence``: phase 14's; ``launches_graphs``: phase 15's,
   the wrapper's launches in the graphed bit-gate runs and the kernel
   records of the source in each timed case's profiled replay;
   ``launches_score_graphs``: phase 16's, the same of its scoring
   graphs; ``launches_imagenet64`` and ``imagenet64``: phase 17's by
   main path, and its sites' summed times; ``launches_jit_graphs``:
   phase 18's graphed bit-gate runs, by program; ``launches_configs``:
   phase 19's by section and path);
21. print ``{"ok": true, "device": {...}}`` as the last line.

``python3 chip_smoke.py --graphs`` builds the kernels and runs phase 15
alone; ``--score-graphs`` phase 16; ``--imagenet64`` phase 17;
``--jit-graphs`` phase 18; ``--configs`` phase 19; ``--mesh`` phase 12;
``--mesh-nccl`` phase
12 (c) and the one-process runs it is held to.  A
Scorer, engine or both-prior batch runs as a scoring graph
(``train/graphs.py::ScoreGraph``): a graph's first batch eager, its
second captured, every later one a replay (the engines' graphs are held
on the job across calls); a check of launches "per batch" counts them
per eager or captured batch (``batches_run``: ``_scored``).

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
conv's float32 form and tolerance.

Card vs CPU training (phases 5, 9, 10 and 17, ``train_gate`` and
``wim_gate``, one step at a time by ``step_gate``), with the card's
discrete choices imposed on the CPU (``tests/torch_choices.py``).  A
gradient follows the branches its forward took: each ReLU's sign, each
max-pool window's argmax, each clamp's side.  Where an input lies within
rounding of a tie the card and the CPU can branch apart, and
training-mode BatchNorm spreads one such flip to every sample's gradient
(``scripts/time_torch_trunk_grads.py``: resnet18 at an input one ulp
apart, its ReLU flips counted).  So each of 3 steps of the main path
(the graphed train step, the fine-tune step) runs on the card from one
init with injected noise, and the program's own forward and gradient
run first on the card's state before it, eager, their choices recorded:
the recording's loss is the step's bit for bit, or the gate fails.  The
CPU then runs the program's own step in float64
(``torch_choices.Float64``) from the card's state before it, the card's
choices imposed, and every choice where its own would differ must be a
near-tie: within TIE_TOL = 1e-4 of the tie in units of the rms of its
op's input (``|x|`` for a ReLU, the gap to the window's maximum for a
pool), each step printing their count and the worst distance.  Held
then, elementwise, each step: the card's gradient (read from Adam's
first moment before and after the step) against the CPU's,
|card - cpu| <= 1e-4 (|cpu| + rms(cpu)), the conv's form (the gradient
runs through every layer back to the first, each as precise as the
conv gate; the rms term covers the elements whose gradient cancels to
near zero); its loss to 1e-4 relative (float32 sums over 3,072 pixels
and 128 latents); the BatchNorm running statistics and the sigma state
after it within 1e-5 (|cpu| + rms(cpu)).  The CPU's optimizer is fed
the card's gradient of the step (``CardGradient``): Adam's first steps
move every weight by about lr whatever the size of its gradient, so a
gradient zero to rounding would move a weight 2 lr apart on the two
devices.  From the same gradient the card's parameter update lies
within OPT_TOL = 1e-5 (|cpu| + rms(cpu)) of the CPU's beyond one float32
ulp of the parameter, and Adam's second moment within 1e-5 in the
gradients' form.  The ResNet flagship's 20 trunk conv weight gradients
are the exception, held at TRUNK_WGRAD_TOL = 2.6e-4: on the card they are
an im2col product summed in float32 (``models/conv.py::
DeterministicConvFn``), which lies within 1.95e-5 of float64 in
inference mode where cuDNN's wgrad lay 2.29e-4 away
(``scripts/time_torch_trunk_grads.py``), yet in training mode the float32
program itself lies about 1e-4 from float64 at the last stages, on the
card as on the CPU (1.05e-4 and 1.04e-4 there): training-mode BatchNorm
over the batch's values at 1x1 maps leaves each conv's weight gradient
orthogonal to its weight, so the float32 roundings of every op around
it (the convs, BatchNorm's moments and backward) carry into it; with
those ops in float64 it lies within 1.5e-5 (``--cpu-only``).  The gate
reads them at 1.055e-4 to 1.333e-4 over 5 seeds, every repeat of a seed
the same to the last digit (``scripts/torch_trunk_gate_spread.py``);
each step names its worst tensor.

Phase 10's ResNet flagship trains at batch 64 (batch statistics over 8
values at the trunk's 1x1 maps make a step chaotic,
tests/test_torch_resnet.py).  The trunks alone (resnet50, densenet121) in
inference: the conv form at 1e-4.

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
import threading
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
# a choice of the card's that the CPU would not make lies this near its
# tie, in units of the rms of its op's input
TIE_TOL = 1e-4
BN_STATS_RTOL = 1e-5
# the card's Adam update and second moment against the same optimizer on
# the card's gradient in float64 (float32 rounds each of its few ops)
OPT_TOL = 1e-5
# the ResNet flagship's trunk conv weight gradients in phase 10's gate: the
# float32 program's own distance from float64 at training-mode BatchNorm's
# 1x1 maps (the module docstring), 1.055e-4 to 1.333e-4 over 5 seeds on an
# H100 (scripts/torch_trunk_gate_spread.py); held to about twice the worst
TRUNK_WGRAD_TOL = 2.6e-4
# a conv bias right before a training-mode BatchNorm (phase 19's
# [vgg-baseline]): its gradient, zero but for rounding, within this many
# times the CPU's own float32 residue (:func:`bn_bias_limits`)
BN_BIAS_ROUNDING = 8.0
# the backward spans of SameGridConvFn and of the trunk convs' im2col dw
# (record_function)
SPANS = ('same_grid_conv_dx', 'same_grid_conv_dw', 'trunk_conv_dw')
PROFILE_GAP_S = 0.05     # the card idle around a profiled step
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
        if not hasattr(stack, 'plans'):   # none, or an MLP's dense imager
            continue
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


def site_elems(site) -> int:
    """The elements of one image's x or y at a site as launched, the
    larger (a sub-pixel site's y packs stride^2 phases)."""
    co = site['co'] * (site['layer'].stride ** 2
                       if site['route'] == 'subpixel' else 1)
    return site['h'] * site['w'] * max(site['ci'], co)


def site_launches(sites) -> int:
    """The conv launches of one forward over ``sites``: a site whose batch
    passes the kernel's int32 shapes launches once per ``batch_chunks``
    range (at L=128 and 512 images, deconv32's 32-channel 32x32 sites
    launch twice)."""
    from joint_vae_tpu_torch.ops.same_grid_conv import batch_chunks
    return sum(len(batch_chunks(s['n'], site_elems(s))) for s in sites)


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


def check_conv(sites, tag: str = 'conv'):
    """Each site in float32 and bfloat16: kernel vs plain version, then the
    kernel, the plain version and the library call timed.  The library
    call is F.conv2d for a same-grid site and F.conv_transpose2d of the
    true deconv for a sub-pixel site.  FLOPs count the packed conv as
    launched; the true (de)conv's FLOPs are printed beside them.  Each
    row is printed on a ``tag`` line."""
    import torch.nn.functional as F
    from joint_vae_tpu_torch.ops.same_grid_conv import (
        kernel_route, same_grid_conv, same_grid_conv_plain)
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
                   'kernel': kernel_route(dt, ci, co),
                   'dtype': str(dt).split('.')[-1],
                   'launched_shape': [n, h, w, ci, co, th, tw],
                   'ms': ms, 'plain_ms': plain, 'library_ms': lib,
                   'bound_ms': b, 'bound_by': by,
                   'gflop_launched': flops / 1e9, 'gflop_true': true_flops / 1e9,
                   'share_of_bound': b / ms,
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
            print(tag, json.dumps(row), flush=True)
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


def check_sites(sites, what: str, seed: int) -> list:
    """Each site's conv in float32 at its shape against its plain version
    in the conv's form (:func:`conv_gate`): the kernel its shape
    dispatches (``kernel_route``), its largest error and its ms."""
    from joint_vae_tpu_torch.ops.same_grid_conv import (
        kernel_route, same_grid_conv, same_grid_conv_plain)
    g = torch.Generator(device='cuda').manual_seed(seed)
    rows = []
    for site in sites:
        x, _, kd = site_inputs(site, torch.float32, g)
        lo = site['lo']
        y = same_grid_conv(x, kd, lo, lo)
        ref = same_grid_conv_plain(x, kd, lo, lo)
        conv_gate(y, ref, '{} {}'.format(what, site['site']))
        rows.append({'site': site['site'], 'route': site['route'],
                     'launched_shape': list(x.shape) + list(kd.shape),
                     'kernel': kernel_route(x.dtype, x.shape[3], kd.shape[3]),
                     'max_abs_err': (y - ref).abs().max().item(),
                     'ms': time_ms(lambda: same_grid_conv(x, kd, lo, lo), 5)})
        del x, kd, y, ref
    return rows


def check_tail_conv(sites) -> float:
    """The conv at every site for the OOD evaluation's ragged last batch
    (10,000 = 19 x 512 + 272 images: n=272 at the features, 16 x 272 =
    4,352 at the decoder), float32, against its plain version in the
    conv's form (``conv_tail`` lines).  Returns the largest error."""
    rows = check_sites(sites, 'same_grid_conv at the ragged tail', 6)
    for r in rows:
        print('conv_tail', json.dumps(r), flush=True)
    return max(r['max_abs_err'] for r in rows)


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


def hgmma_counts(sass: dict) -> dict:
    """HGMMA (wgmma) instructions of the tensor-core conv kernel
    (``tc_conv_kernel``, which runs the flagship's tensor-core sites) by
    instantiation and type; raises unless its float32 instantiations hold
    TF32 ones and its bfloat16 ones BF16 ones, every one of them."""
    out = {}
    for fn, ops in sass['by_kernel'].items():
        if 'tc_conv_kernel' not in fn:
            continue
        counts = {kind: sum(c for op, c in ops.items()
                            if op.startswith('HGMMA') and kind in op)
                  for kind in ('TF32', 'BF16')}
        # the mangled template arguments: float or __nv_bfloat16
        kind = 'BF16' if 'bfloat16' in fn else 'TF32'
        if counts[kind] == 0:
            raise AssertionError('no HGMMA {} in {}'.format(kind, fn))
        out[fn] = counts
    for kind in ('TF32', 'BF16'):
        if not any(c[kind] for c in out.values()):
            raise AssertionError('no HGMMA {} in the tensor-core conv '
                                 'kernel'.format(kind))
    return out


# the combine's cases: (L, N, C, K, mean scale, modes).  The flagship
# serve point in both modes, a ragged one, the ragged last batch of a
# 10,000-image set at batch 512 (the OOD evaluation's, N=272), the
# flagship's prior scale (init_mean=17), the reference's eval L=128 at a
# scorer batch of 64 and of 512, the imagenet64 geometry (C=1000,
# K=256), and C=1 at the WIM evaluation's batch of 256 with the
# alternate prior's scale (init_mean 8): a class-conditional one-mean
# alternate prior (force_conditional, which load_wim_job restores)
# reaches the kernel there.  Then the streamed kernel (K > 352): the
# named sections [fashion] (K=512) and [fashion-vgg16] (K=1024) at their
# test L=128, C=10 and the prior scale 17, a flagship-width prior at
# K=512, the first K the resident kernel cannot hold (353, ragged, on the
# 4-byte copies) and K=1025 (one k in its last chunk)
IWS_CASES = ((16, 512, 100, 128, 0.1, (True, False)),
             (16, 137, 37, 128, 0.1, (True, False)),
             (16, 272, 100, 128, 0.1, (True, False)),
             (16, 512, 100, 128, 17.0, (True, False)),
             (128, 64, 100, 128, 0.1, (True,)),
             (128, 512, 100, 128, 0.1, (True,)),
             (16, 512, 1000, 256, 0.1, (True,)),
             (16, 256, 1, 128, 8.0, (True, False)),
             (128, 512, 10, 512, 17.0, (True,)),
             (128, 512, 10, 1024, 17.0, (True,)),
             (16, 512, 100, 512, 0.1, (True, False)),
             (16, 137, 37, 353, 0.1, (True, False)),
             (128, 64, 10, 1025, 0.1, (True,)))
LANES_PER_SM, SM_CLOCK_HZ = 128, 1.98e9     # float32 lanes, H100 SXM boost


def iws_inputs(L: int, N: int, C: int, K: int, g: torch.Generator,
               mean_scale: float = 0.1) -> tuple:
    """Combine inputs whose log-weights spread by a few units over l, so
    that the online sum, not the max alone, carries the result: z within
    0.3 of its class mean (means ``mean_scale`` N(0,1) per latent: 0.1,
    or 17 as the flagship's prior draws them), log_pxq about -1e3 with
    noise of a scale drawn per input in [0.25, 2.5] (so that the sum term
    still spreads across inputs at L=128).  Past K=256 the noise of z
    shrinks as 1 / sqrt(K), so that its share of the spread over l stays
    K=256's: at K=512 and L=128, 0.3 would spread the weights over l by
    several units and leave every input's sum term near its least value.
    Returns the kernel's five inputs and each input's class."""
    mean = mean_scale * torch.randn((C, K), generator=g, device='cuda')
    y = torch.randint(0, C, (N,), generator=g, device='cuda')
    noise = 0.3 * min(1.0, (256.0 / K) ** 0.5)
    z = (mean[y][None] + noise * torch.randn((L, N, K), generator=g,
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
    with torch.cuda.graph(graph):
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
                   # the bytes against the two-instruction floor
                   'bound_2instr_ms': max(
                       nbytes / HBM_BYTES_PER_S, 2.0 * L * C * N * K / (
                           sms * LANES_PER_SM * SM_CLOCK_HZ)) * 1e3,
                   'max_abs_err': err,
                   'max_abs_plain': ref.abs().max().item(),
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


def _device_record(ev) -> bool:
    """A profiler event that is a kernel's or a copy's record on the card,
    not a span the trace also draws on the card's timeline (the wrappers'
    ``<kernel>.launch`` spans, SPANS, the profiler's steps): those would
    count the kernels under them twice."""
    return (ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, 'is_user_annotation', False)
            and ev.key not in SPANS and not ev.key.endswith('.launch')
            and not ev.key.startswith('ProfilerStep'))


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
        if not _device_record(ev):
            continue                # operators: their kernels are listed too
        dev_us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.key[:60], ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    by_group = {}
    for ms, key, _ in rows:
        by_group[_bucket(key)] = by_group.get(_bucket(key), 0.0) + ms
    dgrad = [k for _, k, _ in rows if 'dgrad' in k.lower()]
    if dgrad:
        raise AssertionError('the serve batch still runs a transposed conv '
                             'on cuDNN: {}'.format(dgrad))
    return {'wall_ms': wall_ms, 'device_ms': busy,
            'device_busy_share': busy / wall_ms if wall_ms else None,
            'by_group_ms': by_group,
            'top': [{'ms': ms, 'kernel': k, 'calls': c}
                    for ms, k, c in rows[:12]]}


def serve_thresholds(scores: dict) -> dict:
    """Each method's gate from a calibration batch's scores: its 5%
    quantile, or its 5% and 95% ones for a two-sided method."""
    return {m: ((float(np.quantile(v, 0.05)), float(np.quantile(v, 0.95)))
                if m.endswith('-2s') else float(np.quantile(v, 0.05)))
            for m, v in scores.items()}


def serve_card_vs_cpu(job, job_dir: str, thresholds: dict, x8) -> dict:
    """The card against the CPU (the saved job loaded there) on ``x8``
    with injected noise: ``evaluate``'s every loss and the Scorer's every
    score at the serving tolerance, and the labels where the CPU's
    classes are clear of each other."""
    from joint_vae_tpu_torch.models.evaluate import evaluate
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.serve import Scorer
    cfg = job.model_cfg
    L, K = cfg.test_latent_sampling, cfg.latent_dim
    eps = np.random.default_rng(3).standard_normal(
        (L + 1, len(x8), K)).astype(np.float32)
    eps[0] = 0.0
    res = {}
    for name, j in (('cuda', job), ('cpu', load_job(job_dir, device='cpu'))):
        out = evaluate(j.model, torch.as_tensor(x8, device=j.device), None,
                       sigma_state=j.sigma_state, eps=torch.as_tensor(eps),
                       decode_mean=False)
        sc = Scorer(j, methods=METHODS, thresholds=thresholds)(
            x8, eps=torch.as_tensor(eps))
        res[name] = ({k: v.cpu().numpy() for k, v in out.losses.items()}, sc)
    checked = [('loss ' + k, res['cuda'][0][k], want)
               for k, want in res['cpu'][0].items()]
    checked += [('score ' + m, res['cuda'][1]['scores'][m],
                 res['cpu'][1]['scores'][m]) for m in METHODS]
    worst = {}
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
    return {'inputs': len(x8), 'checked': len(checked),
            'clear_labels': int(clear.sum()), 'worst': worst}


def serve(card: str):
    """Phase 4: the flagship through save_job, the CLI and Scorer."""
    from joint_vae_tpu_torch.cli.serve import main as cli_main
    from joint_vae_tpu_torch.models.cvnet import flagship_config
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

    _count_reset()
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
    thresholds = serve_thresholds(calib['scores'])
    scorer = Scorer(job, methods=METHODS, thresholds=thresholds)
    scorer(xs[0])                   # its graph's warm-up, then its capture
    scorer(xs[0])
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
    # CLI (64 inputs), calibration, warm-up and capture, timed: a
    # Scorer's first batch eager, its second captured, the rest replays
    batches = _scored(1 + 1 + 2 + BATCHES, 'serve batches', ('scorer',))
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
    _count_reset()
    outs128, ms128 = [], []
    for _ in range(2):              # the first one meets new shapes
        t0 = time.perf_counter()
        outs128.append(scorer128(xs[2, :BATCH_EVAL]))
        ms128.append((time.perf_counter() - t0) * 1e3)
    launches128 = {'same_grid_conv': same_grid_conv.launches,
                   'iws_combine': iws_combine.launches}
    # --- end of the L=128 path ---
    b128 = _scored(2, 'L={} batches'.format(L_EVAL), ('scorer',))
    if launches128 != {'same_grid_conv': b128 * SITES_PER_BATCH,
                       'iws_combine': b128}:
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
    worst = serve_card_vs_cpu(job, job_dir, thresholds, xs[1, :8])['worst']
    L = cfg.test_latent_sampling
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


def check_train_conv(sites, dt=torch.float32, prefix: str = '',
                     dx_sites: int = DX_PER_STEP):
    """The same-grid conv at the train step's shapes (batch 1024, L=1, or
    the batch of ``sites``) in ``dt``, each row on a ``prefix``-ed line: the forward at every site against its plain version (timed
    beside cuDNN's forward, ``F.conv2d`` of the launched kernel); at the
    sites whose input needs a gradient the dx kernel against its plain
    version (``library_ms``: cuDNN's data gradient of the same conv,
    ``torch.nn.grad.conv2d_input``), and the weight gradient (an im2col
    product summed in float32) against the same product in float64
    (:func:`dw_gate`), timed beside cuDNN's weight gradient in ``dt``,
    whose error against float64 is printed (not gated).  The first site
    reads the data (no dx); ``dx_sites`` sites take one."""
    import torch.nn.functional as F
    from joint_vae_tpu_torch.ops.same_grid_conv import (
        kernel_route, same_grid_conv, same_grid_conv_dw, same_grid_conv_dx,
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
                         'kernel': kernel_route(dt, ci, co),
                         'dtype': str(dt).split('.')[-1], 'ms': fwd_ms,
                         'plain_ms': fwd_plain, 'library_ms': fwd_lib,
                         'bound_ms': fb, 'bound_by': fby,
                         'share_of_bound': fb / fwd_ms,
                         'max_abs_err': fwd_err})
        print(prefix + 'train_conv' + tag, json.dumps(fwd_rows[-1]),
              flush=True)
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
               'kernel': kernel_route(dt, co, ci),
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
        print(prefix + 'dx' + tag, json.dumps(row), flush=True)
        for key in ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'dw_ms',
                    'dw_cudnn_ms'):
            total[key] += row[key]
        total['t_bytes'] += nbytes / HBM_BYTES_PER_S * 1e3
        total['t_ops'] += flops / PEAK_FLOPS[dt] * 1e3
        for key in ('max_abs_err', 'dw_max_rel_err', 'dw_cudnn_max_rel_err'):
            total[key] = max(total[key], row[key])
        del x, kern, kd, g, dx, dx_ref, dw, dw64, dw_cudnn, wc, gc, xc, wk
        torch.cuda.empty_cache()
    if len(dx_rows) != dx_sites:
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
    from joint_vae_tpu_torch.ops.cuda_lib import source_of
    low = name.lower()
    if source_of(name) == 'same_grid_conv':
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
    in (SPANS: the same-grid dx and dw, the trunk convs' dw) or else to a group by its name —
    the same-grid kernel, cuDNN (the strided convs, both directions),
    cuBLAS, the optimizer's foreach kernels, copies, the rest (elementwise
    and reductions); the busy share; and the host's time by operator.
    The same-grid kernel's own launches come from outside PyTorch's
    operators (ctypes), so its forward and dx launches both land in the
    'same_grid_kernel' group; phase 5's per-site times split them.
    ``kernel_records``: the step's kernel records of each CUDA source of
    the port, by function name (a graph's replay included).  Two steps
    run under the profiler: the first traced and dropped (its warm-up:
    a session's first kernel records can be lost late in a long
    process), the second kept, with the card idle for PROFILE_GAP_S on
    either side of it, so that none of its records falls outside the
    kept window by the skew between the host's and the card's clocks."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from joint_vae_tpu_torch.ops.cuda_lib import KERNEL_FUNCTIONS, source_of
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        step(state, xb, yb)
        torch.cuda.synchronize()
        prof.step()                     # the kept step's trace ends at exit
        time.sleep(PROFILE_GAP_S)
        t0 = time.perf_counter()
        step(state, xb, yb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_GAP_S)
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
        if _device_record(ev) and dev_self > 0:
            kernels.append((dev_self, ev.key[:80], ev.count))
    kernels.sort(reverse=True)
    by_name = {}
    for ms, key, _ in kernels:
        by_name[_bucket(key)] = by_name.get(_bucket(key), 0.0) + ms
    busy = sum(k[0] for k in kernels)
    records = dict.fromkeys(KERNEL_FUNCTIONS, 0)
    for ev in prof.key_averages():
        src = source_of(ev.key)
        if ev.device_type == torch.autograd.DeviceType.CUDA and src:
            records[src] += ev.count
    host = sorted(((ev.self_cpu_time_total / 1e3, ev.key[:60], ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type != torch.autograd.DeviceType.CUDA
                   and not ev.key.startswith('ProfilerStep')),
                  reverse=True)
    return {'wall_ms': wall_ms, 'device_ms': busy,
            'device_busy_share': busy / wall_ms if wall_ms else None,
            'by_span_ms': by_span, 'by_name_ms': by_name,
            'kernel_records': records,
            'top': [{'ms': ms, 'kernel': k, 'calls': c}
                    for ms, k, c in kernels[:16]],
            'host_self_ms': sum(h[0] for h in host),
            'top_host': [{'ms': ms, 'op': k, 'calls': c}
                         for ms, k, c in host[:16]]}


def _torch_choices():
    """``tests/torch_choices.py``: the choices recorder and replayer."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    import torch_choices
    return torch_choices


def _ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (|want| + rms(want)) over every element.  An
    element that is NaN on both sides (a vib's sigma rmse: it reconstructs
    nothing) counts as equal; NaN on one side only fails."""
    got, want = got.cpu().double(), want.double()
    nan = got.isnan() & want.isnan()
    got, want = got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0)
    rms = want.square().mean().sqrt()
    return ((got - want).abs() / (want.abs() + rms + 1e-30)).max().item()


def bn_invariant_biases(model) -> list:
    """The conv biases that a BatchNorm right after their conv takes out of
    the training loss (a conv stack's ``conv_i`` followed by ``bn_i``,
    ``batch_norm`` on the features).  Their gradient, the batch sum of
    the BatchNorm's input gradient, is zero but for rounding: the card's
    float32 sum cancels to a residue of its terms' rounding and the CPU's
    float64 one to 1e-17, and a tensor of such residues has no scale of
    its own.  The gate holds each to the CPU's own float32 residue
    (:func:`bn_bias_limits`)."""
    out = []
    for name, mod in model.named_modules():
        for i, pl in enumerate(getattr(mod, 'plans', ())):
            conv = getattr(mod, 'conv_{}'.format(i), None)
            if (getattr(pl, 'batch_norm', False) and conv is not None
                    and getattr(conv, 'bias', None) is not None):
                out.append('{}.conv_{}.bias'.format(name, i) if name else
                           'conv_{}.bias'.format(i))
    return out


def bn_bias_limits(seen32: dict, seen64: dict, names: list) -> dict:
    """Each BatchNorm-invariant bias's limit: BN_BIAS_ROUNDING times the
    largest residue of the same step's gradient in float32 on the CPU
    (the card's choices imposed) against float64, over the tensor."""
    out = {}
    for k in names:
        r = (seen32[k].double() - seen64[k].double()).abs().max()
        if not r > 0:
            raise AssertionError('{}: no float32 residue on the CPU'.format(k))
        out[k] = BN_BIAS_ROUNDING * r
    return out


def check_close(card: dict, cpu: dict, tol: float, what: str,
                apart=(), apart_tol: float = None,
                absolute: dict = None) -> dict:
    """Each tensor of the card's against the float64 CPU's, elementwise
    |card - cpu| <= tol (|cpu| + rms(cpu)), ``apart_tol`` for the tensors
    named in ``apart``, and |card - cpu| <= the limit that ``absolute``
    gives a tensor (:func:`bn_bias_limits`); raises otherwise.
    Returns the worst ratio over every tensor, over ``apart``, over the
    rest and over ``absolute`` (|card - cpu| / limit), and the worst
    tensor's name."""
    worst = {'worst': 0.0, 'worst_apart': 0.0, 'worst_rest': 0.0,
             'worst_absolute': 0.0, 'worst_name': None}
    absolute = absolute or {}
    for k, want in cpu.items():
        if k in absolute:
            err = (card[k].cpu().double() - want.double()).abs()
            r = (err / absolute[k]).max().item()
            worst['worst_absolute'] = max(worst['worst_absolute'], r)
            if not r <= 1.0:
                raise AssertionError(
                    'card vs CPU {} {}: {} of its limit {} (largest error '
                    '{})'.format(what, k, r, float(absolute[k]),
                                 err.max().item()))
            continue
        r = _ratio(card[k], want)
        part = 'worst_apart' if k in apart else 'worst_rest'
        if r > worst['worst']:
            worst['worst'], worst['worst_name'] = r, k
        worst[part] = max(worst[part], r)
        bound = apart_tol if k in apart else tol
        if not r <= bound:
            raise AssertionError('card vs CPU {} {}: {} beyond {}'.format(
                what, k, r, bound))
    return worst


def check_update(after: dict, cpu_after: dict, before: dict,
                 what: str) -> float:
    """The card's parameter update d = after - before against the CPU's,
    elementwise: |d - d_cpu| <= OPT_TOL (|d_cpu| + rms(d_cpu)) beyond one
    float32 ulp of the parameter (the card rounds p + d to float32).
    Returns the worst of (|d - d_cpu| - ulp) / (|d_cpu| + rms(d_cpu))."""
    worst = 0.0
    for k, p0 in before.items():
        want = cpu_after[k] - p0
        p = cpu_after[k].float().abs()
        ulp = (torch.nextafter(p, torch.full_like(p, float('inf'))) - p
               ).double()
        rms = want.square().mean().sqrt()
        r = (((after[k].cpu().double() - p0 - want).abs() - ulp).clamp(min=0)
             / (want.abs() + rms + 1e-30)).max().item()
        worst = max(worst, r)
        if not r <= OPT_TOL:
            raise AssertionError('card vs CPU {} update of {}: {} beyond {}'
                                 .format(what, k, r, OPT_TOL))
    return worst


def trunk_conv_weights(model) -> set:
    """The trunk convs' weights (``models/resnet.py::TrunkConv``), whose
    gradients the gate holds at TRUNK_WGRAD_TOL."""
    from joint_vae_tpu_torch.models.resnet import TrunkConv
    return {n + '.weight' for n, m in model.named_modules()
            if isinstance(m, TrunkConv)}


def check_flips(summary: dict, what: str) -> dict:
    """The card's choices imposed on the CPU differ from the CPU's own
    only at near-ties: every flipped element within TIE_TOL of its op's
    input rms (raises otherwise).  Returns the count and the worst
    distance."""
    if not summary['worst_distance'] <= TIE_TOL:
        raise AssertionError('{}: a flipped choice {} from its tie (beyond '
                             '{}): {}'.format(what, summary['worst_distance'],
                                              TIE_TOL, summary))
    return {'choices': summary['choices'], 'flips': summary['flips'],
            'flips_by_kind': summary['flips_by_kind'],
            'worst_distance': summary['worst_distance'],
            'first_flips': summary['first_flips'][:2]}


def same_loss(recorded: float, gated: float, what: str) -> None:
    """The recording run made the gated run's choices: its loss is the
    gated run's, bit for bit."""
    if recorded != gated:
        raise AssertionError('{}: the recording run\'s loss {!r}, the '
                             'gated run\'s {!r}'.format(what, recorded, gated))


def float64_state(state):
    """A CPU train state made the card's float64 twin: its model, Adam's
    moments and sigma state in float64."""
    from joint_vae_tpu_torch.ops.sigma import SigmaState
    state.model.to(torch.float64)
    opt = state.opt_state
    opt.mu = {k: v.double() for k, v in opt.mu.items()}
    opt.nu = {k: v.double() for k, v in opt.nu.items()}
    state.sigma_state = SigmaState(state.sigma_state.data.double(),
                                   state.sigma_state.rmse.double())
    return state


def load_state(dst, src) -> None:
    """Everything a step reads, from the train state ``src`` into ``dst``
    (each tensor kept on its device and in its dtype): the parameters and
    buffers, Adam's moments, counts and learning rate, the sigma state."""
    with torch.no_grad():
        theirs = src.model.state_dict()
        for k, t in dst.model.state_dict().items():
            t.copy_(theirs[k])
        for mine, other in ((dst.opt_state.mu, src.opt_state.mu),
                            (dst.opt_state.nu, src.opt_state.nu)):
            for k, t in mine.items():
                t.copy_(other[k])
        dst.sigma_state.data.copy_(src.sigma_state.data)
        dst.sigma_state.rmse.copy_(src.sigma_state.rmse)
    opt, other = dst.opt_state, src.opt_state
    opt.learning_rate, opt.count = other.learning_rate, other.count
    opt.adam_count, opt.scalars = other.adam_count, None
    dst.epoch, dst.step = src.epoch, src.step


class CardGradient:
    """The optimizer of a step on the CPU's twin: keeps the gradient that
    the step hands it (:attr:`seen`) and updates from the card's gradient
    of the same step (:attr:`card`) instead.  So the card's update is held
    to the step's own optimizer on the gradient the card used: from the
    CPU's own gradient, Adam's first steps would move a weight whose
    gradient is zero to rounding 2 lr the other way."""

    def __init__(self, tx):
        if tx.cfg.optim_type != 'adam' or tx.cfg.grad_clipping or \
                tx.cfg.weight_decay:
            # the card's gradient is read from Adam's first moment, which
            # holds it as given only without clipping and weight decay
            raise ValueError('the gate reads plain Adam: {}'.format(tx.cfg))
        self.tx, self.cfg = tx, tx.cfg
        self.card, self.seen = None, None

    def update(self, grads, state, params, **kw):
        self.seen = {k: v.detach().clone() for k, v in grads.items()}
        return self.tx.update({k: self.card[k].to(v) for k, v in
                               grads.items()}, state, params, **kw)


def step_gate(record, card_step, cpu_step, card, twin, feed: CardGradient,
              what: str, apart=(), cpu32=None) -> dict:
    """One step of a training gate (the module docstring's form).  Loads
    the card's train state ``card`` into the CPU's float64 ``twin``; runs
    ``record()``, the program's own forward and gradient on the card's
    state (eager, its choices recorded; returns its metrics); the card's
    step ``card_step()`` (returns its metrics); then ``cpu_step()``, the
    program's step on the twin with the card's choices imposed, its
    optimizer fed the card's gradient of the step (read from Adam's first
    moment).  Holds the recording's loss to the card step's bit for bit,
    the step's gradient, loss, parameter update, Adam's second moment,
    BatchNorm statistics and sigma state, and the flips; the gradients
    of ``apart`` at TRUNK_WGRAD_TOL; with ``cpu32`` (a float32 CPU twin,
    its step and its :class:`CardGradient`), the conv biases before a
    training-mode BatchNorm at :func:`bn_bias_limits`."""
    tc = _torch_choices()
    load_state(twin, card)
    if cpu32 is not None:
        load_state(cpu32[0], card)
    before = {k: v.detach().clone() for k, v in
              twin.model.named_parameters()}
    mu = {k: v.clone() for k, v in card.opt_state.mu.items()}
    choices = tc.Choices()
    with choices.recording():
        rec = record()['total'].item()
    m_card = {k: v.item() for k, v in card_step().items()}
    same_loss(rec, m_card['total'], what)
    b1 = feed.cfg.betas[0]
    feed.card = {k: ((card.opt_state.mu[k].double() - b1 * mu[k].double())
                     / (1 - b1)).cpu() for k in mu}
    with tc.Float64(), choices.imposing() as replay:
        m_cpu = {k: v.item() for k, v in cpu_step().items()}
    flips = check_flips(replay.summary(), what)
    limits = {}
    if cpu32 is None and bn_invariant_biases(card.model):
        raise ValueError(what + ': BatchNorm-invariant biases need cpu32')
    if cpu32 is not None:            # the same step in float32 on the CPU
        twin32, step32, feed32 = cpu32
        feed32.card = feed.card
        with choices.imposing():
            step32()
        limits = bn_bias_limits(feed32.seen, feed.seen,
                                bn_invariant_biases(twin32.model))
    loss_err = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
                for k in m_card if k.endswith('total')}
    for k, err in loss_err.items():
        if not err <= TRAIN_LOSS_RTOL:
            raise AssertionError('card vs CPU {} {}: {} vs {}'.format(
                what, k, m_card[k], m_cpu[k]))
    return {
        'loss_cuda': m_card['total'], 'loss_cpu': m_cpu['total'],
        'loss_rel_err': max(loss_err.values()),
        'grad_err_over_abs_plus_rms': check_close(
            feed.card, feed.seen, GRAD_TOL, what + ' gradient', apart,
            TRUNK_WGRAD_TOL, limits),
        'bn_bias_limits': {k: float(v) for k, v in limits.items()},
        'update_err_over_abs_plus_rms': check_update(
            dict(card.model.named_parameters()),
            dict(twin.model.named_parameters()), before, what),
        'nu_err_over_abs_plus_rms': check_close(
            card.opt_state.nu, twin.opt_state.nu, OPT_TOL,
            what + ' second moment')['worst'],
        'bn_stats_err_over_abs_plus_rms': check_close(
            _bn_stats(card.model), _bn_stats(twin.model), BN_STATS_RTOL,
            'BatchNorm statistics after ' + what)['worst'],
        'sigma_err_over_abs_plus_rms': check_close(
            {k: getattr(card.sigma_state, k) for k in ('data', 'rmse')},
            {k: getattr(twin.sigma_state, k) for k in ('data', 'rmse')},
            BN_STATS_RTOL, 'sigma state after ' + what)['worst'],
        'flips': flips}


def _bn_stats(model) -> dict:
    return {k: v.detach().cpu() for k, v in model.named_buffers()
            if k.endswith(('running_mean', 'running_var'))}


def gate_summary(rows: list) -> dict:
    """The worst of each reading over a gate's steps."""
    def worst(key, part=None):
        return max(r[key][part] if part else r[key] for r in rows)
    return {
        'grad_worst': worst('grad_err_over_abs_plus_rms', 'worst_rest'),
        'grad_worst_trunk_conv_weights': worst('grad_err_over_abs_plus_rms',
                                               'worst_apart'),
        'grad_worst_tensors': [r['grad_err_over_abs_plus_rms']['worst_name']
                               for r in rows],
        'bn_bias_worst_over_limit': worst('grad_err_over_abs_plus_rms',
                                          'worst_absolute'),
        'loss_worst_rel_err': worst('loss_rel_err'),
        'update_worst': worst('update_err_over_abs_plus_rms'),
        'nu_worst': worst('nu_err_over_abs_plus_rms'),
        'bn_stats_worst': worst('bn_stats_err_over_abs_plus_rms'),
        'sigma_worst': worst('sigma_err_over_abs_plus_rms'),
        'flips_total': sum(r['flips']['flips'] for r in rows),
        'flip_worst_distance': max(r['flips']['worst_distance']
                                   for r in rows)}


def train_gate(cfg, batch: int = GATE_BATCH, seeds: tuple = (1, 5)) -> dict:
    """The full-width model of ``cfg`` at ``batch`` from one init and one
    batch with its injected noise (``seeds``: the init's and the numpy
    draw's), GATE_STEPS steps of the card's graphed ``make_train_step``
    (the main path), each held by :func:`step_gate` to the same step on
    the CPU in float64 from the card's state before it, the card's
    choices imposed.  The first step's gradient is the first row's."""
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.steps import make_train_step
    init, draw = seeds
    rng = np.random.default_rng(draw)
    x = rng.uniform(0, 1, (batch,) + cfg.input_shape).astype(np.float32)
    y = rng.integers(0, cfg.num_labels, batch).astype(np.int64)
    eps = rng.standard_normal((cfg.latent_sampling + 1, batch,
                               cfg.latent_dim)).astype(np.float32)
    eps[0] = 0.0
    opt = OptimizerConfig(lr=TRAIN_LR)
    card, scratch = (new_job(cfg, opt, seed=init, device='cuda').state
                     for _ in range(2))
    twin = float64_state(new_job(cfg, opt, seed=init, device='cpu').state)
    data = {'cuda': tuple(torch.from_numpy(a).cuda() for a in (x, y, eps)),
            'cpu': tuple(torch.from_numpy(a) for a in (x, y, eps))}
    card_step = make_train_step(card.model, opt)
    # the choices are recorded on a copy of the card's state: the same
    # step eager (phase 15 holds it bit for bit to the graphed one)
    rec_step = make_train_step(scratch.model, opt, graphed=False)
    cpu_step = make_train_step(twin.model, opt, graphed=False)
    cpu_step.tx = feed = CardGradient(cpu_step.tx)
    trunk = trunk_conv_weights(card.model)
    cpu32 = None
    if bn_invariant_biases(card.model):
        twin32 = new_job(cfg, opt, seed=init, device='cpu').state
        step32 = make_train_step(twin32.model, opt, graphed=False)
        step32.tx = feed32 = CardGradient(step32.tx)
        cpu32 = (twin32, lambda: step32(twin32, *data['cpu'][:2],
                                        eps=data['cpu'][2]), feed32)

    def record():
        load_state(scratch, card)
        return rec_step(scratch, *data['cuda'][:2], eps=data['cuda'][2])[1]
    rows = [step_gate(
        record,
        lambda: card_step(card, *data['cuda'][:2], eps=data['cuda'][2])[1],
        lambda: cpu_step(twin, *data['cpu'][:2], eps=data['cpu'][2])[1],
        card, twin, feed, 'step {}'.format(i), trunk, cpu32)
        for i in range(GATE_STEPS)]
    res = {'batch': batch, 'steps': GATE_STEPS, 'seeds': list(seeds),
           'reference': 'CPU float64', 'tensors': len(feed.seen),
           'trunk_conv_weights': len(trunk),
           'bn_stats': len(_bn_stats(card.model)), 'rows': rows}
    res.update(gate_summary(rows))
    return res


def _same_jobs(a, b) -> bool:
    """Two jobs' weights, buffers, optimizer and train state equal."""
    sd, sd2 = a.model.state_dict(), b.model.state_dict()
    o, o2 = a.state.opt_state, b.state.opt_state
    return (set(sd) == set(sd2) and all(torch.equal(sd[k], sd2[k])
                                        for k in sd)
            and (o.count, o.adam_count, o.learning_rate)
            == (o2.count, o2.adam_count, o2.learning_rate)
            and all(set(getattr(o, n)) == set(getattr(o2, n))
                    and all(torch.equal(getattr(o, n)[k], getattr(o2, n)[k])
                            for k in getattr(o, n))
                    for n in ('mu', 'nu', 'trace'))
            and torch.equal(a.sigma_state.data, b.sigma_state.data)
            and (a.state.epoch, a.state.step) == (b.state.epoch, b.state.step))


def train(card: str, cfg=None, sites: int = SITES_PER_BATCH,
          dx: int = DX_PER_STEP, name: str = 'train',
          gate_batch: int = GATE_BATCH,
          batch: int = TRAIN_BATCH, batches: int = TRAIN_BATCHES,
          eval_size: int = TRAIN_TEST, gate: bool = True):
    """Phase 5: the full-width flagship (or ``cfg``, whose forward
    launches the conv ``sites`` times and its input gradient ``dx`` times
    per step) trained through new_job, train_model, save_job and
    load_job for one epoch of ``batches`` batches of ``batch`` (a
    validation split and a test set of ``eval_size`` each, at
    TRAIN_TEST_BATCH), weights, BatchNorm statistics and optimizer state
    compared; then timed steps, a profile and, with ``gate``, the card vs
    CPU gate at ``gate_batch`` (:func:`train_gate`).  Returns the main
    path's launches, the summary and the job."""
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
    n = batch * batches + eval_size
    trainset = ArrayDataset(
        rng.uniform(0, 1, (n,) + cfg.input_shape).astype(np.float32),
        rng.integers(0, cfg.num_labels, n), 'synthetic')
    testset = ArrayDataset(
        rng.uniform(0, 1, (eval_size,) + cfg.input_shape).astype(np.float32),
        rng.integers(0, cfg.num_labels, eval_size), 'synthetic')
    job_dir = os.path.join(WORK, name + '_job')
    job = new_job(cfg, OptimizerConfig(lr=TRAIN_LR), seed=0)   # on the card

    _count_reset()
    # --- the main path: train_model, one epoch ---
    t0 = time.perf_counter()
    train_model(job, trainset, testset, epochs=1, batch_size=batch,
                test_batch_size=TRAIN_TEST_BATCH, validation=eval_size,
                save_dir=job_dir, final_test=False, final_ood=False,
                outputs=EpochOutput(stdout=False))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = {'same_grid_conv': same_grid_conv.launches,
                'same_grid_conv_dx': same_grid_conv_dx.launches,
                'iws_combine': iws_combine.launches}
    # --- end of the main path ---
    # the validation and test sets' batches as a scoring graph: its
    # warm-up and capture counted
    eval_batches = _scored(2 * (eval_size // TRAIN_TEST_BATCH),
                           'train evaluations', ('mean_losses',))
    body = _body_steps(batches, 'train epoch')
    want = {'same_grid_conv': sites * (body + eval_batches),
            'same_grid_conv_dx': dx * body,
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
    if job.state.step != batches:
        raise AssertionError('{} steps'.format(job.state.step))

    # --- save_job / load_job: weights and optimizer state exactly ---
    save_job(job, job_dir)
    if not _same_jobs(job, load_job(job_dir)):
        raise AssertionError('reloaded weights, optimizer or train state '
                             'differ')

    # --- timed steps, fed as train_model feeds them ---
    step = make_train_step(job.model, job.opt_cfg)
    state = job.state
    def batches_of(seed=1):     # epoch after epoch: a short epoch's set
        while True:             # holds fewer batches than are timed
            yield from DataLoader(trainset, batch, shuffle=True, seed=seed,
                                  drop_last=True)
            seed += 1
    loader = batches_of()
    dev = state.device
    for _ in range(TRAIN_WARMUP):
        xb, yb = next(loader)
        state, m = step(state, to_device(xb, dev), to_device(yb, dev))
    torch.cuda.synchronize()
    _count_reset()
    pending, staged = [], []
    loader_s = copy_s = 0.0
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        t1 = time.perf_counter()
        xb, yb = next(loader)
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
    body = _body_steps(TRAIN_TIMED, 'timed steps')
    if timed_launches != {'same_grid_conv': sites * body,
                          'same_grid_conv_dx': dx * body}:
        raise AssertionError('timed steps launched {}'.format(timed_launches))
    got = pull_metrics(pending)
    if not all(np.isfinite(list(r.values())).all() for r in got):
        raise AssertionError('non-finite train metrics')
    t0 = time.perf_counter()             # the same batches, already on the card
    for xy in staged:
        state, m = step(state, *xy)
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    xb, yb = next(loader)
    breakdown = profile_train_step(step, state, to_device(xb, dev),
                                   to_device(yb, dev))
    gate = train_gate(cfg, gate_batch) if gate else None
    summary = {'batch': batch, 'epoch_batches': batches,
               'epoch_seconds': epoch_s,
               'epoch_images_per_s': batch * batches / epoch_s,
               'timed_steps': TRAIN_TIMED, 'warmup_steps': TRAIN_WARMUP,
               'ms_per_step': timed_s * 1e3 / TRAIN_TIMED,
               'train_images_per_s': batch * TRAIN_TIMED / timed_s,
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
        if _device_record(ev) and dev > 0:
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
        kernel_route, same_grid_conv, same_grid_conv_dx,
        same_grid_conv_dx_plain)
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
        'kernel': kernel_route(torch.float32, co, ci),
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
        _count_reset()
        # --- the main path: the three engines, in order ---
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engines.ood_detection_rates(job, testset, oodsets,
                                          batch_size=OOD_BATCH)
        torch.cuda.synchronize()
        ood_s = time.perf_counter() - t0
        launches = {'same_grid_conv': same_grid_conv.launches,
                    'iws_combine': iws_combine.launches}
        ood_runs = _batches_run()
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
    # one graph for the full batches and one for the tail, held across the
    # sets: their warm-ups and captures counted, their replays not
    counted = _scored(batches * len(sets), 'OOD evaluation', runs=ood_runs)
    want = {'same_grid_conv': SITES_PER_BATCH * counted,
            'iws_combine': counted}
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
               'batches_run': ood_runs,
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
    """Every launch counter and the step graphs' ``steps_run`` to 0."""
    from joint_vae_tpu_torch.ops.iws import iws_combine
    from joint_vae_tpu_torch.ops.same_grid_conv import (
        bf16_launches, same_grid_conv, same_grid_conv_dx)
    from joint_vae_tpu_torch.train.graphs import reset_steps_run
    same_grid_conv.launches = 0
    same_grid_conv_dx.launches = 0
    iws_combine.launches = 0
    for k in bf16_launches:
        bf16_launches[k] = 0
    reset_steps_run()


def _body_steps(steps: int, what: str, run: dict = None) -> int:
    """Of ``steps`` train or fine-tune steps since ``_count_reset`` (or in
    ``run``, a ``steps_run`` record), those whose launches the wrappers
    counted: the eager ones and the captures.  A replay calls no wrapper;
    its launches are its graph's kernel nodes, held at capture against
    the capture's count (``train/graphs.py``) and counted on the card in
    phase 15's profiled replays.  Every one of ``steps`` must have run."""
    from joint_vae_tpu_torch.train.graphs import steps_run
    run = steps_run if run is None else run
    if run['eager'] + run['replayed'] != steps:
        raise AssertionError('{}: steps run {}, want {} steps'.format(
            what, run, steps))
    return run['eager'] + run['captured']


def _scored(batches: int, what: str, names=None, runs: dict = None) -> int:
    """Of ``batches`` scored batches since ``_count_reset`` (or in
    ``runs``, a ``batches_run`` record) of the scoring graphs ``names``
    (every one by default), those whose launches the wrappers counted:
    the eager ones (a graph's warm-up, a mesh or ungraphed batch) and the
    captures.  A replay's launches are its graph's kernel nodes, held at
    capture against the capture's count (``train/graphs.py``) and counted
    on the card in phase 16's profiled replays.  Every one of
    ``batches`` must have run."""
    from joint_vae_tpu_torch.train.graphs import batches_run
    runs = batches_run if runs is None else runs
    picked = [r for n, r in runs.items() if names is None or n in names]
    ran = sum(r['eager'] + r['replayed'] for r in picked)
    if ran != batches:
        raise AssertionError('{}: scored batches {}, want {}'.format(
            what, runs, batches))
    return sum(r['eager'] + r['captured'] for r in picked)


def _batches_run() -> dict:
    from joint_vae_tpu_torch.train.graphs import batches_run
    return {n: dict(r) for n, r in batches_run.items()}


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


def _want(steps: int, batches: int = 0, sites: int = SITES_PER_BATCH,
          dx: int = DX_PER_STEP) -> dict:
    """Launches of ``steps`` train steps and ``batches`` scored batches of
    a model with ``sites`` same-grid sites, ``dx`` of them with an input
    gradient (the flagship's by default)."""
    return {'same_grid_conv': sites * (steps + batches),
            'same_grid_conv_dx': dx * steps,
            'iws_combine': batches}


def time_device_steps(job, dd, batch: int, want=_want) -> dict:
    """10 device-fed steps after 3 warm-up ones, each gathering its rows of
    a DeviceDataset in the epoch's order, with their launches (``want``
    of the steps); then one step profiled (phase 5's breakdown)."""
    from joint_vae_tpu_torch.train.device_data import (epoch_permutation,
                                                       make_device_train_step)
    from joint_vae_tpu_torch.train.steps import pull_metrics
    step = make_device_train_step(job.model, job.opt_cfg, batch)
    state = job.state
    perm = epoch_permutation(dd.n, 1, 0, dd.x.device)
    for i in range(TRAIN_WARMUP):
        state, m = step(state, dd.x, dd.y, i, perm=perm)
    torch.cuda.synchronize()
    _count_reset()
    pending = []
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_TIMED):
        state, m = step(state, dd.x, dd.y, i, perm=perm)
        pending.append(m)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    launches = _counts()
    if launches != want(_body_steps(TRAIN_TIMED, 'device-fed steps')):
        raise AssertionError('device-fed steps launched {}'.format(launches))
    _check_bf16_counts(launches, job.model.cfg.compute_dtype == 'bfloat16',
                       'device-fed steps')
    got = pull_metrics(pending)
    if not all(np.isfinite(list(r.values())).all() for r in got):
        raise AssertionError('non-finite device-fed metrics')
    i = TRAIN_WARMUP + TRAIN_TIMED
    breakdown = profile_train_step(
        lambda st, a, b: step(st, a, b, i, perm=perm), state, dd.x, dd.y)
    return {'batch': batch, 'ms_per_step': s * 1e3 / TRAIN_TIMED,
            'images_per_s': batch * TRAIN_TIMED / s, 'launches': launches,
            'last_total': got[-1]['total'], 'profile': breakdown}


def profile_device_epoch(cfg, trainset, batch: int) -> dict:
    """One fused ``train_epochs_on_device`` epoch over 4 batches under
    torch.profiler: the gathers counted (per step two, x's and y's rows
    into the step graph's buffers; none of the whole set)."""
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
    if gathers != 2 * 4:
        raise AssertionError('{} gathers in a device-fed epoch of 4 steps, '
                             'want 8 (x and y per step)'.format(gathers))
    return {'steps': 4, 'index_select': gathers,
            'graph_launches': ops.get('cudaGraphLaunch', 0)}


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
        del out, got                # before the step graph's capture
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
            scorer(x, eps=et)                 # captured: the next a replay
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
    host-fed one; one device-fed epoch profiled (two gathers a step);
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
        want = _want(_body_steps(steps, 'bf16 {} epoch'.format(mode)))
        if launches != want:
            raise AssertionError('bf16 {} epoch launched {}, want {}'.format(
                mode, launches, want))
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
        # each engine's batches as scoring graphs: the warm-ups and
        # captures counted, the replays not
        want = _want(0, _scored(passes * batches, 'cli.test rehard'))
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


def wim_gate(job_dir: str, cfg=None) -> dict:
    """Card against CPU on phase 4's weights (or the job of ``cfg``) with
    the alternate prior
    drawn from one numpy seed: a both-prior evaluation of 8 inputs at
    L=16 (every loss and '@' twin, then every WIM score from them, at the
    serving tolerance); then GATE_STEPS fine-tuning steps of 8 in and 8
    moving inputs on the card (``finetune_batch``), each held by
    :func:`step_gate` to the same step on the CPU in float64 from the
    card's state before it, the card's choices imposed (recorded in the
    card's ``finetune_grads``); the prior and every buffer bit-equal
    after the card's steps."""
    from joint_vae_tpu_torch.ft.job import wim_scores_for_set
    from joint_vae_tpu_torch.ft.wim import WIMJob
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.train.optimizers import build_optimizer
    from joint_vae_tpu_torch.train.state import named_params
    cfg = cfg or flagship_config()
    # the '~' methods read each input's class estimate: a per-class
    # model's (a vae's [tilted] has none)
    methods = (WIM_METHODS + WIM_MISCLASS if cfg.losses_per_class
               else tuple(m for m in WIM_METHODS if '~' not in m))
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
    wims, evals, data, noise = {}, {}, {}, {}
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
        evals[dev] = (host, wim_scores_for_set(wim, host, methods))
        wims[dev] = wim
        data[dev] = (t(x_in), t(y), t(x_mix))
        noise[dev] = t(eps)
        job.state.opt_state = build_optimizer(job.opt_cfg).init(
            named_params(job.model))
    card, twin = wims['cuda'], wims['cpu']
    state, twin_state = card.job.state, float64_state(twin.job.state)
    tx = build_optimizer(card.job.opt_cfg)
    feed = CardGradient(build_optimizer(twin.job.opt_cfg))
    keep = {k: v.detach().clone() for k, v in _frozen(card.model)}
    steps = {'cuda': tx, 'cpu': feed}

    def run(dev, st):
        return (wims[dev].finetune_batch(
            st, *data[dev], WIM_ALPHA, tx=steps[dev],
            train_L=cfg.latent_sampling, eps=noise[dev])[1])
    rows = [step_gate(
        lambda: card.finetune_grads(state, *data['cuda'], WIM_ALPHA,
                                    train_L=cfg.latent_sampling,
                                    eps=noise['cuda'])[1],
        lambda: run('cuda', state), lambda: run('cpu', twin_state),
        state, twin_state, feed, 'fine-tuning step {}'.format(i))
        for i in range(GATE_STEPS)]
    now = dict(_frozen(card.model))
    moved = [k for k in keep if not torch.equal(now[k], keep[k])]
    if moved:
        raise AssertionError('fine-tuning moved {}'.format(moved))
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
    res = {'batch': n, 'steps': GATE_STEPS, 'reference': 'CPU float64',
           'tensors': len(feed.seen), 'rows': rows,
           'frozen_bit_equal': sorted(keep),
           'both_priors_worst_elementwise_rel_err': worst}
    res.update(gate_summary(rows))
    return res


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
    if launches != _ft_want(_body_steps(WIM_TIMED_STEPS, 'fine-tune steps'),
                            0, 0):
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
        for name, argv, steps, evals in (
                ('ft', ['0', '--train-size', str(WIM_TRAIN_SIZE),
                        '--inspection'], WIM_TRAIN_SIZE // WIM_BATCH,
                 (n_sets * batches, n_sets * batches,
                  2 * n_sets * WIM_LATENT_BATCHES)),
                ('ft_task1', ['0', '--train-size', str(WIM_TRAIN_SIZE_2),
                              '--task', '1'], WIM_TRAIN_SIZE_2 // WIM_BATCH,
                 (n_sets * batches, n_sets * batches))):
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
            # the pre-tuning engine's, the both-prior and record_latents'
            # batches as scoring graphs: their warm-ups and captures
            # counted
            want = _ft_want(
                _body_steps(steps, name),
                _scored(evals[0], name + ' pre-tuning', ('score_batch',)),
                _scored(evals[1], name + ' both-prior',
                        ('both_prior_batch',)),
                *[_scored(n, name + ' latents', ('latents_batch',))
                  for n in evals[2:]])
            if rc != 0 or launches != want:
                raise AssertionError('{}: exit {}, launches {}, want {}'
                                     .format(name, rc, launches, want))
            (d,) = set(_job_dirs(os.path.join(root, 'wim'))) - seen
            runs[name] = {'dir': d, 'wall_s': wall, 'launches': launches,
                          'batches_run': _batches_run(),
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
        # the frozen net's batches as a scoring graph: its warm-ups and
        # captures counted
        want['same_grid_conv'] = SITES_PER_BATCH * _scored(
            2 * poscod_epochs * train_steps + n_sets * batches, 'poscod',
            ('poscod_batch',))
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
RESNET_REPEAT_STEPS = 2          # float32 steps run twice from one state
TRUNK_ARCHS = ('resnet50', 'densenet121')
DRIVER_SETS = ('cifar10', 'svhn', 'lsunc')     # phase 6's OOD sets


def resnet_config():
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    return dataclasses.replace(flagship_config(), features='resnet18')


def _sites(cfg) -> int:
    """Same-grid launches of one evaluate of a flagship-shaped model."""
    return RESNET_SITES if cfg.features.startswith('resnet') else SITES_PER_BATCH


def resnet_repeat_bits(cfg, batch: int = TRAIN_BATCH) -> dict:
    """The ResNet flagship's float32 train step repeated: RESNET_REPEAT_STEPS
    graphed host-fed steps of ``batch`` from one state (``new_job`` seed 4),
    one batch stream and the job's noise, run twice in this process under
    the port's defaults; each step's gradient (Adam's first moment holds
    it) and every tensor of :func:`_run_tensors` and metric bit-equal
    (the trunk convs' deterministic dx and im2col dw,
    ``models/conv.py::DeterministicConvFn``)."""
    from joint_vae_tpu_torch.device import to_device
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.steps import make_train_step
    rng = np.random.default_rng(13)
    xs = rng.uniform(0, 1, (RESNET_REPEAT_STEPS, batch) + cfg.input_shape
                     ).astype(np.float32)
    ys = rng.integers(0, cfg.num_labels, (RESNET_REPEAT_STEPS, batch))
    dev = torch.device('cuda')
    runs = []
    t0 = time.perf_counter()
    for _ in range(2):
        job = new_job(cfg, OptimizerConfig(lr=TRAIN_LR), seed=4)
        step = make_train_step(job.model, job.opt_cfg)
        st, ms, grads = job.state, [], []
        for i in range(RESNET_REPEAT_STEPS):
            st, m = step(st, to_device(xs[i], dev), to_device(ys[i], dev))
            ms.append(m.vector)
            grads.append({k: v.detach().cpu() for k, v in
                          st.opt_state.mu.items()})
        torch.cuda.synchronize()
        runs.append({'metrics': torch.stack(ms).cpu(), 'grads': grads,
                     'tensors': {k: v.detach().cpu()
                                 for k, v in _run_tensors(job).items()}})
        del job, step, st
    if torch.backends.cudnn.deterministic:
        raise AssertionError('cuDNN\'s deterministic switch was left on')
    a, b = runs
    diff = ['step {} gradient {}'.format(i, k)
            for i, (ga, gb) in enumerate(zip(a['grads'], b['grads']))
            for k in ga if not torch.equal(ga[k], gb[k])]
    diff += [k for k in a['tensors'] if not torch.equal(a['tensors'][k],
                                                        b['tensors'][k])]
    if not torch.equal(a['metrics'], b['metrics']):
        diff.append('metrics')
    if diff:
        raise AssertionError('ResNet flagship float32 steps do not repeat: '
                             '{} differ, first {}'.format(len(diff),
                                                          diff[:8]))
    return {'batch': batch, 'steps': RESNET_REPEAT_STEPS,
            'gradients_equal': sum(len(g) for g in a['grads']),
            'tensors_equal': len(a['tensors']),
            'metrics_equal': int(a['metrics'].numel()),
            'seconds': time.perf_counter() - t0}


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
    counted = _scored(BATCHES, 'ResNet Scorer', ('scorer',))
    if launches != {'same_grid_conv': RESNET_SITES * counted,
                    'same_grid_conv_dx': 0, 'iws_combine': counted}:
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
    # the scores' batches (the test and OOD sets) as a scoring graph per
    # job, held on it: the warm-ups and captures counted, as many for
    # each job; the record sets' batches eager
    scored = _scored(2 * batches * (1 + len(DRIVER_SETS)), 'aggregate',
                     ('aggregate_batch',))
    counted = batches * (1 + len(DRIVER_SETS)) + scored // 2
    want = {'same_grid_conv': counted * (SITES_PER_BATCH + RESNET_SITES),
            'same_grid_conv_dx': 0, 'iws_combine': 2 * counted}
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
        gate_batch=RESNET_GATE_BATCH)
    repeat = resnet_repeat_bits(cfg)
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
              'float32_repeat': repeat, 'trunks': trunks, 'card': card}
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
                'iws_combine': ('iws_combine_kernel',
                                'iws_combine_streamed_kernel')}


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
    # eager: the trace counts the wrappers' launch spans of the batch
    scorer = Scorer(imp, methods=METHODS, thresholds=lows, graphed=False)
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
    want_test = _want(0, _scored(passes * batches, 'imported cli.test'))
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
    if resume_launches != _want(_body_steps(INTEROP_RESUME_STEPS,
                                            'resumed steps')):
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
# (b)/(c)'s imagenet64 pair (C=1000, K=256 at model 2: a rank's combine on
# (500, N)): a test and an OOD set of MESH_IM64_SET synthetic images at
# batch 256, L=16, then MESH_IM64_STEPS steps of 256
MESH_IM64_SET, MESH_IM64_BATCH, MESH_IM64_STEPS = 2048, 256, 2
MESH_IM64_RUNS = ({'name': 'im64_model2', 'model_axis': 2,
                   'geometry': 'imagenet64'},
                  {'name': 'im64_steps2', 'model_axis': 2,
                   'steps': MESH_IM64_STEPS, 'geometry': 'imagenet64'})
MESH_GRAPH_SET = 2 * OOD_BATCH + 272   # (a)'s graphed OOD: two batches, a tail
MESH_TURNS = ('eager', 'graph', 'plain_graph', 'plain_graph', 'graph',
              'eager')


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
    ``backend`` against the same steps without a mesh (both graphed); the
    eager steps and the all-reduce timed, the all-reduce also alone in a
    graph; the sharded checkpoint, synchronous and asynchronous, restored
    byte-equal into a run without a mesh; on the card, the mesh programs
    graphed against eager (:func:`mesh_graphs_world1`)."""
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
        # the mesh step graphed (a replay calls no wrapper)
        body = _body_steps(len(got), 'world-1 mesh steps')
        if launches != _want(body):
            raise AssertionError('world-1 mesh steps launched {}, want {}'
                                 .format(launches, _want(body)))
        if len(got) != MESH_STEPS:
            raise AssertionError('{} mesh steps'.format(len(got)))
        worst = _steps_gate(got, want, again, meshed.model_cfg,
                            MESH_WORLD1_RTOL, 'world-1 mesh')

        # the eager step with and without the mesh, in turns; the all-reduce
        x, y = trainset[:MESH_BATCH]
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        yd = torch.from_numpy(np.ascontiguousarray(y)).to(device)
        steps = {'plain': (plain.state, make_train_step(
                     plain.model, plain.opt_cfg, graphed=False)),
                 'mesh': (meshed.state, make_train_step(
                     meshed.model, meshed.opt_cfg, mesh=mesh,
                     graphed=False))}

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
            collectives = {
                'all_reduce': _collective_graph(lambda: all_reduce_mean_(
                    flat, mesh, 'data', force=True)),
                'reduce_over_data': _collective_graph(
                    lambda: reduce_over_data(grads, mesh))}
            del plain, steps
            graphs = mesh_graphs_world1(mesh, collectives)
        else:
            ar_ms = red_ms = collectives = graphs = None

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
               'launches': launches, 'collective_graphs': collectives,
               'graphs': graphs}
    print('mesh_world1', json.dumps(summary), flush=True)
    return launches, summary


def _collective_graph(fn, reps: int = 20) -> dict:
    """A collective alone in a CUDA graph: run once eagerly on the
    capturing stream (its communicator exists before the capture), then
    captured in the default ``capture_error_mode``; its nodes by type, the
    NCCL kernel nodes among them, and the replay's device ms (CUDA
    events)."""
    from joint_vae_tpu_torch.train.graphs import kernel_nodes
    side = torch.cuda.Stream()
    cur = torch.cuda.current_stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            fn()
        finally:
            graph.capture_end()
    cur.wait_stream(side)
    nodes = kernel_nodes(graph.raw_cuda_graph())
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return {'replay_ms': start.elapsed_time(end) / reps,
            'nodes_by_type': nodes['by_type'],
            'nccl_kernel_nodes': nodes['nccl']}


def _nccl_nodes(capture: dict) -> dict:
    """What a capture record says of the graph's collectives."""
    return {k: capture[k] for k in ('nccl_kernel_nodes', 'nodes_by_type',
                                    'kernel_nodes_by_source', 'capture_s')}


def mesh_ood_bits(job_dir: str, mesh) -> dict:
    """``ood_detection_rates(mesh=)`` of the flagship job on the world-1
    mesh, graphed against eager: MESH_GRAPH_SET images of cifar100's test
    set and of cifar10 at OOD_BATCH (two batches and a ragged tail a
    set), every entry equal; 8 conv and 1 combine launches per eager or
    captured batch."""
    from joint_vae_tpu_torch.parallel.mesh import ensure_placed
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.train.graphs import held_score_graphs
    testset, ood = _mesh_sets(MESH_GRAPH_SET)
    n_batches = 2 * -(-MESH_GRAPH_SET // OOD_BATCH)
    runs = {}
    for graphed in (False, True):
        job = load_job(job_dir)
        job.state = ensure_placed(job.state, mesh)
        _count_reset()
        res = _mesh_ood(job, testset, ood, OOD_BATCH, 'cuda', mesh,
                        graphed=graphed)
        torch.cuda.synchronize()
        scored = _scored(n_batches, 'world-1 mesh OOD graphed {}'.format(
            graphed))
        if _counts() != _want(0, scored):
            raise AssertionError('world-1 mesh OOD (graphed {}): launched '
                                 '{}, want {}'.format(graphed, _counts(),
                                                      _want(0, scored)))
        runs[graphed] = {'result': res, 'launches': _counts(),
                         'batches_run': _batches_run(),
                         'captures': [c for g in held_score_graphs(
                             job).values() for c in g.captures]}
        del job
    if runs[True]['result'] != runs[False]['result']:
        raise AssertionError('world-1 mesh OOD: graphed {} against eager '
                             '{}'.format(runs[True]['result'],
                                         runs[False]['result']))
    caps = runs[True]['captures']
    if len(caps) != 2 or any(c['kernel_nodes_by_source'] != {
            'same_grid_conv': SITES_PER_BATCH, 'iws_combine': 1}
            for c in caps):
        raise AssertionError('world-1 mesh OOD: captures {}'.format(caps))
    return {'set': MESH_GRAPH_SET, 'batch': OOD_BATCH,
            'aucs': {m: e['auc'] for m, e in runs[True]['result'][
                MESH_OOD].items()},
            'entries_equal': True,
            'launches': {'eager': runs[False]['launches'],
                         'graphed': runs[True]['launches']},
            'batches_run': runs[True]['batches_run'],
            'captures': [_nccl_nodes(c) for c in caps]}


def _mesh_turns(name: str, steps: dict, states: dict, feed) -> dict:
    """ms per step of each mode of ``steps`` (TRAIN_WARMUP steps each
    first, then TRAIN_TIMED steps a turn in MESH_TURNS' order,
    synchronised), with the graphed mesh step's capture record."""
    i = [0]

    def run(mode, n):
        for _ in range(n):
            states[mode], _ = steps[mode](states[mode], *feed(i[0]))
            i[0] += 1
    for mode in steps:
        run(mode, TRAIN_WARMUP)
    got = {m: [] for m in steps}
    for mode in (m for m in MESH_TURNS if m in steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(mode, TRAIN_TIMED)
        torch.cuda.synchronize()
        got[mode].append((time.perf_counter() - t0) * 1e3 / TRAIN_TIMED)
    caps = steps['graph'].graph.captures
    return {'case': name, 'ms_per_step': {m: float(np.mean(v))
                                          for m, v in got.items()},
            'turns': [m for m in MESH_TURNS if m in steps],
            'capture': _nccl_nodes(caps[0]) if caps else None}


def mesh_graph_timings(mesh, job_dir: str) -> list:
    """The world-1 mesh's steps graphed and eager, and the same step
    graphed off the mesh, in turns: the flagship's host-fed train step at
    MESH_BATCH in float32 and bfloat16, the fine-tune step at
    GRAPH_FT_BATCH + GRAPH_FT_BATCH (on the mesh only)."""
    from joint_vae_tpu_torch.device import to_device
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.parallel.mesh import ensure_placed
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.steps import make_train_step
    rng = np.random.default_rng(19)
    dev = torch.device('cuda')
    modes = {'eager': (mesh, False), 'graph': (mesh, True),
             'plain_graph': (None, True)}
    cases = []
    for dtype in ('float32', 'bfloat16'):
        cfg = flagship_config(compute_dtype=dtype)
        hx = rng.uniform(0, 1, (4, MESH_BATCH) + cfg.input_shape
                         ).astype(np.float32)
        hy = rng.integers(0, cfg.num_labels, (4, MESH_BATCH))
        jobs, steps = {}, {}
        for m, (on, graphed) in modes.items():
            jobs[m] = new_job(cfg, OptimizerConfig(lr=TRAIN_LR), seed=0)
            if on is not None:
                jobs[m].state = ensure_placed(jobs[m].state, on)
            steps[m] = make_train_step(jobs[m].model, jobs[m].opt_cfg,
                                       mesh=on, graphed=graphed)
        cases.append(_mesh_turns(
            'train_' + dtype, steps, {m: j.state for m, j in jobs.items()},
            lambda i: (to_device(hx[i % 4], dev), to_device(hy[i % 4], dev))))
        del jobs, steps
        torch.cuda.empty_cache()
    cfg = flagship_config()
    fx = rng.uniform(0, 1, (4, 2, GRAPH_FT_BATCH) + cfg.input_shape
                     ).astype(np.float32)
    fy = rng.integers(0, cfg.num_labels, (4, GRAPH_FT_BATCH))
    pairs = {m: _wim_pair(job_dir, m == 'graph', mesh)
             for m in ('eager', 'graph')}
    cases.append(_mesh_turns(
        'finetune', {m: p[1] for m, p in pairs.items()},
        {m: p[0].state for m, p in pairs.items()},
        lambda i: (to_device(fx[i % 4, 0], dev), to_device(fy[i % 4], dev),
                   to_device(fx[i % 4, 1], dev))))
    del pairs
    torch.cuda.empty_cache()
    return cases


def mesh_graphs_world1(mesh, collectives: dict) -> dict:
    """(a)'s graphs on the world-1 NCCL mesh: the mesh train step (float32
    and bfloat16, MESH_STEPS steps of MESH_BATCH) and the mesh fine-tune
    step (GRAPH_FT_BATCH + GRAPH_FT_BATCH) graphed against their eager
    selves from one state, bit for bit, 8 forward and 7 dx kernel nodes a
    train step graph; ``ood_detection_rates(mesh=)`` graphed against
    eager; then the timings in turns.  ``collectives``: the all-reduce
    alone in a graph (:func:`_collective_graph`), whose NCCL nodes each
    step graph must hold too."""
    t0 = time.perf_counter()
    job_dir = _flagship_dir()
    bits = {'train_float32': graph_train_bits(
                'float32', batch=MESH_BATCH, mesh=mesh, steps=MESH_STEPS),
            'train_bfloat16': graph_train_bits(
                'bfloat16', batch=MESH_BATCH, mesh=mesh, steps=MESH_STEPS),
            'finetune': graph_ft_bits(job_dir, mesh, GRAPH_FT_BATCH)}
    want = collectives['all_reduce']['nccl_kernel_nodes']
    for name, b in bits.items():
        got = b['capture']['nccl_kernel_nodes']
        if got != want:
            raise AssertionError('world-1 mesh {}: {} NCCL kernel nodes in '
                                 'its graph, the all-reduce alone holds {}'
                                 .format(name, got, want))
    ood = mesh_ood_bits(job_dir, mesh)
    timings = mesh_graph_timings(mesh, job_dir)
    return {'bits': {k: {**{kk: v for kk, v in b.items()
                            if kk not in ('capture',)},
                         'capture': _nccl_nodes(b['capture'])}
                     for k, b in bits.items()},
            'ood': ood, 'timings': timings,
            'seconds': time.perf_counter() - t0}


def _mesh_sets(size=None):
    from joint_vae_tpu_torch.data.loaders import get_dataset
    _, testset = get_dataset('cifar100', splits=['test'])
    _, ood = get_dataset(MESH_OOD, splits=['test'])
    if size:
        testset = testset.subset(np.arange(size))
        ood = ood.subset(np.arange(size))
    return testset, ood


def _mesh_ood(job, testset, ood, batch, device, mesh=None, graphed=None):
    from joint_vae_tpu_torch.evals.engines import ood_detection_rates
    from joint_vae_tpu_torch.train.state import make_generator
    return ood_detection_rates(
        job, testset, [ood], batch_size=batch, recording=False,
        from_where=('compute',), update_self_ood=False,
        generator=make_generator(device, MESH_NOISE_SEED), mesh=mesh,
        graphed=graphed)


def _mesh_steps(job, trainset, device, mesh=None, batch=MESH_BATCH,
                captures=None, steps: int = MESH_STEPS):
    """``steps`` steps of the job's model on the first batches of
    ``trainset``; each rank feeds its rows (all of them on the 'model'
    axis).  Graphed by default (``train/graphs.py::graph_mode``: eager
    over gloo on the card); ``captures`` gets the step graph's capture
    records."""
    from joint_vae_tpu_torch.parallel.sharded_data import aligned_global_batch
    from joint_vae_tpu_torch.train.steps import make_train_step
    step = make_train_step(job.model, job.opt_cfg, mesh=mesh)
    out = []
    for i in range(steps):
        x, y = trainset[i * batch:(i + 1) * batch]
        if mesh is None:
            xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            yd = torch.from_numpy(np.ascontiguousarray(y)).to(device)
        else:
            xd, yd = aligned_global_batch(mesh, x, y)
        _, m = step(job.state, xd, yd)
        out.append({k: float(v) for k, v in m.items()})
    if captures is not None:
        captures.extend(step.graph.captures)
    return out


def _im64_mesh_sets():
    """(b)/(c)'s imagenet64 sets: a test set and an OOD set of
    MESH_IM64_SET synthetic 3x64x64 images, from one numpy seed (the same
    in every process)."""
    from joint_vae_tpu_torch.data.loaders import ArrayDataset
    from joint_vae_tpu_torch.models.cvnet import imagenet64_config
    cfg = imagenet64_config()
    rng = np.random.default_rng(29)
    shape = (MESH_IM64_SET,) + cfg.input_shape
    return tuple(ArrayDataset(
        (scale * rng.uniform(0, 1, shape)).astype(np.float32),
        rng.integers(0, cfg.num_labels, MESH_IM64_SET), name, synthetic=True)
        for name, scale in (('im64_mesh_test', 1.0), ('im64_mesh_ood', 0.3)))


def mesh_rank(argv):
    """One rank of phase 12 (b)/(c): ``chip_smoke.py --mesh-rank <spec
    json> <rank>``.  Writes ``<out>/rank-<r>.json``."""
    import torch.distributed as dist
    from joint_vae_tpu_torch.device import set_float32_math
    from joint_vae_tpu_torch.parallel.mesh import (distributed_init,
                                                   ensure_placed, make_mesh)
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.train.graphs import (graph_mode,
                                                  held_score_graphs,
                                                  steps_run)
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
    sets = {'flagship': _mesh_sets(spec.get('size')),
            'imagenet64': _im64_mesh_sets()}
    geometry = {'flagship': spec, 'imagenet64': spec['im64']}
    for run in spec['runs']:
        geo = geometry[run.get('geometry', 'flagship')]
        testset, ood = sets[run.get('geometry', 'flagship')]
        mesh = make_mesh(model_axis=run.get('model_axis', 1),
                         sample_axis=run.get('sample_axis', 1),
                         device=device)
        job = load_job(geo['job_dir'], device=device)
        job.state = ensure_placed(job.state, mesh)
        _count_reset()
        t = time.perf_counter()
        caps = []
        if run.get('steps'):
            with _deterministic():
                got = _mesh_steps(job, testset, device, mesh,
                                  geo['step_batch'], captures=caps,
                                  steps=run['steps'])
        else:
            got = _mesh_ood(job, testset, ood, geo['batch'], device, mesh)
            caps = [c for g in held_score_graphs(job).values()
                    for c in g.captures]
        if device.startswith('cuda'):
            torch.cuda.synchronize()
        out['runs'][run['name']] = {
            'seconds': time.perf_counter() - t, 'launches': _counts(),
            'steps_run': dict(steps_run), 'batches_run': _batches_run(),
            'graphed': graph_mode(None, mesh),
            'captures': [_nccl_nodes(c) for c in caps],
            'result': got, 'coords': mesh.coords}
        del job, caps
        if device.startswith('cuda'):
            torch.cuda.empty_cache()
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
        out['kernels']['imagenet64'] = mesh_im64_kernel_checks(
            spec['world'], spec['im64'])
    with open(os.path.join(spec['out'], 'rank-{}.json'.format(rank)),
              'w') as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _rank_kernel_checks(cfg, batch: int, parts: int, decodes: dict,
                        seed: int) -> dict:
    """Both kernels on this rank against their plain versions at the
    shapes a rank of a model axis of ``parts`` gives them for ``cfg``: the
    combine on a block of C / parts classes (test L, N = ``batch``, K);
    the conv at the decoder's last same-grid site at each batch this rank
    decodes (``decodes``: name -> images)."""
    from joint_vae_tpu_torch.models.cvnet import CVNet
    from joint_vae_tpu_torch.ops.iws import iws_combine, iws_combine_plain
    from joint_vae_tpu_torch.ops.same_grid_conv import (same_grid_conv,
                                                        same_grid_conv_plain)
    g = torch.Generator(device='cuda').manual_seed(seed)
    shape = [cfg.test_latent_sampling, batch, cfg.num_labels // parts,
             cfg.latent_dim]
    args, _ = iws_inputs(*shape, g, mean_scale=17)
    got = iws_combine(*args)
    want = iws_combine_plain(*args)
    iws_err = (got - want).abs().max().item()
    if not torch.all((got - want).abs() <= IWS_ATOL + IWS_RTOL * want.abs()):
        raise AssertionError('iws_combine on a class block: {}'.format(
            iws_err))
    del args, got, want
    model = CVNet(cfg)
    tol = CONV_TOL[torch.float32]
    conv = {}
    for what, n in decodes.items():
        site = same_grid_sites(model, n, 1)[-1]
        x, _, kd = site_inputs(site, torch.float32, g)
        got = same_grid_conv(x, kd, site['lo'], site['lo'])
        want = same_grid_conv_plain(x, kd, site['lo'], site['lo'])
        err = (got - want).abs().max().item()
        if not torch.all((got - want).abs() <= tol * (
                want.abs() + want.square().mean().sqrt())):
            raise AssertionError('same_grid_conv at n={}: {}'.format(n, err))
        conv[what] = {'max_abs_err': err, 'site': site['site'], 'n': n}
        del x, kd, got, want
    torch.cuda.empty_cache()
    return {'iws_combine': {'max_abs_err': iws_err, 'shape': shape},
            'same_grid_conv': conv}


def mesh_kernel_checks(rank: int, parts: int, step_batch: int) -> dict:
    """:func:`_rank_kernel_checks` for the flagship (L=16, N=512, K=128):
    the decodes of all L samples on the 'model' axis, of its block of the
    L+1 samples less the mean one on the 'sample' axis
    (``mesh.py::sample_blocks``), and of the train step's L=1 rows."""
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.parallel.mesh import sample_blocks
    cfg = flagship_config()
    L = cfg.test_latent_sampling
    a, b = sample_blocks(L + 1, parts)[rank]
    return _rank_kernel_checks(cfg, OOD_BATCH, parts, {
        'model': L * OOD_BATCH,
        'sample': (max(b, 1) - max(a, 1)) * OOD_BATCH,
        'steps': cfg.latent_sampling * step_batch}, 11)


def mesh_im64_kernel_checks(parts: int, im64: dict) -> dict:
    """:func:`_rank_kernel_checks` for imagenet64's runs (L=16, N at the
    OOD batch, K=256, C=500 a rank at model 2): its last same-grid site,
    the 5x5 head, at the OOD batch's decode and at the step's."""
    from joint_vae_tpu_torch.models.cvnet import imagenet64_config
    cfg = imagenet64_config()
    return _rank_kernel_checks(cfg, im64['batch'], parts, {
        'ood': cfg.test_latent_sampling * im64['batch'],
        'steps': cfg.latent_sampling * im64['step_batch']}, 12)


def mesh_ranks(backend: str, world: int, job_dir: str, im64_dir: str,
               device: str = 'cuda', size=None, batch: int = OOD_BATCH,
               step_batch: int = MESH_BATCH) -> list:
    """Spawn the ranks of (b)/(c), each under its own time limit; a rank
    that fails or hangs fails the phase.  ``job_dir``: the flagship's job,
    ``im64_dir``: the imagenet64 job of the MESH_IM64_RUNS."""
    out = os.path.join(WORK, 'mesh_{}'.format(backend))
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    spec = {'backend': backend, 'world': world, 'port': _free_port(),
            'device': device, 'job_dir': job_dir, 'out': out, 'size': size,
            'batch': batch, 'step_batch': step_batch,
            'runs': list(MESH_RUNS) + [{'name': 'steps2', 'model_axis': 2,
                                        'steps': MESH_STEPS}]
            + list(MESH_IM64_RUNS),
            'im64': {'job_dir': im64_dir, 'batch': MESH_IM64_BATCH,
                     'step_batch': MESH_IM64_BATCH}}
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


def mesh_check_ranks(ranks, refs: dict, what) -> dict:
    """Each rank's runs against the one-process card runs ``refs`` of their
    geometry (``_mesh_refs``: 'flagship' and 'imagenet64'): OOD AUCs equal
    and means within MESH_MEAN_RTOL, the steps' losses within
    MESH_STEP_RTOL (``_steps_gate``; a ref holds its one-process steps
    twice), the launches of each run (per eager or captured step and
    batch: graphed over NCCL, eager over gloo on the card).  Returns the
    worst readings by geometry."""
    worst = {g: {'mean_rel': 0.0, 'step_rel': 0.0, 'step_rel_all': 0.0,
                 'plain_spread_all': 0.0} for g in refs}
    for r in ranks:
        if not all(r['collectives'].values()):
            raise AssertionError('{} rank {} collectives: {}'.format(
                what, r['rank'], r['collectives']))
        for name, run in r['runs'].items():
            geo = 'imagenet64' if name.startswith('im64_') else 'flagship'
            ref, w = refs[geo], worst[geo]
            tag = '{} rank {} {}'.format(what, r['rank'], name)
            if name.endswith('steps2'):
                g = _steps_gate(run['result'], ref['steps'][0],
                                ref['steps'][1], ref['cfg'], MESH_STEP_RTOL,
                                tag)
                w['step_rel'] = max(w['step_rel'], g['max_rel_err'])
                w['step_rel_all'] = max(w['step_rel_all'],
                                        g['max_rel_err_all'])
                w['plain_spread_all'] = g['plain_spread_all']
                want = ref['want'](_body_steps(ref['n_steps'], tag,
                                               run['steps_run']))
            else:
                got = run['result'][ref['ood_set']]
                for m, e in ref['ood'][ref['ood_set']].items():
                    if got[m]['auc'] != e['auc']:
                        raise AssertionError('{} {}: AUC {} against {}'.format(
                            tag, m, got[m]['auc'], e['auc']))
                    err = abs(got[m]['mean'] - e['mean']) / max(
                        abs(e['mean']), 1e-30)
                    if not err <= MESH_MEAN_RTOL:
                        raise AssertionError('{} {}: mean {} against {}'
                                             .format(tag, m, got[m]['mean'],
                                                     e['mean']))
                    w['mean_rel'] = max(w['mean_rel'], err)
                want = ref['want'](0, _scored(ref['n_batches'], tag,
                                              runs=run['batches_run']))
            if run['launches'] != want:
                raise AssertionError('{}: launches {}, want {}'.format(
                    tag, run['launches'], want))
    return worst


def _mesh_launch_keys(launches: dict, kernel: str) -> dict:
    """The kernels line's phase-12 launch counts of one kernel: the
    world-1 mesh's steps, and per gloo run each rank's."""
    return {'launches_mesh_world1': launches['world1'][kernel],
            'launches_mesh_gloo': {n: [c[kernel] for c in per_rank]
                                   for n, per_rank in launches['gloo'].items()}}


def _mesh_ref(job_dir: str, sets: tuple, batch: int, step_batch: int,
              steps: int, want) -> dict:
    """The one-process card runs of one geometry that (b) and (c) are held
    to: the job's OOD evaluation of ``sets`` (a test and an OOD set) at
    ``batch`` and its ``steps`` steps of ``step_batch`` run twice."""
    from joint_vae_tpu_torch.save_load.jobs import load_job
    testset, ood = sets
    job = load_job(job_dir)
    t = time.perf_counter()
    ref_ood = _mesh_ood(job, testset, ood, batch, 'cuda')
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t
    cfg = job.model_cfg
    del job
    with _deterministic():
        ref_steps = [_mesh_steps(load_job(job_dir), testset, 'cuda',
                                 batch=step_batch, steps=steps)
                     for _ in range(2)]
    torch.cuda.empty_cache()
    return {'job_dir': job_dir, 'cfg': cfg, 'ood': ref_ood,
            'ood_set': ood.name, 'steps': ref_steps, 'seconds': ref_s,
            'n_batches': 2 * -(-len(testset) // batch), 'n_steps': steps,
            'want': want}


def _mesh_refs() -> dict:
    """(b) and (c)'s one-process card runs: phase 4's flagship job on
    cifar100's test set and MESH_OOD (MESH_STEPS steps of MESH_BATCH), and
    a new imagenet64 job (seed 0) on the MESH_IM64_RUNS' sets
    (MESH_IM64_STEPS steps of MESH_IM64_BATCH)."""
    from joint_vae_tpu_torch.models.cvnet import imagenet64_config
    from joint_vae_tpu_torch.save_load.jobs import new_job, save_job
    im64_dir = os.path.join(WORK, 'mesh_im64_job')
    shutil.rmtree(im64_dir, ignore_errors=True)
    save_job(new_job(imagenet64_config(), seed=0), im64_dir)
    return {'flagship': _mesh_ref(_flagship_dir(), _mesh_sets(), OOD_BATCH,
                                  MESH_BATCH, MESH_STEPS, _want),
            'imagenet64': _mesh_ref(im64_dir, _im64_mesh_sets(),
                                    MESH_IM64_BATCH, MESH_IM64_BATCH,
                                    MESH_IM64_STEPS, _im64_want)}


def mesh_nccl(card: str, refs: dict):
    """(c): two ranks over NCCL, one a card, their steps and batches
    graphed, held to ``refs``; the ``mesh_nccl`` line (None and a line
    saying so on a machine with one card)."""
    if torch.cuda.device_count() < 2:
        print('mesh_nccl: the NCCL run over two cards waits for a machine '
              'with two cards (this one has {})'.format(
                  torch.cuda.device_count()), flush=True)
        return None
    t = time.perf_counter()
    nccl = mesh_ranks('nccl', 2, refs['flagship']['job_dir'],
                      refs['imagenet64']['job_dir'])
    line = {'card': card, 'ranks': 2,
            'seconds': round(time.perf_counter() - t, 2),
            **mesh_check_ranks(nccl, refs, 'nccl'),
            'runs': {r['rank']: {n: {k: v[k] for k in (
                'seconds', 'launches', 'steps_run', 'batches_run',
                'graphed', 'captures')} for n, v in r['runs'].items()}
                for r in nccl}}
    for r in nccl:
        for n, v in r['runs'].items():
            if not v['graphed'] or not v['captures'] or any(
                    c['nccl_kernel_nodes'] < 1 for c in v['captures']):
                raise AssertionError('nccl rank {} {}: graphed {}, captures '
                                     '{}'.format(r['rank'], n, v['graphed'],
                                                 v['captures']))
    print('mesh_nccl', json.dumps(line), flush=True)
    return line


def mesh_nccl_phase(card: str) -> None:
    """``--mesh-nccl``: (c) and the one-process runs it is held to."""
    mesh_nccl(card, _mesh_refs())


def mesh_phase(card: str) -> tuple:
    """Phase 12: (a), (b) and (c) of the section's comment."""
    testset, _ = _mesh_sets()
    w1_launches, w1 = mesh_world1(card, testset.subset(
        np.arange(MESH_STEPS * MESH_BATCH)))
    refs = _mesh_refs()

    torch.cuda.empty_cache()
    t = time.perf_counter()
    gloo = mesh_ranks('gloo', 2, refs['flagship']['job_dir'],
                      refs['imagenet64']['job_dir'])
    gloo_s = time.perf_counter() - t
    worst = mesh_check_ranks(gloo, refs, 'gloo')
    line = {'card': card, 'world1': w1,
            'gloo': {'ranks': 2, 'seconds': round(gloo_s, 2),
                     'one_process_ood_s': {g: round(r['seconds'], 3)
                                           for g, r in refs.items()},
                     **worst,
                     'runs': {r['rank']: {n: {'seconds': round(v['seconds'],
                                                               2),
                                              'launches': v['launches'],
                                              'coords': v['coords']}
                                          for n, v in r['runs'].items()}
                              for r in gloo},
                     'kernels': {r['rank']: r['kernels'] for r in gloo},
                     'graphed': [v['graphed'] for r in gloo
                                 for v in r['runs'].values()],
                     'note': 'two processes share one card: correctness '
                             'runs, their times are no speed figure; '
                             'eager: gloo stages its collectives through '
                             'host memory, which a CUDA graph cannot '
                             'capture (NCCL refuses two ranks on one '
                             'card)'}}
    print('mesh_gloo', json.dumps(line['gloo']), flush=True)
    nccl = mesh_nccl(card, refs)
    if nccl is not None:
        line['nccl'] = nccl
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

# ---------------------------------------------------------------------------
# phase 14: the evidence scripts in rehearsal (scripts/torch_*.py: the WIM
# quality run, the WIM study, the Poscod study, the WIM inversion study, the
# reproduction of the reference's sota row in fixture mode and the data
# preparer), each called in process through its ``main`` at a size that
# runs in seconds: 1 pretrain epoch of 1,024 images (4 steps of 256), 256
# images per evaluation set, one fine-tune epoch of 512 images (4 steps of
# 128 + 128); the inversion study in bfloat16 (its own default), the others
# in float32
# ---------------------------------------------------------------------------
EVIDENCE_ARGS = ['--epochs', '1', '--train-size', '1024', '--test-size',
                 '256', '--ft-size', '512', '--ft-epochs', '1']
EVIDENCE_STUDIES = (     # (name, module, dtype, the JAX package's record)
    ('wim_quality', 'torch_wim_quality', 'float32', 'WIM_QUALITY.json'),
    ('wim_study', 'torch_wim_study', 'float32', 'WIM_STUDY.json'),
    ('poscod_quality', 'torch_poscod_quality', 'float32',
     'POSCOD_QUALITY.json'),
    ('wim_inversion', 'torch_wim_inversion_study', 'bfloat16',
     'WIM_INVERSION.json'))
# the conv's batches new to the card in these scripts: each fine-tune half
# and Poscod's head batches (128), pretraining and Poscod's scoring (256)
EVIDENCE_BATCHES = (128, 256)
EVIDENCE_EVAL_BATCH = 512
SOTA_SETS = ('lsunr', 'svhn')
SOTA_METHODS = {'elbo', 'elbo@', 'zdist', 'zdist@', 'kl'}


def evidence_conv_checks() -> list:
    """The conv against its plain version at the evidence scripts' shapes
    that no earlier phase gives it: the plain VAE's eight sites at L=1 and
    n in ``EVIDENCE_BATCHES``, the forward at each site and the dx at the
    seven whose input needs one, float32 and bfloat16, in the conv's form
    and tolerance."""
    from joint_vae_tpu_torch.models.cvnet import CVNet
    from joint_vae_tpu_torch.ops.same_grid_conv import (
        same_grid_conv, same_grid_conv_dx, same_grid_conv_dx_plain,
        same_grid_conv_plain)
    from scripts.torch_evidence import vae_config
    g = torch.Generator(device='cuda').manual_seed(17)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for n in EVIDENCE_BATCHES:
            sites = same_grid_sites(CVNet(vae_config('float32', 8)), n, 1)
            if len(sites) != SITES_PER_BATCH:
                raise AssertionError('{} sites in the plain VAE'.format(
                    len(sites)))
            err = {'forward': 0.0, 'dx': 0.0}
            for j, site in enumerate(sites):
                lo, what = site['lo'], '{} n={} {}'.format(site['site'], n, dt)
                x, _, kd = site_inputs(site, dt, g)
                y = same_grid_conv(x, kd, lo, lo)
                ref = same_grid_conv_plain(x, kd, lo, lo)
                conv_gate(y, ref, 'evidence forward ' + what, dt)
                err['forward'] = max(err['forward'],
                                     (y.float() - ref.float()).abs().max().item())
                if j:                 # features conv_0 reads the data
                    gy = (0.05 * torch.randn(y.shape, generator=g,
                                             device='cuda')).to(dt)
                    dx = same_grid_conv_dx(gy, kd, lo, lo)
                    dref = same_grid_conv_dx_plain(gy, kd, lo, lo)
                    conv_gate(dx, dref, 'evidence dx ' + what, dt)
                    err['dx'] = max(err['dx'], (dx.float() - dref.float())
                                    .abs().max().item())
            rows.append({'dtype': str(dt).split('.')[-1], 'n': n,
                         'sites': len(sites), 'dx_sites': len(sites) - 1,
                         'max_abs_err': err})
            print('evidence_conv', json.dumps(rows[-1]), flush=True)
    return rows


def _evidence_want(rec: dict) -> dict:
    """The WIM quality rehearsal's launches by stage, worked out from the
    code and its record's sizes: pretraining 8 forward and 7 dx per eager
    or captured step of 256 (``_body_steps`` of its ``steps_run``); the
    pre-tuning engines 8 forward per batch of 512 of the test set and of
    each OOD set; the fine-tune 8 forward and 7 dx per half per eager or
    captured step (``_ft_want``) and 16 forward per both-prior batch of its post-tuning
    evaluation of the same sets; no combine anywhere (the plain VAE's
    prior is unconditional, ``models/evaluate.py``)."""
    def batches(n):
        return -(-n // EVIDENCE_EVAL_BATCH)
    evals = batches(rec['test_images']) + sum(
        batches(n) for n in rec['ood_images'].values())
    pt, ft = (_body_steps(rec[k]['steps'], 'wim_quality ' + k,
                          rec[k]['steps_run'])
              for k in ('pretrain', 'finetune'))
    # the engine's and the both-prior batches as scoring graphs: their
    # warm-ups and captures counted
    pre = _scored(evals, 'wim_quality pre_eval', ('score_batch',),
                  rec['pre_eval']['batches_run'])
    both = _scored(evals, 'wim_quality finetune', ('both_prior_batch',),
                   rec['finetune']['batches_run'])
    return {'pretrain': _want(pt), 'pre_eval': _want(0) | {
                'same_grid_conv': SITES_PER_BATCH * pre},
            'finetune': _ft_want(ft, 0, both) | {'iws_combine': 0}}


def evidence(card: str) -> tuple:
    """Phase 14: the six evidence scripts through their ``main``, each
    checked to return 0 and to write a record with the JAX package's
    record's keys (the reproduction: its table's rows and sets, the data
    preparer: its fixtures read back by the port's loaders); the WIM
    quality rehearsal's launches against those worked out from the code;
    the conv at the scripts' new shapes.  Returns (launches, line)."""
    import contextlib
    import csv
    import importlib
    import io
    from scripts.torch_evidence import keys_unlike
    from joint_vae_tpu_torch.data import loaders
    root = os.path.join(WORK, 'evidence')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    conv_rows = evidence_conv_checks()
    seconds, launched, records = {}, {}, {}
    torch.cuda.synchronize()
    _count_reset()
    # --- the main path of phase 14 ---
    for name, module, dtype, _ in EVIDENCE_STUDIES:
        before, t0 = _counts(), time.perf_counter()
        out = os.path.join(root, name + '.json')
        mod = importlib.import_module('scripts.' + module)
        if mod.main(EVIDENCE_ARGS + ['--dtype', dtype, '--out', out]) != 0:
            raise AssertionError('{} did not return 0'.format(module))
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launched[name] = {k: v - before[k] for k, v in _counts().items()}
        with open(out) as f:
            records[name] = json.load(f)['runs'][dtype]
    old_dir, old_env = loaders.DATA_DIR, os.environ.get('JVT_DATA_DIR')
    fx, sota = os.path.join(root, 'fixtures'), os.path.join(root, 'sota')
    try:
        from scripts import torch_prepare_data, torch_reproduce_sota
        for name, fn, argv in (
                ('prepare_data', torch_prepare_data.main,
                 ['make-fixtures', '--data-dir', fx]),
                ('reproduce_sota', torch_reproduce_sota.main,
                 ['--fixtures', fx, '--out', sota]),
                ('prepare_data_verify', torch_prepare_data.main,
                 ['verify', '--data-dir', fx])):
            before, t0 = _counts(), time.perf_counter()
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = fn(argv)
            if rc != 0:
                raise AssertionError('{} returned {}'.format(name, rc))
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            launched[name] = {k: v - before[k] for k, v in _counts().items()}
            records[name] = text.getvalue()
    finally:
        loaders.DATA_DIR = old_dir
        if old_env is None:
            os.environ.pop('JVT_DATA_DIR', None)
        else:
            os.environ['JVT_DATA_DIR'] = old_env
        loaders._cache.clear()
    launches = _counts()
    # --- end of the main path ---
    for name, _, _, reference in EVIDENCE_STUDIES:
        with open(os.path.join(ROOT, 'docs', reference)) as f:
            unlike = keys_unlike(records[name], json.load(f))
        if unlike:
            raise AssertionError('{}: keys unlike docs/{}: {}'.format(
                name, reference, unlike))
    wq = records['wim_quality']
    if wq['pretrain']['steps'] != 1024 // 256 or wq['finetune']['steps'] != 4:
        raise AssertionError('wim_quality steps: {} {}'.format(
            wq['pretrain']['steps'], wq['finetune']['steps']))
    want = _evidence_want(wq)
    got = {k: wq[k]['launches'] for k in want}
    if got != want:
        raise AssertionError('wim_quality launches {}, want {}'.format(
            got, want))
    with open(os.path.join(sota, 'sota_native.csv')) as f:
        rows = list(csv.reader(f))
    if [r[0] for r in rows] != ['set', 'method', 'measures',
                                'vae (published)', 'vae (this run)'] or \
            rows[0][1:] != [s for s in SOTA_SETS for _ in range(6)]:
        raise AssertionError('sota_native.csv rows: {}'.format(rows))
    with open(os.path.join(sota, 'sota_native.json')) as f:
        post = json.load(f)['post']
    if {s: set(ms) for s, ms in post.items()} != {
            s: SOTA_METHODS for s in SOTA_SETS}:
        raise AssertionError('sota_native.json post: {}'.format(post))
    verified = dict(line.split(None, 1) for line in
                    records['prepare_data_verify'].splitlines())
    fallback = sorted(n for n, v in verified.items() if not
                      v.startswith('real'))
    if fallback != ['imagenet12', 'imagenet1k', 'imagenet20']:
        raise AssertionError('fixtures not read back as real: {}'.format(
            fallback))
    line = {'card': card, 'seconds': seconds, 'launches': launched,
            'total_launches': launches,
            'wim_quality_launches': got,
            'wim_quality_auroc': {'pre': wq['pre_best'],
                                  'post': wq['post_best']},
            'sota_this_run': rows[4], 'conv_at_new_shapes': conv_rows}
    print('evidence', json.dumps(line), flush=True)
    return launches, line


# ---------------------------------------------------------------------------
# phase 15: the JAX package's one-program steps as CUDA graphs
# (``joint_vae_tpu_torch/train/graphs.py``): the graphed train step and the
# graphed fine-tune step held bit for bit to their eager steps from one
# state, then graphed against eager timings in one process
# ---------------------------------------------------------------------------
GRAPH_STEPS = 3                  # steps held bit for bit, graph vs eager
GRAPH_FT_BATCH = 128             # the timed fine-tune step: 128 + 128
GRAPH_EPOCH_BATCH = BENCH_BATCHES['pipeline']    # phase 7's fused epoch


def _run_tensors(job) -> dict:
    """Every tensor a step moves: parameters and buffers, the optimizer's
    moments, the sigma state, the generator's state."""
    o = job.state.opt_state
    out = {'p/' + k: v for k, v in job.model.state_dict().items()}
    for kind in ('mu', 'nu', 'trace'):
        out.update({kind + '/' + k: v for k, v in getattr(o, kind).items()})
    out['sigma'] = job.state.sigma_state.data
    out['rmse'] = job.state.sigma_state.rmse
    out['generator'] = job.state.generator.get_state()
    return out


def _bit_gate(runs: dict, what: str) -> dict:
    """Graph against eager: every metric and every tensor of
    :func:`_run_tensors` equal bit for bit, the host counts equal."""
    e, g = runs[False], runs[True]
    diff = [k for k in e['tensors'] if not torch.equal(e['tensors'][k],
                                                       g['tensors'][k])]
    if not torch.equal(e['metrics'], g['metrics']):
        diff.append('metrics')
    if e['counts'] != g['counts']:
        diff.append('counts {} {}'.format(e['counts'], g['counts']))
    if diff:
        raise AssertionError('{}: graph and eager differ at {}'.format(
            what, diff[:12]))
    return {'tensors_equal': len(e['tensors']),
            'metrics_equal': int(e['metrics'].numel()),
            'counts': list(e['counts'])}


def graph_train_bits(dtype: str, cfg=None, batch: int = TRAIN_BATCH,
                     want=_want, mesh=None, steps: int = GRAPH_STEPS) -> dict:
    """The flagship's (or ``cfg``'s) graphed train step against its eager
    step from one state (``new_job`` seed 4 twice), ``steps`` host-fed
    steps of ``batch``: the first eager (the warm-up), the second captured
    and replayed, the later ones replayed; launches ``want`` per step
    either way (the flagship's 8 forward and 7 dx).  ``mesh``: the state
    placed there and the mesh step (a mesh of one rank: the batch is this
    rank's rows)."""
    from joint_vae_tpu_torch.device import to_device
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.parallel.mesh import ensure_placed
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.graphs import steps_run
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.steps import make_train_step
    cfg = cfg or flagship_config(compute_dtype=dtype)
    rng = np.random.default_rng(21)
    xs = rng.uniform(0, 1, (steps, batch) + cfg.input_shape
                     ).astype(np.float32)
    ys = rng.integers(0, cfg.num_labels, (steps, batch))
    dev = torch.device('cuda')
    runs = {}
    # under the port's defaults: the 'conv' route's backward runs cuDNN's
    # deterministic algorithms itself (models/conv.py::DeterministicConvFn)
    for graphed in (False, True):
        job = new_job(cfg, OptimizerConfig(lr=TRAIN_LR), seed=4)
        if mesh is not None:
            job.state = ensure_placed(job.state, mesh)
        step = make_train_step(job.model, job.opt_cfg, mesh=mesh,
                               graphed=graphed)
        _count_reset()
        st, ms = job.state, []
        with _all_reduces_seen() as seen:
            for i in range(steps):
                st, m = step(st, to_device(xs[i], dev),
                             to_device(ys[i], dev))
                ms.append(m.vector)
        torch.cuda.synchronize()
        o = st.opt_state
        runs[graphed] = {
            'metrics': torch.stack(ms).cpu(), 'launches': _counts(),
            'steps_run': dict(steps_run), 'all_reduce': seen,
            'tensors': {k: v.detach().cpu()
                        for k, v in _run_tensors(job).items()},
            'counts': (o.count, o.adam_count, st.step),
            'captures': step.graph.captures}
        del job, step, st
    if torch.backends.cudnn.deterministic:
        raise AssertionError('cuDNN\'s deterministic switch was left on')
    what = '{}train step {}'.format('mesh ' if mesh is not None else '',
                                    dtype)
    out = _bit_gate(runs, what)
    out.update({'dtype': dtype, 'batch': batch, 'steps': steps,
                'cudnn_deterministic': False})
    out.update(_graph_launch_gate(runs, want, what + 's', steps))
    if mesh is not None:
        out['all_reduce'] = _all_reduce_gate(runs, steps, what)
    return out


@contextlib.contextmanager
def _all_reduces_seen():
    """{'eager': n, 'captured': n}: the all-reduces issued inside, by
    whether their stream was capturing (a replay issues none: its graph
    holds them)."""
    import torch.distributed as dist
    real, seen = dist.all_reduce, {'eager': 0, 'captured': 0}

    def counting(*a, **k):
        seen['captured' if torch.cuda.is_current_stream_capturing()
             else 'eager'] += 1
        return real(*a, **k)
    dist.all_reduce = counting
    try:
        yield seen
    finally:
        dist.all_reduce = real


def _all_reduce_gate(runs: dict, steps: int, what: str) -> dict:
    """A one-rank mesh step issues one all-reduce (``reduce_over_data``):
    eager, one a step; graphed, one in the warm-up and one inside the
    capture, none in a replay."""
    want = {False: {'eager': steps, 'captured': 0},
            True: {'eager': 1, 'captured': 1}}
    for graphed, r in runs.items():
        if r['all_reduce'] != want[graphed]:
            raise AssertionError('{} (graphed {}): all-reduces {}, want {}'
                                 .format(what, graphed, r['all_reduce'],
                                         want[graphed]))
    return {('graph' if g else 'eager'): r['all_reduce']
            for g, r in runs.items()}


def _graph_launch_gate(runs: dict, want, what: str,
                       steps: int = GRAPH_STEPS) -> dict:
    """The launches of ``steps`` steps, eager and graphed: the wrappers
    count every eager step's (``want(steps)``) and, graphed, the warm-up's
    and the capture's; the one capture's graph holds as many same-grid
    kernel nodes, by function name, as the capture launched (a step's
    forward and dx launches, which run the same kernels)."""
    per_step = want(1)
    for graphed, r in runs.items():
        body = _body_steps(steps, what, r['steps_run'])
        if body != (2 if graphed else steps) or r['launches'] != want(
                body):
            raise AssertionError('{} (graphed {}): {} launched, steps run '
                                 '{}'.format(what, graphed, r['launches'],
                                             r['steps_run']))
    caps = runs[True]['captures']
    nodes = {'same_grid_conv': per_step['same_grid_conv']
             + per_step['same_grid_conv_dx'],
             'iws_combine': per_step['iws_combine']}
    if len(caps) != 1 or caps[0]['kernel_nodes_by_source'] != nodes:
        raise AssertionError('{}: captures {}, want one holding {} kernel '
                             'nodes'.format(what, caps, nodes))
    return {'launches': {'eager': runs[False]['launches'],
                         'graphed': runs[True]['launches']},
            'steps_run': {'eager': runs[False]['steps_run'],
                          'graphed': runs[True]['steps_run']},
            'capture': caps[0]}


def _flagship_dir() -> str:
    """Phase 6's flagship job, or a fresh one saved there when phase 15
    runs alone."""
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job, save_job
    job_dir = os.path.join(WORK, 'flagship_job')
    if not os.path.exists(os.path.join(job_dir, 'params.json')):
        save_job(new_job(flagship_config(), seed=0), job_dir)
    return job_dir


def _wim_pair(job_dir: str, graphed: bool, mesh=None):
    """A WIM job on phase 9's alternate prior, a fresh optimizer state and
    the loop's generator, and its fine-tune step (on ``mesh``, the state
    placed there)."""
    from joint_vae_tpu_torch.ft.job import load_wim_job
    from joint_vae_tpu_torch.parallel.mesh import ensure_placed
    from joint_vae_tpu_torch.train.optimizers import build_optimizer
    from joint_vae_tpu_torch.train.state import make_generator, named_params
    wim = load_wim_job(job_dir, seed=7, **WIM_PRIOR)
    job = wim.job
    if mesh is not None:
        job.state = ensure_placed(job.state, mesh)
    tx = build_optimizer(job.opt_cfg)
    job.state.opt_state = tx.init(named_params(job.model))
    job.state.generator = make_generator(job.device, 3)
    step = wim.make_finetune_step(WIM_ALPHA, tx=tx,
                                  train_L=job.model_cfg.latent_sampling,
                                  mesh=mesh, graphed=graphed)
    return job, step


def graph_ft_bits(job_dir: str, mesh=None, batch: int = WIM_BATCH) -> dict:
    """Phase 9's fine-tune step (``batch`` + ``batch``, host-fed; 64 + 64
    by default) graphed against eager from one state, GRAPH_STEPS steps;
    16 forward and 14 dx launches per step either way.  ``mesh``: the
    mesh step (a mesh of one rank)."""
    from joint_vae_tpu_torch.device import to_device
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.train.graphs import steps_run
    cfg = flagship_config()
    rng = np.random.default_rng(23)
    xs = rng.uniform(0, 1, (GRAPH_STEPS, 2, batch) + cfg.input_shape
                     ).astype(np.float32)
    ys = rng.integers(0, cfg.num_labels, (GRAPH_STEPS, batch))
    dev = torch.device('cuda')
    runs = {}
    for graphed in (False, True):
        job, step = _wim_pair(job_dir, graphed, mesh)
        _count_reset()
        st, ms = job.state, []
        with _all_reduces_seen() as seen:
            for i in range(GRAPH_STEPS):
                st, m = step(st, to_device(xs[i, 0], dev),
                             to_device(ys[i], dev), to_device(xs[i, 1], dev))
                ms.append(m.vector)
        torch.cuda.synchronize()
        o = st.opt_state
        runs[graphed] = {
            'metrics': torch.stack(ms).cpu(), 'launches': _counts(),
            'steps_run': dict(steps_run), 'all_reduce': seen,
            'tensors': {k: v.detach().cpu()
                        for k, v in _run_tensors(job).items()},
            'counts': (o.count, o.adam_count, st.step),
            'captures': step.graph.captures}
        del job, step, st
    what = ('mesh ' if mesh is not None else '') + 'fine-tune step'
    out = _bit_gate(runs, what)
    out.update({'batch_in': batch, 'batch_mix': batch,
                'steps': GRAPH_STEPS})
    out.update(_graph_launch_gate(runs, lambda n: _ft_want(n, 0, 0),
                                  what + 's'))
    if mesh is not None:
        out['all_reduce'] = _all_reduce_gate(runs, GRAPH_STEPS, what)
    return out


def _turns(steps: dict, run, n: int) -> dict:
    """ms per step of ``run(mode)`` (n steps, synchronised) for the modes
    of ``steps``, in turns eager, graph, graph, eager."""
    got = {m: [] for m in steps}
    for mode in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(mode, n)
        torch.cuda.synchronize()
        got[mode].append((time.perf_counter() - t0) * 1e3 / n)
    return {('graph' if m else 'eager'): float(np.mean(v))
            for m, v in got.items()}


def _timed_case(name: str, steps: dict, states: dict, feed, batch: int,
                images_per_step: int, records: dict) -> dict:
    """Warm-up, timing in turns and one profiled step of each mode, with
    the graph's capture record.  The profiled step's kernel records of the
    port's kernels, counted on the card by function name, must be
    ``records`` in either mode: a replay runs every launch its capture
    made."""
    i = [0]

    def run(mode, n):
        for _ in range(n):
            states[mode], _ = steps[mode](states[mode], *feed(i[0]))
            i[0] += 1
    run(False, TRAIN_WARMUP)
    run(True, TRAIN_WARMUP)
    ms = _turns(steps, run, TRAIN_TIMED)
    prof = {}
    for mode in (False, True):
        args = feed(i[0])
        i[0] += 1
        p = profile_train_step(lambda st, _a, _b: steps[mode](st, *args),
                               states[mode], None, None)
        prof['graph' if mode else 'eager'] = {
            k: p[k] for k in ('wall_ms', 'device_ms', 'device_busy_share',
                              'by_name_ms', 'kernel_records', 'host_self_ms')}
        if p['kernel_records'] != records:
            raise AssertionError('{} (graphed {}): kernel records {} in a '
                                 'step, want {}'.format(name, mode,
                                                        p['kernel_records'],
                                                        records))
    caps = steps[True].graph.captures
    return {'case': name, 'batch': batch, 'ms_per_step': ms,
            'images_per_s': {m: images_per_step * 1e3 / v
                             for m, v in ms.items()},
            'profile': prof, 'capture': caps[0] if caps else None}


def _records(want: dict) -> dict:
    """A step's launches by wrapper -> its kernel records by CUDA source."""
    return {'same_grid_conv': want['same_grid_conv']
            + want['same_grid_conv_dx'], 'iws_combine': want['iws_combine']}


def graph_timings(job_dir: str) -> dict:
    """Graphed against eager in one process: the bf16 device-fed step at
    1024 on a 50,000-image uint8 set, the float32 host-fed step at 1024,
    one bf16 fused epoch at 512 over the same set (the epoch's wall time,
    a 4-batch epoch profiled), the fine-tune step at 128 + 128."""
    from torch.profiler import ProfilerActivity, profile
    from joint_vae_tpu_torch.data.loaders import ArrayDataset
    from joint_vae_tpu_torch.device import to_device
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.device_data import (
        DeviceDataset, epoch_permutation, make_device_train_step,
        train_epochs_on_device)
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.steps import make_train_step
    cfg16 = flagship_config(compute_dtype='bfloat16')
    cfg32 = flagship_config()
    rng = np.random.default_rng(9)
    trainset = ArrayDataset(
        rng.integers(0, 256, (BENCH_SET,) + cfg16.input_shape, dtype=np.uint8),
        rng.integers(0, cfg16.num_labels, BENCH_SET).astype(np.int32),
        'synthetic')
    dev = torch.device('cuda')
    cases = []

    # bf16 device-fed step at 1024
    dd = DeviceDataset(trainset)
    perm = epoch_permutation(dd.n, 1, 0, dev)
    jobs = {m: new_job(cfg16, OptimizerConfig(lr=TRAIN_LR), seed=0)
            for m in (False, True)}
    steps = {m: make_device_train_step(jobs[m].model, jobs[m].opt_cfg,
                                       TRAIN_BATCH, graphed=m)
             for m in (False, True)}
    n_batches = dd.n // TRAIN_BATCH
    cases.append(_timed_case(
        'bf16_device_fed', steps, {m: jobs[m].state for m in jobs},
        lambda i: (dd.x, dd.y, i % n_batches, None, perm), TRAIN_BATCH,
        TRAIN_BATCH, _records(_want(1))))
    del jobs, steps

    # float32 host-fed step at 1024
    hx = rng.uniform(0, 1, (4, TRAIN_BATCH) + cfg32.input_shape
                     ).astype(np.float32)
    hy = rng.integers(0, cfg32.num_labels, (4, TRAIN_BATCH))
    jobs = {m: new_job(cfg32, OptimizerConfig(lr=TRAIN_LR), seed=0)
            for m in (False, True)}
    steps = {m: make_train_step(jobs[m].model, jobs[m].opt_cfg, graphed=m)
             for m in (False, True)}
    cases.append(_timed_case(
        'f32_host_fed', steps, {m: jobs[m].state for m in jobs},
        lambda i: (to_device(hx[i % 4], dev), to_device(hy[i % 4], dev)),
        TRAIN_BATCH, TRAIN_BATCH, _records(_want(1))))
    del jobs, steps

    # one bf16 fused epoch at 512 over the 50,000 images
    epoch_s = {False: [], True: []}
    jobs = {m: new_job(cfg16, OptimizerConfig(lr=TRAIN_LR), seed=0)
            for m in (False, True)}
    for mode in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = train_epochs_on_device(jobs[mode], trainset, 1,
                                      GRAPH_EPOCH_BATCH, fused=True,
                                      graphed=mode)
        torch.cuda.synchronize()
        epoch_s[mode].append(time.perf_counter() - t0)
        if not np.isfinite(last['total']):
            raise AssertionError('fused epoch total {}'.format(last))
    small = ArrayDataset(trainset.data[:4 * GRAPH_EPOCH_BATCH],
                         trainset.targets[:4 * GRAPH_EPOCH_BATCH], 'small')
    eprof = {}
    for mode in (False, True):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_epochs_on_device(jobs[mode], small, 1, GRAPH_EPOCH_BATCH,
                                   fused=True, graphed=mode)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev_ms = sum(getattr(ev, 'self_device_time_total',
                             getattr(ev, 'self_cuda_time_total', 0))
                     for ev in prof.key_averages() if _device_record(ev)
                     ) / 1e3
        ops = {ev.key: ev.count for ev in prof.key_averages()}
        eprof['graph' if mode else 'eager'] = {
            'steps': 4, 'wall_ms': wall, 'device_ms': dev_ms,
            'device_busy_share': dev_ms / wall,
            'index_select': ops.get('aten::index_select', 0),
            'graph_launches': ops.get('cudaGraphLaunch', 0)}
    steps_per_epoch = BENCH_SET // GRAPH_EPOCH_BATCH
    cases.append({
        'case': 'bf16_fused_epoch', 'batch': GRAPH_EPOCH_BATCH,
        'steps': steps_per_epoch,
        'epoch_s': {('graph' if m else 'eager'): float(np.mean(v))
                    for m, v in epoch_s.items()},
        'images_per_s': {('graph' if m else 'eager'):
                         steps_per_epoch * GRAPH_EPOCH_BATCH / float(np.mean(v))
                         for m, v in epoch_s.items()},
        'profile_4_batches': eprof})
    del jobs, dd
    torch.cuda.empty_cache()

    # the fine-tune step at 128 + 128
    fx = rng.uniform(0, 1, (4, 2, GRAPH_FT_BATCH) + cfg32.input_shape
                     ).astype(np.float32)
    fy = rng.integers(0, cfg32.num_labels, (4, GRAPH_FT_BATCH))
    pairs = {m: _wim_pair(job_dir, m) for m in (False, True)}
    steps = {m: p[1] for m, p in pairs.items()}
    cases.append(_timed_case(
        'finetune', steps, {m: p[0].state for m, p in pairs.items()},
        lambda i: (to_device(fx[i % 4, 0], dev), to_device(fy[i % 4], dev),
                   to_device(fx[i % 4, 1], dev)),
        GRAPH_FT_BATCH, 2 * GRAPH_FT_BATCH, _records(_ft_want(1, 0, 0))))
    del pairs, steps
    torch.cuda.empty_cache()
    return cases


def _graph_launch_keys(launches: dict, records: dict, kernel: str,
                       source: str) -> dict:
    """The kernels line's ``launches_graphs``: the wrapper's launches in
    each graphed bit-gate run (the warm-up's and the capture's), and the
    kernel records of ``source`` in each timed case's profiled replay
    (the forward's and dx's together: they run the same kernels)."""
    return {'wrapper': {k: c[kernel] for k, c in launches.items()},
            'replay_records_per_step': {k: r[source]
                                        for k, r in records.items()}}


def graphs_phase(card: str) -> tuple:
    """Phase 15: the bit gates, then the timings; returns the graphed
    runs' launches and the ``graphs`` line."""
    t0 = time.perf_counter()
    job_dir = _flagship_dir()
    bits = {'train_float32': graph_train_bits('float32'),
            'train_bfloat16': graph_train_bits('bfloat16'),
            'finetune': graph_ft_bits(job_dir)}
    timings = graph_timings(job_dir)
    line = {'bits': bits, 'timings': timings,
            'seconds': time.perf_counter() - t0, 'card': card}
    print('graphs', json.dumps(line), flush=True)
    launches = {k: v['launches']['graphed'] for k, v in bits.items()}
    records = {c['case']: c['profile']['graph']['kernel_records']
               for c in timings if 'profile' in c}
    return launches, records, line


# phase 16: the scoring programs as CUDA graphs.  The Scorer's bit gates
# run at the serve batch, at the reference's eval point and on the OOD
# evaluation's ragged tail; each Scorer graph runs SCORE_CALLS batches per
# noise source (its warm-up, its capture and a replay)
SCORE_CASES = ((BATCH, None), (BATCH_EVAL, L_EVAL), (OOD_SET_SIZE % OOD_BATCH,
                                                    None))
SCORE_CALLS = 3
SCORE_SMALL = 64                 # the small timed Scorer batch, at L=16
PROFILED = 10                    # a profiled engine call's batches a set
SCORE_PER_BATCH = {'same_grid_conv': SITES_PER_BATCH, 'iws_combine': 1}
BOTH_PER_BATCH = {'same_grid_conv': 2 * SITES_PER_BATCH, 'iws_combine': 1}


def _capture_gate(captures: list, per_batch: dict, what: str) -> dict:
    """Each capture's graph holds, by function name, ``per_batch`` kernel
    nodes of the port's kernels: one scored batch's launches."""
    bad = [c['kernel_nodes_by_source'] for c in captures
           if c['kernel_nodes_by_source'] != per_batch]
    if not captures or bad:
        raise AssertionError('{}: {} captures, kernel nodes {}, want {} each'
                             .format(what, len(captures), bad, per_batch))
    return {'captures': len(captures),
            'kernel_nodes': [c['kernel_nodes'] for c in captures],
            'capture_s': [c['capture_s'] for c in captures],
            'pool_bytes': [c['pool_bytes'] for c in captures]}


def _scored_gate(run: dict, batches: int, per_batch: dict, what: str):
    """The wrappers' launches of ``batches`` scored batches: per_batch for
    each eager or captured one (``_scored`` of the run's record)."""
    n = _scored(batches, what, runs=run['runs'])
    want = {k: per_batch.get(k, 0) * n for k in run['launches']}
    if run['launches'] != want:
        raise AssertionError('{}: launched {}, want {} ({} batches run '
                             'eager or captured)'.format(
                                 what, run['launches'], want, n))


def _host_equal(a, b) -> list:
    """The keys of two nests of host arrays whose bytes differ."""
    if isinstance(a, dict):
        return [k + ('/' + d if d else '') for k in a
                for d in (_host_equal(a[k], b[k]) if k in b else ['missing'])]
    a, b = np.asarray(a), np.asarray(b)
    same = (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())
    return [] if same else ['']


def scorer_bits(dtype: str) -> list:
    """(a) The flagship Scorer graphed against eager from one job, in each
    of SCORE_CASES: SCORE_CALLS batches with a caller's generator, then
    SCORE_CALLS with the default noise (seed 0 every call: the registered
    generator reseeded); every output and the generator's state after
    them bit for bit; launches per eager or captured batch; each capture's
    kernel nodes."""
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.serve import Scorer
    cfg = flagship_config(compute_dtype=dtype)
    job = new_job(cfg, seed=0)
    rng = np.random.default_rng(31)
    calib = Scorer(job, methods=METHODS, graphed=False,
                   thresholds={m: float('-inf') for m in METHODS})(
        rng.uniform(0, 1, (BATCH,) + cfg.input_shape).astype(np.float32))
    # gates that split the batch, so that in_distribution carries bits
    thresholds = {m: float(np.median(v)) for m, v in calib['scores'].items()}
    rows = []
    for n, L in SCORE_CASES:
        xs = rng.uniform(0, 1, (SCORE_CALLS, n) + cfg.input_shape
                         ).astype(np.float32)
        got = {}
        for graphed in (False, True):
            scorer = Scorer(job, methods=METHODS, thresholds=thresholds, L=L,
                            graphed=graphed)
            gen = torch.Generator(device='cuda').manual_seed(5)
            _count_reset()
            outs = ([scorer(x, generator=gen) for x in xs]
                    + [scorer(x) for x in xs])
            torch.cuda.synchronize()
            got[graphed] = {'outs': outs, 'gen': gen.get_state(),
                            'launches': _counts(), 'runs': _batches_run(),
                            'captures': list(scorer.graph.captures)}
            del scorer
        what = 'Scorer {} n={} L={}'.format(dtype, n, L or
                                             cfg.test_latent_sampling)
        diff = [str(i) + '/' + k for i, (e, g) in enumerate(zip(
            got[False]['outs'], got[True]['outs'])) for k in _host_equal(e, g)]
        if not torch.equal(got[False]['gen'], got[True]['gen']):
            diff.append('generator state')
        if diff:
            raise AssertionError('{}: graph and eager differ at {}'.format(
                what, diff[:12]))
        for graphed, r in got.items():
            _scored_gate(r, 2 * SCORE_CALLS, SCORE_PER_BATCH,
                         '{} (graphed {})'.format(what, graphed))
        row = {'dtype': dtype, 'batch': n,
               'L': L or cfg.test_latent_sampling,
               'batches_equal': 2 * SCORE_CALLS,
               'runs': got[True]['runs']['scorer'],
               'launches': {'eager': got[False]['launches'],
                            'graphed': got[True]['launches']}}
        row.update(_capture_gate(got[True]['captures'], SCORE_PER_BATCH,
                                 what))
        if row['captures'] != 2:            # the caller's generator, then
            raise AssertionError('{}: {} captures'.format(   # the default
                what, row['captures']))
        rows.append(row)
    return rows


def _keep_engine_graphs(engines, graphs: list):
    """``engines.held_graph`` keeping each graph it hands out in
    ``graphs`` (once); returns the original, to restore."""
    real = engines.held_graph

    def keep(*a, **k):
        g, gen = real(*a, **k)
        if all(g is not h for h in graphs):
            graphs.append(g)
        return g, gen
    engines.held_graph = keep
    return real


def _ood_sets():
    from joint_vae_tpu_torch.data.loaders import get_dataset
    _, testset = get_dataset('cifar100', splits=['test'])
    return testset, [get_dataset(n, splits=['test'])[1] for n in OOD_SETS]


def ood_bits(job_dir: str) -> dict:
    """(b) ``ood_detection_rates`` in phase 6's setup (its job, cifar100's
    test set and the three OOD sets, batch 512, L=16, the compute tier
    with record files), graphed against eager from one generator: every
    score, ROC entry and record file's bytes, and the generator's state,
    equal; launches per eager or captured batch; each capture's kernel
    nodes."""
    from joint_vae_tpu_torch.evals import engines
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.train.state import make_generator
    job = load_job(job_dir)
    testset, oodsets = _ood_sets()
    batches = -(-OOD_SET_SIZE // OOD_BATCH) * (1 + len(oodsets))
    got = {}
    for graphed in (False, True):
        rdir = os.path.join(WORK, 'score_graphs_ood_{}'.format(int(graphed)))
        shutil.rmtree(rdir, ignore_errors=True)
        os.makedirs(rdir)
        scores = {}
        collect = engines._collect_scores

        def keep(job_, dataset, *a, **k):
            out = collect(job_, dataset, *a, **k)
            scores[dataset.name] = {m: v.cpu().numpy() for m, v in out.items()}
            return out
        engines._collect_scores = keep
        try:
            gen = make_generator(job.device, 0)
            _count_reset()
            res = engines.ood_detection_rates(
                job, testset, oodsets, batch_size=OOD_BATCH,
                from_where=('compute',), update_self_ood=False,
                recording=True, record_dir=rdir, generator=gen,
                graphed=graphed)
            torch.cuda.synchronize()
            launches, runs = _counts(), _batches_run()
        finally:
            engines._collect_scores = collect
        files = {}
        for f in sorted(os.listdir(rdir)):
            with open(os.path.join(rdir, f), 'rb') as fh:
                files[f] = fh.read()
        got[graphed] = {'res': res, 'scores': scores, 'files': files,
                        'gen': gen.get_state(), 'launches': launches,
                        'runs': runs,
                        'captures': [c for g in engines.held_score_graphs(
                            job).values() for c in g.captures]}
    e, g = got[False], got[True]
    diff = ['scores/' + k for k in _host_equal(e['scores'], g['scores'])]
    if json.dumps(e['res'], sort_keys=True) != json.dumps(g['res'],
                                                          sort_keys=True):
        diff.append('results')
    if e['files'] != g['files'] or not e['files']:
        diff.append('record files {} {}'.format(sorted(e['files']),
                                                 sorted(g['files'])))
    if not torch.equal(e['gen'], g['gen']):
        diff.append('generator state')
    if diff:
        raise AssertionError('OOD evaluation: graph and eager differ at {}'
                             .format(diff[:12]))
    for graphed, r in got.items():
        _scored_gate(r, batches, SCORE_PER_BATCH,
                     'OOD evaluation (graphed {})'.format(graphed))
    out = {'sets': 1 + len(oodsets), 'batches': batches,
           'scores_equal': sum(len(v) for v in e['scores'].values()),
           'roc_entries_equal': sum(len(v) for v in e['res'].values()),
           'record_files_equal': sorted(e['files']),
           'runs': g['runs'],
           'launches': {'eager': e['launches'], 'graphed': g['launches']}}
    out.update(_capture_gate(g['captures'], SCORE_PER_BATCH,
                             'OOD evaluation'))
    return out


def _wim(job_dir: str):
    from joint_vae_tpu_torch.ft.job import load_wim_job
    return load_wim_job(job_dir, seed=7, **WIM_PRIOR)


def both_prior_bits(job_dir: str) -> dict:
    """(c) ``ft/job.py::_both_prior_losses`` on phase 9's WIM job (its
    alternate prior on the flagship) over cifar10's test set at phase 9's
    test batch (40 batches, a ragged tail), graphed against eager from one
    generator: every array and the generator's state equal; 16 conv and 1
    combine launches per eager or captured batch (the original prior's
    combine: the alternate one is unconditional); each capture's kernel
    nodes."""
    from joint_vae_tpu_torch.data.loaders import get_dataset
    from joint_vae_tpu_torch.ft import job as ft_job
    from joint_vae_tpu_torch.train.state import make_generator
    wim = _wim(job_dir)
    _, ds = get_dataset('cifar10', splits=['test'])
    batches = -(-len(ds) // WIM_TEST_BATCH)
    got = {}
    for graphed in (False, True):
        graph = ft_job.both_prior_graph(wim, graphed=graphed)
        gen = make_generator(wim.job.device, 10000)
        _count_reset()
        arrays = ft_job._both_prior_losses(wim, ds, WIM_TEST_BATCH, gen,
                                           graph=graph)
        torch.cuda.synchronize()
        got[graphed] = {'arrays': arrays, 'gen': gen.get_state(),
                        'launches': _counts(), 'runs': _batches_run(),
                        'captures': list(graph.captures)}
        del graph
    e, g = got[False], got[True]
    diff = _host_equal(e['arrays'], g['arrays'])
    if not torch.equal(e['gen'], g['gen']):
        diff.append('generator state')
    if diff:
        raise AssertionError('both-prior losses: graph and eager differ at '
                             '{}'.format(diff[:12]))
    for graphed, r in got.items():
        _scored_gate(r, batches, BOTH_PER_BATCH,
                     'both-prior losses (graphed {})'.format(graphed))
    out = {'set': ds.name, 'batch': WIM_TEST_BATCH, 'batches': batches,
           'arrays_equal': len(e['arrays']), 'runs': g['runs'],
           'launches': {'eager': e['launches'], 'graphed': g['launches']}}
    out.update(_capture_gate(g['captures'], BOTH_PER_BATCH,
                             'both-prior losses'))
    return out


def _profile_once(run) -> dict:
    """One call of ``run`` under torch.profiler: wall and device ms, the
    busy share and the port's kernel records by source (no dropped
    call before it: a long call's first records, if lost, are few)."""
    from torch.profiler import ProfilerActivity, profile
    from joint_vae_tpu_torch.ops.cuda_lib import KERNEL_FUNCTIONS, source_of
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, records = 0.0, dict.fromkeys(KERNEL_FUNCTIONS, 0)
    for ev in prof.key_averages():
        if not _device_record(ev):
            continue
        busy += getattr(ev, 'self_device_time_total',
                        getattr(ev, 'self_cuda_time_total', 0)) / 1e3
        if source_of(ev.key):
            records[source_of(ev.key)] += ev.count
    return {'wall_ms': wall_ms, 'device_ms': busy,
            'device_busy_share': busy / wall_ms, 'kernel_records': records}


def _score_case(name: str, run, per: int, records, make_graphs,
                profile_run=None) -> dict:
    """``run(mode)`` (one batch of a held Scorer, ``per`` calls a turn, or
    one whole call) in each mode: its first calls timed (``first_ms``: a
    Scorer's SCORE_CALLS calls, its warm-up and capture among them; one
    engine call, whose held graphs it captures), then in turns eager,
    graph, graph, eager (``ms``: per call); one call of each mode (of
    ``profile_run``, by default ``run``) profiled, after a traced call
    that is dropped where ``records`` is given (its kernel records by
    source, which must be ``records`` in either mode); the graph mode's
    captures (``make_graphs()``)."""
    profile_run = profile_run or run
    first = {}
    for mode in (False, True):
        n = SCORE_CALLS if per > 1 else 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            run(mode)
        torch.cuda.synchronize()
        first['graph' if mode else 'eager'] = (time.perf_counter() - t0) * 1e3
    ms = _turns({False: None, True: None}, lambda m, n: [
        run(m) for _ in range(n)], per)
    prof = {}
    for mode in (False, True):
        if records is not None:
            p = profile_train_step(lambda _s, _a, _b: profile_run(mode),
                                   None, None, None)
            if p['kernel_records'] != records:
                raise AssertionError('{} (graphed {}): kernel records {}, '
                                     'want {}'.format(name, mode,
                                                      p['kernel_records'],
                                                      records))
        else:
            p = _profile_once(lambda: profile_run(mode))
        prof['graph' if mode else 'eager'] = {
            k: p[k] for k in ('wall_ms', 'device_ms', 'device_busy_share',
                              'kernel_records')}
    caps = make_graphs()
    return {'case': name, 'first_ms': first, 'ms': ms, 'profile': prof,
            'capture_s': [c['capture_s'] for c in caps],
            'pool_bytes': [c['pool_bytes'] for c in caps],
            'kernel_nodes': [c['kernel_nodes'] for c in caps]}


def score_timings(job_dir: str) -> list:
    """Graphed against eager in one process: the Scorer at 512 and at 64
    (L=16; ms per batch), the OOD evaluation (phase 6's four sets, on one
    job whose engine graphs are held across calls; ms per call; profiled
    over PROFILED batches of the test set and of one OOD set),
    ``cli.test --compute rehard``
    (phase 8's recompute, its engines graphed or not; each call loads the
    job and captures anew) and the both-prior batches of one set (phase
    9's WIM job, cifar10 at 256, one graph and one generator held across
    calls as the fine-tune flow holds them across sets; ms per set;
    profiled over its first PROFILED batches)."""
    import functools
    from joint_vae_tpu_torch.cli import test as test_cli
    from joint_vae_tpu_torch.data.loaders import ArrayDataset, get_dataset
    from joint_vae_tpu_torch.evals import engines
    from joint_vae_tpu_torch.ft import job as ft_job
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.serve import Scorer
    from joint_vae_tpu_torch.train.state import make_generator
    job = load_job(job_dir)
    cfg = job.model_cfg
    rng = np.random.default_rng(33)
    free = {m: float('-inf') for m in METHODS}
    cases = []
    for n in (BATCH, SCORE_SMALL):
        x = rng.uniform(0, 1, (n,) + cfg.input_shape).astype(np.float32)
        scorers = {m: Scorer(job, methods=METHODS, thresholds=free,
                             graphed=m) for m in (False, True)}
        cases.append(_score_case(
            'scorer_{}'.format(n), lambda m: scorers[m](x), TRAIN_TIMED,
            SCORE_PER_BATCH, lambda: scorers[True].graph.captures))
        del scorers

    testset, oodsets = _ood_sets()

    def ood(mode, test=testset, sets=oodsets):
        engines.ood_detection_rates(
            job, test, sets, batch_size=OOD_BATCH,
            from_where=('compute',), update_self_ood=False,
            recording=False, graphed=mode)
    # profiled over the first PROFILED batches of the test set and of one
    # OOD set (replays of the held full-batch graph): late in the whole
    # script a profiled call of some 16,000 kernel records lost a few
    n = PROFILED * OOD_BATCH
    ood_part = [ArrayDataset(d.data[:n], d.targets[:n], d.name)
                for d in (testset, oodsets[0])]
    c = _score_case('ood_evaluation', ood, 1,
                    {k: v * 2 * PROFILED for k, v in SCORE_PER_BATCH.items()},
                    lambda: [cap for g in engines.held_score_graphs(
                        job).values() for cap in g.captures],
                    lambda mode: ood(mode, ood_part[0], ood_part[1:]))
    c['profile_batches'] = 2 * PROFILED
    cases.append(c)

    graphs = []
    real = _keep_engine_graphs(engines, graphs)
    try:
        root = _score_store()
        argv = ['--job-dir', root, '--job', '0', '--compute', 'rehard',
                '--sets'] + list(TEST_CLI_SETS) + ['-M', str(OOD_BATCH)]
        names = ('accuracy', 'ood_detection_rates',
                 'misclassification_detection_rates')
        engine = {n: getattr(test_cli, n) for n in names}

        def rehard(mode):
            graphs.clear()
            for n in names:
                setattr(test_cli, n, functools.partial(engine[n],
                                                       graphed=mode))
            try:
                with open(os.path.join(WORK, 'score_graphs_rehard.out'),
                          'w') as f, contextlib.redirect_stdout(f):
                    if test_cli.main(argv) != 0:
                        raise AssertionError('cli.test --compute rehard '
                                             'failed (graphed {})'.format(mode))
            finally:
                for n in names:
                    setattr(test_cli, n, engine[n])
        cases.append(_score_case('cli_test_rehard', rehard, 1, None, lambda: [
            cap for g in graphs for cap in g.captures]))
    finally:
        engines.held_graph = real

    wim = _wim(job_dir)
    _, ds = get_dataset('cifar10', splits=['test'])
    both = {m: (ft_job.both_prior_graph(wim, graphed=m),
                make_generator(wim.job.device, 0)) for m in (False, True)}

    def both_prior(mode, data=ds):
        graph, gen = both[mode]
        ft_job._both_prior_losses(wim, data, WIM_TEST_BATCH,
                                  gen.manual_seed(10000), graph=graph)
    # profiled over the set's first PROFILED batches, as the OOD
    # evaluation
    n = PROFILED * WIM_TEST_BATCH
    both_part = ArrayDataset(ds.data[:n], ds.targets[:n], ds.name)
    c = _score_case(
        'both_prior', both_prior, 1,
        {k: v * PROFILED for k, v in BOTH_PER_BATCH.items()},
        lambda: both[True][0].captures,
        lambda mode: both_prior(mode, both_part))
    c['profile_batches'] = PROFILED
    cases.append(c)
    return cases


def _score_store() -> str:
    """Phase 8's fleet, or, when phase 16 runs alone, a store holding the
    flagship's job alone (the test set cifar100's)."""
    from joint_vae_tpu_torch.save_load.checkpoint import load_json, save_json
    root = os.path.join(WORK, 'fleet')
    if os.path.isdir(root):
        return root
    root = os.path.join(WORK, 'score_graphs_store')
    shutil.rmtree(root, ignore_errors=True)
    d = os.path.join(root, 'cifar100', 'flagship', '000000')
    shutil.copytree(_flagship_dir(), d,
                    ignore=shutil.ignore_patterns('samples'))
    path = os.path.join(d, 'train_params.json')
    tp = load_json(path)
    tp['set'] = 'cifar100'
    save_json(tp, path)
    return root


def score_graphs_phase(card: str) -> tuple:
    """Phase 16: the bit gates, then the timings; returns the graphed
    bit-gate runs' launches, the profiled replays' kernel records and the
    ``score_graphs`` line."""
    t0 = time.perf_counter()
    job_dir = _flagship_dir()
    bits = {'scorer_float32': scorer_bits('float32'),
            'scorer_bfloat16': scorer_bits('bfloat16'),
            'ood_evaluation': ood_bits(job_dir),
            'both_prior': both_prior_bits(job_dir)}
    timings = score_timings(job_dir)
    line = {'bits': bits, 'timings': timings,
            'seconds': time.perf_counter() - t0, 'card': card}
    print('score_graphs', json.dumps(line), flush=True)
    launches = {'scorer_{}_{}_L{}'.format(dt, r['batch'], r['L']):
                r['launches']['graphed']
                for dt in ('float32', 'bfloat16')
                for r in bits['scorer_' + dt]}
    launches['ood_evaluation'] = bits['ood_evaluation']['launches']['graphed']
    launches['both_prior'] = bits['both_prior']['launches']['graphed']
    records = {c['case']: c['profile']['graph']['kernel_records']
               for c in timings}
    return launches, records, line


def _score_launch_keys(launches: dict, records: dict, kernel: str,
                       source: str) -> dict:
    """The kernels line's ``launches_score_graphs``: the wrapper's
    launches in each graphed bit-gate run (the warm-ups and captures), and
    the kernel records of ``source`` in each timed case's profiled
    graphed call."""
    return {'wrapper': {k: c.get(kernel, 0) for k, c in launches.items()},
            'profiled_records': {k: r[source] for k, r in records.items()}}


# phase 17: the JAX package's second geometry, imagenet64 (models/cvnet.py::
# imagenet64_config, the values of __graft_entry__.py:41-58; bench.py's
# batch 512 at :57): vgg16's 13 convs, the four k=4, s=2 sub-pixel deconvs
# and the 5x5 head on the same-grid kernel, 18 launches a forward; conv_0
# reads the data, so a train step takes 17 dx; C=1000, K=256, test L=16
IM64_SITES, IM64_DX = 18, 17
IM64_BATCH = 512
IM64_SERVE_BATCHES = 4
IM64_TRAIN_BATCHES = 6          # one short epoch; validation and test of 512
IM64_EVAL = 512
IM64_DEVICE_SET = 10000         # uint8 3x64x64 on the card, 123 MB: 19 steps
IM64_OOD_SIZE = 2048
IM64_OOD_SETS = ('im64_ood_dark', 'im64_ood_noise')
IM64_PER_BATCH = {'same_grid_conv': IM64_SITES, 'iws_combine': 1}


def _im64_want(steps: int, batches: int = 0) -> dict:
    return _want(steps, batches, IM64_SITES, IM64_DX)


def _im64_totals(rows: list, keys=('ms', 'plain_ms', 'library_ms',
                                   'bound_ms')) -> dict:
    """Per dtype, the sum over the sites of each of ``keys``, the largest
    error, and the bound's share of the kernel's time."""
    out = {}
    for r in rows:
        t = out.setdefault(r['dtype'], dict.fromkeys(keys, 0.0))
        for k in keys:
            t[k] += r[k]
        t['max_abs_err'] = max(t.get('max_abs_err', 0.0), r['max_abs_err'])
        t['sites'] = t.get('sites', 0) + 1
    for t in out.values():
        t['share_of_bound'] = t['bound_ms'] / t['ms']
    return out


def im64_kernels() -> dict:
    """(a) The same-grid conv at imagenet64's 18 sites against its plain
    version, each row with the kernel its shape dispatches, its ms,
    cuDNN's ms and the bound: a serve batch (512 images, L=16: the
    decoder at 8,192) in float32 and bfloat16 (``im64_conv`` lines), the
    train step's forward and dx at batch 512 in both dtypes with the
    im2col dw against float64 and cuDNN's wgrad beside it
    (``im64_train_conv``, ``im64_dx`` lines, ``_bf16`` for bfloat16)."""
    from joint_vae_tpu_torch.models.cvnet import CVNet, imagenet64_config
    from joint_vae_tpu_torch.ops.same_grid_conv import batch_chunks
    cfg = imagenet64_config()
    model = CVNet(cfg)
    sites = same_grid_sites(model, IM64_BATCH, cfg.test_latent_sampling)
    if len(sites) != IM64_SITES:
        raise AssertionError('{} imagenet64 same-grid sites'.format(len(sites)))
    # each site's launches at the serve batch (``batch_chunks``: one unless
    # x or y passes the kernel's int32 shapes) and the largest launch
    widest = max(s['n'] * site_elems(s) for s in sites)
    chunks = {s['site']: len(batch_chunks(s['n'], site_elems(s)))
              for s in sites}
    serve_rows, _ = check_conv(sites, 'im64_conv')
    train_sites = same_grid_sites(model, IM64_BATCH, cfg.latent_sampling)
    fwd, dx, t32 = check_train_conv(train_sites, torch.float32, 'im64_',
                                    IM64_DX)
    fwd16, dx16, t16 = check_train_conv(train_sites, torch.bfloat16, 'im64_',
                                        IM64_DX)
    dw_keys = ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'dw_ms',
               'dw_cudnn_ms')
    out = {'sites': len(sites), 'launch_chunks': chunks,
           'widest_launch_elements': widest,
           'serve': _im64_totals(serve_rows),
           'train_forward': _im64_totals(fwd + fwd16),
           'train_dx': _im64_totals(dx + dx16, dw_keys),
           'dw_max_rel_err': {'float32': t32['dw_max_rel_err'],
                              'bfloat16': t16['dw_max_rel_err']},
           'dw_cudnn_max_rel_err': {'float32': t32['dw_cudnn_max_rel_err'],
                                    'bfloat16': t16['dw_cudnn_max_rel_err']},
           'kernels': {r['site']: r['kernel'] for r in serve_rows}}
    print('im64_kernels', json.dumps(out), flush=True)
    return out


def im64_serve(card: str) -> tuple:
    """(b) The imagenet64 job saved and loaded, then scored through its
    Scorer graph on IM64_SERVE_BATCHES batches of 512 at L=16 after the
    graph's warm-up and capture, in float32 and in bfloat16: 18 conv and 1
    combine launches per eager or captured batch, the capture's graph
    holding 18 same-grid and 1 combine kernel nodes by function name,
    finite outputs, images/s and ms per batch, one batch profiled by
    kernel; in float32 the card against the CPU on 8 inputs with
    injected noise (phase 4's tolerance); the bfloat16 scores' rms-relative
    distance to the float32 ones on the same weights and noise
    (reported).  Returns the launches by dtype and the summary."""
    from joint_vae_tpu_torch.models.cvnet import imagenet64_config
    from joint_vae_tpu_torch.save_load.jobs import load_job, new_job, save_job
    from joint_vae_tpu_torch.serve import Scorer
    rng = np.random.default_rng(17)
    shape = imagenet64_config().input_shape
    xs = rng.uniform(0, 1, (IM64_SERVE_BATCHES + 1, IM64_BATCH) + shape
                     ).astype(np.float32)
    eps = torch.from_numpy(rng.standard_normal(
        (imagenet64_config().test_latent_sampling + 1, IM64_BATCH,
         imagenet64_config().latent_dim)).astype(np.float32))
    eps[0] = 0.0
    launches, rows, same_noise = {}, {}, {}
    for dtype in ('float32', 'bfloat16'):
        cfg = imagenet64_config(dtype)
        job_dir = os.path.join(WORK, 'im64_job_' + dtype)
        shutil.rmtree(job_dir, ignore_errors=True)
        save_job(new_job(cfg, seed=0), job_dir)      # on the card
        job = load_job(job_dir)
        calib = Scorer(job, methods=METHODS, graphed=False,
                       thresholds={m: float('-inf') for m in METHODS})(xs[0])
        thresholds = serve_thresholds(calib['scores'])
        scorer = Scorer(job, methods=METHODS, thresholds=thresholds)
        what = 'imagenet64 Scorer ' + dtype
        _count_reset()
        # --- the main path: the Scorer's graph, warm-up, capture, batches ---
        t0 = time.perf_counter()
        scorer(xs[0])
        scorer(xs[0])
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        outs, batch_ms = [], []
        for b in range(IM64_SERVE_BATCHES):
            t0 = time.perf_counter()
            outs.append(scorer(xs[1 + b]))
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        launches[dtype] = _counts()
        # --- end of the main path ---
        n = _scored(2 + IM64_SERVE_BATCHES, what, ('scorer',))
        if launches[dtype] != _im64_want(0, n):
            raise AssertionError('{}: launched {}, want {}'.format(
                what, launches[dtype], _im64_want(0, n)))
        _check_bf16_counts(launches[dtype], dtype == 'bfloat16', what)
        capture = _capture_gate(scorer.graph.captures, IM64_PER_BATCH, what)
        for o in outs:
            for m in METHODS:
                if (o['scores'][m].shape != (IM64_BATCH,)
                        or not np.all(np.isfinite(o['scores'][m]))):
                    raise AssertionError('{}: bad scores for {}'.format(what, m))
            if not (np.all(np.isfinite(o['confidence']))
                    and o['label'].shape == (IM64_BATCH,)
                    and np.all((o['label'] >= 0)
                               & (o['label'] < cfg.num_labels))):
                raise AssertionError(what + ': bad labels or confidence')
        profile = profile_batch(scorer, xs[1])
        del scorer
        same_noise[dtype] = Scorer(job, methods=METHODS, thresholds=thresholds,
                                   graphed=False)(xs[1], eps=eps)['scores']
        rows[dtype] = {
            'params': sum(p.numel() for p in job.model.parameters()),
            'batch': IM64_BATCH, 'L': cfg.test_latent_sampling,
            'C': cfg.num_labels, 'K': cfg.latent_dim,
            'batches': IM64_SERVE_BATCHES, 'batch_ms': batch_ms,
            'warmup_and_capture_ms': first_ms,
            'images_per_s': IM64_BATCH * IM64_SERVE_BATCHES
            / (sum(batch_ms) / 1e3),
            'launches': launches[dtype], 'batches_counted': n,
            'capture': capture, 'profile': profile,
            'accept_rate': float(np.mean([o['in_distribution'].mean()
                                          for o in outs]))}
        if dtype == 'float32':
            rows[dtype]['card_vs_cpu'] = serve_card_vs_cpu(
                job, job_dir, thresholds, xs[1, :8])
        del job
        torch.cuda.empty_cache()
        print('im64_serve', json.dumps({dtype: rows[dtype]}), flush=True)
    rows['bf16_vs_f32_scores_rel_rms'] = {
        m: rel_rms(same_noise['bfloat16'][m], same_noise['float32'][m])
        for m in METHODS}
    return launches, rows


def im64_train(card: str) -> tuple:
    """(c) Training in both dtypes at batch 512: phase 5's ``train`` on the
    imagenet64 config (``new_job`` with bench.py's Adam, ``train_model``
    for one epoch of IM64_TRAIN_BATCHES batches with a validation split
    and a test set of 512, graphed; ``save_job`` / ``load_job`` exact; 18
    forward and 17 dx launches per eager or captured step, 18 per eval
    batch, no combine; 10 timed steps after 3 warm-up ones; one step
    profiled; in float32 the card against the CPU at batch 8), then the
    graphed step bit for bit against its eager step over 3 steps (phase
    15's gate), its capture holding 35 same-grid kernel nodes."""
    from joint_vae_tpu_torch.models.cvnet import imagenet64_config
    launches, rows = {}, {}
    for dtype in ('float32', 'bfloat16'):
        cfg = imagenet64_config(dtype)
        launches[dtype], summary, job = train(
            card, cfg, IM64_SITES, IM64_DX, 'im64_train_' + dtype,
            batch=IM64_BATCH, batches=IM64_TRAIN_BATCHES,
            eval_size=IM64_EVAL, gate=dtype == 'float32')
        del job
        torch.cuda.empty_cache()
        bits = graph_train_bits(dtype, cfg, IM64_BATCH, _im64_want)
        print('im64_graph_bits', json.dumps(bits), flush=True)
        torch.cuda.empty_cache()
        rows[dtype] = {k: summary[k] for k in (
            'batch', 'epoch_batches', 'epoch_seconds', 'epoch_images_per_s',
            'ms_per_step', 'train_images_per_s', 'loader_ms_per_batch',
            'to_device_ms_per_batch', 'ms_per_step_batches_on_card',
            'launches', 'timed_launches', 'card_vs_cpu')}
        rows[dtype]['profile'] = {k: summary['profile'][k] for k in (
            'wall_ms', 'device_ms', 'device_busy_share', 'by_span_ms',
            'by_name_ms', 'kernel_records')}
        rows[dtype]['graph_bits'] = {k: bits[k] for k in (
            'tensors_equal', 'metrics_equal', 'launches', 'capture')}
    return launches, rows


def im64_device_fed(card: str) -> tuple:
    """(d) The bench's pipeline mode in bfloat16: a synthetic uint8 set of
    IM64_DEVICE_SET 3x64x64 images held on the card, one fused
    ``train_epochs_on_device`` epoch at 512 (19 steps, 18 forward and 17
    dx launches per eager or captured step, all of the bfloat16 build),
    then 10 timed device-fed steps after 3 warm-up ones and one
    profiled."""
    from joint_vae_tpu_torch.data.loaders import ArrayDataset
    from joint_vae_tpu_torch.models.cvnet import imagenet64_config
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.device_data import (DeviceDataset,
                                                       train_epochs_on_device)
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    cfg16 = imagenet64_config('bfloat16')
    rng = np.random.default_rng(19)
    trainset = ArrayDataset(
        rng.integers(0, 256, (IM64_DEVICE_SET,) + cfg16.input_shape,
                     dtype=np.uint8),
        rng.integers(0, cfg16.num_labels, IM64_DEVICE_SET).astype(np.int32),
        'synthetic')
    job = new_job(cfg16, OptimizerConfig(lr=TRAIN_LR), seed=0)
    steps = IM64_DEVICE_SET // IM64_BATCH
    _count_reset()
    # --- the main path: one fused bfloat16 epoch fed from the card ---
    t0 = time.perf_counter()
    total = train_epochs_on_device(job, trainset, 1, IM64_BATCH,
                                   fused=True)['total']
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = _counts()
    # --- end of the main path ---
    want = _im64_want(_body_steps(steps, 'imagenet64 device-fed epoch'))
    if launches != want:
        raise AssertionError('imagenet64 device-fed epoch launched {}, want '
                             '{}'.format(launches, want))
    _check_bf16_counts(launches, True, 'imagenet64 device-fed epoch')
    if job.state.step != steps or not np.isfinite(total):
        raise AssertionError('imagenet64 device-fed epoch: {} steps, total '
                             '{}'.format(job.state.step, total))
    dd = DeviceDataset(trainset)
    if dd.x.dtype != torch.uint8:
        raise AssertionError('the uint8 set is held as {}'.format(dd.x.dtype))
    timed = time_device_steps(job, dd, IM64_BATCH, _im64_want)
    row = {'batch': IM64_BATCH, 'steps': steps, 'launches': launches,
           'epoch_seconds': epoch_s,
           'epoch_images_per_s': steps * IM64_BATCH / epoch_s,
           'epoch_total_loss': total, 'dataset_mb': dd.x.numel() / 1e6,
           'ms_per_step': timed['ms_per_step'],
           'images_per_s': timed['images_per_s'],
           'timed_launches': timed['launches'],
           'profile': {k: timed['profile'][k] for k in (
               'wall_ms', 'device_ms', 'device_busy_share', 'by_span_ms',
               'by_name_ms', 'kernel_records')}}
    del job, dd
    torch.cuda.empty_cache()
    print('im64_device_fed', json.dumps(row), flush=True)
    return launches, row


def im64_ood(card: str) -> tuple:
    """(e) Per-class OOD evaluation at C=1000 through the engines: the
    float32 serving job, an in-distribution test set and two OOD sets of
    IM64_OOD_SIZE synthetic 64x64 images (in memory), batch 512, L=16:
    ``ood_detection_rates`` on the compute tier (18 conv and 1 combine
    launches per eager or captured batch), its record files holding the
    (1000, N) per-class losses; the json tier and then the recorders
    tier alone (the records read back) with no launch and the same
    results; the compute tier's images/s and ms per set, the ROC's ms per
    (set, method) on the card."""
    from joint_vae_tpu_torch.data.loaders import ArrayDataset
    from joint_vae_tpu_torch.evals import engines
    from joint_vae_tpu_torch.ops.roc import roc_curve, two_sided_from_method
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.save_load.recorders import LossRecorder, find_record
    job_dir = os.path.join(WORK, 'im64_job_float32')
    shutil.rmtree(os.path.join(job_dir, 'samples'), ignore_errors=True)
    job = load_job(job_dir)
    cfg = job.model_cfg
    rng = np.random.default_rng(23)
    shape = (IM64_OOD_SIZE,) + cfg.input_shape

    def synthetic(name, scale):
        return ArrayDataset(
            (scale * rng.uniform(0, 1, shape)).astype(np.float32),
            rng.integers(0, cfg.num_labels, IM64_OOD_SIZE), name,
            synthetic=True)
    testset = synthetic('im64_test', 1.0)
    oodsets = [synthetic(IM64_OOD_SETS[0], 0.3), synthetic(IM64_OOD_SETS[1], 1.0)]
    sets = [testset] + oodsets
    batches = -(-IM64_OOD_SIZE // IM64_BATCH)
    set_ms = {}
    collect = engines._collect_scores

    def timed_collect(job_, dataset, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = collect(job_, dataset, *a, **k)
        torch.cuda.synchronize()
        set_ms[dataset.name] = (time.perf_counter() - t0) * 1e3
        return out
    engines._collect_scores = timed_collect
    try:
        _count_reset()
        # --- the main path: the compute tier, then the cheap tiers ---
        t0 = time.perf_counter()
        res = engines.ood_detection_rates(job, testset, oodsets,
                                          batch_size=IM64_BATCH)
        torch.cuda.synchronize()
        ood_s = time.perf_counter() - t0
        launches = _counts()
        runs = _batches_run()
        again = engines.ood_detection_rates(job, testset, oodsets,
                                            batch_size=IM64_BATCH,
                                            from_where=('json', 'recorders'))
        job.ood_results.clear()
        t0 = time.perf_counter()
        replay = engines.ood_detection_rates(job, testset, oodsets,
                                             batch_size=IM64_BATCH,
                                             from_where=('recorders',))
        replay_s = time.perf_counter() - t0
        reuse = {k: v - launches[k] for k, v in _counts().items()}
        # --- end of the main path ---
    finally:
        engines._collect_scores = collect
    n = _scored(batches * len(sets), 'imagenet64 OOD evaluation', runs=runs)
    if launches != _im64_want(0, n):
        raise AssertionError('imagenet64 OOD launches {}, want {} ({} sets of '
                             '{} batches)'.format(launches, _im64_want(0, n),
                                                  len(sets), batches))
    if any(reuse.values()):
        raise AssertionError('the json and recorders tiers launched {}'.format(
            reuse))
    if again != res or set(res) != set(IM64_OOD_SETS):
        raise AssertionError('the json tier changed the results')
    for s_name, ms in res.items():
        for m, r in ms.items():
            vals = [r['auc'], r['mean'], r['std']] + r['fpr'] + r['precision']
            if r['n'] != IM64_OOD_SIZE or not np.all(np.isfinite(vals)):
                raise AssertionError('bad imagenet64 ood entry {} {}'.format(
                    s_name, m))
            got = replay[s_name][m]
            if abs(got['auc'] - r['auc']) > ROC_TOL:
                raise AssertionError('the recorders tier: {} {} auc {} vs '
                                     '{}'.format(s_name, m, got['auc'],
                                                 r['auc']))
    sdir = os.path.join(job_dir, 'samples', '0000')
    per_class = {}
    for s in sets:
        rec = LossRecorder.load(find_record(sdir, s.name))
        shapes = {k: list(rec.get(k).shape) for k in rec.keys()}
        if shapes.get('iws') != [cfg.num_labels, IM64_OOD_SIZE]:
            raise AssertionError('{}: record shapes {}'.format(s.name, shapes))
        per_class[s.name] = shapes
    scores = {s.name: engines._scores_from_recorder(
        job, LossRecorder.load(find_record(sdir, s.name)), cfg.ood_methods)
        for s in sets}
    roc_ms = {}
    for s_name in IM64_OOD_SETS:
        for m in cfg.ood_methods:
            ins, outs = scores[testset.name][m], scores[s_name][m]
            geo = two_sided_from_method(m)
            roc_ms['{}/{}'.format(s_name, m)] = time_ms(
                lambda: roc_curve(ins, outs, two_sided=geo), 5)
    n_images = IM64_OOD_SIZE * len(sets)
    row = {'sets': [s.name for s in sets], 'set_size': IM64_OOD_SIZE,
           'batch': IM64_BATCH, 'L': cfg.test_latent_sampling,
           'C': cfg.num_labels, 'methods': cfg.ood_methods,
           'ood_seconds': ood_s, 'compute_ms_per_set': set_ms,
           'ood_images_per_s': n_images / (sum(set_ms.values()) / 1e3),
           'ood_images_per_s_with_roc': n_images / ood_s,
           'recorders_tier_seconds': replay_s,
           'roc_ms': roc_ms, 'roc_ms_total': sum(roc_ms.values()),
           'launches': launches, 'reuse_launches': reuse,
           'batches_run': runs, 'record_shapes': per_class,
           'auc': {s: {m: res[s][m]['auc'] for m in ('iws', 'elbo')}
                   for s in res}}
    del job
    torch.cuda.empty_cache()
    print('im64_ood', json.dumps(row), flush=True)
    return launches, row


def _im64_launch_keys(launches: dict, kernel: str) -> dict:
    """Phase 17's launches of ``kernel``, by main path (and dtype)."""
    return {'serve_' + dt: c[kernel] for dt, c in launches['serve'].items()} | {
        'train_' + dt: c[kernel] for dt, c in launches['train'].items()} | {
        'device_fed_bf16': launches['device_fed_bf16'][kernel],
        'ood': launches['ood'][kernel]}


def imagenet64_phase(card: str) -> tuple:
    """Phase 17: the JAX package's second geometry at full width (the
    module docstring); returns the launches of each main path and the
    ``imagenet64`` line."""
    from joint_vae_tpu_torch.models.cvnet import CVNet, imagenet64_config
    torch.cuda.empty_cache()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out
    kernels = timed('kernels', im64_kernels)
    serve_launches, serve_rows = timed('serve', im64_serve, card)
    train_launches, train_rows = timed('train', im64_train, card)
    fed_launches, fed = timed('device_fed', im64_device_fed, card)
    ood_launches, ood = timed('ood', im64_ood, card)
    line = {'config': 'imagenet64',
            'params': sum(p.numel() for p in CVNet(imagenet64_config())
                          .parameters()),
            'kernels': kernels, 'serve': serve_rows, 'train': train_rows,
            'device_fed_bf16': fed, 'ood': ood, 'seconds': seconds,
            'card': card}
    print('imagenet64', json.dumps(line), flush=True)
    launches = {'serve': serve_launches, 'train': train_launches,
                'device_fed_bf16': fed_launches, 'ood': ood_launches}
    return launches, line


# ---------------------------------------------------------------------------
# phase 18: the JAX package's last jitted programs as CUDA graphs (the
# trainer's per-epoch losses, ``cli.aggregate``'s scores, Poscod's means,
# head step and scores, the sampling driver's batch, ``record_latents``),
# each held bit for bit to its eager self from one job, then graphed
# against eager timings in one process
# ---------------------------------------------------------------------------
JIT_EPOCH_STEPS = 3              # train steps between two epochs' losses
JIT_EVAL_SET = 2 * TRAIN_TEST_BATCH + 276     # two full batches, a tail
JIT_POSCOD_SET = 512             # Poscod's ind and moving sets, at WIM_BATCH
JIT_SAMPLE_N = 64                # cli.sample's -N default


class _Generators:
    """The generator each scoring graph was last called with, by graph
    name (the held generators' state after a run: ``state()``), kept
    while it is installed."""

    def __enter__(self):
        from joint_vae_tpu_torch.train import graphs
        self.cls, self.real, self.last = (graphs.ScoreGraph,
                                          graphs.ScoreGraph.__call__, {})
        real, last = self.real, self.last

        def call(graph, generator, **kw):
            last[graph.name] = generator
            return real(graph, generator, **kw)
        self.cls.__call__ = call
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.real

    def state(self) -> dict:
        return {n: g.get_state() for n, g in self.last.items()
                if g is not None}


def _second_job_dir() -> str:
    """Phase 9's first WIM job, or a flagship job of another seed when
    phase 18 runs alone."""
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job, save_job
    wims = _job_dirs(os.path.join(WORK, 'ft_jobs', 'wim'))
    if wims:
        return wims[0]
    job_dir = os.path.join(WORK, 'jit_graphs_second_job')
    if not os.path.exists(os.path.join(job_dir, 'params.json')):
        save_job(new_job(flagship_config(), seed=1), job_dir)
    return job_dir


def _cut(ds, n: int):
    """The first ``n`` images of ``ds``."""
    from joint_vae_tpu_torch.data.loaders import ArrayDataset
    return ArrayDataset(ds.data[:n], ds.targets[:n], ds.name)


def _jit_run(program: str, graphed: bool, dirs: tuple, dtype: str) -> dict:
    """Program ``program`` once, on fresh loads of the jobs in ``dirs``
    (the flagship's in ``dtype``): its host outputs, every tensor it
    moves, the generators' states after it, the wrappers' launches,
    the scoring batches and steps run, the captures."""
    from joint_vae_tpu_torch.cli import aggregate as agg_cli
    from joint_vae_tpu_torch.device import to_device
    from joint_vae_tpu_torch.evals import sample
    from joint_vae_tpu_torch.ft import job as ft_job
    from joint_vae_tpu_torch.ft import poscod
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import load_job, new_job
    from joint_vae_tpu_torch.train import trainer
    from joint_vae_tpu_torch.train.graphs import held_score_graphs, steps_run
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.state import fold_in, make_generator
    from joint_vae_tpu_torch.train.steps import make_train_step
    testset, oodsets = _ood_sets()
    jobs, caps, out, tensors = [], [], {}, {}
    _count_reset()
    with _Generators() as gens:
        if program == 'mean_losses':
            job = new_job(flagship_config(compute_dtype=dtype),
                          OptimizerConfig(lr=TRAIN_LR), seed=4)
            jobs.append(job)
            dev = job.device
            step = make_train_step(job.model, job.opt_cfg, graphed=graphed)
            rng = np.random.default_rng(41)
            ds = _cut(testset, JIT_EVAL_SET)
            for epoch in range(2):
                job.state.epoch = epoch
                for _ in range(JIT_EPOCH_STEPS):
                    x = rng.uniform(0, 1, (TRAIN_BATCH,) + job.model_cfg
                                    .input_shape).astype(np.float32)
                    y = rng.integers(0, job.model_cfg.num_labels, TRAIN_BATCH)
                    job.state, _ = step(job.state, to_device(x, dev),
                                        to_device(y, dev))
                out[epoch] = trainer._mean_losses(
                    job, ds, TRAIN_TEST_BATCH, epoch, graphed=graphed)
            caps += step.graph.captures
            tensors = _run_tensors(job)
        elif program == 'aggregate':
            for d in dirs:
                job = load_job(d)
                jobs.append(job)
                # the test set's pass and an OOD pass, as the CLI seeds them
                for seed, ds in ((0, testset), (fold_in(0, 9), oodsets[0])):
                    out['{}/{}'.format(len(jobs), ds.name)] = \
                        agg_cli._scores(job, ds, OOD_BATCH, seed,
                                        graphed=graphed)
        elif program == 'poscod':
            job = load_job(dirs[0])
            jobs.append(job)
            steps = []

            class Step(poscod._HeadStep):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    steps.append(self)
            real, poscod._HeadStep = poscod._HeadStep, Step
            try:
                pc = poscod.PoscodJob(job=job, graphed=graphed).finetune(
                    _cut(testset, JIT_POSCOD_SET),
                    _cut(oodsets[0], JIT_POSCOD_SET), epochs=1,
                    batch_size=WIM_BATCH, seed=0)
            finally:
                poscod._HeadStep = real
            o = steps[0].opt_state
            tensors = {'head/' + k: v for k, v in pc.head.items()}
            tensors.update({'mu/' + k: v for k, v in o.mu.items()})
            tensors.update({'nu/' + k: v for k, v in o.nu.items()})
            out['counts'] = (o.count, o.adam_count)
            for ds in (testset, oodsets[0]):
                out['llr/' + ds.name] = pc.llr_scores(ds, WIM_TEST_BATCH)
            caps += steps[0].graph.captures
        elif program == 'sample':
            job = load_job(dirs[0])
            jobs.append(job)
            out = sample.select_correct_incorrect(job, testset, JIT_SAMPLE_N,
                                                  graphed=graphed)
        else:
            wim = _wim(dirs[0])
            jobs.append(wim.job)
            gen = make_generator(wim.job.device, 5)
            d = os.path.join(WORK, 'jit_latents_{}'.format(int(graphed)))
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            ft_job.record_latents(wim, [testset, oodsets[0]], WIM_TEST_BATCH,
                                  gen, d, graphed=graphed)
            for f in sorted(os.listdir(d)):
                with open(os.path.join(d, f), 'rb') as fh:
                    out[f] = fh.read()
            tensors = {'generator': gen.get_state()}
        torch.cuda.synchronize()
        states = gens.state()
    caps += [c for j in jobs for g in held_score_graphs(j).values()
             for c in g.captures]
    return {'out': out, 'tensors': {k: v.detach().cpu()
                                    for k, v in tensors.items()},
            'gens': {k: v.cpu() for k, v in states.items()},
            'launches': _counts(), 'runs': _batches_run(),
            'steps_run': dict(steps_run), 'captures': caps}


def _host_same(a, b) -> list:
    """Where two nests of host outputs (arrays, bytes, numbers) differ."""
    if isinstance(a, dict):
        return [str(k) + ('/' + d if d else '') for k in a
                for d in (_host_same(a[k], b[k]) if k in b else ['missing'])]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return ['length']
        return ['{}{}'.format(i, '/' + d if d else '')
                for i, (u, v) in enumerate(zip(a, b)) for d in _host_same(u, v)]
    if isinstance(a, np.ndarray):
        return _host_equal(a, b)
    return [] if a == b else ['']


def jit_bits(program: str, dirs: tuple, dtype: str = 'float32') -> dict:
    """``program`` graphed against eager from one job: every output, every
    tensor it moves and every generator's state after it bit for bit;
    launches per eager or captured batch (one eager batch's launches,
    the flagship's 8 conv, with or without a combine); each scoring
    capture holding them as kernel nodes by name (Poscod's head step
    none of the port's)."""
    got = {graphed: _jit_run(program, graphed, dirs, dtype)
           for graphed in (False, True)}
    e, g = got[False], got[True]
    what = '{} {}'.format(program, dtype)
    diff = ['out/' + k for k in _host_same(e['out'], g['out'])]
    diff += [k for k in e['tensors']
             if not torch.equal(e['tensors'][k], g['tensors'][k])]
    if set(e['gens']) != set(g['gens']) or any(
            not torch.equal(e['gens'][k], g['gens'][k]) for k in e['gens']):
        diff.append('generators')
    if diff:
        raise AssertionError('{}: graph and eager differ at {}'.format(
            what, diff[:12]))
    names = [n for n in e['runs'] if n != 'train_step']
    eager_batches = sum(e['runs'][n]['eager'] for n in names)
    body = {k: 0 for k in e['launches']}
    if program == 'mean_losses':
        body = _want(_body_steps(2 * JIT_EPOCH_STEPS, what, e['steps_run']))
        body['iws_combine'] = 0
    per_batch = {k: (v - body[k]) // eager_batches
                 for k, v in e['launches'].items()}
    if per_batch['same_grid_conv'] != SITES_PER_BATCH or per_batch[
            'same_grid_conv_dx'] or per_batch['iws_combine'] not in (0, 1):
        raise AssertionError('{}: {} launches a batch'.format(what, per_batch))
    for graphed, r in got.items():
        if graphed and not any(x['replayed'] for x in r['runs'].values()):
            raise AssertionError('{}: no batch replayed'.format(what))
        n = _scored(sum(x['eager'] + x['replayed'] for x in
                        r['runs'].values()), what, runs=r['runs'])
        steps = (_body_steps(2 * JIT_EPOCH_STEPS, what, r['steps_run'])
                 if program == 'mean_losses' else 0)
        want = {k: per_batch[k] * n + (_want(steps)[k] if steps else 0)
                for k in per_batch}
        if r['launches'] != want:
            raise AssertionError('{} (graphed {}): launched {}, want {}'
                                 .format(what, graphed, r['launches'], want))
    scoring = [c for c in g['captures'] if c['name'] in g['runs']]
    nodes = {'same_grid_conv': per_batch['same_grid_conv'],
             'iws_combine': per_batch['iws_combine']}
    out = {'program': program, 'dtype': dtype, 'runs': g['runs'],
           'outputs_equal': len(e['out']), 'tensors_equal': len(e['tensors']),
           'generators_equal': sorted(e['gens']),
           'per_batch': per_batch,
           'launches': {'eager': e['launches'], 'graphed': g['launches']}}
    out.update(_capture_gate(scoring, nodes, what))
    if program == 'mean_losses':
        # the train step's graph, beside which the losses' pool sits
        out['train_step'] = [{k: c[k] for k in ('capture_s', 'pool_bytes',
                                                 'kernel_nodes')}
                             for c in g['captures']
                             if c['name'] == 'train_step']
    heads = [c for c in g['captures'] if c['name'] == 'poscod_head_step']
    if program == 'poscod':
        if not heads or any(any(c['kernel_nodes_by_source'].values())
                            for c in heads):
            raise AssertionError('poscod head step captures {}'.format(heads))
        out['head_step'] = {'captures': len(heads),
                            'capture_s': [c['capture_s'] for c in heads],
                            'pool_bytes': [c['pool_bytes'] for c in heads],
                            'steps_run': g['steps_run']}
    return out


def jit_timings(dirs: tuple) -> list:
    """Graphed against eager in one process, in turns eager, graph, graph,
    eager (``_score_case``: the first calls with their captures, ms a
    call, one profiled call of each mode): one epoch's per-epoch losses
    on a 10,000-image test set at 512, ``cli.aggregate``'s scores of two
    jobs over the test set, a Poscod fine-tune and its scores of the test
    set, ``record_latents`` of two sets.  Each graphed program on a job
    of its own, its held graphs captured in its first call."""
    from joint_vae_tpu_torch.cli import aggregate as agg_cli
    from joint_vae_tpu_torch.ft import job as ft_job
    from joint_vae_tpu_torch.ft.poscod import PoscodJob
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.train import trainer
    from joint_vae_tpu_torch.train.graphs import held_score_graphs
    from joint_vae_tpu_torch.train.state import make_generator
    testset, oodsets = _ood_sets()
    jobs = {m: [load_job(d) for d in dirs] for m in (False, True)}

    def caps(kind, *js):
        return lambda: [c for j in js
                        for c in held_score_graphs(j)[kind].captures]
    cases = [_score_case(
        'mean_losses', lambda m: trainer._mean_losses(
            jobs[m][0], testset, OOD_BATCH, 0, graphed=m), 1, None,
        caps('mean_losses', jobs[True][0]))]
    cases.append(_score_case(
        'aggregate', lambda m: [agg_cli._scores(j, testset, OOD_BATCH, 0,
                                                graphed=m) for j in jobs[m]],
        1, None, caps('aggregate', *jobs[True])))
    pcs = {m: PoscodJob(job=jobs[m][0], graphed=m) for m in (False, True)}
    ind, moving = (_cut(testset, JIT_POSCOD_SET),
                   _cut(oodsets[0], JIT_POSCOD_SET))

    def poscod_run(m):
        pcs[m].finetune(ind, moving, epochs=1, batch_size=WIM_BATCH)
        pcs[m].llr_scores(testset, WIM_TEST_BATCH)
    cases.append(_score_case('poscod', poscod_run, 1, None,
                             caps('poscod', jobs[True][0])))
    wims = {m: _wim(dirs[0]) for m in (False, True)}
    d = os.path.join(WORK, 'jit_latents_timed')
    os.makedirs(d, exist_ok=True)
    cases.append(_score_case(
        'record_latents', lambda m: ft_job.record_latents(
            wims[m], [testset, oodsets[0]], WIM_TEST_BATCH,
            make_generator(wims[m].job.device, 5), d, graphed=m), 1, None,
        caps('latents', wims[True].job)))
    return cases


def jit_graphs_phase(card: str) -> tuple:
    """Phase 18: the bit gates, then the timings; returns the graphed
    bit-gate runs' launches and the ``jit_graphs`` line."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    dirs = (_flagship_dir(), _second_job_dir())
    bits = [jit_bits('mean_losses', dirs, 'float32'),
            jit_bits('mean_losses', dirs, 'bfloat16')]
    bits += [jit_bits(p, dirs) for p in ('aggregate', 'poscod', 'sample',
                                         'latents')]
    torch.cuda.empty_cache()
    timings = jit_timings(dirs)
    torch.cuda.empty_cache()
    line = {'bits': bits, 'timings': timings,
            'jobs': [os.path.relpath(d, WORK) for d in dirs],
            'seconds': time.perf_counter() - t0, 'card': card}
    print('jit_graphs', json.dumps(line), flush=True)
    launches = {'{}_{}'.format(b['program'], b['dtype']):
                b['launches']['graphed'] for b in bits}
    return launches, line


# phase 19: the JAX package's named training configurations
# (configs/default.ini), each through the train CLI with ``--config``,
# at full width (its own widths, depth, K, L, batch and test batch), in
# float32, on the registry's seeded synthetic sets.  [imagenet] is
# refused by both packages alike (ROADMAP); [cifar100] is the flagship
# (phases 4-18) and [wim-default] the WIM parameters run from [tilted]
CONFIG_SECTIONS = ('DEFAULT', 'mnist-dense', 'mnist-vae', 'mnist-vib',
                   'cifar10', 'tilted', 'mnist-vgg', 'fashion',
                   'fashion-vgg16', 'svhn', 'cifar10-vgg', 'autoencoder',
                   'vgg-baseline')
CONFIG_BATCHES = 4              # the CLI's epoch: 4 batches of the section's
CONFIG_EVAL_SIZE = 1024         # the test set and each OOD set, evaluated
CONFIG_SERVE_BATCHES = 2        # Scorer batches after warm-up and capture
CONFIG_PARALLEL = 4             # train CLIs at once beside the gates
# two same-size OOD sets of each section's set (the registry's)
CONFIG_OOD = {'mnist': ('fashion', 'letters'),
              'fashion': ('mnist', 'letters'),
              'cifar10': ('svhn', 'lsunc'), 'svhn': ('cifar10', 'lsunc')}
CONFIG_WIM_SECTION, CONFIG_WIM_TRAIN = 'tilted', 1024


def _section(section: str) -> tuple:
    """The section's args and model config through the port's
    ``utils/parameters`` (``--config``), as the train CLI reads them."""
    from joint_vae_tpu_torch.utils import parameters
    args = parameters.get_args(['--config', section])
    return args, parameters.model_config_from_args(args)


def _section_sites(cfg) -> tuple:
    """The model's same-grid sites (a serve batch's conv launches) and
    those whose input gradient a train step launches (all but a features
    stack's first layer, which reads the data)."""
    from joint_vae_tpu_torch.models.cvnet import CVNet
    sites = same_grid_sites(CVNet(cfg), GATE_BATCH, 1)
    dx = [s for s in sites if s['site'] != 'features_stack.conv_0']
    return sites, dx


CONFIG_SLICE_ELEMS = 2 ** 27    # a plain version's slice: x or y elements


def _sliced_gate(y, x, plain, what: str) -> float:
    """``y`` against ``plain(x)`` in the conv's form (:func:`conv_gate`,
    its rms over the whole of ``plain(x)``), the plain version run and
    compared over slices of images: over a serve batch at once (65,536
    decoder images at L=128) its temporaries would pass the card's
    memory.  Returns the largest error."""
    step = max(1, CONFIG_SLICE_ELEMS // max(x[0].numel(), y[0].numel()))
    ref = torch.empty_like(y)
    for a in range(0, x.shape[0], step):
        ref[a:a + step] = plain(x[a:a + step])
    tol = CONV_TOL[torch.float32]
    atol = tol * (torch.linalg.vector_norm(ref) / ref.numel() ** 0.5).item()
    err = 0.0
    for a in range(0, x.shape[0], step):
        got, want = y[a:a + step], ref[a:a + step]
        torch.testing.assert_close(got, want, rtol=tol, atol=atol,
                                   msg=lambda m: '{}: {}'.format(what, m))
        err = max(err, (got - want).abs().max().item())
    del ref
    return err


def _site_key(site, dx: bool) -> tuple:
    """What a site's launches depend on: its launched shapes and pads, the
    sub-pixel packing, and whether it is the input gradient."""
    lay = site['layer']
    pack = ((lay.stride, lay.padding, lay.output_padding)
            if site['route'] == 'subpixel' else None)
    return (dx, site['route'], pack) + tuple(
        site[k] for k in ('n', 'h', 'w', 'ci', 'co', 'k', 'lo'))


def check_section_sites(section: str, serve: list, train: list, dx: list,
                        seen: dict) -> list:
    """The section's same-grid sites at the main path's shapes, float32,
    kernel against plain version (:func:`_sliced_gate`): the forward at
    its serve batch (the test batch at test L) and at its train batch,
    the input gradient at the train batch's dx sites.  Each distinct
    launch is checked once over the sections (``seen``: key -> row) and
    its row named by the section that checked it.  Rows carry the route
    (``kernel_route``), the launched shape, the launches
    (``batch_chunks``), the largest error and the kernel's ms."""
    from joint_vae_tpu_torch.ops.same_grid_conv import (
        batch_chunks, kernel_route, same_grid_conv, same_grid_conv_dx,
        same_grid_conv_dx_plain, same_grid_conv_plain)
    g = torch.Generator(device='cuda').manual_seed(19)
    rows = []
    for path, sites, is_dx in (('serve', serve, False),
                               ('train', train, False),
                               ('train_dx', dx, True)):
        for site in sites:
            key = _site_key(site, is_dx)
            if key not in seen:
                x, _, kd = site_inputs(site, torch.float32, g)
                lo, th = site['lo'], kd.shape[0]
                what = '[{}] {} {}'.format(section, path, site['site'])
                if is_dx:
                    x = (0.05 * torch.randn(x.shape[:3] + kd.shape[3:],
                                            generator=g, device='cuda'))
                    plo = th - 1 - lo
                    run = lambda: same_grid_conv_dx(x, kd, lo, lo)
                    plain = lambda a: same_grid_conv_dx_plain(a, kd, lo, lo)
                    ci, co = kd.shape[3], kd.shape[2]
                else:
                    plo = lo
                    run = lambda: same_grid_conv(x, kd, lo, lo)
                    plain = lambda a: same_grid_conv_plain(a, kd, lo, lo)
                    ci, co = kd.shape[2], kd.shape[3]
                y = run()
                seen[key] = {
                    'checked_in': section,
                    'launched_shape': list(x.shape) + [th, kd.shape[1], ci,
                                                       co],
                    'pad_lo': plo,
                    'kernel': kernel_route(torch.float32, ci, co),
                    'launches': len(batch_chunks(
                        x.shape[0], max(x[0].numel(), y[0].numel()))),
                    'max_abs_err': _sliced_gate(y, x, plain, what),
                    'ms': time_ms(run, 3)}
                del x, kd, y
                torch.cuda.empty_cache()
            rows.append({'site': site['site'], 'path': path,
                         'route': site['route'], **seen[key]})
    return rows


def _section_want(cfg, sites: int, dx: int, scored: int):
    """Launches of ``steps`` train steps and ``batches`` scored batches:
    the conv at every site per step and ``scored`` per batch (its sites at
    the test batch and L, :func:`site_launches`), its dx per step, one
    combine per batch where the prior is a class-conditional gaussian of
    scalar variance (a cvae), none for a vae, a vib or the tilted
    prior."""
    combine = int(cfg.type == 'cvae' and cfg.prior.distribution == 'gaussian'
                  and cfg.prior.var_dim == 'scalar')

    def want(steps: int, batches: int = 0) -> dict:
        return {'same_grid_conv': sites * steps + scored * batches,
                'same_grid_conv_dx': dx * steps,
                'iws_combine': combine * batches}
    return want, combine


class _CliRuns:
    """The sections' train CLIs as subprocesses, CONFIG_PARALLEL at once
    (two threads each), started in order by a thread of their own, each
    timed to its exit and waited for by name."""

    def __init__(self, argvs: dict):
        self.done, self.procs, self.stopped = {}, {}, False
        self.slots = threading.Semaphore(CONFIG_PARALLEL)
        self.env = dict(os.environ, OMP_NUM_THREADS='2')
        self.lock = threading.Lock()
        threading.Thread(target=self._start, args=(list(argvs.items()),),
                         daemon=True).start()

    def _start(self, items):
        for name, argv in items:
            self.slots.acquire()
            with self.lock:
                if self.stopped:
                    return
                log = open(os.path.join(WORK, 'config_{}.log'.format(name)),
                           'w')
                proc = subprocess.Popen(argv, cwd=ROOT, env=self.env,
                                        stdout=log, stderr=subprocess.STDOUT)
                self.procs[name] = proc
            threading.Thread(target=self._reap, daemon=True, args=(
                name, proc, time.perf_counter(), log)).start()

    def _reap(self, name, proc, t0, log):
        rc = proc.wait()
        log.close()
        self.done[name] = {'rc': rc, 'seconds': time.perf_counter() - t0}
        self.slots.release()

    def wait(self, name: str) -> dict:
        while name not in self.done:
            time.sleep(0.2)
        return self.done[name]

    def stop(self):
        with self.lock:
            self.stopped = True
            for proc in self.procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def _section_set(name: str, args, size: int = CONFIG_EVAL_SIZE):
    """The registry's test split of ``name`` as the section transforms
    it, ``size`` images."""
    from joint_vae_tpu_torch.data.loaders import get_dataset
    return get_dataset(name, transformer=args.transformer, splits=['test'],
                       size=size)[1]


def section_steps(job, args, want, what: str) -> dict:
    """CONFIG_TIMED graphed steps of the section's batch after
    TRAIN_WARMUP (the first eager, the second captured), fed as the CLI
    feeds them (its augmentation included): ms per step, the launches of
    the counted steps, the capture's kernel nodes."""
    from joint_vae_tpu_torch.data.loaders import DataLoader, get_dataset
    from joint_vae_tpu_torch.device import to_device
    from joint_vae_tpu_torch.train.steps import make_train_step, pull_metrics
    bs = args.batch_size
    trainset, _ = get_dataset(args.dataset, transformer=args.transformer,
                              splits=['train'], size=CONFIG_BATCHES * bs)
    batches = [tuple(to_device(a, job.device) for a in b)
               for b in DataLoader(trainset, bs, shuffle=True, seed=1,
                                   drop_last=True,
                                   data_augmentation=args.data_augmentation)]
    step = make_train_step(job.model, job.opt_cfg)
    state = job.state
    _count_reset()
    for i in range(TRAIN_WARMUP):
        state, m = step(state, *batches[i % len(batches)])
    torch.cuda.synchronize()
    pending = []
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED):
        state, m = step(state, *batches[i % len(batches)])
        pending.append(m)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
    launches = _counts()
    body = _body_steps(TRAIN_WARMUP + TRAIN_TIMED, what)
    if launches != want(body):
        raise AssertionError('{}: steps launched {}, want {}'.format(
            what, launches, want(body)))
    caps = step.graph.captures
    nodes = {'same_grid_conv': want(1)['same_grid_conv']
             + want(1)['same_grid_conv_dx'], 'iws_combine': 0}
    if len(caps) != 1 or caps[0]['kernel_nodes_by_source'] != nodes:
        raise AssertionError('{}: captures {}, want one holding {}'.format(
            what, caps, nodes))
    got = pull_metrics(pending)
    if not all(np.isfinite(list(r.values())).all() for r in got):
        raise AssertionError(what + ': non-finite train metrics')
    return {'batch': bs, 'ms_per_step': ms,
            'train_images_per_s': bs * 1e3 / ms, 'launches': launches,
            'body_steps': body, 'capture_kernel_nodes': nodes,
            'last_total': got[-1]['total']}


def section_serve(job, job_dir: str, args, want, what: str) -> dict:
    """The saved job served through its Scorer's graph at the section's
    test batch and L (warm-up, capture, CONFIG_SERVE_BATCHES timed), the
    launches per eager or captured batch and the capture's kernel nodes;
    then the card against the CPU on phase 4's 8 uniform inputs and on 8
    of the section's test images (:func:`section_card_vs_cpu`)."""
    from joint_vae_tpu_torch.serve import Scorer
    cfg = job.model_cfg
    bs = args.test_batch_size
    x = _section_set(args.dataset, args, bs * (CONFIG_SERVE_BATCHES + 1))[:][0]
    methods = [m for m in cfg.ood_methods if not m.startswith('odin')]
    calib = Scorer(job, methods=methods, graphed=False,
                   thresholds={m: float('-inf') for m in methods})(x[:bs])
    kw = {'methods': methods, 'thresholds': serve_thresholds(calib['scores'])}
    scorer = Scorer(job, **kw)
    _count_reset()
    scorer(x[:bs])
    scorer(x[:bs])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [scorer(x[(1 + b) * bs:(2 + b) * bs])
            for b in range(CONFIG_SERVE_BATCHES)]
    seconds = time.perf_counter() - t0
    launches = _counts()
    n = _scored(2 + CONFIG_SERVE_BATCHES, what + ' Scorer', ('scorer',))
    if launches != want(0, n):
        raise AssertionError('{} Scorer: launched {}, want {}'.format(
            what, launches, want(0, n)))
    one = want(0, 1)
    per_batch = {k: one[k] for k in ('same_grid_conv', 'iws_combine')}
    capture = _capture_gate(scorer.graph.captures, per_batch,
                            what + ' Scorer')
    for o in outs:
        if not all(np.all(np.isfinite(o['scores'][m])) for m in methods):
            raise AssertionError(what + ': non-finite scores')
    del scorer
    return {'batch': bs, 'L': cfg.test_latent_sampling, 'methods': methods,
            'images_per_s': bs * CONFIG_SERVE_BATCHES / seconds,
            'launches': launches, 'batches_counted': n,
            'per_batch': per_batch, 'capture': capture,
            'card_vs_cpu': section_card_vs_cpu(
                job, job_dir, kw, np.random.default_rng(29).uniform(
                    0, 1, (8,) + cfg.input_shape).astype(np.float32),
                x[:8])}


def section_card_vs_cpu(job, job_dir: str, scorer_kw: dict, x_uniform,
                        x_own) -> dict:
    """The card against the CPU with injected noise at the job's test L:
    ``evaluate``'s every loss, the Scorer's every score (``scorer_kw``)
    and, where the job computes per-class iws, its labels where the
    reference's classes are clear of each other.  On 8 inputs uniform in
    [0, 1] against the CPU in float32 (phase 4's inputs) and on 8 of the
    section's own test images against the CPU in float64 (the job's
    weights made float64, ``torch_choices.Float64``), both at phase 4's
    tolerance.  The CPU's scores and labels are ``batch_dist_measures``
    and ``predict_after_evaluate`` of its one evaluation, as the Scorer
    computes them.  On its own images a well reconstructed image leaves
    residuals of ~0.1, whose squares a reconstruction term sums beside
    constants that cancel them, so either device's float32 rounding moves
    that term by more of itself than on uniform inputs: float64 leaves
    the card's alone."""
    from joint_vae_tpu_torch.models.evaluate import evaluate
    from joint_vae_tpu_torch.ops.scores import (batch_dist_measures,
                                                predict_after_evaluate)
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.serve import Scorer
    tc = _torch_choices()
    cfg = job.model_cfg
    methods = scorer_kw['methods']
    eps = np.random.default_rng(3).standard_normal(
        (cfg.test_latent_sampling + 1, 8, cfg.latent_dim)).astype(np.float32)
    eps[0] = 0.0
    scorer = Scorer(job, **scorer_kw)

    def evaluated(j, x, mode):
        xt, et = torch.as_tensor(x, device=j.device), torch.as_tensor(eps)
        with torch.no_grad(), mode:
            out = evaluate(j.model, xt, None, sigma_state=j.sigma_state,
                           eps=et, decode_mean=False)
            vals = {'score ' + m: v for m, v in batch_dist_measures(
                cfg, out.logits, out.losses, methods).items()}
            iws = out.losses.get('iws')
            if iws is not None and iws.ndim > 1:
                logits = out.logits
                if logits.ndim == 3 and scorer._pm == 'esty':
                    logits = torch.mean(logits, dim=0)
                vals['label'] = predict_after_evaluate(
                    cfg, logits, out.losses, scorer._pm)
        vals.update({'loss ' + k: v for k, v in out.losses.items()})
        return {k: v.cpu().numpy() for k, v in vals.items()}

    cpu64 = load_job(job_dir, device='cpu')
    cpu64.model.to(torch.float64)
    refs = {'uniform': (x_uniform, load_job(job_dir, device='cpu'),
                        contextlib.nullcontext(), 'CPU float32'),
            'own': (x_own, cpu64, tc.Float64(), 'CPU float64')}
    out = {}
    for name, (x, ref_job, mode, ref_name) in refs.items():
        want = evaluated(ref_job, x, mode)
        card = evaluated(job, x, contextlib.nullcontext())
        sc = scorer(x, eps=torch.as_tensor(eps))
        got = {k: (sc['scores'][k[6:]] if k.startswith('score ') else v)
               for k, v in card.items() if k != 'label'}
        worst = {}
        for k, g in got.items():
            w = want[k].astype(np.float64)
            err = np.nan_to_num(np.abs(g.astype(np.float64) - w), nan=0.0)
            worst[k] = float(np.max(err / np.maximum(np.abs(w), 1e-30)))
            np.testing.assert_allclose(
                g, w, rtol=SERVE_RTOL, atol=SERVE_ATOL,
                err_msg='card vs {} on {} inputs, {}'.format(
                    ref_name, name, k))
        clear = np.zeros(0, bool)
        if 'label' in want:
            top2 = np.sort(want['loss iws'], axis=0)[-2:]
            clear = (top2[1] - top2[0]) > 2 * (SERVE_ATOL
                                               + SERVE_RTOL * np.abs(top2[1]))
            if not np.array_equal(want['label'][clear], sc['label'][clear]):
                raise AssertionError('card and {} labels differ on {} '
                                     'inputs'.format(ref_name, name))
        out[name] = {'reference': ref_name, 'inputs': len(x),
                     'checked': len(got), 'clear_labels': int(clear.sum()),
                     'worst': worst}
    del scorer
    return out


def section_ood(job, args, want, what: str) -> dict:
    """``ood_detection_rates`` on the compute tier alone (the CLI's
    results of the same sets are in the job's json): the section's test set
    and two same-size OOD sets of CONFIG_EVAL_SIZE at its test batch and
    L (every OOD method but ODIN's, whose input gradients phase 6
    holds), the launches per eager or captured batch, finite results."""
    from joint_vae_tpu_torch.evals import engines
    cfg = job.model_cfg
    testset = _section_set(args.dataset, args)
    oodsets = [_section_set(s, args) for s in CONFIG_OOD[args.dataset]]
    methods = [m for m in cfg.ood_methods if not m.startswith('odin')]
    bs = args.test_batch_size
    _count_reset()
    t0 = time.perf_counter()
    res = engines.ood_detection_rates(job, testset, oodsets, batch_size=bs,
                                      method=methods, recording=False,
                                      from_where=('compute',))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    batches = 3 * -(-CONFIG_EVAL_SIZE // bs)
    n = _scored(batches, what + ' OOD evaluation')
    if launches != want(0, n):
        raise AssertionError('{} OOD: launched {}, want {}'.format(
            what, launches, want(0, n)))
    aucs = {s: {m: r['auc'] for m, r in ms.items()} for s, ms in res.items()}
    if set(res) != set(CONFIG_OOD[args.dataset]) or not all(
            np.isfinite(v) for r in aucs.values() for v in r.values()):
        raise AssertionError('{} OOD results {}'.format(what, aucs))
    return {'sets': [testset.name] + [s.name for s in oodsets],
            'set_size': CONFIG_EVAL_SIZE, 'batch': bs,
            'ood_images_per_s': 3 * CONFIG_EVAL_SIZE / seconds,
            'seconds': seconds, 'launches': launches,
            'batches_counted': n, 'auc': aucs}


def section_wim(card: str, jobs: str, job_dir: str, args) -> dict:
    """WIM from [tilted], the reference's own flow: the card against the
    CPU on its weights with [wim-default]'s alternate prior (``wim_gate``:
    a both-prior evaluation of 8 inputs, 3 fine-tuning steps each held by
    ``step_gate``), then ``cli.ft`` on the CLI's job with [wim-default]'s
    parameters (its alternate prior, alpha, moving set, one epoch), the
    train size cut to CONFIG_WIM_TRAIN, in process with its launches
    counted: the conv at both halves' sites and its dx per step, the
    pre-tuning, both-prior and ``record_latents`` batches' convs."""
    from joint_vae_tpu_torch.cli import ft as ft_cli
    from joint_vae_tpu_torch.ft.wim import WIM_OOD_METHODS_PER_TYPE
    from joint_vae_tpu_torch.save_load.checkpoint import load_json
    from joint_vae_tpu_torch.save_load.jobs import load_job
    cfg = load_job(job_dir, device='cpu').model_cfg
    sites, dx = (len(s) for s in _section_sites(cfg))
    gate = wim_gate(job_dir, cfg)
    cwd = os.path.join(WORK, 'config_ft_cwd')
    shutil.rmtree(cwd, ignore_errors=True)
    os.makedirs(cwd)
    seen = set(_job_dirs(jobs))
    old_cwd = os.getcwd()
    argv = ['1', '--job-dir', jobs, '--train-size', str(CONFIG_WIM_TRAIN),
            '--oodsets'] + list(CONFIG_OOD[args.dataset])
    _count_reset()
    t0 = time.perf_counter()
    try:
        os.chdir(cwd)
        with open(os.path.join(WORK, 'config_ft.out'), 'w') as f, \
                contextlib.redirect_stdout(f):
            # --- the main path: WIM fine-tuning from [tilted] ---
            rc = ft_cli.main(argv)
        torch.cuda.synchronize()
    finally:
        os.chdir(old_cwd)
    wall = time.perf_counter() - t0
    launches = _counts()
    # --- end of the main path ---
    runs = _batches_run()
    steps = _body_steps(CONFIG_WIM_TRAIN // WIM_BATCH, 'WIM from [tilted]')
    counted = {n: r['eager'] + r['captured'] for n, r in runs.items()}
    batches = (counted.get('score_batch', 0) + counted.get('latents_batch', 0)
               + 2 * counted.get('both_prior_batch', 0))
    want = {'same_grid_conv': sites * (2 * steps + batches),
            'same_grid_conv_dx': 2 * dx * steps}
    got = {k: launches[k] for k in want}
    if rc != 0 or got != want or not counted.get('both_prior_batch'):
        raise AssertionError('WIM from [tilted]: exit {}, launches {}, want '
                             '{} (batches {})'.format(rc, launches, want,
                                                      runs))
    (d,) = set(_job_dirs(jobs)) - seen
    ood = load_json(os.path.join(d, 'ood.json'))
    last = ood[max(ood, key=int)]          # the source job's last epoch
    aucs = {s + '/' + m: r['auc'] for s, ms in last.items()
            for m, r in ms.items()}
    # the WIM methods of the source's type (a vae's: zdist, elbo, kl)
    want = {s + '/' + m for s in CONFIG_OOD[args.dataset]
            for m in WIM_OOD_METHODS_PER_TYPE[cfg.type]}
    if set(aucs) != want or not np.all(np.isfinite(list(aucs.values()))):
        raise AssertionError('WIM from [tilted]: results {}, want {}'.format(
            aucs, sorted(want)))
    return {'gate': gate, 'wall_s': wall, 'launches': launches,
            'batches_run': runs, 'steps': CONFIG_WIM_TRAIN // WIM_BATCH,
            'job_dir': os.path.relpath(d, WORK), 'auc': aucs,
            'card': card}


def _config_launch_keys(launches: dict, kernel: str) -> dict:
    """Phase 19's launches of ``kernel``, by section and main path."""
    return {s: {path: c[kernel] for path, c in paths.items()}
            for s, paths in launches.items()}


def configs_phase(card: str) -> tuple:
    """Phase 19: each of CONFIG_SECTIONS trained by ``cli.train --config
    <section>`` (a subprocess; one epoch of CONFIG_BATCHES batches, its
    validation split and final test, ``--no-final-ood``), CONFIG_PARALLEL
    at once while this process runs each section's sites against their
    plain versions at its serve and train shapes
    (:func:`check_section_sites`) and its training gate (``train_gate``
    at batch 8, 3 steps, every gradient element at GRAD_TOL but the
    BatchNorm-invariant biases, :func:`bn_bias_limits`); then, each CLI
    done, the saved job: trained 4 steps, saved and loaded exactly, 10
    graphed steps timed with their launches and the capture's kernel
    nodes, served through its Scorer's graph and held to the CPU on 8
    uniform inputs and on 8 of its test images
    (:func:`section_card_vs_cpu`), evaluated by
    ``ood_detection_rates``; WIM from [tilted].  One ``config`` line
    per section; returns the launches by section and path, and the
    ``configs`` line."""
    from joint_vae_tpu_torch.data import native
    from joint_vae_tpu_torch.models.cvnet import CVNet
    from joint_vae_tpu_torch.save_load.jobs import load_job, save_job
    t_phase = time.perf_counter()
    native.get_lib()                  # built once, before the CLIs load it
    root = os.path.join(WORK, 'config_jobs')
    shutil.rmtree(root, ignore_errors=True)
    info, argvs = {}, {}
    for section in CONFIG_SECTIONS:
        args, cfg = _section(section)
        sites, dx = _section_sites(cfg)
        model = CVNet(cfg)
        train = same_grid_sites(model, args.batch_size, cfg.latent_sampling)
        info[section] = (args, cfg, sites, dx, same_grid_sites(
            model, args.test_batch_size, cfg.test_latent_sampling), train,
            [s for s in train if s['site'] != 'features_stack.conv_0'])
        del model
        jobs = os.path.join(root, section)
        argvs[section] = [
            sys.executable, '-m', 'joint_vae_tpu_torch.cli.train',
            '--config', section, '--epochs', '1', '--dataset-size',
            str(CONFIG_BATCHES * args.batch_size + args.validation),
            '--no-final-ood', '--job-dir', jobs, '--job-number', '1']
    clis = _CliRuns(argvs)
    rows, launches, checked = {}, {}, {}
    try:
        for section in CONFIG_SECTIONS:       # beside the CLIs
            args, cfg, sites, dx = info[section][:4]
            t0 = time.perf_counter()
            rows[section] = {
                'params': sum(p.numel() for p in CVNet(cfg).parameters()),
                'type': cfg.type, 'K': cfg.latent_dim, 'C': cfg.num_labels,
                'L': cfg.test_latent_sampling,
                'sites': check_section_sites(
                    section, *info[section][4:], checked),
                'gate': train_gate(cfg, GATE_BATCH),
                'gate_seconds': time.perf_counter() - t0}
            print('config_gate', json.dumps({section: {
                k: rows[section]['gate'][k] for k in (
                    'grad_worst', 'grad_worst_tensors', 'loss_worst_rel_err',
                    'update_worst', 'flips_total',
                    'bn_bias_worst_over_limit')}}), flush=True)
            torch.cuda.empty_cache()
        runs = {s: clis.wait(s) for s in CONFIG_SECTIONS}  # the card free
        t_jobs = time.perf_counter()
        for section in CONFIG_SECTIONS:
            args, cfg, sites, dx = info[section][:4]
            what = '[{}]'.format(section)
            run = runs[section]
            if run['rc'] != 0:
                with open(os.path.join(WORK, 'config_{}.log'.format(
                        section))) as f:
                    raise AssertionError('{} train CLI exited {}:\n{}'.format(
                        what, run['rc'], f.read()[-4000:]))
            jobs = os.path.join(root, section)
            (job_dir,) = _job_dirs(jobs)
            scored = site_launches(info[section][4])
            want, combine = _section_want(cfg, len(sites), len(dx), scored)
            t0 = time.perf_counter()
            job = load_job(job_dir)
            if (job.trained != 1 or job.state.step != CONFIG_BATCHES
                    or job.model_cfg.architecture != cfg.architecture):
                raise AssertionError('{}: {} epochs, {} steps'.format(
                    what, job.trained, job.state.step))
            hist = job.train_history[1]
            for part in ('train_loss', 'test_loss') + (
                    ('validation_loss',) if args.validation else ()):
                if not np.all(np.isfinite(list(hist[part].values()))):
                    raise AssertionError('{} {}: {}'.format(what, part,
                                                            hist[part]))
            again = os.path.join(WORK, 'config_saved', section)
            shutil.rmtree(again, ignore_errors=True)
            save_job(job, again)
            if not _same_jobs(job, load_job(again)):
                raise AssertionError(what + ': save and load differ')
            row = rows[section]
            row.update({
                'cli_seconds': run['seconds'],
                'sites_by_route': {r: sum(
                    s['kernel']['kernel'] == r for s in row['sites']
                    if s['path'] == 'serve') for r in {
                        s['kernel']['kernel'] for s in row['sites']}},
                'combine_per_batch': combine,
                'serve': section_serve(job, job_dir, args, want, what),
                'ood': section_ood(job, args, want, what)})
            del job
            torch.cuda.empty_cache()
            # the timed steps move the weights: on a job of their own
            row['steps'] = section_steps(load_job(job_dir), args, want, what)
            torch.cuda.empty_cache()
            launches[section] = {'steps': row['steps']['launches'],
                                 'serve': row['serve']['launches'],
                                 'ood': row['ood']['launches']}
            if section == CONFIG_WIM_SECTION:
                row['wim'] = section_wim(card, jobs, job_dir, args)
                launches[section]['wim_ft'] = row['wim']['launches']
            row['card'] = card
            row['job_seconds'] = time.perf_counter() - t0
            print('config', json.dumps({section: row}), flush=True)
    finally:
        clis.stop()
    line = {'sections': list(CONFIG_SECTIONS),
            'seconds': time.perf_counter() - t_phase,
            'gates_and_clis_seconds': t_jobs - t_phase,
            'summary': {s: {
                'params': r['params'], 'sites_by_route': r['sites_by_route'],
                'launches_per_batch': r['serve']['per_batch'],
                'launches_per_step': {
                    'same_grid_conv': len(info[s][2]),
                    'same_grid_conv_dx': len(info[s][3])},
                'cli_seconds': r['cli_seconds'],
                'job_seconds': r['job_seconds'],
                'step_ms': r['steps']['ms_per_step'],
                'serve_images_per_s': r['serve']['images_per_s'],
                'ood_images_per_s': r['ood']['ood_images_per_s'],
                'gate_grad_worst': r['gate']['grad_worst'],
                'gate_loss_worst_rel_err': r['gate']['loss_worst_rel_err'],
                'card_vs_cpu_worst': {
                    k: max(v['worst'].values())
                    for k, v in r['serve']['card_vs_cpu'].items()}}
                for s, r in rows.items()},
            'card': card}
    print('configs', json.dumps(line), flush=True)
    return launches, line

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
    hgmma = hgmma_counts(sass)
    print('hgmma', json.dumps(hgmma), flush=True)

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
    del ood_job                     # and the engine graphs it holds
    wim_launches, poscod_launches, wim = timed('9 wim', wim_finetune, card)
    (resnet_step, resnet_serve, driver_launches, resnet,
     driver_line) = timed('10 trunks_and_drivers', trunks_and_drivers, card)
    (interop_serve, interop_test, interop_resume, interop_resnet,
     interop_line) = timed('11 interop', interop, card)
    mesh_launches, mesh_line = timed('12 mesh', mesh_phase, card)
    export_launches, export_line = timed('13 export', export_phase, card)
    evidence_launches, evidence_line = timed('14 evidence', evidence, card)
    graph_launches, graph_records, graphs_line = timed('15 graphs',
                                                       graphs_phase, card)
    score_launches, score_records, score_line = timed(
        '16 score_graphs', score_graphs_phase, card)
    im64_launches, im64_line = timed('17 imagenet64', imagenet64_phase, card)
    jit_launches, jit_line = timed('18 jit_graphs', jit_graphs_phase, card)
    config_launches, config_line = timed('19 configs', configs_phase, card)
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
         'launches_evidence': evidence_launches['same_grid_conv'],
         'launches_graphs': _graph_launch_keys(graph_launches,
                                               graph_records, 'same_grid_conv', 'same_grid_conv'),
         'launches_score_graphs': _score_launch_keys(
             score_launches, score_records, 'same_grid_conv',
             'same_grid_conv'),
         'launches_imagenet64': _im64_launch_keys(im64_launches,
                                                  'same_grid_conv'),
         'launches_jit_graphs': {k: c['same_grid_conv']
                                 for k, c in jit_launches.items()},
         'launches_configs': _config_launch_keys(config_launches, 'same_grid_conv'),
         'imagenet64': {g: im64_line['kernels'][g]
                        for g in ('serve', 'train_forward')},
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
         'launches_evidence': evidence_launches['same_grid_conv_dx'],
         'launches_graphs': _graph_launch_keys(graph_launches,
                                               graph_records, 'same_grid_conv_dx', 'same_grid_conv'),
         'launches_score_graphs': _score_launch_keys(
             score_launches, score_records, 'same_grid_conv_dx',
             'same_grid_conv'),
         'launches_imagenet64': _im64_launch_keys(im64_launches,
                                                  'same_grid_conv_dx'),
         'launches_jit_graphs': {k: c['same_grid_conv_dx']
                                 for k, c in jit_launches.items()},
         'launches_configs': _config_launch_keys(config_launches, 'same_grid_conv_dx'),
         'imagenet64': {'train_dx': im64_line['kernels']['train_dx']},
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
         'launches_evidence': evidence_launches['iws_combine'],
         'launches_graphs': _graph_launch_keys(graph_launches,
                                               graph_records, 'iws_combine', 'iws_combine'),
         'launches_score_graphs': _score_launch_keys(
             score_launches, score_records, 'iws_combine', 'iws_combine'),
         'launches_imagenet64': _im64_launch_keys(im64_launches,
                                                  'iws_combine'),
         'launches_jit_graphs': {k: c['iws_combine']
                                 for k, c in jit_launches.items()},
         'launches_configs': _config_launch_keys(config_launches, 'iws_combine'),
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
                      'export': export_line, 'evidence': evidence_line,
                      'graphs': graphs_line, 'score_graphs': score_line,
                      'imagenet64': im64_line, 'jit_graphs': jit_line,
                      'configs': config_line,
                      'library_conv_grads': library_rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def phase_only(phase):
    """``--mesh`` / ``--graphs`` / ``--score-graphs`` / ``--imagenet64`` /
    ``--jit-graphs`` / ``--configs``: build the kernels and run phase 12,
    15, 16, 17, 18 or 19 alone (its ``mesh_*``, ``graphs``,
    ``score_graphs``, ``imagenet64``, ``jit_graphs`` or ``config(s)``
    lines)."""
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is false')
    from joint_vae_tpu_torch.device import set_float32_math
    from joint_vae_tpu_torch.ops import cuda_lib
    set_float32_math()
    card = card_line()
    print(card, flush=True)
    print('build seconds', round(cuda_lib.build(), 3), flush=True)
    os.makedirs(WORK, exist_ok=True)
    phase(card)


if __name__ == '__main__':
    if len(sys.argv) > 1 and sys.argv[1] == '--mesh-rank':
        mesh_rank(sys.argv[2:])
    elif sys.argv[1:] == ['--mesh']:
        phase_only(mesh_phase)
    elif sys.argv[1:] == ['--mesh-nccl']:
        phase_only(mesh_nccl_phase)
    elif sys.argv[1:] == ['--graphs']:
        phase_only(graphs_phase)
    elif sys.argv[1:] == ['--score-graphs']:
        phase_only(score_graphs_phase)
    elif sys.argv[1:] == ['--imagenet64']:
        phase_only(imagenet64_phase)
    elif sys.argv[1:] == ['--jit-graphs']:
        phase_only(jit_graphs_phase)
    elif sys.argv[1:] == ['--configs']:
        phase_only(configs_phase)
    else:
        main()
