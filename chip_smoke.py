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
   N=137 case, the same shape with prior means at the flagship's scale 17,
   L=128 at N=64 and N=512, and C=1000, K=256 (``IWS_CASES``), each timed
   as called back to back and replayed from a CUDA graph, beside the
   composite of PyTorch calls that the JAX package's default path
   computes (``library_ms``, its deviation from the plain version
   printed, not gated);
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
6. print one JSON line ``{"kernels": [...]}``;
7. print ``{"ok": true, "device": {...}}`` as the last line.

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
"""

import json
import os
import subprocess
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
# the backward spans of SameGridConvFn (record_function)
SPANS = ('same_grid_conv_dx', 'same_grid_conv_dw')
METHODS = ('iws', 'elbo', 'zdist', 'mse', 'soft', 'iws-2s', 'elbo-2s')


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
# serve point in both modes, a ragged one, the flagship's prior scale
# (init_mean=17), the reference's eval L=128 at a scorer batch of 64 and
# of 512, and the imagenet64 geometry (C=1000, K=256)
IWS_CASES = ((16, 512, 100, 128, 0.1, (True, False)),
             (16, 137, 37, 128, 0.1, (True, False)),
             (16, 512, 100, 128, 17.0, (True, False)),
             (128, 64, 100, 128, 0.1, (True,)),
             (128, 512, 100, 128, 0.1, (True,)),
             (16, 512, 1000, 256, 0.1, (True,)))
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


def conv_gate(got, want, what):
    """The conv's float32 form: |got - want| <= tol (|want| + rms(want))."""
    tol = CONV_TOL[torch.float32]
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


def check_train_conv(sites):
    """The same-grid conv at the train step's shapes (batch 1024, L=1):
    the forward at every site; at the sites whose input needs a gradient
    the dx kernel against its plain version (``library_ms``: cuDNN's data
    gradient of the same conv, ``torch.nn.grad.conv2d_input``), and the
    weight gradient (a float32 im2col product) against the same product
    in float64, timed beside cuDNN's float32 weight gradient, whose error
    against float64 is printed (not gated)."""
    from joint_vae_tpu_torch.ops.same_grid_conv import (
        same_grid_conv, same_grid_conv_dw, same_grid_conv_dx,
        same_grid_conv_dx_plain, same_grid_conv_plain)
    g_cuda = torch.Generator(device='cuda').manual_seed(3)
    dt = torch.float32
    fwd_rows, dx_rows = [], []
    keys = ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'dw_ms',
            'dw_cudnn_ms', 't_bytes', 't_ops')
    total = {'fwd_ms': 0.0, 'fwd_max_abs_err': 0.0, 'max_abs_err': 0.0,
             'dw_max_rel_err': 0.0, 'dw_cudnn_max_rel_err': 0.0,
             **{k: 0.0 for k in keys}}
    for j, site in enumerate(sites):
        name, lo = site['site'], site['lo']
        x, kern, kd = site_inputs(site, dt, g_cuda)
        n, h, w, ci = x.shape
        th, tw, _, co = kd.shape
        y = same_grid_conv(x, kd, lo, lo)
        ref = same_grid_conv_plain(x, kd, lo, lo)
        conv_gate(y, ref, 'train forward ' + name)
        fwd_err = (y - ref).abs().max().item()
        fwd_ms = time_ms(lambda: same_grid_conv(x, kd, lo, lo), 10)
        fwd_rows.append({'site': name, 'launched_shape': [n, h, w, ci, co, th, tw],
                         'ms': fwd_ms, 'max_abs_err': fwd_err})
        print('train_conv', json.dumps(fwd_rows[-1]), flush=True)
        total['fwd_ms'] += fwd_ms
        total['fwd_max_abs_err'] = max(total['fwd_max_abs_err'], fwd_err)
        del y, ref
        if j == 0:
            continue              # features conv_0 reads the data: no dx
        g = 0.05 * torch.randn((n, h, w, co), generator=g_cuda, device='cuda')
        dx = same_grid_conv_dx(g, kd, lo, lo)
        dx_ref = same_grid_conv_dx_plain(g, kd, lo, lo)
        conv_gate(dx, dx_ref, 'dx ' + name)
        dw = same_grid_conv_dw(x, g, th, tw, lo, lo)
        dw64 = same_grid_conv_dw(x.double(), g.double(), th, tw, lo, lo)
        conv_gate(dw, dw64, 'dw ' + name)
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
        nbytes = 4.0 * (g.numel() + kd.numel() + x.numel())
        flops = 2.0 * n * h * w * th * tw * ci * co
        b, by = bound_ms(nbytes, flops, PEAK_FLOPS[dt])
        row = {'site': name, 'dx_shape': [n, h, w, co, ci, th, tw],
               'ms': ms, 'plain_ms': plain, 'library_ms': lib,
               'bound_ms': b, 'bound_by': by, 'share_of_bound': b / ms,
               'max_abs_err': (dx - dx_ref).abs().max().item(),
               'tflops': flops / ms / 1e9,
               'dw_ms': dw_ms, 'dw_cudnn_ms': dw_cudnn_ms,
               'dw_max_rel_err': (dw - dw64).abs().max().item() / rms64,
               'dw_cudnn_max_rel_err':
                   (dw_cudnn - dw64).abs().max().item() / rms64}
        dx_rows.append(row)
        print('dx', json.dumps(row), flush=True)
        for key in ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'dw_ms',
                    'dw_cudnn_ms'):
            total[key] += row[key]
        total['t_bytes'] += nbytes / HBM_BYTES_PER_S * 1e3
        total['t_ops'] += flops / PEAK_FLOPS[dt] * 1e3
        for key in ('max_abs_err', 'dw_max_rel_err', 'dw_cudnn_max_rel_err'):
            total[key] = max(total[key], row[key])
        del x, kern, kd, g, dx, dx_ref, dw, dw64, dw_cudnn, wc, gc
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


def train_gate(cfg) -> dict:
    """The full-width flagship at batch 8 from one init (a numpy seed),
    with the same batch and the same injected noise, on the card and on
    the CPU: the first step's gradients per tensor, then the losses of 3
    steps."""
    from joint_vae_tpu_torch.models.evaluate import evaluate
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.steps import make_train_step
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (GATE_BATCH,) + cfg.input_shape).astype(np.float32)
    y = rng.integers(0, cfg.num_labels, GATE_BATCH).astype(np.int64)
    eps = rng.standard_normal((cfg.latent_sampling + 1, GATE_BATCH,
                               cfg.latent_dim)).astype(np.float32)
    eps[0] = 0.0
    grads, losses = {}, {}
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
        if dev == 'cpu':         # the features' first ReLU input nearest 0
            with torch.no_grad():
                relu0_min = job.model.features_stack.conv_0(
                    xt.permute(0, 2, 3, 1).contiguous()).abs().min().item()
        step = make_train_step(job.model, job.opt_cfg)
        state, seq = job.state, []
        for _ in range(GATE_STEPS):
            state, m = step(state, xt, yt, eps=et)
            seq.append(m['total'].item())
        losses[dev] = seq
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
    np.testing.assert_allclose(losses['cuda'], losses['cpu'],
                               rtol=TRAIN_LOSS_RTOL, atol=0,
                               err_msg='card vs CPU train losses')
    return {'batch': GATE_BATCH, 'steps': GATE_STEPS,
            'grad_worst_err_over_abs_plus_rms': worst,
            'grad_beyond_strict_tol': loose,
            'conv_0_relu_input_nearest_zero': relu0_min,
            'losses_cuda': losses['cuda'], 'losses_cpu': losses['cpu'],
            'loss_worst_rel_err': max(abs(a - b) / abs(b) for a, b in
                                      zip(losses['cuda'], losses['cpu']))}


def train(card: str):
    """Phase 5: the full-width flagship trained through new_job,
    train_model, save_job and load_job; then timed steps, a profile and
    the card vs CPU gate."""
    from joint_vae_tpu_torch.data.loaders import ArrayDataset, DataLoader
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.ops.iws import iws_combine
    from joint_vae_tpu_torch.ops.same_grid_conv import (same_grid_conv,
                                                        same_grid_conv_dx)
    from joint_vae_tpu_torch.save_load.jobs import load_job, new_job, save_job
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.steps import make_train_step, pull_metrics
    from joint_vae_tpu_torch.train.trainer import to_device, train_model
    from joint_vae_tpu_torch.utils.print_log import EpochOutput

    cfg = flagship_config()
    rng = np.random.default_rng(7)
    n = TRAIN_BATCH * TRAIN_BATCHES + TRAIN_VALIDATION
    trainset = ArrayDataset(
        rng.uniform(0, 1, (n,) + cfg.input_shape).astype(np.float32),
        rng.integers(0, cfg.num_labels, n), 'synthetic')
    testset = ArrayDataset(
        rng.uniform(0, 1, (TRAIN_TEST,) + cfg.input_shape).astype(np.float32),
        rng.integers(0, cfg.num_labels, TRAIN_TEST), 'synthetic')
    job_dir = os.path.join(WORK, 'train_job')
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
    want = {'same_grid_conv': SITES_PER_BATCH * (TRAIN_BATCHES + eval_batches),
            'same_grid_conv_dx': DX_PER_STEP * TRAIN_BATCHES,
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
    if timed_launches != {'same_grid_conv': SITES_PER_BATCH * TRAIN_TIMED,
                          'same_grid_conv_dx': DX_PER_STEP * TRAIN_TIMED}:
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
    gate = train_gate(cfg)
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
    print('train', json.dumps(summary), flush=True)
    return launches, summary


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is false')
    from joint_vae_tpu_torch.device import set_float32_math
    from joint_vae_tpu_torch.models.cvnet import CVNet, flagship_config
    from joint_vae_tpu_torch.ops import cuda_lib

    set_float32_math()
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

    cfg = flagship_config()
    sites = same_grid_sites(CVNet(cfg), BATCH, cfg.test_latent_sampling)
    if len(sites) != SITES_PER_BATCH:
        raise AssertionError('{} same-grid sites'.format(len(sites)))
    conv_rows, conv = check_conv(sites)
    iws_rows, iws = check_iws()
    train_sites = same_grid_sites(CVNet(cfg), TRAIN_BATCH, cfg.latent_sampling)
    fwd_rows, dx_rows, dxt = check_train_conv(train_sites)
    library_rows = check_library_convs(CVNet(cfg), TRAIN_BATCH)
    os.makedirs(WORK, exist_ok=True)
    launches, launches128, summary = serve(card)
    train_launches, train_summary = train(card)

    kernels = [
        {'name': 'same_grid_conv', 'route': 'cuda',
         'source': 'joint_vae_tpu_torch/csrc/same_grid_conv.cu',
         'replaces': 'joint_vae_tpu/ops/pallas_conv.py:109',
         'launches': launches['same_grid_conv'],
         'launches_train': train_launches['same_grid_conv'],
         'max_abs_err': max(conv['max_abs_err'], dxt['fwd_max_abs_err']),
         'ms': conv['ms'], 'kernel_ms': conv['ms'],
         'train_step_ms': dxt['fwd_ms'],
         'plain_ms': conv['plain_ms'], 'bound_ms': conv['bound_ms'],
         'bound_by': 'bytes' if conv['t_bytes'] >= conv['t_ops'] else 'operations',
         'bound_ms_cuda_core': conv['bound_ms_cuda_core'],
         'library_ms': conv['library_ms'],
         'per': 'one serve batch: the eight float32 sites summed (bound at '
                'the 3xTF32 rate; library: F.conv2d, or F.conv_transpose2d '
                'of the true deconv at the sub-pixel sites); '
                'train_step_ms: the eight sites at the train step\'s shapes '
                '(batch 1024, L=1)',
         'sites': conv_rows, 'train_sites': fwd_rows},
        {'name': 'same_grid_conv_dx', 'route': 'cuda',
         'source': 'joint_vae_tpu_torch/csrc/same_grid_conv.cu',
         'replaces': 'joint_vae_tpu/ops/pallas_conv.py:109',
         'launches': train_launches['same_grid_conv_dx'],
         'max_abs_err': dxt['max_abs_err'],
         'ms': dxt['ms'], 'kernel_ms': dxt['ms'],
         'plain_ms': dxt['plain_ms'], 'bound_ms': dxt['bound_ms'],
         'bound_by': 'bytes' if dxt['t_bytes'] >= dxt['t_ops'] else 'operations',
         'library_ms': dxt['library_ms'],
         'library': 'torch.nn.grad.conv2d_input (cuDNN dgrad, float32)',
         'dw_ms': dxt['dw_ms'], 'dw_cudnn_ms': dxt['dw_cudnn_ms'],
         'dw_max_rel_err': dxt['dw_max_rel_err'],
         'dw_cudnn_max_rel_err': dxt['dw_cudnn_max_rel_err'],
         'per': 'one train step at batch 1024: the input gradient of the '
                'seven same-grid sites whose input needs one, the same '
                'kernel on the flipped, ci/co-swapped kernel (the TPU '
                'kernel\'s custom vjp leaves it to XLA, pallas_conv.py:'
                '164-170); bound at the 3xTF32 rate; dw: the weight '
                'gradient of the same sites as a float32 im2col product '
                '(not a port of a kernel), beside cuDNN\'s (dw_cudnn; '
                'errors relative to the float64 product\'s rms)',
         'sites': dx_rows},
        {'name': 'iws_combine', 'route': 'cuda',
         'source': 'joint_vae_tpu_torch/csrc/iws_combine.cu',
         'replaces': 'joint_vae_tpu/ops/pallas_kernels.py:99',
         'launches': launches['iws_combine'],
         'launches_l128': launches128['iws_combine'],
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
                      'train': train_summary,
                      'library_conv_grads': library_rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
