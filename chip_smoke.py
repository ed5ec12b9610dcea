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
5. print one JSON line ``{"kernels": [...]}``;
6. print ``{"ok": true, "device": {...}}`` as the last line.

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
    os.makedirs(WORK, exist_ok=True)
    launches, launches128, summary = serve(card)

    kernels = [
        {'name': 'same_grid_conv', 'route': 'cuda',
         'source': 'joint_vae_tpu_torch/csrc/same_grid_conv.cu',
         'replaces': 'joint_vae_tpu/ops/pallas_conv.py:109',
         'launches': launches['same_grid_conv'],
         'max_abs_err': conv['max_abs_err'],
         'ms': conv['ms'], 'kernel_ms': conv['ms'],
         'plain_ms': conv['plain_ms'], 'bound_ms': conv['bound_ms'],
         'bound_by': 'bytes' if conv['t_bytes'] >= conv['t_ops'] else 'operations',
         'bound_ms_cuda_core': conv['bound_ms_cuda_core'],
         'library_ms': conv['library_ms'],
         'per': 'one serve batch: the eight float32 sites summed (bound at '
                'the 3xTF32 rate; library: F.conv2d, or F.conv_transpose2d '
                'of the true deconv at the sub-pixel sites)',
         'sites': conv_rows},
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
    print(json.dumps({'kernels': kernels, 'serve': summary}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
