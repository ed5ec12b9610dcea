#!/usr/bin/env python3
"""Time the port's same-grid conv kernel of a tree at the flagship's (or
imagenet64's) shapes, on one CUDA card, beside cuDNN and the bound.

    python3 scripts/time_torch_conv.py --root DIR [--label NAME]
        [--geometry flagship|imagenet64]

DIR is the root of a checkout whose ``joint_vae_tpu_torch`` is imported
(this tree, or an earlier commit unpacked with ``git archive``); its
kernels build into DIR/build.  The sites, inputs, timers and bounds are
this tree's ``chip_smoke.py``'s.  Run it for two trees in one call on the
card (parent, change, change, parent) to compare them.

Cases (one ``conv_time`` JSON line each): every site of a float32 and a
bfloat16 serve batch (512 images, L=16); the forward at every site and
the input gradient at those that need one (all but conv_0, which reads
the data), at the train step's batch (L=1), in both dtypes; for the
flagship (the default), at a train batch of 1024, also ODIN's input
gradient at conv_0 (64 images, 32 -> 3) and the OOD evaluation's ragged
last batch (272 images) at every site in float32.  ``--geometry
imagenet64`` (``models/cvnet.py::imagenet64_config``, which DIR's port
must have) takes its 18 sites, the train step at 512 (``bench.py:57``).  Each line has the kernel's device ms (CUDA events,
calls back to back), cuDNN's ms for the same function (``F.conv2d``,
``F.conv_transpose2d`` of the true deconv at a sub-pixel serve site,
``torch.nn.grad.conv2d_input`` for an input gradient), the bound
(bytes over 3.35 TB/s or FLOPs over the type's tensor-core rate, 3xTF32
for float32; the CUDA cores' 67 TFLOP/s beside it in float32), the
share of the bound, the kernel that DIR's dispatch takes, and the error
against the plain version with whether it is within ``chip_smoke.py``'s
gate (reported, not enforced: an earlier kernel may miss it).  A
``conv_total`` line sums each group.
"""

import argparse
import importlib.util
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', required=True)
    ap.add_argument('--label', default=None)
    ap.add_argument('--geometry', default='flagship',
                    choices=['flagship', 'imagenet64'])
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    label = args.label or os.path.basename(root)
    sys.path.insert(0, root)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_timers', os.path.join(here, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit('time_torch_conv: no CUDA card')
    import joint_vae_tpu_torch.ops.same_grid_conv as sgc
    if not sgc.__file__.startswith(root + os.sep):
        raise SystemExit('imported {} outside {}'.format(sgc.__file__, root))
    from joint_vae_tpu_torch.device import set_float32_math
    from joint_vae_tpu_torch.models import cvnet
    from joint_vae_tpu_torch.models.cvnet import CVNet
    set_float32_math()
    flagship = args.geometry == 'flagship'
    if flagship:
        cfg, train_batch = cvnet.flagship_config(), cs.TRAIN_BATCH
    elif hasattr(cvnet, 'imagenet64_config'):
        cfg, train_batch = cvnet.imagenet64_config(), cs.IM64_BATCH
    else:
        raise SystemExit('{} has no imagenet64_config'.format(root))
    print(cs.card_line(), flush=True)

    def route(dt, ci, co):
        if hasattr(sgc, 'kernel_route'):
            return sgc.kernel_route(dt, ci, co)
        # a tree from before kernel_route: the mma.sync kernel's dispatch
        if dt == torch.float32 and co < 8:
            return {'kernel': 'simt', 'co_tile': 4}
        return {'kernel': 'mma.sync',
                'tile': [128, 64] if co > 32 else [256, 32] if co > 8
                else [128, 8]}

    totals = {}

    def report(group, site, dt, shape, fn, plain_fn, lib_fn, nbytes, flops,
               ci, co, reps):
        got = fn()
        want = plain_fn()
        torch.cuda.synchronize()
        tol = cs.CONV_TOL[dt]
        err = (got.float() - want.float()).abs()
        rms = want.float().square().mean().sqrt().item()
        within = bool((err <= tol * (want.float().abs() + rms)).all())
        ms = cs.time_ms(fn, reps)
        lib = cs.time_ms(lib_fn, reps)
        b, by = cs.bound_ms(nbytes, flops, cs.PEAK_FLOPS[dt])
        row = {'tree': label, 'geometry': args.geometry, 'group': group,
               'site': site,
               'dtype': str(dt).split('.')[-1], 'launched_shape': shape,
               'ms': ms, 'cudnn_ms': lib, 'bound_ms': b, 'bound_by': by,
               'share_of_bound': b / ms, 'kernel': route(dt, ci, co),
               'max_abs_err': err.max().item(), 'within_gate': within}
        if dt == torch.float32:
            row['bound_ms_cuda_core'] = max(
                nbytes / cs.HBM_BYTES_PER_S, flops / cs.CUDA_CORE_FLOPS) * 1e3
        print('conv_time', json.dumps(row), flush=True)
        t = totals.setdefault(group, {'tree': label,
                                      'geometry': args.geometry,
                                      'group': group, 'ms': 0.0,
                                      'cudnn_ms': 0.0, 'bound_ms': 0.0,
                                      'sites': 0, 'within_gate': True})
        t['ms'] += ms
        t['cudnn_ms'] += lib
        t['bound_ms'] += b
        t['sites'] += 1
        t['within_gate'] = t['within_gate'] and within
        del got, want

    g = torch.Generator(device='cuda').manual_seed(1)
    # a serve batch, both dtypes; the flagship's ragged tail in float32
    both = (torch.float32, torch.bfloat16)
    groups = [('serve', cs.BATCH, both)]
    if flagship:
        groups.append(('tail', cs.OOD_SET_SIZE % cs.OOD_BATCH,
                       (torch.float32,)))
    for group, n_img, dts in groups:
        for site in cs.same_grid_sites(CVNet(cfg), n_img,
                                       cfg.test_latent_sampling):
            lo, lay = site['lo'], site['layer']
            for dt in dts:
                x, kern, kd = cs.site_inputs(site, dt, g)
                n, h, w, ci = x.shape
                th, tw, _, co = kd.shape
                xc = x.permute(0, 3, 1, 2)
                if site['route'] == 'subpixel':
                    wc = torch.flip(kern, (0, 1)).permute(2, 3, 0, 1)
                    lib = (lambda xc=xc, wc=wc, lay=lay: F.conv_transpose2d(
                        xc, wc, stride=lay.stride, padding=lay.padding,
                        output_padding=lay.output_padding))
                else:
                    wc = kern.permute(3, 2, 0, 1)
                    lib = (lambda xc=xc, wc=wc, lo=lo:
                           F.conv2d(xc, wc, padding=lo))
                es = x.element_size()
                report('{}_{}'.format(group, str(dt).split('.')[-1]),
                       site['site'], dt, [n, h, w, ci, co, th, tw],
                       lambda: sgc.same_grid_conv(x, kd, lo, lo),
                       lambda: sgc.same_grid_conv_plain(x, kd, lo, lo), lib,
                       (x.numel() + kd.numel() + n * h * w * co) * es,
                       2.0 * n * h * w * th * tw * ci * co, ci, co,
                       20 if n * h * w < 2 ** 20 else 5)
                del x, kern, kd, xc, wc
                torch.cuda.empty_cache()

    # the train step: forward at every site, dx at all but conv_0
    g = torch.Generator(device='cuda').manual_seed(3)
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split('.')[-1]
        sites = cs.same_grid_sites(CVNet(cfg), train_batch,
                                   cfg.latent_sampling)
        for j, site in enumerate(sites):
            lo = site['lo']
            x, _, kd = cs.site_inputs(site, dt, g)
            n, h, w, ci = x.shape
            th, tw, _, co = kd.shape
            es = x.element_size()
            xc, wk = x.permute(0, 3, 1, 2), kd.permute(3, 2, 0, 1)
            report('train_fwd_' + tag, site['site'], dt,
                   [n, h, w, ci, co, th, tw],
                   lambda: sgc.same_grid_conv(x, kd, lo, lo),
                   lambda: sgc.same_grid_conv_plain(x, kd, lo, lo),
                   lambda: F.conv2d(xc, wk, padding=lo),
                   (x.numel() + kd.numel() + n * h * w * co) * es,
                   2.0 * n * h * w * th * tw * ci * co, ci, co, 10)
            if j > 0:                    # conv_0 reads the data: no dx
                gr = (0.05 * torch.randn((n, h, w, co), generator=g,
                                         device='cuda')).to(dt)
                wc = kd.permute(3, 2, 0, 1).contiguous()
                gc = gr.permute(0, 3, 1, 2)
                report('train_dx_' + tag, site['site'], dt,
                       [n, h, w, co, ci, th, tw],
                       lambda: sgc.same_grid_conv_dx(gr, kd, lo, lo),
                       lambda: sgc.same_grid_conv_dx_plain(gr, kd, lo, lo),
                       lambda: torch.nn.grad.conv2d_input(
                           (n, ci, h, w), wc, gc, padding=lo),
                       (gr.numel() + kd.numel() + x.numel()) * es,
                       2.0 * n * h * w * th * tw * ci * co, co, ci, 10)
                del gr, wc, gc
            del x, kd, xc, wk
            torch.cuda.empty_cache()

    if flagship:
        odin_dx(cs, sgc, cfg, CVNet, g, report)
    for t in totals.values():
        t['share_of_bound'] = t['bound_ms'] / t['ms']
        print('conv_total', json.dumps(t), flush=True)


def odin_dx(cs, sgc, cfg, CVNet, g, report):
    """ODIN's input gradient at the flagship's conv_0: 64 images, 32 -> 3
    channels."""
    import torch
    site = cs.same_grid_sites(CVNet(cfg), cs.ODIN_BATCH, 1)[0]
    lo = site['lo']
    _, _, k0 = cs.site_inputs(site, torch.float32, g)
    n, h, w = cs.ODIN_BATCH, site['h'], site['w']
    ci, co = site['ci'], site['co']
    th, tw = k0.shape[:2]
    gr = 0.05 * torch.randn((n, h, w, co), generator=g, device='cuda')
    wc, gc = k0.permute(3, 2, 0, 1).contiguous(), gr.permute(0, 3, 1, 2)
    report('odin_dx_float32', site['site'], torch.float32,
           [n, h, w, co, ci, th, tw],
           lambda: sgc.same_grid_conv_dx(gr, k0, lo, lo),
           lambda: sgc.same_grid_conv_dx_plain(gr, k0, lo, lo),
           lambda: torch.nn.grad.conv2d_input((n, ci, h, w), wc, gc,
                                              padding=lo),
           4.0 * (gr.numel() + k0.numel() + n * h * w * ci),
           2.0 * n * h * w * th * tw * ci * co, co, ci, 20)


if __name__ == '__main__':
    main()
