"""Serving CLI: score inputs with a trained job's classify + OOD-gate
Scorer (``serve.py``), on the CUDA card unless ``--device cpu``.

    python -m joint_vae_tpu_torch.cli.serve path/to/jobdir x.npy [--methods elbo iws]
    python -m joint_vae_tpu_torch.cli.serve path/to/jobdir images_dir/ --device cpu

Inputs: .npy/.npz arrays ((N, C, H, W) float [0, 1] or uint8), image files
and directories of images (decoded with PIL, imported only then).  One
JSON line per input on stdout (or --output FILE): input name, label,
confidence, per-method scores and the accept bit; a final summary line
reports the reject rate, and exit status 3 flags a reject rate above
--max-reject-rate.  The job is a job directory; lookup by job number
comes with the job-store port.
"""

import argparse
import json
import logging
import os
import sys
from typing import List, Tuple

import numpy as np

IMG_EXTS = ('.jpg', '.jpeg', '.png', '.bmp')


def _decode_one(path: str, shape) -> np.ndarray:
    """Decode + resize one image to (C, H, W) uint8."""
    from PIL import Image
    c, h, w = shape
    img = Image.open(path).convert('RGB' if c == 3 else 'L').resize((w, h))
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return arr


def _load_inputs(paths, shape) -> Tuple[np.ndarray, List[str]]:
    """-> (x (N, C, H, W) float32 in [0, 1], per-row source names)."""
    xs, names = [], []

    def add_array(a, name):
        a = np.asarray(a)
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / 255.0
        a = a.astype(np.float32)
        if a.ndim == len(shape):
            a = a[None]
        if a.shape[1:] != tuple(shape):
            raise SystemExit('{}: shape {} != model input {}'.format(
                name, a.shape[1:], tuple(shape)))
        for i in range(a.shape[0]):
            xs.append(a[i])
            names.append('{}[{}]'.format(name, i) if a.shape[0] > 1 else name)

    def add_image(p):
        xs.append(_decode_one(p, shape).astype(np.float32) / 255.0)
        names.append(p)

    for p in paths:
        if os.path.isdir(p):
            found = 0
            for dirpath, _, files in sorted(os.walk(p)):
                for f in sorted(files):
                    if f.lower().endswith(IMG_EXTS):
                        add_image(os.path.join(dirpath, f))
                        found += 1
            if not found:
                raise SystemExit('no images under {}'.format(p))
        elif p.endswith('.npy'):
            add_array(np.load(p), p)
        elif p.endswith('.npz'):
            with np.load(p) as z:
                for k in z.files:
                    add_array(z[k], '{}:{}'.format(p, k))
        elif p.lower().endswith(IMG_EXTS):
            add_image(p)
        else:
            raise SystemExit('unsupported input {}'.format(p))
    if not xs:
        raise SystemExit('no inputs')
    return np.stack(xs), names


def main(argv=None):
    p = argparse.ArgumentParser(prog='jvt-torch-serve')
    p.add_argument('job', help='job directory path')
    p.add_argument('inputs', nargs='+',
                   help='image files, image directories, .npy/.npz arrays')
    p.add_argument('--job-dir', '-J', default='jobs',
                   help='job store root (job-number lookup is not ported yet)')
    p.add_argument('--methods', nargs='*', default=None,
                   help='OOD gate methods (default: the first stored-result '
                        "method, else the type's first ood method)")
    p.add_argument('--predict-method', default='default')
    p.add_argument('--tpr', type=float, default=0.95,
                   help='calibration operating point (kept-TPR grid of '
                        'ood.json, 0.90-0.99)')
    p.add_argument('--latent-samples', '-L', type=int, default=None,
                   help='override eval latent sampling (compute knob)')
    p.add_argument('--batch-size', type=int, default=128,
                   help='batch bucket; the tail is zero-padded to it')
    p.add_argument('--max-reject-rate', type=float, default=1.0,
                   help='exit 3 when the rejected fraction exceeds this')
    p.add_argument('--output', '-o', default='-',
                   help='write JSON lines here instead of stdout')
    p.add_argument('--summary-only', action='store_true',
                   help='print only the summary line')
    p.add_argument('--device', default=None,
                   help="torch device: default the CUDA card; 'cpu' on request")
    p.add_argument('-v', '--verbose', action='count', default=0)
    p.add_argument('--debug', action='store_true')
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else
                        logging.INFO if args.verbose else logging.WARNING)

    from ..save_load.jobs import load_job
    from ..serve import Scorer
    if not os.path.isdir(args.job):
        raise SystemExit('{} is not a job directory (job-number lookup under '
                         '--job-dir is not ported yet)'.format(args.job))
    job = load_job(args.job, device=args.device)

    cfg = job.model_cfg
    methods = args.methods
    if not methods:
        stored = [m for e in sorted((e for e in job.ood_results
                                     if isinstance(e, int)), reverse=True)
                  for ms in job.ood_results[e].values() for m in ms]
        methods = ([stored[0]] if stored
                   else list(cfg.ood_methods[:1]) or ['elbo'])
        logging.info('gate methods: %s', methods)

    scorer = Scorer(job, predict_method=args.predict_method,
                    methods=methods, tpr=args.tpr, L=args.latent_samples)
    for m, thr in scorer.thresholds.items():
        lo = thr[0] if isinstance(thr, (tuple, list)) else thr
        if not np.isfinite(lo):
            logging.warning('no stored ood results calibrate %r at tpr '
                            '%.2f: the gate accepts everything', m, args.tpr)

    x, names = _load_inputs(args.inputs, cfg.input_shape)
    out_f = sys.stdout if args.output == '-' else open(args.output, 'w')
    n = len(x)
    bs = max(1, args.batch_size)
    rejected = 0
    try:
        for lo_i in range(0, n, bs):
            xb = x[lo_i:lo_i + bs]
            pad = bs - len(xb)
            if pad:
                xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:],
                                                  xb.dtype)])
            out = scorer(xb)
            for j in range(min(bs, n - lo_i)):
                label = int(out['label'][j])
                ind = bool(out['in_distribution'][j])
                rejected += not ind
                if not args.summary_only:
                    rec = {'input': names[lo_i + j], 'label': label,
                           'confidence': round(float(out['confidence'][j]), 6),
                           'scores': {m: round(float(out['scores'][m][j]), 6)
                                      for m in methods},
                           'in_distribution': ind}
                    out_f.write(json.dumps(rec) + '\n')
        rate = rejected / n
        out_f.write(json.dumps({
            'summary': True, 'n': n, 'rejected': rejected,
            'reject_rate': round(rate, 6), 'tpr': args.tpr,
            'methods': list(methods)}) + '\n')
    finally:
        if out_f is not sys.stdout:
            out_f.close()
    if rate > args.max_reject_rate:
        logging.error('reject rate %.1f%% exceeds --max-reject-rate %.1f%%',
                      100 * rate, 100 * args.max_reject_rate)
        return 3
    return 0


if __name__ == '__main__':
    sys.exit(main())
