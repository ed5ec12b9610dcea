"""The IWAE combine's share of its roofline in a scoring cell: its least
time at the cell's (L, N, C, K) on the CUDA cores (``counts/flops.py``),
once a batch, over the summed device time of ``csrc/iws_combine.cu``'s
kernel records.  Nothing when the records do not number one a batch."""

import sys

from harness.trace import COMBINE_KERNELS, kernel_seconds


def read(r):
    wl, cfg, tr, res = r['workload'], r['cfg'], r['trace'], r['result']
    if wl['entry'] != 'score':
        return None
    units = res['batches']
    seconds, n = kernel_seconds(tr['kernels'], COMBINE_KERNELS)
    if n != units or seconds <= 0:
        print('combine_roofline.score: {} kernel records, {} expected'
              .format(n, units), file=sys.stderr)
        return None
    peaks = r['peaks']
    least = units * r['flops'].combine_least_s(
        wl['L'], wl['batch_size'], cfg['num_labels'], cfg['latent_dim'],
        peaks.CUDA_CORE_FLOAT32_FLOPS, peaks.HBM_BYTES_PER_S)
    return 100.0 * least / seconds
