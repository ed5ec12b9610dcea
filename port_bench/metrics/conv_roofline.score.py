"""The conv kernel's share of its roofline in a scoring cell: the least
time of every same-grid and sub-pixel site of the traced batches (the
features' on the batch, the decoder's on its L samples of each image;
``counts/flops.py``) over the summed device time of
``csrc/same_grid_conv.cu``'s kernel records.  Nothing when the records do
not number the launches the configuration's site list gives."""

import sys

from harness.trace import CONV_KERNELS, kernel_seconds


def read(r):
    wl, cfg, tr, res = r['workload'], r['cfg'], r['trace'], r['result']
    if wl['entry'] != 'score':
        return None
    B, L, units = wl['batch_size'], wl['L'], res['batches']
    seconds, n = kernel_seconds(tr['kernels'], CONV_KERNELS)
    expect = r['flops'].conv_launches(cfg, B, L) * units
    if n != expect or seconds <= 0:
        print('conv_roofline.score: {} kernel records, {} launches expected'
              .format(n, expect), file=sys.stderr)
        return None
    peaks = r['peaks']
    least = units * r['flops'].conv_least_s(cfg, B, L, peaks.FLOAT32_FLOPS,
                                            peaks.HBM_BYTES_PER_S)
    return 100.0 * least / seconds
