"""The conv kernel's share of its roofline in a training cell: the least
time of every site's forward and data gradient over the traced steps
(``counts/flops.py``) over the summed device time of
``csrc/same_grid_conv.cu``'s kernel records.  Nothing when the records do
not number the launches the configuration's site list gives."""

import sys

from harness.trace import CONV_KERNELS, kernel_seconds


def read(r):
    wl, cfg, tr, res = r['workload'], r['cfg'], r['trace'], r['result']
    if wl['entry'] != 'train':
        return None
    B, L, units = wl['batch_size'], cfg['latent_sampling'], res['steps']
    f = r['flops']
    seconds, n = kernel_seconds(tr['kernels'], CONV_KERNELS)
    expect = units * (f.conv_launches(cfg, B, L)
                      + f.conv_launches(cfg, B, L, grad=True))
    if n != expect or seconds <= 0:
        print('conv_roofline.train: {} kernel records, {} launches expected'
              .format(n, expect), file=sys.stderr)
        return None
    peaks = r['peaks']
    least = units * sum(f.conv_least_s(cfg, B, L, peaks.FLOAT32_FLOPS,
                                       peaks.HBM_BYTES_PER_S, grad=g)
                        for g in (False, True))
    return 100.0 * least / seconds
