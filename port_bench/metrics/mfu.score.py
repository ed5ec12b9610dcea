"""A scoring cell's model FLOPs utilization: a scored image's operations
at the cell's L (``counts/flops.py``: the encoder once, the decoder on L
samples) times the images of the traced window per second, over the
float32 peak."""


def read(r):
    wl, cfg, tr, res = r['workload'], r['cfg'], r['trace'], r['result']
    if wl['entry'] != 'score' or tr['window_s'] <= 0:
        return None
    per_image = r['flops'].score_flops_per_image(cfg, wl['L'])
    rate = res['images'] / tr['window_s']
    return 100.0 * per_image * rate / r['peaks'].FLOAT32_FLOPS
