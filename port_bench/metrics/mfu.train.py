"""A training cell's model FLOPs utilization: a trained image's forward,
data-gradient and weight-gradient operations (``counts/flops.py``) times
the images of the traced window per second, over the float32 peak."""


def read(r):
    wl, cfg, tr, res = r['workload'], r['cfg'], r['trace'], r['result']
    if wl['entry'] != 'train' or tr['window_s'] <= 0:
        return None
    rate = res['images'] / tr['window_s']
    return (100.0 * r['flops'].train_flops_per_image(cfg) * rate
            / r['peaks'].FLOAT32_FLOPS)
