"""Operations and bytes of the benchmark's work, counted from the
configuration files alone (``port_bench/configs/<name>.json``), never
through the program's model: a roofline then reads the same work whatever
implements it.

Conventions (one NVIDIA H100 SXM, ``harness/peaks.py``):

- a conv or deconv does 2 k^2 ci co operations per input pixel of a
  deconv and per output pixel of a conv (its true work: a lowering that
  pads the work, as the sub-pixel form of a strided deconv does, counts
  no more);
- each input byte is read once and each output byte written once;
- a site's least time is the larger of bytes / HBM bandwidth and
  operations / the dtype's peak.
"""

from typing import Dict, List, Tuple

F32_BYTES = 4
# the conv kernel's int32 shapes: one launch per range of images whose x
# and y stay within this many elements
MAX_ELEMS = 2 ** 31 - 1


def stack_shapes(input_shape, layers) -> List[Tuple[tuple, tuple]]:
    """[(in (c, h, w), out (c, h, w))] of each layer of a stack."""
    out = []
    c, h, w = input_shape
    for ly in layers:
        t, k = ly['type'], ly.get('k', 1)
        s, p = ly.get('stride', 1), ly.get('pad', 0)
        if t == 'conv':
            oc, oh, ow = ly['co'], (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        elif t == 'deconv':
            op = ly.get('output_pad', 0)
            oc = ly['co']
            oh, ow = (h - 1) * s - 2 * p + k + op, (w - 1) * s - 2 * p + k + op
        elif t in ('maxpool', 'avgpool'):
            oc, oh, ow = c, (h - k) // s + 1, (w - k) // s + 1
        else:
            raise ValueError('unknown layer type {}'.format(t))
        out.append(((c, h, w), (oc, oh, ow)))
        c, h, w = oc, oh, ow
    return out


def layer_flops(ly: dict, shape_in, shape_out) -> float:
    """Operations of one image through a conv or deconv layer (0 for
    pooling)."""
    if ly['type'] == 'conv':
        _, oh, ow = shape_out
        return 2.0 * oh * ow * ly['k'] ** 2 * shape_in[0] * ly['co']
    if ly['type'] == 'deconv':
        _, h, w = shape_in
        return 2.0 * h * w * ly['k'] ** 2 * shape_in[0] * ly['co']
    return 0.0


def dense_flops(dims: List[int]) -> float:
    """2 x in x out per layer of the chain ``dims``."""
    return sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))


def _stacks(cfg: dict):
    feat = stack_shapes(cfg['input_shape'], cfg['features_layers'])
    img = stack_shapes(cfg['imager_input'], cfg['imager_layers'])
    return feat, img


def forward_flops_per_image(cfg: dict, samples: int) -> Dict[str, float]:
    """Operations of one input image's forward pass, its decoder on
    ``samples`` latent samples, by part: the features' convs, the encoder
    and its heads, the decoder's dense layers and imager, the classifier
    on ``samples`` + 1 samples (the mean one too)."""
    feat, img = _stacks(cfg)
    f_feat = sum(layer_flops(ly, i, o)
                 for ly, (i, o) in zip(cfg['features_layers'], feat))
    c, h, w = feat[-1][1]
    d_feat = c * h * w
    K = cfg['latent_dim']
    enc = dense_flops([d_feat] + list(cfg['encoder']))
    u = (list(cfg['encoder']) or [d_feat])[-1]
    heads = 2 * dense_flops([u, K])
    dec = dense_flops([K] + list(cfg['decoder']))
    f_img = sum(layer_flops(ly, i, o)
                for ly, (i, o) in zip(cfg['imager_layers'], img))
    clf = dense_flops([K] + list(cfg['classifier']) + [cfg['num_labels']])
    return {'features': f_feat, 'encoder': enc + heads,
            'decoder': samples * (dec + f_img),
            'classifier': (samples + 1) * clf}


def score_flops_per_image(cfg: dict, L: int) -> float:
    """A scored image's model operations: the forward at test L."""
    return sum(forward_flops_per_image(cfg, L).values())


def train_flops_per_image(cfg: dict) -> float:
    """A trained image's model operations: the forward at the training
    L, and its backward, a data gradient and a weight gradient of the
    forward's size for every layer but the first layer's data gradient
    (its input is the data)."""
    fwd = forward_flops_per_image(cfg, cfg['latent_sampling'])
    feat, _ = _stacks(cfg)
    first = layer_flops(cfg['features_layers'][0], *feat[0])
    return 3.0 * sum(fwd.values()) - first


def site_shapes(cfg: dict, site: dict, n_images: int, L: int) -> dict:
    """One conv-kernel site of ``cfg['conv_sites']`` at a batch of
    ``n_images`` inputs and ``L`` decoded samples each: its batch n, input
    grid, channels and kernel."""
    stack = site['stack']
    feat, img = _stacks(cfg)
    shapes = feat if stack == 'features' else img
    ly = (cfg['features_layers'] if stack == 'features'
          else cfg['imager_layers'])[site['layer']]
    (ci, h, w), (co, oh, ow) = shapes[site['layer']]
    n = n_images if stack == 'features' else n_images * L
    return {'n': n, 'h': h, 'w': w, 'ci': ci, 'co': co, 'oh': oh, 'ow': ow,
            'k': ly['k'], 'stride': ly.get('stride', 1),
            'route': site['route']}


def site_work(sh: dict) -> Tuple[float, float]:
    """(operations, bytes) of a site's forward in float32; its data
    gradient (dy in, dx out) does the same work on as many bytes."""
    n, h, w, ci, co, k = (sh[x] for x in ('n', 'h', 'w', 'ci', 'co', 'k'))
    flops = 2.0 * n * h * w * k * k * ci * co
    x_el = n * h * w * ci
    y_el = n * sh['oh'] * sh['ow'] * co
    nbytes = F32_BYTES * (x_el + k * k * ci * co + y_el)
    return flops, nbytes


def site_launches(sh: dict) -> int:
    """Launches of the conv kernel at a site, forward or data gradient:
    one per range of images whose launched x and y stay within the
    kernel's int32 shapes (a sub-pixel site's y packs its stride^2 output
    phases on the input grid)."""
    per_image = sh['h'] * sh['w'] * max(sh['ci'], sh['co'] * sh['stride'] ** 2)
    step = MAX_ELEMS // per_image
    return -(-sh['n'] // step)


def conv_least_s(cfg: dict, n_images: int, L: int, peak_flops: float,
                 hbm_bytes_per_s: float, grad: bool = False) -> float:
    """The least seconds of every conv-kernel site of one forward (or
    with ``grad`` of every data gradient: each site but one reading the
    data) at a batch of ``n_images`` and ``L`` samples."""
    total = 0.0
    for site in cfg['conv_sites']:
        if grad and not site['dx']:
            continue
        fl, by = site_work(site_shapes(cfg, site, n_images, L))
        total += max(fl / peak_flops, by / hbm_bytes_per_s)
    return total


def conv_launches(cfg: dict, n_images: int, L: int,
                  grad: bool = False) -> int:
    """The conv kernel's launches of one forward (or data gradient)."""
    return sum(site_launches(site_shapes(cfg, s, n_images, L))
               for s in cfg['conv_sites'] if s['dx'] or not grad)


def combine_work(L: int, N: int, C: int, K: int) -> Tuple[float, float]:
    """(operations, bytes) of the IWAE combine: 3 L C N K operations (a
    difference, a square and a sum per latent dimension, class and
    sample), z (L, N, K), the log-weights (L, N), the means (C, K), the
    two per-class scalars read and iws (C, N) written."""
    flops = 3.0 * L * C * N * K
    nbytes = F32_BYTES * (L * N * K + L * N + C * K + 2 * C + C * N)
    return flops, nbytes


def combine_least_s(L: int, N: int, C: int, K: int, peak_flops: float,
                    hbm_bytes_per_s: float) -> float:
    fl, by = combine_work(L, N, C, K)
    return max(fl / peak_flops, by / hbm_bytes_per_s)


def param_count(cfg: dict) -> int:
    """Parameters of the model the configuration describes."""
    feat, img = _stacks(cfg)
    n = 0
    for ly, ((ci, _, _), _) in list(zip(cfg['features_layers'], feat)) + list(
            zip(cfg['imager_layers'], img)):
        if ly['type'] in ('conv', 'deconv'):
            n += ly['k'] ** 2 * ci * ly['co'] + ly['co']
    c, h, w = feat[-1][1]
    K, C = cfg['latent_dim'], cfg['num_labels']

    def dense(dims):
        return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    n += dense([c * h * w] + list(cfg['encoder']))
    u = (list(cfg['encoder']) or [c * h * w])[-1]
    n += 2 * dense([u, K])
    n += dense([K] + list(cfg['decoder']))
    n += dense([K] + list(cfg['classifier']) + [C])
    n += C * K + C                     # prior means and inverse scales
    if cfg['sigma']['learned']:
        n += 1
    return n
