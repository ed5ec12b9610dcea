"""Everything a run feeds the program and the reference, made from the
run's ``--seed``: the weights (on the card, with one generator, in one
draw for every kernel, dense weight and prior mean), the training set and
the scoring pool (drawn on the card, held on the host as the program's
users hold theirs), and the latent noise as the program draws it.

Imports only torch and numpy: the reference takes its inputs from here.
"""

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

M63 = (1 << 63) - 1


def derive(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each stream of one run's inputs."""
    z = (int(seed) + 0x9E3779B97F4A7C15 * (stream + 1)) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & M63


SEEDS = {'weights': 0, 'data': 1, 'loader': 2, 'noise': 3}


def seeds(seed: int) -> Dict[str, int]:
    return {k: derive(seed, v) for k, v in SEEDS.items()}


def weight_shapes(cfg: dict) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every parameter, in a fixed order;
    kind 'kernel' (a conv or deconv, (k, k, ci, co)), 'dense' ((out, in)),
    'bias', 'prior_mean', 'prior_var' or 'sigma'."""
    out = []

    def conv_stack(prefix, layers, c):
        for i, ly in enumerate(layers):
            if ly['type'] in ('conv', 'deconv'):
                k, co = ly['k'], ly['co']
                name = '{}.{}_{}'.format(prefix, ly['type'], i)
                out.append((name + '.weight', (k, k, c, co), 'kernel', k * k * c))
                out.append((name + '.bias', (co,), 'bias', 0))
                c = co

    def dense_chain(prefix, dims, d, names=None):
        for j, o in enumerate(dims):
            name = names[j] if names else '{}.dense_{}'.format(prefix, j)
            out.append((name + '.weight', (o, d), 'dense', d))
            out.append((name + '.bias', (o,), 'bias', 0))
            d = o
        return d

    if cfg['sigma']['learned']:
        out.append(('sigma_param', (1,), 'sigma', 0))
    conv_stack('features_stack', cfg['features_layers'], cfg['input_shape'][0])
    d = dense_chain('encoder.dense_projs', cfg['encoder'], _features_out(cfg))
    K, C = cfg['latent_dim'], cfg['num_labels']
    dense_chain(None, [K], d, ['encoder.dense_mean'])
    dense_chain(None, [K], d, ['encoder.dense_log_var'])
    dense_chain('decoder', cfg['decoder'], K)
    conv_stack('imager', cfg['imager_layers'], cfg['imager_input'][0])
    d = dense_chain('classifier', cfg['classifier'], K)
    dense_chain(None, [C], d, ['classifier.head'])
    out.append(('prior.mean', (C, K), 'prior_mean', 0))
    out.append(('prior.var_param', (C,), 'prior_var', 0))
    return out


def _features_out(cfg: dict) -> int:
    c, h, w = cfg['input_shape']
    for ly in cfg['features_layers']:
        k, s, p = ly.get('k', 1), ly.get('stride', 1), ly.get('pad', 0)
        h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        c = ly.get('co', c)
    return c * h * w


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Fresh weights as the reference project initialises them: lecun
    normal kernels and dense weights, zero biases, prior means
    ``init_mean`` times a standard normal, unit inverse scales, log sigma
    at the configured value; float32 on ``device``."""
    shapes = weight_shapes(cfg)
    drawn = [(n, s, kind, f) for n, s, kind, f in shapes
             if kind in ('kernel', 'dense', 'prior_mean')]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s, _, _ in drawn),
                       generator=g, device=device, dtype=torch.float32)
    W, at = {}, 0
    for name, shape, kind, fan_in in shapes:
        if kind in ('kernel', 'dense', 'prior_mean'):
            n = math.prod(shape)
            v = flat[at:at + n].reshape(shape)
            at += n
            scale = (float(cfg['prior']['init_mean']) if kind == 'prior_mean'
                     else 1.0 / math.sqrt(fan_in))
            W[name] = v * scale
        elif kind == 'prior_var':
            W[name] = torch.ones(shape, device=device)
        elif kind == 'sigma':
            W[name] = torch.full(shape, math.log(cfg['sigma']['value']),
                                 device=device)
        else:
            W[name] = torch.zeros(shape, device=device)
    return W


def make_train_set(cfg: dict, size: int, seed: int, device
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``size`` uint8 images (size, C, H, W) and labels over the classes,
    drawn on the card and held on the host."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, (size,) + tuple(cfg['input_shape']),
                      generator=g, device=device, dtype=torch.uint8)
    y = torch.randint(0, cfg['num_labels'], (size,), generator=g,
                      device=device, dtype=torch.int32)
    return x.cpu().numpy(), y.cpu().numpy()


def make_pool(cfg: dict, batches: int, batch_size: int, seed: int,
              device) -> np.ndarray:
    """``batches`` float32 host batches (batches, B, C, H, W) of images in
    [0, 1) to score."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((batches, batch_size) + tuple(cfg['input_shape']),
                   generator=g, device=device, dtype=torch.float32)
    return x.cpu().numpy()


def latent_noise(generator: torch.Generator, L: int, n: int, K: int,
                 device) -> torch.Tensor:
    """One draw of the program's latent noise: a standard normal (L+1, n,
    K) from ``generator``, its row 0 (the mean sample) zero."""
    eps = torch.randn((L + 1, n, K), generator=generator, device=device,
                      dtype=torch.float32)
    eps[0] = 0.0
    return eps
