"""The benchmark's plain reference held to ``joint_vae_tpu_torch`` on the
CPU, at narrowed twins of both configurations (every conv width, dense
width and latent size over 8, the layer structure, 32x32 inputs and the
priors kept; test L 4) on the same weights: the Scorer's outputs, and
the trainer's entry up to its first pull (the mean loss pulled there,
the first gradient as Adam takes it, the weights after three steps).  A
disagreement on the card is then the program's, not the reference's.
"""

import copy
import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(0, os.path.dirname(BENCH))

from harness import compare, inputs, program  # noqa: E402
from entries import train as train_entry      # noqa: E402
from reference import model as ref            # noqa: E402
from reference import loader as ref_loader    # noqa: E402
from reference import steps as ref_steps      # noqa: E402

METHODS = ('iws', 'elbo', 'zdist', 'mse', 'soft', 'iws-2s', 'elbo-2s')


def load_config(name: str) -> dict:
    with open(os.path.join(BENCH, 'configs', name + '.json')) as f:
        return json.load(f)


def _token(ly: dict, last_conv_in_deconv: bool) -> str:
    t = ly['type']
    if t in ('maxpool', 'avgpool'):
        return '{}x{}:{}'.format('M' if t == 'maxpool' else 'A', ly['k'],
                                 ly['stride'])
    if last_conv_in_deconv:
        return '!{}x{}+{}'.format(ly['co'], ly['k'], ly['pad'])
    s = '{}x{}+{}:{}'.format(ly['co'], ly['k'], ly['pad'], ly['stride'])
    if t == 'deconv' and ly.get('output_pad'):
        s += '++{}'.format(ly['output_pad'])
    return s


def twin(cfg: dict, div: int = 8, test_L: int = 4) -> dict:
    """The configuration with every width over ``div`` (the 3-channel
    output conv kept), its layer lists rendered back to the program's
    conv-string grammar."""
    t = copy.deepcopy(cfg)
    last = len(t['imager_layers']) - 1
    for key in ('features_layers', 'imager_layers'):
        for i, ly in enumerate(t[key]):
            if 'co' in ly and not (key == 'imager_layers' and i == last):
                ly['co'] = max(ly['co'] // div, 2)
    for key in ('encoder', 'decoder', 'classifier'):
        t[key] = [d // div for d in t[key]]
    t['latent_dim'] //= div
    t['test_latent_sampling'] = test_L
    t['features'] = '-'.join(_token(ly, False) for ly in t['features_layers'])
    t['upsampler'] = '-'.join(
        _token(ly, i == last and ly['type'] == 'conv')
        for i, ly in enumerate(t['imager_layers']))
    d = (t['decoder'] or [t['latent_dim']])[-1]
    t['imager_input'] = [d, 1, 1]
    return t


@pytest.fixture(params=['cifar100', 'cifar10-vgg'])
def config(request):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return twin(load_config(request.param))


def test_twin_builds_the_layers_it_lists(config):
    """The program's model of a twin has the layer lists' parameters."""
    job = program.build_job(config, inputs.make_weights(config, 1, 'cpu'),
                            'cpu', 2)
    names = {n: tuple(s) for n, s, _, _ in inputs.weight_shapes(config)}
    got = program.canonical_params(job)
    assert {n: tuple(v.shape) for n, v in got.items()} == names


def test_scorer_against_reference(config):
    seed = 2 ** 31 + 11
    s = inputs.seeds(seed)
    W = inputs.make_weights(config, s['weights'], 'cpu')
    job = program.build_job(config, W, 'cpu', s['noise'])
    L, K, B = config['test_latent_sampling'], config['latent_dim'], 24
    x = inputs.make_pool(config, 1, B, s['data'], 'cpu')[0]
    probe = program.Scorer(job, methods=METHODS, L=L, graphed=False,
                           thresholds={m: float('-inf') for m in METHODS})
    thr = compare.thresholds_from(probe(x)['scores'])
    scorer = program.Scorer(job, methods=METHODS, L=L, thresholds=thr)
    got = scorer(x)
    eps = inputs.latent_noise(torch.Generator('cpu').manual_seed(0), L, B,
                              K, 'cpu')
    want = ref.score_batch(W, config, torch.from_numpy(x), eps, METHODS)
    gaps = compare.score_gaps(got, want, thr)
    assert gaps['answer_gap'] < 1e-5, gaps


def test_train_steps_against_reference(config):
    seed = 977
    s = inputs.seeds(seed)
    W = inputs.make_weights(config, s['weights'], 'cpu')
    job = program.build_job(config, W, 'cpu', s['noise'])
    B, n, pull = 16, 64, 4
    x, y = inputs.make_train_set(config, n, s['data'], 'cpu')
    win = train_entry.train_window(job, program.ArrayDataset(x, y, 'twin'),
                                   config, B, s['loader'], 0.0,
                                   metrics_every=pull)
    got = win.compared()
    assert got['steps'] == pull
    flip, crop = ref_loader.augmentation(config['data_augmentation'],
                                         config['input_shape'][1])
    batches = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in
               ref_loader.epoch_batches(x, y, B, s['loader'], 0, pull, flip,
                                        crop)]
    g = torch.Generator('cpu').manual_seed(s['noise'])
    noise = [inputs.latent_noise(g, config['latent_sampling'], B,
                                 config['latent_dim'], 'cpu')
             for _ in range(pull)]
    want = ref_steps.adam_steps(W, config, batches, noise,
                                after_step=compare.COMPARED_STEPS)
    leaves = {}
    gaps = compare.train_gaps(got, want, W, leaves)
    assert gaps['loss_gap'] < 1e-5, gaps
    assert gaps['grad_gap'] < 1e-5, gaps
    assert max(leaves['update'].values()) < 1e-5, gaps
