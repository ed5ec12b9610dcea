"""The export cases shared by ``test_torch_export_reference.py`` and
``test_torch_export_trunks.py``: each writes one job directory with the
port (random BatchNorm statistics, random optimizer moments, results,
record files, as the case asks), exports it to the stub reference
checkout (``torch_reference_stub.py``) with the JAX package's exporter
and with the port's, and imports the port's export back with both
importers (once per process).  The checks:

- ``check_files``: the two exports hold the same files; JSON files equal
  as parsed objects, ``.pth`` files equal as loaded (keys and their
  order, dtypes, shapes and bits of every tensor, every other value);
- ``check_round_trip``: import(export(job)) through either importer gives
  the source's parameters, BatchNorm statistics, sigma, optimizer
  moments and counts bit for bit, its record files' ``.jvr`` bytes and
  its sample files' arrays; a WIM or Poscod job's moments do not come
  back through either importer (``state.pth`` holds parameters that
  ``optimizer.pth`` does not index).
"""

import json
import os
import sys
import types

import numpy as np
import torch

from joint_vae_tpu.models.cvnet import CVNetConfig as JCVNetConfig
from joint_vae_tpu.ops.priors import build_prior_config
from joint_vae_tpu.ops.sigma import SigmaConfig as JSigmaConfig
from joint_vae_tpu.save_load import export_reference as jexp
from joint_vae_tpu.save_load import import_reference as jimp

from joint_vae_tpu_torch.save_load import export_reference as texp
from joint_vae_tpu_torch.save_load import import_reference as timp
from joint_vae_tpu_torch.save_load.from_jax import (jax_to_opt_state,
                                                    opt_state_to_jax)
from joint_vae_tpu_torch.save_load.jobs import new_job, save_job
from joint_vae_tpu_torch.save_load.recorders import (LossRecorder,
                                                     SampleRecorder)
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig

from torch_port_util import port_cfg
from torch_reference_stub import stub_checkout

IN_SHAPE = (1, 8, 8)
C, K = 4, 6
EPOCHS = 2


def conv_cfg(**kw):
    """The JAX export test's conv case: conv + BatchNorm features and
    imager, learned sigma, a conditional tilted prior."""
    args = dict(input_shape=IN_SHAPE, num_labels=C, type='cvae',
                features='8x3+1:2-16x3+1', upsampler='4x8+0-!1x3+1',
                batch_norm='both', encoder=(16, 16), latent_dim=K,
                decoder=(16,), classifier=(8,), latent_sampling=1,
                test_latent_sampling=3, beta=0.0, gamma=10.,
                output_activation='sigmoid',
                sigma=JSigmaConfig(learned=True, value=0.5),
                prior=build_prior_config(K, 'tilted', num_priors=C, tau=5.,
                                         init_mean=1.0, learned_means=True))
    args.update(kw)
    return JCVNetConfig(**args)


def mlp_cfg(type_, **kw):
    """The JAX export test's featureless cases."""
    args = dict(input_shape=IN_SHAPE, num_labels=C, type=type_,
                features=None, upsampler=None, encoder=(16,), latent_dim=K,
                decoder=(16,), classifier=(8,), latent_sampling=1,
                test_latent_sampling=3, beta=0.0,
                sigma=JSigmaConfig(value=0.5), output_activation='sigmoid')
    args.update(kw)
    return JCVNetConfig(**args)


def trunk_cfg(features):
    return JCVNetConfig(
        input_shape=(3, 32, 32), num_labels=C, type='cvae', features=features,
        encoder=(16,), decoder=(16,), classifier=(8,), latent_dim=K,
        latent_sampling=1, test_latent_sampling=2, gamma=10.0, beta=1e-2,
        sigma=JSigmaConfig(value=0.5),
        prior=build_prior_config(K, 'gaussian', num_priors=C, init_mean=1.0,
                                 learned_means=True))


ADAM = OptimizerConfig(lr=1e-3)
SGD = OptimizerConfig(optim_type='sgd', lr=0.01, momentum=0.9)
WIM = {'dim': K, 'distribution': 'gaussian', 'num_priors': 1,
       'init_mean': 3.0, 'seed': 5, 'sets': ['fashion'], 'mix': 0.5,
       'padding_dataset': None}

# name: (config, optimizer, options)
CASES = {
    'cvae_conv_records': (conv_cfg, ADAM, {'records': True}),
    'cvae_conv_sgd_momentum': (conv_cfg, SGD, {}),
    'cvae_conv_bf16': (lambda: conv_cfg(compute_dtype='bfloat16'), ADAM, {}),
    'cvae_conv_fresh_adam': (conv_cfg, ADAM, {'fresh_optimizer': True,
                                              'sentinels': True}),
    'vae': (lambda: mlp_cfg('vae', gamma=0., classifier=(),
                            prior=build_prior_config(K, 'gaussian')),
            ADAM, {}),
    'jvae': (lambda: mlp_cfg('jvae', gamma=1., y_is_coded=True,
                             prior=build_prior_config(K, 'gaussian')),
             ADAM, {}),
    'xvae': (lambda: mlp_cfg('xvae', gamma=0., y_is_coded=True,
                             classifier=(),
                             prior=build_prior_config(
                                 K, 'gaussian', num_priors=C, init_mean=1.0,
                                 learned_means=True)), ADAM, {}),
    'vib': (lambda: mlp_cfg('vib', gamma=1000., decoder=(), upsampler=None,
                            prior=build_prior_config(K, 'gaussian')),
            ADAM, {}),
    'cvae_wim': (conv_cfg, ADAM, {'wim': True, 'extra_params': True}),
    'cvae_poscod': (conv_cfg, ADAM, {'poscod': True, 'extra_params': True}),
    'cvae_samples_init': (conv_cfg, ADAM, {'samples': True}),
    'resnet18': (lambda: trunk_cfg('resnet18'), ADAM, {}),
    'densenet121': (lambda: trunk_cfg('densenet121'), ADAM, {}),
}


def random_moments(opt_arrays, seed):
    """The optimizer's arrays with random moments (second moments
    positive) and scale_by_adam's count 7."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in opt_arrays.items():
        v = np.asarray(v)
        if '/mu/' in k or '/trace/' in k:
            v = rng.normal(0, 1e-3, v.shape).astype(np.float32)
        elif '/nu/' in k:
            v = rng.uniform(1e-8, 1e-6, v.shape).astype(np.float32)
        elif k.endswith('inner_state/0/count'):
            v = np.asarray(7, v.dtype)
        out[k] = v
    return out


def _randomize_statistics(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith(('running_mean', 'running_var')):
                b.copy_(torch.from_numpy(np.abs(rng.normal(
                    0.5, 0.2, tuple(b.shape))).astype(np.float32)))


def _records(src):
    rng = np.random.default_rng(3)
    rec = LossRecorder(10)
    for n in (10, 10, 7):
        rec.append_batch(kl=rng.normal(size=(C, n)).astype(np.float32),
                         y_true=rng.integers(0, C, n))
    rec.save(os.path.join(src, 'samples', '{:04d}'.format(EPOCHS),
                          'record-mnist.jvr'))


def _samples(src):
    edir = os.path.join(src, 'samples', '{:04d}'.format(EPOCHS))
    rng = np.random.default_rng(5)
    srec = SampleRecorder()
    srec.append_batch(mu=rng.normal(size=(20, K)).astype(np.float32),
                      y=rng.integers(0, C, 20))
    srec.append_batch(centroids=rng.normal(size=(C, K)).astype(np.float32))
    srec.save(os.path.join(edir, 'sample-mnist.npz'))
    init_rec = LossRecorder(10)
    init_rec.append_batch(kl=rng.normal(size=(C, 10)).astype(np.float32))
    init_rec.save(os.path.join(edir, 'init', 'record-mnist.jvr'))


def write_source(name, src, job_number=9):
    """The case's job directory, written by the port."""
    make_cfg, opt_cfg, opts = CASES[name]
    job = new_job(port_cfg(make_cfg()), opt_cfg, seed=1, job_number=job_number,
                  device='cpu')
    _randomize_statistics(job.model, 11)
    if not opts.get('fresh_optimizer'):
        st = job.state
        jax_to_opt_state(job.model, job.opt_cfg, random_moments(
            opt_state_to_jax(job.model, job.opt_cfg, st.opt_state), 21),
            st.opt_state)
    job.state.epoch = EPOCHS
    job.train_history = {'epochs': EPOCHS, 'train_loss': {'total': [1., .5]}}
    job.training_parameters.update(set='mnist', epochs=EPOCHS)
    if opt_cfg.momentum:
        # the optimizer's params omit the momentum; load_job reads it here
        job.training_parameters['optimizer'] = dict(
            job.training_parameters['optimizer'], momentum=opt_cfg.momentum)
    job.testing = {EPOCHS: {'iws': {'n': 64, 'epochs': EPOCHS,
                                    'sampling': 3, 'accuracy': 0.75}}}
    job.ood_results = {EPOCHS: {'fashion': {'iws': {
        'n': 64, 'auc': 0.9, 'tpr': [0.95], 'fpr': [0.2],
        'thresholds': [0.0], 'epochs': EPOCHS}}}}
    if opts.get('wim'):
        job.training_parameters['wim'] = dict(WIM)
    if opts.get('poscod'):
        job.training_parameters['poscod'] = {'epochs': 5}
    save_job(job, src)
    if opts.get('poscod'):
        rng = np.random.default_rng(3)
        np.savez(os.path.join(src, 'poscod_head.npz'),
                 w=rng.normal(size=(K,)).astype(np.float32),
                 b=np.float32(0.125))
    if opts.get('records'):
        _records(src)
    if opts.get('samples'):
        _samples(src)
    if opts.get('sentinels'):
        for s in ('derailed', 'RESUMED'):
            open(os.path.join(src, s), 'w').close()
    return job


_DONE = {}


def export_case(name, tmp_path_factory):
    """The case exported by both packages and imported back by both
    (once per process)."""
    if name not in _DONE:
        root = str(tmp_path_factory.mktemp('export-' + name))
        stub = stub_checkout()
        case = types.SimpleNamespace(
            name=name, opts=CASES[name][2], src=os.path.join(root, 'src', '9'),
            jax=os.path.join(root, 'jax', '9'),
            port=os.path.join(root, 'port', '9'),
            back_port=os.path.join(root, 'back_port', '9'),
            back_jax=os.path.join(root, 'back_jax', '9'))
        write_source(name, case.src)
        jexp.export_to_reference_job(case.src, case.jax, reference_path=stub)
        texp.export_to_reference_job(case.src, case.port, reference_path=stub,
                                     device='cpu')
        timp.import_reference_job(case.port, case.back_port, device='cpu')
        jimp.import_reference_job(case.port, case.back_jax)
        _DONE[name] = case
    return _DONE[name]


def tree_files(root):
    out = set()
    for d, _, fs in os.walk(root):
        out |= {os.path.relpath(os.path.join(d, f), root) for f in fs}
    return out


def assert_same(a, b, where):
    """Loaded ``.pth`` contents equal: dict keys in order, tensors by
    dtype, shape and bits, other values by ==."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], '{}/{}'.format(where, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, '{}[{}]'.format(where, i))
    elif isinstance(a, torch.Tensor):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), where
        assert a.numpy().tobytes() == b.numpy().tobytes(), where
    else:
        assert a == b, where


def load_pth(path):
    return torch.load(path, map_location='cpu', weights_only=False)


def check_files(case):
    """The port's export against the JAX package's, file by file."""
    files = tree_files(case.port)
    assert files == tree_files(case.jax)
    for rel in sorted(files):
        a, b = os.path.join(case.port, rel), os.path.join(case.jax, rel)
        if rel.endswith('.json'):
            with open(a) as f, open(b) as g:
                assert json.load(f) == json.load(g), rel
        elif rel.endswith('.pth'):
            assert_same(load_pth(a), load_pth(b), rel)
        else:
            with open(a, 'rb') as f, open(b, 'rb') as g:
                assert f.read() == g.read(), rel
    return files


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.tobytes()


def check_round_trip(case, back):
    """import(export(job)) against the source job, bit for bit."""
    src = _npz(os.path.join(case.src, 'state.npz'))
    got = _npz(os.path.join(back, 'state.npz'))
    keys = [k for k in src if k.startswith(('params/', 'batch_stats/'))]
    learned = 'params/sigma_param' in src
    if not learned:
        keys.append('sigma_state/data')
    assert keys
    for k in keys:
        assert _bits(got[k]) == _bits(src[k]), k
    if learned:
        # a learned sigma travels as its log-space parameter
        assert _bits(got['sigma_state/data']) == _bits(
            src['params/sigma_param']), 'sigma'
    src_opt = _npz(os.path.join(case.src, 'optimizer.npz'))
    moments = [k for k in src_opt if '/mu/' in k or '/nu/' in k
               or '/trace/' in k or k.endswith('inner_state/0/count')]
    opt_path = os.path.join(back, 'optimizer.npz')
    if case.opts.get('fresh_optimizer'):
        assert not os.path.exists(os.path.join(case.port, 'optimizer.pth'))
        assert not os.path.exists(opt_path)
    elif case.opts.get('extra_params'):
        # both exporters write the WIM alias and the Poscod head into
        # state.pth but not into optimizer.pth, whose parameters are the
        # template's: both importers then refuse the parameter count and
        # the moments restart at zero (ROADMAP Queue 3)
        assert os.path.exists(os.path.join(case.port, 'optimizer.pth'))
        assert not os.path.exists(opt_path)
    else:
        assert moments
        got_opt = _npz(opt_path)
        for k in moments:
            assert _bits(got_opt[k]) == _bits(src_opt[k]), k
    for d, _, fs in os.walk(os.path.join(case.src, 'samples')):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), case.src)
            other = os.path.join(back, rel)
            if f.endswith('.jvr'):
                with open(os.path.join(d, f), 'rb') as x, \
                        open(other, 'rb') as y:
                    assert x.read() == y.read(), rel
            else:
                a, b = _npz(os.path.join(d, f)), _npz(other)
                assert sorted(a) == sorted(b), rel
                for k in a:
                    assert _bits(a[k]) == _bits(b[k]), (rel, k)
    head = os.path.join(case.src, 'poscod_head.npz')
    if os.path.exists(head):
        a, b = _npz(head), _npz(os.path.join(back, 'poscod_head.npz'))
        for k in a:
            assert _bits(a[k]) == _bits(b[k]), k


def drop_stubs():
    """Leave the process as the export tests found it: the importers' stub
    modules and the torchvision stub out of ``sys.modules`` (a stub
    answering every attribute breaks tools that walk the modules later
    in the process, hypothesis among them), and the checkout's own
    modules and both exporters' caches of them too (so that a later test
    of the importers finds no ``module`` package where it expects its
    stubs; a later export imports the checkout again)."""
    checkout = os.path.join(stub_checkout(), '')
    for name in list(sys.modules):
        v = vars(sys.modules[name])
        stub = '__file__' not in v and (
            (name in timp.REFERENCE_STUBS and '__getattr__' in v)
            or name.split('.')[0] == 'torchvision')
        mine = str(v.get('__file__') or '').startswith(checkout)
        if stub or mine:
            del sys.modules[name]
    jexp._REF_CACHE.clear()
    texp._REF_CACHE.clear()
