"""The reference-import cases shared by ``test_torch_import_reference.py``
and ``test_torch_import_trunks.py``: each writes one reference-layout job
directory (``torch_reference_layout.py``) from a port job's weights with
random BatchNorm statistics and random optimizer moments, imports it with
the JAX package's importer and the port's, and holds the two (the checks
are described in ``test_torch_import_reference.py``)."""

import os
import sys
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as graft
import joint_vae_tpu.models.evaluate as jev
from joint_vae_tpu.models.cvnet import CVNetConfig as JCVNetConfig
from joint_vae_tpu.ops.priors import build_prior_config
from joint_vae_tpu.ops.sigma import SigmaConfig as JSigmaConfig
from joint_vae_tpu.save_load import import_reference as jimp
from joint_vae_tpu.save_load.checkpoint import flatten_pytree
from joint_vae_tpu.save_load.jobs import load_job as jload_job
from joint_vae_tpu.train.optimizers import OptimizerConfig as JOptimizerConfig

from joint_vae_tpu_torch.models.evaluate import evaluate
from joint_vae_tpu_torch.save_load import import_reference as timp
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.save_load.from_jax import (opt_state_to_jax,
                                                    state_dict_to_jax)
from joint_vae_tpu_torch.save_load import tv_resnet
from joint_vae_tpu_torch.save_load.jobs import load_job
from joint_vae_tpu_torch.save_load.recorders import LossRecorder
from joint_vae_tpu_torch.train.optimizers import (
    OptimizerConfig as TOptimizerConfig)

from torch_port_util import close, inject_jax_eps, make_eps, port_cfg
from torch_reference_layout import (loss_record_dump, sample_record_dump,
                                    write_reference_job)

EVAL_TOL = 5e-4
TRUNK_TOL = 1e-4
N = 4
EXEMPT = {'rng'}      # the JAX package's sampling key (port jobs.py)


def _cfg(type_, **kw):
    base = dict(input_shape=(1, 6, 6), num_labels=3, type=type_,
                encoder=(16,), decoder=(16,), classifier=(8,), latent_dim=4,
                latent_sampling=2, test_latent_sampling=3, gamma=10.0,
                beta=1e-2, sigma=JSigmaConfig(value=0.3),
                prior=build_prior_config(4, 'gaussian', num_priors=3,
                                         init_mean=1.0, learned_means=True))
    base.update(kw)
    return JCVNetConfig(**base)


def trunk_cfg(features):
    return JCVNetConfig(
        input_shape=(3, 32, 32), num_labels=4, type='cvae', features=features,
        encoder=(16,), decoder=(16,), classifier=(8,), latent_dim=6,
        latent_sampling=1, test_latent_sampling=2, gamma=10.0, beta=1e-2,
        sigma=JSigmaConfig(value=0.5),
        prior=build_prior_config(6, 'gaussian', num_priors=4, init_mean=1.0,
                                 learned_means=True))


ADAM = JOptimizerConfig(lr=1e-4)
SGD = JOptimizerConfig(optim_type='sgd', lr=0.01, momentum=0.9)

# name: (config, optimizer, options)
CASES = {
    'flagship_tiny': (lambda: graft._flagship_cfg(tiny=True), ADAM,
                      {'records': '2'}),
    'cvae_bn_learned_sigma_sgd': (lambda: _cfg(
        'cvae', input_shape=(3, 8, 8), features='[x3+1]6-6:2',
        upsampler='[x3+1]6x2+0-6:2++1-!3x3+1', decoder=(54,),
        batch_norm='both', representation='hsv',
        sigma=JSigmaConfig(value=0.5, learned=True)), SGD,
        {'sigma_subclass': True}),
    'vae_samples_last': (lambda: _cfg('vae', prior=None), ADAM,
                         {'records': 'last', 'no_job_number': True}),
    'jvae': (lambda: _cfg('jvae', prior=None), ADAM, {}),
    'xvae_tilted_wim': (lambda: _cfg(
        'xvae', prior=build_prior_config(4, 'tilted', num_priors=3,
                                         init_mean=1.0, tau=2.0)), ADAM,
        {'wim': True}),
    'vib': (lambda: _cfg('vib', prior=None), ADAM, {}),
    'cvae_uniform_poscod': (lambda: _cfg(
        'cvae', prior=build_prior_config(4, 'uniform', num_priors=3,
                                         init_mean=1.0, tau=1.5)), ADAM,
        {'poscod': True}),
    'resnet18': (lambda: trunk_cfg('resnet18'), ADAM,
                 {'trunk': 'resnet18'}),
    'densenet121': (lambda: trunk_cfg('densenet121'), ADAM,
                    {'trunk': 'densenet121'}),
}


def random_moments(opt_arrays, seed):
    """The JAX optimizer's arrays with random moments (second moments
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


def port_job(jcfg, opt_cfg=None):
    return tjobs.new_job(port_cfg(jcfg), opt_cfg or TOptimizerConfig(lr=1e-4),
                         seed=1, device='cpu')


def port_arrays(jcfg):
    return state_dict_to_jax(port_job(jcfg).model)


def trunk_module(arch, seed=3):
    torch.manual_seed(seed)
    net = getattr(tv_resnet, arch)().eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(
                    m.running_mean.shape, generator=g))
                m.running_var.copy_(1 + 0.3 * torch.rand(
                    m.running_var.shape, generator=g))
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape,
                                                     generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return net


def _records(cfg, seed):
    rng = np.random.default_rng(seed)
    rec = LossRecorder(batch_size=4)
    for n in (4, 4, 3):
        rec.append_batch(total=rng.normal(size=(cfg.num_labels, n)).astype(
            np.float32), y_true=rng.integers(0, cfg.num_labels, n))
    return rec


def _write_source(name, root):
    make_cfg, opt_cfg, opts = CASES[name]
    jcfg = make_cfg()
    # the source weights: a port job of the same config (every leaf is
    # mapped, so the fresh init of neither package survives the import)
    job = port_job(jcfg, TOptimizerConfig(
        optim_type=opt_cfg.optim_type, lr=opt_cfg.lr,
        momentum=opt_cfg.momentum))
    rng = np.random.default_rng(2)
    arrays = {k: (v + rng.uniform(0.1, 0.4, v.shape).astype(np.float32)
                  if k.startswith('batch_stats/') else v)
              for k, v in state_dict_to_jax(job.model).items()}
    arrays['sigma_state/data'] = job.sigma_state.data.numpy()
    opt_arrays = random_moments(opt_state_to_jax(
        job.model, job.opt_cfg, job.state.opt_state), 4)
    arch = dict(jcfg.architecture)
    if not opts.get('no_job_number'):
        arch['job_number'] = 17
    tp = dict(job.training_parameters, set='synthetic', epochs=2)
    if opt_cfg.momentum:
        # the optimizer's params omit the momentum; load_job reads it here
        tp['optimizer'] = dict(tp['optimizer'], momentum=opt_cfg.momentum)
    src = os.path.join(root, 'ref', 'synthetic', name, '23')
    records, extra, trunk = {}, {}, None
    rec = None
    if 'records' in opts:
        rec = _records(jcfg, 5)
        records = {opts['records']: {
            'record-synthetic.pth': loss_record_dump(rec),
            'samples-synthetic.pth': sample_record_dump(
                {'z': np.arange(12, dtype=np.float32).reshape(3, 4)},
                {'centroids': np.ones((2, 4), np.float32)})},
            opts['records'] + '/init': {
            'record-other.pth': loss_record_dump(rec)}}
    rng = np.random.default_rng(6)
    K = jcfg.latent_dim
    if opts.get('wim'):
        extra['_alternate_prior.mean'] = rng.normal(
            size=(1, K)).astype(np.float32)
        extra['_alternate_prior._var_parameter'] = np.asarray(
            0.7, np.float32)
    if opts.get('poscod'):
        extra['ood_head.1.weight'] = rng.normal(size=(1, K)).astype(
            np.float32)
        extra['ood_head.1.bias'] = rng.normal(size=(1,)).astype(np.float32)
    if 'trunk' in opts:
        trunk = trunk_module(opts['trunk'])
    sd = write_reference_job(
        src, arch, arrays, training_parameters=tp,
        history={'epochs': 2, 'train_loss': {'total': [1.0, 0.5]}},
        test={2: {'esty': {'n': 4, 'epochs': 2, 'accuracy': 0.5}}},
        ood={2: {'other': {'iws': {'auc': 0.7}}}},
        opt_arrays=None if trunk is not None else opt_arrays,
        param_group={'lr': opt_cfg.lr}, records=records, trunk=trunk,
        extra=extra, sigma_subclass=opts.get('sigma_subclass', False))
    return dict(src=src, jcfg=jcfg, arrays=arrays, opt_arrays=opt_arrays,
                sd=sd, trunk=trunk, rec=rec, opts=opts)


_DONE = {}


def drop_reference_stubs():
    """Remove the importers' stub modules (``module.vae_layers.layers``
    and its parents) from ``sys.modules``: the JAX package's answer every
    attribute, ``__file__`` included, which breaks tools that walk the
    modules (hypothesis does) in tests run later in the process."""
    for name in timp.REFERENCE_STUBS:
        m = sys.modules.get(name)
        if type(m) is types.ModuleType and '__getattr__' in vars(m):
            del sys.modules[name]


def import_case(name, tmp_path_factory):
    """The case's reference job written and imported by both packages
    (once per process)."""
    if name not in _DONE:
        root = str(tmp_path_factory.mktemp('import-' + name))
        case = _write_source(name, root)
        case['jax'] = os.path.join(root, 'jax')
        case['port'] = os.path.join(root, 'port')
        jimp.import_reference_job(case['src'], case['jax'])
        timp.import_reference_job(case['src'], case['port'], device='cpu')
        _DONE[name] = case
    return _DONE[name]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def tree_files(root):
    """Every file under root, by its relative path."""
    out = set()
    for d, _, fs in os.walk(root):
        out |= {os.path.relpath(os.path.join(d, f), root) for f in fs}
    return out


def _assert_same_arrays(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = got[k], want[k]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (what, k)
        assert g.tobytes() == w.tobytes(), (what, k)


def check_writer(imported):
    """writer -> the JAX importer: the source's arrays bit for bit."""
    st = _npz(os.path.join(imported['jax'], 'state.npz'))
    trunk = imported['trunk']
    for k, v in imported['arrays'].items():
        if trunk is not None and k.split('/')[1] == 'features_stack':
            continue                     # written from the torchvision trunk
        if k == 'sigma_state/data' and 'params/sigma_param' in st:
            continue                     # learned: the log-space parameter
        assert st[k].tobytes() == np.asarray(v).tobytes(), k
    if trunk is not None:
        # the stem's conv (OIHW -> HWIO) and statistics; the whole trunk
        # is held by its features in check_evaluate
        stem = {'params/features_stack/Conv_0/kernel':
                trunk.conv1.weight if hasattr(trunk, 'conv1')
                else trunk.features.conv0.weight,
                'batch_stats/features_stack/BatchNorm_0/mean':
                trunk.bn1.running_mean if hasattr(trunk, 'bn1')
                else trunk.features.norm0.running_mean}
        for k, v in stem.items():
            v = v.detach().numpy()
            if v.ndim == 4:
                v = v.transpose(2, 3, 1, 0)
            assert st[k].tobytes() == np.ascontiguousarray(v).tobytes(), k
        assert not os.path.exists(os.path.join(imported['jax'],
                                               'optimizer.npz'))
        return
    opt = _npz(os.path.join(imported['jax'], 'optimizer.npz'))
    moments = {k: v for k, v in imported['opt_arrays'].items()
               if '/mu/' in k or '/nu/' in k or '/trace/' in k
               or k.endswith('inner_state/0/count')}
    assert moments
    for k, v in moments.items():
        assert opt[k].tobytes() == np.asarray(v).tobytes(), k


def check_files(imported):
    """The port's import against the JAX package's, file by file."""
    jd, pd = imported['jax'], imported['port']
    assert tree_files(pd) == tree_files(jd)
    for rel in sorted(tree_files(jd)):
        a, b = os.path.join(pd, rel), os.path.join(jd, rel)
        if rel in ('state.npz', 'optimizer.npz'):
            want = {k: v for k, v in _npz(b).items() if k not in EXEMPT}
            _assert_same_arrays(_npz(a), want, rel)
            if rel == 'state.npz':
                assert set(_npz(b)) - set(want) == EXEMPT
        elif rel.endswith('.npz'):
            assert _members(a) == _members(b), rel
        else:
            with open(a, 'rb') as f, open(b, 'rb') as g:
                assert f.read() == g.read(), rel
    opts = imported['opts']
    if 'records' in opts:
        d = os.path.join(pd, 'samples', '0002')
        for rel in ('record-synthetic.jvr', 'sample-synthetic.npz',
                    'init/record-other.jvr'):
            assert os.path.exists(os.path.join(d, rel)), rel
        back = LossRecorder.load(os.path.join(d, 'record-synthetic.jvr'))
        for k, v in imported['rec']._tensors.items():
            np.testing.assert_array_equal(back.get(k), v[..., :11])
    for flag, fname in (('wim', 'wim_prior.npz'),
                        ('poscod', 'poscod_head.npz')):
        assert os.path.exists(os.path.join(pd, fname)) == bool(
            opts.get(flag)), fname


def check_evaluate(imported, monkeypatch):
    """The JAX package loads the port's import with the same weights;
    evaluate on the two imports with the same noise; a trunk's features
    against tv_resnet's forward."""
    jcfg = imported['jcfg']
    jjob = jload_job(imported['jax'])
    # the JAX package reads the port's import: the same weights
    jport = jload_job(imported['port'])
    for a, b in ((jjob.state.params, jport.state.params),
                 (jjob.state.batch_stats, jport.state.batch_stats)):
        fa, fb = flatten_pytree(a or {}), flatten_pytree(b or {})
        _assert_same_arrays(fb, fa, 'JAX load_job of the port import')
    assert jport.job_number == jjob.job_number == (
        23 if imported['opts'].get('no_job_number') else 17)
    assert jport.trained == 2
    job = load_job(imported['port'], device='cpu')
    L = jcfg.test_latent_sampling
    x = np.random.default_rng(42).uniform(
        0, 1, (N,) + jcfg.input_shape).astype(np.float32)
    lead = (jcfg.num_labels, N) if jcfg.y_is_coded else (N,)
    eps = make_eps((L + 1,) + lead + (jcfg.latent_dim,))
    inject_jax_eps(monkeypatch, eps)
    want = jev.evaluate(jjob.model, jjob.state.variables, jnp.asarray(x),
                        None, rng=jax.random.PRNGKey(1),
                        sigma_state=jjob.state.sigma_state, train=False)
    got = evaluate(job.model, torch.from_numpy(x),
                   sigma_state=job.sigma_state, eps=torch.from_numpy(eps))
    assert set(got.losses) == set(want.losses)
    for k, v in want.losses.items():
        close(got.losses[k], v, EVAL_TOL, 'loss ' + k)
    close(got.logits, want.logits, EVAL_TOL, 'logits')
    if imported['trunk'] is not None:
        with torch.no_grad():
            seq = torch.nn.Sequential(*list(imported['trunk'].children())[:-1])
            tv = seq(torch.from_numpy(x)).numpy()
            ours = job.model.features_stack(torch.from_numpy(x)).numpy()
        assert ours.shape == tv.shape
        err = np.abs(ours - tv) / (np.abs(tv) + np.sqrt(np.mean(tv ** 2)))
        assert err.max() <= TRUNK_TOL, err.max()


