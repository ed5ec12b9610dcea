"""The port's importer of reference-trained jobs against the JAX package's.

Each case writes one reference-layout job directory
(``torch_reference_layout.py``: ``state.pth``, ``optimizer.pth``, the JSON
files, ``samples/<dir>/record-<set>.pth``) from a port job's weights with
random BatchNorm statistics and random optimizer moments, and then:

- the writer itself: the JAX package's ``import_reference_job`` gives the
  source's params, BatchNorm statistics and moments back bit for bit;
- the JAX importer and the port's on the same directory write the same
  files: JSON files byte-equal; ``state.npz`` and ``optimizer.npz`` with
  the same keys, dtypes, shapes and bits, except the JAX package's
  sampling key ``rng``, which the port does not keep (``jobs.py``);
  ``.jvr`` files byte-equal; ``sample-*.npz``, ``wim_prior.npz`` and
  ``poscod_head.npz`` member by member byte-equal (``np.savez`` stamps
  each member with the time of writing, so the archives' own bytes
  differ by that);
- the port's ``evaluate`` on its import against the JAX package's on its
  own, with injected latent noise, within 5e-4 (docs/PARITY.md), and the
  JAX package's ``load_job`` reads the port's import.

Cases: all five types; the gaussian, tilted and uniform priors; a
learned sigma pickled as the reference's Sigma subclass (unpickled
through the importer's stubs); a conv + BatchNorm stack; Adam and
SGD-momentum moments; a WIM job (its alternate prior in ``state.pth``), a
Poscod job (its ``ood_head``), records under ``samples/last``; the
full-width torchvision trunks in ``test_torch_import_trunks.py``.  Every
leaf of every case is mapped, so no fresh-init leaf is compared.  Then
the rejections, each with the JAX package's message.  The cases and
checks live in ``torch_import_cases.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from joint_vae_tpu.save_load import import_reference as jimp

from joint_vae_tpu_torch.save_load import import_reference as timp
from joint_vae_tpu_torch.save_load import tv_resnet
from joint_vae_tpu_torch.save_load.from_jax import (opt_state_to_jax,
                                                    state_dict_to_jax)
from joint_vae_tpu_torch.train.optimizers import (
    OptimizerConfig as TOptimizerConfig)

from torch_import_cases import (CASES, check_evaluate, check_files,
                                check_writer, drop_reference_stubs,
                                import_case, port_arrays, port_job,
                                random_moments, tree_files, trunk_cfg,
                                trunk_module)
from torch_reference_layout import write_reference_job

SMALL = sorted(k for k, (_, _, o) in CASES.items() if 'trunk' not in o)


@pytest.fixture
def imported(request, tmp_path_factory):
    return import_case(request.param, tmp_path_factory)


@pytest.fixture(autouse=True)
def _no_reference_stubs_left():
    yield
    drop_reference_stubs()


@pytest.mark.parametrize('imported', SMALL, indirect=True)
def test_writer_gives_the_source_back(imported):
    """writer -> the JAX importer: the source's arrays bit for bit."""
    check_writer(imported)


@pytest.mark.parametrize('imported', SMALL, indirect=True)
def test_port_import_files_equal_jax(imported):
    check_files(imported)


@pytest.mark.parametrize('imported', SMALL, indirect=True)
def test_evaluate_on_imports_agrees(imported, monkeypatch):
    check_evaluate(imported, monkeypatch)


# -- rejections, with the JAX package's messages -----------------------------

def _raises_same(fn_jax, fn_port, match):
    with pytest.raises(jimp.ImportError_, match=match) as ej:
        fn_jax()
    with pytest.raises(timp.ImportError_, match=match) as ep:
        fn_port()
    assert str(ep.value) == str(ej.value)


def _bn_underflow(mod):
    params = {'features_stack': {
        'conv_0': {'kernel': np.zeros((3, 3, 1, 8), np.float32),
                   'bias': np.zeros((8,), np.float32)},
        'bn_0': {'scale': np.ones((8,), np.float32),
                 'bias': np.zeros((8,), np.float32)}}}
    stats = {'features_stack': {'bn_0': {'mean': np.zeros((8,), np.float32),
                                         'var': np.ones((8,), np.float32)}}}
    sd = {'features.0.weight': np.zeros((8, 1, 3, 3), np.float32),
          'features.0.bias': np.zeros((8,), np.float32)}
    return lambda: mod.map_reference_state(sd, params, stats)


def _missing_dense(mod):
    params = {'imager': {
        'dense': {'kernel': np.zeros((4, 16), np.float32),
                  'bias': np.zeros((16,), np.float32)},
        'deconv_0': {'kernel': np.zeros((3, 3, 1, 1), np.float32),
                     'bias': np.zeros((1,), np.float32)}}}
    sd = {'imager.0.weight': np.zeros((1, 1, 3, 3), np.float32),
          'imager.0.bias': np.zeros((1,), np.float32)}
    return lambda: mod.map_reference_state(sd, params, None)


@pytest.mark.parametrize('case,match', [(_bn_underflow, 'batch-norm'),
                                        (_missing_dense, 'dense')])
def test_partial_maps_rejected(case, match):
    _raises_same(case(jimp), case(timp), match)


def _trunk_sd():
    net = tv_resnet.resnet18()
    seq = torch.nn.Sequential(*list(net.children())[:-1])
    return {'features.' + k: v.numpy() for k, v in seq.state_dict().items()}


def test_resnet_block_missing_tensor_rejected():
    from joint_vae_tpu_torch.save_load.from_jax import state_dict_to_jax
    from joint_vae_tpu_torch.models.resnet import ResNetFeatures
    sd = _trunk_sd()
    flat = {k[len('params/'):]: v for k, v in
            state_dict_to_jax(ResNetFeatures('resnet18')).items()
            if k.startswith('params/')}
    params = {'features_stack': timp._nest(flat)}
    out, stats = {}, {}
    timp._map_resnet_features(dict(sd), params, out, stats)
    assert len(out) == len(flat) and len(stats) == 40
    missing = {k: v for k, v in sd.items()
               if not k.startswith('features.5.1.conv2')}
    _raises_same(
        lambda: jimp._map_resnet_features(missing, params, {}, {}),
        lambda: timp._map_resnet_features(missing, params, {}, {}),
        'missing conv2')


@pytest.mark.parametrize('features,arch', [('resnet18:16', 'resnet18'),
                                           ('densenet-small', 'densenet121')])
def test_untorchvision_trunks_rejected(features, arch, tmp_path):
    """A width-suffixed or compact trunk has no torchvision counterpart:
    a reference job with a torchvision trunk does not map onto it."""
    jcfg = trunk_cfg(features)
    arrays = port_arrays(jcfg)
    src = str(tmp_path / 'ref' / '5')
    write_reference_job(src, dict(jcfg.architecture), arrays,
                        trunk=trunk_module(arch))
    _raises_same(
        lambda: jimp.import_reference_job(src, str(tmp_path / 'jax')),
        lambda: timp.import_reference_job(src, str(tmp_path / 'port'),
                                          device='cpu'),
        'mismatch|vs')


def test_optimizer_param_count_mismatch(tmp_path, caplog):
    """An optimizer whose parameter count differs from the state_dict's is
    refused with the reason; the job imports without optimizer.npz."""
    jcfg = CASES['jvae'][0]()
    job = port_job(jcfg)
    arrays = state_dict_to_jax(job.model)
    opt = random_moments(opt_state_to_jax(job.model, job.opt_cfg,
                                           job.state.opt_state), 1)
    src = str(tmp_path / 'ref' / '5')
    sd = write_reference_job(src, dict(jcfg.architecture), arrays,
                             training_parameters=dict(
                                 job.training_parameters),
                             opt_arrays=opt)
    opt_sd = timp.load_reference_optimizer(os.path.join(src,
                                                        'optimizer.pth'))
    opt_sd['param_groups'][0]['params'] = opt_sd['param_groups'][0][
        'params'][:-1]
    torch.save(opt_sd, os.path.join(src, 'optimizer.pth'))
    params = timp._nest({k[len('params/'):]: v for k, v in arrays.items()})
    _raises_same(
        lambda: jimp.map_reference_optimizer(opt_sd, sd, params, None, None),
        lambda: timp.map_reference_optimizer(opt_sd, sd, params, None, {}),
        'optimizer tracks')
    timp.import_reference_job(src, str(tmp_path / 'port'), device='cpu')
    assert os.path.exists(str(tmp_path / 'port' / 'state.npz'))
    assert not os.path.exists(str(tmp_path / 'port' / 'optimizer.npz'))
    assert 'moments restart at zero' in caplog.text


def test_sgd_without_momentum_imports_no_moments(tmp_path):
    jcfg = CASES['vib'][0]()
    job = port_job(jcfg, TOptimizerConfig(optim_type='sgd', lr=0.01))
    arrays = state_dict_to_jax(job.model)
    src = str(tmp_path / 'ref' / '5')
    sd = write_reference_job(src, dict(jcfg.architecture), arrays,
                             training_parameters=dict(
                                 job.training_parameters))
    torch.save({'state': {}, 'param_groups': [{'lr': 0.01, 'params': list(
        range(len(sd)))}]}, os.path.join(src, 'optimizer.pth'))
    for mod, d in ((jimp, 'jax'), (timp, 'port')):
        kw = {'device': 'cpu'} if mod is timp else {}
        mod.import_reference_job(src, str(tmp_path / d), **kw)
        assert not os.path.exists(str(tmp_path / d / 'optimizer.npz'))


def test_no_state_and_sentinels(tmp_path):
    """A job without state.pth imports its JSON files only; the
    sentinels are copied; a directory without params.json is refused."""
    jcfg = CASES['vib'][0]()
    src = tmp_path / 'ref' / '8'
    src.mkdir(parents=True)
    import json
    (src / 'params.json').write_text(json.dumps(dict(jcfg.architecture)))
    (src / 'history.json').write_text(json.dumps({'epochs': 3}))
    (src / 'derailed').write_text('')
    for mod, d in ((jimp, 'jax'), (timp, 'port')):
        kw = {'device': 'cpu'} if mod is timp else {}
        mod.import_reference_job(str(src), str(tmp_path / d), **kw)
    assert tree_files(str(tmp_path / 'port')) == tree_files(str(tmp_path / 'jax')) \
        == {'params.json', 'train_params.json', 'history.json', 'derailed'}
    for f in ('params.json', 'train_params.json', 'history.json'):
        assert (tmp_path / 'port' / f).read_bytes() == (
            tmp_path / 'jax' / f).read_bytes()
    with pytest.raises(FileNotFoundError, match='no params.json'):
        timp.import_reference_job(str(tmp_path), str(tmp_path / 'x'),
                                  device='cpu')


def test_reference_stubs_answer_no_dunders(tmp_path):
    """A state.pth carrying the reference's Sigma subclass loads through
    the port's stubs, which give Sigma as a Parameter and refuse dunder
    names, so a walk of sys.modules reading ``__file__`` (hypothesis's)
    is not broken by them."""
    import sys
    jcfg = CASES['vib'][0]()
    arrays = port_arrays(jcfg)
    arrays['sigma_state/data'] = np.asarray([0.3], np.float32)
    src = str(tmp_path / 'ref' / '5')
    write_reference_job(src, dict(jcfg.architecture), arrays,
                        sigma_subclass=True)
    drop_reference_stubs()
    sd = timp.load_reference_state(os.path.join(src, 'state.pth'))
    assert sd['sigma'].tolist() == [np.float32(0.3)]
    stub = sys.modules['module.vae_layers.layers']
    assert issubclass(stub.Sigma, torch.nn.Parameter)
    for name in timp.REFERENCE_STUBS:
        assert getattr(sys.modules[name], '__file__', None) is None
    with pytest.raises(AttributeError):
        stub.__path__
