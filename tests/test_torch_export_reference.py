"""The port's exporter to moxime/joint-vae's job layout against the JAX
package's, on the CPU, through one stub reference checkout
(``torch_reference_stub.py``) handed to both.

Each case (``torch_export_cases.py``) writes a job with the port at the
JAX export test's size (input (1, 8, 8), C=4, K=6), exports it with both
packages and holds the two exports equal, exactly: the same files, JSON
files equal as parsed objects, ``state.pth``/``optimizer.pth``/
``record-*.pth``/``samples-*.pth`` equal as loaded (keys and their order,
dtypes and bits).  Then import(export(job)) through the port's importer
and through the JAX package's gives the source's parameters, statistics,
sigma, moments and counts back bit for bit, and its record files'
bytes.  Cases: the conv cvae (conv + BatchNorm, learned sigma, tilted
prior) with Adam moments and records, with SGD momentum, computing in
bfloat16 (the master weights exported unrounded), with a fresh optimizer
(no optimizer.pth) and sentinel files; the vae, jvae, xvae and vib;
a WIM job (``wim.json``, ``_original_prior.*``); a Poscod job
(``poscod.json``, ``ood_head.1.*``, ``param_a``); sample recorders and
``init/`` nesting.  The trunks are in ``test_torch_export_trunks.py``.
Beside: the sample recorders' tie-break, the compact trunk's rejection,
the dropped-key warnings, ``--no-optimizer``/``--no-recorders``, and
export after an import that left the importer's stub modules in place
(the JAX package's exporter fails there, the port's drops the stubs).
"""

import logging
import os
import sys

import numpy as np
import pytest
import torch

from joint_vae_tpu.save_load import export_reference as jexp
from joint_vae_tpu.save_load import import_reference as jimp

from joint_vae_tpu_torch.save_load import export_reference as texp
from joint_vae_tpu_torch.save_load import import_reference as timp
from joint_vae_tpu_torch.save_load.jobs import new_job, save_job
from joint_vae_tpu_torch.save_load.recorders import SampleRecorder
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig

from torch_export_cases import (CASES, WIM, assert_same, check_files,
                                check_round_trip, drop_stubs, export_case,
                                load_pth, trunk_cfg, tree_files, write_source)
from torch_port_util import port_cfg
from torch_reference_layout import write_reference_job
from torch_reference_stub import stub_checkout

SMALL = sorted(k for k in CASES if not k.startswith(('resnet', 'densenet')))


@pytest.fixture
def exported(request, tmp_path_factory):
    return export_case(request.param, tmp_path_factory)


@pytest.fixture(scope='module', autouse=True)
def _no_stubs_left():
    yield
    drop_stubs()


@pytest.mark.parametrize('exported', SMALL, indirect=True)
def test_port_export_files_equal_jax(exported):
    """Also: the checkout's own load takes the export, state included."""
    files = check_files(exported)
    net_cls, _ = texp.reference_modules(stub_checkout())
    net = net_cls.load(exported.port, load_state=True)
    assert net.job_number == 9
    assert list(net.state_dict()) == [
        k for k in net.loaded_state if k in net.state_dict()]
    opts = exported.opts
    want = {'params.json', 'train_params.json', 'history.json', 'test.json',
            'ood.json', 'state.pth'}
    if not opts.get('fresh_optimizer'):
        want.add('optimizer.pth')
    assert want <= files
    for flag, name in (('wim', 'wim.json'), ('poscod', 'poscod.json'),
                       ('sentinels', 'derailed'), ('sentinels', 'RESUMED'),
                       ('records', 'samples/2/record-mnist.pth'),
                       ('records', 'samples/last/record-mnist.pth'),
                       ('samples', 'samples/2/samples-mnist.pth'),
                       ('samples', 'samples/2/init/record-mnist.pth')):
        assert (name in files) == bool(opts.get(flag)), name


@pytest.mark.parametrize('exported', SMALL, indirect=True)
def test_port_import_gives_the_source_back(exported):
    check_round_trip(exported, exported.back_port)


@pytest.mark.parametrize('exported', SMALL, indirect=True)
def test_jax_import_gives_the_source_back(exported):
    check_round_trip(exported, exported.back_jax)


def test_state_layout(tmp_path_factory):
    """What the reference reads: the learned sigma's Adam moment rides
    the sigma parameter's index, step is Adam's count, a conv moment is
    OIHW; the Poscod head and the WIM alias in state.pth."""
    case = export_case('cvae_conv_records', tmp_path_factory)
    sd = load_pth(os.path.join(case.port, 'state.pth'))
    opt = load_pth(os.path.join(case.port, 'optimizer.pth'))
    names = [k for k in sd if not k.endswith(
        ('running_mean', 'running_var', 'num_batches_tracked'))]
    src_opt = np.load(os.path.join(case.src, 'optimizer.npz'))
    mu = {k.split('/mu/', 1)[1]: src_opt[k] for k in src_opt.files
          if '/mu/' in k}
    st = opt['state']
    i = names.index('sigma')
    assert st[i]['exp_avg'].numpy().tobytes() == mu['sigma_param'].tobytes()
    i = names.index('features.0.weight')
    np.testing.assert_array_equal(
        st[i]['exp_avg'].numpy().transpose(2, 3, 1, 0),
        mu['features_stack/conv_0/kernel'])
    assert float(st[i]['step']) == 7.0
    poscod = load_pth(os.path.join(export_case(
        'cvae_poscod', tmp_path_factory).port, 'state.pth'))
    assert poscod['ood_head.1.bias'].tolist() == [0.125]
    assert poscod['param_a'].tolist() == [0.5]
    wim = load_pth(os.path.join(export_case(
        'cvae_wim', tmp_path_factory).port, 'state.pth'))
    for f in ('mean', '_var_parameter'):
        assert torch.equal(wim['_original_prior.' + f],
                           wim['encoder.prior.' + f])


def test_wim_json(tmp_path_factory):
    """The prior keys and the moving-set metadata the reference's
    load_post_hook pops; padding_dataset is dropped."""
    import json
    case = export_case('cvae_wim', tmp_path_factory)
    with open(os.path.join(case.port, 'wim.json')) as f:
        wj = json.load(f)
    assert wj == {k: v for k, v in WIM.items() if k != 'padding_dataset'}


def test_bf16_master_weights_exported_unrounded(tmp_path_factory):
    """A job computing in bfloat16 keeps float32 master weights; the
    template's dtype (float32) leaves their bits as they are."""
    case = export_case('cvae_conv_bf16', tmp_path_factory)
    sd = load_pth(os.path.join(case.port, 'state.pth'))
    assert {v.dtype for k, v in sd.items()
            if not k.endswith('num_batches_tracked')} == {torch.float32}
    src = np.load(os.path.join(case.src, 'state.npz'))
    w = src['params/encoder/dense_mean/kernel']
    assert sd['encoder.dense_mean.weight'].numpy().tobytes() == \
        np.ascontiguousarray(w.T).tobytes()
    rounded = w.astype(np.float32).view(np.uint32) & np.uint32(0xffff)
    assert rounded.any()          # bits below bfloat16's: not rounded away


def test_sample_recorder_tie_break(tmp_path):
    """On a tie of leading dims the larger is the sample axis; both
    packages split the same keys into _tensors and _aux."""
    rec = SampleRecorder()
    rng = np.random.default_rng(2)
    rec.append_batch(mu=rng.normal(size=(8, 3)).astype(np.float32),
                     y=rng.integers(0, 4, 8))
    rec.append_batch(centroids=rng.normal(size=(4, 3)).astype(np.float32),
                     alternate=rng.normal(size=(4, 3)).astype(np.float32))
    p = str(tmp_path / 'sample-x.npz')
    rec.save(p)
    stub = stub_checkout()
    out = {}
    for name, mod in (('jax', jexp), ('port', texp)):
        _, ref_recorders = mod.reference_modules(stub)
        out[name] = str(tmp_path / name / 'samples-x.pth')
        assert mod.export_sample_recorder(p, out[name], ref_recorders)
    a, b = load_pth(out['port']), load_pth(out['jax'])
    assert_same(a, b, 'samples-x.pth')
    assert set(a['_tensors']) == {'mu', 'y'}
    assert set(a['_aux']) == {'centroids', 'alternate'}


def test_compact_trunk_rejected_before_the_checkout(tmp_path, monkeypatch):
    """densenet-small has no torchvision counterpart: both exporters
    refuse it with the same message, without a reference checkout."""
    monkeypatch.delenv('JVT_REFERENCE', raising=False)
    cfg = port_cfg(trunk_cfg('densenet-small'))
    save_job(new_job(cfg, OptimizerConfig(), device='cpu'),
             str(tmp_path / 'src' / '1'), save_state=False)
    msgs = []
    for mod in (jexp, texp):
        with pytest.raises(mod.ExportError_, match='densenet') as e:
            mod.export_to_reference_job(str(tmp_path / 'src' / '1'),
                                        str(tmp_path / 'out' / '1'),
                                        reference_path='/nonexistent')
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert not os.path.exists(str(tmp_path / 'out'))


def test_dropped_keys_warned(tmp_path, caplog):
    """compute_dtype (unknown to the reference ctor) and the native train
    keys leave params.json and train_params.json with the same warning
    from both packages."""
    write_source('vib', str(tmp_path / 'src' / '9'))
    stub = stub_checkout()
    logs = {}
    for name, mod, kw in (('jax', jexp, {}), ('port', texp,
                                              {'device': 'cpu'})):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            mod.export_to_reference_job(str(tmp_path / 'src' / '9'),
                                        str(tmp_path / name / '9'),
                                        reference_path=stub, **kw)
        logs[name] = [r.getMessage() for r in caplog.records
                      if 'dropped on export' in r.getMessage()]
    assert logs['port'] == logs['jax']
    assert any('params.json keys' in m and 'compute_dtype' in m
               for m in logs['port'])


@pytest.mark.parametrize('flag', ['export_optimizer', 'export_recorders'])
def test_no_optimizer_no_recorders(tmp_path, tmp_path_factory, flag):
    case = export_case('cvae_conv_records', tmp_path_factory)
    stub = stub_checkout()
    out = {}
    for name, mod, kw in (('jax', jexp, {}), ('port', texp,
                                              {'device': 'cpu'})):
        out[name] = str(tmp_path / name)
        mod.export_to_reference_job(case.src, out[name], reference_path=stub,
                                    **{flag: False}, **kw)
    files = tree_files(out['port'])
    assert files == tree_files(out['jax'])
    full = tree_files(case.port)
    gone = ({'optimizer.pth'} if flag == 'export_optimizer'
            else {f for f in full if f.startswith('samples')})
    assert gone and files == full - gone
    for rel in files:
        if rel.endswith('.pth'):
            assert_same(load_pth(os.path.join(out['port'], rel)),
                        load_pth(os.path.join(out['jax'], rel)), rel)


def test_export_after_import_drops_the_importer_stubs(tmp_path, monkeypatch):
    """A process that imports a reference job whose sigma is the
    reference's Sigma subclass, and then exports, finds the importer's
    stub ``module`` packages in sys.modules, which shadow the checkout's:
    the JAX package's exporter fails there, the port's drops the stubs
    and exports."""
    stub = stub_checkout()
    for name in [n for n in sys.modules
                 if n.split('.')[0] in ('cvae', 'utils', 'module')]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(jexp, '_REF_CACHE', {})
    monkeypatch.setattr(texp, '_REF_CACHE', {})
    jcfg = CASES['vib'][0]()
    job = new_job(port_cfg(jcfg), OptimizerConfig(), device='cpu')
    from joint_vae_tpu_torch.save_load.from_jax import state_dict_to_jax
    arrays = state_dict_to_jax(job.model)
    arrays['sigma_state/data'] = np.asarray([0.3], np.float32)
    write_reference_job(str(tmp_path / 'ref' / '5'), dict(jcfg.architecture),
                        arrays, training_parameters=dict(
                            job.training_parameters), sigma_subclass=True)
    imported = str(tmp_path / 'imported' / '5')
    timp.import_reference_job(str(tmp_path / 'ref' / '5'), imported,
                              device='cpu')
    assert 'module.vae_layers.layers' in sys.modules          # the stubs
    with pytest.raises(ImportError):
        jexp.reference_modules(stub)
    dst = str(tmp_path / 'out' / '5')
    texp.export_to_reference_job(imported, dst, reference_path=stub,
                                 device='cpu')
    sd = load_pth(os.path.join(dst, 'state.pth'))
    assert sd['sigma'].tolist() == [np.float32(0.3)]
    # the checkout's Sigma now unpickles the reference job's sigma
    back = timp.load_reference_state(str(tmp_path / 'ref' / '5' / 'state.pth'))
    assert back['sigma'].tolist() == [np.float32(0.3)]
    assert vars(sys.modules['module']).get('__file__', '').startswith(stub)
    jimp.import_reference_job(dst, str(tmp_path / 'jax_back' / '5'))
