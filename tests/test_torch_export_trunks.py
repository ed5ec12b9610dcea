"""The port's exporter on jobs with torchvision trunks, against the JAX
package's, through the stub reference checkout: the full-width
``resnet18`` and ``densenet121`` on 32x32 inputs with random running
statistics (``torch_export_cases.py``), both exports equal file for file
(``.pth`` contents bit-equal, key order included) and import(export(job))
through both importers bit-equal to the source.  The checkout routes only
``resnet*`` to its trunk class, as the reference does: the densenet121
template builds through ``tv_resnet.route_densenet``, which both packages
apply once.  A file of its own: the JAX package's full-width DenseNet
template takes most of a minute to build.
"""

import pytest

from joint_vae_tpu.save_load import export_reference as jexp
from joint_vae_tpu.save_load import tv_resnet as jtv

from joint_vae_tpu_torch.save_load import export_reference as texp
from joint_vae_tpu_torch.save_load import tv_resnet as ttv

from torch_export_cases import (check_files, check_round_trip, drop_stubs,
                                export_case)
from torch_reference_stub import stub_checkout

TRUNKS = ['densenet121', 'resnet18']


@pytest.fixture
def exported(request, tmp_path_factory):
    return export_case(request.param, tmp_path_factory)


@pytest.fixture(scope='module', autouse=True)
def _no_stubs_left():
    yield
    drop_stubs()


@pytest.mark.parametrize('exported', TRUNKS, indirect=True)
def test_port_export_files_equal_jax(exported):
    files = check_files(exported)
    assert {'state.pth', 'optimizer.pth'} <= files


@pytest.mark.parametrize('exported', TRUNKS, indirect=True)
def test_port_import_gives_the_source_back(exported):
    check_round_trip(exported, exported.back_port)


@pytest.mark.parametrize('exported', TRUNKS, indirect=True)
def test_jax_import_gives_the_source_back(exported):
    check_round_trip(exported, exported.back_jax)


def test_route_densenet_once():
    """The checkout's own routing refuses densenet121; the cvae module's
    symbol is wrapped once, whichever package routes first."""
    import sys
    stub = stub_checkout()
    net_cls, _ = texp.reference_modules(stub)
    jexp.reference_modules(stub)
    ref_cvae = sys.modules[net_cls.__module__]
    conv = sys.modules['module.vae_layers.conv']
    with pytest.raises(ValueError, match='densenet121'):
        conv.build_de_conv_layers((3, 32, 32), 'densenet121', where='input')
    routed = ref_cvae.build_de_conv_layers
    assert routed is not conv.build_de_conv_layers
    for route in (ttv.route_densenet, jtv.route_densenet):
        route(ref_cvae)
        assert ref_cvae.build_de_conv_layers is routed
    trunk = routed((3, 32, 32), 'densenet121', where='input')
    assert isinstance(trunk, conv.ResOrDenseNetFeatures)
    assert type(list(trunk.children())[0].denseblock1).__name__ == \
        'Sequential'


def test_install_leaves_a_real_torchvision(monkeypatch):
    """``install`` fills a stub's models module, never a real one."""
    import sys
    import types
    real = types.ModuleType('torchvision.models')
    real.__file__ = 'models/__init__.py'
    monkeypatch.setitem(sys.modules, 'torchvision.models', real)
    ttv.install()
    assert not hasattr(real, 'resnet18')
    stub = types.ModuleType('torchvision.models')
    monkeypatch.setitem(sys.modules, 'torchvision.models', stub)
    ttv.install()
    assert stub.resnet18 is ttv.resnet18 and stub.densenet201 is \
        ttv.densenet201
