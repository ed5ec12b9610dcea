"""The port's importer on reference jobs with torchvision trunks, against
the JAX package's: the full-width ``resnet18`` (BasicBlocks) and
``densenet121`` (dense blocks, transitions, norm5) of
``save_load/tv_resnet.py`` on 32x32 inputs at batch 4, with random
running statistics and BatchNorm affines, keyed as the reference keys
them (``features.<i>...`` over ``children()[:-1]``).  The checks of
``test_torch_import_reference.py`` (``torch_import_cases.py``): the JAX
importer gives the trunk back, the two importers' files are equal, and
``evaluate`` on the imports agrees within 5e-4; besides, the imported
trunk's features agree with ``tv_resnet``'s eval-mode forward of the
same weights within 1e-4 (|tv| + rms(tv)).  A file of its own: the JAX
package's full-width DenseNet template and evaluate take a minute to
build.
"""

import pytest

from torch_import_cases import (CASES, check_evaluate, check_files,
                                check_writer, drop_reference_stubs,
                                import_case)

TRUNKS = sorted(k for k, (_, _, o) in CASES.items() if 'trunk' in o)


@pytest.fixture
def imported(request, tmp_path_factory):
    return import_case(request.param, tmp_path_factory)


@pytest.fixture(autouse=True)
def _no_reference_stubs_left():
    yield
    drop_reference_stubs()


@pytest.mark.parametrize('imported', TRUNKS, indirect=True)
def test_writer_gives_the_trunk_back(imported):
    check_writer(imported)


@pytest.mark.parametrize('imported', TRUNKS, indirect=True)
def test_port_import_files_equal_jax(imported):
    check_files(imported)


@pytest.mark.parametrize('imported', TRUNKS, indirect=True)
def test_evaluate_and_features_agree(imported, monkeypatch):
    check_evaluate(imported, monkeypatch)
