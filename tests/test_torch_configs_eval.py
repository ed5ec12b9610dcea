"""The named sections' twins (the section's own layer structure, conv
widths cut; ``tests/torch_config_cases.py``) through the port's
``evaluate`` against the JAX package's, in training mode and in
per-class test mode, within 5e-4 (``tests/torch_config_twins.py``)."""

import pytest

from torch_config_cases import SECTIONS
from torch_config_twins import check_evaluate


@pytest.mark.parametrize('train', [False, True], ids=['per_class', 'train'])
@pytest.mark.parametrize('section', SECTIONS)
def test_section_evaluate_matches_jax(section, train, monkeypatch):
    check_evaluate(section, train, monkeypatch)
