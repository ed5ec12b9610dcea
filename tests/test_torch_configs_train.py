"""The vgg and autoencoder sections' twins trained 12 steps of the
section's optimizer from one init, the port against the JAX package's
``make_train_step``: every metric, parameter and the sigma state within
1e-4 (``tests/torch_config_twins.py``; the other sections' in
``test_torch_configs.py``)."""

import pytest

from torch_config_cases import SECTIONS
from torch_config_twins import check_train_steps


@pytest.mark.parametrize('section', SECTIONS[6:])
def test_section_train_steps_match_jax(section, monkeypatch):
    check_train_steps(section, monkeypatch)
