"""On the card: the control, the plain reference in TF32 put in the
program's place, comes out not correct against each cell's limits, as do
the reference's steps on half of each batch.  At the cells' own batch,
L and widths, on a smaller training set and one scored batch, so that a
test run holds it; ``calibrate.py`` takes the same readings at the cells'
full size.  Run on the card with ``python -m pytest port_bench/tests -m
cuda``; skipped without one.
"""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

CELLS = ['cifar100-train', 'cifar100-score', 'cifar10-vgg-train',
         'cifar10-vgg-score']


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(card, cell):
    import calibrate
    wl, cfg = calibrate.load(cell)
    if wl['entry'] == 'train':
        kinds = ['control', 'half_batch']
        got = calibrate.train_readings(wl, cfg, 2 ** 31 + 3, kinds, card,
                                       set_size=4096)
    else:
        kinds = ['control']
        got = calibrate.score_readings(wl, cfg, 2 ** 31 + 3, kinds, card,
                                       batches=1)
    for kind in kinds:
        over = [k for k, v in wl['limits'].items() if got[kind][k] > v]
        assert over, json.dumps({kind: got[kind], 'limits': wl['limits']})
