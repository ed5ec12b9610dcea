"""A run driven past its look for a card, on the CPU at the narrowed
twins of ``test_port_bench_reference.py``, with the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have
(a step that leaves the state unchanged; half of each batch left out, the
mean taken over the rest; an answer altered where it is produced), and
true with nothing broken.  The cells take one card, so no exchange
between cards can be left out.  The limits are the cells' own.
"""

import argparse
import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [HERE, BENCH, os.path.dirname(BENCH)]

import run                                        # noqa: E402
from test_port_bench_reference import load_config, twin   # noqa: E402
from joint_vae_tpu_torch import serve             # noqa: E402
from joint_vae_tpu_torch.train import steps       # noqa: E402

SMALL = {'batch_size': 16, 'set_size': 96, 'trace_steps': 8,
         'metrics_every': 4, 'pool_batches': 3, 'compared_batches': 2,
         'trace_batches': 2}


def measure(cell: str) -> dict:
    wl = run.load_json(BENCH, 'workloads', cell + '.json')
    cfg = twin(load_config(wl['config']))
    wl = dict(wl, **SMALL)
    if 'L' in wl:
        wl['L'] = 4
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 99, seconds=0.5,
                              trace=0)
    return run.measure(args, torch.device('cpu'), wl, cfg)


def unchanged_state(monkeypatch):
    body = steps.TrainStep._body

    def frozen(self, state, *a, **k):
        keep = [p.detach().clone() for p in self.model.parameters()]
        out = body(self, state, *a, **k)
        with torch.no_grad():
            for p, v in zip(self.model.parameters(), keep):
                p.copy_(v)
        return out
    monkeypatch.setattr(steps.TrainStep, '_body', frozen)


def half_batch(monkeypatch):
    body = steps.TrainStep._body

    def half(self, state, x, y, eps=None):
        h = x.shape[0] // 2
        return body(self, state, x[:h], y[:h], eps)
    monkeypatch.setattr(steps.TrainStep, '_body', half)


def altered_answer(monkeypatch):
    score = serve.Scorer._score

    def altered(self, *a, **k):
        out = score(self, *a, **k)
        packed = out['packed'].clone()
        packed[2, 0] = packed[2, 0] * (1 + 1e-3)    # one image's first score
        return {'packed': packed}
    monkeypatch.setattr(serve.Scorer, '_score', altered)


CASES = [('cifar100-train', None, True), ('cifar10-vgg-train', None, True),
         ('cifar100-score', None, True), ('cifar10-vgg-score', None, True),
         ('cifar100-train', unchanged_state, False),
         ('cifar10-vgg-train', unchanged_state, False),
         ('cifar100-train', half_batch, False),
         ('cifar10-vgg-train', half_batch, False),
         ('cifar100-score', altered_answer, False),
         ('cifar10-vgg-score', altered_answer, False)]


@pytest.mark.parametrize('cell, fault, correct', CASES,
                         ids=['{}-{}'.format(c, f.__name__ if f else 'sound')
                              for c, f, _ in CASES])
def test_fault_reads_incorrect(monkeypatch, cell, fault, correct):
    if fault is not None:
        fault(monkeypatch)
    out = measure(cell)
    assert out['correct'] is correct, json.dumps(out['checks'])
