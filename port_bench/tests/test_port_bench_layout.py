"""The benchmark is data: every cell, configuration, entry and per-layer
metric is a file of its own, found by its name in ``BENCHMARK.json``.
This checks that what the repository's ``BENCHMARK.json`` names exists
and fits the rules a run is held to: names and units of the allowed
characters, each cell reporting ``setup_s``, another end-to-end metric and
a per-layer one, each per-layer metric's cells reporting the end-to-end
metric it moves, and each configuration file describing the model the
program builds from it (its conv-kernel sites, routes and parameters).
"""

import json
import os
import re
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import run  # noqa: E402

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_names_units_and_paths():
    b = bench()
    assert b['command'][:2] == ['python3', 'port_bench/run.py']
    assert all(PATH.match(p) and not p.startswith('/') and '..' not in p
               for p in b['paths'])
    names = []
    for c in b['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert 0 < len(c['why']) <= 200 and '\n' not in c['why']
        assert os.path.exists(os.path.join(ROOT, c['file']))
        assert all(NAME.match(k) for k in c['reduced'])
        names.append(c['name'])
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['traffic']) and NAME.match(w['config'])
        assert 0 < len(w['why']) <= 200 and '\n' not in w['why']
        names.append(w['name'])
    for m in b['end_to_end'] + b['per_layer']:
        assert UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')
        names.append(m['name'])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in b['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize('cell', [w['name'] for w in bench()['workloads']])
def test_cell_files_and_metrics(cell):
    b = bench()
    wl = run.load_json(BENCH, 'workloads', cell + '.json')
    assert wl['name'] == cell and wl['chips'] == 1
    entry = [w for w in b['workloads'] if w['name'] == cell][0]
    assert (entry['config'], entry['traffic'], entry['why']) == (
        wl['config'], wl['traffic'], wl['why'])
    assert os.path.exists(os.path.join(BENCH, 'configs',
                                       wl['config'] + '.json'))
    assert hasattr(run.load_module('entries', wl['entry']), 'run')
    e2e = [m['name'] for m in run.cell_metrics(b, cell, False)]
    assert 'setup_s' in e2e and len(e2e) >= 2
    layer = run.cell_metrics(b, cell, True)
    assert layer
    for m in layer:
        assert hasattr(run.load_module('metrics', m['name']), 'read')
    assert set(wl['limits']) and all(v > 0 for v in wl['limits'].values())


def test_each_per_layer_metric_moves_what_its_cells_report():
    b = bench()
    cells = [w['name'] for w in b['workloads']]
    for m in b['per_layer']:
        assert m['moves'] in {e['name'] for e in b['end_to_end']}
        for cell in m.get('workloads', cells):
            assert cell in cells
            assert m['moves'] in [e['name']
                                  for e in run.cell_metrics(b, cell, False)]
        assert os.path.exists(os.path.join(BENCH, 'metrics',
                                           m['name'] + '.py'))
    layers = {}
    for m in b['per_layer']:
        layers.setdefault(m['layer'], set()).add(m['name'])
    assert set(layers) <= {'kernels', 'model step', 'device'}


@pytest.mark.parametrize('name', ['cifar100', 'cifar10-vgg'])
def test_configuration_is_the_programs(name):
    """The program's model, built as its training CLI builds the section,
    has the file's conv-kernel sites with their routes, and the file's
    parameter count; the benchmark's model configuration equals the
    CLI's."""
    from joint_vae_tpu_torch.models.cvnet import CVNet
    from joint_vae_tpu_torch.utils.parameters import (
        get_args, model_config_from_args, optimizer_config_from_args)
    from harness import program
    cfg = run.load_json(BENCH, 'configs', name + '.json')
    args = get_args(['--config', cfg['section']], 'train')
    assert program.model_config(cfg) == model_config_from_args(args)
    assert program.optimizer_config(cfg) == optimizer_config_from_args(args)
    assert (args.batch_size, list(args.data_augmentation)) == (
        cfg['batch_size'], cfg['data_augmentation'])
    model = CVNet(program.model_config(cfg))
    assert sum(p.numel() for p in model.parameters()) == cfg['params']
    sites = []
    for stack_name, stack in (('features', model.features_stack),
                              ('imager', model.imager)):
        for i, pl in enumerate(stack.plans):
            if pl.ltype in ('conv', 'deconv'):
                layer = getattr(stack, '{}_{}'.format(pl.ltype, i))
                if layer.route in ('same_grid', 'subpixel'):
                    sites.append((stack_name, i, layer.route))
    assert sites == [(s['stack'], s['layer'], s['route'])
                     for s in cfg['conv_sites']]


def test_workload_names_match_their_files():
    for f in os.listdir(os.path.join(BENCH, 'workloads')):
        wl = run.load_json(BENCH, 'workloads', f)
        assert f == wl['name'] + '.json'
