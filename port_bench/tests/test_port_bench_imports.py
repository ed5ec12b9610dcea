"""What a run loads, in fresh processes: the harness, every entry, every
per-layer reader and the reference load no module whose top-level name
(the part before the first dot) is ``jax``, ``jaxlib``, ``flax`` or
``joint_vae_tpu`` (the port's name, ``joint_vae_tpu_torch``, begins with
the JAX package's, so names are compared whole); the reference and what
it takes its inputs from load nothing of ``joint_vae_tpu_torch`` either.
Without a card, ``run.py`` exits non-zero, says so, and prints no result.
"""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

LOAD_ALL = r'''
import glob, json, os, sys
sys.path[:0] = [{bench!r}, {root!r}]
import run
from harness import compare, inputs, peaks, program, trace
from counts import flops
import calibrate
for kind in ('entries', 'metrics'):
    for f in sorted(glob.glob(os.path.join({bench!r}, kind, '*.py'))):
        run.load_module(kind, os.path.basename(f)[:-3])
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
'''

LOAD_REFERENCE = r'''
import json, sys
sys.path.insert(0, {bench!r})
from reference import loader, model, steps
from harness import compare, inputs
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
'''


def top_level_names(code: str) -> set:
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, '-c', code.format(bench=BENCH,
                                                            root=ROOT)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = top_level_names(LOAD_ALL)
    assert 'joint_vae_tpu_torch' in names
    assert not names & {'jax', 'jaxlib', 'flax', 'joint_vae_tpu'}


def test_the_reference_loads_nothing_of_the_program():
    names = top_level_names(LOAD_REFERENCE)
    assert not names & {'jax', 'jaxlib', 'flax', 'joint_vae_tpu',
                        'joint_vae_tpu_torch'}


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present: run.py would measure')
    out = subprocess.run(
        [sys.executable, os.path.join('port_bench', 'run.py'), '--workload',
         'cifar100-train', '--seed', str(2 ** 31 + 5), '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert out.returncode != 0
    assert 'no CUDA card' in out.stderr
    assert out.stdout.strip() == ''
