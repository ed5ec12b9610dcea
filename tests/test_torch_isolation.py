"""The port stands alone: no module of ``joint_vae_tpu_torch``, nothing in
``chip_smoke.py`` and nothing in the card-only kernel tests imports jax,
flax, optax or the JAX package, and importing them in a clean interpreter
loads neither."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'flax', 'optax', 'joint_vae_tpu')


def _port_sources():
    pkg = os.path.join(ROOT, 'joint_vae_tpu_torch')
    out = [os.path.join(ROOT, 'chip_smoke.py'),
           os.path.join(ROOT, 'tests', 'test_torch_kernels_cuda.py')]
    for dirpath, _, files in os.walk(pkg):
        out += [os.path.join(dirpath, f) for f in sorted(files)
                if f.endswith('.py')]
    return out


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, '{} imports {}'.format(os.path.relpath(path, ROOT), bad)


def test_clean_import_loads_no_jax():
    code = ('import sys; sys.path.insert(0, {root!r}); '
            'import chip_smoke, joint_vae_tpu_torch.serve, '
            'joint_vae_tpu_torch.cli.serve, joint_vae_tpu_torch.save_load.jobs, '
            'joint_vae_tpu_torch.train.trainer; '
            'bad = [m for m in sys.modules if m.split(".")[0] in {bad!r}]; '
            'print(bad); sys.exit(1 if bad else 0)').format(
                root=ROOT, bad=FORBIDDEN)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
