"""The port stands alone: no module of ``joint_vae_tpu_torch``, nothing in
``chip_smoke.py``, nothing in the card-only kernel tests, nothing in
the reference-layout writer and the stub reference checkout that
``chip_smoke.py`` shares with the tests (``tests/torch_reference_layout.py``,
``tests/torch_reference_stub.py``) and nothing in the port's quality run
(``scripts/torch_quality_run.py``) imports jax,
flax, optax, the JAX package or pandas (the card machine has no pandas:
the port's result tables are its own), and importing them in a clean
interpreter loads none of them."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'flax', 'optax', 'joint_vae_tpu', 'pandas')


def _port_sources():
    pkg = os.path.join(ROOT, 'joint_vae_tpu_torch')
    out = [os.path.join(ROOT, 'chip_smoke.py'),
           os.path.join(ROOT, 'tests', 'test_torch_kernels_cuda.py'),
           os.path.join(ROOT, 'tests', 'torch_reference_layout.py'),
           os.path.join(ROOT, 'tests', 'torch_reference_stub.py'),
           os.path.join(ROOT, 'scripts', 'torch_quality_run.py')]
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
            'sys.path.insert(0, {tests!r}); '
            'import chip_smoke, torch_reference_layout, '
            'torch_reference_stub, '
            'joint_vae_tpu_torch.serve, '
            'joint_vae_tpu_torch.cli.serve, joint_vae_tpu_torch.save_load.jobs, '
            'joint_vae_tpu_torch.train.trainer, joint_vae_tpu_torch.cli.test, '
            'joint_vae_tpu_torch.cli.results, '
            'joint_vae_tpu_torch.save_load.fetch, '
            'joint_vae_tpu_torch.results.tables, '
            'joint_vae_tpu_torch.ft, joint_vae_tpu_torch.ft.wim, '
            'joint_vae_tpu_torch.ft.job, joint_vae_tpu_torch.ft.array, '
            'joint_vae_tpu_torch.ft.poscod, joint_vae_tpu_torch.ft.datasets, '
            'joint_vae_tpu_torch.ft.scheduler, joint_vae_tpu_torch.cli.ft, '
            'joint_vae_tpu_torch.utils.inspection, '
            'joint_vae_tpu_torch.models.resnet, '
            'joint_vae_tpu_torch.models.cvnet, '
            'joint_vae_tpu_torch.save_load.from_jax, '
            'joint_vae_tpu_torch.save_load.transfer, '
            'joint_vae_tpu_torch.utils.mutual_information, '
            'joint_vae_tpu_torch.evals.aggregation, '
            'joint_vae_tpu_torch.evals.cascad, '
            'joint_vae_tpu_torch.evals.sample, '
            'joint_vae_tpu_torch.results.mutual_info, '
            'joint_vae_tpu_torch.cli.sample, '
            'joint_vae_tpu_torch.cli.aggregate, '
            'joint_vae_tpu_torch.cli.cascade, '
            'joint_vae_tpu_torch.cli.grid, '
            'joint_vae_tpu_torch.cli.import_ref, '
            'joint_vae_tpu_torch.save_load.import_reference, '
            'joint_vae_tpu_torch.save_load.export_reference, '
            'joint_vae_tpu_torch.cli.export_ref, '
            'joint_vae_tpu_torch.save_load.tv_resnet, '
            'joint_vae_tpu_torch.utils.device, '
            'joint_vae_tpu_torch.utils.profiling; '
            'bad = [m for m in sys.modules if m.split(".")[0] in {bad!r}]; '
            'print(bad); sys.exit(1 if bad else 0)').format(
                root=ROOT, tests=os.path.join(ROOT, 'tests'), bad=FORBIDDEN)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
