"""The port's export CLI (``python -m joint_vae_tpu_torch.cli.export_ref``)
against the JAX package's on the same jobs tree and the same stub
reference checkout (``torch_reference_stub.py``), on the CPU:

- ``--scan`` keeps the <dataset>/<arch>/<options>/<job#> layout; a
  corrupt job is logged and counted (``2 exported, 1 failed``, exit 1)
  while the others export, and the two CLIs write the same files (JSON
  equal as parsed, ``.pth`` contents bit-equal);
- ``--dry-run`` prints the same plan, writes nothing and needs no
  reference;
- without ``--reference`` and ``JVT_REFERENCE`` the CLI stops at
  argument parsing (exit 2);
- without ``--device`` the weights go to the card, so a host without one
  fails every job that has weights, with the reason, and exits 1.
"""

import os

import pytest

from joint_vae_tpu.cli.export_ref import main as jmain

from joint_vae_tpu_torch.cli.export_ref import main

from torch_export_cases import (assert_same, drop_stubs, load_pth,
                                tree_files, write_source)
from torch_reference_stub import stub_checkout

GOOD = ('mnist/archX/opt/12', 'mnist/archY/opt/3')


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('natroot')
    write_source('cvae_conv_records', str(root / GOOD[0]), job_number=12)
    write_source('jvae', str(root / GOOD[1]), job_number=3)
    bad = root / 'mnist' / 'archX' / 'opt' / '2'
    bad.mkdir(parents=True)
    (bad / 'params.json').write_text('{ this is not json')
    return root


@pytest.fixture(scope='module', autouse=True)
def _no_stubs_left():
    yield
    drop_stubs()


def test_scan_layout_and_corrupt_job(tree, tmp_path, capsys):
    stub = stub_checkout()
    out = tmp_path / 'port'
    rc = main(['--scan', str(tree), '--out', str(out), '--reference', stub,
               '--device', 'cpu'])
    text = capsys.readouterr().out
    assert rc == 1 and '2 exported, 1 failed' in text
    rc_jax = jmain(['--scan', str(tree), '--out', str(tmp_path / 'jax'),
                    '--reference', stub, '--platform', 'cpu'])
    assert rc_jax == 1
    assert '2 exported, 1 failed' in capsys.readouterr().out
    files = tree_files(out)
    assert files == tree_files(tmp_path / 'jax')
    for rel in GOOD:
        for f in ('params.json', 'train_params.json', 'history.json',
                  'state.pth', 'optimizer.pth'):
            assert os.path.join(rel, f) in files
    assert os.path.join(GOOD[0], 'samples/2/record-mnist.pth') in files
    assert not any(f.startswith('mnist/archX/opt/2/') for f in files)
    for rel in sorted(files):
        a, b = out / rel, tmp_path / 'jax' / rel
        if rel.endswith('.pth'):
            assert_same(load_pth(str(a)), load_pth(str(b)), rel)
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def test_dry_run_prints_the_plan(tree, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv('JVT_REFERENCE', raising=False)
    out = str(tmp_path / 'out')
    assert main(['--scan', str(tree), '--out', out, '--dry-run']) == 0
    text = capsys.readouterr().out
    assert jmain(['--scan', str(tree), '--out', out, '--dry-run',
                  '--platform', 'cpu']) == 0
    assert capsys.readouterr().out == text
    assert len(text.splitlines()) == 3 and 'exported' not in text
    assert not os.path.exists(out)


def test_no_reference_is_a_usage_error(tree, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv('JVT_REFERENCE', raising=False)
    with pytest.raises(SystemExit) as e:
        main(['--scan', str(tree), '--out', str(tmp_path / 'out')])
    assert e.value.code == 2
    assert 'no reference package' in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        main(['--out', str(tmp_path / 'out'), '--reference', stub_checkout()])
    assert e.value.code == 2


def test_the_card_by_default(tree, tmp_path, capsys, caplog):
    """No --device: each job's weights are loaded on the card, which this
    host lacks, so every job fails with the reason (no quiet CPU run)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    rc = main([str(tree / GOOD[1]), '--out', str(tmp_path / 'out'),
               '--reference', stub_checkout()])
    assert rc == 1
    assert '0 exported, 1 failed' in capsys.readouterr().out
    assert 'no CUDA device' in caplog.text
