"""The port's dataset registry and ``get_dataset`` against the JAX
package's: for each name the registry's answers (shape, labels, classes,
heldout split, same-size companions) are equal, and so are the arrays of
``get_dataset`` at size 64 (numpy from the same seeds, real files where
they exist, else the flagged synthetic substitute)."""

import os

import numpy as np
import pytest

from joint_vae_tpu.data import loaders as jloaders
from joint_vae_tpu.data import registry as jreg

from joint_vae_tpu_torch.data import loaders as tloaders
from joint_vae_tpu_torch.data import registry as treg

NAMES = ['cifar100', 'cifar10', 'svhn', 'lsunc', 'shapes32', 'mnist32p',
         'mnist90', 'cifar10-3-4', 'cifar10+0+1', 'const32']


@pytest.mark.parametrize('name', NAMES)
def test_registry_and_arrays_match_jax(name):
    assert treg.get_shape_by_name(name) == jreg.get_shape_by_name(name)
    assert treg.get_classes_by_name(name) == jreg.get_classes_by_name(name)
    assert (treg.get_heldout_classes_by_name(name)
            == jreg.get_heldout_classes_by_name(name))
    assert (treg.get_same_size_by_name(name)
            == jreg.get_same_size_by_name(name))
    got = tloaders.get_dataset(name, size=64)
    want = jloaders.get_dataset(name, size=64)
    for t, j in zip(got, want):
        assert t.data.dtype == j.data.dtype and t.data.shape == j.data.shape
        np.testing.assert_array_equal(t.data, j.data)
        np.testing.assert_array_equal(t.targets, j.targets)
        assert (t.name, t.classes, t.heldout, t.synthetic, t.same_size,
                t.transformer) == (j.name, j.classes, j.heldout, j.synthetic,
                                   j.same_size, j.transformer)


def test_transformers_splits_and_require_real():
    for tf in ('pad', 'crop'):
        t, = (s for s in tloaders.get_dataset('mnist', transformer=tf,
                                              splits=['test'], size=16) if s)
        j, = (s for s in jloaders.get_dataset('mnist', transformer=tf,
                                              splits=['test'], size=16) if s)
        np.testing.assert_array_equal(t.data, j.data)
    assert tloaders.get_dataset('svhn', splits=['test'], size=8)[0] is None
    if tloaders.get_dataset('cifar100', splits=['test'], size=8)[1].synthetic:
        with pytest.raises(FileNotFoundError):
            tloaders.get_dataset('cifar100', splits=['test'], size=8,
                                 require_real=True)
    with pytest.raises(ValueError):
        tloaders.get_dataset('no-such-set', splits=['test'])


def test_registry_ini_and_class_files(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, 'data', 'imagenet2.txt')) as f:
        (tmp_path / 'two.txt').write_text(f.read())
    ini = tmp_path / 'sets.ini'
    ini.write_text('[toy]\nshape = 3 16 16\nclasses = $numbers\n'
                   'pre_transform = tensor\n\n[img]\nshape = 3 64 64\n'
                   'classes_from_file = two.txt\n')
    assert treg.load_registry_ini(str(ini)) == jreg.load_registry_ini(str(ini))
    props_t = treg.dataset_properties()['imagenet2']
    props_j = jreg.dataset_properties()['imagenet2']
    assert props_t['classes'] == props_j['classes']
    assert len(props_t['classes']) == 2


def test_image_folder_reader_matches_jax(tmp_path, monkeypatch):
    """root/<split>/<class>/*.png decoded to uint8 (C, H, W), restricted
    to a class file: the same arrays as the JAX reader's direct decode."""
    from PIL import Image
    rng = np.random.default_rng(0)
    for split in ('train', 'val'):
        for c in ('n01', 'n02', 'n03'):
            d = tmp_path / split / c
            d.mkdir(parents=True)
            for i in range(2):
                Image.fromarray(rng.integers(0, 256, (20, 24, 3), np.uint8)
                                ).save(str(d / '{}.png'.format(i)))
    cls = tmp_path / 'classes.txt'
    cls.write_text('n01 first\nn03 third\n')
    monkeypatch.setenv('JVT_INGEST_CACHE', '0')
    for split in ('train', 'test'):
        t = tloaders._load_image_folder(str(tmp_path), (3, 8, 8), split,
                                        str(cls))
        j = jloaders._load_image_folder(str(tmp_path), (3, 8, 8), split,
                                        str(cls))
        assert t[0].dtype == np.uint8 and t[0].shape == (4, 3, 8, 8)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
