"""Dataset registry + name grammar.

The port's own copy of ``joint_vae_tpu/data/registry.py``.
Registry semantics follow the reference's INI-driven properties
(ref utils/torch_load.py:29-87, data/sets.ini): per-set shape, classes
(inline, $letters/$numbers macros, or from a class file), pre/post transform
micro-DSL, same-size OOD companionship, synthetic by-shape sets.  Defaults
are a Python dict here; an INI file can extend/override them
(``load_registry_ini``).

Name grammar (ref utils/torch_load.py:584-682):
- rotation suffix '90':     mnist90 = mnist with H/W transposed
- heldout by '-':           mnist-3-4 = mnist with classes 3, 4 removed
- kept by '+':              cifar10+0+1 = only classes 0, 1 kept
- same-size companions:     all sets with the same shape (+ the rotated self)
"""

import configparser
import os
import string
from typing import Dict, List, Optional, Tuple

_NUMBERS = [str(i) for i in range(10)]
_LETTERS = list(string.ascii_lowercase)

CIFAR10_CLASSES = ['airplane', 'automobile', 'bird', 'cat', 'deer',
                   'dog', 'frog', 'horse', 'ship', 'truck']

FASHION_CLASSES = ['t-shirt/top', 'trouser', 'pullover', 'dress', 'coat',
                   'sandal', 'shirt', 'sneaker', 'bag', 'ankle boot']

# CIFAR-100 fine labels (alphabetical, the torchvision convention)
CIFAR100_CLASSES = [
    'apple', 'aquarium fish', 'baby', 'bear', 'beaver', 'bed', 'bee',
    'beetle', 'bicycle', 'bottle', 'bowl', 'boy', 'bridge', 'bus',
    'butterfly', 'camel', 'can', 'castle', 'caterpillar', 'cattle', 'chair',
    'chimpanzee', 'clock', 'cloud', 'cockroach', 'couch', 'crab',
    'crocodile', 'cup', 'dinosaur', 'dolphin', 'elephant', 'flatfish',
    'forest', 'fox', 'girl', 'hamster', 'house', 'kangaroo', 'keyboard',
    'lamp', 'lawn mower', 'leopard', 'lion', 'lizard', 'lobster', 'man',
    'maple tree', 'motorcycle', 'mountain', 'mouse', 'mushroom', 'oak tree',
    'orange', 'orchid', 'otter', 'palm tree', 'pear', 'pickup truck',
    'pine tree', 'plain', 'plate', 'poppy', 'porcupine', 'possum', 'rabbit',
    'raccoon', 'ray', 'road', 'rocket', 'rose', 'sea', 'seal', 'shark',
    'shrew', 'skunk', 'skyscraper', 'snail', 'snake', 'spider', 'squirrel',
    'streetcar', 'sunflower', 'sweet pepper', 'table', 'tank', 'telephone',
    'television', 'tiger', 'tractor', 'train', 'trout', 'tulip', 'turtle',
    'wardrobe', 'whale', 'willow tree', 'wolf', 'woman', 'worm']

# Default registry — mirrors the reference's data/sets.ini entries.
DEFAULT_REGISTRY: Dict[str, dict] = {
    # synthetic by-shape OOD sets
    'const28': {'shape': (1, 28, 28), 'by_shape': True},
    'const32': {'shape': (3, 32, 32), 'by_shape': True},
    'uniform28': {'shape': (1, 28, 28), 'by_shape': True},
    'uniform32': {'shape': (3, 32, 32), 'by_shape': True},
    # core image sets
    'mnist': {'shape': (1, 28, 28), 'classes': _NUMBERS},
    'mnist32p': {'shape': (3, 32, 32), 'classes': _NUMBERS,
                 'pre_transform': 'tensor g2c pad-2', 'parent': 'mnist'},
    'mnist32r': {'shape': (3, 32, 32), 'classes': _NUMBERS,
                 'pre_transform': 'resize tensor g2c', 'parent': 'mnist'},
    'fashion': {'shape': (1, 28, 28), 'classes': FASHION_CLASSES},
    'fashion32p': {'shape': (3, 32, 32), 'classes': FASHION_CLASSES,
                   'pre_transform': 'tensor g2c pad-2', 'parent': 'fashion'},
    'fashion32r': {'shape': (3, 32, 32), 'classes': FASHION_CLASSES,
                   'pre_transform': 'resize tensor g2c', 'parent': 'fashion'},
    'letters': {'shape': (1, 28, 28), 'classes': _LETTERS,
                'pre_transform': 'rotate-270 hflip',
                'target_transform': 'y-1'},
    'cifar10': {'shape': (3, 32, 32), 'classes': CIFAR10_CLASSES},
    'cifar100': {'shape': (3, 32, 32), 'classes': CIFAR100_CLASSES},
    'svhn': {'shape': (3, 32, 32), 'classes': _NUMBERS},
    'lsunc': {'shape': (3, 32, 32), 'classes': None},
    'lsunr': {'shape': (3, 32, 32), 'classes': None},
    'dtd': {'shape': (3, 32, 32), 'classes': None},
    'random300k': {'shape': (3, 32, 32), 'classes': None, 'by_shape': True},
    'imagenet12': {'shape': (3, 224, 224), 'classes': None},
    # ImageNet subsets restricted by wnid class files (ref data/imagenet*.txt
    # + ImageFolderWithClassesInFile, utils/torch_load.py:250-294;
    # sets.ini [imagenet1k/20/2]).
    'imagenet1k': {'shape': (3, 224, 224),
                   'classes': ['c{:03d}'.format(i) for i in range(1000)],
                   'classes_from_file': 'data/imagenet1k.txt'},
    'imagenet20': {'shape': (3, 224, 224),
                   'classes': ['c{:02d}'.format(i) for i in range(20)],
                   'classes_from_file': 'data/imagenet20.txt'},
    'imagenet2': {'shape': (3, 224, 224), 'classes': ['c0', 'c1'],
                  'classes_from_file': 'data/imagenet2.txt'},
    # procedural benchmark set (this framework's own): 10 shape classes with
    # nuisance position/scale/color variation — learnable structure for
    # quality runs where no real data is at hand
    'shapes32': {'shape': (3, 32, 32), 'procedural': True,
                 'classes': ['disk', 'ring', 'square', 'frame', 'cross',
                             'hbar', 'vbar', 'stripes', 'checker', 'dot']},
}


_registry_cache: Optional[Dict[str, dict]] = None


def dataset_properties(conf_file: Optional[str] = None,
                       reload: bool = False) -> Dict[str, dict]:
    global _registry_cache
    if _registry_cache is not None and not reload:
        return _registry_cache
    reg = {k: dict(v) for k, v in DEFAULT_REGISTRY.items()}
    if conf_file:
        reg.update(load_registry_ini(conf_file))
    for name, p in reg.items():
        cf = p.get('classes_from_file')
        if cf:
            # Resolve to an absolute path so downstream consumers (the
            # image-folder loader's wnid restriction) can
            # open it from any cwd; keep the key in the props.
            resolved = _resolve_data_path(cf)
            if resolved:
                p['classes_from_file'] = resolved
            classes = _read_class_file(cf)
            if classes:
                p['classes'] = classes
        p.setdefault('classes', None)
        p.setdefault('by_shape', False)
        p.setdefault('pre_transform', '')
        p.setdefault('target_transform', '')
        p['labels'] = len(p['classes']) if p['classes'] else 0
    _registry_cache = reg
    return reg


def _resolve_data_path(path: str) -> Optional[str]:
    """Absolute path for a registry-relative file, searched against
    $JVT_DATA_DIR's parent, the repo root, and the cwd.  None if absent."""
    if os.path.isabs(path):
        return path if os.path.exists(path) else None
    roots = []
    dd = os.environ.get('JVT_DATA_DIR')
    if dd:
        roots.append(os.path.dirname(os.path.abspath(dd)))
    roots.append(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    roots.append('.')
    for root in roots:
        p = os.path.join(root, path)
        if os.path.exists(p):
            return os.path.abspath(p)
    return None


def _read_class_file(path: str) -> Optional[list]:
    """Class names from a wnid list file ('<wnid> <name with_underscores>'
    per line, ref utils/torch_load.py:72).  None when absent (callers keep
    their inline fallback classes)."""
    p = _resolve_data_path(path)
    if p is None:
        return None
    with open(p) as f:
        return [' '.join(l.split()[1:]).replace('_', ' ')
                for l in f if l.strip() and not l.startswith('#')]


def load_registry_ini(conf_file: str) -> Dict[str, dict]:
    """Parse an INI file with the reference's sets.ini schema."""
    cp = configparser.ConfigParser()
    cp.read(conf_file)
    out = {}
    for s in cp.sections():
        p_ = cp[s]
        p = {'shape': tuple(int(_) for _ in p_['shape'].split())}
        classes = p_.get('classes', '')
        if p_.get('classes_from_file'):
            cf = p_['classes_from_file']
            p['classes_from_file'] = cf
            # resolve against the INI's own directory first, then the same
            # lookup (+ blank-line guard) as the built-in registry
            beside = os.path.join(os.path.dirname(os.path.abspath(conf_file)),
                                  cf)
            classes = _read_class_file(
                beside if os.path.exists(beside) else cf)
            if classes is None:
                raise FileNotFoundError(
                    'classes_from_file {} not found for [{}]'.format(cf, s))
            p['classes'] = classes
        elif classes == '$numbers':
            p['classes'] = list(_NUMBERS)
        elif classes == '$letters':
            p['classes'] = list(_LETTERS)
        elif classes:
            p['classes'] = [c.replace('_', ' ') for c in classes.split()]
        else:
            p['classes'] = None
        for k in ('pre_transform', 'target_transform', 'root', 'folder'):
            if p_.get(k):
                p[k] = p_[k]
        if p_.get('by_shape'):
            p['by_shape'] = p_.getboolean('by_shape')
        out[s] = p
    return out


def get_heldout_classes_by_name(dataset: str) -> Tuple[str, List[int]]:
    """'mnist-3-4' -> ('mnist', [3, 4]); 'cifar10+0+1' -> ('cifar10',
    [2..9]) (ref utils/torch_load.py:654-676)."""
    if '-' in dataset:
        parts = dataset.split('-')
        heldout = sorted(int(_) for _ in parts[1:])
        return parts[0], heldout
    if '+' in dataset:
        parts = dataset.split('+')
        parent = parts[0]
        C = get_shape_by_name(parent)[1]
        heldout = [c for c in range(C) if str(c) not in parts]
        return parent, heldout
    return dataset, []


def get_name_by_heldout_classes(dataset: str, *heldout: int) -> str:
    """(ref utils/torch_load.py:684-693)."""
    if not heldout:
        return dataset
    C = get_shape_by_name(dataset)[1]
    heldout = sorted(heldout)
    if len(heldout) / C > 0.5:
        kept = [str(c) for c in range(C) if c not in heldout]
        return dataset + '+' + '+'.join(kept)
    return dataset + '-' + '-'.join(str(c) for c in heldout)


def get_shape_by_name(set_name: str, transform: str = 'default'):
    """-> (shape, num_labels) (ref utils/torch_load.py:584-604)."""
    props = dataset_properties()
    if set_name.endswith('90'):
        shape, labels = get_shape_by_name(set_name[:-2])
        return (shape[0], shape[2], shape[1]), labels
    set_name, heldout = get_heldout_classes_by_name(set_name)
    if set_name not in props:
        return None, None
    shape = props[set_name]['shape']
    num_labels = props[set_name]['labels'] - len(heldout)
    if transform == 'pad':
        p = 2
        shape = (shape[0], shape[1] + 2 * p, shape[2] + 2 * p)
    return shape, num_labels


def get_same_size_by_name(set_name: str, rotated: bool = False) -> List[str]:
    """Same-shape OOD companions (ref utils/torch_load.py:607-632)."""
    props = dataset_properties()
    if set_name.endswith('-?'):
        return [set_name[:-2] + '+?']
    if set_name.endswith('90'):
        return get_same_size_by_name(set_name[:-2], rotated=True)
    parent, heldout = get_heldout_classes_by_name(set_name)
    if heldout:
        C = get_shape_by_name(parent)[1]
        comp = [c for c in range(C) if c not in heldout]
        return [get_name_by_heldout_classes(parent, *comp)]
    if set_name not in props:
        return []
    shape = props[set_name]['shape']
    same = [s for s in props if props[s]['shape'] == shape]
    if not rotated:
        same.remove(set_name)
        same.append(set_name + '90')
    return same


def get_classes_by_name(dataset: str) -> List[str]:
    """(ref utils/torch_load.py:635-651)."""
    if dataset.endswith('90'):
        return get_classes_by_name(dataset[:-2])
    parent, ho = get_heldout_classes_by_name(dataset)
    props = dataset_properties()[parent]
    classes = props.get('classes') or [parent]
    return [c for i, c in enumerate(classes) if i not in ho]
