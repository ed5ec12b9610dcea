"""Fine-tuning dataset utilities: seeded sub-sampling, labeled mixtures,
estimated-label attachment and the WIM 'moving set'.

Port of ``joint_vae_tpu/ft/datasets.py`` (numpy over the port's
``data/loaders.ArrayDataset``; its arrays equal the JAX package's), of
ref ``ft/datasets.py``:

- :class:`SubSampledDataset` (:68): seeded permutation + task-indexed
  slicing, with a ``bar()`` complement mode;
- :class:`MixtureDataset` (:187): named components with target mixture
  ratios, labels = component index, ``extract_subdataset``;
- :class:`EstimatedLabelsDataset` (:22): attaches y-hat to x;
- :func:`create_moving_set` (:383): ind test + OOD mixture + padding +
  optional mix-padding built from the complements.

All on whole-array numpy datasets (ArrayDataset), so mixture construction is
vectorized indexing, not per-item __getitem__ chains.
"""

from typing import Dict, Optional, Sequence

import numpy as np

from ..data.loaders import ArrayDataset, get_dataset, to_float


def _same_dtype(parts):
    """Mixture components may mix uint8 (ingest-cached) and float32 sets;
    concatenating raw would let numpy promote 0..255 uint8 next to 0..1
    floats — normalize everything to float32 [0,1] when dtypes differ."""
    if len({p.dtype for p in parts}) > 1:
        return [to_float(p) for p in parts]
    return list(parts)


class SubSampledDataset(ArrayDataset):
    def __init__(self, dataset: ArrayDataset, length: Optional[int] = None,
                 seed: int = 0, task: Optional[int] = 0):
        self._parent = dataset
        self._seed = seed
        self._task = task
        self.maxlength = len(dataset)
        self._bar = False
        # length=0 is a real request for an empty subset (ref shrink(),
        # ft/datasets.py:151-153) — only None means "everything"
        length = self.maxlength if length is None else length
        self._length = min(length, self.maxlength)
        idx = self._indices()
        super().__init__(dataset.data[idx], dataset.targets[idx],
                         'sub-{}'.format(dataset.name), dataset.classes,
                         dataset.transformer, dataset.heldout,
                         dataset.synthetic, dataset.same_size)

    def _indices(self) -> np.ndarray:
        rng = np.random.default_rng(self._seed)
        perm = rng.permutation(self.maxlength)
        L, t = self._length, self._task
        if L == 0:
            # empty subset; the complement is also truncated to L (= empty),
            # and array_split(perm, 0) would raise in the stratified branch
            return perm[:0]
        if t is None:
            # stratified: one sample per bundle (ref ft/datasets.py:87-92)
            bundles = np.array_split(perm, L)
            sel = np.array([b[0] for b in bundles if len(b)])
        else:
            # modulo wraparound so every task index yields L samples
            # (ref ft/datasets.py:182: _idx[(idx + shift) % len(_idx)])
            sel = perm[(t * L + np.arange(L)) % self.maxlength]
        if self._bar:
            mask = np.ones(self.maxlength, bool)
            mask[sel] = False
            comp = perm[mask[perm]]
            sel = comp[:L] if len(comp) >= L else comp
        return sel

    def bar(self, b: bool = True):
        """Switch to the complement of the selected slice
        (ref ft/datasets.py:120-130)."""
        self._bar = b
        idx = self._indices()
        self.data = self._parent.data[idx]
        self.targets = self._parent.targets[idx]
        return self


class MixtureDataset(ArrayDataset):
    """Mixture of named components; targets = component index.

    mix: scalar (equal ratios) or {name: ratio}; length: total size.
    """

    def __init__(self, mix=1, seed: int = 0, task: Optional[int] = 0,
                 length: Optional[int] = None, **datasets: ArrayDataset):
        names = sorted(datasets)
        if isinstance(mix, dict):
            ratios = np.array([float(mix.get(n, 0)) for n in names])
        else:
            ratios = np.ones(len(names))
        total_ratio = ratios.sum()
        if total_ratio <= 0:
            ratios = np.ones(len(names))
            total_ratio = ratios.sum()
        ratios = ratios / total_ratio
        if length is None:
            length = sum(len(d) for d in datasets.values())

        self.component_names = names
        self._bar = False
        self._seed = seed
        self._task = task
        parts, labels = [], []
        self._components: Dict[str, ArrayDataset] = {}
        for i, n in enumerate(names):
            li = int(round(ratios[i] * length))
            if li == 0:
                continue
            sub = SubSampledDataset(datasets[n], li, seed=seed + i, task=task)
            self._components[n] = sub
            parts.append(sub.data)
            labels.append(np.full(len(sub), i, np.int32))
        data = (np.concatenate(_same_dtype(parts)) if parts
                else np.zeros((0, 1, 1, 1), np.float32))
        y = np.concatenate(labels) if labels else np.zeros((0,), np.int32)
        rng = np.random.default_rng((seed, 17))
        order = rng.permutation(len(data))
        name = 'mix-' + '-'.join(names)
        super().__init__(data[order], y[order], name,
                         classes=names)
        self.mix = {n: float(r) for n, r in zip(names, ratios)}

    def bar(self, b: bool = True):
        # labels must stay the component's index in component_names (the
        # __init__ convention) — enumerating the surviving _components
        # would shift every label after a dropped (ratio 0) component
        for c in self._components.values():
            c.bar(b)
        parts = [c.data for c in self._components.values()]
        labels = [np.full(len(c), self.component_names.index(n), np.int32)
                  for n, c in self._components.items()]
        data = (np.concatenate(_same_dtype(parts)) if parts
                else np.zeros((0, 1, 1, 1), np.float32))
        y = np.concatenate(labels) if labels else np.zeros((0,), np.int32)
        rng = np.random.default_rng((self._seed, 17))
        order = rng.permutation(len(data))
        self.data, self.targets = data[order], y[order]
        self._bar = b
        return self

    def extract_subdataset(self, name: str) -> ArrayDataset:
        """(ref ft/datasets.py:187+ extract_subdataset)."""
        i = self.component_names.index(name)
        m = self.targets == i
        return ArrayDataset(self.data[m], np.zeros(m.sum(), np.int32),
                            name)


class EstimatedLabelsDataset(ArrayDataset):
    """Pairs inputs with estimated labels y-hat (ref ft/datasets.py:22-66).
    targets stay the true labels; ``estimated`` carries y-hat."""

    def __init__(self, dataset: ArrayDataset, estimated: np.ndarray):
        assert len(estimated) == len(dataset)
        super().__init__(dataset.data, dataset.targets, dataset.name,
                         dataset.classes, dataset.transformer,
                         dataset.heldout, dataset.synthetic, dataset.same_size)
        self.estimated = np.asarray(estimated, np.int32)
        self.return_estimated = True


def create_moving_set(ind: str, transformer: str = 'default',
                      data_augmentation: Sequence[str] = (),
                      moving_size: int = 512, ood_mix: float = 0.5,
                      oodsets: Sequence[str] = (),
                      padding_sets: Sequence[str] = (),
                      padding: float = 0.0, mix_padding: float = 0.0,
                      ood_mix_pad: float = 0.5,
                      seed: int = 0, task: Optional[int] = 0,
                      size: Optional[int] = None) -> MixtureDataset:
    """The WIM 'moving set' (ref ft/datasets.py:383-440)."""
    _, testset = get_dataset(ind, transformer=transformer,
                             splits=['test'], size=size)
    ood_sets = {n: get_dataset(n, transformer=transformer, splits=['test'],
                               size=size)[1] for n in oodsets}
    ood_set = MixtureDataset(mix=1, seed=seed, task=task,
                             length=int(ood_mix * moving_size), **ood_sets)
    ind_set = SubSampledDataset(testset, moving_size - len(ood_set),
                                seed=seed, task=task)

    pad_sets = {}
    for n in padding_sets:
        if n in oodsets:
            raise ValueError('{} is in ood sets and padding sets. Set '
                             'padding_mix arg instead'.format(n))
        pad_sets[n] = get_dataset(n, transformer=transformer,
                                  splits=['test'], size=size)[1]
    padding_mix = {n: padding / max(len(pad_sets), 1) for n in pad_sets}
    padding_set = MixtureDataset(seed=seed, task=task, mix=padding_mix,
                                 length=int(padding * moving_size),
                                 **pad_sets) if pad_sets else None

    moving_sets = {'ood': ood_set, 'ind': ind_set}
    if padding_set is not None:
        moving_sets['pad'] = padding_set

    if mix_padding:
        ind_bar = SubSampledDataset(testset, len(ind_set), seed=seed,
                                    task=task).bar()
        ood_bar = MixtureDataset(mix=1, seed=seed, task=task,
                                 length=len(ood_set), **ood_sets).bar()
        moving_sets['padmix'] = MixtureDataset(
            seed=seed, task=task,
            mix={'ood': mix_padding * ood_mix_pad,
                 'ind': mix_padding * (1 - ood_mix_pad)},
            length=int(mix_padding * moving_size),
            ood=ood_bar, ind=ind_bar)

    return MixtureDataset(mix={n: len(moving_sets[n]) for n in moving_sets},
                          seed=seed, task=task, **moving_sets)
