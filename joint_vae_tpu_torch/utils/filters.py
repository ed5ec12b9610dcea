"""Model-query filters (ref utils/filters.py:12-144 + utils/filters.ini).

The port's own copy of ``joint_vae_tpu/utils/filters.py``: the same
grammar, classes and key schema, so that a filter string selects the same
jobs in both packages.

Grammar (from CLI/INI strings, parsed per typed key):
- empty string            -> any value (of the key's type)
- 'not ...' prefix        -> negation
- 'a...b' / '100..'       -> interval (open ends allowed)
- comma/space lists       -> value sets
- single token            -> singleton set (bools parse 'true')

``DictOfListsOfParamFilters`` ANDs lists of filters per key over the flat
model dicts from dictify; ``MetaFilter`` builds and/or trees.
"""

import re
from typing import Any, Dict, Optional

import numpy as np

_INTERVAL_RE = re.compile(r'\.{2,}')
_LIST_RE = re.compile(r'[\s\,]+\s*')


def _coerce(token: str, type, default):
    """Best-effort typed parse of an interval end; open ends keep ±inf."""
    try:
        return type(token)
    except (ValueError, TypeError):
        return default


class ParamFilter:
    """One predicate over a single model-dict value.

    Holds a base test callable plus a negation flag; built through the named
    constructors below.  :meth:`from_string` implements the query grammar
    (behavior of ref utils/filters.py:12-144, re-implemented here as
    predicate composition).  Negation is tri-state aware: a negated filter
    over a *list-valued* field passes only if every element fails the base
    test, and the 'always true' filter (a missing INI value) is never
    negated.
    """

    def __init__(self, test, description: str, type=str, neg: bool = False,
                 unconditional: bool = False):
        self._test = test
        self._description = description
        self.type = type
        self.neg = neg
        self.unconditional = unconditional

    # --- named constructors ------------------------------------------------
    @classmethod
    def tautology(cls, type=str) -> 'ParamFilter':
        return cls(lambda v: True, 'always true', type, unconditional=True)

    @classmethod
    def of_type(cls, type=str, neg=False) -> 'ParamFilter':
        return cls(lambda v: isinstance(v, type), 'any', type, neg=neg)

    @classmethod
    def within(cls, lo, hi, type=float, neg=False) -> 'ParamFilter':
        def test(v):
            try:
                return lo <= v <= hi
            except TypeError:
                return False
        return cls(test, 'in [{}...{}]'.format(lo, hi), type, neg=neg)

    @classmethod
    def among(cls, values, type=str, neg=False) -> 'ParamFilter':
        values = list(values)
        return cls(lambda v: v in values,
                   'in ' + ', '.join(str(v) for v in values), type, neg=neg)

    # --- the string grammar ------------------------------------------------
    @classmethod
    def from_string(cls, arg_str: Optional[str] = '', type=str) -> 'ParamFilter':
        if arg_str is None:
            return cls.tautology(type)
        s = arg_str.strip()
        neg = s.lower().startswith('not') and (len(s) == 3 or s[3].isspace())
        if neg:
            s = s[3:].strip()

        if _INTERVAL_RE.search(s):
            raw = _INTERVAL_RE.split(s)
            lo = _coerce(raw[0], type, -np.inf)
            hi = _coerce(raw[-1], type, np.inf)
            return cls.within(lo, hi, type, neg=neg)
        if not s:
            return cls.of_type(type, neg=neg)
        tokens = _LIST_RE.split(s)
        if type is bool:
            values = [t.lower() == 'true' for t in tokens]
        else:
            values = [type(t) for t in tokens]
        return cls.among(values, type, neg=neg)

    # --- evaluation ----------------------------------------------------------
    def filter(self, value) -> bool:
        if self.unconditional:
            return True
        if isinstance(value, list):
            hits = [self.filter(v) for v in value]
            return all(hits) if self.neg else any(hits)
        return self._test(value) ^ self.neg

    def __call__(self, value) -> bool:
        return self.filter(value)

    def __str__(self):
        return ('not ' if self.neg else '') + self._description


class ListOfParamFilters(list):
    """ANDed filters for one key (ref utils/filters.py:147-176)."""

    def filter(self, value) -> bool:
        return all(f.filter(value) for f in self)

    __call__ = filter


class DictOfListsOfParamFilters(dict):
    """key -> ListOfParamFilters; a model dict passes iff every key passes
    (ref utils/filters.py:179-220)."""

    def add(self, key: str, filter: ParamFilter):
        self.setdefault(key, ListOfParamFilters()).append(filter)

    def filter(self, d: Dict[str, Any]) -> bool:
        return all(filters.filter(d.get(key))
                   for key, filters in self.items())

    __call__ = filter


class MetaFilter:
    """and/or tree over DictOfListsOfParamFilters
    (ref utils/filters.py:223-260)."""

    def __init__(self, operator: str = 'and', *filters):
        assert operator in ('and', 'or')
        self.operator = operator
        self.filters = list(filters)

    def filter(self, d: Dict[str, Any]) -> bool:
        op = all if self.operator == 'and' else any
        return op(f.filter(d) for f in self.filters)

    __call__ = filter


# filter-key schema: key -> (type, aliases) — the spirit of utils/filters.ini
FILTER_KEYS: Dict[str, dict] = {
    'job': {'type': int, 'aliases': ['job_number']},
    'set': {'type': str, 'aliases': ['dataset']},
    'type': {'type': str},
    'arch': {'type': str},
    'arch_code': {'type': str},
    'features': {'type': str},
    'upsampler': {'type': str},
    # distinct fields in the flat dict: 'classifier' is the layer-size
    # string, 'classif_type' the head type (linear/softmax) — the
    # reference's filters.ini also keys them separately
    'classifier': {'type': str},
    'classif_type': {'type': str},
    'depth': {'type': int},
    'width': {'type': int},
    'sigma': {'type': float},
    'sigma_train': {'type': str},
    'beta': {'type': float},
    'gamma': {'type': float},
    'latent_dim': {'type': int, 'aliases': ['K']},
    'latent_sampling': {'type': int, 'aliases': ['L']},
    'test_latent_sampling': {'type': int, 'aliases': ['l']},
    'prior': {'type': str, 'aliases': ['prior_distribution']},
    'prior_means': {'type': float, 'aliases': ['latent_prior_init_means']},
    'prior_variance': {'type': str, 'aliases': ['latent_prior_variance']},
    'tilted_tau': {'type': float},
    'learned_prior_means': {'type': bool},
    'forced_var': {'type': float, 'aliases': ['encoder_forced_variance']},
    'output_distribution': {'type': str},
    'activation': {'type': str},
    'output_activation': {'type': str},
    'batch_norm': {'type': str},
    'data_augmentation': {'type': str},
    'rep': {'type': str, 'aliases': ['representation']},
    'optim': {'type': str, 'aliases': ['optimizer']},
    'lr': {'type': float},
    'epochs': {'type': int},
    'done': {'type': int},
    'warmup': {'type': int},
    'warmup_gamma': {'type': int},
    'validation': {'type': int},
    'has_validation': {'type': bool},
    'batch_size': {'type': int, 'aliases': ['train_batch_size']},
    'best_accuracy': {'type': float},
    'version': {'type': str},
    'heldout': {'type': str, 'aliases': ['h/o']},
    'wim': {'type': bool},
    'wim_prior': {'type': str},
    'wim_mean': {'type': float},
    'wim_alpha': {'type': float},
    'wim_sets': {'type': str},
    'wim_train_size': {'type': int},
    'wim_moving_size': {'type': int},
    'wim_mix': {'type': float},
    'wim_padding': {'type': float},
    # remaining filters.ini keys (ref utils/filters.ini:40-52)
    'wim_array_size': {'type': int},
    'wim_from': {'type': int},
    'wim_padding_dataset': {'type': str},
    'wim_mix_padding': {'type': float},
    'latent_prior_means': {'type': str},
    'finished': {'type': bool},
}


def get_filter_keys() -> Dict[str, dict]:
    return dict(FILTER_KEYS)


def filters_from_dict(d: Dict[str, str]) -> DictOfListsOfParamFilters:
    """Build filters from {key: filter-string} using the key schema."""
    alias_to_key = {}
    for k, spec in FILTER_KEYS.items():
        alias_to_key[k] = k
        for a in spec.get('aliases', ()):
            alias_to_key[a] = k
    out = DictOfListsOfParamFilters()
    for k, s in d.items():
        key = alias_to_key.get(k, k)
        t = FILTER_KEYS.get(key, {}).get('type', str)
        out.add(key, ParamFilter.from_string(s, type=t))
    return out
