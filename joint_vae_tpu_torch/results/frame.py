"""A small table with named index levels and tuple column keys.

The JAX package's results layer is built on pandas DataFrames with a
MultiIndex on both axes.  The port does without pandas: :class:`Frame`
holds what the test and results CLIs need and nothing more, and follows
pandas wherever the output files depend on it:

- each column has a kind inferred from its values as pandas infers a
  column's dtype: 'int' (ints, none missing), 'float' (numbers, or ints
  with a missing cell), 'bool' (bools, none missing), 'str' (strings) or
  'object' (anything else); a missing cell is ``None``;
- ``sort_index`` orders rows level by level, missing last, stably;
- ``agg`` groups by index levels in sorted order, drops groups with a
  missing key, and computes the mean (Kahan-compensated), the sample std
  (``ddof=1``, Welford) and the count over the present cells, as pandas'
  grouped reductions do;
- ``iterrows`` hands out values as ``DataFrame.iterrows`` does: in a frame
  of only int and float columns, ints come out as floats;
- ``to_csv`` writes the layout pandas writes for MultiIndex rows and
  columns (one header line per column level, then the index names),
  floats in float columns through ``float_format``, other cells through
  ``str``, missing cells empty, quoted by Python's ``csv`` module.
"""

import csv
import math
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def is_missing(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


def _is_bool(v) -> bool:
    return isinstance(v, (bool, np.bool_))


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not _is_bool(v)


def _is_float(v) -> bool:
    return isinstance(v, (float, np.floating))


def infer_kind(values: Sequence) -> str:
    """The kind pandas would give a column of these values."""
    present = [v for v in values if not is_missing(v)]
    missing = len(present) < len(values)
    if not present:
        # pandas makes a column of missing cells float64 once one is NaN
        return 'float' if any(_is_float(v) for v in values) else 'object'
    if all(_is_bool(v) for v in present):
        return 'object' if missing else 'bool'
    if all(_is_int(v) for v in present):
        return 'float' if missing else 'int'
    if all(_is_int(v) or _is_float(v) for v in present):
        return 'float'
    if all(isinstance(v, str) for v in present):
        return 'str'
    return 'object'


def _normalise(values: Sequence, kind: str) -> List:
    out = []
    for v in values:
        if is_missing(v):
            out.append(None)
        elif kind == 'float':
            out.append(float(v))
        elif kind == 'int':
            out.append(int(v))
        elif kind == 'bool':
            out.append(bool(v))
        else:
            out.append(v)
    return out


class Frame:
    """Rows keyed by index tuples (one value per named level), columns by
    tuple keys, cells in row-major lists."""

    def __init__(self, index_names: Sequence[str], index: Sequence[tuple],
                 columns: Sequence[tuple], rows: Sequence[Sequence],
                 kinds: Optional[Sequence[str]] = None,
                 index_kinds: Optional[Sequence[str]] = None):
        self.index_names = list(index_names)
        self.columns = [tuple(c) for c in columns]
        cols = list(zip(*rows)) if rows else [[] for _ in self.columns]
        self.kinds = (list(kinds) if kinds is not None
                      else [infer_kind(c) for c in cols])
        cols = [_normalise(c, k) for c, k in zip(cols, self.kinds)]
        self.rows = [list(r) for r in zip(*cols)] if cols else [
            [] for _ in index]
        levels = list(zip(*index)) if index else [[] for _ in index_names]
        self.index_kinds = (list(index_kinds) if index_kinds is not None
                            else [infer_kind(v) for v in levels])
        levels = [_normalise(v, k) for v, k in zip(levels, self.index_kinds)]
        self.index = [tuple(r) for r in zip(*levels)] if levels else [
            () for _ in rows]

    # -- construction ---------------------------------------------------

    @classmethod
    def from_records(cls, records: Sequence[Dict[tuple, object]],
                     index: Sequence[tuple] = ()) -> 'Frame':
        """Rows from dicts keyed by column tuples, columns in the order of
        their first appearance (``pd.DataFrame(records)``), then the
        ``index`` columns moved into named index levels (their last
        element names the level; ``set_index``)."""
        columns: List[tuple] = []
        seen = set()
        for r in records:
            for k in r:
                if k not in seen:
                    seen.add(k)
                    columns.append(k)
        table = [[r.get(c) for c in columns] for r in records]
        idx_cols = [c for c in index if c in seen]
        pos = [columns.index(c) for c in idx_cols]
        keep = [i for i in range(len(columns)) if i not in pos]
        kinds = [infer_kind([row[i] for row in table])
                 for i in range(len(columns))]
        return cls([c[-1] for c in idx_cols],
                   [tuple(row[i] for i in pos) for row in table],
                   [columns[i] for i in keep],
                   [[row[i] for i in keep] for row in table],
                   kinds=[kinds[i] for i in keep],
                   index_kinds=[kinds[i] for i in pos])

    def _like(self, index, rows, columns=None, kinds=None, index_names=None,
              index_kinds=None) -> 'Frame':
        f = Frame.__new__(Frame)
        f.index_names = list(self.index_names if index_names is None
                             else index_names)
        f.index_kinds = list(self.index_kinds if index_kinds is None
                             else index_kinds)
        f.columns = list(self.columns if columns is None else columns)
        f.kinds = list(self.kinds if kinds is None else kinds)
        f.index = list(index)
        f.rows = [list(r) for r in rows]
        return f

    # -- shape ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.rows)

    @property
    def empty(self) -> bool:
        return not self.rows or not self.columns

    @property
    def nlevels(self) -> int:
        return len(self.index_names)

    def column(self, col: tuple) -> List:
        i = self.columns.index(tuple(col))
        return [r[i] for r in self.rows]

    def level_values(self, name: str) -> List:
        i = self.index_names.index(name)
        return [k[i] for k in self.index]

    # -- operations -----------------------------------------------------

    def sort_index(self) -> 'Frame':
        """Rows ordered level by level, missing values last, ties in
        their order (pandas' lexsort on the MultiIndex)."""
        order = sorted(range(len(self.rows)), key=lambda i: tuple(
            (True, 0) if is_missing(v) else (False, v)
            for v in self.index[i]))
        return self._like([self.index[i] for i in order],
                          [self.rows[i] for i in order])

    def droplevel(self, names: Sequence[str]) -> 'Frame':
        if isinstance(names, str):
            names = [names]
        keep = [i for i, n in enumerate(self.index_names) if n not in names]
        return self._like([tuple(k[i] for i in keep) for k in self.index],
                          self.rows,
                          index_names=[self.index_names[i] for i in keep],
                          index_kinds=[self.index_kinds[i] for i in keep])

    def nunique(self, name: str) -> int:
        return len({v for v in self.level_values(name) if not is_missing(v)})

    def select(self, columns: Sequence[tuple]) -> 'Frame':
        """The frame restricted to these columns, in this order."""
        pos = [self.columns.index(tuple(c)) for c in columns]
        return self._like(self.index, [[r[i] for i in pos] for r in self.rows],
                          columns=[self.columns[i] for i in pos],
                          kinds=[self.kinds[i] for i in pos])

    def drop_columns(self, columns: Sequence[tuple]) -> 'Frame':
        gone = {tuple(c) for c in columns}
        return self.select([c for c in self.columns if c not in gone])

    def agg(self, group_by: Sequence[str]) -> 'Frame':
        """mean / std / count of every column per group of the
        ``group_by`` levels; columns ('mean', *c), ('std', *c),
        ('count', *c)."""
        pos = [self.index_names.index(n) for n in group_by]
        groups: Dict[tuple, List[int]] = {}
        for i, k in enumerate(self.index):
            key = tuple(k[p] for p in pos)
            if any(is_missing(v) for v in key):
                continue
            groups.setdefault(key, []).append(i)
        keys = sorted(groups)
        stats = {'mean': [], 'std': [], 'count': []}
        for key in keys:
            m, s, n = [], [], []
            for j in range(len(self.columns)):
                vals = [float(self.rows[i][j]) for i in groups[key]
                        if not is_missing(self.rows[i][j])]
                m.append(_kahan_mean(vals))
                s.append(_welford_std(vals))
                n.append(len(vals))
            stats['mean'].append(m)
            stats['std'].append(s)
            stats['count'].append(n)
        columns = [(st,) + c for st in stats for c in self.columns]
        kinds = (['float'] * (2 * len(self.columns))
                 + ['int'] * len(self.columns))
        rows = [stats['mean'][g] + stats['std'][g] + stats['count'][g]
                for g in range(len(keys))]
        return self._like(keys, rows, columns=columns, kinds=kinds,
                          index_names=list(group_by),
                          index_kinds=[self.index_kinds[p] for p in pos])

    def iterrows(self) -> Iterator[Tuple[tuple, List]]:
        """(index tuple, values) per row, the values as
        ``DataFrame.iterrows`` gives them."""
        as_float = (set(self.kinds) <= {'int', 'float'}
                    and 'float' in self.kinds)
        for k, r in zip(self.index, self.rows):
            if as_float:
                r = [float('nan') if v is None else float(v) for v in r]
            yield k, list(r)

    # -- output ---------------------------------------------------------

    def _csv_cell(self, v, kind: str, float_format: Optional[str]) -> str:
        if is_missing(v):
            return ''
        if kind == 'float' and float_format:
            return float_format % v
        return str(v)

    def to_csv(self, path: str, sep: str = ' ',
               float_format: Optional[str] = None, index: bool = True):
        """Write the table as ``DataFrame.to_csv`` writes it."""
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        ncl = max((len(c) for c in self.columns), default=1)
        with open(path, 'w', newline='') as f:
            w = csv.writer(f, delimiter=sep, lineterminator='\n',
                           quoting=csv.QUOTE_MINIMAL, quotechar='"',
                           doublequote=True)
            names = list(self.index_names) if index else []
            if ncl > 1:
                for lev in range(ncl):
                    lead = ([''] + [''] * (len(names) - 1)) if names else []
                    w.writerow(lead + [c[lev] for c in self.columns])
                if names and set(names) != {''}:
                    w.writerow(names + [''] * len(self.columns))
            else:
                w.writerow(names + [c[0] for c in self.columns])
            for k, r in zip(self.index, self.rows):
                cells = ([self._csv_cell(v, kd, float_format)
                          for v, kd in zip(k, self.index_kinds)]
                         if index else [])
                cells += [self._csv_cell(v, kd, float_format)
                          for v, kd in zip(r, self.kinds)]
                w.writerow(cells)

    def to_string(self) -> str:
        """An aligned text rendering for the console: one header line per
        column level, the index names, then the rows (floats '{:.4g}')."""
        def fmt(v, kind):
            if is_missing(v):
                return 'NaN'
            if kind == 'float':
                return '{:.4g}'.format(v)
            return str(v)
        ncl = max((len(c) for c in self.columns), default=1)
        nl = self.nlevels
        body = [[fmt(v, k) for v, k in zip(key, self.index_kinds)]
                + [fmt(v, k) for v, k in zip(r, self.kinds)]
                for key, r in zip(self.index, self.rows)]
        head = [[''] * nl + [str(c[lev]) if lev < len(c) else ''
                             for c in self.columns] for lev in range(ncl)]
        head.append(list(self.index_names) + [''] * len(self.columns))
        table = head + body
        widths = [max(len(row[j]) for row in table)
                  for j in range(nl + len(self.columns))]
        lines = []
        for row in table:
            cells = [c.ljust(w) if j < nl else c.rjust(w)
                     for j, (c, w) in enumerate(zip(row, widths))]
            lines.append('  '.join(cells).rstrip())
        return '\n'.join(lines)

    def __str__(self) -> str:
        return self.to_string()


def _kahan_mean(vals: List[float]) -> float:
    if not vals:
        return float('nan')
    total, comp = 0.0, 0.0
    for v in vals:
        y = v - comp
        t = total + y
        comp = t - total - y
        if comp != comp:
            comp = 0.0
        total = t
    return total / len(vals)


def _welford_std(vals: List[float], ddof: int = 1) -> float:
    mean, m2, n = 0.0, 0.0, 0
    for v in vals:
        n += 1
        old = mean
        mean += (v - old) / n
        m2 += (v - mean) * (v - old)
    if n <= ddof:
        return float('nan')
    return math.sqrt(m2 / (n - ddof))
