"""LaTeX table export (re-design of ref ``utils/texify.py``).

The port's copy of ``joint_vae_tpu/results/texify.py`` on its own table
type (``frame.py``): the same .tex and .tab bytes as the JAX package's.

:class:`TexTab` renders rows/cells with column formats, per-cell faces
(bold/italic — the best-in-group marking), multicolumn cells, custom
inter-column separators, named rows, cmidrules and trailing comments
(ref TexTab/TexCell/TexRow, texify.py:346-790);
:func:`texify_test_results_df` turns a results dataframe into a .tex
tabular (ref texify.py:181-536: multirow group headers, per-column-group
formats, percent columns in 10^-2, optional best-in-column bolding).
"""

import os
from typing import Dict, List, Optional

import numpy as np

from .frame import Frame, is_missing

TEX_FACES = {'bf': r'\bfseries ', 'it': r'\itshape '}


def texify_str(s) -> str:
    s = str(s)
    for a, b in (('_', r'\_'), ('%', r'\%'), ('#', r'\#'), ('&', r'\&')):
        s = s.replace(a, b)
    return s


class TexTab:
    """LaTeX tabular builder.

    Rows are keyed by any hashable (ints, strings, dataframe index tuples)
    in insertion order; cells carry optional ``formatter``, ``face``
    ('bf'/'it'), and ``width``/``multicol_format`` for multicolumn spans.
    ``add_midrule(row, after=..., start=..., end=...)`` places full or
    partial (cmidrule) rules around named rows; ``add_col_sep`` swaps the
    separator glue between two columns; ``comment`` appends trailing
    ``%``-lines (the reference logs its job lists there).
    """

    def __init__(self, *col_format: str, float_format: str = '{:.3g}',
                 na_rep: str = '--'):
        self.col_format = list(col_format)
        self.float_format = float_format
        self.na_rep = na_rep
        self._order: List = []
        self._cells: Dict = {}
        self._rules: List = []        # (row_key, after?, start, end)
        self._col_seps: Dict[int, str] = {}
        self._comments: List[str] = []

    # -- construction -----------------------------------------------------

    def _row(self, key) -> List[str]:
        if key not in self._cells:
            self._cells[key] = []
            self._order.append(key)
        return self._cells[key]

    def append_cell(self, value, row=0, formatter: Optional[str] = None,
                    multicol: int = 1, width: Optional[int] = None,
                    multicol_format: Optional[str] = None,
                    face: Optional[str] = None):
        cells = self._row(row)
        if value is None or (isinstance(value, float) and np.isnan(value)):
            txt = self.na_rep
        elif isinstance(value, (float, np.floating)):
            txt = (formatter or self.float_format).format(value)
        else:
            txt = str(value)
            if not txt.startswith('\\'):
                txt = texify_str(txt)
        if face:
            txt = TEX_FACES[face] + txt
        w = width or multicol
        if w > 1 or multicol_format:
            txt = r'\multicolumn{%d}{%s}{%s}' % (w, multicol_format or 'c',
                                                 txt)
        cells.append(txt)

    def add_midrule(self, row, after: bool = False,
                    start: Optional[int] = None, end: Optional[int] = None):
        self._row(row)
        self._rules.append((row, after, start, end))

    def add_col_sep(self, index: int, sep: str = '/'):
        """Replace the glue between columns index-1 and index."""
        self._col_seps[index] = sep

    def comment(self, text: str):
        self._comments.append('% ' + str(text))

    # -- rendering --------------------------------------------------------

    def _format_line(self) -> str:
        parts = []
        for i, f in enumerate(self.col_format):
            if i in self._col_seps:
                parts.append('@{%s}' % self._col_seps[i])
            parts.append(f)
        return ''.join(parts)

    def _rule_tex(self, start, end) -> str:
        if start is None and end is None:
            return r'\midrule'
        a = (start if start is not None else 0) + 1
        b = (end if end is not None else len(self.col_format) - 1) + 1
        border = ('l' if a > 1 else '') + ('r' if b < len(self.col_format)
                                           else '')
        mid = '(%s)' % border if border else ''
        return r'\cmidrule%s{%d-%d}' % (mid, a, b)

    def render(self) -> str:
        lines = [r'\begin{tabular}{%s}' % self._format_line(), r'\toprule']
        for key in self._order:
            for row, after, s, e in self._rules:
                if row == key and not after:
                    lines.append(self._rule_tex(s, e))
            cells = self._cells[key]
            if cells:
                lines.append(' & '.join(cells) + r' \\')
            for row, after, s, e in self._rules:
                if row == key and after:
                    lines.append(self._rule_tex(s, e))
        lines += [r'\bottomrule', r'\end{tabular}']
        lines += self._comments
        return '\n'.join(lines)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        with open(path, 'w') as f:
            f.write(self.render() + '\n')


PERCENT_GROUPS = ('accuracy', 'auc', 'rate')


def _is_percent_group(group) -> bool:
    return (group in PERCENT_GROUPS
            or str(group).startswith(('fpr', 'tnr')))


def _metric_group(col):
    """The metric group of a column: its first MultiIndex level, except in
    agg_results tables where level 0 is the statistic ('mean'/'std'/
    'count') and the group sits at level 1."""
    if not isinstance(col, tuple):
        return ''
    if col[0] in ('mean', 'std', 'count') and len(col) > 1:
        return col[1]
    return col[0]


def _col_stat(col):
    if isinstance(col, tuple) and col[0] in ('mean', 'std', 'count'):
        return col[0]
    return None


# per-column-group formats (ref texify.py format-per-column); keys match
# the first MultiIndex level of results dataframes
GROUP_FORMATS = {'accuracy': '{:.1f}', 'auc': '{:.1f}', 'rate': '{:.1f}',
                 'train': '{:.4g}', 'arch': '{}'}


def texify_test_results_df(df: Frame, dataset: Optional[str] = None,
                           tex_file: Optional[str] = None,
                           tab_file: Optional[str] = None,
                           best_in_group: bool = False,
                           column_formats: Optional[Dict] = None) -> str:
    """Dataframe -> LaTeX tabular string (+ optional .tex/.tab files).

    ``best_in_group=True`` bolds the best value per metric column
    (max for accuracy/auc, min for fpr — ref results/__main__.py:305-386);
    ``column_formats`` overrides the per-group formatter ({group: fmt}).
    """
    if df.empty:
        return ''
    fmts = dict(GROUP_FORMATS)
    fmts.update(column_formats or {})
    tab = TexTab(*(['l'] * df.nlevels + ['r'] * len(df.columns)))
    multi = max(len(c) for c in df.columns) > 1

    # header rows: group line (multicolumn spans) + key line
    for name in df.index_names:
        tab.append_cell(name or '', 'group_header')
    if multi:
        groups: List = []
        for g, *_ in df.columns:
            if groups and groups[-1][0] == g:
                groups[-1][1] += 1
            else:
                groups.append([g, 1])
        for g, n in groups:
            tab.append_cell(g, 'group_header', width=n)
        for _ in range(df.nlevels):
            tab.append_cell('', 'header')
        for col in df.columns:
            tab.append_cell(col[-1], 'header')
    else:
        for col in df.columns:
            tab.append_cell(str(col[0]), 'group_header')
        tab.add_midrule('group_header', after=True)

    if multi:
        tab.add_midrule('header', after=True)

    # best-in-column values for the bolding pass
    best: Dict = {}
    if best_in_group:
        for col in df.columns:
            group = _metric_group(col)
            if _col_stat(col) not in (None, 'mean'):
                continue                    # never bold std/count cells
            vals = [float(v) for v in df.column(col)
                    if isinstance(v, (int, float, np.number))
                    and not is_missing(v)]
            if vals and _is_percent_group(group):
                best[col] = (min(vals) if str(group).startswith('fpr')
                             else max(vals))

    for idx, values in df.iterrows():
        # Rows whose keys are equal share a line, as in pandas, where a
        # missing cell of a float level is a fresh NaN equal to nothing
        # and one of any other level is the shared ``np.nan``.
        ref = tuple(object() if v is None and kind == 'float' else v
                    for v, kind in zip(idx, df.index_kinds))
        key = ('row', ref if len(ref) > 1 else ref[0])
        for v in idx:
            tab.append_cell(v, key)
        for col, v in zip(df.columns, values):
            group = _metric_group(col)
            if isinstance(v, (float, np.floating)) and not np.isnan(v):
                face = None
                if col in best and abs(float(v) - best[col]) < 5e-4:
                    face = 'bf'
                if _is_percent_group(group) and _col_stat(col) != 'count':
                    tab.append_cell(100 * float(v), key,
                                    formatter=fmts.get(group, '{:.1f}'),
                                    face=face)
                else:
                    tab.append_cell(float(v), key, face=face,
                                    formatter=(fmts.get(group)
                                               if group in fmts
                                               and '{' in fmts[group]
                                               else None))
            else:
                tab.append_cell(None if (isinstance(v, float)
                                         and np.isnan(v)) else v, key)

    out = tab.render()
    if tex_file:
        tab.save(tex_file)
    if tab_file:
        os.makedirs(os.path.dirname(tab_file) or '.', exist_ok=True)
        df.to_csv(tab_file, sep=' ', float_format='%.4g')
    return out
