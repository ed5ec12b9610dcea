"""Live epoch output: grouped-column progress rows to stdout and per-job
.out files (ref EpochOutput, utils/print_log.py:50-344).  The port's copy
of ``EpochOutput`` from ``joint_vae_tpu/utils/print_log.py``."""

import os
import sys
from typing import Dict, Optional


BOLD, DIM_OFF = '\033[1m', '\033[0m'

CELL_W = 9


def _fmt(v) -> str:
    """Compact scalar formatter (log lines, summaries)."""
    try:
        v = float(v)
    except (TypeError, ValueError):
        return str(v)[:8].rjust(8)
    if v != v:  # nan
        return '     -- '
    if v == 0:
        return '     0  '
    if abs(v) >= 1e4 or abs(v) < 1e-3:
        return '{:8.1e}'.format(v)
    return '{:8.4g}'.format(v)


def _cell(group: str, key, v) -> str:
    """Per-group cell formats (ref cell_formats, print_log.py:68-76)."""
    try:
        v = float(v)
    except (TypeError, ValueError):
        return '{:>{w}}'.format(str(v)[:CELL_W], w=CELL_W)
    if v != v:  # nan
        return '{:>{w}}'.format('--', w=CELL_W)
    if key == 'dB':
        return '{:{w}.1f} dB'.format(v, w=CELL_W - 3)
    if group in ('accuracy', 'fpr'):
        return '{:{w}.2%}'.format(v, w=CELL_W)
    return '{:{w}.2e}'.format(v, w=CELL_W)


class EpochOutput:
    """Grouped live table (ref EpochOutput, utils/print_log.py:50-344).

    Column groups (losses || metrics || accuracy || fpr || time) separated
    by ' || ', cells by ' | ', fixed cell width; when the column signature
    changes, a header block is printed first: one row of column keys and one
    of group titles centered in underscores.  Data rows refresh in place
    ('\\r') within an epoch; the end-of-epoch row is bolded on ANSI streams
    and appended to the attached .out files.
    """

    def __init__(self, stdout: bool = True, ansi: bool = True):
        self.streams: list = [sys.stdout] if stdout else []
        self.files: list = []
        self.ansi = ansi
        self._signature = None

    def add_file(self, path: str):
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        f = open(path, 'a')
        self.files.append(f)
        return f

    def close(self):
        for f in self.files:
            f.close()
        self.files = []

    # -- row building ------------------------------------------------------

    @staticmethod
    def _groups(losses, metrics, accuracy, fpr):
        return [(g, d) for g, d in (('losses', losses), ('metrics', metrics),
                                    ('accuracy', accuracy), ('fpr', fpr))
                if d]

    def _lead(self, preambule, epoch, epochs, i, per_epoch):
        return '{:>9} {:>4}/{:<4} {:>5}/{:<5}'.format(
            preambule[:9], epoch, epochs, i + 1, per_epoch)

    def _header_lines(self, lead_w, groups, with_time) -> list:
        keys_row, title_row = [' ' * lead_w], [' ' * lead_w]
        for g, d in groups:
            keys = ' | '.join('{:^{w}}'.format(str(k)[:CELL_W], w=CELL_W)
                              for k in d)
            keys_row.append(keys)
            title_row.append('{:_^{w}}'.format(g, w=len(keys)))
        if with_time:
            keys_row.append('{:^12}'.format('im/s'))
            title_row.append('{:_^12}'.format('time'))
        return [' || '.join(title_row), ' || '.join(keys_row)]

    def results(self, i: int, per_epoch: int, epoch: int, epochs: int,
                preambule: str = '',
                losses: Optional[Dict[str, float]] = None,
                metrics: Optional[Dict[str, float]] = None,
                accuracy: Optional[Dict[str, float]] = None,
                fpr: Optional[Dict[str, float]] = None,
                time_per_i: float = 0.0,
                batch_size: int = 0,
                end_of_epoch: str = '\n'):
        groups = self._groups(losses, metrics, accuracy, fpr)
        lead = self._lead(preambule, epoch, epochs, i, per_epoch)

        # header block when the column set changes (ref last_row check);
        # the time column's presence is part of the set — a row growing an
        # 'im/s' cell must reprint the header
        signature = (preambule, time_per_i > 0,
                     tuple((g, tuple(d)) for g, d in groups))
        header = None
        if signature != self._signature:
            self._signature = signature
            header = self._header_lines(len(lead), groups, time_per_i > 0)


        cells = [lead]
        for g, d in groups:
            cells.append(' | '.join(_cell(g, k, v) for k, v in d.items()))
        if time_per_i:
            ips = batch_size / time_per_i if time_per_i else float('nan')
            cells.append('{:9.1f} im/s'.format(ips))
        line = ' || '.join(cells)

        last = i + 1 >= per_epoch
        for s in self.streams:
            try:
                if header:
                    s.write('\n'.join(header) + '\n')
                if last and self.ansi and s.isatty():
                    s.write(BOLD + line + DIM_OFF + end_of_epoch)
                else:
                    s.write(line + (end_of_epoch if last else '\r'))
                s.flush()
            except ValueError:
                pass
        if last:
            for f in self.files:
                # files only receive end-of-epoch rows; give each its own
                # header whenever the signature it last saw differs
                if getattr(f, '_jvt_sig', None) != signature:
                    file_header = (header if header is not None else
                                   self._header_lines(len(lead), groups,
                                                      time_per_i > 0))
                    f.write('\n'.join(file_header) + '\n')
                    try:
                        f._jvt_sig = signature
                    except AttributeError:
                        pass
                f.write(line + '\n')
                f.flush()

