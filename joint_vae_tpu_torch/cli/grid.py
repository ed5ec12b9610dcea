"""Sweep-grid expansion (ref grid.ini): turn a grid INI section into the
cartesian product of training commands.

    python -m joint_vae_tpu_torch.cli.grid grids.ini [section] [--run] \
        [--device cpu]

Port of ``joint_vae_tpu/cli/grid.py``: the commands run the port's train
CLI (``python -m joint_vae_tpu_torch.cli.train``), on the CUDA card
unless ``--device`` (forwarded to each) names another device.

Grid section format: every key is a train-CLI option; space-separated
values are swept, '|'-separated groups are zipped options.

    [sweep-K]
    config = cifar10
    latent-dim = 64 128 256
    beta = 1e-4 1e-3
"""

import argparse
import configparser
import itertools
import subprocess
import sys
from typing import Dict, List

TRAIN_MODULE = 'joint_vae_tpu_torch.cli.train'


def expand_grid(section: Dict[str, str]) -> List[List[str]]:
    """-> list of train-CLI argv lists.

    Reference grid.ini compatibility: keys may use underscores
    (latent_sampling) and a ``repeat = N`` key replicates every combo N
    times (the reference's SLURM-array repetition)."""
    section = dict(section)
    repeat = int(section.pop('repeat', 1) or 1)
    if repeat < 1:
        raise ValueError(
            'grid section repeat={} would expand to zero jobs'.format(repeat))
    fixed, swept, zipped = {}, {}, {}
    for k, v in section.items():
        k = k.replace('_', '-')
        if '|' in v:
            # zipped options: '|' groups advance together across all
            # '|' keys (beta = 1e-4|1e-3 with lr = 1e-3|1e-4 yields two
            # combos, not four); groups may hold multi-word values
            zipped[k] = [g.strip() for g in v.split('|')]
            continue
        vals = v.split()
        if len(vals) > 1:
            swept[k] = vals
        else:
            fixed[k] = v
    if len({len(v) for v in zipped.values()}) > 1:
        raise ValueError('zipped (|) options must have equal group counts: '
                         '{}'.format({k: len(v) for k, v in zipped.items()}))
    combos = [dict(zip(swept, c))
              for c in itertools.product(*swept.values())] or [{}]
    if zipped:
        zgroups = [dict(zip(zipped, grp)) for grp in zip(*zipped.values())]
        combos = [dict(c, **z) for c in combos for z in zgroups]
    argvs = []
    for combo in combos:
        argv = []
        for k, v in {**fixed, **combo}.items():
            if str(v).lower() == 'true':       # store_true flags
                argv.append('--{}'.format(k))
            elif str(v).lower() == 'false':
                continue
            else:
                argv += ['--{}'.format(k)] + str(v).split()
        argvs.extend([list(argv)] * repeat)
    return argvs


def main(argv=None):
    p = argparse.ArgumentParser(prog='jvt-grid')
    p.add_argument('grid_file')
    p.add_argument('section', nargs='?', default=None)
    p.add_argument('--run', action='store_true',
                   help='launch the trainings sequentially')
    p.add_argument('--extra', nargs='*', default=[],
                   help='extra args appended to every command')
    p.add_argument('--device', default=None,
                   help='forwarded to every spawned train command (the '
                        "CUDA card by default; 'cpu' on request)")
    args = p.parse_args(argv)

    cp = configparser.ConfigParser()
    cp.read(args.grid_file)
    sections = [args.section] if args.section else cp.sections()

    device_args = ['--device', args.device] if args.device else []
    commands = []
    for s in sections:
        for cmd_args in expand_grid(dict(cp[s])):
            commands.append([sys.executable, '-m', TRAIN_MODULE,
                             *cmd_args, *args.extra, *device_args])
    for c in commands:
        print(' '.join(c))
    if args.run:
        for c in commands:
            r = subprocess.run(c)
            if r.returncode:
                print('command failed: {}'.format(' '.join(c)),
                      file=sys.stderr)
                return r.returncode
    return 0


if __name__ == '__main__':
    sys.exit(main())
