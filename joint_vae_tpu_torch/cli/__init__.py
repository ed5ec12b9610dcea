"""Command-line entry points of the port: train, serve, test, results,
ft, import_ref (reference-trained job directories), and the analysis
drivers sample (reconstruction and generation grids, latent exports),
aggregate (ensembles), cascade (chained reconstructions) and grid (sweeps
of the train CLI)."""


def add_device_arg(parser):
    """``--device``: the torch device a CLI runs on; the CUDA card unless
    'cpu' (or another device) is asked for (``device.resolve_device``)."""
    parser.add_argument('--device', default=None,
                        help="torch device: default the CUDA card; 'cpu' "
                             'on request')
    return parser


def add_mesh_args(parser):
    """The JAX package's mesh flags, parsed to be refused
    (``utils/parameters.py::refuse_unported``, ROADMAP Queue 1 item 14)."""
    parser.add_argument('--mesh', nargs='?', const='all', default=None,
                        metavar='N', help='(not ported yet)')
    parser.add_argument('--model-axis', type=int, default=1,
                        help='(not ported yet)')
    parser.add_argument('--sample-axis', type=int, default=1,
                        help='(not ported yet)')
    parser.add_argument('--distributed', action='store_true',
                        help='(not ported yet)')
    return parser


def find_job_dirs(root):
    """Every directory under root holding a params.json (a job dir), for
    the import CLI's ``--scan``."""
    import os
    for dirpath, dirnames, filenames in os.walk(root):
        if 'params.json' in filenames:
            dirnames[:] = []                # job dirs don't nest
            yield dirpath


def convert_job_batch(sources, rel_root, out_root, convert, dry_run):
    """The ``--scan`` batch loop: each source lands under its path
    relative to ``rel_root`` (else under its basename, suffixed ``-1``,
    ``-2``... when two sources share one), and a job that fails is
    logged and counted without stopping the rest.

    ``convert(src, dst)`` does the work; returns (done, failed)."""
    import logging
    import os
    done, failed = 0, 0
    taken = set()
    for src in sources:
        src = os.path.abspath(src)
        if rel_root and src.startswith(rel_root + os.sep):
            rel = os.path.relpath(src, rel_root)
        else:
            rel = os.path.basename(src.rstrip(os.sep))
        base, n = rel, 1
        while rel in taken:
            rel = '{}-{}'.format(base, n)
            n += 1
        taken.add(rel)
        dst = os.path.join(out_root, rel)
        if dry_run:
            print('{} -> {}'.format(src, dst))
            continue
        try:
            convert(src, dst)
            done += 1
        except Exception as e:
            logging.error('%s not converted: %s: %s',
                          src, type(e).__name__, e)
            failed += 1
    return done, failed
