"""Import reference-trained job directories into jobs of this package.

    python -m joint_vae_tpu_torch.cli.import_ref SRC [SRC...] --job-dir jobs
    python -m joint_vae_tpu_torch.cli.import_ref --scan REF_JOBS_ROOT -J jobs

Each SRC is a reference job directory (it holds params.json and
state.pth, ref cvae.py:2650-2857); ``--scan`` walks a reference jobs tree
and imports every job found.  Imported jobs land under the same
<dataset>/<arch>/<options>/<job#> relative layout when importing from a
jobs root, else under <job-dir>/<basename>, in the JAX package's job
schema (``save_load/import_reference.py``): the test, serve, sample and ft
CLIs of either package take them.  The template model of each job is
built on the CUDA card unless ``--device cpu``; the files written are the
same.  Any job that fails is logged and counted, and the exit code is 1.
"""

import argparse
import logging
import os
import sys

from ..save_load.import_reference import import_reference_job
from . import add_device_arg, convert_job_batch, find_job_dirs


def main(argv=None):
    p = argparse.ArgumentParser(prog='jvt-import')
    p.add_argument('sources', nargs='*',
                   help='reference job directories to import')
    p.add_argument('--scan', default=None, metavar='ROOT',
                   help='walk a reference jobs tree and import every job')
    p.add_argument('--job-dir', '-J', default='jobs',
                   help='destination jobs root')
    p.add_argument('--job-number', type=int, default=None,
                   help='override the imported job number '
                        '(single-source only)')
    p.add_argument('--no-recorders', dest='recorders', action='store_false',
                   help='skip converting record-*.pth recorder dumps')
    p.add_argument('--dry-run', action='store_true',
                   help='list what would be imported')
    p.add_argument('-v', '--verbose', action='count', default=0)
    p.add_argument('--debug', action='store_true')
    add_device_arg(p)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else
                        logging.INFO if args.verbose else logging.WARNING)

    sources = list(args.sources)
    rel_root = None
    if args.scan:
        rel_root = os.path.abspath(args.scan)
        sources += sorted(find_job_dirs(args.scan))
    if not sources:
        p.error('no sources (pass job dirs or --scan a jobs root)')
    if args.job_number is not None and len(sources) > 1:
        p.error('--job-number only applies to a single source')

    def convert(src, dst):
        import_reference_job(src, dst, job_number=args.job_number,
                             import_recorders=args.recorders,
                             device=args.device)
        print('imported {} -> {}'.format(src, dst))

    done, failed = convert_job_batch(sources, rel_root, args.job_dir,
                                     convert, args.dry_run)
    if not args.dry_run:
        print('{} imported, {} failed'.format(done, failed))
    # a batch conversion that lost a job must not exit 0
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
