"""Export job directories into reference-loadable jobs.

    python -m joint_vae_tpu_torch.cli.export_ref SRC [SRC...] --out ref-jobs
    python -m joint_vae_tpu_torch.cli.export_ref --scan JOBS_ROOT -O ref-jobs

The inverse of ``cli/import_ref.py``: each SRC is a job directory of
either package (``save_load/jobs.py``); the output is a directory that
moxime/joint-vae's own ``CVNet.load``, test.py and results pipelines
consume (ref cvae.py:2677-2857), the same files as the JAX package's
export CLI writes.  The reference package must be importable: pass
``--reference`` or set ``JVT_REFERENCE`` (it defines the torch checkpoint
formats written).  Exported jobs land under the same relative layout when
exporting a jobs root, else under <out>/<basename>.  The weights are
loaded on the CUDA card unless ``--device cpu``; the files written are
the same.  Any job that fails is logged and counted, and the exit code is
1.
"""

import argparse
import logging
import os
import sys

from ..save_load.export_reference import (default_reference_path,
                                          export_to_reference_job)
from . import add_device_arg, convert_job_batch, find_job_dirs


def main(argv=None):
    p = argparse.ArgumentParser(prog='jvt-export')
    p.add_argument('sources', nargs='*',
                   help='job directories to export')
    p.add_argument('--scan', default=None, metavar='ROOT',
                   help='walk a jobs tree and export every job')
    p.add_argument('--out', '-O', default='ref-jobs',
                   help='destination reference jobs root')
    p.add_argument('--reference', default=None, metavar='PATH',
                   help='reference package path (default: $JVT_REFERENCE)')
    p.add_argument('--no-recorders', dest='recorders', action='store_false',
                   help='skip converting recorders to record-*.pth')
    p.add_argument('--no-optimizer', dest='optimizer', action='store_false',
                   help='skip exporting optimizer moments')
    p.add_argument('--dry-run', action='store_true',
                   help='list what would be exported')
    p.add_argument('-v', '--verbose', action='count', default=0)
    p.add_argument('--debug', action='store_true')
    add_device_arg(p)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else
                        logging.INFO if args.verbose else logging.WARNING)

    if not args.dry_run and not (args.reference or default_reference_path()):
        p.error('no reference package (pass --reference or set '
                'JVT_REFERENCE)')

    sources = list(args.sources)
    rel_root = None
    if args.scan:
        rel_root = os.path.abspath(args.scan)
        sources += sorted(find_job_dirs(args.scan))
    if not sources:
        p.error('no sources (pass job dirs or --scan a jobs root)')

    def convert(src, dst):
        export_to_reference_job(src, dst, reference_path=args.reference,
                                export_recorders=args.recorders,
                                export_optimizer=args.optimizer,
                                device=args.device)
        print('exported {} -> {}'.format(src, dst))

    done, failed = convert_job_batch(sources, rel_root, args.out,
                                     convert, args.dry_run)
    if not args.dry_run:
        print('{} exported, {} failed'.format(done, failed))
    # a batch conversion that lost a job must not exit 0
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
