#!/usr/bin/env python
"""Soft-delete (or purge) job directories (ref delete-jobs.sh), without
JAX: ``scripts/delete-jobs.py`` on the port's job store.

    scripts/torch_delete_jobs.py <job-number> [<job-number> ...]
        [--job-dir jobs] [--purge]

Prints ``deleted <dir>`` (``purged <dir>``) per job found and ``job <n>
not found`` on stderr per job missing (exit 1 then), as the JAX script
does.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from joint_vae_tpu_torch.save_load.checkpoint import load_json  # noqa: E402
from joint_vae_tpu_torch.save_load.fetch import collect_models  # noqa: E402
from joint_vae_tpu_torch.utils.maintenance import delete_job  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('jobs', nargs='+', type=int)
    p.add_argument('--job-dir', default='jobs')
    p.add_argument('--purge', action='store_true')
    args = p.parse_args(argv)
    wanted = set(args.jobs)
    for d in collect_models(args.job_dir):
        try:
            n = load_json(os.path.join(d, 'params.json')).get('job_number')
        except Exception:
            continue
        if n in wanted:
            delete_job(d, purge=args.purge)
            print('{} {}'.format('purged' if args.purge else 'deleted', d))
            wanted.discard(n)
    for n in wanted:
        print('job {} not found'.format(n), file=sys.stderr)
    return 1 if wanted else 0


if __name__ == '__main__':
    sys.exit(main())
