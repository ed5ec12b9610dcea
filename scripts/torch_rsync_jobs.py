#!/usr/bin/env python
"""Pull/push job trees between machines (ref utils/rsync-jobs.sh), without
JAX: ``scripts/rsync-jobs.py`` on the port's maintenance helpers.

    scripts/torch_rsync_jobs.py <remote-host> [--push]
        [--profile results|records|full] [--job-dir jobs] [--go]

Prints the rsync command line, then runs it (``--dry-run`` unless
``--go``) and passes its output and exit code on, as the JAX script
does.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from joint_vae_tpu_torch.utils.maintenance import (  # noqa: E402
    rsync_command, sync_jobs)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('remote')
    p.add_argument('--push', action='store_true')
    p.add_argument('--profile', default='results',
                   choices=['results', 'records', 'full'])
    p.add_argument('--job-dir', default='jobs')
    p.add_argument('--go', action='store_true', help='actually run (else dry)')
    args = p.parse_args(argv)
    print(' '.join(rsync_command(args.remote, args.job_dir, args.push,
                                 args.profile)))
    r = sync_jobs(args.remote, args.job_dir, args.push, args.profile,
                  dry_run=not args.go)
    sys.stdout.write(r.stdout)
    sys.stderr.write(r.stderr)
    return r.returncode


if __name__ == '__main__':
    sys.exit(main())
