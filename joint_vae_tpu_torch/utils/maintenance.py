"""Job-store maintenance (ref utils/refactor.py, delete-jobs.sh,
utils/rsync-jobs.sh, utils/prune_out_directory.py):

- mark/delete jobs (sentinel-based soft delete + optional purge)
- prune stale .out/.tmp files
- rsync command builders with the reference's pth-filter profiles
  (pull results without weights, push everything, ...)

The port's own copy of ``joint_vae_tpu/utils/maintenance.py``.
"""

import os
import shutil
import subprocess
from typing import List

from ..save_load.fetch import collect_models
from ..save_load.jobs import mark


def delete_job(job_dir: str, purge: bool = False):
    """Soft delete (sentinel) or remove the directory
    (ref delete-jobs.sh / refactor.delete_job)."""
    if purge:
        shutil.rmtree(job_dir, ignore_errors=True)
    else:
        mark(job_dir, 'deleted')


def list_deleted(jobs_root: str) -> List[str]:
    """Jobs soft-deleted via the 'deleted' sentinel only — derailed
    (crashed) jobs keep their checkpoints for forensics and are never
    purged here (ref delete-jobs.sh marks, test.py:132-143 derails)."""
    return [d for d in collect_models(jobs_root)
            if os.path.exists(os.path.join(d, 'deleted'))]


def purge_deleted(jobs_root: str) -> List[str]:
    gone = []
    for d in list_deleted(jobs_root):
        shutil.rmtree(d, ignore_errors=True)
        gone.append(d)
    return gone


def prune_out_files(jobs_root: str, suffixes=('.tmp', '.out.old')) -> List[str]:
    removed = []
    for root, _, files in os.walk(jobs_root):
        for f in files:
            if f.endswith(tuple(suffixes)):
                os.unlink(os.path.join(root, f))
                removed.append(os.path.join(root, f))
    return removed


RSYNC_PROFILES = {
    # ref rsync-jobs.sh filter profiles
    'results': ['--include=*/', '--include=*.json', '--include=*.out',
                '--exclude=*'],
    # the ft sidecar arrays (wim_prior/poscod_head) ride with records:
    # rates recomputation needs them (ft/job.py, ft/poscod.py)
    'records': ['--include=*/', '--include=*.json', '--include=record-*.npz',
                '--include=record-*.jvr', '--include=sample-*.npz',
                '--include=wim_prior.npz', '--include=poscod_head.npz',
                '--exclude=*.npz', '--exclude=*.jvr', '--exclude=*'],
    'full': [],
}


def rsync_command(remote: str, jobs_root: str = 'jobs', push: bool = False,
                  profile: str = 'results') -> List[str]:
    """Build the rsync argv for pulling/pushing job trees."""
    filt = RSYNC_PROFILES.get(profile, [])
    src, dst = ('{}/'.format(jobs_root), '{}:{}/'.format(remote, jobs_root))
    if not push:
        src, dst = dst, src
    return ['rsync', '-av', '--prune-empty-dirs', *filt, src, dst]


def sync_jobs(remote: str, jobs_root: str = 'jobs', push: bool = False,
              profile: str = 'results', dry_run: bool = True):
    cmd = rsync_command(remote, jobs_root, push, profile)
    if dry_run:
        cmd.insert(1, '--dry-run')
    return subprocess.run(cmd, capture_output=True, text=True)
