"""Model registry: walk job directories, cache summary dicts, query.

Re-design of ref ``utils/save_load/fetch.py:129-300``: the registry walks a
jobs root for ``params.json`` files, builds flat dicts
(:func:`make_dict_from_model`), caches them in ``models-<hostname>.json``
behind a lock file, and serves filtered queries + job-number lookups.

The port's own copy of ``joint_vae_tpu/save_load/fetch.py``.  The
registry file has the same name, keys and schema version in both
packages, so that either one reads the other's as fresh.  Its entries
come from ghost loads, which touch no device."""

import json
import logging
import os
import socket
import time
from typing import Callable, Dict, List, Optional

from .checkpoint import save_json, load_json
from .dictify import DICT_SCHEMA_VERSION, make_dict_from_model
from .jobs import Job, load_job, is_derailed


def _registry_path(job_dir: str) -> str:
    return os.path.join(job_dir, 'models-{}.json'.format(socket.gethostname()))


class _Lock:
    """Minimal cross-process lock via O_EXCL lock file
    (ref FileLock use, fetch.py:30-51)."""

    def __init__(self, path: str, timeout: float = 10.0):
        self.path = path + '.lock'
        self.timeout = timeout
        self._fd = None

    def __enter__(self):
        t0 = time.time()
        self._token = '{}-{}'.format(os.getpid(), time.monotonic_ns())
        while True:
            try:
                self._fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(self._fd, self._token.encode())
                return self
            except FileExistsError:
                if time.time() - t0 > self.timeout:
                    logging.warning('breaking stale lock %s', self.path)
                    try:
                        os.unlink(self.path)
                    except FileNotFoundError:
                        pass
                    # restart the staleness clock: the next lock file we see
                    # may be a fresh one another process just acquired —
                    # without the reset every retry would keep deleting
                    # live locks and let multiple writers race the registry
                    t0 = time.time()
                time.sleep(0.05)

    def __exit__(self, *a):
        if self._fd is not None:
            os.close(self._fd)
        # only unlink a lock file we still own: if OUR stale lock was broken
        # and another process acquired, its live lock must survive our exit
        try:
            with open(self.path) as f:
                if f.read() != self._token:
                    return
            os.unlink(self.path)
        except (FileNotFoundError, OSError):
            pass


def collect_models(job_dir: str) -> List[str]:
    """All job directories under job_dir (contain params.json)."""
    out = []
    for root, dirs, files in os.walk(job_dir):
        if 'params.json' in files:
            out.append(root)
            dirs[:] = []
    return sorted(out)


def fetch_models(job_dir: str, flash: bool = True,
                 filter: Optional[Callable[[Dict], bool]] = None) -> List[Dict]:
    """Flat dicts of every (non-deleted) job under job_dir; ``flash`` uses
    the registry cache when fresh (ref fetch.py:181-233)."""
    reg_path = _registry_path(job_dir)
    cache: Dict[str, Dict] = {}
    if flash and os.path.exists(reg_path):
        try:
            with _Lock(reg_path):
                cache = load_json(reg_path)
        except (json.JSONDecodeError, OSError):
            cache = {}

    dicts = []
    dirty = False
    for d in collect_models(job_dir):
        if is_derailed(d):
            continue
        mtime = max(os.path.getmtime(os.path.join(d, f))
                    for f in os.listdir(d)
                    if f.endswith('.json') and not f.startswith('models-'))
        entry = cache.get(d)
        if (entry is None or entry.get('_mtime', 0) < mtime
                or entry.get('_schema') != DICT_SCHEMA_VERSION):
            try:
                job = load_job(d, ghost=True)
            except Exception as e:
                logging.warning('skipping %s: %s', d, e)
                continue
            entry = make_dict_from_model(job, directory=d)
            entry['_mtime'] = mtime
            entry['_schema'] = DICT_SCHEMA_VERSION
            cache[d] = entry
            dirty = True
        dicts.append(entry)

    if dirty:
        with _Lock(reg_path):
            save_json(cache, reg_path)

    if filter is not None:
        dicts = [m for m in dicts if filter(m)]
    return dicts


def find_by_job_number(job_dir: str, number: int,
                       load_state: bool = True, **kw) -> Optional[Job]:
    """The job with this number under job_dir, or None; ``kw``
    (``device``, ``ghost``, ``strict``) goes to ``load_job``
    (ref fetch.py:288-300)."""
    for d in collect_models(job_dir):
        try:
            arch = load_json(os.path.join(d, 'params.json'))
        except (json.JSONDecodeError, OSError):
            continue
        if arch.get('job_number') == number:
            return load_job(d, load_state=load_state, **kw)
    return None


def needed_remote_files(job_dir: str, kinds=('state', 'records')) -> List[str]:
    """Paths missing locally that an rsync pull should fetch
    (ref fetch.py:303-384)."""
    out = []
    for d in collect_models(job_dir):
        if 'state' in kinds:
            if not os.path.exists(os.path.join(d, 'state.npz')):
                out.append(os.path.join(d, 'state.npz'))
            # ft sidecar arrays travel with the state: the frozen WIM
            # alternate prior / poscod llr head (ft/job.py, ft/poscod.py)
            tp_path = os.path.join(d, 'train_params.json')
            tp = load_json(tp_path) if os.path.exists(tp_path) else {}
            for key, fname in (('wim', 'wim_prior.npz'),
                               ('poscod', 'poscod_head.npz')):
                if tp.get(key) and not os.path.exists(os.path.join(d, fname)):
                    out.append(os.path.join(d, fname))
        if 'records' in kinds:
            samples = os.path.join(d, 'samples')
            if not os.path.isdir(samples):
                out.append(samples + '/')
    return out
