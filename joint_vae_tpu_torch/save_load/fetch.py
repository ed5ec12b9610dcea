"""Job lookup under a jobs root: the part of the JAX package's
``save_load/fetch.py`` that the train CLI uses (``--resume``).  The
model registry cache and its queries are not ported.
"""

import json
import os
from typing import List, Optional

from ..device import DeviceLike
from .checkpoint import load_json
from .jobs import Job, load_job


def collect_models(job_dir: str) -> List[str]:
    """All job directories under job_dir (contain params.json)."""
    out = []
    for root, dirs, files in os.walk(job_dir):
        if 'params.json' in files:
            out.append(root)
            dirs[:] = []
    return sorted(out)


def find_by_job_number(job_dir: str, number: int,
                       device: DeviceLike = None) -> Optional[Job]:
    """The job with this number under job_dir, loaded onto ``device``, or
    None (ref fetch.py:288-300)."""
    for d in collect_models(job_dir):
        try:
            arch = load_json(os.path.join(d, 'params.json'))
        except (json.JSONDecodeError, OSError):
            continue
        if arch.get('job_number') == number:
            return load_job(d, device=device)
    return None
