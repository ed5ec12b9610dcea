"""Decode worker of the ImageFolder ingest (``data/ingest.py``).

Run as ``python -S ingest_worker.py <site-packages dir> <jobs json>``:
no site or sitecustomize, so nothing but numpy and PIL is imported (not
torch, not this package).  The jobs file carries the memmap path and
shape and ``[index, path]`` entries; the worker decodes each file into
its row of the memmap, reports each failure on one stdout line and exits
1 when any file failed.  It decodes as ``ingest.decode_one`` does.
"""

import json
import sys


def main():
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    from PIL import Image
    with open(sys.argv[2]) as f:
        spec = json.load(f)
    c, h, w = spec['shape']
    mm = np.memmap(spec['mm'], dtype=np.uint8, mode='r+',
                   shape=(spec['n'], c, h, w))
    failed = 0
    for i, p in spec['entries']:
        try:
            img = Image.open(p).convert('RGB' if c == 3 else 'L').resize(
                (w, h))
            a = np.asarray(img, np.uint8)
            mm[i] = a[None] if a.ndim == 2 else a.transpose(2, 0, 1)
        except Exception as e:           # the slot stays zero; reported
            failed += 1
            print('{}: {}'.format(p, e), flush=True)
    mm.flush()
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
