#!/usr/bin/env python
"""Do the flagship's OOD scores repeat, within a process and across
processes, and do they depend on the card's free memory?

    python scripts/torch_score_repeat_probe.py --what ood --repeats 6
    python scripts/torch_score_repeat_probe.py --what ood --leave-free-gb 8
    python scripts/torch_score_repeat_probe.py --what convs --leave-free-gb 1
    python scripts/torch_score_repeat_probe.py --modes eager graphed --fill-cache-gb 60

``--what ood``: ``chip_smoke.py`` phase 6's setup (the flagship of
``models/cvnet.py::flagship_config`` from seed 0, cifar100's test split
and cifar10/svhn/lsunc, 10,000 synthetic images each, batch 512, L=16,
the compute tier on the engines' graphs held on the job), run
``--repeats`` times in this process; a digest of every score array per
run.  ``--what convs``: the forward of every layer of the features stack
on cuDNN (the 'conv' route, ``models/conv.py``) at the OOD evaluation's
two batch shapes (512 and its ragged 272), each output's digest.
``--modes``: the runs' modes, in order (``graphed=False`` for 'eager'),
on one job, each set's scores digested whole and per batch.
``--fill-cache-gb G`` first takes G GiB and frees it, so that the
allocator's cache holds it idle, as after a long process's earlier work;
``--empty-cache-at-capture`` gives the cache back before every capture.
``--leave-free-gb G`` first takes all but G GiB of the card's free memory
with one allocation: PyTorch's cuDNN path tries the heuristic's
algorithms in order and takes the next one where a workspace allocation
fails, and it keeps the first one that ran for the process.  Prints one
JSON line (``--out`` also writes it); compare two processes' digests.
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.append(REPO)

OOD_SETS = ('cifar10', 'svhn', 'lsunc')
BATCH = 512
TAIL = 10000 % BATCH


def digest(t: torch.Tensor) -> str:
    a = t.detach().contiguous().cpu()
    return hashlib.sha256(a.view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def hog(leave_free_gb):
    """All but ``leave_free_gb`` GiB of the card's free memory, held."""
    if leave_free_gb is None:
        return None
    free, _ = torch.cuda.mem_get_info()
    take = free - int(leave_free_gb * 2 ** 30)
    return torch.empty(max(take, 0), dtype=torch.uint8, device='cuda')


def ood_digests(job, repeats: int, modes=('graphed',)) -> list:
    """Per run (``repeats`` in each mode, in order, on one job): each
    set's score digests, whole and per batch, the AUCs, the seconds."""
    from joint_vae_tpu_torch.data.loaders import get_dataset
    from joint_vae_tpu_torch.evals import engines
    _, testset = get_dataset('cifar100', splits=['test'])
    oodsets = [get_dataset(n, splits=['test'])[1] for n in OOD_SETS]
    collect = engines._collect_scores
    runs = []
    for mode in modes:
        for _ in range(repeats):
            got, batches = {}, {}

            def keep(job_, dataset, *a, **k):
                out = collect(job_, dataset, *a, **k)
                got[dataset.name] = {m: digest(v) for m, v in out.items()}
                v = torch.stack([out[m].float() for m in sorted(out)])
                batches[dataset.name] = [
                    digest(v[:, i:i + BATCH])
                    for i in range(0, v.shape[1], BATCH)]
                return out
            engines._collect_scores = keep
            try:
                t0 = time.perf_counter()
                res = engines.ood_detection_rates(
                    job, testset, oodsets, batch_size=BATCH,
                    from_where=('compute',), update_self_ood=False,
                    recording=False, graphed=mode == 'graphed')
                torch.cuda.synchronize()
            finally:
                engines._collect_scores = collect
            runs.append({'mode': mode, 'scores': got, 'batches': batches,
                         'seconds': time.perf_counter() - t0,
                         'auc': {s: {m: r['auc'] for m, r in ms.items()}
                                 for s, ms in res.items()}})
    return runs


def fill_cache(gb: float) -> None:
    """``gb`` GiB taken in 1 GiB blocks and freed: the caching allocator
    keeps them reserved, as after a long process's earlier work."""
    if gb:
        blocks = [torch.empty(2 ** 30, dtype=torch.uint8, device='cuda')
                  for _ in range(int(gb))]
        del blocks


def conv_digests(job) -> dict:
    """Each cuDNN layer's forward output digest at the two batch shapes."""
    from joint_vae_tpu_torch.models.conv import ConvLayer
    model = job.model
    layers = {n: m for n, m in model.named_modules()
              if isinstance(m, ConvLayer) and m.route == 'conv'}
    out, hooks = {}, []
    for name, m in layers.items():
        hooks.append(m.register_forward_hook(
            lambda mod, inp, o, name=name: out.__setitem__(
                '{}/{}'.format(name, inp[0].shape[0]), digest(o))))
    rng = np.random.default_rng(0)
    try:
        with torch.no_grad():
            for n in (BATCH, TAIL):
                x = torch.from_numpy(rng.uniform(
                    0, 1, (n,) + job.model_cfg.input_shape).astype(
                        np.float32)).to(job.device)
                model.features_stack(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--what', default='ood', choices=['ood', 'convs'])
    p.add_argument('--repeats', type=int, default=1)
    p.add_argument('--leave-free-gb', type=float, default=None)
    p.add_argument('--modes', nargs='+', default=['graphed'],
                   choices=['graphed', 'eager'],
                   help="--what ood: the runs' modes, in order, on one job")
    p.add_argument('--fill-cache-gb', type=float, default=0,
                   help='take and free this many GiB first (reserved, idle)')
    p.add_argument('--empty-cache-at-capture', action='store_true',
                   help='give the allocator\'s cache back before every '
                        'capture (the graphs do so only when it holds '
                        'more idle memory than the card has free)')
    p.add_argument('--label', default='')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA card')
    from joint_vae_tpu_torch.device import set_float32_math
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job
    set_float32_math()
    if args.empty_cache_at_capture:
        from joint_vae_tpu_torch.train import graphs
        capture = graphs.GraphRunner._capture

        def emptied(*a, **k):
            torch.cuda.empty_cache()
            return capture(*a, **k)
        graphs.GraphRunner._capture = emptied
    held = hog(args.leave_free_gb)
    fill_cache(args.fill_cache_gb)
    job = new_job(flagship_config(), seed=0)
    line = {'label': args.label, 'what': args.what,
            'leave_free_gb': args.leave_free_gb,
            'fill_cache_gb': args.fill_cache_gb,
            'empty_cache_at_capture': args.empty_cache_at_capture,
            'reserved_bytes_at_start': torch.cuda.memory_reserved(),
            'free_bytes_at_start': torch.cuda.mem_get_info()[0],
            'device': torch.cuda.get_device_name(0)}
    if args.what == 'ood':
        line['runs'] = ood_digests(job, args.repeats, args.modes)
    else:
        line['convs'] = conv_digests(job)
    del held
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, 'a') as f:
            f.write(text + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
