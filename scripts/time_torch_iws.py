#!/usr/bin/env python3
"""Time the port's IWAE-combine kernel of another tree at the shapes of
``chip_smoke.py`` phase 3, on one CUDA card, the way phase 3 times it.

    python3 scripts/time_torch_iws.py --root DIR

DIR is the root of a checkout whose ``joint_vae_tpu_torch`` is imported
(for example an earlier commit unpacked with ``git archive``); its kernels
build into DIR/build.  The inputs and timers are this tree's
``chip_smoke.py``.  Each case prints one ``iws_earlier`` JSON line with
its times, its worst error against the plain version and whether every
element is within phase 3's gate (reported, not enforced: an earlier
kernel may miss it).
"""

import argparse
import importlib.util
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', required=True)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_timers', os.path.join(here, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('time_torch_iws: no CUDA card')
    import joint_vae_tpu_torch.ops.iws as iws
    if not iws.__file__.startswith(root):
        raise SystemExit('imported {} outside {}'.format(iws.__file__, root))
    print(cs.card_line(), flush=True)
    g = torch.Generator(device='cuda').manual_seed(2)
    for (L, N, C, K, scale, modes) in cs.IWS_CASES:
        args, _ = cs.iws_inputs(L, N, C, K, g, scale)
        for ref_mode in modes:
            out = iws.iws_combine(*args, ref_mode=ref_mode)
            ref = iws.iws_combine_plain(*args, ref_mode=ref_mode)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            row = {'root': root, 'shape': [L, N, C, K], 'mean_scale': scale,
                   'ref_mode': ref_mode, 'max_abs_err': err.max().item(),
                   'within_gate': bool(torch.all(
                       err <= cs.IWS_ATOL + cs.IWS_RTOL * ref.abs()))}
            row.update(cs.time_iws(iws.iws_combine, args, ref_mode))
            print('iws_earlier', json.dumps(row), flush=True)
        del args
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
