#!/usr/bin/env python3
"""Whether the port's kernels can be captured in a CUDA graph on the card,
one ``capture`` line a case:

    python3 scripts/torch_graph_probe.py

each kernel wrapper (the same-grid conv in float32 and bfloat16, its
input gradient, the IWAE combine) and the conv's autograd backward
captured in the default ``capture_error_mode`` ('global') and in
'relaxed', the error of each capture that fails, and the replay against
the eager call.  (The registered generator's draws under replay are
``tests/test_torch_graphs_cuda.py::test_generator_under_replay``'s.)

Needs a CUDA card; exits nonzero without one.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _capture(fn, mode):
    """-> (graph, output, error text or None)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode=mode):
            out = fn()
    except Exception as e:          # reported, the probe goes on
        torch.cuda.synchronize()
        return None, None, '{}: {}'.format(type(e).__name__, str(e)[:300])
    return graph, out, None


def capture_rows():
    from joint_vae_tpu_torch.ops.iws import iws_combine
    from joint_vae_tpu_torch.ops.same_grid_conv import (SameGridConvFn,
                                                        same_grid_conv,
                                                        same_grid_conv_dx)
    g = torch.Generator(device='cuda').manual_seed(0)
    x = torch.randn((64, 16, 16, 32), generator=g, device='cuda')
    k = torch.randn((3, 3, 32, 64), generator=g, device='cuda') * 0.1
    x16, k16 = x.bfloat16(), k.bfloat16()
    gy = torch.randn((64, 16, 16, 64), generator=g, device='cuda')
    L, N, K, C = 16, 128, 32, 10
    z = torch.randn((L, N, K), generator=g, device='cuda')
    lp = -100 + torch.randn((L, N), generator=g, device='cuda')
    mean = torch.randn((C, K), generator=g, device='cuda')
    s2 = 0.5 + torch.rand((C,), generator=g, device='cuda')
    ldp = -K * torch.log(s2)
    xg = x.clone().requires_grad_(True)
    kg = k.clone().requires_grad_(True)

    def backward():
        y = SameGridConvFn.apply(xg, kg, 1, 1)
        return torch.autograd.grad((y * gy).sum(), [xg, kg])

    cases = {
        'conv_f32': lambda: same_grid_conv(x, k, 1, 1),
        'conv_bf16': lambda: same_grid_conv(x16, k16, 1, 1),
        'conv_dx_f32': lambda: same_grid_conv_dx(gy, k, 1, 1),
        'iws_combine': lambda: iws_combine(z, lp, mean, s2, ldp),
        'conv_autograd_backward': backward,
    }
    rows = []
    for name, fn in cases.items():
        want = fn()
        row = {'case': name}
        for mode in ('global', 'relaxed'):
            graph, out, err = _capture(fn, mode)
            row[mode] = 'ok' if err is None else err
            if graph is not None:
                graph.replay()
                torch.cuda.synchronize()
                outs = out if isinstance(out, tuple) else (out,)
                wants = want if isinstance(want, tuple) else (want,)
                row[mode + '_replay_equal'] = all(
                    torch.equal(a, b) for a, b in zip(outs, wants))
                del graph
        rows.append(row)
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit('torch_graph_probe: no CUDA card')
    from joint_vae_tpu_torch.device import set_float32_math
    from joint_vae_tpu_torch.ops import cuda_lib
    set_float32_math()
    cuda_lib.build()
    print('versions', json.dumps({'torch': torch.__version__,
                                  'cuda': torch.version.cuda,
                                  'card': torch.cuda.get_device_name(0)}))
    for row in capture_rows():
        print('capture', json.dumps(row), flush=True)


if __name__ == '__main__':
    main()
