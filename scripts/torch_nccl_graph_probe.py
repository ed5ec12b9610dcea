#!/usr/bin/env python3
"""What a CUDA graph holds of the port's NCCL collectives on one card, one
``nccl_capture`` line a case:

    python3 scripts/torch_nccl_graph_probe.py

On a world of one rank over NCCL (``parallel/mesh.py::distributed_init``),
each collective that a mesh step or batch runs, on a float32 buffer of
the flagship's parameter count: the all-reduce in place as
``shard_steps.py::reduce_over_data`` runs it (and the whole
``reduce_over_data`` of the flagship's gradients), the all-reduce with
``ReduceOp.AVG``, the all-gather into one tensor (``mesh.py::
_all_gather_cat``) and into a list, and the all-reduce in a backward
(``mesh.py::_AllReduceSum``, issued from autograd's device thread).  Each
is run once eagerly on the capturing stream, then captured in the
'global' and in the 'thread_local' ``capture_error_mode``: the graph's
nodes by type and NCCL's kernel nodes among them
(``train/graphs.py::kernel_nodes``), the replay against the eager call,
and the replay's ms beside the eager call's (CUDA events).  Then 20
captures each begun right after an eager collective with no
synchronisation between them (NCCL's watchdog still holds the eager
one); gloo's all-gather on the card's tensors (the path of
``chip_smoke.py`` phase 12 (b)); and last, a capture of a collective on
a new group that no collective has run on (its communicator would be
made inside the capture).

Needs a CUDA card; exits nonzero without one.
"""

import json
import os
import socket
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 50


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _ms(fn, reps: int = REPS) -> float:
    """Device ms per call of ``fn`` (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def capture(fn, mode: str, warm: bool = True):
    """``fn`` run once eagerly on a side stream (``warm``), then captured
    there in ``mode``: (graph, output, nodes, error text or None)."""
    from joint_vae_tpu_torch.train.graphs import kernel_nodes
    side = torch.cuda.Stream()
    cur = torch.cuda.current_stream()
    if warm:
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
        cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode=mode)
            try:
                out = fn()
            finally:
                graph.capture_end()
        nodes = kernel_nodes(graph.raw_cuda_graph())
        graph.instantiate()
    except Exception as e:          # reported, the probe goes on
        torch.cuda.synchronize()
        return None, None, None, '{}: {}'.format(type(e).__name__,
                                                 str(e)[:300])
    cur.wait_stream(side)
    return graph, out, nodes, None


def _line(row: dict) -> None:
    print('nccl_capture', json.dumps(row), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit('torch_nccl_graph_probe: no CUDA card')
    from joint_vae_tpu_torch.models.cvnet import CVNet, flagship_config
    from joint_vae_tpu_torch.parallel.mesh import (_AllReduceSum,
                                                   _all_gather_single,
                                                   all_reduce_mean_,
                                                   distributed_init,
                                                   make_mesh)
    from joint_vae_tpu_torch.parallel.shard_steps import reduce_over_data
    distributed_init('localhost:{}'.format(_free_port()), 1, 0,
                     backend='nccl')
    mesh = make_mesh()
    g = mesh.group('data')
    shapes = {n: tuple(p.shape)
              for n, p in CVNet(flagship_config()).named_parameters()}
    n = sum(int(torch.Size(s).numel()) for s in shapes.values())
    gen = torch.Generator(device='cuda').manual_seed(0)
    grads = {k: torch.randn(s, generator=gen, device='cuda')
             for k, s in shapes.items()}
    buf = torch.randn(n, generator=gen, device='cuda')
    small = torch.randn(4096, generator=gen, device='cuda')
    gathered = torch.empty(n, device='cuda')
    parts = [torch.empty(n, device='cuda')]
    xg = small.clone().requires_grad_(True)
    print('probe', json.dumps({
        'torch': torch.__version__, 'cuda': torch.version.cuda,
        'nccl': '.'.join(map(str, torch.cuda.nccl.version())),
        'card': torch.cuda.get_device_name(0), 'floats': n,
        'backend': mesh.backend}), flush=True)

    def backward():
        y = _AllReduceSum.apply(xg * 2.0, g)
        return torch.autograd.grad((y * y).sum(), [xg])[0]

    cases = {
        'all_reduce_in_place': (lambda: dist.all_reduce(buf, group=g),
                                lambda: buf),
        'all_reduce_mean_force': (
            lambda: all_reduce_mean_(buf, mesh, 'data', force=True),
            lambda: buf),
        'reduce_over_data': (lambda: reduce_over_data(grads, mesh), None),
        'all_reduce_avg': (lambda: dist.all_reduce(
            buf, op=dist.ReduceOp.AVG, group=g), lambda: buf),
        'all_gather_into_tensor': (
            lambda: _all_gather_single(gathered, buf, group=g),
            lambda: gathered),
        'all_gather_list': (lambda: dist.all_gather(parts, buf, group=g),
                            lambda: parts[0]),
        'backward_all_reduce': (backward, None),
    }
    for name, (fn, result) in cases.items():
        for mode in ('global', 'thread_local'):
            want = fn()
            want = (result() if result is not None else want)
            want = ({k: v.clone() for k, v in want.items()}
                    if isinstance(want, dict) else want.clone())
            eager_ms = _ms(fn)
            graph, out, nodes, err = capture(fn, mode)
            row = {'case': name, 'mode': mode, 'error': err}
            if err is None:
                graph.replay()
                torch.cuda.synchronize()
                got = result() if result is not None else out
                if isinstance(want, dict):
                    same = all(torch.equal(got[k], want[k]) for k in want)
                else:
                    same = torch.equal(got, want)
                row.update({'nodes_by_type': nodes['by_type'],
                            'nccl_kernel_nodes': nodes['nccl'],
                            'replay_equal': same,
                            'replay_ms': _ms(graph.replay),
                            'eager_ms': eager_ms})
                del graph
            _line(row)

    # captures begun while the watchdog still holds an eager collective
    fails, t0 = [], time.perf_counter()
    for i in range(20):
        dist.all_reduce(small, group=g)
        _, _, _, err = capture(lambda: dist.all_reduce(small, group=g),
                               'global', warm=False)
        if err is not None:
            fails.append(err)
    _line({'case': 'capture_after_eager_collective', 'mode': 'global',
           'captures': 20, 'failed': len(fails), 'errors': fails[:2],
           'seconds': time.perf_counter() - t0})

    # gloo on the card's tensors: phase 12 (b)'s all-gather
    gg = dist.new_group(backend='gloo')
    x = torch.arange(6.0, device='cuda').reshape(2, 3)
    full = torch.empty_like(x)
    try:
        _all_gather_single(full, x, group=gg)
        _line({'case': 'gloo_all_gather_into_tensor_cuda', 'error': None,
               'equal': torch.equal(full, x)})
    except Exception as e:
        _line({'case': 'gloo_all_gather_into_tensor_cuda',
               'error': '{}: {}'.format(type(e).__name__, str(e)[:300])})

    # last: a new NCCL group that no collective has run on
    g2 = dist.new_group([0], backend='nccl')
    _, _, nodes, err = capture(lambda: dist.all_reduce(small, group=g2),
                               'global', warm=False)
    _line({'case': 'no_warm_up_new_group', 'mode': 'global', 'error': err,
           'nodes_by_type': None if nodes is None else nodes['by_type']})
    torch.cuda.synchronize()
    dist.destroy_process_group()
    print('probe done', flush=True)


if __name__ == '__main__':
    main()
