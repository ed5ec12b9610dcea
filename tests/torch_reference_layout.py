"""Write job directories in the reference's layout (moxime/joint-vae's
``save()``, ref cvae.py:2650-2675) from weights under the JAX package's
checkpoint keys, for the import tests and ``chip_smoke.py``.

    params.json, train_params.json, history.json, test.json, ood.json
    state.pth         the torch state_dict: Sequential indices with gaps
                      where the reference puts its activations, BatchNorm
                      buffers (num_batches_tracked included), torch
                      layouts (Linear (out, in), Conv2d OIHW,
                      ConvTranspose2d (I, O, kH, kW) flipped)
    optimizer.pth     torch's optimizer state_dict: ``state`` keyed by the
                      index of each parameter in state_dict order (buffers
                      excluded), ``param_groups``
    samples/<dir>/record-<set>.pth   LossRecorder.__dict__ dumps

The weights come as ``{'params/...': array, 'batch_stats/...': array}``
(``save_load/from_jax.py::state_dict_to_jax`` of a port model, or the
JAX package's flattened tree), the optimizer as the JAX package's
optimizer.npz arrays (``opt_state_to_jax``), so that importing the
directory gives the same arrays back.  A torchvision trunk (a
``save_load/tv_resnet.py`` module) is written as the reference keys it:
``features.<i>...`` over ``children()[:-1]``.

Imports neither jax nor the JAX package.
"""

import contextlib
import json
import os
import re
import sys
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_MOMENT_KEY = re.compile(r'^(.*/)?(mu|nu|trace)/(.+)$')
_FIELDS = {'mu': 'exp_avg', 'nu': 'exp_avg_sq', 'trace': 'momentum_buffer'}


def _inv_linear(k):
    return np.ascontiguousarray(k.T)


def _inv_conv(k):                                  # HWIO -> OIHW
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


def _inv_deconv(k):                      # HWIO -> (I, O, kH, kW), flipped
    return np.ascontiguousarray(k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


def _same(a):
    return np.array(a, order='C')


def _suffix(name: str) -> int:
    return int(name.rsplit('_', 1)[1])


def _children(params: Dict[str, np.ndarray], prefix: str) -> List[str]:
    """Names of the direct children of ``prefix`` in flat param paths."""
    out = []
    for k in params:
        if k.startswith(prefix + '/'):
            c = k[len(prefix) + 1:].split('/', 1)[0]
            if c not in out:
                out.append(c)
    return out


def correspondence(arrays: Dict[str, np.ndarray]
                   ) -> List[Tuple[str, Optional[str], Any]]:
    """[(reference key, JAX key or None, to_reference)] in the reference's
    state_dict order: features, encoder (projections, heads, prior),
    decoder, imager, classifier.  BatchNorm's ``num_batches_tracked`` has
    no JAX key."""
    p = {k[len('params/'):]: v for k, v in arrays.items()
         if k.startswith('params/')}
    out = []

    def linear(ref, jax):
        out.append((ref + '.weight', 'params/{}/kernel'.format(jax),
                    _inv_linear))
        out.append((ref + '.bias', 'params/{}/bias'.format(jax), _same))

    def conv_stack(jax, ref):
        names = _children(p, jax)
        idx = 0
        if 'dense' in names:
            linear('{}.{}'.format(ref, idx), jax + '/dense')
            idx += 2                                   # Linear, activation
        convs = sorted((n for n in names if n.startswith(('conv_',
                                                          'deconv_'))),
                       key=_suffix)
        bns = {_suffix(n): n for n in names if n.startswith('bn_')}
        for c in convs:
            inv = _inv_conv if c.startswith('conv_') else _inv_deconv
            r = '{}.{}'.format(ref, idx)
            out.append((r + '.weight', 'params/{}/{}/kernel'.format(jax, c),
                        inv))
            if '{}/{}/bias'.format(jax, c) in p:
                out.append((r + '.bias', 'params/{}/{}/bias'.format(jax, c),
                            _same))
            idx += 1
            bn = bns.pop(_suffix(c), None)
            if bn is not None:
                r = '{}.{}'.format(ref, idx)
                for f, j in (('weight', 'params/{}/{}/scale'),
                             ('bias', 'params/{}/{}/bias'),
                             ('running_mean', 'batch_stats/{}/{}/mean'),
                             ('running_var', 'batch_stats/{}/{}/var')):
                    out.append(('{}.{}'.format(r, f), j.format(jax, bn),
                                _same))
                out.append((r + '.num_batches_tracked', None, None))
                idx += 1
            idx += 1                                   # the activation
        if bns:
            raise ValueError('{}: BatchNorms {} follow no conv'.format(
                jax, sorted(bns.values())))

    def mlp(jax, ref, head=None):
        dense = sorted((n for n in _children(p, jax)
                        if n.startswith('dense_')), key=_suffix)
        for i, n in enumerate(dense):
            linear('{}.{}'.format(ref, 2 * i), '{}/{}'.format(jax, n))
        if head is not None:
            linear('{}.{}'.format(ref, 2 * len(dense)), jax + '/' + head)

    if any(k.startswith('features_stack/') for k in p):
        conv_stack('features_stack', 'features')
    mlp('encoder/dense_projs', 'encoder.dense_projs')
    for head in ('dense_mean', 'dense_log_var', 'sigma'):
        if 'encoder/{}/kernel'.format(head) in p:
            linear('encoder.' + head, 'encoder/' + head)
    if 'prior/mean' in p:
        out.append(('encoder.prior.mean', 'params/prior/mean', _same))
    if 'prior/var_param' in p:
        out.append(('encoder.prior._var_parameter', 'params/prior/var_param',
                    _same))
    if any(k.startswith('decoder/') for k in p):
        mlp('decoder', 'decoder')
    if any(k.startswith('imager/') for k in p):
        conv_stack('imager', 'imager')
    if any(k.startswith('classifier/') for k in p):
        mlp('classifier', 'classifier',
            'head' if 'classifier/head/kernel' in p else None)
    return out


def reference_state_dict(arrays: Dict[str, np.ndarray],
                         trunk: Optional[torch.nn.Module] = None
                         ) -> Dict[str, np.ndarray]:
    """The reference's state_dict (numpy, in its order) of the weights in
    ``arrays``; with ``trunk`` (a torchvision-layout module), its
    ``children()[:-1]`` take the features' place.  ``sigma``: the learned
    ``params/sigma_param`` (log-space) or else ``sigma_state/data``."""
    sd = {}
    if trunk is not None:
        seq = torch.nn.Sequential(*list(trunk.children())[:-1])
        for k, v in seq.state_dict().items():
            sd['features.' + k] = v.detach().cpu().numpy()
        arrays = {k: v for k, v in arrays.items()
                  if not k.startswith(('params/features_stack/',
                                       'batch_stats/features_stack/'))}
    for ref, jax, inv in correspondence(arrays):
        sd[ref] = (np.asarray(0, np.int64) if jax is None
                   else inv(np.asarray(arrays[jax])))
    if 'params/sigma_param' in arrays:
        sd['sigma'] = _same(arrays['params/sigma_param'])
    elif 'sigma_state/data' in arrays:
        sd['sigma'] = _same(arrays['sigma_state/data'])
    return sd


def reference_optimizer(sd: Dict[str, np.ndarray],
                        arrays: Dict[str, np.ndarray],
                        opt_arrays: Dict[str, np.ndarray],
                        param_group: Optional[dict] = None) -> dict:
    """torch's optimizer state_dict over the parameters of ``sd`` (its
    order, buffers excluded) from the JAX package's optimizer arrays:
    ``mu``/``nu`` -> Adam's ``exp_avg``/``exp_avg_sq`` with ``step`` (a
    float tensor, as recent torch keeps it) from scale_by_adam's count,
    ``trace`` -> SGD's ``momentum_buffer``.  A parameter with no moment
    (a trunk's, sigma unless learned) has no state entry, as in torch for
    a parameter that never had a gradient."""
    moments: Dict[str, Dict[str, np.ndarray]] = {}
    count = None
    for k, v in opt_arrays.items():
        m = _MOMENT_KEY.match(k)
        if m:
            moments.setdefault(_FIELDS[m.group(2)], {})[m.group(3)] = v
            if m.group(2) == 'mu':
                count = opt_arrays.get((m.group(1) or '') + 'count')
    inv = {ref: (jax, f) for ref, jax, f in correspondence(arrays)
           if jax is not None and jax.startswith('params/')}
    if 'params/sigma_param' in arrays:
        inv['sigma'] = ('params/sigma_param', _same)
    pnames = [k for k in sd if not k.endswith(
        ('running_mean', 'running_var', 'num_batches_tracked'))]
    state = {}
    for i, name in enumerate(pnames):
        if name not in inv:
            continue
        path = inv[name][0][len('params/'):]
        st = {field: torch.from_numpy(inv[name][1](np.asarray(m[path])))
              for field, m in moments.items() if path in m}
        if not st:
            continue
        if count is not None:
            st['step'] = torch.tensor(float(np.asarray(count)))
        state[i] = st
    group = {'lr': 1e-3, 'betas': (0.9, 0.999), 'eps': 1e-8,
             'weight_decay': 0, 'amsgrad': False}
    group.update(param_group or {})
    group['params'] = list(range(len(pnames)))
    return {'state': state, 'param_groups': [group]}


def loss_record_dump(rec, device='cpu') -> dict:
    """The reference's record-<set>.pth (``LossRecorder.__dict__``) of a
    port ``LossRecorder``, its tensors on ``device``."""
    return {'_tensors': {k: torch.from_numpy(np.array(v, order='C')).to(
                device) for k, v in rec._tensors.items()},
            'batch_size': rec.batch_size, '_num_batch': rec._num_batch,
            '_recorded_batches': rec._recorded_batches,
            'last_batch_size': rec.last_batch_size, '_seed': rec._seed}


def sample_record_dump(tensors: Dict[str, np.ndarray],
                       aux: Optional[Dict[str, np.ndarray]] = None,
                       device='cpu') -> dict:
    """The reference's samples-<set>.pth (``SampleRecorder.__dict__``)."""
    t = lambda d: {k: torch.from_numpy(np.array(v, order='C')).to(device)
                   for k, v in (d or {}).items()}
    return {'_tensors': t(tensors), '_aux': t(aux)}


@contextlib.contextmanager
def _reference_sigma_class():
    """A ``Sigma`` Parameter subclass importable as
    ``module.vae_layers.layers.Sigma`` while the block runs (pickle names
    classes by module), the previous modules of those names restored
    after."""
    names = ('module', 'module.vae_layers', 'module.vae_layers.layers')
    saved = {n: sys.modules.get(n) for n in names}
    mods = {n: types.ModuleType(n) for n in names}

    class Sigma(torch.nn.Parameter):
        def __reduce_ex__(self, proto):
            return (Sigma, (self.data, False))
    Sigma.__module__ = 'module.vae_layers.layers'
    Sigma.__qualname__ = 'Sigma'
    mods['module.vae_layers.layers'].Sigma = Sigma
    sys.modules.update(mods)
    try:
        yield Sigma
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def _dump_json(d, path):
    with open(path, 'w') as f:
        json.dump(d, f, indent=1)


def write_reference_job(job_dir: str, arch: Dict[str, Any],
                        arrays: Dict[str, np.ndarray], *,
                        training_parameters: Optional[dict] = None,
                        history: Optional[dict] = None,
                        test: Optional[dict] = None,
                        ood: Optional[dict] = None,
                        opt_arrays: Optional[Dict[str, np.ndarray]] = None,
                        param_group: Optional[dict] = None,
                        records: Optional[Dict[str, Dict[str, dict]]] = None,
                        trunk: Optional[torch.nn.Module] = None,
                        extra: Optional[Dict[str, np.ndarray]] = None,
                        sigma_subclass: bool = False,
                        device='cpu') -> Dict[str, np.ndarray]:
    """Write a reference job directory; returns its state_dict (numpy).

    ``arch``: params.json (the architecture dict; ``job_number`` left out
    makes the importer take the directory's name); ``records``:
    {samples sub-dir ('2', 'last', '2/init'): {file name: dump}};
    ``extra``: more state_dict entries (a WIM job's
    ``_alternate_prior.*``, a Poscod job's ``ood_head.1.*``), appended;
    ``sigma_subclass``: ``sigma`` pickled as the reference's Sigma
    Parameter subclass, which only unpickles with the importer's stubs;
    ``device``: where the saved tensors lie (``torch.load``'s
    ``map_location`` brings them back)."""
    os.makedirs(job_dir, exist_ok=True)
    _dump_json(arch, os.path.join(job_dir, 'params.json'))
    for name, d in (('train_params.json', training_parameters),
                    ('history.json', history), ('test.json', test),
                    ('ood.json', ood)):
        if d is not None:
            _dump_json(d, os.path.join(job_dir, name))
    sd = reference_state_dict(arrays, trunk)
    sd.update(extra or {})
    tensors = {k: torch.from_numpy(np.array(v, order='C')).to(device)
               for k, v in sd.items()}
    path = os.path.join(job_dir, 'state.pth')
    if sigma_subclass and 'sigma' in tensors:
        with _reference_sigma_class() as sigma_cls:
            tensors['sigma'] = sigma_cls(tensors['sigma'], False)
            torch.save(tensors, path)
    else:
        torch.save(tensors, path)
    if opt_arrays is not None:
        opt = reference_optimizer(sd, arrays, opt_arrays, param_group)
        for st in opt['state'].values():
            for k, v in st.items():
                if k != 'step':
                    st[k] = v.to(device)
        torch.save(opt, os.path.join(job_dir, 'optimizer.pth'))
    for sub, files in (records or {}).items():
        d = os.path.join(job_dir, 'samples', *sub.split('/'))
        os.makedirs(d, exist_ok=True)
        for name, dump in files.items():
            torch.save(dump, os.path.join(d, name))
    return sd
