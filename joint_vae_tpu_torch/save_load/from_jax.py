"""Weight bridge between the JAX package's checkpoint arrays and the port.

The JAX checkpoint stores arrays under tree paths
(``params/features_stack/conv_0/kernel``, ``batch_stats/imager/bn_2/mean``).
The port's modules carry the same names, so a path maps to a
``state_dict`` key by swapping '/' for '.'; the layouts convert:

- dense kernels (in, out) -> ``weight`` (out, in);
- conv kernels (k, k, Cin, Cout), correlation-oriented (a JAX "deconv"
  kernel included) -> the layout of the layer's route (``ConvLayer``):
  as is for the same-grid, sub-pixel and matmul routes, OIHW for
  ``F.conv2d``, and ``k[::-1, ::-1].transpose(2, 3, 0, 1)`` for
  ``F.conv_transpose2d``;
- BatchNorm ``scale``/``bias`` and ``mean``/``var`` statistics;
- prior ``mean``/``var_param`` and ``sigma_param`` as they are.

Both directions are exact (transposes and flips), so JAX -> port -> JAX
returns the same bits.

The optimizer state (``optimizer.npz``) is the flattened optax chain of
``train/optimizers.py::build_optimizer`` in the JAX package; its keys
depend on the chain's composition (``c`` = 1 with gradient clipping, else
0; ``a`` = 1 with weight decay, else 0)::

    {c}/count                           updates applied
    {c}/hyperparams/learning_rate       the injected learning rate
    {c}/inner_state/{a}/count           scale_by_adam's count
    {c}/inner_state/{a}/mu/<param path> first moments (adam)
    {c}/inner_state/{a}/nu/<param path> second moments (adam)
    {c}/inner_state/{a}/trace/<param path>  momentum (sgd)

with each moment in its parameter's JAX layout (converted like the
parameter itself).
"""

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from ..models.conv import BatchNorm, ConvLayer
from ..models.layers import Dense, PriorParams


def _entries(model: nn.Module):
    """(jax key, state_dict key, to_port, to_jax) for every array."""
    out = []
    for name, mod in model.named_modules():
        jp = name.replace('.', '/')
        if isinstance(mod, Dense):
            t = lambda a: a.T
            out += [('params/{}/kernel'.format(jp), name + '.weight', t, t),
                    ('params/{}/bias'.format(jp), name + '.bias', None, None)]
        elif isinstance(mod, ConvLayer):
            out += [('params/{}/kernel'.format(jp), name + '.weight',
                     mod.from_hwio, mod.to_hwio),
                    ('params/{}/bias'.format(jp), name + '.bias', None, None)]
        elif isinstance(mod, BatchNorm):
            out += [('params/{}/scale'.format(jp), name + '.weight', None, None),
                    ('params/{}/bias'.format(jp), name + '.bias', None, None),
                    ('batch_stats/{}/mean'.format(jp), name + '.running_mean',
                     None, None),
                    ('batch_stats/{}/var'.format(jp), name + '.running_var',
                     None, None)]
        elif isinstance(mod, PriorParams):
            out += [('params/{}/mean'.format(jp), name + '.mean', None, None),
                    ('params/{}/var_param'.format(jp), name + '.var_param',
                     None, None)]
    if hasattr(model, 'sigma_param'):
        out.append(('params/sigma_param', 'sigma_param', None, None))
    return out


def param_paths(model: nn.Module) -> Dict[str, str]:
    """state_dict key of each parameter -> its JAX path under ``params/``
    (``features_stack/conv_0/kernel``)."""
    return {tkey: jkey[len('params/'):] for jkey, tkey, _, _ in _entries(model)
            if jkey.startswith('params/')}


def _opt_prefixes(opt_cfg):
    c = 1 if opt_cfg.grad_clipping else 0
    a = 1 if opt_cfg.weight_decay else 0
    return '{}/'.format(c), '{}/inner_state/{}/'.format(c, a)


def opt_state_to_jax(model: nn.Module, opt_cfg, opt_state
                     ) -> Dict[str, np.ndarray]:
    """The port's ``OptState`` -> the JAX package's optimizer.npz arrays."""
    outer, inner = _opt_prefixes(opt_cfg)
    out = {outer + 'count': np.asarray(opt_state.count, np.int32),
           outer + 'hyperparams/learning_rate':
               np.asarray(opt_state.learning_rate, np.float32)}
    conv = {tkey: (jkey[len('params/'):], to_jax)
            for jkey, tkey, _, to_jax in _entries(model)
            if jkey.startswith('params/')}
    moments = {'mu': opt_state.mu, 'nu': opt_state.nu,
               'trace': opt_state.trace}
    if opt_cfg.optim_type == 'adam':
        out[inner + 'count'] = np.asarray(opt_state.adam_count, np.int32)
    for kind, tensors in moments.items():
        for tkey, t in tensors.items():
            path, to_jax = conv[tkey]
            t = t.detach().cpu().float()
            if to_jax is not None:
                t = to_jax(t)
            out['{}{}/{}'.format(inner, kind, path)] = t.contiguous().numpy()
    return out


def jax_to_opt_state(model: nn.Module, opt_cfg, arrays: Dict[str, np.ndarray],
                     opt_state):
    """Fill ``opt_state`` (a fresh ``OptState`` for ``model``, on its
    device) from optimizer.npz arrays; leaves the file lacks keep their
    fresh values (as the JAX package's lenient load does)."""
    outer, inner = _opt_prefixes(opt_cfg)
    if outer + 'count' in arrays:
        opt_state.count = int(arrays[outer + 'count'])
    if outer + 'hyperparams/learning_rate' in arrays:
        opt_state.learning_rate = float(np.float32(
            arrays[outer + 'hyperparams/learning_rate']))
    if inner + 'count' in arrays:
        opt_state.adam_count = int(arrays[inner + 'count'])
    conv = {tkey: (jkey[len('params/'):], to_port)
            for jkey, tkey, to_port, _ in _entries(model)
            if jkey.startswith('params/')}
    for kind in ('mu', 'nu', 'trace'):
        tensors = getattr(opt_state, kind)
        for tkey, t in tensors.items():
            path, to_port = conv[tkey]
            key = '{}{}/{}'.format(inner, kind, path)
            if key not in arrays:
                continue
            a = torch.from_numpy(np.array(arrays[key], dtype=np.float32))
            if to_port is not None:
                a = to_port(a)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError('optimizer leaf {} has shape {}, the model '
                                 'expects {}'.format(key, tuple(a.shape),
                                                     tuple(t.shape)))
            with torch.no_grad():
                t.copy_(a)
    return opt_state


def jax_to_state_dict(model: nn.Module, arrays: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
    """JAX checkpoint arrays -> the ``state_dict`` of a port module (a
    ``CVNet`` or a single ``ConvStack``).  Raises on a missing key or a
    shape that does not fit the module."""
    template = model.state_dict()
    sd = {}
    missing = []
    for jkey, tkey, to_port, _ in _entries(model):
        if jkey not in arrays:
            missing.append(jkey)
            continue
        t = torch.from_numpy(np.array(arrays[jkey], dtype=np.float32))
        if to_port is not None:
            t = to_port(t)
        if tuple(t.shape) != tuple(template[tkey].shape):
            raise ValueError('checkpoint leaf {} has shape {}, the model '
                             'expects {}'.format(jkey, tuple(t.shape),
                                                 tuple(template[tkey].shape)))
        sd[tkey] = t.contiguous()
    if missing:
        raise KeyError('missing state keys: {}'.format(missing))
    return sd


def state_dict_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """The port model's weights -> JAX checkpoint arrays (npz keys)."""
    sd = model.state_dict()
    out = {}
    for jkey, tkey, _, to_jax in _entries(model):
        t = sd[tkey].detach().cpu().float()
        if to_jax is not None:
            t = to_jax(t)
        out[jkey] = t.contiguous().numpy()
    return out
