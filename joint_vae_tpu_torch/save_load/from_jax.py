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
