"""Import a reference-trained job directory into a job of this package.

Port of ``joint_vae_tpu/save_load/import_reference.py``.  The reference
(moxime/joint-vae, PyTorch) persists a job as (ref cvae.py:2650-2675):

    params.json         architecture ctor kwargs
    train_params.json   training parameters (sigma/beta/optimizer/...)
    test.json           accuracy results   {epoch: {method: {...}}}
    ood.json            OOD results        {epoch: {set: {method: {...}}}}
    history.json        per-epoch training history
    state.pth           torch state_dict
    optimizer.pth       torch optimizer state (Adam's moments and step, or
                        SGD's momentum buffers)
    samples/<epoch>/record-<set>.pth   LossRecorder dumps
                        (ref utils/save_load/recorders.py:108-176)

``import_reference_job(src, dst)`` writes the JAX package's job schema
(``jobs.py``): the same JSON files, ``state.npz`` and ``optimizer.npz``
under the JAX package's keys and layouts, ``.jvr`` record files.  The
template is a fresh job of the same config built by ``load_job`` (on the
card unless ``device`` says otherwise); its arrays come from
``from_jax.py::state_dict_to_jax`` and ``opt_state_to_jax``, and the
mapped arrays replace them under the same keys.  So a job imported here
loads in both packages, and its files equal those of the JAX package's
importer on the same source, except the JAX package's sampling key
(``rng``), which the port does not keep (``jobs.py``), and the leaves
that the reference lacks, which keep each package's own fresh init.

Weight-mapping rules:

    torch Linear   (out, in)          -> kernel (in, out)        = W.T
    torch Conv2d   (O, I, kH, kW)     -> kernel (kH, kW, I, O)   OIHW->HWIO
    torch ConvT2d  (I, O, kH, kW)     -> kernel (kH, kW, I, O), HW-flipped
                                         (correlation-oriented, as the
                                         JAX package's conv kernels)
    BatchNorm weight/bias             -> scale/bias
    BatchNorm running_mean/var        -> batch_stats mean/var
    encoder.prior.mean                -> prior/mean
    encoder.prior._var_parameter      -> prior/var_param
    sigma (log-space iff learned)     -> sigma_param + sigma_state/data

Sequential indices on the torch side are positional (activations and
dropout interleave), so groups are walked by their weight-bearing entries
in index order and zipped against the layer names (conv_i/deconv_i/bn_i/
dense_i), which follow the same construction order.

torchvision resnet18-152 and densenet121-201 trunks (a reference
``--features resnet*`` job, ref module/vae_layers/conv.py:247-272) map
onto ``models/resnet.py``'s trunks one to one, their running statistics
included.  The compact densenet-small/-tiny and width-suffixed trunks
have no torchvision counterpart and are refused with the reason.
"""

import logging
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike
from .checkpoint import load_json, save_arrays, save_json
from .from_jax import opt_state_to_jax, state_dict_to_jax
from .jobs import load_job
from .recorders import LossRecorder, SampleRecorder, record_filename
from ..models.cvnet import CVNetConfig

_SEQ_KEY = re.compile(r'(\d+)\.(.+)\Z')


# -- torch checkpoint reading -------------------------------------------------

def _torch_load(path: str):
    """``torch.load`` on the CPU, unpickling objects (``weights_only``
    would refuse the reference's Sigma Parameter subclass); on a missing
    reference module, retried once with stubs in its place."""
    import torch
    try:
        return torch.load(path, map_location='cpu', weights_only=False)
    except (ModuleNotFoundError, AttributeError) as e:
        logging.debug('retrying %s with stub reference modules (%s)', path, e)
        _inject_reference_stubs()
        return torch.load(path, map_location='cpu', weights_only=False)


def _to_numpy(v):
    if hasattr(v, 'detach'):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _to_numpy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_numpy(x) for x in v)
    return v


def load_reference_state(path: str) -> Dict[str, np.ndarray]:
    """state.pth -> {name: ndarray}, in the file's key order.

    Plain tensors unpickle with stock torch; if the dump carries the
    reference's Sigma Parameter subclass, stub modules are injected so the
    reference package need not be importable.
    """
    return {k: (_to_numpy(v) if hasattr(v, 'detach') else np.asarray(v))
            for k, v in _torch_load(path).items()}


REFERENCE_STUBS = ('module', 'module.vae_layers', 'module.vae_layers.layers')


def _inject_reference_stubs():
    """Make `module.vae_layers.layers.Sigma` (and friends) unpicklable as
    plain Parameters without the reference package on the path.  The
    stubs answer no dunder name (``__file__``, ``__path__``...), which
    tools that walk ``sys.modules`` read, where the JAX package's stubs
    answer every name with the Parameter class."""
    import sys
    import types
    import torch

    class _AnyParameter(torch.nn.Parameter):
        def __init__(self, *a, **kw):                     # noqa: U100
            pass

    def stub_attr(attr):
        if attr.startswith('__'):
            raise AttributeError(attr)
        return _AnyParameter

    for name in REFERENCE_STUBS:
        if name in sys.modules:
            continue
        m = types.ModuleType(name)
        m.__getattr__ = stub_attr
        sys.modules[name] = m


# -- kernel orientation -------------------------------------------------------

def _linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))      # OIHW -> HWIO


def _deconv(w: np.ndarray) -> np.ndarray:
    # torch ConvTranspose2d (I, O, kH, kW) is the 180-degree flip of a
    # correlation-oriented kernel
    return np.ascontiguousarray(w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))


# -- state_dict structure helpers ---------------------------------------------

def _group(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    p = prefix + '.'
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def _seq_entries(group: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """Group `<idx>.<field>` keys by ascending Sequential index."""
    by_idx: Dict[int, Dict[str, np.ndarray]] = {}
    for k, v in group.items():
        m = _SEQ_KEY.match(k)
        if m:
            by_idx.setdefault(int(m.group(1)), {})[m.group(2)] = v
    return [by_idx[i] for i in sorted(by_idx)]


def _sorted_names(sub: Dict[str, Any], prefixes) -> List[str]:
    """Layer names with a numeric suffix, in construction order."""
    names = [n for n in sub
             if n.startswith(tuple(p + '_' for p in prefixes))]
    return sorted(names, key=lambda n: int(n.rsplit('_', 1)[1]))


def _nest(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """{'a/b/c': v} -> {'a': {'b': {'c': v}}} (the JAX package's param
    tree, which the mapping walks by name)."""
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split('/')
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _flatten(tree: Dict[str, Any], prefix: str = '') -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + '/'))
        else:
            out[prefix + k] = v
    return out


class ImportError_(RuntimeError):
    pass


# a torchvision trunk wrapped by ResOrDenseNetFeatures (nn.Sequential of
# model.children()[:-1], ref module/vae_layers/conv.py:247-272) keys resnet
# blocks as features.<layer_seq_idx>.<block>.conv1.weight
_RESNET_BLOCK = re.compile(r'^features\.(\d+)\.(\d+)\.(.+)$')


def _map_resnet_features(sd: Dict[str, np.ndarray], params,
                         out: Dict[str, np.ndarray],
                         stats: Dict[str, np.ndarray]):
    """torchvision resnet trunk -> ``models/resnet.py::ResNetFeatures``.

    Reference Sequential children: 0=conv1, 1=bn1, (2=relu, 3=maxpool),
    4..7=layer1..4 of BasicBlocks, 8=avgpool.  Ours: Conv_0/BatchNorm_0
    stem + _BasicBlock_k in the same construction order with
    conv1->Conv_0, bn1->BatchNorm_0, conv2->Conv_1, bn2->BatchNorm_1,
    downsample.(0,1)->(Conv_2, BatchNorm_2).

    Bottleneck blocks (resnet50/101/152) map conv1..3->Conv_0..2,
    bn1..3->BatchNorm_0..2, downsample.(0,1)->(Conv_3, BatchNorm_3)."""
    ours = params.get('features_stack')
    if ours is None:
        raise ImportError_('reference job carries a resnet trunk but the '
                           'rebuilt native model has no features_stack')
    path = 'features_stack'
    if 'features.0.weight' not in sd or 'features.1.running_mean' not in sd:
        raise ImportError_('resnet trunk: stem conv/bn keys missing')
    out['{}/Conv_0/kernel'.format(path)] = _conv(sd['features.0.weight'])
    out['{}/BatchNorm_0/scale'.format(path)] = sd['features.1.weight']
    out['{}/BatchNorm_0/bias'.format(path)] = sd['features.1.bias']
    stats['{}/BatchNorm_0/mean'.format(path)] = sd['features.1.running_mean']
    stats['{}/BatchNorm_0/var'.format(path)] = sd['features.1.running_var']

    blocks: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        m = _RESNET_BLOCK.match(k)
        if m:
            blocks.setdefault((int(m.group(1)), int(m.group(2))),
                              {})[m.group(3)] = v
    our_blocks = _sorted_names(ours, ('_BasicBlock', '_Bottleneck'))
    if len(blocks) != len(our_blocks):
        raise ImportError_('resnet trunk: {} torch blocks vs {} native'
                           .format(len(blocks), len(our_blocks)))
    basic_fields = (('conv1', 'Conv_0'), ('conv2', 'Conv_1'),
                    ('downsample.0', 'Conv_2'))
    basic_bns = (('bn1', 'BatchNorm_0'), ('bn2', 'BatchNorm_1'),
                 ('downsample.1', 'BatchNorm_2'))
    bott_fields = (('conv1', 'Conv_0'), ('conv2', 'Conv_1'),
                   ('conv3', 'Conv_2'), ('downsample.0', 'Conv_3'))
    bott_bns = (('bn1', 'BatchNorm_0'), ('bn2', 'BatchNorm_1'),
                ('bn3', 'BatchNorm_2'), ('downsample.1', 'BatchNorm_3'))
    for (key, name) in zip(sorted(blocks), our_blocks):
        entry = blocks[key]
        bpath = '{}/{}'.format(path, name)
        bott = 'conv3.weight' in entry
        if bott != name.startswith('_Bottleneck'):
            raise ImportError_('resnet trunk: block type mismatch at {} '
                               '(torch block {})'.format(name, key))
        field_map = bott_fields if bott else basic_fields
        bn_map = bott_bns if bott else basic_bns
        down_conv = 'Conv_3' if bott else 'Conv_2'
        has_down = down_conv in ours[name]
        if has_down != ('downsample.0.weight' in entry):
            raise ImportError_('resnet trunk: downsample mismatch at {} '
                               '(torch block {})'.format(name, key))
        # only the downsample pair is optional (its presence was just
        # checked against our block); anything else missing means a
        # truncated state_dict, refused rather than left at its fresh init
        for t, f in field_map:
            if t + '.weight' not in entry:
                if t.startswith('downsample'):
                    continue
                raise ImportError_('resnet trunk: torch block {} is '
                                   'missing {}.weight'.format(key, t))
            out['{}/{}/kernel'.format(bpath, f)] = _conv(entry[t + '.weight'])
        for t, f in bn_map:
            if t + '.weight' not in entry:
                if t.startswith('downsample'):
                    continue
                raise ImportError_('resnet trunk: torch block {} is '
                                   'missing {}.weight'.format(key, t))
            out['{}/{}/scale'.format(bpath, f)] = entry[t + '.weight']
            out['{}/{}/bias'.format(bpath, f)] = entry[t + '.bias']
            stats['{}/{}/mean'.format(bpath, f)] = entry[
                t + '.running_mean']
            stats['{}/{}/var'.format(bpath, f)] = entry[
                t + '.running_var']


# a torchvision densenet trunk wrapped by ResOrDenseNetFeatures has ONE
# Sequential child (the DenseNet's `features`), so keys come as
# features.0.denseblock<B>.denselayer<L>.<norm1|conv1|norm2|conv2>.<leaf>
_DENSE_SUB = re.compile(
    r'^denseblock(\d+)\.denselayer(\d+)\.(norm1|conv1|norm2|conv2)$')
_DENSE_TRANS = re.compile(r'^transition(\d+)\.')


def _map_densenet_features(sd: Dict[str, np.ndarray], params,
                           out: Dict[str, np.ndarray],
                           stats: Dict[str, np.ndarray]):
    """torchvision densenet trunk -> ``models/resnet.py::DenseNetFeatures``
    (the torchvision archs, ``DENSENET_TV``).

    Construction-order correspondence: conv0/norm0 -> Conv_0/BatchNorm_0
    stem, denseblockB.denselayerL.{norm1,conv1,norm2,conv2} ->
    _DenseLayer_k/{BatchNorm_0,Conv_0,BatchNorm_1,Conv_1} (k global over
    blocks), transitionT.{norm,conv} -> BatchNorm_T/Conv_T, norm5 ->
    BatchNorm_<T+1>.  The compact variants (densenet-small/-tiny,
    non-default growth) have no torchvision counterpart and refuse."""
    ours = params.get('features_stack')
    if ours is None:
        raise ImportError_('reference job carries a densenet trunk but the '
                           'rebuilt native model has no features_stack')
    path = 'features_stack'
    prefix = 'features.0.'
    mods: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        if k.startswith(prefix) and '.' in k[len(prefix):]:
            mod, leaf = k[len(prefix):].rsplit('.', 1)
            mods.setdefault(mod, {})[leaf] = v

    def leaf(entry, field, what):
        # a truncated or hand-edited trunk is refused with the reason
        if field not in entry:
            raise ImportError_('densenet trunk: {} missing its {} tensor'
                               .format(what, field))
        return entry[field]

    def bn(entry, name, what='a BN'):
        out['{}/{}/scale'.format(path, name)] = leaf(entry, 'weight', what)
        out['{}/{}/bias'.format(path, name)] = leaf(entry, 'bias', what)
        stats['{}/{}/mean'.format(path, name)] = leaf(
            entry, 'running_mean', what)
        stats['{}/{}/var'.format(path, name)] = leaf(
            entry, 'running_var', what)

    if 'conv0' not in mods or 'norm0' not in mods or 'norm5' not in mods:
        raise ImportError_(
            'densenet trunk: torchvision stem/norm5 keys missing — only '
            'torchvision densenet121/161/169/201 trunks import')
    out['{}/Conv_0/kernel'.format(path)] = _conv(
        leaf(mods['conv0'], 'weight', 'conv0'))
    bn(mods['norm0'], 'BatchNorm_0', 'norm0')

    layers: Dict[Tuple[int, int], Dict[str, Dict[str, np.ndarray]]] = {}
    for name, entry in mods.items():
        m = _DENSE_SUB.match(name)
        if m:
            layers.setdefault((int(m.group(1)), int(m.group(2))),
                              {})[m.group(3)] = entry
    our_layers = _sorted_names(ours, ('_DenseLayer',))
    if len(layers) != len(our_layers):
        raise ImportError_('densenet trunk: {} torch denselayers vs {} '
                           'native (arch or growth mismatch)'
                           .format(len(layers), len(our_layers)))
    for key, lname in zip(sorted(layers), our_layers):
        sub = layers[key]
        what = 'denseblock{}.denselayer{}'.format(*key)
        for t, f in (('conv1', 'Conv_0'), ('conv2', 'Conv_1')):
            out['{}/{}/{}/kernel'.format(path, lname, f)] = _conv(
                leaf(sub.get(t, {}), 'weight', '{}.{}'.format(what, t)))
        for t, f in (('norm1', 'BatchNorm_0'), ('norm2', 'BatchNorm_1')):
            bn(sub.get(t, {}), '{}/{}'.format(lname, f),
               '{}.{}'.format(what, t))

    trans = sorted({int(m.group(1)) for name in mods
                    for m in [_DENSE_TRANS.match(name)] if m})
    for t in trans:
        bn(mods.get('transition{}.norm'.format(t), {}),
           'BatchNorm_{}'.format(t), 'transition{}.norm'.format(t))
        out['{}/Conv_{}/kernel'.format(path, t)] = _conv(
            leaf(mods.get('transition{}.conv'.format(t), {}), 'weight',
                 'transition{}.conv'.format(t)))
    bn(mods['norm5'], 'BatchNorm_{}'.format(len(trans) + 1), 'norm5')


def _map_conv_group(ref_entries: List[Dict[str, np.ndarray]],
                    ours: Dict[str, Any], out: Dict[str, np.ndarray],
                    stats: Dict[str, np.ndarray], path: str):
    """Zip a torch (de)conv Sequential against a ConvStack's subtree."""
    weight_names = _sorted_names(ours, ('conv', 'deconv'))
    dense_names = ['dense'] if 'dense' in ours else []
    bn_names = _sorted_names(ours, ('bn',))
    wi = bi = di = 0
    for entry in ref_entries:
        if 'running_mean' in entry:
            if bi >= len(bn_names):
                raise ImportError_('{}: more torch BatchNorms than ours'
                                   .format(path))
            n = bn_names[bi]
            out['{}/{}/scale'.format(path, n)] = entry['weight']
            out['{}/{}/bias'.format(path, n)] = entry['bias']
            stats['{}/{}/mean'.format(path, n)] = entry['running_mean']
            stats['{}/{}/var'.format(path, n)] = entry['running_var']
            bi += 1
        elif 'weight' in entry and entry['weight'].ndim == 4:
            if wi >= len(weight_names):
                raise ImportError_('{}: more torch convs than ours'
                                   .format(path))
            n = weight_names[wi]
            conv = _conv if n.startswith('conv') else _deconv
            out['{}/{}/kernel'.format(path, n)] = conv(entry['weight'])
            if 'bias' in entry:
                out['{}/{}/bias'.format(path, n)] = entry['bias']
            wi += 1
        elif 'weight' in entry and entry['weight'].ndim == 2:
            if di >= len(dense_names):
                raise ImportError_('{}: unexpected torch Linear'.format(path))
            out['{}/dense/kernel'.format(path)] = _linear(entry['weight'])
            out['{}/dense/bias'.format(path)] = entry['bias']
            di += 1
    # every layer must be fed: a partial map would leave fresh-init
    # leaves behind, so it is refused
    for got, want, kind in ((wi, len(weight_names), 'conv'),
                            (bi, len(bn_names), 'batch-norm'),
                            (di, len(dense_names), 'dense')):
        if got != want:
            raise ImportError_('{}: mapped {}/{} {} layers'.format(
                path, got, want, kind))


def _map_dense_seq(ref_entries: List[Dict[str, np.ndarray]],
                   names: List[str], out: Dict[str, np.ndarray], path: str):
    linears = [e for e in ref_entries if e.get('weight') is not None
               and e['weight'].ndim == 2]
    if len(linears) != len(names):
        raise ImportError_('{}: {} torch Linears vs {} of ours'.format(
            path, len(linears), len(names)))
    for e, n in zip(linears, names):
        out['{}/{}/kernel'.format(path, n)] = _linear(e['weight'])
        out['{}/{}/bias'.format(path, n)] = e['bias']


def map_reference_state(sd: Dict[str, np.ndarray], params,
                        batch_stats) -> Tuple[Dict[str, np.ndarray],
                                              Dict[str, np.ndarray],
                                              Optional[np.ndarray]]:
    """Reference state_dict -> (flat param updates, flat batch_stat updates,
    sigma data or None), keyed by the paths of the nested ``params`` and
    ``batch_stats`` trees (the JAX package's names).  Raises ImportError_
    on a structural mismatch."""
    out: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}

    resnet_trunk = any(_RESNET_BLOCK.match(k) and k.endswith('conv1.weight')
                       for k in sd)
    densenet_trunk = any('denseblock' in k or 'norm5' in k for k in sd)
    if resnet_trunk:
        _map_resnet_features(sd, params, out, stats)
    elif densenet_trunk:
        _map_densenet_features(sd, params, out, stats)

    # features / imager conv stacks
    for ref_name, our_name in ((('features', 'features_stack'),)
                               if not (resnet_trunk or densenet_trunk)
                               else ()) + (
                               ('imager', 'imager'),):
        g = _group(sd, ref_name)
        if not g or our_name not in params:
            continue
        entries = _seq_entries(g)
        if (our_name == 'imager' and len(entries) == 1
                and entries[0]['weight'].ndim == 2):
            # featureless MLP imager: a single Linear (ref cvae.py imager)
            out['imager/dense/kernel'] = _linear(entries[0]['weight'])
            out['imager/dense/bias'] = entries[0]['bias']
        else:
            _map_conv_group(entries, params[our_name], out, stats, our_name)

    # encoder MLP + heads + prior
    enc = _group(sd, 'encoder')
    if enc:
        # Sequential and ModuleList spellings both key `dense_projs.<i>.*`
        projs = _seq_entries(_group(enc, 'dense_projs'))
        our_projs = params.get('encoder', {}).get('dense_projs', {})
        _map_dense_seq(projs, _sorted_names(our_projs, ('dense',)), out,
                       'encoder/dense_projs')
        our_enc = params.get('encoder', {})
        for head in ('dense_mean', 'dense_log_var'):
            if head + '.weight' in enc:
                if head not in our_enc:
                    # the reference builds dense_log_var even under forced
                    # variance, where forward never reads it (ref
                    # layers.py:390-391): vestigial, skipped
                    logging.debug('encoder.%s has no native counterpart '
                                  '(vestigial head), skipped', head)
                    continue
                out['encoder/{}/kernel'.format(head)] = _linear(
                    enc[head + '.weight'])
                out['encoder/{}/bias'.format(head)] = enc[head + '.bias']
        if 'sigma.weight' in enc and 'sigma' in our_enc:  # coded-sigma head
            out['encoder/sigma/kernel'] = _linear(enc['sigma.weight'])
            out['encoder/sigma/bias'] = enc['sigma.bias']
        if 'prior.mean' in enc:
            out['prior/mean'] = enc['prior.mean']
        if 'prior._var_parameter' in enc:
            out['prior/var_param'] = enc['prior._var_parameter']

    # decoder MLP
    dec = _seq_entries(_group(sd, 'decoder'))
    if dec and 'decoder' in params:
        _map_dense_seq(dec, _sorted_names(params['decoder'], ('dense',)),
                       out, 'decoder')

    # classifier MLP + head (vestigial heads differ in shape: skip leniently)
    clf = _seq_entries(_group(sd, 'classifier'))
    if clf and 'classifier' in params:
        linears = [e for e in clf if e['weight'].ndim == 2]
        names = _sorted_names(params['classifier'], ('dense',))
        if 'head' in params['classifier'] and len(linears) == len(names) + 1:
            _map_dense_seq(linears[:-1], names, out, 'classifier')
            out['classifier/head/kernel'] = _linear(linears[-1]['weight'])
            out['classifier/head/bias'] = linears[-1]['bias']
        else:
            logging.warning('classifier not imported (vestigial head: '
                            '%d torch Linears vs %s ours)',
                            len(linears), names)

    sigma = sd.get('sigma')
    if sigma is not None and 'sigma_param' in params:
        out['sigma_param'] = sigma

    # every mapped leaf's shape against the fresh tree
    flat = _flatten(params)
    for k, v in out.items():
        if k not in flat:
            raise ImportError_('mapped key {} absent from our tree'.format(k))
        if tuple(flat[k].shape) != tuple(v.shape):
            raise ImportError_('shape mismatch at {}: ref {} vs ours {}'
                               .format(k, v.shape, flat[k].shape))
    if batch_stats is not None:
        flat_bs = _flatten(batch_stats)
        for k, v in stats.items():
            if k not in flat_bs or tuple(flat_bs[k].shape) != tuple(v.shape):
                raise ImportError_('batch-stat mismatch at {}'.format(k))

    return out, stats, sigma


# -- optimizer state ----------------------------------------------------------

_BUFFER_SUFFIXES = ('running_mean', 'running_var', 'num_batches_tracked')
_MOMENT_KEY = re.compile(r'^(.*/)(mu|nu|trace)/')


def load_reference_optimizer(path: str) -> Dict[str, Any]:
    """optimizer.pth -> torch Optimizer.state_dict() with tensors as
    ndarrays ({'state': {idx: {field: array}}, 'param_groups': [...]})."""
    return _to_numpy(_torch_load(path))


def map_reference_optimizer(opt_sd: Dict[str, Any], sd: Dict[str, np.ndarray],
                            params, batch_stats,
                            opt_template: Dict[str, np.ndarray]
                            ) -> Optional[Dict[str, np.ndarray]]:
    """torch optimizer state -> optimizer.npz arrays (moments transplanted).

    torch keys optimizer state by parameter *index* into the iterable the
    optimizer was built from; the reference passes ``self.parameters()``
    unfiltered (ref cvae.py:399), whose order is the state_dict order
    restricted to parameters (buffers excluded).  Each moment tensor is
    elementwise-aligned with its parameter, so the weight-mapping
    transposes apply: a pseudo-state_dict per moment field goes through
    :func:`map_reference_state`.

    ``opt_template``: a fresh optimizer's arrays under the JAX package's
    keys (``from_jax.py::opt_state_to_jax``).  Returns them with Adam's
    ``mu``/``nu``/``count`` or SGD's ``trace`` replaced (a moment the
    reference lacks is zero), or None when there is nothing to import (a
    fresh optimizer, SGD without momentum)."""
    torch_state = {int(k): v for k, v in (opt_sd.get('state') or {}).items()}
    if not torch_state:
        return None
    idx_order = [i for g in (opt_sd.get('param_groups') or [])
                 for i in g.get('params', [])]
    pnames = [k for k in sd if not k.endswith(_BUFFER_SUFFIXES)]
    if len(idx_order) != len(pnames):
        raise ImportError_(
            'optimizer tracks {} params vs {} state_dict parameters'
            .format(len(idx_order), len(pnames)))
    name_of = dict(zip(idx_order, pnames))

    sample = next(iter(torch_state.values()))
    fields = [f for f in ('exp_avg', 'exp_avg_sq', 'momentum_buffer')
              if f in sample]
    if 'max_exp_avg_sq' in sample:
        logging.warning('amsgrad max_exp_avg_sq not imported '
                        '(our adam chain has no amsgrad)')
    if not fields:
        return None

    flat_params = _flatten(params)

    def _moments(field):
        pseudo = dict(sd)            # buffers keep real values (grouping cue)
        for i, name in name_of.items():
            st = torch_state.get(i)
            v = st.get(field) if st else None
            pseudo[name] = (np.asarray(v, np.float32) if v is not None
                            else np.zeros_like(sd[name], dtype=np.float32))
        flat_m, _, _ = map_reference_state(pseudo, params, batch_stats)
        full = {k: np.zeros(np.shape(v), np.float32)
                for k, v in flat_params.items()}
        full.update({k: np.asarray(v, np.float32)
                     for k, v in flat_m.items()})
        return full

    moments = {f: _moments(f) for f in fields}
    steps = [int(np.asarray(st['step']).item())
             for st in torch_state.values() if 'step' in st]
    count = np.asarray(max(steps) if steps else 0, np.int32)

    out = dict(opt_template)
    kinds = {}
    for k in out:
        m = _MOMENT_KEY.match(k)
        if m:
            kinds.setdefault(m.group(2), m.group(1))
    graft = []
    if 'mu' in kinds and 'exp_avg' in moments:         # scale_by_adam
        inner = kinds['mu']
        out[inner + 'count'] = count
        graft += [(inner + 'mu/', moments['exp_avg']),
                  (inner + 'nu/', moments['exp_avg_sq'])]
    if 'trace' in kinds and 'momentum_buffer' in moments:   # trace
        graft.append((kinds['trace'] + 'trace/', moments['momentum_buffer']))
    for prefix, full in graft:
        for path, v in full.items():
            out[prefix + path] = v
    return out


# -- recorders ----------------------------------------------------------------

def import_recorder(pth_path: str, dst_path: str):
    """record-<set>.pth (torch.save of LossRecorder.__dict__,
    ref recorders.py:108-138) -> .jvr/.npz record file."""
    import torch
    d = torch.load(pth_path, map_location='cpu', weights_only=False)
    tensors = {k: v.detach().cpu().numpy() for k, v in d['_tensors'].items()}
    batch_size = int(d['batch_size'])
    num_batch = int(d.get('_num_batch', 0))
    recorded = int(d.get('_recorded_batches', num_batch))
    rec = LossRecorder(batch_size)
    rec._tensors = tensors
    rec._num_batch = num_batch
    rec._recorded_batches = recorded
    rec.last_batch_size = int(d.get('last_batch_size', batch_size))
    seed = d.get('_seed')
    if seed is not None:
        rec._seed = int(seed)
    rec.save(dst_path)


def import_sample_recorder(pth_path: str, dst_path: str):
    """samples-<set>.pth (torch.save of SampleRecorder.__dict__, sample
    axis 0, ref recorders.py:372-399) -> sample-<set>.npz; aux entries
    (prior centroids etc.) become plain keys of the flat store."""
    import torch
    d = torch.load(pth_path, map_location='cpu', weights_only=False)
    rec = SampleRecorder()
    for src in (d.get('_tensors') or {}), (d.get('_aux') or {}):
        for k, v in src.items():
            rec.append_batch(**{k: v.detach().cpu().numpy()
                                if hasattr(v, 'detach') else np.asarray(v)})
    rec.save(dst_path)


# -- the importer -------------------------------------------------------------

def _store(template: Dict[str, np.ndarray], key: str, v) -> np.ndarray:
    return np.array(v, dtype=template[key].dtype, order='C')


def import_reference_job(src: str, dst: str,
                         job_number: Optional[int] = None,
                         import_recorders: bool = True,
                         device: DeviceLike = None) -> str:
    """Convert a reference job directory into a job under ``dst``; the
    template model is built on ``device`` (the card unless the caller asks
    for the CPU).

    Returns the destination directory.  The import is rejected (with the
    reason) rather than silently wrong when the architecture cannot be
    reproduced.
    """
    params_path = os.path.join(src, 'params.json')
    if not os.path.exists(params_path):
        raise FileNotFoundError('{} is not a job dir (no params.json)'
                                .format(src))
    arch = load_json(params_path)
    arch.pop('version', None)
    job_no = arch.pop('job_number', None)
    if job_number is None:
        if isinstance(job_no, int):
            job_number = job_no
        else:
            # the reference falls back to the directory name (cvae.py:2705)
            base = os.path.basename(os.path.abspath(src).rstrip(os.sep))
            job_number = int(base) if base.isdigit() else 0

    tp_path = os.path.join(src, 'train_params.json')
    training_parameters = load_json(tp_path) if os.path.exists(tp_path) else {}

    # shape-affecting training params merge before construction (load_job)
    merged = dict(arch)
    for k in ('beta', 'gamma', 'latent_sampling', 'sigma'):
        if training_parameters.get(k) is not None:
            merged[k] = training_parameters[k]
    cfg = CVNetConfig.from_dict(merged)

    os.makedirs(dst, exist_ok=True)
    save_json(dict(cfg.architecture, job_number=job_number),
              os.path.join(dst, 'params.json'))
    training_parameters.setdefault('from_reference', os.path.abspath(src))
    # reference ft jobs keep their params in a sidecar json (wim.json /
    # poscod.json, ref ft/wim.py:18, ft/poscod.py:23); here they live in
    # train_params['wim'/'poscod'], merged, the reference's values winning
    for ft_file, tp_key in (('wim.json', 'wim'), ('poscod.json', 'poscod')):
        p = os.path.join(src, ft_file)
        if os.path.exists(p):
            merged_ft = dict(training_parameters.get(tp_key) or {})
            merged_ft.update(load_json(p))
            training_parameters[tp_key] = merged_ft
    save_json(training_parameters, os.path.join(dst, 'train_params.json'))
    for name in ('test.json', 'ood.json', 'history.json'):
        p = os.path.join(src, name)
        if os.path.exists(p):
            save_json(load_json(p), os.path.join(dst, name))

    epochs = 0
    hist = os.path.join(src, 'history.json')
    if os.path.exists(hist):
        epochs = int(load_json(hist).get('epochs', 0) or 0)

    state_path = os.path.join(src, 'state.pth')
    if os.path.exists(state_path):
        # a fresh job of the same config supplies the template arrays
        job = load_job(dst, device=device, load_state=False)
        template = state_dict_to_jax(job.model)
        params = _nest({k[len('params/'):]: v for k, v in template.items()
                        if k.startswith('params/')})
        bs = _nest({k[len('batch_stats/'):]: v for k, v in template.items()
                    if k.startswith('batch_stats/')}) or None
        sd = load_reference_state(state_path)
        mapped, stats, sigma = map_reference_state(sd, params, bs)
        arrays = dict(template)
        for prefix, upd in (('params/', mapped), ('batch_stats/', stats)):
            for k, v in upd.items():
                arrays[prefix + k] = _store(template, prefix + k, v)
        sigma_state = job.sigma_state
        arrays['sigma_state/data'] = (
            sigma_state.data.detach().cpu().numpy() if sigma is None
            else np.asarray(sigma, np.float32))
        arrays['sigma_state/rmse'] = sigma_state.rmse.detach().cpu().numpy()
        arrays['counters/epoch'] = np.asarray(epochs, np.int32)
        arrays['counters/step'] = np.asarray(0, np.int32)
        save_arrays(os.path.join(dst, 'state.npz'), arrays)
        logging.info('state.pth imported: %d tensors mapped onto %s',
                     len(mapped), dst)

        # WIM alternate prior: the reference registers it as a module, so
        # its (frozen, torch-seeded) arrays ride in state.pth; imported so
        # that '@' scores use the prior the job was tuned against
        # (ft/job.py::load_wim_job reads wim_prior.npz)
        alt = {our: sd.get('_alternate_prior.' + ref)
               for ref, our in (('mean', 'mean'),
                                ('_var_parameter', 'var_param'))}
        if all(v is not None for v in alt.values()):
            np.savez(os.path.join(dst, 'wim_prior.npz'),
                     **{k: np.asarray(v, np.float32)
                        for k, v in alt.items()})
            logging.info('alternate WIM prior imported from state.pth')

        # poscod llr head: Dropout+Linear(K->1) at ood_head.1.*
        # (ref ft/poscod.py:38-42) -> the {'w': (K,), 'b': ()} head
        hw, hb = sd.get('ood_head.1.weight'), sd.get('ood_head.1.bias')
        if hw is not None and hb is not None:
            np.savez(os.path.join(dst, 'poscod_head.npz'),
                     w=np.asarray(hw, np.float32).reshape(-1),
                     b=np.asarray(hb, np.float32).reshape(()))
            logging.info('poscod llr head imported from state.pth')

        opt_path = os.path.join(src, 'optimizer.pth')
        if os.path.exists(opt_path):
            try:
                opt_arrays = map_reference_optimizer(
                    load_reference_optimizer(opt_path), sd, params, bs,
                    opt_state_to_jax(job.model, job.opt_cfg,
                                     job.state.opt_state))
            except ImportError_ as e:
                logging.warning('optimizer.pth not imported (%s): moments '
                                'restart at zero on resume', e)
            else:
                if opt_arrays is not None:
                    save_arrays(os.path.join(dst, 'optimizer.npz'),
                                opt_arrays)
                    logging.info('optimizer.pth imported: adam moments '
                                 'continue on resume')
    elif os.path.exists(os.path.join(src, 'optimizer.pth')):
        logging.warning('optimizer.pth not imported (no state.pth): '
                        'moments restart at zero on resume')

    if import_recorders:
        _import_sample_dirs(src, dst, epochs)

    for sentinel in ('deleted', 'derailed', 'RESUMED'):
        p = os.path.join(src, sentinel)
        if os.path.exists(p):
            shutil.copy(p, os.path.join(dst, sentinel))
    return dst


def _import_sample_dirs(src: str, dst: str, epochs: int):
    """``epochs`` is the trained-epoch count parsed from history.json by
    :func:`import_reference_job`.

    Destination epoch dirs are zero-padded ``{:04d}``, the layout every
    consumer resolves (engines, dictify, ft); the reference writes bare
    ints (ref cvae.py sample dirs).
    """
    samples = os.path.join(src, 'samples')
    if not os.path.isdir(samples):
        return
    for sub in sorted(os.listdir(samples)):
        sub_path = os.path.join(samples, sub)
        if not os.path.isdir(sub_path):
            continue
        if sub == 'last':
            # 'last' holds the newest epoch's records; mapped onto the
            # trained-epoch number unless that epoch dir exists in src
            if os.path.isdir(os.path.join(samples, str(epochs))) \
                    or os.path.isdir(os.path.join(
                        samples, '{:04d}'.format(epochs))):
                continue
            sub_out = '{:04d}'.format(epochs)
        elif sub.isdigit():
            sub_out = '{:04d}'.format(int(sub))
        else:
            sub_out = sub
        out_dir = os.path.join(dst, 'samples', sub_out)
        _import_record_files(sub_path, out_dir)
        # one nesting level: WIM pre-tuning snapshots live under
        # samples/<epoch>/init/ (ref ft/job.py:302-313)
        for nested in sorted(os.listdir(sub_path)):
            nested_path = os.path.join(sub_path, nested)
            if os.path.isdir(nested_path):
                _import_record_files(nested_path,
                                     os.path.join(out_dir, nested))


def _import_record_files(src_dir: str, out_dir: str):
    for f in sorted(os.listdir(src_dir)):
        m = re.match(r'record-(?P<set>.+)\.pth\Z', f)
        if m:
            dst_file = os.path.join(out_dir, record_filename(m.group('set')))
            try:
                import_recorder(os.path.join(src_dir, f), dst_file)
            except Exception as e:
                logging.warning('recorder %s not imported: %s', f, e)
            continue
        m = re.match(r'samples-(?P<set>.+)\.pth\Z', f)
        if m:
            dst_file = os.path.join(out_dir,
                                    'sample-{}.npz'.format(m.group('set')))
            try:
                import_sample_recorder(os.path.join(src_dir, f), dst_file)
            except Exception as e:
                logging.warning('sample recorder %s not imported: %s', f, e)
