"""Export a job directory of this package into a reference-loadable job.

Port of ``joint_vae_tpu/save_load/export_reference.py``, the inverse of
``import_reference.py``: a job (``jobs.py``, written by either package)
becomes a directory that moxime/joint-vae's own ``CVNet.load`` consumes
(ref cvae.py:2677-2857) —

    params.json         sanitized against the reference ctor signature
    train_params.json   filtered to the keys its load() tolerates
                        (ref cvae.py:2788-2801 keys_out + ctor kwargs)
    test.json / ood.json / history.json   as they are (same schemas)
    state.pth           torch state_dict (weights mapped back, see below)
    optimizer.pth       torch optimizer state (Adam's moments and step, or
                        SGD's momentum buffers, so a reference resume
                        continues them)
    samples/<epoch>/record-<set>.pth     reference LossRecorder dumps
                        (written by the reference's own save,
                        ref utils/save_load/recorders.py:107-138)

The reference package must be importable (it defines the torch
checkpoint format): pass ``reference_path`` or set ``JVT_REFERENCE``.
The exporter builds the reference network from the exported JSONs with
the reference's own ``load(dir, load_state=False)`` — so an export that
succeeds proves that the JSONs rebuild on its side — and takes its
``state_dict()`` as the template of keys and shapes.

The weights: the job's arrays under the JAX package's keys
(``from_jax.py::state_dict_to_jax``) and its sigma state.  The template
is re-keyed with integer tags and pushed through this package's
``import_reference.map_reference_state``, which gives the exact (reference
key <-> JAX key) correspondence the importer applies; each array is then
written back through the inverse of the importer's transpose for its kind
(Linear W.T, conv HWIO->OIHW, deconv flip+transpose, identities for
BatchNorm, prior and sigma).  So export inverts import bit for bit; the
moments come the same way from ``opt_state_to_jax``.  The files equal
those of the JAX package's exporter on the same job and checkout.

Not exportable (a clear error, before the checkout is touched): the
compact trunks (densenet-small/-tiny, width- or growth-suffixed names),
which have no torchvision counterpart.  torchvision's resnet18-152 and
densenet121-201 export; a stock checkout routes only ``resnet*`` to its
trunk class, which ``tv_resnet.route_densenet`` repairs in-process.
"""

import inspect
import logging
import os
import re
import shutil
import sys
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike
from .checkpoint import load_json, save_json
from .from_jax import opt_state_to_jax, state_dict_to_jax
from .import_reference import (REFERENCE_STUBS, ImportError_, _BUFFER_SUFFIXES,
                               _nest, map_reference_state)
from .jobs import _has_checkpoint, load_job
from .recorders import LossRecorder, SampleRecorder

#: train_params.json keys the reference's load() pops before calling the
#: ctor (ref cvae.py:2788-2801); everything else must be a ctor kwarg.
REF_TRAIN_KEYS_OUT = frozenset((
    'set', 'epochs', 'data_augmentation', 'batch_size', 'fine_tuning',
    'warmup', 'warmup_gamma', 'full_test_every', 'validation_split_seed',
    'max_batch_sizes', 'pretrained_features', 'pretrained_upsampler',
    'transformer', 'validation'))

_MOMENT_KEY = re.compile(r'^(.*/)(mu|nu|trace)/(.+)$')


class ExportError_(RuntimeError):
    pass


# -- reference package loading ------------------------------------------------

def default_reference_path() -> Optional[str]:
    """``$JVT_REFERENCE``, the path of a moxime/joint-vae checkout."""
    return os.environ.get('JVT_REFERENCE') or None


def _stub_torchvision():
    """Satisfy the reference's torchvision imports when the real package
    is absent: resnet18-152 and densenet121-201 get the faithful modules
    of ``tv_resnet.py``, so that trunk templates build; any other name
    is a dummy."""
    if 'torchvision' not in sys.modules:
        try:
            import torchvision                           # noqa: F401
        except ImportError:
            class _Dummy:
                def __init__(self, *a, **k):
                    pass

            def _ga(name):
                if name.startswith('__'):
                    raise AttributeError(name)
                return _Dummy

            tv = types.ModuleType('torchvision')
            for sub in ('models', 'transforms', 'datasets', 'utils'):
                m = types.ModuleType('torchvision.' + sub)
                m.__getattr__ = _ga
                setattr(tv, sub, m)
                sys.modules['torchvision.' + sub] = m
            tv.utils.save_image = lambda *a, **k: None
            tv.__path__ = []
            sys.modules['torchvision'] = tv
    from . import tv_resnet
    tv_resnet.install()


def _drop_importer_stubs():
    """Drop the importers' stub modules (plain modules answering
    attributes through ``__getattr__``, put in place to unpickle the
    reference's Sigma without a checkout): they would shadow the
    checkout's ``module`` package, and ``import cvae`` would fail."""
    for name in REFERENCE_STUBS:
        m = sys.modules.get(name)
        if type(m) is types.ModuleType and '__getattr__' in vars(m):
            del sys.modules[name]


_REF_CACHE: Dict[str, Tuple[Any, Any]] = {}


def reference_modules(reference_path: Optional[str] = None):
    """(RefNet class, reference recorders module) from the reference tree."""
    path = reference_path or default_reference_path()
    if not path:
        raise ExportError_(
            'the reference package is required to write its torch formats: '
            'pass reference_path or set JVT_REFERENCE')
    path = os.path.abspath(path)
    if path in _REF_CACHE:
        return _REF_CACHE[path]
    _stub_torchvision()
    _drop_importer_stubs()
    sys.path.insert(0, path)
    try:
        import cvae as ref_cvae
        from utils.save_load import recorders as ref_recorders
    finally:
        sys.path.remove(path)
    from .tv_resnet import route_densenet
    route_densenet(ref_cvae)
    pair = (ref_cvae.ClassificationVariationalNetwork, ref_recorders)
    _REF_CACHE[path] = pair
    return pair


# -- JSON sanitization --------------------------------------------------------

def _ctor_params(ref_net_cls) -> frozenset:
    sig = inspect.signature(ref_net_cls.__init__)
    return frozenset(p for p, v in sig.parameters.items()
                     if p != 'self'
                     and v.kind not in (v.VAR_POSITIONAL, v.VAR_KEYWORD))


def export_architecture(arch: Dict[str, Any], ref_net_cls) -> Dict[str, Any]:
    """params.json -> reference-ctor-safe params.json."""
    allowed = _ctor_params(ref_net_cls) | {'job_number', 'version'}
    out = {k: v for k, v in arch.items() if k in allowed}
    dropped = sorted(set(arch) - set(out))
    if dropped:
        logging.warning('params.json keys not in the reference ctor, '
                        'dropped on export: %s', ', '.join(dropped))
    return out


def export_train_params(tp: Dict[str, Any], ref_net_cls) -> Dict[str, Any]:
    """train_params.json -> keys the reference load() tolerates."""
    allowed = _ctor_params(ref_net_cls)
    out = {k: v for k, v in tp.items()
           if k in REF_TRAIN_KEYS_OUT or k.startswith('early-')
           or k in allowed}
    dropped = sorted(set(tp) - set(out))
    if dropped:
        logging.warning('train_params.json keys the reference load() would '
                        'reject, dropped on export: %s', ', '.join(dropped))
    return out


# -- weight mapping -----------------------------------------------------------

def _inv_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _inv_conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _inv_deconv(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w).transpose(2, 3, 0, 1)          # (kH,kW,I,O)->(I,O,kH,kW)
    return np.ascontiguousarray(w[:, :, ::-1, ::-1])


def _inverse_transform(our_key: str, value: np.ndarray) -> np.ndarray:
    """Invert the importer's per-kind transpose (``import_reference.py``)."""
    v = np.asarray(value)
    if our_key.endswith('/kernel'):
        if v.ndim == 4:
            layer = our_key.split('/')[-2]
            return (_inv_deconv if layer.startswith('deconv')
                    else _inv_conv)(v)
        return _inv_linear(v)
    # not ascontiguousarray: it makes a 0-d array (a scalar var_param) (1,)
    return v


def _job_trees(job) -> Tuple[Dict[str, np.ndarray], Dict[str, Any], Any]:
    """(the job's arrays under the JAX package's checkpoint keys, the
    nested params tree, the nested batch_stats tree or None)."""
    arrays = state_dict_to_jax(job.model)
    params = _nest({k[len('params/'):]: v for k, v in arrays.items()
                    if k.startswith('params/')})
    bs = _nest({k[len('batch_stats/'):]: v for k, v in arrays.items()
                if k.startswith('batch_stats/')}) or None
    return arrays, params, bs


def state_correspondence(template_sd: Dict[str, np.ndarray], params,
                         batch_stats) -> Dict[str, str]:
    """{reference key: JAX checkpoint key} derived by running the importer
    on a tagged copy of the reference template (so export inverts import
    exactly)."""
    keys = list(template_sd)
    tagged = {k: np.full(np.shape(template_sd[k]), i, np.float32)
              for i, k in enumerate(keys)}
    mapped, stats, sigma = map_reference_state(tagged, params, batch_stats)

    corr: Dict[str, str] = {}

    def _claim(our_key, arr):
        arr = np.asarray(arr)
        tag = int(round(float(arr.reshape(-1)[0]))) if arr.size else -1
        if 0 <= tag < len(keys):
            corr[keys[tag]] = our_key

    # later claims win, and the params/ spelling must win over the bare
    # sigma one (a learned sigma is both the 'sigma' state and the
    # sigma_param parameter; the optimizer export needs the params/ key)
    if sigma is not None:
        _claim('sigma', sigma)
    for our_key, arr in stats.items():
        _claim('batch_stats/' + our_key, arr)
    for our_key, arr in mapped.items():
        _claim('params/' + our_key, arr)
    return corr


def export_state_dict(job, template_sd) -> Tuple[Dict[str, Any], List[str]]:
    """The job's weights -> torch state_dict tensors.

    Returns (state_dict of torch tensors, reference parameter keys left at
    their fresh-init template values)."""
    import torch

    np_template = {k: v.detach().cpu().numpy() for k, v in template_sd.items()}
    flat, params, bs = _job_trees(job)
    corr = state_correspondence(np_template, params, bs)
    flat['sigma'] = job.sigma_state.data.detach().cpu().numpy()

    out, missing = {}, []
    for ref_key, tmpl in np_template.items():
        our_key = corr.get(ref_key)
        if our_key is None:
            out[ref_key] = torch.as_tensor(tmpl)
            if not ref_key.endswith('num_batches_tracked'):
                missing.append(ref_key)
            continue
        v = _inverse_transform(our_key.split('/', 1)[-1], flat[our_key])
        if tuple(v.shape) != tuple(np.shape(tmpl)):
            raise ExportError_('shape mismatch exporting {} from {}: '
                               '{} vs template {}'.format(
                                   ref_key, our_key, v.shape,
                                   np.shape(tmpl)))
        out[ref_key] = torch.as_tensor(np.array(v, dtype=tmpl.dtype))
    if missing:
        logging.warning('reference parameters kept at fresh-init values '
                        '(no native counterpart): %s', ', '.join(missing))
    return out, missing


# -- optimizer state ----------------------------------------------------------

def _find_moments(job) -> Dict[str, Any]:
    """Adam's mu/nu (as exp_avg/exp_avg_sq) and count, or SGD's trace
    (momentum_buffer), each {param path: array}, from the optimizer's
    arrays under the JAX package's keys (``from_jax.py``)."""
    names = {'mu': 'exp_avg', 'nu': 'exp_avg_sq', 'trace': 'momentum_buffer'}
    found: Dict[str, Any] = {}
    arrays = opt_state_to_jax(job.model, job.opt_cfg, job.state.opt_state)
    for k, v in arrays.items():
        m = _MOMENT_KEY.match(k)
        if m:
            found.setdefault(names[m.group(2)], {})[m.group(3)] = v
            if m.group(2) == 'mu':
                found['count'] = int(np.asarray(arrays[m.group(1) + 'count']))
    return found


def export_optimizer_state(job, ref_model,
                           state_dict) -> Optional[Dict[str, Any]]:
    """The job's optimizer state -> torch Optimizer.state_dict(), or None
    when there are no moments to carry (fresh Adam, stateless SGD).

    torch keys optimizer state by parameter index into ``parameters()``
    (state_dict order restricted to parameters: the rule
    ``import_reference.map_reference_optimizer`` inverts)."""
    import torch

    moments = _find_moments(job)
    fields = [f for f in ('exp_avg', 'exp_avg_sq', 'momentum_buffer')
              if f in moments]
    if not fields or moments.get('count') == 0:
        return None

    np_template = {k: v.detach().cpu().numpy()
                   for k, v in state_dict.items()}
    _, params, bs = _job_trees(job)
    corr = state_correspondence(np_template, params, bs)

    pnames = [k for k in state_dict if not k.endswith(_BUFFER_SUFFIXES)]
    template = ref_model.optimizer.state_dict()
    groups = template.get('param_groups') or []
    idx_order = [i for g in groups for i in g.get('params', [])]
    if len(idx_order) != len(pnames):
        logging.warning('optimizer not exported: %d torch params vs %d '
                        'state_dict parameters', len(idx_order), len(pnames))
        return None

    state: Dict[int, Dict[str, Any]] = {}
    count = moments.get('count', 0)
    for idx, pname in zip(idx_order, pnames):
        our_key = corr.get(pname)
        if our_key is None or not our_key.startswith('params/'):
            continue                       # sigma / untracked on our side
        leaf_key = our_key[len('params/'):]
        entry: Dict[str, Any] = {}
        for f in fields:
            if leaf_key in moments[f]:
                entry[f] = torch.as_tensor(np.array(
                    _inverse_transform(leaf_key, moments[f][leaf_key]),
                    dtype=np.float32))
        if not entry:
            continue
        if 'exp_avg' in entry:
            entry['step'] = torch.tensor(float(count))
        state[idx] = entry
    if not state:
        return None
    return {'state': state, 'param_groups': groups}


# -- recorders ----------------------------------------------------------------

def export_recorder(native_path: str, dst_path: str, ref_recorders) -> bool:
    """.jvr/.npz record file -> reference record-<set>.pth (written with
    the reference's own LossRecorder.save, recorders.py:107-138)."""
    import torch

    rec = LossRecorder.load(native_path)
    if len(rec) == 0:
        logging.debug('%s empty, not exported', native_path)
        return False
    # copies: .jvr files are mapped read-only, which torch refuses to wrap
    tensors = {k: torch.as_tensor(np.array(v))
               for k, v in rec._tensors.items()}
    r = ref_recorders.LossRecorder(rec.batch_size, rec._num_batch,
                                   device='cpu', **tensors)
    r._tensors = tensors
    r._recorded_batches = rec._recorded_batches
    r.last_batch_size = rec.last_batch_size
    if rec._seed is not None:
        r._seed = int(rec._seed)
    os.makedirs(os.path.dirname(dst_path), exist_ok=True)
    r.save(dst_path, cut=True)
    return True


def export_sample_recorder(npz_path: str, dst_path: str,
                           ref_recorders) -> bool:
    """sample-<set>.npz -> reference samples-<set>.pth.

    The SampleRecorder here is a flat keyed store; the reference splits
    sample-axis tensors from auxiliaries (recorders.py:372-399).  Keys
    whose leading dim is the modal one (the largest on a tie: samples
    usually outnumber auxiliary rows) become ``_tensors``, the rest (prior
    centroids...) ``_aux``; an auxiliary array as long as the samples is
    not told apart by the flat store and lands in ``_tensors``."""
    import torch

    rec = SampleRecorder.load(npz_path)
    arrays = {k: np.array(rec.get(k)) for k in rec.keys()}
    if not arrays:
        return False
    lengths = [v.shape[0] for v in arrays.values() if v.ndim]
    n = (max(sorted(set(lengths)), key=lambda L: (lengths.count(L), L))
         if lengths else 0)
    tensors = {k: torch.as_tensor(v) for k, v in arrays.items()
               if v.ndim and v.shape[0] == n}
    aux = {k: torch.as_tensor(v) for k, v in arrays.items()
           if k not in tensors}
    if not tensors:
        return False
    r = ref_recorders.SampleRecorder(n, 1, device='cpu', **tensors)
    r._tensors = tensors
    r._recorded_batches = 1
    r.last_batch_size = n
    if aux:
        r.add_auxiliary(**aux)
    os.makedirs(os.path.dirname(dst_path), exist_ok=True)
    r.save(dst_path, cut=True)
    return True


def _export_sample_dirs(src: str, dst: str, ref_recorders) -> int:
    """samples/<0-padded epoch>/record-*.jvr -> samples/<bare int>/*.pth,
    the newest epoch also into samples/last (the dir the reference's
    dictify reads first, ref dictify.py:750)."""
    samples = os.path.join(src, 'samples')
    if not os.path.isdir(samples):
        return 0
    n = 0
    numbered = []
    for sub in sorted(os.listdir(samples)):
        sub_path = os.path.join(samples, sub)
        if not os.path.isdir(sub_path):
            continue
        sub_out = str(int(sub)) if sub.isdigit() else sub
        if sub.isdigit():
            numbered.append((int(sub), sub_path))
        out_dir = os.path.join(dst, 'samples', sub_out)
        n += _export_record_files(sub_path, out_dir, ref_recorders)
        # one nesting level: WIM pre-tuning snapshots live under
        # samples/<epoch>/init/ (ref ft/job.py:302-313)
        for nested in sorted(os.listdir(sub_path)):
            nested_path = os.path.join(sub_path, nested)
            if os.path.isdir(nested_path):
                n += _export_record_files(
                    nested_path, os.path.join(out_dir, nested),
                    ref_recorders)
    if numbered:
        _, newest = max(numbered)
        _export_record_files(newest, os.path.join(dst, 'samples', 'last'),
                             ref_recorders)
    return n


def _export_record_files(src_dir: str, out_dir: str, ref_recorders) -> int:
    n = 0
    for f in sorted(os.listdir(src_dir)):
        for pattern, out_name, export, what in (
                (r'record-(?P<set>.+)\.(jvr|npz)\Z', 'record-{}.pth',
                 export_recorder, 'recorder'),
                (r'sample-(?P<set>.+)\.npz\Z', 'samples-{}.pth',
                 export_sample_recorder, 'sample recorder')):
            m = re.match(pattern, f)
            if not m:
                continue
            dst_file = os.path.join(out_dir, out_name.format(m.group('set')))
            try:
                n += export(os.path.join(src_dir, f), dst_file, ref_recorders)
            except Exception as e:
                logging.warning('%s %s not exported: %s', what, f, e)
            break
    return n


# -- the exporter -------------------------------------------------------------

def _check_exportable(features: str):
    """Reject the compact trunks before the checkout is touched: a clear
    rejection does not depend on the reference being importable."""
    if not features.startswith(('resnet', 'densenet')):
        return
    from ..models.resnet import DENSENET_TV, RESNET_LAYERS
    # -small/-tiny and width/growth-suffixed variants ('resnet18:16',
    # 'densenet121:12') are from-scratch-only
    ok = (features in RESNET_LAYERS if features.startswith('resnet')
          else features in DENSENET_TV)
    if not ok:
        raise ExportError_(
            'from-scratch flax {} features have no torchvision '
            'counterpart and cannot be exported (docs/PARITY.md); '
            'torchvision-faithful trunks (resnet18/34/50/101/152, '
            'densenet121/161/169/201) export fine'.format(features))


def _export_ft_params(job, src: str, dst: str) -> bool:
    """wim.json / poscod.json beside the exported job; True for a WIM job."""
    import dataclasses
    from ..ops.priors import PriorConfig
    wim_tp = job.training_parameters.get('wim')
    is_wim = bool(isinstance(wim_tp, dict) and wim_tp.get('distribution'))
    if is_wim:
        # reference WIM jobs keep their ft params in wim.json, fed to
        # build_prior on reload after its load_post_hook pops the
        # moving-set metadata (ref ft/wim.py:208-213, ft/job.py:142-145):
        # the prior keys (build_prior discards tau-for-gaussian etc.,
        # priors.py:41-52) and exactly the keys that hook pops.  The
        # reference re-derives the prior arrays from the torch seed
        # (priors.py:66-71), so its '@' scores use its own seeded prior
        allowed = ({f.name for f in dataclasses.fields(PriorConfig)}
                   | {'sets', 'alpha', 'train_size', 'moving_size',
                      'padding', 'mix_padding', 'padding_sets', 'from',
                      'mix', 'hash', 'array_size'})
        save_json({k: v for k, v in wim_tp.items()
                   if k in allowed and v is not None},
                  os.path.join(dst, 'wim.json'))
    poscod_tp = job.training_parameters.get('poscod')
    if isinstance(poscod_tp, dict):
        if os.path.exists(os.path.join(src, 'poscod_head.npz')):
            # marks the dir as a poscod job (ref PoscodJob.is_poscod,
            # ft/poscod.py:48); the llr head rides in state.pth
            save_json(poscod_tp, os.path.join(dst, 'poscod.json'))
        else:
            # without the head a poscod.json dir cannot load on the
            # reference side: exported as a plain job instead
            logging.warning('poscod params present but no poscod_head.npz: '
                            'exported as a plain job (no poscod.json)')
    return is_wim


def _ft_state(sd: Dict[str, Any], src: str, is_wim: bool):
    """The fine-tuning entries of the reference's state.pth, added to
    ``sd``: a Poscod job's llr head (ood_head.1.*; param_a, a vestigial
    learned scalar, ref ft/poscod.py:38-43), so that its strict
    load_state_dict succeeds with the trained head; a WIM job's
    ``_original_prior.*``, the alias of encoder.prior the reference
    WIMJob registers (ft/wim.py:28) — without it its load raises
    MissingKeys and the fallback path wipes the job's ood_results (ref
    ft/job.py:126-138)."""
    import torch
    head_path = os.path.join(src, 'poscod_head.npz')
    if os.path.exists(head_path):
        with np.load(head_path) as z:
            sd['ood_head.1.weight'] = torch.as_tensor(
                np.array(z['w'], np.float32).reshape(1, -1))
            sd['ood_head.1.bias'] = torch.as_tensor(
                np.array(z['b'], np.float32).reshape(1))
        sd.setdefault('param_a', torch.tensor([0.5]))
    if is_wim:
        for field in ('mean', '_var_parameter'):
            enc = sd.get('encoder.prior.' + field)
            if enc is not None:
                sd.setdefault('_original_prior.' + field, enc.clone())


def export_to_reference_job(src: str, dst: str,
                            reference_path: Optional[str] = None,
                            export_recorders: bool = True,
                            export_optimizer: bool = True,
                            device: DeviceLike = None) -> str:
    """Convert a job directory into a reference-loadable one; the job's
    weights are loaded on ``device`` (the card unless the caller asks for
    the CPU).  Returns the destination directory.  Raises
    :class:`ExportError_` (with the reason) rather than writing a
    directory the reference cannot load."""
    if not os.path.exists(os.path.join(src, 'params.json')):
        raise FileNotFoundError('{} is not a job dir (no params.json)'
                                .format(src))
    job = load_job(src, ghost=True)
    _check_exportable(job.model_cfg.features or '')
    ref_net_cls, ref_recorders = reference_modules(reference_path)

    arch = load_json(os.path.join(src, 'params.json'))
    os.makedirs(dst, exist_ok=True)
    save_json(export_architecture(arch, ref_net_cls),
              os.path.join(dst, 'params.json'))
    tp = {k: (dict(v) if isinstance(v, dict) else v)
          for k, v in job.training_parameters.items()}
    if isinstance(tp.get('optimizer'), dict):
        # the optimizer's params omit momentum (the reference's summary
        # schema, module/optimizers.py:25-34) but its Optimizer passes it
        # on to torch: carried so an exported SGD job resumes with its
        # momentum buffers live; likewise betas other than torch's
        if job.opt_cfg.momentum:
            tp['optimizer'].setdefault('momentum', job.opt_cfg.momentum)
        if tuple(job.opt_cfg.betas) != (0.9, 0.999):
            tp['optimizer'].setdefault('betas', list(job.opt_cfg.betas))
    save_json(export_train_params(tp, ref_net_cls),
              os.path.join(dst, 'train_params.json'))
    is_wim = _export_ft_params(job, src, dst)
    for name in ('test.json', 'ood.json'):
        p = os.path.join(src, name)
        if os.path.exists(p):
            save_json(load_json(p), os.path.join(dst, name))

    history = dict(job.train_history)
    has_state = _has_checkpoint(src, 'state')
    if has_state:
        job = load_job(src, device=device)
        history['epochs'] = max(int(history.get('epochs', 0) or 0),
                                int(job.state.epoch))
    save_json(history, os.path.join(dst, 'history.json'))

    # the reference network from the exported JSONs, by its own loader
    try:
        ref_model = ref_net_cls.load(dst, load_state=False)
    except Exception as e:
        raise ExportError_('the reference cannot rebuild the exported '
                           'architecture: {}: {}'.format(type(e).__name__, e))

    if has_state:
        import torch
        template = ref_model.state_dict()
        try:
            sd, missing = export_state_dict(job, template)
        except ImportError_ as e:
            raise ExportError_('weight mapping failed: {}'.format(e))
        _ft_state(sd, src, is_wim)
        torch.save(sd, os.path.join(dst, 'state.pth'))
        logging.info('state exported: %d tensors (%d left at init)',
                     len(sd), len(missing))
        if export_optimizer:
            opt_sd = export_optimizer_state(job, ref_model, template)
            if opt_sd is not None:
                torch.save(opt_sd, os.path.join(dst, 'optimizer.pth'))
                logging.info('optimizer exported: moments continue on a '
                             'reference resume')

    if export_recorders:
        _export_sample_dirs(src, dst, ref_recorders)

    for sentinel in ('deleted', 'derailed', 'RESUMED'):
        p = os.path.join(src, sentinel)
        if os.path.exists(p):
            shutil.copy(p, os.path.join(dst, sentinel))
    return dst
