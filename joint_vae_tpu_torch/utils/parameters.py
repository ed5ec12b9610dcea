"""Config-file-backed argparse + job numbering.

Port of ``joint_vae_tpu/utils/parameters.py`` (ref ``utils/parameters.py``):
an INI file (``configs/default.ini``) holds named training configs
([DEFAULT], [cifar10], [tilted], ...); ``--config <name>`` selects a
section whose values become argparse defaults, the full CLI overrides them,
and everything is persisted to the job directory (ref :179-389).  Job
numbers are hostname-scoped counters in a ``number-<host>`` file (ref
:33-59).  ``--device`` picks the torch device (the CUDA card by default).
A flag of what the port does not run yet would be parsed and refused by
:func:`refuse_unported` (``UNPORTED`` names none now)."""

import argparse
import configparser
import os
import socket
import time
from typing import Any, Dict, List, Optional

from ..cli import add_device_arg, add_mesh_args


def _default_config_file() -> str:
    """Repo-relative configs/default.ini, falling back to the cwd (for
    pip-installed usage where the repo layout is absent)."""
    here = os.path.join(os.path.dirname(__file__), '..', '..',
                        'configs', 'default.ini')
    if os.path.exists(here):
        return here
    return os.path.join('configs', 'default.ini')


DEFAULT_CONFIG_FILE = _default_config_file()


def next_job_number(job_dir: str = 'jobs') -> int:
    """Hostname-scoped monotonically increasing job number
    (ref utils/parameters.py:33-59).

    The read-increment-write is guarded by an O_EXCL lock file so
    concurrent launches (SLURM-array style) never share a number."""
    os.makedirs(job_dir, exist_ok=True)
    path = os.path.join(job_dir, 'number-{}'.format(socket.gethostname()))
    lock = path + '.lock'
    t0 = time.time()
    fd = None
    while fd is None:
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            if time.time() - t0 > 10.0:      # break a stale lock
                try:
                    os.unlink(lock)
                except FileNotFoundError:
                    pass
                t0 = time.time()
            time.sleep(0.02)
    try:
        n = 0
        if os.path.exists(path):
            with open(path) as f:
                try:
                    n = int(f.read().strip() or 0)
                except ValueError:
                    n = 0
        with open(path, 'w') as f:
            f.write(str(n + 1))
        return n + 1
    finally:
        os.close(fd)
        try:
            os.unlink(lock)
        except FileNotFoundError:
            pass


def _parse_value(s: str):
    s = s.strip()
    if s.lower() in ('true', 'false'):
        return s.lower() == 'true'
    for t in (int, float):
        try:
            return t(s)
        except ValueError:
            pass
    if ' ' in s:
        return [_parse_value(v) for v in s.split()]
    return s


def load_config_section(config_file: Optional[str], section: str) -> Dict[str, Any]:
    cf = config_file or DEFAULT_CONFIG_FILE
    cp = configparser.ConfigParser()
    cp.read(cf)
    if section != 'DEFAULT' and section not in cp:
        raise ValueError('config section [{}] not in {}'.format(section, cf))
    src = cp[section] if section != 'DEFAULT' else cp.defaults()
    return {k.replace('-', '_'): _parse_value(v) for k, v in dict(src).items()}


def add_training_args(parser: argparse.ArgumentParser):
    g = parser.add_argument_group('architecture')
    g.add_argument('--type', choices=['jvae', 'cvae', 'vib', 'vae', 'xvae'],
                   default='cvae')
    g.add_argument('--features', default=None)
    g.add_argument('--no-features', action='store_true',
                   help='force a featureless model even if a config file '
                        'sets --features (ref parameters.py:302,386)')
    g.add_argument('--upsampler', default=None)
    g.add_argument('--encoder', nargs='*', type=int, default=[36])
    g.add_argument('--decoder', nargs='*', type=int, default=[36])
    g.add_argument('--classifier', nargs='*', default=[36])
    g.add_argument('--latent-dim', '-K', type=int, default=32)
    g.add_argument('--latent-sampling', '-L', type=int, default=1)
    g.add_argument('--test-latent-sampling', '-l', type=int, default=0)
    g.add_argument('--activation', default='relu')
    g.add_argument('--output-activation', default='sigmoid')
    g.add_argument('--output-distribution',
                   choices=['gaussian', 'categorical'], default='gaussian')
    g.add_argument('--categorical', action='store_const',
                   dest='output_distribution', const='categorical',
                   help='alias for --output-distribution categorical '
                        '(ref parameters.py:251)')
    g.add_argument('--conv-padding', default=None,
                   help='(parsed but unused in the reference, '
                        'parameters.py:312)')
    g.add_argument('--batch-norm', nargs='?', const='encoder', default=None,
                   choices=['encoder', 'both'])
    g.add_argument('--dropout', type=float, default=0.0)
    g.add_argument('--encoder-forced-variance', type=float, nargs='?',
                   const=1.0, default=0.0)
    g.add_argument('--encoder-free-variance', action='store_const',
                   dest='encoder_forced_variance', const=0.0,
                   help='inverse of --encoder-forced-variance '
                        '(ref parameters.py:320)')
    g.add_argument('--compute-dtype', choices=['float32', 'bfloat16'],
                   default='float32')
    g.add_argument('--iws-mode', choices=['reference', 'lme'],
                   default='reference',
                   help="IWAE estimator: the reference's published variant "
                        "or the corrected log-mean-exp")

    p = parser.add_argument_group('prior')
    p.add_argument('--prior', default='gaussian',
                   choices=['gaussian', 'tilted', 'uniform'])
    p.add_argument('--prior-means', type=float, default=0.0)
    p.add_argument('--learned-prior-means', action='store_true')
    p.add_argument('--static-prior-means', action='store_false',
                   dest='learned_prior_means',
                   help='frozen prior means (inverse of --learned-prior-'
                        'means, ref parameters.py:284)')
    p.add_argument('--prior-variance', default='scalar',
                   choices=['scalar', 'diag', 'full'])
    p.add_argument('--tilted-tau', type=float, default=25.0)
    p.add_argument('--freeze-prior-means', type=int, default=0)

    l = parser.add_argument_group('loss')
    l.add_argument('--beta', type=float, default=1.0)
    l.add_argument('--gamma', type=float, default=0.0)
    l.add_argument('--sigma-per-dim', action='store_true')
    l.add_argument('--sigma', '-s', default='1.0',
                   help='float | "learned" | "rmse" | "coded"')
    l.add_argument('--force-cross-y', type=float, nargs='?', const=1.0,
                   default=0.0,
                   help='(parsed but unused in the reference, '
                        'parameters.py:336)')
    l.add_argument('--sigma-reach', type=float, default=1.0)
    l.add_argument('--sigma-decay', type=float, default=0.0)
    l.add_argument('--sigma-max-step', type=float, default=0.0)
    l.add_argument('--coded-sigma-per-dim', action='store_true')

    t = parser.add_argument_group('training')
    t.add_argument('--dataset', '--set', dest='dataset', default='cifar10')
    t.add_argument('--transformer', default='default')
    t.add_argument('--data-augmentation', nargs='*', default=[])
    t.add_argument('--device-data', action='store_true',
                   help='keep the whole trainset resident in device memory '
                        '(8-bit sets as uint8), shuffled there each epoch')
    t.add_argument('--epochs', type=int, default=2)
    t.add_argument('--batch-size', '-M', type=int, default=64)
    t.add_argument('--test-batch-size', '-m', type=int, default=512)
    t.add_argument('--validation', '-V', type=int, default=0)
    t.add_argument('--test-sample-size', '-t', type=int, default=0,
                   help='cap the per-epoch test/OOD evaluation to this many '
                        'samples (0 = whole set; ref parameters.py:236, '
                        'train.py:348)')
    t.add_argument('--oodsets', nargs='*', default=None,
                   help='OOD companion sets for in-training detection rates '
                        '(default: the registry same-size list; ref '
                        'parameters.py:325)')
    t.add_argument('--warmup', nargs='*', type=int, default=[0])
    t.add_argument('--warmup-gamma', nargs='*', type=int, default=[0])
    t.add_argument('--full-test-every', type=int, default=10)
    t.add_argument('--ood-detection-every', type=int, default=10)
    t.add_argument('--optimizer', dest='optim_type', default='adam',
                   choices=['adam', 'sgd'])
    t.add_argument('--lr', type=float, default=0.0)
    t.add_argument('--lr-decay', type=float, default=0.0)
    t.add_argument('--weight-decay', '--wd', type=float, default=0.0)
    t.add_argument('--grad-clipping', type=float, default=0.0)
    t.add_argument('--seed', type=int, default=0)
    t.add_argument('--fine-tuning', action='store_true')
    t.add_argument('--pretrained-features', metavar='JOB_DIR', default=None,
                   help='copy (and freeze) the features stack from another '
                        "job's checkpoint (ref --pretrained-features)")
    t.add_argument('--pretrained-upsampler', metavar='JOB_DIR', default=None)
    t.add_argument('--dry-run', action='store_true',
                   help='build the model and datasets, print the setup, '
                        'exit before training (ref --dry-run)')
    t.add_argument('--freeze', nargs='*', default=[],
                   help='module names whose params never train (ref '
                        'pretrained feature/upsampler freezing, '
                        'module/vae_layers/conv.py:237-243), e.g. '
                        '--freeze features upsampler')

    t.add_argument('--dataset-size', type=int, default=None,
                   help='cap train/test sizes (smoke tests)')
    t.add_argument('--no-final-test', action='store_true')
    t.add_argument('--no-final-ood', action='store_true')

    add_mesh_args(t)
    add_device_arg(t)

    j = parser.add_argument_group('job')
    j.add_argument('--job-dir', default='jobs')
    j.add_argument('--job-number', '-j', type=int, default=0,
                   help='use this job number instead of the hostname '
                        'counter (ref parameters.py:364)')
    j.add_argument('--resume', '-R', type=int, default=None,
                   help='job number to resume')
    j.add_argument('--output-dir', default=None, metavar='DIR/',
                   help='also write the live epoch table to '
                        'DIR/train-<job>.out (ref parameters.py:369)')
    j.add_argument('--where', action='store_true',
                   help='print the save dir and exit (ref train.py:267)')
    j.add_argument('--show', action='store_true')
    j.add_argument('--verbose', '-v', action='count', default=0)
    j.add_argument('--debug', action='store_true')
    return parser


def get_args(argv: Optional[List[str]] = None, what: str = 'train'):
    """Two-stage parse: --config picks INI defaults, then the full CLI
    (ref utils/parameters.py:179-219)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument('--config', default=None)
    pre.add_argument('--config-file', default=None)
    cfg_args, remaining = pre.parse_known_args(argv)

    parser = argparse.ArgumentParser(parents=[pre],
                                     prog='jvt-{}'.format(what))
    add_training_args(parser)
    list_dests = {a.dest for a in parser._actions if a.nargs in ('*', '+')}
    if cfg_args.config:
        defaults = load_config_section(cfg_args.config_file, cfg_args.config)
        known = {a.dest for a in parser._actions}
        defaults = {k: v for k, v in defaults.items() if k in known}
        for k in list(defaults):
            if k in list_dests and not isinstance(defaults[k], (list, tuple)):
                defaults[k] = [] if defaults[k] in (None, '') else [defaults[k]]
        parser.set_defaults(**defaults)
    args = parser.parse_args(remaining)
    for k in list_dests:
        v = getattr(args, k, None)
        if v is not None and not isinstance(v, (list, tuple)):
            setattr(args, k, [v])
    return args


def model_config_from_args(args) -> 'CVNetConfig':
    from ..models.cvnet import CVNetConfig
    from ..ops.priors import build_prior_config
    from ..ops.sigma import SigmaConfig
    from ..data.registry import get_shape_by_name

    shape, num_labels = get_shape_by_name(args.dataset, args.transformer)
    if shape is None:
        raise ValueError('unknown dataset {}'.format(args.dataset))

    prior_kw = dict(num_priors=(num_labels if args.type in ('cvae', 'xvae')
                                else 1),
                    init_mean=args.prior_means,
                    learned_means=args.learned_prior_means,
                    freeze_means=args.freeze_prior_means,
                    var_dim=args.prior_variance)
    if args.prior in ('tilted', 'uniform'):
        prior_kw.pop('var_dim')
    if args.prior == 'tilted':
        # ref train.py:182-183 forwards tau only for tilted; uniform keeps
        # its family default (tau=5, module/priors.py:411).
        prior_kw['tau'] = args.tilted_tau
    prior = build_prior_config(args.latent_dim, args.prior, **prior_kw)

    s = str(args.sigma)
    D = int(shape[0] * shape[1] * shape[2])
    sdim = D if getattr(args, 'sigma_per_dim', False) else 1
    if s.startswith('learned'):
        # 'learned' or 'learned--<init>' (ref train.py:141-148)
        init = float(s.split('--')[-1]) if '--' in s else 1.0
        sigma = SigmaConfig(value=init, learned=True, sdim=sdim)
    elif s == 'rmse':
        sigma = SigmaConfig(is_rmse=True)
    elif s == 'coded':
        sigma = SigmaConfig(input_dim=tuple(shape),
                            sdim=(int(1) if not args.coded_sigma_per_dim
                                  else D))
    else:
        sigma = SigmaConfig(value=float(s), sdim=sdim,
                            decay=args.sigma_decay, reach=args.sigma_reach,
                            max_step=args.sigma_max_step or None)

    classifier = tuple(args.classifier) if args.classifier else ()
    classifier = tuple(int(c) if str(c).isdigit() else c for c in classifier)

    return CVNetConfig(
        input_shape=tuple(shape), num_labels=num_labels, type=args.type,
        output_distribution=args.output_distribution,
        features=(None if getattr(args, 'no_features', False)
                  or (args.features or '').lower() == 'none'
                  else args.features or None),
        upsampler=args.upsampler or None,
        batch_norm=args.batch_norm or False, dropout=args.dropout,
        encoder=tuple(args.encoder), decoder=tuple(args.decoder),
        classifier=classifier, latent_dim=args.latent_dim,
        latent_sampling=args.latent_sampling,
        test_latent_sampling=args.test_latent_sampling,
        activation=args.activation, output_activation=args.output_activation,
        encoder_forced_variance=args.encoder_forced_variance,
        beta=args.beta, gamma=args.gamma, prior=prior, sigma=sigma,
        compute_dtype=args.compute_dtype, iws_mode=args.iws_mode)


def optimizer_config_from_args(args) -> 'OptimizerConfig':
    from ..train.optimizers import OptimizerConfig
    return OptimizerConfig(optim_type=args.optim_type, lr=args.lr,
                           lr_decay=args.lr_decay,
                           weight_decay=args.weight_decay,
                           grad_clipping=args.grad_clipping or None)


# flags the JAX package runs and the port does not yet, with the ROADMAP
# item that ports them: none (the mesh flags run since the mesh was
# ported; ``cli.mesh_from_args`` keeps the JAX package's own refusals)
UNPORTED = ()


def refuse_unported(args) -> None:
    """SystemExit naming the ROADMAP item of each set flag the port does
    not run yet."""
    bad = ['--{}: {}'.format(k.replace('_', '-'), what)
           for k, what in UNPORTED if getattr(args, k, None)]
    if bad:
        raise SystemExit('not ported yet:\n  ' + '\n  '.join(bad))
