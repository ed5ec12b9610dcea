"""The parts of the JAX package's ``save_load/dictify.py`` that the
evaluation engines and the train CLI use: which recorded loss components a
method needs (the 'recorders' reuse tier), the FPR at a kept TPR of a
stored result, and the architecture string of job paths.  The flat
summary dicts and the 3-tier results planner are not ported.
"""

from typing import List, Optional

from ..ops.scores import strip_roc_suffix


def needed_components(method: str) -> List[str]:
    """Which recorded loss keys a method needs (ref dictify.py:434-471)."""
    m = strip_roc_suffix(method)
    if m and m[-1] in '~@':
        # WIM variants (ref dictify.py:453-461): '~' scores at the
        # estimated label (needs y_est_already), '@' needs the
        # alternate-prior twin, '~@' needs both
        base = m.rstrip('~@')
        base = base[4:] if base.startswith('soft') else base
        key = 'total' if base == 'elbo' else base
        if m.endswith('~@'):
            return [key, key + '@', 'y_est_already']
        if m.endswith('@'):
            # scoring aggregates the in-prior loss before subtracting the
            # twin (ft/wim.py::wim_measures), so both are needed (the
            # reference's table lists only the twin, dictify.py:457)
            return [key, key + '@']
        return [key, 'y_est_already']
    if m.startswith('odin'):
        return [m, 'logits']
    if m in ('baseline', 'logits', 'hyz') or m.startswith('baseline'):
        return ['logits']
    if m == 'elbo' or m in ('sum', 'max', 'mean', 'std', 'mag', 'nstd', 'IYx'):
        return ['total']
    if m == 'iws' or m.startswith('softiws'):
        return ['iws']
    if m in ('soft', 'softkl') or m.startswith('softkl'):
        return ['kl']
    if m.startswith('softzdist'):
        return ['zdist']
    if m == 'mse':
        return ['cross_x']
    if m == 'wmse':
        return ['wmse']
    if m in ('kl', 'zdist', 'total', 'cross_x', 'cross_y', 'var_kl'):
        return [m]
    # predict methods
    if m == 'esty':
        return ['logits']
    if m == 'loss':
        return ['total']
    if m == 'closest':
        return ['zdist']
    if m == 'already':
        return ['y_est_already']
    return [m]


def _fpr_at(r: dict, tpr: float) -> Optional[float]:
    for t, f in zip(r.get('tpr') or [], r.get('fpr') or []):
        if abs(t - tpr) < 1e-4:
            return f
    return None


def _arch_string(cfg) -> str:
    """Compact architecture string used in job paths and summaries
    (the spirit of ref print_architecture)."""
    parts = [cfg.type]
    if cfg.features:
        parts.append(cfg.features)
    parts.append('e' + '-'.join(map(str, cfg.encoder)))
    parts.append('K{}'.format(cfg.latent_dim))
    if cfg.x_is_generated:
        parts.append('d' + '-'.join(map(str, cfg.decoder)))
        if cfg.upsampler:
            parts.append(cfg.upsampler)
    clf = '-'.join(map(str, cfg.classifier))
    if clf:
        parts.append('c' + clf)
    parts.append(cfg.prior.distribution)
    if cfg.prior.conditional:
        parts.append('cond')
    return '--'.join(parts)
