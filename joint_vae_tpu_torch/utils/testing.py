"""Post-hoc early stopping: pick the epoch minimizing a validation metric
from the training history (ref utils/testing.py:5-45); cached in
train_params.json as 'early-min-loss'.

The port's own copy of ``joint_vae_tpu/utils/testing.py``.  Its family
scan looks at every history epoch (not only the candidate epochs): a
validation entry at any epoch selects the validation family for all of
them, as the JAX package does."""

from typing import Dict, Optional, Sequence


def early_stopping_epoch(train_history: Dict, metric: str = 'total',
                         source: str = 'validation',
                         fallback_source: str = 'test',
                         epochs: Optional[Sequence[int]] = None
                         ) -> Optional[int]:
    """Epoch (1-based) minimizing the metric.

    The history family is chosen GLOBALLY like the reference
    (testing.py:21-26 keys it off history[0]): 'validation' when any
    epoch carries validation entries, else 'test' — values from the two
    families are never mixed across epochs (a per-epoch fallback could
    silently select on the test set, i.e. leakage).  Within the family
    the metric is looked up in ``<family>_loss`` then
    ``<family>_measures`` (mse/rmse/dB live there — ref testing.py:31-37
    builds metrics['mse'] from validation_measures).  ``epochs``
    restricts the candidates (the reference only considers epochs
    carrying stored test/OOD results, testing.py:16-17)."""
    hist_epochs = sorted(k for k in train_history if isinstance(k, int))
    family = fallback_source
    for e in hist_epochs:
        if any(train_history[e].get(source + k)
               for k in ('_loss', '_measures')):
            family = source
            break
    best, best_epoch = None, None
    for epoch in hist_epochs:
        if epochs is not None and epoch not in epochs:
            continue
        entry = train_history[epoch]
        v = None
        for key in ('_loss', '_measures'):
            vals = entry.get(family + key)
            if vals and metric in vals:
                v = vals[metric]
                break
        if v is None:
            continue
        if best is None or v < best:
            best, best_epoch = v, epoch
    return best_epoch


def cache_early_stopping(job, metric: str = 'total') -> Optional[int]:
    """Reference-faithful selection for a stored job: candidates are the
    epochs carrying test/OOD results (ref testing.py:16-17, with its
    explicit -1 discard), intersected with the epochs the history
    actually holds — new_job seeds a testing[0] placeholder (mirroring
    the reference's pre-training eval entry) that must not pin the
    restriction to a history epoch that does not exist.  When no usable
    restriction remains (fresh job, placeholder-only results), every
    history epoch is a candidate (a deviation — the reference returns
    None there, silently disabling --early-stopping on fresh jobs)."""
    result_epochs = ({e for e in getattr(job, 'ood_results', {}) or {}
                      if isinstance(e, int)}
                     | {e for e in getattr(job, 'testing', {}) or {}
                        if isinstance(e, int)})
    result_epochs.discard(-1)
    result_epochs &= {e for e in job.train_history if isinstance(e, int)}
    e = early_stopping_epoch(job.train_history, metric=metric,
                             epochs=result_epochs or None)
    if e is not None:
        job.training_parameters['early-min-loss'] = e
    return e
