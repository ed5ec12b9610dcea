"""Second-stage fine-tuning (WIM / Poscod) + array aggregation + scheduler."""

from .datasets import (SubSampledDataset, MixtureDataset,  # noqa: F401
                       EstimatedLabelsDataset, create_moving_set)
from .wim import WIMJob, wim_measures  # noqa: F401
from .job import finetune  # noqa: F401
