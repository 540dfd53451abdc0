"""ray_tpu_torch.tune — hyperparameter optimization engine.

Port of ``ray_tpu/tune``, copied with its imports rewritten; it imports
neither torch nor jax itself. Parity with ``python/ray/tune/``: trials are
``ray_tpu_torch`` actors (one Trainable each) driven by an event-loop
TrialRunner with pluggable schedulers (ASHA/HyperBand/PBT/median-stopping)
and searchers (grid/random + wrappers); checkpoints interoperate with
``ray_tpu_torch.air.Checkpoint``. The one seam is the trial's accelerator:
``resources_per_trial={"gpu": n}`` asks the runtime for ``num_gpus=n``,
where the JAX package maps ``"tpu"`` to ``num_tpus``.
"""

from ray_tpu_torch.tune.analysis import ExperimentAnalysis, ResultGrid
from ray_tpu_torch.tune.sample import (choice, grid_search, lograndint,
                                       loguniform, qloguniform, quniform,
                                       randint, randn, sample_from, uniform)
from ray_tpu_torch.tune.schedulers import (AsyncHyperBandScheduler,
                                           FIFOScheduler, HyperBandScheduler,
                                           MedianStoppingRule,
                                           PopulationBasedTraining,
                                           TrialScheduler)
from ray_tpu_torch.tune.search import (BasicVariantGenerator, BayesOptSearch,
                                       ConcurrencyLimiter, HyperOptSearch,
                                       OptunaSearch, Repeater, Searcher)
from ray_tpu_torch.tune.bohb import BOHBSearcher, HyperBandForBOHB
from ray_tpu_torch.tune.pb2 import PB2
from ray_tpu_torch.tune.syncer import SyncConfig, Syncer
from ray_tpu_torch.tune.tpe import TPESearcher
from ray_tpu_torch.tune.session import get_checkpoint, get_trial_id, report
from ray_tpu_torch.tune.trainable import (FunctionTrainable, Trainable,
                                          wrap_function)
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.tuner import TuneConfig, Tuner, run

__all__ = [
    "run", "Tuner", "TuneConfig", "Trainable", "FunctionTrainable",
    "wrap_function", "Trial", "report", "get_checkpoint", "get_trial_id",
    "uniform", "quniform", "loguniform", "qloguniform", "randn", "randint",
    "lograndint", "choice", "sample_from", "grid_search",
    "FIFOScheduler", "AsyncHyperBandScheduler", "HyperBandScheduler",
    "MedianStoppingRule", "PopulationBasedTraining", "TrialScheduler",
    "BasicVariantGenerator", "ConcurrencyLimiter", "Repeater", "Searcher",
    "TPESearcher", "OptunaSearch", "HyperOptSearch", "BayesOptSearch",
    "BOHBSearcher", "HyperBandForBOHB", "PB2", "SyncConfig", "Syncer",
    "ExperimentAnalysis", "ResultGrid",
]
