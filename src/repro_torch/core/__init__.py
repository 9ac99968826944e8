"""repro_torch.core — Tune: distributed model selection over a narrow-waist interface.

Public API mirrors the paper: a user API (Trainable / function trainables +
search-space DSL + run_experiments) and a scheduler API (TrialScheduler and the
six built-in algorithms of Table 1).
"""
from .api import FunctionHandle, FunctionTrainable, Trainable, wrap_function
from .checkpoint import CheckpointManager, load_pytree, save_pytree, tree_from_bytes, tree_to_bytes
from .clock import (Clock, VirtualClock, WallClock, get_default_clock,
                    set_default_clock, use_clock)
from .experiment import (ExperimentAnalysis, load_experiment_state,
                         register_trainable, run_experiments)
from .loggers import CompositeLogger, ConsoleLogger, CSVLogger, JSONLLogger, Logger
from .object_store import ObjectStore
from .resources import ResourceAccountant, Resources
from .runner import TrialRunner
from .events import EventBus, EventType, TrialEvent
from .executor import BusDrivenExecutor, SerialMeshExecutor, TrialExecutor
from .concurrent_executor import ConcurrentMeshExecutor
from .process_executor import ProcessMeshExecutor
from .elastic import FairShare, GreedyFill, ResizePolicy, ResourceBroker
from .workers import (ProcessWorker, TrainableFactory, factory_from_class,
                      register_worker_factory, resolve_worker_factory)
from .trial import Checkpoint, Result, Trial, TrialStatus
from .schedulers.base import SchedulerDecision, TrialScheduler
from .schedulers.fifo import FIFOScheduler
from .schedulers.median_stopping import MedianStoppingRule
from .schedulers.asha import ASHAScheduler, AsyncHyperBandScheduler
from .schedulers.hyperband import HyperBandScheduler
from .schedulers.pbt import PopulationBasedTraining
from .search.space import (
    choice, grid_search, loguniform, normal, qrandint, randint, sample_from, uniform,
)
from .search.basic import GridSearcher, RandomSearcher, Searcher
from .search.tpe import TPESearcher
from .search.gp import GPSearcher
from ..obs import (NULL_OBS, MetricsRegistry, Observability,  # DESIGN.md §8
                   Tracer)

__all__ = [
    "Trainable", "FunctionTrainable", "FunctionHandle", "wrap_function",
    "run_experiments", "register_trainable", "ExperimentAnalysis",
    "load_experiment_state",
    "Clock", "WallClock", "VirtualClock",
    "get_default_clock", "set_default_clock", "use_clock",
    "Trial", "TrialStatus", "Result", "Checkpoint",
    "TrialRunner", "TrialExecutor", "SerialMeshExecutor", "BusDrivenExecutor",
    "ConcurrentMeshExecutor", "ProcessMeshExecutor",
    "ResourceBroker", "ResizePolicy", "GreedyFill", "FairShare",
    "TrainableFactory", "ProcessWorker", "register_worker_factory",
    "resolve_worker_factory", "factory_from_class",
    "EventBus", "EventType", "TrialEvent",
    "TrialScheduler", "SchedulerDecision",
    "FIFOScheduler", "MedianStoppingRule", "ASHAScheduler",
    "AsyncHyperBandScheduler", "HyperBandScheduler", "PopulationBasedTraining",
    "Searcher", "RandomSearcher", "GridSearcher", "TPESearcher", "GPSearcher",
    "grid_search", "choice", "uniform", "loguniform", "randint", "qrandint",
    "normal", "sample_from",
    "Resources", "ResourceAccountant", "ObjectStore", "CheckpointManager",
    "save_pytree", "load_pytree", "tree_to_bytes", "tree_from_bytes",
    "Logger", "ConsoleLogger", "CSVLogger", "JSONLLogger", "CompositeLogger",
    "Observability", "NULL_OBS", "MetricsRegistry", "Tracer",
]
