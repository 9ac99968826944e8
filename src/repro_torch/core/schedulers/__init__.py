from .base import SchedulerDecision, TrialScheduler
from .fifo import FIFOScheduler
from .median_stopping import MedianStoppingRule
from .asha import ASHAScheduler, AsyncHyperBandScheduler
from .hyperband import HyperBandScheduler
from .pbt import PopulationBasedTraining
