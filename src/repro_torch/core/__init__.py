"""The parts of ``repro.core`` that the port's training slice needs, copied:
``api`` (the ``Trainable`` contract)."""
from .api import FunctionHandle, FunctionTrainable, Trainable, wrap_function
