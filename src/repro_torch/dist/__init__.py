"""repro_torch.dist — trial placement.

:mod:`repro_torch.dist.submesh` is the port's copy of ``repro.dist.submesh``:
the ``SlicePool`` that carves the device list into contiguous per-trial
slices, in its virtual mode.  The rule-based sharding engine
(``repro.dist.sharding``) is not ported yet.
"""
from . import submesh
from .submesh import MeshSlice, SlicePool

__all__ = ["submesh", "SlicePool", "MeshSlice"]
