"""Fault-tolerance runtime (PyTorch port of repro.runtime)."""
from . import fault_tolerance
from .fault_tolerance import (PreemptionGuard, StragglerMonitor, StepTimer,
                              replan_mesh, rescale_grad_accum)

__all__ = ["fault_tolerance", "PreemptionGuard", "StragglerMonitor",
           "StepTimer", "replan_mesh", "rescale_grad_accum"]
