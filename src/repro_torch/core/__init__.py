"""FlashMatrix/FlashR core on PyTorch: GenOps, lazy DAG, fusion, whole-mode
materialization.

Public surface:
  * `repro_torch.core.fm` — the R-like namespace
  * `repro_torch.core.genops` — raw GenOps (paper Table I)
  * `repro_torch.core.vudf` — VUDF registry
  * `repro_torch.core.matrix` — FMMatrix handles + partition policy
"""
from . import (dtypes, vudf, matrix, dag, genops, plan_ir, lowering, fusion,
               materialize)
from . import rlike as fm
from .matrix import FMMatrix

__all__ = ["dtypes", "vudf", "matrix", "dag", "genops", "plan_ir",
           "lowering", "fusion", "materialize", "fm", "FMMatrix"]
