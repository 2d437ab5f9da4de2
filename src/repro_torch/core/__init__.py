# The loop compiler of the paper, ported to PyTorch (one device, eager).
#
# Pipeline: @loop_program (Python-source frontend, paper Fig. 1 language)
#   → analysis.check (Def. 3.1 restrictions)
#   → translate (Fig. 2 rules E/K/D/U/S + Rule 2 unnesting)
#   → passes.plan_program (optimizer pipeline → physical-plan IR, plan.py)
#   → lower.PlanExecutor (plan nodes → PyTorch; the group-by ⊕ and the §5
#     packed matmul run hand-written CUDA kernels, kernels/csrc/)
# The planning modules are copies of the reference package's, so both
# packages build the same plan from the same program.
from .analysis import check
from .frontend import (bag, dim, intscalar, loop_program, map_, matrix,
                       parse_program, scalar, vector)
from .interp import run as interpret
from .loop_ast import Program, RejectionError
from .lower import CompiledProgram, PlanExecutor, compile_program
from .passes import PlanConfig, plan_program
from .translate import translate

__all__ = ["loop_program", "parse_program", "compile_program", "interpret",
           "check", "translate", "CompiledProgram", "PlanExecutor",
           "PlanConfig", "plan_program", "Program",
           "RejectionError", "vector", "matrix", "map_", "bag", "dim",
           "scalar", "intscalar"]
