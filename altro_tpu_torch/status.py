"""Solver status and error codes (PyTorch port).

Counterpart: altro_tpu/status.py (SolveStatus, ErrorCode, LineSearchCode,
AltroError), copied value for value so a status code means the same in
both packages. A batched solve carries the status per lane as an int32
tensor; the facade (api.ALTROSolver) raises AltroError.
"""

from __future__ import annotations

import enum


class SolveStatus(enum.IntEnum):
    SUCCESS = 0
    UNSOLVED = 1
    MAX_ITERATIONS = 2
    MAX_OBJECTIVE_EXCEEDED = 3
    STATE_OUT_OF_BOUNDS = 4
    INPUT_OUT_OF_BOUNDS = 5
    MERIT_FUN_GRADIENT_TOO_SMALL = 6
    BACKWARD_PASS_FAILED = 7
    LINE_SEARCH_FAILED = 8
    MAX_SOLVE_TIME = 9


class ErrorCode(enum.IntEnum):
    NO_ERROR = 0
    STATE_DIM_UNKNOWN = 1
    INPUT_DIM_UNKNOWN = 2
    NEXT_STATE_DIM_UNKNOWN = 3
    DIMENSION_UNKNOWN = 4
    BAD_INDEX = 5
    DIMENSION_MISMATCH = 6
    SOLVER_NOT_INITIALIZED = 7
    SOLVER_ALREADY_INITIALIZED = 8
    NON_POSITIVE = 9
    TIMESTEP_NOT_POSITIVE = 10
    COST_FUN_NOT_SET = 11
    DYNAMICS_FUN_NOT_SET = 12
    INVALID_OPT_AT_TERMINAL_KNOT_POINT = 13
    MAX_CONSTRAINTS_EXCEEDED = 14
    INVALID_CONSTRAINT_DIM = 15
    CHOLESKY_FAILED = 16
    OP_ONLY_VALID_AT_TERMINAL_KNOT_POINT = 17
    INVALID_POINTER = 18
    BACKWARD_PASS_FAILED = 19
    LINE_SEARCH_FAILED = 20
    MERIT_FUNCTION_GRADIENT_TOO_SMALL = 21
    INVALID_BOUND_CONSTRAINT = 22
    NON_POSITIVE_PENALTY = 23
    COST_NOT_QUADRATIC = 24
    FILE_ERROR = 25


class LineSearchCode(enum.IntEnum):
    """Return codes of the line searches (the reference's codes plus
    BEST_DECREASE, the grid search's best-decrease fallback, which counts
    as a failure for status and recovery but carries a usable step)."""

    NO_ERROR = 0
    MINIMUM_FOUND = 1
    INVALID_POINTER = 2
    NOT_DESCENT_DIRECTION = 3
    WINDOW_TOO_SMALL = 4
    GOT_NONFINITE_STEP_SIZE = 5
    MAX_ITERATIONS = 6
    HIT_MAX_STEPSIZE = 7
    BEST_DECREASE = 8


class AltroError(RuntimeError):
    """Host-side exception raised by the facade (api.ALTROSolver); `.code`
    is its ErrorCode."""

    def __init__(self, code: ErrorCode, msg: str = ""):
        super().__init__(f"[{code.name}] {msg}")
        self.code = code
