"""Solver options (PyTorch port).

Counterpart: altro_tpu/options.py::SolverOptions. The same frozen
dataclass with the same field names and defaults, free of jax, so the
port reads the options a JAX user already writes. The field docs live in
the JAX module; options the port's slice does not implement are kept so
that `supported_options` can refuse them by name.
"""

from __future__ import annotations

import dataclasses
import enum


class Verbosity(enum.IntEnum):
    SILENT = 0
    OUTER = 1
    INNER = 2
    LINE_SEARCH = 3


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    iterations_max: int = 200
    tol_cost: float = 1e-4
    tol_cost_intermediate: float = 1e-4
    enable_cost_tolerance: bool = False
    tol_primal_feasibility: float = 1e-4
    tol_stationarity: float = 1e-4
    tol_stationarity_rel: float = 0.0
    tol_meritfun_gradient: float = 1e-8
    max_solve_time: float = float("inf")

    max_state_value: float = float("inf")
    max_input_value: float = float("inf")
    max_objective_value: float = float("inf")

    penalty_initial: float = 1.0
    penalty_scaling: float = 10.0
    penalty_max: float = 1e8
    penalty_warm_start: bool = False
    penalty_warm_start_decay: float = 1.0

    use_backtracking_linesearch: bool = False
    ls_max_iters: int = 25
    ls_alpha_max: float = 2.0
    ls_beta_increase: float = 1.5
    ls_beta_decrease: float = 0.5
    ls_min_interval_size: float = 1e-6
    ls_try_cubic_first: bool = True
    ls_c1: float = 1e-4
    ls_c2: float = 0.9
    ls_failure_recovery: bool = False
    ls_recovery_max_fails: int = 2
    ls_best_decrease_fallback: bool = False
    parallel_linesearch: bool = False
    ls_parallel_width: int = 8
    ls_phase_split: bool = False
    ls_armijo_only: bool = False
    ls_armijo_slack: float = 0.0

    reg_initial: float = 0.0
    reg_min: float = 1e-8
    reg_scaling: float = 10.0
    reg_max_retries: int = 12

    parallel_riccati: bool = False
    parallel_riccati_chunk: int = 0
    ls_grid_x_only: bool = True
    pallas_rollout: bool = True
    pallas_rollout_tiled: bool = True
    pallas_backward: bool = False
    pallas_latency_backward: bool = True
    diag_expansion: bool = True
    exact_al_hessian: bool = False
    throw_errors: bool = True
    symmetrize_ctg: bool = False

    rti_mode: bool = False

    iteration_callback: object = None

    verbose: Verbosity = Verbosity.SILENT

    def replace(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)
