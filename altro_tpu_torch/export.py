"""AOT export / serving: a saved, load-and-call warm-started MPC tick.

Counterpart: altro_tpu/export.py (`state_to_arrays`, `arrays_to_state`,
`make_serving_fn`, `export_mpc_server`, `save_exported`,
`load_exported`, `call_exported`). JAX serialized the lowered StableHLO
of `mpc.mpc_step` (vmapped over lanes, or one lane) with `jax.export`;
here `torch.export` records the same tick as an `ExportedProgram` and
saves it as a `.pt2` file, which a serving process loads and calls
without tracing. The problem (model, horizon, constraints, Q and R) and
the SolverOptions are frozen into the graph; the calling convention is
JAX's plain-array ABI:

    (x_measured [B, n], x_ref [B, N+1, n], u_ref [B, N+1, m],
     state dict {x, u, y, rho, K, d, P, p, reg, z0, ...})
      -> (u0 [B, m], state dict, stats dict)

with no B axis for batch=None (one lane). The graph is graph_solve.py's
form of the solve: the setup and one trip traced once, the trips in
torch's while_loop operator with per-lane masks, the rollouts' knot
loops as scans, the backward pass with its retry as one operator a trip
(ops/library.py). It carries every option JAX's export carries: the
default strong-Wolfe search (the live machine's pass in a loop operator
inside the trip) and the sequential backtracking, the grids (phase-split
x-only or light payload, non-split, the best-decrease fallback),
`rti_mode`, `exact_al_hessian`, `parallel_riccati` (pure or chunked)
and, on one lane, the trial-rollout kernel under `pallas_rollout`
(`altro_tpu_torch::trial_rollout`) where the live solve runs it. What
JAX's export refuses too (a verbosity above SILENT, an
`iteration_callback`: host callbacks), or a kernel on the card that
cannot take the problem, raises NotImplementedError naming it before
tracing (`graph_solve.graph_refusal`).

Under the reference's default options (the strong-Wolfe search), one
lane, for the card and the host:

    save_exported(export_mpc_server(problem), "controller.pt2")

Devices. `platforms` ("cuda", "cpu" or both; default both) says where
the artifact may run; it is traced on the problem's device and moved to
the inputs' device at the first call there. An f32 artifact that selects
the latency kernel holds the `altro_tpu_torch::riccati_latency` operator
whatever device traced it, and the operator dispatches by device: the
kernel on CUDA tensors, the plain recursion on CPU tensors. So the JAX
module's warning for a TPU artifact traced off the TPU (altro_tpu/
export.py:129-148) has no case here, and its two-platform artifact is a
CPU-traced artifact run on both devices.

Loading. JAX's artifact needs nothing of altro_tpu at load time. This
one needs the port's three operators registered before `torch.export.load`
(importing this module does it; `load_exported` runs from it), and the
CUDA kernels build on the first call on the card, as every entry point
of the port builds them.

Example
-------
    art = export_mpc_server(problem, opts, batch=8)
    save_exported(art, "controller.pt2")             # build box
    ...
    srv = load_exported("controller.pt2")            # serving box
    u0, state, stats = call_exported(
        srv, x_measured, x_ref_window, u_ref_window, state)
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Dict, Optional, Sequence, Tuple

import torch

from altro_tpu_torch.graph_solve import SolveGraphs, graph_refusal, graph_solve, trace_solve
from altro_tpu_torch.mpc import update_tracking_window_lanes
from altro_tpu_torch.options import SolverOptions
from altro_tpu_torch.parallel.batch import check_options
from altro_tpu_torch.problem import DiagonalCost, Problem
from altro_tpu_torch.solver import SolverState, SolveStats, init_state
from altro_tpu_torch.tile_solver import shift_trajectory_tiled

__all__ = [
    "state_to_arrays",
    "arrays_to_state",
    "make_serving_fn",
    "export_mpc_server",
    "save_exported",
    "load_exported",
    "call_exported",
    "Exported",
]

_STATE_FIELDS = ("x", "u", "y", "rho", "K", "d", "P", "p", "reg")
_PLATFORMS = ("cuda", "cpu")


def state_to_arrays(state: SolverState) -> Dict[str, torch.Tensor]:
    """Flatten a SolverState into a plain dict of tensors (serving ABI)."""
    out = {f: getattr(state, f) for f in _STATE_FIELDS}
    for j, zj in enumerate(state.z):
        out[f"z{j}"] = zj
    return out


def arrays_to_state(arrays: Dict[str, torch.Tensor]) -> SolverState:
    """Inverse of state_to_arrays."""
    nz = sum(1 for k in arrays if k.startswith("z") and k[1:].isdigit())
    return SolverState(z=tuple(arrays[f"z{j}"] for j in range(nz)),
                       **{f: arrays[f] for f in _STATE_FIELDS})


def _lanes(single: bool):
    """(to lane-minor, back) for one lane or a batch-major batch."""
    if single:
        return (lambda t: t[..., None]), (lambda t: t[..., 0])
    return (lambda t: t.movedim(0, -1)), (lambda t: t.movedim(-1, 0))


def _serving_setup(problem: Problem, single: bool, x_measured, x_ref, u_ref, state_arrays):
    """The tick's lane-minor problem on the window and its shifted warm
    start (`mpc.mpc_step`'s first three steps)."""
    lanes, _ = _lanes(single)
    lane_problem = dataclasses.replace(
        update_tracking_window_lanes(problem, lanes(x_ref), lanes(u_ref)), x0=lanes(x_measured))
    return lane_problem, shift_trajectory_tiled(arrays_to_state(state_arrays).map(lanes))


def make_serving_fn(problem: Problem, opts: SolverOptions, batch: Optional[int],
                    graphs: Optional[SolveGraphs] = None):
    """The MPC tick as a plain-arrays function.

    (x_measured [B, n], x_ref [B, N+1, n], u_ref [B, N+1, m], state dict)
      -> (u0 [B, m], state' dict, stats dict)

    With batch=None the function is unbatched (one lane, no leading B
    axis). It runs `mpc.mpc_step`'s tick (slide the window, set the
    measured state, shift the warm start, solve) through graph_solve.py's
    solve: lane for lane the answers of `mpc.mpc_step` (batch=None) or of
    the vmapped solve (batch=B), the counterparts of JAX's `mpc_step` and
    `jax.vmap(mpc_step)`. graphs: the solve's setup and trip traced on
    these shapes (`graph_solve.trace_solve`), which `export_mpc_server`
    passes; without them the trips run as a Python loop.
    """
    if not isinstance(problem.cost, DiagonalCost):
        raise TypeError("make_serving_fn requires a DiagonalCost (the tracking window)")
    single = batch is None
    _, unlanes = _lanes(single)

    def serve(x_measured, x_ref, u_ref, state_arrays):
        lane_problem, shifted = _serving_setup(problem, single, x_measured, x_ref, u_ref,
                                               state_arrays)
        new_state, stats = graph_solve(lane_problem, shifted, opts, single=single,
                                       graphs=graphs)
        stats = {f.name: unlanes(getattr(stats, f.name)) for f in dataclasses.fields(SolveStats)}
        return unlanes(new_state.u[0]), state_to_arrays(new_state.map(unlanes)), stats

    return serve


def _example_args(problem: Problem, batch: Optional[int]):
    N, n, m = problem.N, problem.n, problem.m
    kw = dict(dtype=problem.dtype, device=problem.device)
    state = state_to_arrays(init_state(problem))
    x_measured = torch.zeros((n,), **kw)
    x_ref = torch.zeros((N + 1, n), **kw)
    u_ref = torch.zeros((N + 1, m), **kw)
    if batch is not None:
        def tile(a):
            return a.expand((batch,) + a.shape).contiguous()

        state = {k: tile(v) for k, v in state.items()}
        x_measured, x_ref, u_ref = tile(x_measured), tile(x_ref), tile(u_ref)
    return x_measured, x_ref, u_ref, state


class _Serving(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x_measured, x_ref, u_ref, state):
        return self.fn(x_measured, x_ref, u_ref, state)


class Exported:
    """A saved-or-loadable MPC tick: the `torch.export.ExportedProgram`
    (`program`), the devices it may run on (`platforms`, a tuple of
    "cuda" / "cpu") and its callable module per device, built once on the
    first call there (the program moved with `torch.export.passes.
    move_to_device_pass` when it was traced elsewhere)."""

    def __init__(self, program: torch.export.ExportedProgram, platforms: Sequence[str]):
        self.program = program
        self.platforms = tuple(platforms)
        self._modules = {}

    def module(self, device) -> torch.nn.Module:
        """The callable module for a device (torch.device or str)."""
        device = torch.device(device)
        if device.type not in self.platforms:
            raise ValueError(f"this artifact runs on {self.platforms}, not {device.type}")
        key = str(device)
        if key not in self._modules:
            program = self.program
            if _program_device(program) != device:
                from torch.export.passes import move_to_device_pass

                # the pass moves the program it is given: move a copy
                program = move_to_device_pass(copy.deepcopy(program), device)
            self._modules[key] = program.module()
        return self._modules[key]

    def call(self, x_measured, x_ref, u_ref, state):
        return self.module(x_measured.device)(x_measured, x_ref, u_ref, state)


def _program_device(program: torch.export.ExportedProgram) -> torch.device:
    """The device the program was traced on (its first tensor input's)."""
    for node in program.graph.nodes:
        if node.op == "placeholder" and "val" in node.meta and torch.is_tensor(node.meta["val"]):
            return node.meta["val"].device
    return torch.device("cpu")


def export_mpc_server(problem: Problem, opts: SolverOptions = SolverOptions(),
                      batch: Optional[int] = None,
                      platforms: Optional[Sequence[str]] = None) -> Exported:
    """Trace and export the MPC tick for the given platforms.

    platforms defaults to ("cuda", "cpu"): one artifact serves on the card
    and on the host. The problem (dynamics, horizon, constraints, Q, R) and
    the SolverOptions are frozen into the graph, as JAX bakes them in as
    compile-time constants. Tracing runs on the problem's device, from
    `init_state`-shaped example inputs. A configuration the graph does not
    carry, or (with "cuda" among the platforms) a kernel the options
    select that cannot take the problem, raises NotImplementedError
    naming it before anything is traced.
    """
    plats = tuple(platforms) if platforms is not None else _PLATFORMS
    unknown = [p for p in plats if p not in _PLATFORMS]
    if unknown:
        raise ValueError(f"export_mpc_server: unknown platforms {unknown} (it takes "
                         f"{_PLATFORMS})")
    check_options(opts)
    why = graph_refusal(problem, opts, single=batch is None, cuda="cuda" in plats)
    if why is not None:
        raise NotImplementedError(f"export_mpc_server: {why}")
    example = _example_args(problem, batch)
    # the nodes' Python stack traces are not kept (a fifth of the tracing
    # time), where this torch has the switch
    config = torch.fx.config
    keep = getattr(config, "do_not_emit_stack_traces", None)
    if keep is not None:
        config.do_not_emit_stack_traces = True
    try:
        # the solve's setup and one trip traced on the example's shapes,
        # then the tick around them
        lane_problem, shifted = _serving_setup(problem, batch is None, *example)
        graphs = trace_solve(lane_problem, shifted, opts, single=batch is None)
        module = _Serving(make_serving_fn(problem, opts, batch, graphs))
        program = torch.export.export(module, example, strict=False)
    finally:
        if keep is not None:
            config.do_not_emit_stack_traces = keep
    return Exported(program, plats)


def save_exported(exported: Exported, path: str) -> None:
    """Write the artifact as a `.pt2` file (`torch.export.save`), its
    platforms beside the program."""
    torch.export.save(exported.program, path,
                      extra_files={"platforms.json": json.dumps(list(exported.platforms))})


class _CachedHints:
    """`typing` with `get_type_hints` cached by class: torch's deserializer
    asks it again for every node's every field (most of a load's time);
    the hints of a schema class do not change."""

    def __init__(self, typing_module):
        self._typing = typing_module
        self._hints = {}

    def __getattr__(self, name):
        return getattr(self._typing, name)

    def get_type_hints(self, cls, globalns=None, **kw):
        key = (cls, id(globalns), tuple(sorted(kw.items())))
        if key not in self._hints:
            self._hints[key] = self._typing.get_type_hints(cls, globalns=globalns, **kw)
        return self._hints[key]


def load_exported(path: str) -> Exported:
    """Read an artifact that `save_exported` wrote (`torch.export.load`),
    with torch's deserializer's type hints cached for the call (the same
    program, several times faster to read)."""
    from torch._export.serde import serialize

    extra = {"platforms.json": ""}
    typing_module = getattr(serialize, "typing", None)
    if typing_module is not None:
        serialize.typing = _CachedHints(typing_module)
    try:
        program = torch.export.load(path, extra_files=extra)
    finally:
        if typing_module is not None:
            serialize.typing = typing_module
    return Exported(program, json.loads(extra["platforms.json"]))


def call_exported(exported: Exported, x_measured, x_ref, u_ref,
                  state: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One serving call on the inputs' device: returns (u0, carried state
    dict, stats dict)."""
    return exported.call(x_measured, x_ref, u_ref, state)
