"""The squirmer Stokes workload (``"workload": "stokes"``): the annulus
mesh, ``tpufem_torch.workloads.stokes`` under test, the plain reference of
``reference/``, and the numbers a frame is judged by (see ``steppers``).

``Program`` is the only code of the benchmark that imports
``tpufem_torch``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import starts as traffic_starts, yardstick
from portbench.steppers import Altered
from portbench.reference import advect, fem
from portbench.reference import mesh as ref_mesh
from portbench.reference import step as ref_step


# Velocity gaps are judged against the change the reference makes over a
# unit, but never against less than this share of the largest velocity
# component on the squirmer's ring: near a fixed point that change tends to
# 0, while sound float32 solves, which stop at their tolerance, still part
# from the reference by a tolerance's worth.
U_FLOOR = 0.01


def mesh(config: dict):
    """(coords, tris, markers): the configuration's annulus, from the
    benchmark's frozen generator."""
    return ref_mesh.annulus(**config["mesh"])


def starts(mesh, config: dict, traffic: dict, seed: int) -> list[dict]:
    return traffic_starts.make(mesh, config["stokes"], traffic, seed)


def counts(mesh, config: dict) -> dict:
    return yardstick.for_mesh(mesh, config["stokes"])


def stokes_fields(config: dict) -> dict:
    """The configuration file's ``StokesConfig`` fields, lists made tuples."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in config["stokes"].items()}


def reference(mesh, config: dict, device, dtype=torch.float64, strict: bool = True):
    """The plain reference of the configuration on the mesh arrays, its
    operators assembled in float64 and its steps taken in ``dtype``; not
    ``strict``, its solves stop at the configuration's iteration caps."""
    coords, tris, markers = mesh
    fields = stokes_fields(config)
    pb = fem.build(coords, tris, markers, fields, dtype=torch.float64, device=device)
    loc = None
    if fields["transport"] == "dye":
        loc = advect.Locator(coords, tris, pb.tri_valid, dtype=dtype, device=device)
    if strict:
        return ref_step.Stokes(pb, locator=loc)
    caps = (fields["cg_iters_visc"], fields["cg_iters_pressure"])
    return ref_step.Stokes(pb.to(dtype), locator=loc, max_iters=caps, strict=False)


class Program:
    """``tpufem_torch``: ``StokesProblem.build`` on the benchmark's mesh
    arrays, ``stokes.run`` for the steps.  ``count_iters`` gives the
    pressure solver an iteration counter (``iters_count``)."""

    def __init__(self, mesh, config: dict, device, count_iters: bool = False):
        from tpufem_torch.mesh import mesh_from_arrays
        from tpufem_torch.metrics import to_host
        from tpufem_torch.workloads import stokes

        self._stokes, self._to_host = stokes, to_host
        device = torch.device(device)
        if device.type == "cuda":
            from tpufem_torch.solve import grid_cg

            grid_cg.build()  # the one library the step launches, from the build cache
        coords, tris, markers = mesh
        fields = stokes_fields(config)
        m = mesh_from_arrays(coords, tris, markers, holes=np.asarray([fields["center"]]))
        problem = stokes.StokesProblem.build(m, stokes.StokesConfig(**fields), device=device)
        self.counter = None
        if count_iters and hasattr(problem.pressure_solver, "iters_count"):
            self.counter = torch.zeros(1, dtype=torch.int32, device=device)
            problem = dataclasses.replace(problem, pressure_solver=dataclasses.replace(
                problem.pressure_solver, iters_count=self.counter))
        self.problem = problem
        self.dtype, self.device = problem.dtype, problem.device

    def start(self, u, c=None) -> dict:
        state = self._stokes.initial_state(self.problem)
        state["u"] = u.clone()
        if "ustar_warm" in state:
            state["ustar_warm"] = state["u"]
        if c is not None:
            state["c"] = c.clone()
        return state

    def advance(self, state, steps: int):
        return self._stokes.run(self.problem, steps=steps, state=state)

    def frame(self, state, field: str) -> np.ndarray:
        return self._to_host(state[field])

    @staticmethod
    def mixing_var(metrics):
        return metrics["mixing_var"][-1]

    def close(self) -> None:
        self.problem = None


class Control:
    """The precision control: the plain reference in the program's place, in
    ``dtype``, one step below the configuration's float32.  A solve
    that cannot reach its tolerance in ``dtype`` stops at the configuration's
    iteration cap (``cg_iters_visc``, ``cg_iters_pressure``) with its best
    iterate, as a capped solve in the program does."""

    def __init__(self, mesh, config: dict, device, dtype=torch.bfloat16):
        self.ref = reference(mesh, config, device, dtype, strict=False)
        self.dtype, self.device = dtype, torch.device(device)
        self.counter = None

    def start(self, u, c=None) -> dict:
        return self.ref.start(u, c)

    def advance(self, state, steps: int):
        state = self.ref.advance(state, steps)
        metrics = {"mixing_var": self.ref.mixing_var(state["c"])} if "c" in state else {}
        return state, metrics

    def frame(self, state, field: str) -> np.ndarray:
        return state[field].float().cpu().numpy()

    @staticmethod
    def mixing_var(metrics):
        return metrics["mixing_var"]

    def close(self) -> None:
        self.ref = None




def compare(reference, first: dict, state: dict, field: str, mine, metrics, stepper) -> dict:
    """The numbers of one frame: the program's ``mine`` (host array of
    ``field``) against the reference's ``state``, which it reached from
    ``first``; ``metrics``, the program's, with its mixing variance.

    * ``u_err``: the largest velocity gap at a node over the largest change
      the reference makes over the unit (a step that does nothing reads 1),
      that change taken as at least ``U_FLOOR`` of the ring's largest
      boundary velocity component;
    * ``c_err``: the largest dye gap at a node (c in [0, 1]);
    * ``mix_err``: the gap in the dye's mixing variance, as a share of the
      reference's.
    """
    ours = torch.as_tensor(np.asarray(mine, dtype=np.float64), device=state[field].device)
    gap = float(torch.max(torch.abs(ours - state[field]))) if bool(
        torch.all(torch.isfinite(ours))) else float("inf")
    out = {}
    if field == "u":
        floor = U_FLOOR * float(torch.max(torch.abs(reference.pb.inner_values)))
        change = float(torch.max(torch.abs(state["u"] - first["u"])))
        out.update(u_err=gap / max(change, floor), u_gap=gap, u_change=change)
    else:
        out[f"{field}_err"] = gap
    if metrics and "mixing_var" in metrics:
        ref_var = float(reference.mixing_var(state["c"]))
        out["mix_err"] = abs(float(stepper.mixing_var(metrics)) - ref_var) / ref_var
    return out


def altered_answer(inner, mesh, field: str):
    """The fault "an answer altered where it is produced": the watched field
    off at one unmarked node, by 0.5 (a velocity; the boundary speed is 2)
    or by 0.05 (the dye)."""
    interior = np.nonzero(np.asarray(mesh[2]) == 0)[0]
    return Altered(inner, field, int(interior[len(interior) // 2]), 0.5 if field == "u" else 0.05)
