"""The forced Navier–Stokes box (``"workload": "ns"``): the annulus mesh,
``tpufem_torch.workloads.navier_stokes`` on its grid path under test, the
plain reference of ``reference/ns.py``, and the numbers a frame is judged
by (see ``steppers``).

A state is {"u": (N, 2), "p": (N,)}: the velocity, and the pressure the
next step's solve starts from.  The pressure is a warm start only (the
next step's answer does not depend on it beyond the solves' tolerance), so
a frame of ``u`` is a state the benchmark knows whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import mesh as ref_mesh
from portbench.reference import ns as ref_ns
from portbench.steppers import Altered

# Velocity gaps are judged against the change the reference makes over a
# unit, but never against less than this share of the unit's first largest
# node speed |u|: the box has no boundary speed, its flow decays, and sound
# float32 solves, which stop at their tolerance, still part from the
# reference by a tolerance's worth.
U_FLOOR = 0.01
# The fault "an answer altered where it is produced": half the starts'
# largest node speed (traffic ``velocity.peak``, 0.01), at one node.
ALTER = 0.005


def mesh(config: dict):
    """(coords, tris, markers): the configuration's annulus, from the
    benchmark's frozen generator."""
    return ref_mesh.annulus(**config["mesh"])


def velocity(coords, zero, spec: dict, rng) -> np.ndarray:
    """(N, 2) float64: Σ over the ``modes`` (kx, ky) of
    sin(π·kx·x/L)·sin(π·ky·y/H) with a seeded weight in [−1, 1] for each
    mode and component, scaled so that the largest node speed is ``peak``;
    0 where ``zero`` (walls, ring, inert nodes), as the step leaves it."""
    x, y = coords[:, 0] / spec["L"], coords[:, 1] / spec["H"]
    u = np.zeros((len(coords), 2))
    for kx, ky in spec["modes"]:
        w = rng.uniform(-1.0, 1.0, size=2)
        shape = np.sin(np.pi * kx * x) * np.sin(np.pi * ky * y)
        u += shape[:, None] * w[None, :]
    u[zero] = 0.0
    speed = np.max(np.hypot(u[:, 0], u[:, 1]))
    return u * (spec["peak"] / speed) if speed > 0 else u


def starts(mesh, config: dict, traffic: dict, seed: int) -> list[dict]:
    """The traffic's ``starts`` seeded disturbances: [{"u": (N, 2)}]."""
    coords, tris, markers = mesh
    fields = config["ns"]
    zero = ref_ns.zero_nodes(coords, tris, markers, fields)
    spec = dict(traffic["velocity"], L=fields["L"], H=fields["H"])
    return [{"u": velocity(coords, zero, spec, np.random.default_rng([seed % 2**63, k]))}
            for k in range(int(traffic["starts"]))]


def counts(mesh, config: dict) -> dict:
    """No per-layer metric of this workload reads operation or byte counts
    yet (K4's roofline waits for its iteration count to be read)."""
    return {}


def ns_fields(config: dict) -> dict:
    """The configuration file's ``NSConfig`` fields, lists made tuples."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in config["ns"].items()}


def reference(mesh, config: dict, device, dtype=torch.float64, strict: bool = True):
    """The plain reference on the mesh arrays, assembled in float64 and
    stepped in ``dtype``; not ``strict``, its solves stop at the
    configuration's iteration caps with their best iterates."""
    pb = ref_ns.build(*mesh, config["ns"], dtype=torch.float64, device=device)
    if strict:
        return ref_ns.NS(pb)
    caps = (config["ns"]["cg_iters_visc"], config["ns"]["cg_iters_pressure"])
    return ref_ns.NS(pb.to(dtype), max_iters=caps, strict=False)


class Program:
    """``tpufem_torch``: ``NSProblem.build`` on the benchmark's mesh arrays,
    ``navier_stokes.run`` for the steps, on the grid path (K4, the C(u)
    refill, K3).  On a CPU device, where no kernel runs, the storage
    ``"auto"`` takes the kernels' plain versions (``"grid_interpret"``).
    ``count_iters`` gives K3 and K4 iteration counters (``iters_count``):
    ``counter`` is K3's, ``k4_counter`` K4's."""

    def __init__(self, mesh, config: dict, device, count_iters: bool = False):
        from tpufem_torch.mesh import mesh_from_arrays
        from tpufem_torch.metrics import to_host
        from tpufem_torch.workloads import navier_stokes

        self._ns, self._to_host = navier_stokes, to_host
        device = torch.device(device)
        fields = ns_fields(config)
        if device.type == "cuda":
            from tpufem_torch.solve import grid_cg

            grid_cg.build()  # the one library the step launches, from the build cache
        elif fields["cg_storage"] == "auto":
            fields["cg_storage"] = "grid_interpret"
        m = mesh_from_arrays(*mesh)
        problem = navier_stokes.NSProblem.build(m, navier_stokes.NSConfig(**fields), device=device)
        if problem.grid_refill is None:
            raise RuntimeError("the NS problem did not take the grid path (K4, the C(u) "
                               "refill, K3); this workload measures that path alone")
        self.counter = self.k4_counter = None
        if count_iters:
            self.counter = torch.zeros(1, dtype=torch.int32, device=device)
            self.k4_counter = torch.zeros(1, dtype=torch.int32, device=device)
            problem = dataclasses.replace(
                problem,
                pressure_solver=dataclasses.replace(problem.pressure_solver,
                                                    iters_count=self.counter),
                vel_solver_grid=dataclasses.replace(problem.vel_solver_grid,
                                                    iters_count=self.k4_counter))
        self.problem = problem
        self.dtype, self.device = problem.dtype, problem.device
        # what ``convection`` needs, kept past ``close`` for the comparison
        self._refill, self._mesh = problem.grid_refill, problem.mesh

    def start(self, u) -> dict:
        return {"u": u.clone(), "p": torch.zeros(len(u), dtype=self.dtype, device=self.device)}

    def advance(self, state, steps: int):
        _, metrics, (u, p) = self._ns.run(self.problem, steps=steps,
                                          state=(state["u"], state["p"]), return_state=True)
        return {"u": u, "p": p}, metrics

    def frame(self, state, field: str) -> np.ndarray:
        return self._to_host(state[field])

    def convection(self, u) -> torch.Tensor:
        """C(u)·u, (N, 2) in the program's dtype, with C(u) built as the
        grid step builds it: the "opsplit" element values
        (``assembly.element_convection_flat``) refilled onto the velocity
        planes (``GridRefill.refill_flat``), applied to each column."""
        from tpufem_torch.ops import assembly

        u = u.to(device=self.device, dtype=self.dtype)
        C = self._refill.refill_flat(assembly.element_convection_flat(self._mesh, u, "opsplit"))
        return torch.stack([C.matvec(u[:, 0].contiguous()), C.matvec(u[:, 1].contiguous())], dim=1)

    def close(self) -> None:
        self.problem = None


class Control:
    """The precision control: the plain reference in the program's place, in
    ``dtype``, one step below the configuration's float32.  A solve that
    cannot reach its tolerance in ``dtype`` stops at the configuration's
    iteration cap (``cg_iters_visc``, ``cg_iters_pressure``) with its best
    iterate, as a capped solve in the program does."""

    def __init__(self, mesh, config: dict, device, dtype=torch.bfloat16):
        self.ref = reference(mesh, config, device, dtype, strict=False)
        self._convection = self.ref.convection  # kept past ``close`` for the comparison
        self.dtype, self.device = dtype, torch.device(device)
        self.counter = None

    def start(self, u) -> dict:
        return self.ref.start(u)

    def advance(self, state, steps: int):
        return self.ref.advance(state, steps), {}

    def frame(self, state, field: str) -> np.ndarray:
        return state[field].float().cpu().numpy()

    def convection(self, u) -> torch.Tensor:
        """C(u)·u of the reference in ``dtype``."""
        u = u.to(device=self.device, dtype=self.dtype)
        return self._convection(u) @ u

    def close(self) -> None:
        self.ref = None


def _speed(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=1)


def _innermost(stepper):
    """The program or control inside the faults of ``steppers`` that wrap it."""
    while hasattr(stepper, "inner"):
        stepper = stepper.inner
    return stepper


def compare(reference, first: dict, state: dict, field: str, mine, metrics, stepper) -> dict:
    """The numbers of one frame: the program's ``mine`` (host array of ``u``)
    against the reference's ``state``, which it reached from ``first``.

    * ``u_err``: the largest velocity gap |Δu| at a node over the largest
      change |Δu| the reference makes at a node over the unit (a step that
      does nothing reads 1), that change taken as at least ``U_FLOOR`` of
      the unit's first largest node speed.
    * ``c_err``: the advection C(u)·u at the unit's first state u, the
      stepper's (``convection``) against the reference's: the largest gap
      at a node over the reference's largest |C(u)·u| at a node.  At
      these widths Δt·C(u)·u is some five orders of magnitude below what
      ``u_err`` resolves (C scales with the lumped mass, ~h²), so ``u_err``
      alone cannot see C(u).
    """
    ours = torch.as_tensor(np.asarray(mine, dtype=np.float64), device=state[field].device)
    if not bool(torch.all(torch.isfinite(ours))):
        return {"u_err": float("inf"), "c_err": float("inf")}
    gap = float(torch.max(_speed(ours - state["u"])))
    change = float(torch.max(_speed(state["u"] - first["u"])))
    floor = U_FLOOR * float(torch.max(_speed(first["u"])))
    u0 = first["u"]
    c_ref = reference.convection(u0) @ u0
    c_ours = _innermost(stepper).convection(u0).to(device=c_ref.device, dtype=c_ref.dtype)
    c_gap = float(torch.max(_speed(c_ours - c_ref)))
    c_size = float(torch.max(_speed(c_ref)))
    return {"u_err": gap / max(change, floor), "u_gap": gap, "u_change": change,
            "c_err": c_gap / max(c_size, np.finfo(np.float64).tiny), "c_gap": c_gap}


def altered_answer(inner, mesh, field: str):
    """The fault "an answer altered where it is produced": the velocity off
    by ``ALTER`` at one unmarked node."""
    interior = np.nonzero(np.asarray(mesh[2]) == 0)[0]
    return Altered(inner, field, int(interior[len(interior) // 2]), ALTER)
