"""Diagnostics: preflight mesh checks, operator verification, run guards.

The PyTorch counterpart of ``tpufem.diag``: the reference's "Tests A–J"
(the reference project's ``scripts/stokes_report.py:343-808``), its preflight
mesh-quality, CFL and orientation checks (``:856-895``), the eigenvalue
sanity check (``:950-958``) and the per-step divergence and NaN blow-up
guards, as functions that return numbers a test can hold to a gate.

The analytic-field tests build float64 fields on ``device`` (default the
card, see :func:`tpufem_torch.config.device`); their random fields come from
``np.random.default_rng(seed)`` as in tpufem, so both packages see the same
inputs.  A test returns a 0-d tensor on ``device`` where tpufem returns a
device array, and a Python number where tpufem does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch import bc
from tpufem_torch import config as tconfig
from tpufem_torch.mesh.core import Mesh
from tpufem_torch.ops import assembly, calculus

F64 = torch.float64


# ---------------------------------------------------------------------------
# Preflight checks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeshQualityReport:
    min_area: float
    max_area: float
    avg_area: float
    min_edge: float
    n_degenerate: int
    n_cw: int  # clockwise-oriented (negative signed det) triangles
    ok: bool

    def viscous_cfl_dt(self, nu: float) -> float:
        """Advisory stable dt ≈ min_edge² / (4ν) (stokes_report.py:874-878)."""
        return self.min_edge**2 / (4.0 * nu) if nu > 0 else float("inf")


def preflight(mesh: Mesh, area_warn: float = 1e-10) -> MeshQualityReport:
    """Mesh quality and orientation census (stokes_report.py:856-895), on
    the host."""
    pc = mesh.coords[mesh.tris]
    e01 = np.linalg.norm(pc[:, 0] - pc[:, 1], axis=1)
    e12 = np.linalg.norm(pc[:, 1] - pc[:, 2], axis=1)
    e20 = np.linalg.norm(pc[:, 2] - pc[:, 0], axis=1)
    min_edge = float(np.min([e01.min(), e12.min(), e20.min()]))
    n_cw = int(np.sum(mesh.det < 0))
    n_deg = int(np.sum(~mesh.valid))
    return MeshQualityReport(
        min_area=float(mesh.area.min()),
        max_area=float(mesh.area.max()),
        avg_area=float(mesh.area.mean()),
        min_edge=min_edge,
        n_degenerate=n_deg,
        n_cw=n_cw,
        ok=bool(mesh.area.min() > area_warn) and n_deg == 0,
    )


def pressure_matrix_eigen_check(A, n_negative_tol: int = 1):
    """Eigenvalue sign census of the pressure operator ``A`` (a tensor, on
    its device, or a host array) (stokes_report.py:950-958).  Returns
    (min_eig, max_eig, n_negative)."""
    A = torch.as_tensor(A)
    eig = torch.linalg.eigvalsh(0.5 * (A + A.T))
    return float(eig.min()), float(eig.max()), int((eig < -1e-10).sum())


# ---------------------------------------------------------------------------
# Operator verification (the reference's analytic-field tests)
# ---------------------------------------------------------------------------


def _coords(mesh: Mesh, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(mesh.coords, dtype=F64, device=dev)


def _stiffness(mesh: Mesh, dev: torch.device) -> torch.Tensor:
    """The dense (N, N) P1 stiffness on ``dev``."""
    return assembly.assemble_dense(mesh, assembly.element_stiffness(mesh, device=dev))


def _correlation(a: torch.Tensor, b: torch.Tensor, mesh: Mesh) -> float:
    """Pearson correlation of two nodal fields over the interior nodes, on
    the host."""
    interior = np.asarray(mesh.markers) == 0
    a = a.detach().cpu().numpy()[interior]
    b = b.detach().cpu().numpy()[interior]
    return float(np.corrcoef(a, b)[0, 1])


def gradient_test(mesh: Mesh, device=None) -> torch.Tensor:
    """Test: p = 2x + 3y ⇒ ∇p = (2, 3) (stokes_report.py:388-407).
    Returns the mean nodal gradient (should be ≈ (2, 3))."""
    coords = _coords(mesh, tconfig.device(device))
    p = 2.0 * coords[:, 0] + 3.0 * coords[:, 1]
    return calculus.gradient(mesh, p).mean(dim=0)


def divergence_test(mesh: Mesh, device=None) -> torch.Tensor:
    """Test: u = (2x, 3y) ⇒ div u = 5 (stokes_report.py:410-431).
    Returns the mean nodal divergence (should be ≈ 5)."""
    coords = _coords(mesh, tconfig.device(device))
    u = torch.stack([2.0 * coords[:, 0], 3.0 * coords[:, 1]], dim=1)
    return calculus.divergence(mesh, u).mean()


def adjointness_test(mesh: Mesh, seed: int = 0, device=None) -> torch.Tensor:
    """⟨∇p, u⟩_M ≈ −⟨p, ∇·u⟩_M with lumped-mass inner products on random
    fields zeroed on the boundary (stokes_report.py:532-591).
    Returns the relative mismatch."""
    dev = tconfig.device(device)
    rng = np.random.default_rng(seed)
    n = mesh.n_nodes
    boundary = mesh.markers != 0
    p = rng.standard_normal(n)
    u = rng.standard_normal((n, 2))
    p[boundary] = 0.0
    u[boundary] = 0.0
    p = torch.as_tensor(p, device=dev)
    u = torch.as_tensor(u, device=dev)
    mass = assembly.lumped_mass(mesh, device=dev)
    g = calculus.gradient(mesh, p)
    d = calculus.divergence(mesh, u)
    lhs = torch.sum(mass * torch.sum(g * u, dim=1))
    rhs = -torch.sum(mass * p * d)
    return torch.abs(lhs - rhs) / (torch.abs(rhs) + 1e-30)


def laplacian_vs_divgrad_test(mesh: Mesh, sigma: float = 0.1, device=None) -> float:
    """Pearson correlation between K p (FEM Laplacian, mass-normalized) and
    −div(grad p) on a Gaussian blob (stokes_report.py:482-529)."""
    dev = tconfig.device(device)
    coords = mesh.coords
    p = np.exp(-((coords[:, 0] - 0.5) ** 2 + (coords[:, 1] - 0.5) ** 2) / (2 * sigma**2))
    p = torch.as_tensor(p, device=dev)
    mass = assembly.lumped_mass(mesh, device=dev)
    lap_fem = (_stiffness(mesh, dev) @ p) / (mass + 1e-12)  # K p / M_L ≈ −∇²p
    lap_composed = -calculus.divergence(mesh, calculus.gradient(mesh, p))  # ≈ −∇²p
    return _correlation(lap_fem, lap_composed, mesh)


def checkerboard_field(mesh: Mesh, seed: int = 0) -> np.ndarray:
    """A ±1 'checkerboard' nodal field (random-sign proxy, like the
    reference's probes: no structured 2-colouring exists on an unstructured
    mesh)."""
    rng = np.random.default_rng(seed)
    return np.where(rng.integers(0, 2, mesh.n_nodes) > 0, 1.0, -1.0)


def checkerboard_response(mesh: Mesh, device=None) -> torch.Tensor:
    """LBB probe: lumped divergence magnitude of a ±1 checkerboard velocity
    (stokes_report.py:343-385).  A near-zero response means the projection
    is blind to this mode (the reference's known accuracy limiter)."""
    sign = checkerboard_field(mesh)
    u = torch.as_tensor(np.stack([sign, -sign], axis=1), device=tconfig.device(device))
    return calculus.divergence(mesh, u).abs().max()


def laplacian_blind_spot_test(mesh: Mesh, device=None) -> torch.Tensor:
    """Response norm of the pressure Laplacian to a checkerboard pressure
    (stokes_report.py:593-637): ‖K c‖ / ‖c‖.  A near-zero response means
    that mode lies in the operator's numerical nullspace."""
    dev = tconfig.device(device)
    c = torch.as_tensor(checkerboard_field(mesh), device=dev)
    return torch.linalg.norm(_stiffness(mesh, dev) @ c) / torch.linalg.norm(c)


def gradient_of_checkerboard_test(mesh: Mesh, device=None) -> torch.Tensor:
    """Mean magnitude of the lumped gradient of a checkerboard pressure
    (stokes_report.py:639-673): ≈ 0 would mean the velocity correction
    cannot see checkerboard pressure."""
    c = torch.as_tensor(checkerboard_field(mesh), device=tconfig.device(device))
    return torch.linalg.norm(calculus.gradient(mesh, c), dim=1).mean()


def projection_consistency_test(mesh: Mesh, seed: int = 0, device=None) -> float:
    """Correlation between the lumped-divergence RHS and the consistent
    (weak) RHS −∫∇φ·u on a random velocity (stokes_report.py:434-479)."""
    dev = tconfig.device(device)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.standard_normal((mesh.n_nodes, 2)), device=dev)
    lumped_rhs = calculus.divergence(mesh, u) * assembly.lumped_mass(mesh, device=dev)
    consistent_rhs = calculus.consistent_divergence_rhs(mesh, u)
    return _correlation(lumped_rhs, consistent_rhs, mesh)


def rhs_handling_test(mesh: Mesh, value: float = 1.5, device=None) -> float:
    """The reference's Test H (stokes_report.py:675-734): write the target
    values into the RHS of the identity-row system and solve.  Returns the
    max deviation of the solution's boundary values from the target
    (should be exactly 0)."""
    from tpufem_torch.solve import make_dense_solver

    dev = tconfig.device(device)
    boundary = bc.ChannelBoundary.build(mesh)
    K = _stiffness(mesh, torch.device("cpu")).numpy()
    A = bc.dirichlet_rows_cols(np.eye(mesh.n_nodes) + 0.01 * K, boundary.dirichlet)
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal(mesh.n_nodes)
    rhs[boundary.dirichlet] = value
    x = make_dense_solver(A, "lu", device=dev).solve(torch.as_tensor(rhs, device=dev))
    idx = torch.as_tensor(boundary.dirichlet, dtype=torch.int64, device=dev)
    return float((x[idx] - value).abs().max())


def single_step_diagnostics(problem, u0=None) -> dict:
    """One projection step broken into stages with per-stage divergence:
    the reference's u*/pressure single-step diagnostics
    (stokes_report.py:736-808).  ``problem`` is a Stokes problem; its
    solvers run on its device (on the grid storage on the card: one K2 and
    one K3 launch).  Returns a dict of stage observables."""
    from tpufem_torch.workloads import stokes

    if u0 is None:
        u0 = stokes.initial_state(problem)["u"]
    dt = problem.config.dt
    u_star = stokes.apply_field_bcs(problem, problem.visc_solver.solve(u0))
    div_star = problem.div(u_star)
    p = problem.pressure_solver.solve(-div_star / dt)
    u1 = u_star - dt * problem.grad(p)
    return {
        "max_u_star": float(u_star.abs().max()),
        "div_star_max": float(div_star.abs().max()),
        "max_p": float(p.abs().max()),
        "div_after_max": float(problem.div(u1).abs().max()),
    }


def projection_reduces_divergence(step_results: dict) -> bool:
    """Single-step projection oracle (scripts/test2.py, final_test.py):
    after a projection step the divergence must drop substantially."""
    return step_results["final_div"] < 0.5 * step_results["initial_div"]


# ---------------------------------------------------------------------------
# Run-time guards (the numerical "sanitizers")
# ---------------------------------------------------------------------------


def blowup_guard(u: torch.Tensor, max_mag: float = 1e3) -> torch.Tensor:
    """True (a 0-d bool tensor) if the field is finite and bounded: the
    functional form of the reference's printed Max-U / Final-Div watching."""
    return torch.isfinite(u).all() & (u.abs().max() < max_mag)


def run_guarded(problem, total_steps: int, chunk: int = 100, max_mag: float = 1e3,
                max_div: float | None = None, state: dict | None = None):
    """Failure-detecting runner: run a Stokes problem in chunks, abort on
    blow-up.  Refuses a chunk whose end state is non-finite or unbounded,
    or (optionally) whose divergence exceeds ``max_div``, and returns the
    last good state.  Reads one flag (and with ``max_div`` one number) back
    from the device a chunk.

    Returns (state, report) with report = {status, completed_steps, reason}."""
    from tpufem_torch.workloads import stokes

    if state is None:
        state = stokes.initial_state(problem)
    done = 0
    while done < total_steps:
        c = min(chunk, total_steps - done)
        new_state, metrics = stokes.run(problem, steps=c, state=state)
        reason = None
        if not bool(blowup_guard(new_state["u"], max_mag)):
            reason = f"velocity non-finite or |u| ≥ {max_mag}"
        elif max_div is not None:
            worst = float(metrics["final_div_max"].max())
            if not np.isfinite(worst) or worst > max_div:
                reason = f"divergence {worst:.3e} > {max_div:.3e}"
        if reason is not None:
            return state, {"status": "aborted", "completed_steps": done, "reason": reason}
        state = new_state
        done += c
    return state, {"status": "ok", "completed_steps": done, "reason": None}
