"""Space-sharded matrix-free Stokes step: one large mesh over a device mesh.

The counterpart of ``tpufem.parallel.stokes_sharded`` on its grid branch:

* viscous and pressure solves: the row-strip sharded grid solvers
  (:mod:`tpufem_torch.parallel.grid_sharded`), halos by ``torch.cat`` or
  by kernel K6;
* divergence and gradient: element slabs, one per shard, whose partial
  nodal sums are ``psum``'d;
* the BC field surgery (``workloads.stokes.apply_field_bcs``): replicated
  O(N) work, on shard 0's device, where the problem lives.

Physics as ``workloads.stokes.projection_step`` with the solves from zero
(the color variant, merged periodic pressure, double projection).  tpufem's
banded and stencil branches wait for those storages (ROADMAP Queue 1 item
5); any storage other than the grid is refused.
"""

from __future__ import annotations

import torch

from tpufem_torch.parallel.grid_sharded import make_sharded_grid_solvers
from tpufem_torch.parallel.spmd import _div_local, _grad_local, _shard_elements, psum
from tpufem_torch.solve.grid_cg import ViscousGridCG
from tpufem_torch.workloads import stokes


def make_sharded_matfree_step(device_mesh, problem, axis: str = "space",
                              halo: str = "ppermute"):
    """The step ``u → (u', metrics)`` sharded over ``axis``.

    ``problem`` must be built with ``solver="cg"`` and grid storage
    (``cg_storage="grid"`` or ``"grid_interpret"``), on the device of the
    axis's first shard.  ``halo`` is passed to
    :func:`~tpufem_torch.parallel.grid_sharded.make_sharded_grid_solvers`
    (``"rdma"``: kernel K6 on every halo of the solves); tpufem's step keeps
    that function's default, which is this one's."""
    if not isinstance(problem.visc_solver, ViscousGridCG):
        raise NotImplementedError(
            "the sharded step runs on grid storage (cg_storage='grid' or 'grid_interpret'); "
            "its banded and stencil forms are not ported to tpufem_torch yet "
            "(ROADMAP Queue 1 item 5)")
    devices = device_mesh.axis_devices(axis)
    if problem.device != devices[0]:
        raise ValueError(f"the problem lives on {problem.device}, the first {axis!r} shard on "
                         f"{devices[0]}")
    cfg = problem.config
    dt = cfg.dt
    n = problem.mesh.n_nodes
    dtype = problem.dtype
    visc_solve, press_solve = make_sharded_grid_solvers(device_mesh, problem, axis=axis,
                                                        halo=halo)

    s = len(devices)
    tris, grads, area, valid = _shard_elements(problem.mesh, s)
    tl = tris.shape[0] // s
    slabs = [
        (torch.as_tensor(tris[i * tl:(i + 1) * tl], dtype=torch.int64, device=dev),
         torch.as_tensor(grads[i * tl:(i + 1) * tl], dtype=dtype, device=dev),
         torch.as_tensor(area[i * tl:(i + 1) * tl], dtype=dtype, device=dev),
         torch.as_tensor(valid[i * tl:(i + 1) * tl], device=dev))
        for i, dev in enumerate(devices)
    ]

    def lumped(local, field):
        parts = [local(*slab, field.to(dev)[None], n) for slab, dev in zip(slabs, devices)]
        num = psum([p[0][0] for p in parts])[0]
        den = psum([p[1] for p in parts])[0]
        return num, den

    def div(u):
        num, den = lumped(_div_local, u)
        return num / (den + 1e-12)

    def grad(p):
        num, den = lumped(_grad_local, p)
        return num / (den + 1e-12)[:, None]

    # the 0/1 interior indicator (stokes.projection_step's second projection)
    imask = problem.visc_solver.interior_mask

    def step(u):
        rhs = u + dt * problem.body_force
        u_star = stokes.apply_field_bcs(problem, visc_solve(rhs))
        div_star = div(u_star)
        p = press_solve(-div_star / dt)
        u_new = stokes.apply_field_bcs(problem, u_star - dt * grad(p))
        if cfg.double_projection:
            p2 = press_solve(-div(u_new) / dt)
            u_new = u_new - dt * grad(p2) * imask[:, None]
        final_div = div(u_new)
        metrics = {
            "div_star_max": torch.max(torch.abs(div_star)),
            "final_div_max": torch.max(torch.abs(final_div)),
            "max_u": torch.max(torch.abs(u_new)),
        }
        return u_new, metrics

    return step
