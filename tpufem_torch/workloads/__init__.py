"""Workload entry points.

poisson — steady Poisson (dense, or BiCGStab on the CSR surgery operator)
heat — implicit-Euler heat equation
advection_diffusion — advection–diffusion with point-source injection
graph_average — the graph-Laplacian averaging prototype
stam_grid — the structured-grid "stable fluids" solver
stokes — operator-split Stokes + squirmer + transport, dense and scale regimes
navier_stokes — monolithic Stokes, the dense Taylor–Hood solvers and
    operator-split Navier–Stokes
th_sparse — the sparse and grid Taylor–Hood engines (they refuse: not ported)
sweep — the squirmer-gait food-capture campaign
"""
