"""Workload entry points.

stokes — operator-split Stokes + squirmer + transport, dense and scale regimes
navier_stokes — monolithic Stokes and operator-split Navier–Stokes
sweep — the squirmer-gait food-capture campaign
"""
