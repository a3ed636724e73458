"""Workload entry points.

stokes — operator-split Stokes + squirmer + transport, dense regime
"""
