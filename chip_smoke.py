"""Smoke test of the PyTorch/CUDA port (``tpufem_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and the CUDA toolkit (``nvcc``); it imports no JAX.  Phases:

1. device: the card's name and power limit; TF32 off;
2. build: kernels K1 (``tpufem_torch/csrc/fused_step_matvec.cu``),
   K2/K3/K4 (``tpufem_torch/csrc/grid_cg.cu``), K5
   (``tpufem_torch/csrc/grid_step.cu``) and K6
   (``tpufem_torch/csrc/halo_rdma.cu``), one nvcc for each source, started
   together; K1's build report;
3. K1 against its plain version (``torch.addmv``) on the card, f32 and f64,
   at 2N = 1704 (the bench mesh), 700 (off the TPU's 128/256 tiles) and 6200 (near the top
   of the dense regime), with µs per call of both, and the kernel's
   scalar-tail and unstaged-x paths at three non-square shapes;
4. the main path: the bench configuration (squirmer Stokes, fused f32
   step on K1, ~10k tracers) for 1000 steps, twice, through
   ``StokesProblem.build`` and ``stokes.run``; K1 must do every step;
5. the card against the port's CPU path at f64 over 50 steps, and the f32
   card run against the f64 one;
6. semi-Lagrangian dye on the fused f32 path for 200 steps;
7. the K2/K3 build report: seconds, registers and spills per instance, and
   for each instance its registers, spill stores, shared memory and blocks
   per SM (K2's f32 instances for an iteration that streams from HBM and
   for one that fits in L2);
8. K2 and K3 against their plain versions on the card: f32 and f64 (and a
   bf16 coarse inverse for K3), fixed iterations and ``tol=1e-5`` from a
   warm start, at ``n_side=20`` (ragged 3×3 coarse blocks) and on the
   1,048,576-node operators of phase 9; rel L2, iterations and ms per solve
   of both, and two launches bit-equal; then ms an iteration of K2 and K3
   (f32) against the iteration's byte bound on the card's split of phase
   9's operators (``GridOperator.dense_split``) and on tpufem's split (26
   pressure planes), built beside it;
9. the scale main path: ``bench_large.bench_config`` on
   ``generate_annulus_mesh(1024, 1088, pad_hole=True)`` (1,048,576 nodes,
   f32, two-level, tol 1e-5, bf16 coarse) through ``StokesProblem.build``
   and ``stokes.run``: 200 steps from rest, then 200 steps of steady
   continuation, div/grad on the stencil between the kernels; K2 must run
   once a step and K3 twice; tpufem's physics gates; the operators' plane
   and remainder counts;
10. the grid path at f64 on the card (kernels) against the port's CPU path
    (plain versions) at ``n_side=40`` over 10 steps, fixed iterations and
    then tol 1e-5 with warm starts; f32 on the card against f64;
11. tracers on the scale path at 78,400 nodes for 200 steps;
12. the K4 build report (K4 is in ``grid_cg.cu``, built in phase 2):
    registers, spills, shared memory and blocks per SM of its instances;
13. K4 against its plain version on the card: f32 and f64, fixed 30
    iterations from zero and ``tol=1e-5`` from the warm start the step
    uses, on the operator refilled from a seeded u at ``n_side=20`` (on its
    template and on a remainder-heavy five-plane layout) and at 1,048,576
    nodes (on its template, the card's split, and on tpufem's 13-plane
    split), the warm solve's ms beside its bound; and K3 against its plain
    version on the NS step's own pressure operator (active mask deg > 0, no
    periodic pairs, float32 coarse inverse; ragged 3×3 coarse blocks at
    ``n_side=20``) at both sizes, at the step's f32 and at f64, fixed 120
    iterations and ``tol=1e-5`` from a warm start; rel L2, iterations and
    ms per solve of both, two launches bit-equal; ms an iteration of K3 on
    the NS operator and of K4, each on the card's split and on tpufem's,
    against their byte bounds;
14. the NS main path: ``bench_large.ns_config`` (tpufem's ``run_ns``) at
    1,048,576 nodes through ``NSProblem.build`` and ``navier_stokes.run``:
    200 steps from rest, then 200 continued; K4 and K3 must each run once a
    step; tpufem's NS gates;
15. the NS grid path at f64 on the card (kernels) against the port's CPU
    path (plain versions) at ``n_side=40`` over 10 steps, held in max abs
    and in relative L2 (|u| is about 1e-5 there); f32 on the card against
    f64;
16. the NS dense path on the card against the CPU at f64 on
    ``generate_annulus_mesh(12, 16)`` over 20 steps.

Phases 17–22, kernel K5 (the whole Stokes step, ``tpufem_torch/csrc/
grid_step.cu``, built in phase 2), run after phase 11 while phase 9's
1,048,576-node problem is built:

17. the K5 build report: registers, spills, shared memory and blocks per
    SM of its instances;
18. K5 against its plain version on the card: f32 (bf16 coarse inverse)
    and f64, fixed iterations and ``tol=1e-5`` from a warm state, at
    ``n_side=20`` (64 coarse nodes) and on phase 9's problem with K5
    attached (``GridStokesStep.build`` on a copy of its configuration); rel
    L2 of u, u*, p, p2 and the metrics, iterations and ms per call of both;
    two launches bit-equal, and one K = 4 launch bit-equal to four K = 1;
    ms a pressure iteration of K5 on the card's split and on tpufem's;
19. the K5 main path: ``bench_large.bench_config`` at 1,048,576 nodes with
    ``grid_steps_per_call`` 1, then 4, through ``stokes.run``: 200 steps
    from rest and 200 continued; K5 must run steps/K times and K2, K3 none;
    tpufem's physics gates; steps/s and device ms a step (profiler) beside
    the unfused path's in the same process;
20. the K5 path at f64 on the card against the port's CPU path at
    ``n_side=40`` over 10 steps, fixed iterations and tol 1e-5; f32 against
    f64;
21. tracers on K5 (K = 1) at 78,400 nodes for 200 steps;
22. the unfused grid path and K5 (K = 1) beside each other on
    ``generate_annulus_mesh(280, 320, pad_hole=False)``, renumbered on the
    host (``gridify``), under tpufem's "imported" gate, and on the
    160,000-node ``generate_annulus_mesh(400, 448, pad_hole=True)`` under
    the scale gates: 200 steps from rest and 200 more, steps/s of both;
    then K5 against its plain version there (f32 and f64, tol 1e-5).

Phases 23–26, the space-sharded grid path (``tpufem_torch.parallel``) and
kernel K6 (the ring halo exchange, ``tpufem_torch/csrc/halo_rdma.cu``, built
in phase 2), run after phase 22 on phase 9's 1,048,576-node problem, with
all shards on the one card:

23. K6 against its plain version (``torch.cat``), bit for bit: f32 and f64,
    2, 4 and 8 shards and one, depths 1, 3 and the solvers' ``dmax``, at
    the 1,048,576-node strips (256 × 1024) and a ragged shape whose row is
    no multiple of 16 bytes; µs a call of both and of ``torch.cat`` (CUDA-
    graph replay), the build report, the bound;
24. the sharded grid solvers (4 shards): ``halo="rdma"`` against
    ``"ppermute"``, both against the single-device K2/K3 and their plain
    versions, at ``n_side=40`` f64 (fixed iterations and tol 1e-8) and on
    phase 9's problem at f32; ms a solve of each;
25. the sharded main path: ``make_sharded_matfree_step(mesh, problem,
    halo="rdma")`` on phase 9's problem, 20 steps from rest; K6 must launch
    as often as the solves' iterations imply and K1–K5 never; tpufem's
    physics gates; steps/s, device ms a step and K6's share beside the
    single-device unfused step from zero on the same problem;
26. at f64 and ``n_side=40``, 4 shards, 10 steps: the card's sharded step
    (K6) against the port's CPU sharded step (plain), both against the
    single-device step; the distributed CSR viscous CG against the
    single-device CSR solve.

Phases 27–30, the rest of the Stokes workload (no new kernel), run last:

27. the gait campaign: ``sweep.food_capture_sweep`` on
    ``generate_annulus_mesh(33, 48)`` (3 gaits × 6000 steps, f32 fused on
    K1, 488 tracers), cold, then warm at 1000 steps a gait: wall seconds of
    each gait and of the campaign, eaten counts and fractions (recorded, not
    gated); K1 must run once a step of every gait and no other kernel; then
    the f32 campaign on the card against the f64 one (LU, penalty) on the
    CPU at 300 steps, fractions within 0.05;
28. Eulerian dye at scale: ``bench_large.bench_config(transport=
    "eulerian_dye")`` on phase 9's 1,048,576-node mesh, grid storage,
    through ``StokesProblem.build`` and ``stokes.run``: 50 steps from rest
    and 50 continued; K2 once and K3 twice a step; tpufem's scale gates,
    c in [0, 1], mixing progress > 0; build seconds, steps/s, device ms a
    step by kernel and the dye solve's share;
29. Eulerian dye at f64, card against CPU: the dense penalty path on
    ``generate_annulus_mesh(12, 16)`` (20 steps; u to 1e-8 relative, c to
    5e-3 relative, as far as the penalty holds it), the grid path at
    ``n_side=40`` (10 steps, kernels against plain versions, max abs
    1e-6), and f32 merge against f64 on the bench mesh (200 steps, c within
    5e-3 relative);
30. the report variant (tpufem's CLI configuration: rotating, dt 1e-5, ramp
    200, smoothing 0.01, one projection, LU penalty) on the bench mesh, f64
    card against CPU over 50 steps (1e-8), then 1000 steps timed twice on
    the card; the same configuration on CSR (Jacobi) at ``n_side=40`` over
    10 steps (1e-9); griddata dye and ``dense_ops=False`` over 20 steps
    (1e-10).

Phases 31–35, Poisson, heat, the small workloads and the dense Taylor–Hood
solvers (no kernel: each checks that none of K1–K6 launches on its path),
run last:

31. Poisson at scale: ``bench_large.run_poisson_large`` (tpufem's
    configuration: f32, two-level BiCGStab on the surgery operator, on the
    stencil, at most 2000 iterations, tol 1e-6) on phase 9's mesh;
    tpufem's gates (relative residual < 1e-4, Dirichlet values within
    1e-3); build, first and second solve seconds, iterations, device ms and
    kernels an iteration, the index kernels' share and the busy share
    (profiler); then the same operator as CSR, on the stencil and on the
    card's grid split (plain apply): ms an apply against each one's byte
    bound, and the solve on each in turns (phase 47's item 4);
32. heat at scale: ``bench_large.run_heat_large`` (f32, 50 steps) at
    160,000 nodes and on phase 9's mesh; u in [−1e-2, 1 + 1e-2]; cold and
    warm steps/s, iterations and device ms a step;
33. f64 card against the port's CPU path on ``generate_annulus_mesh(20,
    24)``: Poisson (lu, inverse, cg), heat (lu, cg; 50 steps),
    advection–diffusion (100 steps), graph average; dense 1e-10, CG 1e-9;
34. Stam's grid solver: ``StamConfig()`` (200², f32) for 400 frames, cold
    then warm, frames/s and kernels a frame; at f64 and size 64, each of 50
    card frames from the CPU's state within 1e-10 of the CPU's frame;
35. the dense Taylor–Hood solvers on ``p2_refine(generate_annulus_mesh(28,
    32))`` (5,192 dofs): the steady solve under tpufem's residual gate, the
    θ-scheme 200 steps f64 card against CPU (1e-10), f32 steps/s;
36. K2 and K3 on the sparse Taylor–Hood engine's operators (the P2
    velocity operator's identity split on its raster, the P1 pressure
    Laplacian) against their plain versions: ``p2_refine(
    generate_annulus_mesh(n, n))`` at n = 20 (K3 with 64 coarse nodes) and
    192; f32 and f64, fixed iterations from zero and the engine's
    ``tol_inner`` from a warm start, K2 also at the engine's velocity cap
    (288 iterations at 192) with ``tol_inner`` from zero and from the warm
    start, both velocity columns; rel L2,
    iterations, ms a solve of both, two launches bit-equal, ms an iteration
    against its bound, planes and remainder entries;
37. the TH-192 row (241,880 dofs): ``bench_large.run_th_sparse(192, 192,
    steps, precision="f32", engine="grid")`` at ``vel_restarts`` 0 and 1
    from one ``SparseTHProblem``: build seconds, steps/s, outer iterations,
    K2 and K3 launches and iterations a step (K2 = (1 + restarts)·(K3 +
    2)), the profiler's device split, weak and nodal divergence beside the P1/P1
    projection's under tpufem's gate th_weak < 0.1·p1_weak;
38. f64 card against CPU on ``p2_refine(generate_annulus_mesh(20, 20))``
    over 10 steps (the CSR engine 1e-10, the grid engine 1e-9 relative in
    u) and the steady Uzawa solve against the dense Taylor–Hood solve
    (1e-9); the NS/TH cross-check of ``benchmarks/ns_th_xcheck_r5.py`` at
    n_side 28 (rotational force, 50 steps, dt 1e-4), NS with
    ``mass_consistent`` False and True against one CSR TH run, the second
    within 0.1.

Phases 39–42, the ensembles, the one-program gait campaign, TopK and bf16
(no kernel: each checks that none of K1–K6 launches on its path), run last:

39. ``__graft_entry__.dryrun_multichip``'s gates on the port's
    ``ShardedEnsemble`` (8 positions on the card, data 2 × space 4, f64
    penalty dye) on ``generate_annulus_mesh(40, 48)``: the divergence falls
    step over step, each simulation meets the scale divergence gate and the
    velocity bound after 10 steps; on the jittered (12, 16) lattice the
    ensemble's tracers stay within 1e-5 of the single-device stepper's with
    equal status; then f64 card against CPU on (12, 16), 2 × 4 positions,
    10 steps: color with dye and with tracers (merged pressure) and the
    report ensemble over four rotation rates (penalty), 1e-10;
40. the gait campaign as one sharded program:
    ``sweep.food_capture_sweep_sharded`` on phase 27's mesh, one gait a
    "data" position on the card (``run_sharded`` replays one CUDA graph a
    step), cold and warm: campaign seconds, fractions within 0.05 of phase
    27's; at B = 3 and 8 gaits, steps/s of the graph run and of the eager
    steps, kernels and device ms a step and the busy share (profiler), the
    count at B = 8 no more than 5 % above B = 3; eaten counts at 300 steps
    within 2 of phase 27's f32 campaign (tpufem's own gate);
41. the geometry ensemble: ``MultiMeshEnsemble`` over 8
    ``generate_annulus_mesh(64, 72, pad_hole=True, jitter=0.15, seed=k)``
    (4,096 nodes each), tracers, f32 merge, 8 data positions on the card,
    500 steps: build seconds, steps/s, device ms and kernels a step, the
    products' share, peak memory, each simulation under the gates; f64 card
    against CPU on 4 jittered (14, 16) meshes, 10 steps, dye and tracers
    (1e-10);
42. ``locator="topk"`` beside the grid locator on the dense bench
    configuration (200 steps cold and warm, K1 every step); topk f64 card
    against CPU on (12, 16) with dye and tracers (1e-10); the bf16 fused
    step (``torch.addmv``) on (12, 16), 10 steps: max|u| < 1.25·(|B1| +
    |B2|), within 1e-2 of f64.

Phases 43–46, the support modules and the CLI (no new kernel; each counts
the launches of K1–K6 on its path):

43. ``diag`` on the card, run after phase 26 on phase 9's problem: Tests
    A–J, preflight, the stiffness's eigenvalue census, ``vorticity`` and
    ``gradient_matrices`` at f64 on ``generate_annulus_mesh(40, 48)`` and
    on the jittered ``(24, 28, jitter=0.25, seed=3)``, each value within
    1e-10 of the port's CPU result (relative, absolute below 1) and under
    tpufem's gates; on the 1,048,576-node problem
    ``single_step_diagnostics`` (one K2 and one K3 launch), the projection
    oracle on a compatible field, and ``run_guarded`` over 200 steps in
    chunks of 50: "ok", then "aborted" at step 0 with ``max_div`` below the
    first chunk's ``final_div_max``;
44. the convergence studies through ``cli.main``, in process: ``converge
    --study self`` at 1.6k, 6.5k and 26k nodes (grid f32: K2, K3), ``ns``
    at 2k, 6.5k and 26k (K4, K3) and ``th`` at 0.5k, 0.8k and 1.2k to its
    steady horizon (CSR and dense Taylor–Hood: no kernel), under tpufem's
    monotone gates and, for ``self``, the Stokes ``div_rel`` gate;
45. ``roofline.measure`` at 160,000 nodes: µs an iteration of K2 and K3
    at fixed counts, GB/s and the share of the byte bound
    (``roofline.iteration_bound``, the one source of every bound here),
    beside phase 8's difference-of-two-solves figure on the same
    operators;
46. every subcommand of ``python -m tpufem_torch`` in process on
    ``--mesh generated`` (``--help``; ``food --precision f32`` on K1,
    ``sweep`` on K1, ``bench --large --sizes 160k`` on K2 and K3), each JSON
    line held to the gates of tpufem's CLI tests and workloads.

Phase 47, the stencil and banded storages (``ops/stencil.py``,
``ops/banded.py``, ``parallel/halo.py``, ``parallel/halo_stencil.py``; no
kernel of their own), run after phase 43 on phase 9's problem:

47. (1) phase 9's four operators (stiffness, merged pressure, Dx, Dy) as
    CSR, on the stencil and on the card's grid split (plain apply): the
    stencil's build seconds, offsets and remainder; device ms an apply
    (CUDA-graph replay) beside each one's byte bound
    (``roofline.apply_bound``) and kernels an apply; f32 rel L2 against
    CSR ≤ 1e-5; (2) the Scale step with its div/grad on the stencil (Dx
    and Dy in one pass, as built), on the stencil as two applies and on
    CSR, in turns A B C C B A, twice, of 400 warm steps: steps/s, device ms
    and kernels a step, the busy share, K2 1 and K3 2 launches a step in every
    turn, u within 1e-5 after 20 steps from rest; (3) at 160,000 nodes
    (``bench_config``) Stokes on the stencil, CSR and banded (warm steps/s,
    iterations a solve; the band's width, bytes and ms an apply) and NS on
    the stencil and CSR (``bench_large.ns_config``, tpufem's gates: warm
    steps/s, device ms and kernels a step over 3 profiled steps); (4) in phase 31; (5) f64 card against the port's CPU, fixed
    iterations, on ``generate_annulus_mesh(40, 48)``: Stokes on the stencil
    (with and without the hole) and banded, NS on the stencil (pad_hole),
    the sharded step's stencil and banded branches on 4 strips of one card
    over 3 steps, each within 1e-10; (6) the sharded step on the stencil
    at 160,000 nodes, 4 strips on one card, 3 steps: steps/s, kernels a
    step, the busy share.

``python3 chip_smoke.py --cards N`` runs phases 1, 2 and 23–26 alone, with
one shard on each of N cards: K6 pushes into its neighbours' outputs on
the other cards through peer access, and its times there are taken by the
host clock; with N ≥ 3 it also runs the campaign with one gait on each of
three cards beside all gaits on the first (phase 40).

Each phase prints its seconds.  Any failed check raises, so the exit code
is not 0.  The line before the last is a JSON summary of the kernels (each
with its bound: the larger of its bytes, each input read once and each
output written once, over the HBM rate, and its operations over the
float32 rate, ``tpufem_torch.roofline``); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import re
import sys
import time

import numpy as np
import torch

from tpufem_torch import bench_large, cli, diag, roofline
from tpufem_torch.bench import (bench_config, bench_mesh, card, profile_run, profile_steps,
                                timed_run)
from tpufem_torch.mesh import generate_annulus_mesh
from tpufem_torch.ops import _nvcc, assembly, calculus
from tpufem_torch.ops import fused_matvec as fm
from tpufem_torch.ops.gridop import (STREAMED_NODES, GridDecompositionError, GridOperator,
                                     GridRefill, _PatternCSR)
from tpufem_torch.ops.stencil import StencilOperator
from tpufem_torch.parallel import (MultiMeshEnsemble, ShardedEnsemble, build_device_mesh,
                                   make_multimesh_step, make_sharded_grid_solvers,
                                   make_sharded_matfree_step, make_sharded_step,
                                   make_sharded_viscous_solver, run_sharded)
from tpufem_torch.parallel import grid_remote_dma as rdma
from tpufem_torch.parallel.grid_sharded import _signed_dy
# the card's peaks and the kernels' byte model (their one source), importable
# from here as before
from tpufem_torch.roofline import (APPLIES, F32_FLOPS, HBM_BYTES_PER_S, bound,  # noqa: F401
                                   iteration_bound, solve_bound)
from tpufem_torch.solve import grid_cg
from tpufem_torch.solve import grid_step as gs
from tpufem_torch.solve.matfree import ViscousCG
from tpufem_torch.solve.pressure import owner_map
from tpufem_torch.workloads import navier_stokes, stokes, sweep

MAX_U_FACTOR = 1.25  # boundedness gate of tpufem/bench_large.py: max|u| < 1.25·(|B1|+|B2|)
KERNEL_SHAPES = (1704, 700, 6200)  # 2N of the bench mesh, an off-tile size, 2N at 3,100 nodes
# checked, not timed: the scalar-tail path (C not a multiple of the 16-byte
# vector) and the path that reads x from L2 (C over the 48 KB staging limit)
KERNEL_EDGE_SHAPES = ((1703, 1701), (256, 13000), (256, 13001))
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # relative L2 against torch.addmv
TIMED_CALLS = 200
MAIN_STEPS = 1000
PARITY_STEPS = 50
DYE_STEPS = 200
SCALE_MESH = (1024, 1088)  # 1,048,576 nodes, bench_large's "1.05M"
SCALE_STEPS = 200
SCALE_PARITY_MESH = (40, 48)
SCALE_PARITY_STEPS = 10
TRACER_MESH = (280, 320)  # 78,400 nodes
TRACER_STEPS = 200
# K2/K3 against their plain versions, relative L2 of the solution.  At
# f64 the two differ in summation order only.  At f32 the difference is
# float32 roundoff amplified by the iterations.  With tol > 0 the two may
# also stop one iteration apart, which moves the result within the
# solve's tolerance.
GRID_RTOL = {(torch.float64, 0.0): 1e-9, (torch.float64, 1e-5): 1e-5,
             (torch.float32, 0.0): 1e-3, (torch.float32, 1e-5): 1e-3}
NS_STEPS = 200
NS_PARITY_MESH = (40, 48)
NS_PARITY_STEPS = 10
NS_DENSE_MESH = (12, 16)
NS_DENSE_STEPS = 20
K5_STEPS = 200
K5_PER_CALL = (1, 4)
K5_PROFILE_STEPS = 40
GRIDIFY_MESH = (280, 320)  # pad_hole=False: 57,448 nodes, renumbered onto 280×280
GRIDIFY_STEPS = 200
MID_MESH = (400, 448)  # pad_hole: 160,000 nodes, below tpufem's 360k streaming threshold
ITER_PROBE = 40  # a kernel's ms an iteration: solves of 40 and 20 fixed iterations, the difference
CPU = torch.device("cpu")


def zero_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    fm.fused_step_matvec.launches = 0
    grid_cg.viscous_cg.launches = grid_cg.pressure_cg.launches = grid_cg.ns_bicgstab.launches = 0
    gs.grid_step.launches = 0
    rdma.halo_rdma.launches = 0


def launch_counts() -> dict:
    return {"K1": fm.fused_step_matvec.launches, "K2": grid_cg.viscous_cg.launches,
            "K3": grid_cg.pressure_cg.launches, "K4": grid_cg.ns_bicgstab.launches,
            "K5": gs.grid_step.launches, "K6": rdma.halo_rdma.launches}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def per_call_ms(fn, *args, calls: int = TIMED_CALLS) -> float:
    """Mean ms per call of ``calls`` back-to-back calls, by CUDA events."""
    for _ in range(10):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, *args, calls: int = TIMED_CALLS, replays: int = 5) -> float:
    """Mean device ms per call: ``calls`` calls captured in one CUDA graph
    and replayed, so the host's launch cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn(*args)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke test runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card())
    print(f"[1 device] {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return torch.device("cuda", 0)


def ptxas_report(path, entry: str = "") -> str:
    """Registers and spill stores of the instances in ``path``'s ptxas
    report whose mangled name contains ``entry`` (all with "")."""
    report = path.with_suffix(".log").read_text()
    parts = [p for p in report.split("Compiling entry function")[1:] if entry in p.split("'")[1]]
    text = "".join(parts) if entry else report
    regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", text)})
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", text))
    return f"registers per instance {regs}, spill stores {spills} bytes"


def instance_label(mangled: str) -> str:
    """``pressure_cg f32 bf16`` for pressure_cg_kernel<float, __nv_bfloat16>:
    the kernel without ``_kernel`` and its template arguments (a second
    field type equal to the first left out; the first integer is the
    columns, a second the blocks per SM of the register budget:
    ``viscous_cg f32 C=2 5/SM`` for viscous_cg_kernel<float, 2, 5>)."""
    m = re.search(r"\d+([a-z][a-z_]*?)_kernelI(.*?)EEv", mangled)
    if m is None:
        return mangled
    args = []
    for t in re.finditer(r"\d+__nv_bfloat16|Li(\d+)E|[fd]", m.group(2)):
        if t.group(1):
            args.append(f"{t.group(1)}/SM" if any(a.startswith("C=") for a in args)
                        else f"C={t.group(1)}")
        else:
            args.append({"f": "f32", "d": "f64"}.get(t.group(0), "bf16"))
    if len(args) == 2 and args[1] == args[0]:
        args = args[:1]
    return " ".join([m.group(1)] + args)


def instance_report(path, blocks: dict, entry: str = "") -> list[str]:
    """One line for each instance in ``path``'s ptxas report whose name
    contains ``entry``: registers, spill stores, shared memory and the
    blocks per SM the cooperative launch runs (``blocks``, by label, as
    ``grid_cg.blocks_per_sm`` gives them)."""
    lines = []
    for part in path.with_suffix(".log").read_text().split("Compiling entry function")[1:]:
        name = part.split("'")[1]
        if entry not in name:
            continue
        label = instance_label(name)
        regs = re.search(r"Used (\d+) registers", part)
        smem = re.search(r"(\d+) bytes smem", part)
        spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", part))
        lines.append(f"{label}: {regs.group(1) if regs else '?'} registers, {spill} B spill "
                     f"stores, {smem.group(1) if smem else 0} B smem, "
                     f"{blocks.get(label, '?')} blocks/SM")
    return lines


def phase_build() -> float:
    """Build every kernel library at once; returns the seconds it took."""
    t0 = time.perf_counter()
    _nvcc.build_all([fm.SOURCE, grid_cg.SOURCE, gs.SOURCE, rdma.SOURCE])
    fm.build()
    grid_cg.build()
    gs.build()
    rdma.build()
    seconds = time.perf_counter() - t0
    print(f"[2 build] K1 from {fm.SOURCE.relative_to(_nvcc.PKG.parent)}, K2/K3/K4 from "
          f"{grid_cg.SOURCE.relative_to(_nvcc.PKG.parent)}, K5 from "
          f"{gs.SOURCE.relative_to(_nvcc.PKG.parent)} and K6 from "
          f"{rdma.SOURCE.relative_to(_nvcc.PKG.parent)} in parallel: {seconds:.2f} s; "
          f"K1 {ptxas_report(fm.library_path())}")
    return seconds


def phase_kernel(dev: torch.device) -> dict:
    """K1 against torch.addmv; returns the numbers at the main path's shape."""
    rng = np.random.default_rng(0)
    at_main = {}
    for r, c in [(n, n) for n in KERNEL_SHAPES] + list(KERNEL_EDGE_SHAPES):
        for dtype, rtol in KERNEL_RTOL.items():
            M, x, b = (torch.as_tensor(a, dtype=dtype, device=dev)
                       for a in (rng.standard_normal((r, c)), rng.standard_normal(c),
                                 rng.standard_normal(r)))
            y = fm.fused_step_matvec(M, x, b)
            want = fm.fused_step_matvec_ref(M, x, b)
            torch.cuda.synchronize()
            err = rel(y, want)
            max_abs = float((y - want).abs().max())
            name = f"K1 {r}x{c} {str(dtype)[6:]}"
            check(err <= rtol, f"{name}: rel L2 {err} > {rtol}")
            line = f"[3 kernel] {name}: rel L2 {err:.3e} (<= {rtol:g}), max abs {max_abs:.3e}"
            if (r, c) in KERNEL_EDGE_SHAPES:
                print(line)
                continue
            k1 = (per_call_ms(fm.fused_step_matvec, M, x, b), device_ms(fm.fused_step_matvec, M, x, b))
            plain = (per_call_ms(fm.fused_step_matvec_ref, M, x, b),
                     device_ms(fm.fused_step_matvec_ref, M, x, b))
            print(f"{line}; us/call eager loop K1 {k1[0] * 1e3:.2f} addmv {plain[0] * 1e3:.2f}, "
                  f"device (graph replay) K1 {k1[1] * 1e3:.2f} addmv {plain[1] * 1e3:.2f}")
            if r == KERNEL_SHAPES[0] and dtype == torch.float32:
                at_main = {"max_abs_err": max_abs, "ms": k1[1], "plain_ms": plain[1],
                           **bound((r * c + c + 2 * r) * M.element_size(), 2.0 * r * c),
                           "library_ms": device_ms(lambda M, x, b: torch.addmv(b, M, x), M, x, b)}
    return at_main


def jittered(problem, dtype, dev, seed: int = 42, sigma: float = 1e-3):
    """The initial state with the tracer lattice moved off the mesh edges,
    where containment is a knife-edge tie."""
    state = stokes.initial_state(problem)
    pts = problem.tracer_init + sigma * np.random.default_rng(seed).standard_normal(
        problem.tracer_init.shape)
    state["tracers"] = torch.as_tensor(pts, dtype=dtype, device=dev)
    return state


def phase_main_path(dev: torch.device, mesh, steps: int = MAIN_STEPS) -> int:
    """The bench configuration through the user's entry points; returns
    K1's launch count over both runs."""
    cfg = bench_config()
    problem = stokes.StokesProblem.build(mesh, cfg, device=dev)
    n_tracers = problem.tracer_init.shape[0]
    zero_launches()
    cold, _, _ = timed_run(problem, steps)
    check(fm.fused_step_matvec.launches == steps,
          f"K1 launched {fm.fused_step_matvec.launches} times in a {steps}-step run")
    warm, state, metrics = timed_run(problem, steps)
    counts = launch_counts()
    launches = counts["K1"]
    check(counts == {"K1": 2 * steps, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0},
          f"launches {counts} in two {steps}-step runs (want K1 = steps)")
    for k, v in {**state, **metrics}.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{k} is finite")
    u_cap = MAX_U_FACTOR * (abs(cfg.B1) + abs(cfg.B2))
    max_u = float(metrics["max_u"].max())
    check(max_u < u_cap, f"max|u| {max_u} < {u_cap}")
    div0, div_end = float(metrics["div_star_max"][0]), float(metrics["final_div_max"][-1])
    check(div_end < div0, f"last final_div_max {div_end} < first div_star_max {div0}")
    frac = float(metrics["eaten"][-1]) / n_tracers
    print(f"[4 main path] {mesh.n_nodes} nodes, {n_tracers} tracers, {steps} steps: "
          f"cold {cold:.1f} steps/s, warm {warm:.1f} steps/s; K1 launches {launches}; "
          f"max|u| {max_u:.4f}; div* {div0:.3e} -> final {div_end:.3e}; "
          f"captured {frac:.4f}")
    return launches


def phase_parity(dev: torch.device, mesh, steps: int = PARITY_STEPS) -> None:
    """f64 on the card against f64 on the CPU; f32 on the card against f64."""
    runs = {}
    for name, device, precision in (("gpu64", dev, "f64"), ("cpu64", torch.device("cpu"), "f64"),
                                    ("gpu32", dev, "f32")):
        problem = stokes.StokesProblem.build(mesh, bench_config(precision=precision),
                                             device=device)
        dtype = problem.dtype
        state, metrics = stokes.run(problem, steps=steps,
                                    state=jittered(problem, dtype, device))
        runs[name] = (state, metrics, problem.tracer_init.shape[0])
    g, c, f = runs["gpu64"][0], runs["cpu64"][0], runs["gpu32"][0]
    du = rel(g["u"], c["u"])
    dp = float((g["tracers"].cpu() - c["tracers"]).abs().max())
    same = bool(torch.equal(g["tracer_status"].cpu(), c["tracer_status"]))
    df = rel(f["u"], g["u"])
    n_tr = runs["gpu64"][2]
    frac = {k: float(v[1]["eaten"][-1]) / n_tr for k, v in runs.items()}
    print(f"[5 parity] {steps} steps f64 card vs CPU: u rel {du:.3e} (<= 1e-10), "
          f"tracers max abs {dp:.3e} (<= 1e-8), status equal {same}; "
          f"f32 vs f64 card: u rel {df:.3e} (<= 5e-3), captured {frac['gpu32']:.4f} "
          f"vs {frac['gpu64']:.4f}")
    check(du <= 1e-10, f"f64 u card vs CPU rel {du}")
    check(dp <= 1e-8, f"f64 tracers card vs CPU max abs {dp}")
    check(same, "tracer_status card vs CPU")
    check(df <= 5e-3, f"f32 u vs f64 rel {df}")
    check(abs(frac["gpu32"] - frac["gpu64"]) <= 0.05, "f32 captured fraction within 0.05 of f64")


def phase_dye(dev: torch.device, mesh, steps: int = DYE_STEPS) -> None:
    cfg = stokes.StokesConfig(transport="dye", solver="inverse", precision="f32",
                              pressure_mode="merge", fused=True, matvec_impl="pallas")
    problem = stokes.StokesProblem.build(mesh, cfg, device=dev)
    state, metrics = stokes.run(problem, steps=steps)
    c = state["c"]
    lo, hi = float(c.min()), float(c.max())
    prog = metrics["mixing_progress"]
    check(lo >= -1e-6 and hi <= 1 + 1e-6, f"dye in [-1e-6, 1+1e-6]: [{lo}, {hi}]")
    check(bool(torch.isfinite(prog).all()), "mixing_progress is finite")
    print(f"[6 dye] {mesh.n_nodes} nodes, {steps} steps: c in [{lo:.3e}, {hi:.6f}], "
          f"mixing progress {float(prog[-1]):.4f}")


def phase_grid_build(seconds: float) -> None:
    blocks = grid_cg.blocks_per_sm()
    print(f"[7 build] K2/K3 ({grid_cg.library_path().name}) within the {seconds:.2f} s "
          f"parallel build: {ptxas_report(grid_cg.library_path())}")
    for entry in ("viscous_cg", "pressure_cg"):
        for line in instance_report(grid_cg.library_path(), blocks, entry):
            print(f"[7 build]   {line}")


def scale_problem(dev, n_side: int, n_circle: int, **overrides):
    mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=True)
    cfg = bench_large.bench_config(n_nodes=mesh.n_nodes, storage="grid", **overrides)
    return stokes.StokesProblem.build(mesh, cfg, device=dev)


def k3_cast(pres, dtype, coarse_dtype):
    """``pres`` (a PressureGridCG) with its fields and operator cast to
    ``dtype`` and its coarse inverse to ``coarse_dtype``."""
    return dataclasses.replace(
        pres, K=pres.K.astype(dtype), m_lumped=pres.m_lumped.to(dtype),
        active_mask=pres.active_mask.to(dtype), master_mask=pres.master_mask.to(dtype),
        slave_mask=pres.slave_mask.to(dtype), ac_inv=pres.ac_inv.to(coarse_dtype))


def solver_variants(problem, dtype):
    """The problem's K2 and K3 solvers with fields and operators cast to
    ``dtype``: [(label, solver, rhs planes)], K3 once with the problem's
    own coarse inverse dtype and, at f32, also with a float32 one."""
    visc, pres = problem.visc_solver, problem.pressure_solver
    K = visc.K.astype(dtype)
    v = dataclasses.replace(visc, K=K, interior_mask=visc.interior_mask.to(dtype))
    coarse = [pres.ac_inv.dtype] if dtype == torch.float64 else [torch.bfloat16, torch.float32]
    if dtype == torch.float64 and pres.ac_inv.dtype == torch.bfloat16:
        coarse = [torch.float64]
    out = [("K2", v, 2)]
    for cd in coarse:
        out.append((f"K3 coarse {str(cd)[6:]}", k3_cast(pres, dtype, cd), 1))
    return out


def solve_timed_ms(fn, solver, b, x0, calls: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn(solver, b, x0)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def check_solve(phase: int, case: str, kernel, plain, solver, b, x0, rtol: float,
                calls: int, plain_calls: int) -> dict:
    """One whole-solve kernel against its plain version on one right-hand
    side: two launches bit-equal, relative L2 within ``rtol``; prints the
    case and returns its numbers (and the kernel's iterations)."""
    dev = b.device
    it_k = torch.zeros(1, dtype=torch.int32, device=dev)
    it_p = torch.zeros(1, dtype=torch.int32, device=dev)
    y1 = kernel(solver, b, x0, it_k)
    y2 = kernel(solver, b, x0)
    want = plain(solver, b, x0, it_p)
    torch.cuda.synchronize()
    same = bool(torch.equal(y1, y2))
    err = rel(y1, want)
    max_abs = float((y1 - want).abs().max())
    ms = solve_timed_ms(kernel, solver, b, x0, calls)
    plain_ms = solve_timed_ms(plain, solver, b, x0, plain_calls)
    print(f"[{phase} kernel] {case}: rel L2 {err:.3e} (<= {rtol:g}), max abs {max_abs:.3e}, "
          f"iterations kernel {int(it_k.item())} plain {int(it_p.item())}, "
          f"ms per solve kernel {ms:.3f} plain {plain_ms:.3f}, repeat bit-equal {same}")
    check(same, f"{case}: two launches differ")
    check(err <= rtol, f"{case}: rel L2 {err} > {rtol}")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "iters": int(it_k.item())}


def check_cg_cases(phase: int, case: str, kernel, plain, solver, b, calls: int,
                   plain_calls: int) -> dict:
    """K2 or K3 (``solver``) against its plain version: fixed iterations
    from zero, then tol 1e-5 from a warm start (the fixed-iteration
    solution of a nearby rhs); returns the numbers of the tol 1e-5 case."""
    out = None
    for tol in (0.0, 1e-5):
        s = dataclasses.replace(solver, tol=tol)
        x0 = torch.zeros_like(b)
        if tol:
            x0 = plain(dataclasses.replace(solver, tol=0.0),
                       b * (1 + 1e-3 * torch.randn_like(b)), torch.zeros_like(b))
        out = check_solve(phase, f"{case} tol {tol:g}", kernel, plain, s, b, x0,
                          GRID_RTOL[(b.dtype, tol)], calls, plain_calls)
    return out


def check_grid_kernels(label: str, problem, dev, calls: int, plain_calls: int) -> dict:
    """K2/K3 against their plain versions on ``problem``'s operators; returns
    {kernel: numbers} for the f32, tol 1e-5 case."""
    rng = np.random.default_rng(7)
    ns = problem.visc_solver.K.ns
    at_main = {}
    for dtype in (torch.float32, torch.float64):
        for name, solver, cols in solver_variants(problem, dtype):
            kernel, plain = ((grid_cg.viscous_cg, grid_cg.viscous_cg_ref) if name == "K2"
                             else (grid_cg.pressure_cg, grid_cg.pressure_cg_ref))
            shape = (cols, ns, ns) if name == "K2" else (ns, ns)
            b = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
            if name != "K2":
                b = b * solver.act_grid  # a prepared rhs: zero off the active dofs
            numbers = check_cg_cases(8, f"{name} {str(dtype)[6:]} at {label}", kernel, plain,
                                     solver, b, calls, plain_calls)
            if dtype == torch.float32 and name in ("K2", "K3 coarse bfloat16"):
                iters = numbers.pop("iters")
                at_main[name[:2]] = {**numbers, **solve_bound(name[:2], solver.K, cols, iters,
                                                              getattr(solver, "ac_inv", None)),
                                     "library_ms": None}
    return at_main


def per_iteration_ms(fn, solver, b, calls: int) -> float:
    """ms an iteration of a whole-solve kernel ``fn``: fixed-iteration solves
    from zero of ITER_PROBE and ITER_PROBE/2 iterations, the difference."""
    x0 = torch.zeros_like(b)
    half = ITER_PROBE // 2
    t = [solve_timed_ms(fn, dataclasses.replace(solver, iters=k, tol=0.0), b, x0, calls)
         for k in (ITER_PROBE, half)]
    return (t[0] - t[1]) / (ITER_PROBE - half)


def iteration_report(phase: int, label: str, kernel: str, fn, cases, b, calls: int = 5) -> None:
    """ms an iteration against its bound, for each (split name, solver,
    operator) in ``cases``."""
    parts = []
    for name, solver, K in cases:
        ms = per_iteration_ms(fn, solver, b, calls)
        ac = solver.ac_inv if kernel == "K3" and solver.use_coarse else None
        bd = iteration_bound(kernel, K, b.shape[0] if b.ndim == 3 else 1, ac)
        parts.append(f"{name} ({len(K.offsets)} planes, {K.n_rest} remainder entries) "
                     f"{ms:.4f} ms an iteration, bound {bd:.4f} ({100 * bd / ms:.1f} %)")
    print(f"[{phase} iteration] {kernel} {label}: " + "; ".join(parts))


def tpufem_split(problem) -> tuple:
    """A grid-path Stokes problem's viscous, pressure, Gdx and Gdy operators
    in tpufem's split (its streamed ``rest_target=128`` from 360,000 nodes
    and its remainder caps): the split the kernels applied before they got
    the card's (``GridOperator.dense_split``)."""
    mesh, bnd = problem.mesh, problem.boundary
    ns, dtype, dev = problem.visc_solver.K.ns, problem.dtype, problem.device
    ke = assembly.element_stiffness(mesh)
    owner = owner_map(mesh.n_nodes, bnd.masters, bnd.slaves)
    merged = dataclasses.replace(mesh, tris=owner[mesh.tris].astype(np.int32))

    def split(csr, streamed):
        if streamed and mesh.n_nodes >= STREAMED_NODES:
            try:
                return GridOperator.build(csr, ns, dtype=dtype, rest_target=128, device=dev)
            except GridDecompositionError:
                pass
        return GridOperator.build(csr, ns, dtype=dtype, device=dev)

    dx, dy = calculus.divergence_csr_operators(mesh)
    return (split(assembly.assemble_csr(mesh, ke), True),
            split(assembly.assemble_csr(merged, ke), True), split(dx, False), split(dy, False))


def grid_iterations(problem, old_ops, dev) -> None:
    """Phase 8's ms an iteration of K2 and K3 (f32, bf16 coarse inverse) on
    ``problem``'s split and on tpufem's (``old_ops``)."""
    rng = np.random.default_rng(8)
    ns = problem.visc_solver.K.ns
    visc, pres = problem.visc_solver, problem.pressure_solver
    b2 = torch.as_tensor(rng.standard_normal((2, ns, ns)), dtype=torch.float32, device=dev)
    iteration_report(8, f"f32 at {problem.mesh.n_nodes} nodes", "K2", grid_cg.viscous_cg,
                     [("card split", visc, visc.K),
                      ("tpufem split", dataclasses.replace(visc, K=old_ops[0]), old_ops[0])], b2)
    p1 = k3_cast(pres, torch.float32, pres.ac_inv.dtype)
    p0 = dataclasses.replace(p1, K=old_ops[1])
    b = torch.as_tensor(rng.standard_normal((ns, ns)), dtype=torch.float32, device=dev) * p1.act_grid
    iteration_report(8, f"f32 coarse {str(p1.ac_inv.dtype)[6:]} at {problem.mesh.n_nodes} nodes",
                     "K3", grid_cg.pressure_cg,
                     [("card split", p1, p1.K), ("tpufem split", p0, old_ops[1])], b)


def phase_grid_kernels(dev, big_problem, old_ops) -> dict:
    small = scale_problem(dev, 20, 24, cg_coarse_nodes=64)
    check(small.pressure_solver.block == 3 and small.pressure_solver.n_blocks == 7,
          "n_side=20 with cg_coarse_nodes=64 gives ragged 3×3 blocks")
    check_grid_kernels("n_side=20", small, dev, calls=20, plain_calls=5)
    out = check_grid_kernels(f"{big_problem.mesh.n_nodes} nodes", big_problem, dev,
                             calls=5, plain_calls=2)
    grid_iterations(big_problem, old_ops, dev)
    return out


def phase_scale_main_path(problem, build_s: float, steps: int = SCALE_STEPS):
    """The scale configuration through the user's entry points; returns the
    launch counts of K2 and K3 over both runs, and the steps/s and end
    state of the runs."""
    problem, counters = bench_large.with_iteration_counters(problem)
    zero_launches()
    cold, state, metrics, warm, state2 = bench_large.run_problem(problem, steps)
    launches = launch_counts()
    iters = bench_large.iterations_per_solve(counters, 2 * steps)
    check(launches == {"K1": 0, "K2": 2 * steps, "K3": 4 * steps, "K4": 0, "K5": 0, "K6": 0},
          f"launches {launches} in two {steps}-step runs (want K2 = steps, K3 = 2·steps)")
    for k, v in {**state, **state2, **metrics}.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{k} is finite")
    phys = bench_large.physics_report(problem, state, metrics, steps)  # raises on a failed gate
    Kv, Kp = problem.visc_solver.K, problem.pressure_solver.K
    print(f"[9 scale main path] {problem.mesh.n_nodes} nodes ({len(Kv.offsets)} viscous planes "
          f"and {Kv.n_rest} remainder entries, {len(Kp.offsets)} pressure planes and "
          f"{Kp.n_rest}), {steps}+{steps} steps: build {build_s:.1f} s, cold "
          f"{cold:.2f} steps/s, warm {warm:.2f} steps/s; launches {launches}; mean iterations "
          f"per solve {iters}; {json.dumps(phys)}")
    return launches, {"cold": cold, "warm": warm, "state": state2}


def phase_scale_parity(dev, steps: int = SCALE_PARITY_STEPS) -> None:
    """The grid path: f64 kernels on the card against the plain versions on
    the CPU, fixed iterations and then tol 1e-5 warm; f32 card against f64."""
    n_side, n_circle = SCALE_PARITY_MESH
    for tols in ((0.0, 0.0), (1e-5, 1e-5)):
        kw = dict(cg_tol_pressure=tols[0], cg_tol_visc=tols[1])
        runs = {}
        for name, device, precision in (("gpu64", dev, "f64"), ("cpu64", torch.device("cpu"), "f64"),
                                        ("gpu32", dev, "f32")):
            problem = scale_problem(device, n_side, n_circle, precision=precision, **kw)
            runs[name], _ = stokes.run(problem, steps=steps)
        g, c, f = (runs[k]["u"].double().cpu() for k in ("gpu64", "cpu64", "gpu32"))
        du = float((g - c).abs().max())
        df = rel(f, g)
        print(f"[10 scale parity] n_side={n_side}, {steps} steps, tol {tols[0]:g}: f64 card "
              f"vs CPU max abs du {du:.3e} (<= 1e-6), u rel {rel(g, c):.3e}; f32 vs f64 card "
              f"u rel {df:.3e} (<= 5e-3)")
        check(du <= 1e-6, f"f64 card vs CPU max abs du {du}")
        check(df <= 5e-3, f"f32 vs f64 card u rel {df}")


def phase_scale_tracers(dev, steps: int = TRACER_STEPS) -> None:
    n_side, n_circle = TRACER_MESH
    problem = scale_problem(dev, n_side, n_circle, transport="tracers")
    state, metrics = stokes.run(problem, steps=steps)
    for k, v in {**state, **metrics}.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{k} is finite")
    n_tr = problem.tracer_init.shape[0]
    frac = float(metrics["eaten"][-1]) / n_tr
    check(0.0 <= frac <= 1.0, f"captured fraction {frac} in [0, 1]")
    print(f"[11 scale tracers] {problem.mesh.n_nodes} nodes, {n_tr} tracers, {steps} steps: "
          f"max|u| {float(metrics['max_u'].max()):.4f}, captured {frac:.4f}")


# ---------------------------------------------------------------------------
# K5: the whole Stokes step
# ---------------------------------------------------------------------------

# K5 against its plain version: u, u* and the metrics in relative L2 as
# GRID_RTOL (summation order at f64, float32 roundoff at f32, and with tol > 0
# a solve may stop one iteration apart); the pressures p and p2 looser, as
# measured on the card: where u agrees to 4e-12 (f64) and 2e-8 (f32), p
# agrees to 3e-9 and 2e-6 at n_side=20 and to 5e-4 (f32) at 1,048,576 nodes.
# Their difference lies in the smooth modes the solves leave, which reach u
# only through the gradient.
K5_P_RTOL = {(torch.float64, 0.0): 1e-7, (torch.float64, 1e-5): 1e-4,
             (torch.float32, 0.0): 1e-2, (torch.float32, 1e-5): 1e-2}


def phase_k5_build(seconds: float) -> None:
    print(f"[17 build] K5 ({gs.library_path().name}, built in the {seconds:.2f} s parallel build "
          f"of phase 2): {ptxas_report(gs.library_path())}")
    for line in instance_report(gs.library_path(), gs.blocks_per_sm()):
        print(f"[17 build]   {line}")


def with_k5(problem, k: int = 1):
    """``problem`` with K5 attached at K steps a call, through
    ``GridStokesStep.build`` on a copy of its configuration (no new build
    of the solvers)."""
    p = dataclasses.replace(problem, config=dataclasses.replace(problem.config,
                                                                grid_steps_per_call=k))
    step = gs.GridStokesStep.build(p)
    check(step is not None and step.steps_per_call == k, f"K5 attaches at K = {k}")
    return dataclasses.replace(p, grid_step=step)


def k5_cast(step, dtype, coarse_dtype, **changes):
    """``step`` (a GridStokesStep) with its operators and fields in ``dtype``."""
    visc = dataclasses.replace(step.visc, K=step.visc.K.astype(dtype),
                               interior_mask=step.visc.interior_mask.to(dtype))
    fields = {k: getattr(step, k).to(dtype)
              for k in ("wall_mask", "inner_mask", "inner_vals", "interior2")}
    return dataclasses.replace(step, visc=visc,
                               pressure=k3_cast(step.pressure, dtype, coarse_dtype),
                               Gdx=step.Gdx.astype(dtype), Gdy=step.Gdy.astype(dtype),
                               **fields, **changes)


def k5_state(step, state, dtype):
    """The call's inputs from a run's state: u, u*, p, p2 as grid planes."""
    ns = step.ns

    def planes(v):
        return v.T.reshape(2, ns, ns).to(dtype).contiguous()

    u = planes(state["u"])
    us = planes(state["ustar_warm"]) if "ustar_warm" in state else torch.zeros_like(u)
    return (u, us, state["p_warm"].reshape(ns, ns).to(dtype).contiguous(),
            state["p2_warm"].reshape(ns, ns).to(dtype).contiguous())


def k5_bound(step, args, iters_v: int, iters_p: int) -> dict:
    """One K5 call's bound: its inputs read once (the four operators' planes
    and remainders, twelve mask and value planes, the state in, the coarse
    inverse) and its outputs written once (the state out), against the
    flops of this call's iterations (as ``solve_bound``: K2's for the
    viscous solve, K3's for each pressure iteration) and of three divs,
    two grads and ~40 elementwise operations a point."""
    n, item = step.visc.K.n, step.visc.K.diags.element_size()
    ops = (step.visc.K, step.pressure.K, step.Gdx, step.Gdy)
    planes = sum((len(K.offsets) * n + 3 * K.n_rest) * item for K in ops)
    ac = step.pressure.ac_inv
    m = ac.shape[0]
    nbytes = planes + (12 + 6 + 6) * n * item + m * m * ac.element_size()
    n_v, n_p, n_d = (len(K.offsets) for K in ops[:3])
    flops = ((iters_v + 1) * 2 * (2 * n_v + 10) * n
             + (iters_p + 2) * ((3 * 2 * n_p + 30) * n + 2 * m * m)
             + 5 * 2 * 2 * n_d * n + 40 * n)
    return bound(nbytes, flops)


def check_k5_call(label: str, step, args, rtol: float, p_rtol: float, calls: int,
                  plain_calls: int, phase: int = 18) -> dict:
    """One K5 call against its plain version: two launches bit-equal,
    u/u*/metrics within ``rtol`` and p/p2 within ``p_rtol`` (relative L2);
    prints the case and returns its numbers."""
    dev = args[0].device
    counts = [torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(4)]
    y1 = gs.grid_step(step, *args, counts[0], counts[1])
    y2 = gs.grid_step(step, *args)
    want = gs.grid_step_ref(step, *args, counts[2], counts[3])
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(y1, y2))
    errs = dict(zip(("u", "u*", "p", "p2", "metrics"), (rel(a, b) for a, b in zip(y1, want))))
    it = [int(c.item()) for c in counts]
    ms = solve_timed_ms(lambda s, a, _: gs.grid_step(s, *a), step, args, None, calls)
    plain_ms = solve_timed_ms(lambda s, a, _: gs.grid_step_ref(s, *a), step, args, None,
                              plain_calls)
    print(f"[{phase} kernel] K5 {label}: rel L2 " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (<= {rtol:g}, p/p2 <= {p_rtol:g}), iterations viscous/pressure kernel "
          f"{it[0]}/{it[1]} plain {it[2]}/{it[3]}, ms per call kernel {ms:.3f} plain "
          f"{plain_ms:.3f}, repeat bit-equal {same}")
    check(same, f"K5 {label}: two launches differ")
    for k, v in errs.items():
        check(v <= (p_rtol if k in ("p", "p2") else rtol), f"K5 {label}: {k} rel {v}")
    return {"max_abs_err": float((y1[0] - want[0]).abs().max()), "ms": ms, "plain_ms": plain_ms,
            **k5_bound(step, args, it[0], it[1]), "library_ms": None}


def check_k5_chain(label: str, step, args) -> None:
    """One launch of K = 4 steps against four launches of K = 1, bit for bit."""
    one = dataclasses.replace(step, steps_per_call=1)
    four = dataclasses.replace(step, steps_per_call=4)
    u, us, p, p2 = args
    mets = []
    for _ in range(4):
        u, us, p, p2, met = gs.grid_step(one, u, us, p, p2)
        mets.append(met)
    got = gs.grid_step(four, *args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got[:4], (u, us, p, p2)))
    same = same and torch.equal(got[4], torch.cat(mets))
    print(f"[18 kernel] K5 {label}: one K=4 launch bit-equal to four K=1 launches: {same}")
    check(same, f"K5 {label}: K=4 differs from 4 × K=1")


def check_k5_problem(label: str, problem, warm_steps: int, calls: int, plain_calls: int) -> dict:
    """K5 on ``problem`` (K5 attached, f32 fields) against its plain version:
    f32 with the problem's coarse inverse and f64, fixed iterations from the
    state after ``warm_steps`` steps and tol 1e-5 from the same state;
    returns the numbers of the f32 tol 1e-5 case."""
    state, _ = stokes.run(problem, steps=warm_steps)
    step = problem.grid_step
    out = {}
    for dtype in (torch.float32, torch.float64):
        coarse = step.pressure.ac_inv.dtype if dtype == torch.float32 else torch.float64
        args = k5_state(step, state, dtype)
        for tol in (0.0, 1e-5):
            s = k5_cast(step, dtype, coarse)
            s = dataclasses.replace(s, visc=dataclasses.replace(s.visc, tol=tol),
                                    pressure=dataclasses.replace(s.pressure, tol=tol))
            case = f"{str(dtype)[6:]} coarse {str(coarse)[6:]} tol {tol:g} at {label}"
            numbers = check_k5_call(case, s, args, GRID_RTOL[(dtype, tol)],
                                    K5_P_RTOL[(dtype, tol)], calls, plain_calls)
            if dtype == torch.float32 and tol:
                out = numbers
                check_k5_chain(case, s, args)
    return out


def k5_pressure_iteration_ms(step, args, calls: int = 5) -> float:
    """ms a pressure iteration of K5 (K = 1): calls with 2 viscous and
    ITER_PROBE, then ITER_PROBE/2, pressure iterations a solve, the
    difference over the two solves a step."""
    half = ITER_PROBE // 2
    s = dataclasses.replace(step, steps_per_call=1,
                            visc=dataclasses.replace(step.visc, iters=2, tol=0.0))
    t = [solve_timed_ms(lambda st, a, _: gs.grid_step(st, *a),
                        dataclasses.replace(s, pressure=dataclasses.replace(
                            s.pressure, iters=k, tol=0.0)), args, None, calls)
         for k in (ITER_PROBE, half)]
    return (t[0] - t[1]) / (2 * (ITER_PROBE - half))


def k5_iterations(problem, old_ops) -> None:
    """Phase 18's ms a pressure iteration of K5 (f32, the problem's coarse
    inverse) on the card's split and on tpufem's (``old_ops``)."""
    state, _ = stokes.run(problem, steps=2)
    step = problem.grid_step
    args = k5_state(step, state, torch.float32)
    old = dataclasses.replace(step, visc=dataclasses.replace(step.visc, K=old_ops[0]),
                              pressure=dataclasses.replace(step.pressure, K=old_ops[1]),
                              Gdx=old_ops[2], Gdy=old_ops[3])
    parts = []
    for name, s in (("card split", step), ("tpufem split", old)):
        ms = k5_pressure_iteration_ms(s, args)
        bd = iteration_bound("K3", s.pressure.K, 1, s.pressure.ac_inv)
        parts.append(f"{name} ({len(s.pressure.K.offsets)} pressure planes, "
                     f"{s.pressure.K.n_rest} remainder entries; Gdx {len(s.Gdx.offsets)} planes) "
                     f"{ms:.4f} ms a pressure iteration, bound {bd:.4f} ({100 * bd / ms:.1f} %)")
    print(f"[18 iteration] K5 f32 at {problem.mesh.n_nodes} nodes: " + "; ".join(parts))


def phase_k5_kernel(dev, big, old_ops) -> dict:
    small = with_k5(scale_problem(dev, 20, 24, cg_coarse_nodes=64))
    check(small.pressure_solver.block == 3, "n_side=20 with 64 coarse nodes: ragged 3×3 blocks")
    check_k5_problem("n_side=20", small, 3, calls=20, plain_calls=2)
    out = check_k5_problem(f"{big.mesh.n_nodes} nodes", big, 20, calls=10, plain_calls=1)
    k5_iterations(big, old_ops)
    return out


def phase_k5_main_path(k5_problems: dict, unfused, unfused_numbers: dict,
                       steps: int = K5_STEPS) -> int:
    """K5 through the user's entry points at K = 1 and 4 (every count set to
    0 just before each, read just after); returns K5's launches at K = 1."""
    from tpufem_torch.bench import profile_steps

    prof = profile_steps(unfused, K5_PROFILE_STEPS, state=unfused_numbers["state"])
    print(f"[19 K5 main path] unfused (phase 9, same process): cold "
          f"{unfused_numbers['cold']:.2f} warm {unfused_numbers['warm']:.2f} steps/s, device "
          f"{prof['device_ms_per_step']:.3f} ms a step, {prof['kernels_per_step']:.1f} kernels a "
          f"step, busy {prof['device_ms_per_step'] * unfused_numbers['warm'] / 1e3:.3f}")
    launches_k1 = 0
    for k, problem in k5_problems.items():
        problem, counters = bench_large.with_iteration_counters(problem)
        zero_launches()
        cold, state, metrics, warm, state2 = bench_large.run_problem(problem, steps)
        launches = launch_counts()
        iters = bench_large.iterations_per_solve(counters, 2 * steps)
        check(launches == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 2 * steps // k, "K6": 0},
              f"launches {launches} in two {steps}-step runs at K = {k} (want K5 = steps/K)")
        for key, v in {**state, **state2, **metrics}.items():
            if v.is_floating_point():
                check(bool(torch.isfinite(v).all()), f"{key} is finite")
        phys = bench_large.physics_report(problem, state, metrics, steps)  # raises on a failed gate
        prof = profile_steps(problem, K5_PROFILE_STEPS, state=state2)
        prof["device_busy_share"] = prof["device_ms_per_step"] * warm / 1e3
        print(f"[19 K5 main path] K = {k}, {problem.mesh.n_nodes} nodes, {steps}+{steps} steps: "
              f"cold {cold:.2f} steps/s, warm {warm:.2f} steps/s (unfused "
              f"{unfused_numbers['warm']:.2f}); "
              f"launches {launches}; mean iterations per solve {iters}; device {json.dumps(prof)}; "
              f"{json.dumps(phys)}")
        if k == 1:
            launches_k1 = launches["K5"]
    return launches_k1


# K5 at f64, card against CPU over 10 steps at n_side=40, relative L2 of u:
# summation order only with fixed iterations; with tol 1e-5 the pressure
# solves stop on a tolerance and leave ~1e-9 of p between the two orders,
# which reaches u (the unfused grid path reads the same 1.4e-9 there, phase
# 10; both measured on the card)
K5_PARITY_RTOL = {0.0: 1e-9, 1e-5: 1e-8}


def phase_k5_parity(dev, steps: int = SCALE_PARITY_STEPS) -> None:
    """K5 at f64 on the card against the port's CPU path (its plain version),
    fixed iterations and tol 1e-5; f32 on the card against f64."""
    n_side, n_circle = SCALE_PARITY_MESH
    for tol, rtol in K5_PARITY_RTOL.items():
        runs = {}
        for name, device, precision in (("gpu64", dev, "f64"), ("cpu64", CPU, "f64"),
                                        ("gpu32", dev, "f32")):
            problem = scale_problem(device, n_side, n_circle, precision=precision,
                                    cg_tol_pressure=tol, cg_tol_visc=tol, grid_steps_per_call=1)
            check(problem.grid_step is not None, f"{name}: K5 attached")
            runs[name], _ = stokes.run(problem, steps=steps)
        g, c, f = (runs[k]["u"].double().cpu() for k in ("gpu64", "cpu64", "gpu32"))
        du, dr, df = float((g - c).abs().max()), rel(g, c), rel(f, g)
        print(f"[20 K5 parity] n_side={n_side}, {steps} steps, tol {tol:g}: f64 card vs CPU max "
              f"abs du {du:.3e} (<= 1e-6), u rel {dr:.3e} (<= {rtol:g}); f32 vs f64 card u rel "
              f"{df:.3e} (<= 5e-3)")
        check(du <= 1e-6, f"K5 f64 card vs CPU max abs du {du}")
        check(dr <= rtol, f"K5 f64 card vs CPU u rel {dr}")
        check(df <= 5e-3, f"K5 f32 vs f64 card u rel {df}")


def phase_k5_tracers(dev, steps: int = TRACER_STEPS) -> None:
    problem = scale_problem(dev, *TRACER_MESH, transport="tracers", grid_steps_per_call=1)
    check(problem.grid_step is not None, "K5 attached under tracers")
    zero_launches()
    state, metrics = stokes.run(problem, steps=steps)
    torch.cuda.synchronize()
    check(gs.grid_step.launches == steps,
          f"K5 launched {gs.grid_step.launches} times in {steps} steps")
    for k, v in {**state, **metrics}.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{k} is finite")
    n_tr = problem.tracer_init.shape[0]
    frac = float(metrics["eaten"][-1]) / n_tr
    check(0.0 <= frac <= 1.0, f"captured fraction {frac} in [0, 1]")
    print(f"[21 K5 tracers] {problem.mesh.n_nodes} nodes, {n_tr} tracers, {steps} steps on K5: "
          f"max|u| {float(metrics['max_u'].max()):.4f}, captured {frac:.4f}")


def k5_beside_unfused(label: str, mesh, steps: int, gate: str) -> None:
    """``mesh`` through explicit grid storage (renumbered on the host if it
    is not grid-numbered), the unfused grid path and then K5 (K = 1):
    ``steps`` cold steps from rest and ``steps`` warm, steps/s of both,
    tpufem's ``gate``; then K5 against its plain version on the K5 problem."""
    rates = {}
    for k in (0, 1):
        t0 = time.perf_counter()
        cfg = bench_large.bench_config(n_nodes=mesh.n_nodes, storage="grid", grid_steps_per_call=k)
        problem = stokes.StokesProblem.build(mesh, cfg, device=torch.device("cuda", 0))
        build_s = time.perf_counter() - t0
        g = problem.gridified
        check(problem.mesh.n_nodes == (g.ns ** 2 if g is not None else mesh.n_nodes),
              "the grid storage holds N = ns² nodes")
        check((problem.grid_step is not None) == (k > 0), f"K5 attached iff K = {k} > 0")
        zero_launches()
        cold, state, metrics, warm, _ = bench_large.run_problem(problem, steps)
        launches = launch_counts()
        want = {"K1": 0, "K2": 0 if k else 2 * steps, "K3": 0 if k else 4 * steps, "K4": 0,
                "K5": 2 * steps if k else 0, "K6": 0}
        check(launches == want, f"launches {launches} (want {want})")
        phys = bench_large.physics_report(problem, state, metrics, steps, gate=gate)
        if g is not None:
            u = g.pull(state["u"].double().cpu().numpy())
            check(u.shape == (mesh.n_nodes, 2), "pulled back to the input's nodes")
        Kv, Kp = problem.visc_solver.K, problem.pressure_solver.K
        rates[k] = warm
        where = f"renumbered onto {g.ns}x{g.ns}" if g is not None else "grid-numbered"
        print(f"[22 {label}] {mesh.n_nodes} nodes {where} ({len(Kv.offsets)} viscous planes and "
              f"{Kv.n_rest} remainder entries, {len(Kp.offsets)} pressure planes and {Kp.n_rest}), "
              f"{'K5' if k else 'unfused'}: build {build_s:.1f} s, {steps} steps from rest at "
              f"{cold:.2f} steps/s, {steps} more at {warm:.2f}; launches {launches}; "
              f"{json.dumps(phys)}")
    print(f"[22 {label}] warm steps/s K5 {rates[1]:.2f} against unfused {rates[0]:.2f} "
          f"({rates[1] / rates[0]:.3f}x)")
    state, _ = stokes.run(problem, steps=3)
    step = problem.grid_step
    for dtype in (torch.float32, torch.float64):
        coarse = step.pressure.ac_inv.dtype if dtype == torch.float32 else torch.float64
        s = k5_cast(step, dtype, coarse)
        s = dataclasses.replace(s, visc=dataclasses.replace(s.visc, tol=1e-5),
                                pressure=dataclasses.replace(s.pressure, tol=1e-5))
        check_k5_call(f"{str(dtype)[6:]} tol 1e-5 at {label}", s, k5_state(step, state, dtype),
                      GRID_RTOL[(dtype, 1e-5)], K5_P_RTOL[(dtype, 1e-5)], calls=5, plain_calls=1,
                      phase=22)


def phase_gridify(dev, steps: int = GRIDIFY_STEPS) -> None:
    """A compacted (not grid-numbered) mesh, renumbered on the host, and a
    160,000-node pad_hole mesh: K5 beside the unfused grid path."""
    k5_beside_unfused("gridify", generate_annulus_mesh(*GRIDIFY_MESH, pad_hole=False), steps,
                      "imported")
    k5_beside_unfused("160k", generate_annulus_mesh(*MID_MESH, pad_hole=True), steps, "stokes")


def phase_ns_build(seconds: float) -> None:
    blocks = grid_cg.blocks_per_sm()
    print(f"[12 build] K4 ({grid_cg.library_path().name}, built in the {seconds:.2f} s parallel "
          f"build of phase 2): {ptxas_report(grid_cg.library_path(), 'ns_bicgstab')}")
    for line in instance_report(grid_cg.library_path(), blocks, "ns_bicgstab"):
        print(f"[12 build]   {line}")


def ns_problem(dev, n_side: int, n_circle: int, precision: str = "f32", storage: str = "grid",
               **overrides):
    mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_circle, pad_hole=True)
    return navier_stokes.NSProblem.build(
        mesh, bench_large.ns_config(precision, storage=storage, **overrides), device=dev)


def ns_operator(problem, dtype, refill=None, seed: int = 3):
    """A = Δt·C(u) + νΔt·K of ``problem`` refilled from a seeded u = 0.1·N(0, 1)
    into ``refill``'s layout (default: the problem's own), in ``dtype``,
    with the step's mask and inverse diagonal: (op, mask, inverse diagonal,
    u planes, rhs planes u + Δt·f)."""
    cfg, mesh, dev = problem.config, problem.mesh, problem.device
    refill = refill or problem.grid_refill
    ns = refill.template.ns
    u = torch.as_tensor(0.1 * np.random.default_rng(seed).standard_normal((mesh.n_nodes, 2)),
                        dtype=dtype, device=dev)
    C = refill.refill_flat(assembly.element_convection_flat(mesh, u, "opsplit"))
    K = refill.refill(assembly.element_stiffness(mesh, signed=True).to(dtype=dtype, device=dev))
    nudt = cfg.nu * cfg.dt
    op = dataclasses.replace(C, diags=cfg.dt * C.diags + nudt * K.diags,
                             rest_vals=cfg.dt * C.rest_vals + nudt * K.rest_vals)

    def planes(v):
        return v.T.reshape(-1, ns, ns).contiguous()

    return (op, torch.ones(ns, ns, dtype=dtype, device=dev),
            problem.inv_diag_visc.to(dtype).reshape(ns, ns).contiguous(), planes(u),
            planes(u + cfg.dt * problem.body_force.to(dtype)))


def ns_other_layout(problem):
    """(label, GridRefill) of a second layout of ``problem``'s velocity
    operator: below 360,000 nodes a remainder-heavy one (five planes, the
    rest on the remainder), from there up tpufem's split of the mesh
    pattern (its TPU caps; 13 planes at 1,048,576 nodes), the template K4
    applied before it took the card's."""
    mesh, ns = problem.mesh, problem.grid_refill.template.ns
    pattern = assembly._csr_pattern(mesh)
    csr = _PatternCSR(pattern, mesh.n_nodes)
    dtype, dev = problem.dtype, problem.device
    if mesh.n_nodes >= STREAMED_NODES:
        label, template = "tpufem split", GridOperator.build(csr, ns, dtype=dtype, device=dev)
    else:
        label, template = "five planes", GridOperator.build(csr, ns, dtype=dtype, max_offsets=5,
                                                             rest_budget_bytes=None, device=dev)
    return label, GridRefill.from_template(mesh, template, pattern)


def ns_solver(problem, op, **changes):
    """The problem's K4 solver on ``op``'s layout, without its counter."""
    return dataclasses.replace(problem.vel_solver_grid, offsets=op.offsets, n_rest=op.n_rest,
                               iters_count=None, **changes)


def check_ns_kernel(label: str, problem, calls: int, plain_calls: int, refill=None) -> dict:
    """K4 against its plain version on ``problem``'s operator in ``refill``'s
    layout (default: the problem's) at f32 and f64, fixed 30 iterations from
    zero and tol 1e-5 from the step's warm start; returns the numbers of the
    f32 tol 1e-5 case."""
    dev = problem.device
    at_main = {}
    for dtype in (torch.float32, torch.float64):
        op, mask, invd, u, b_step = ns_operator(problem, dtype, refill)
        b_rand = torch.as_tensor(np.random.default_rng(8).standard_normal(tuple(u.shape)),
                                 dtype=dtype, device=dev)

        def kernel(s, b, x0, it=None):
            return grid_cg.ns_bicgstab(s, op, mask, invd, b, x0, it)

        def plain(s, b, x0, it=None):
            return grid_cg.ns_bicgstab_ref(s, op, mask, invd, b, x0, it)

        for iters, tol, b, x0 in ((30, 0.0, b_rand, torch.zeros_like(u)), (30, 1e-5, b_step, u)):
            s = ns_solver(problem, op, iters=iters, tol=tol)
            case = (f"K4 {str(dtype)[6:]} {'tol 1e-5 warm' if tol else 'fixed 30'} at {label} "
                    f"({len(op.offsets)} planes, {op.n_rest} remainder entries)")
            numbers = check_solve(13, case, kernel, plain, s, b, x0, GRID_RTOL[(dtype, tol)],
                                  calls, plain_calls)
            if dtype == torch.float32 and tol:
                iters = numbers.pop("iters")
                at_main = {**numbers, **solve_bound("K4", op, 2, iters), "library_ms": None}
                print(f"[13 kernel] K4 warm solve at {label}: {numbers['ms']:.4f} ms ({iters} "
                      f"iteration(s)), bound {at_main['bound_ms']:.4g} ms "
                      f"({100 * at_main['bound_ms'] / numbers['ms']:.3g} %)")
    return at_main


def check_ns_pressure(label: str, problem, calls: int, plain_calls: int) -> None:
    """K3 against its plain version on the NS step's own pressure operator
    (active mask deg > 0, no periodic pairs): the step's instance, with the
    problem's field and coarse dtypes, and the same at f64 throughout."""
    pres = problem.pressure_solver
    rng = np.random.default_rng(9)
    ns = pres.K.ns
    for dtype, coarse in ((pres.K.diags.dtype, pres.ac_inv.dtype), (torch.float64, torch.float64)):
        solver = k3_cast(pres, dtype, coarse)
        b = torch.as_tensor(rng.standard_normal((ns, ns)), dtype=dtype, device=problem.device)
        b = b * solver.act_grid  # a prepared rhs: zero off the active dofs
        check_cg_cases(13, f"K3 coarse {str(coarse)[6:]} {str(dtype)[6:]} NS pressure at {label}",
                       grid_cg.pressure_cg, grid_cg.pressure_cg_ref, solver, b, calls, plain_calls)


def ns_iterations(problem, other) -> None:
    """Phase 13's ms an iteration of K3 on the NS pressure operator (the
    step's f32 instance) in the card's split and in tpufem's, and of K4
    (f32) on the problem's template and on ``other``, (label, GridRefill)."""
    pres = problem.pressure_solver
    mesh, ns, dev = problem.mesh, pres.K.ns, problem.device
    kp = assembly.assemble_csr(mesh, assembly.element_stiffness(mesh, signed=False))
    old = GridOperator.build(kp.astype(pres.K.dtype), ns, dtype=pres.K.dtype, device=dev)
    rng = np.random.default_rng(13)
    b = torch.as_tensor(rng.standard_normal((ns, ns)), dtype=pres.K.dtype, device=dev)
    b = b * pres.act_grid
    iteration_report(13, f"NS pressure at {mesh.n_nodes} nodes", "K3", grid_cg.pressure_cg,
                     [("card split", pres, pres.K),
                      ("tpufem split", dataclasses.replace(pres, K=old), old)], b)
    b2 = torch.as_tensor(rng.standard_normal((2, ns, ns)), dtype=torch.float32, device=dev)
    for name, refill in (("card split", None), other):
        op, mask, invd, _, _ = ns_operator(problem, torch.float32, refill)

        def k4(s, b, x0, it=None, op=op, mask=mask, invd=invd):
            return grid_cg.ns_bicgstab(s, op, mask, invd, b, x0, it)

        iteration_report(13, f"at {mesh.n_nodes} nodes", "K4", k4,
                         [(name, ns_solver(problem, op), op)], b2)


def phase_ns_kernel(dev, big) -> dict:
    # 64 coarse nodes give ragged 3×3 blocks at n_side=20.  With the default
    # 2048 the coarse space is the whole grid (block 1), the preconditioner
    # is exact, and a fixed-iteration f32 solve converges in one or two
    # iterations and then iterates on roundoff, where kernel and plain
    # version drift apart (both diverge; the step's tol 1e-5 stops at one)
    small = ns_problem(dev, 20, 24, cg_coarse_nodes=64)
    check(small.pressure_solver.block == 3 and small.pressure_solver.n_blocks == 7,
          "n_side=20 with cg_coarse_nodes=64 gives ragged 3×3 blocks")
    check_ns_kernel("n_side=20", small, calls=20, plain_calls=5)
    name, refill = ns_other_layout(small)
    check_ns_kernel(f"n_side=20, {name}", small, calls=20, plain_calls=5, refill=refill)
    check_ns_pressure("n_side=20", small, calls=20, plain_calls=5)
    check_ns_pressure(f"{big.mesh.n_nodes} nodes", big, calls=5, plain_calls=2)
    out = check_ns_kernel(f"{big.mesh.n_nodes} nodes", big, calls=20, plain_calls=2)
    other = ns_other_layout(big)
    check_ns_kernel(f"{big.mesh.n_nodes} nodes, {other[0]}", big, calls=20, plain_calls=2,
                    refill=other[1])
    ns_iterations(big, other)
    return out


def phase_ns_main_path(problem, build_s: float, steps: int = NS_STEPS) -> dict:
    """The NS configuration through the user's entry points; returns the
    launch counts of K4 and K3 over both runs (every count set to 0 just
    before, read just after)."""
    problem, counters = bench_large.with_iteration_counters(problem, bench_large.NS_SOLVES)
    zero_launches()
    row = bench_large.run_ns_problem(problem, steps, counters)
    launches = launch_counts()
    check(launches == {"K1": 0, "K2": 0, "K3": 2 * steps, "K4": 2 * steps, "K5": 0, "K6": 0},
          f"launches {launches} in two {steps}-step NS runs (want K4 = K3 = steps)")
    u, p = row.pop("state")
    check(bool(torch.isfinite(u).all() and torch.isfinite(p).all()), "NS state is finite")
    t = problem.grid_refill.template
    print(f"[14 NS main path] {problem.mesh.n_nodes} nodes ({len(t.offsets)} velocity planes, "
          f"{t.n_rest} remainder entries; {len(problem.pressure_solver.K.offsets)} pressure "
          f"planes), {steps}+{steps} steps: build {build_s:.1f} s, cold "
          f"{row['cold_steps_per_sec']:.2f} steps/s, warm {row['warm_steps_per_sec']:.2f} "
          f"steps/s; launches {launches}; {json.dumps(row)}")
    return launches


def phase_ns_grid_parity(dev, steps: int = NS_PARITY_STEPS) -> None:
    """The NS grid path: f64 kernels on the card against the plain versions
    on the CPU; f32 on the card against f64."""
    runs = {}
    for name, device, precision in (("gpu64", dev, "f64"), ("cpu64", torch.device("cpu"), "f64"),
                                    ("gpu32", dev, "f32")):
        problem = ns_problem(device, *NS_PARITY_MESH, precision=precision)
        check(problem.grid_refill is not None, f"{name} took the grid path")
        runs[name], _ = navier_stokes.run(problem, steps=steps)
    g, c, f = (runs[k].double().cpu() for k in ("gpu64", "cpu64", "gpu32"))
    du, dr = float((g - c).abs().max()), rel(g, c)
    df = rel(f, g)
    print(f"[15 NS grid parity] n_side={NS_PARITY_MESH[0]}, {steps} steps, max|u| "
          f"{float(c.abs().max()):.3e}: f64 card vs CPU max abs du {du:.3e} (<= 1e-6), u rel "
          f"{dr:.3e} (<= 1e-9); f32 vs f64 card u rel {df:.3e} (<= 5e-3)")
    check(du <= 1e-6, f"NS f64 card vs CPU max abs du {du}")
    # |u| is about 1e-5 here, so the absolute bound alone would let a wrong
    # f64 kernel through: the f64 runs differ in summation order only
    check(dr <= 1e-9, f"NS f64 card vs CPU u rel {dr}")
    check(df <= 5e-3, f"NS f32 vs f64 card u rel {df}")


def phase_ns_dense_parity(dev, steps: int = NS_DENSE_STEPS) -> None:
    mesh = generate_annulus_mesh(*NS_DENSE_MESH)
    runs = {}
    for name, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
        problem = navier_stokes.NSProblem.build(mesh, navier_stokes.NSConfig(), device=device)
        runs[name], _ = navier_stokes.run(problem, steps=steps)
    du = rel(runs["gpu"], runs["cpu"])
    print(f"[16 NS dense parity] {mesh.n_nodes} nodes, {steps} steps, f64: card vs CPU u rel "
          f"{du:.3e} (<= 1e-10), max|u| {float(runs['gpu'].abs().max()):.4e}")
    check(du <= 1e-10, f"NS dense f64 card vs CPU rel {du}")


# ---------------------------------------------------------------------------
# The space-sharded grid path and K6
# ---------------------------------------------------------------------------

HALO_SHARDS = (1, 2, 4, 8)
# the 1,048,576-node strips on 4 shards, and a ragged shape: 1001 values a
# row is no multiple of 16 bytes in f32 or f64, so K6 takes its scalar path
HALO_SHAPES = ((256, 1024), (64, 1001))
SHARDS = 4
SHARDED_STEPS = 20
SHARDED_PROFILE_STEPS = 1
SHARDED_PARITY_MESH = (40, 48)
SHARDED_PARITY_STEPS = 10
# tpufem's sharded-solver and dryrun configuration (tests/test_parallel.py)
SHARDED_PARITY_CONFIG = dict(solver="cg", cg_storage="grid", precision="f64",
                             cg_precond="twolevel", cg_iters_visc=25, cg_iters_pressure=40,
                             cg_warm_start=False, transport="none")
SHARDED_TOL = dict(cg_iters_visc=60, cg_iters_pressure=80, cg_tol_visc=1e-8,
                   cg_tol_pressure=1e-8)


def shard_mesh(devs):
    """A one-row mesh with one shard on each of ``devs`` (repeats allowed)."""
    return build_device_mesh(len(devs), data=1, devices=list(devs))


def wall_ms(fn, *args, calls: int = TIMED_CALLS) -> float:
    """Mean ms per call by the host clock, every card synchronised (for
    work on several cards, which one CUDA graph or stream cannot time)."""
    for _ in range(10):
        fn(*args)
    sync_all()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    sync_all()
    return (time.perf_counter() - t0) / calls * 1e3


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def halo_dmax(problem) -> int:
    """The sharded solvers' halo depth: the largest |dy| of both operators."""
    ns = problem.visc_solver.K.ns
    offsets = problem.visc_solver.K.offsets + problem.pressure_solver.K.offsets
    return max([abs(_signed_dy(dy, ns)) for dy, _ in offsets] + [1])


def phase_halo_kernel(devs, dmax: int, build_s: float) -> dict:
    """K6 against its plain version, bit for bit, in every case (shard i on
    card i mod the cards of ``devs``); returns the numbers at the main
    path's shape (f32, one strip on each of ``devs``, d = dmax)."""
    print(f"[23 build] K6 ({rdma.library_path().name}, built in the {build_s:.2f} s parallel "
          f"build of phase 2): {ptxas_report(rdma.library_path())}")
    cards = sorted(set(devs), key=lambda v: v.index)
    rng = np.random.default_rng(23)
    err = 0.0
    for h, ns in HALO_SHAPES:
        for dtype in (torch.float32, torch.float64):
            cases = 0
            for S in HALO_SHARDS:
                for d in sorted({1, 3, dmax}):
                    x = [torch.as_tensor(rng.standard_normal((h, ns)), dtype=dtype,
                                         device=cards[i % len(cards)]) for i in range(S)]
                    got, want = rdma.halo_rdma(x, d), rdma.halo_rdma_ref(x, d)
                    sync_all()
                    check(all(a.device == b.device and torch.equal(a, b)
                              for a, b in zip(got, want)),
                          f"K6 {h}x{ns} {dtype} S={S} d={d}: not bit-equal to torch.cat")
                    err = max([err] + [float((a - b).abs().max()) for a, b in zip(got, want)])
                    cases += 1
            print(f"[23 kernel] K6 ({h}, {ns}) {str(dtype)[6:]}: {cases} cases (S in "
                  f"{HALO_SHARDS} over {len(cards)} card(s), d in {sorted({1, 3, dmax})}) "
                  "bit-equal to the plain version")
    h, ns = HALO_SHAPES[0]
    x = [torch.as_tensor(rng.standard_normal((h, ns)), dtype=torch.float32, device=v)
         for v in devs]

    def library(x, d):  # one torch.cat of the three slices a shard
        return [torch.cat([x[i - 1][-d:].to(x[i].device), x[i],
                           x[(i + 1) % len(x)][:d].to(x[i].device)]) for i in range(len(x))]

    # one card: device time (CUDA-graph replay); several: the host clock
    timer, unit = (device_ms, "device") if len(cards) == 1 else (wall_ms, "wall")
    ms = timer(rdma.halo_rdma, x, dmax)
    plain_ms = timer(rdma.halo_rdma_ref, x, dmax)
    library_ms = timer(library, x, dmax)
    nbytes = len(devs) * (2 * h + 2 * dmax) * ns * 4
    at_main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound(nbytes, 0.0),
               "library_ms": library_ms}
    print(f"[23 kernel] K6 at the main path's shape ({len(devs)} x ({h}, {ns}) f32 on "
          f"{len(cards)} card(s), d = {dmax}): {unit} us a call K6 {ms * 1e3:.3f}, plain "
          f"{plain_ms * 1e3:.3f}, {len(devs)} torch.cat {library_ms * 1e3:.3f}; "
          f"{nbytes / 1e6:.2f} MB read and written, bound {at_main['bound_ms'] * 1e3:.3f} us at "
          "3.35 TB/s")
    return at_main


def sharded_pair(problem, devs):
    """(ppermute, rdma) sharded grid solvers of ``problem``, one shard on
    each of ``devs``: [(visc_solve, pressure_solve)] × 2."""
    return [make_sharded_grid_solvers(shard_mesh(devs), problem, halo=h)
            for h in ("ppermute", "rdma")]


def timed_solve_ms(fn, b, calls: int = 1) -> float:
    sync_all()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(b)
    sync_all()
    return (time.perf_counter() - t0) / calls * 1e3


def check_sharded_solvers(label: str, problem, devs, bounds, metric: str) -> None:
    """The sharded solvers (both halos) against the single-device K2/K3 and
    their plain versions on seeded right-hand sides; ``metric`` "abs" holds
    the max abs difference to ``bounds``, "rel" the relative L2."""
    (pv, pp), (rv, rp) = sharded_pair(problem, devs)
    visc, pres = problem.visc_solver, problem.pressure_solver
    rng = np.random.default_rng(24)
    n = problem.mesh.n_nodes
    for name, fns, single, shape, bnd in (
            ("viscous", (rv, pv), (visc.solve, dataclasses.replace(visc, plain=True).solve),
             (n, 2), bounds[0]),
            ("pressure", (rp, pp), (pres.solve, dataclasses.replace(pres, plain=True).solve),
             (n,), bounds[1])):
        b = torch.as_tensor(rng.standard_normal(shape), dtype=problem.dtype, device=devs[0])
        got = [f(b) for f in fns]
        want = [f(b) for f in single]
        sync_all()
        same = rel(got[0], got[1])
        check(same <= (1e-13 if problem.dtype == torch.float64 else 1e-6),
              f"{label} {name}: rdma vs ppermute rel {same}")

        def dist(a, c):
            return float((a - c).abs().max()) if metric == "abs" else rel(a, c)

        errs = [dist(g, w) for g in got for w in want]
        ms = [timed_solve_ms(f, b) for f in (*fns, *single)]
        print(f"[24 sharded solvers] {label} {name}: rdma vs ppermute rel {same:.3e}; "
              f"{metric} to K2/K3 and plain: rdma {errs[0]:.3e} {errs[1]:.3e}, ppermute "
              f"{errs[2]:.3e} {errs[3]:.3e} (<= {bnd:g}); ms a solve rdma {ms[0]:.1f}, "
              f"ppermute {ms[1]:.1f}, single-device kernel {ms[2]:.2f}, plain {ms[3]:.1f}")
        check(max(errs) <= bnd, f"{label} {name}: {metric} {errs} > {bnd}")


def phase_sharded_solvers(devs, big) -> None:
    mesh = generate_annulus_mesh(*SHARDED_PARITY_MESH, pad_hole=True)
    small = stokes.StokesProblem.build(mesh, stokes.StokesConfig(**SHARDED_PARITY_CONFIG),
                                       device=devs[0])
    check_sharded_solvers(f"n_side={SHARDED_PARITY_MESH[0]} f64 fixed", small, devs,
                          (1e-12, 1e-9), "abs")
    tol = stokes.StokesProblem.build(
        mesh, stokes.StokesConfig(**{**SHARDED_PARITY_CONFIG, **SHARDED_TOL}), device=devs[0])
    check_sharded_solvers(f"n_side={SHARDED_PARITY_MESH[0]} f64 tol 1e-8", tol, devs,
                          (1e-6, 1e-5), "abs")
    check_sharded_solvers(f"{big.mesh.n_nodes} nodes f32", big, devs, (1e-3, 1e-3), "rel")


def run_matfree_sharded(step, u, steps: int):
    """``steps`` sharded steps from ``u``: (u, metric series on the device)."""
    series = {}
    for i in range(steps):
        u, m = step(u)
        for k, v in m.items():
            series.setdefault(k, torch.empty(steps, dtype=v.dtype, device=v.device))[i] = v
    return u, series


def phase_sharded_main_path(devs, big, steps: int = SHARDED_STEPS) -> int:
    """The sharded step with K6 through the user's entry point (every count
    set to 0 just before, read just after); returns K6's launches."""
    problem, counters = bench_large.with_iteration_counters(big)
    step = make_sharded_matfree_step(shard_mesh(devs), problem, halo="rdma")
    u0 = stokes.initial_state(problem)["u"]
    zero_launches()
    sync_all()
    t0 = time.perf_counter()
    u, series = run_matfree_sharded(step, u0, steps)
    sync_all()
    rate = steps / (time.perf_counter() - t0)
    launches = launch_counts()
    visc_it = int(counters["visc_solver"][0].item())
    pres_it = int(counters["pressure_solver"][0].item())
    # one halo a viscous iteration; 3k + 2 a two-level pressure solve of k
    # iterations, and its two rolls (grid_sharded's docstring); one launch a
    # halo on each card
    want_k6 = (visc_it + 3 * pres_it + 4 * 2 * steps) * len(set(devs))
    check(launches == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": want_k6},
          f"launches {launches} in {steps} sharded steps (want K6 = {want_k6} from "
          f"{visc_it} viscous and {pres_it} pressure iterations)")
    phys = bench_large.physics_report(problem, {"u": u}, series, steps)  # raises on a failed gate
    prof = profile_run(lambda: run_matfree_sharded(step, u, SHARDED_PROFILE_STEPS),
                       SHARDED_PROFILE_STEPS, top=200)
    k6_ms = sum(t["ms_per_step"] for t in prof["top"] if "halo_push" in t["name"])
    # the single-device unfused step on the same problem, its solves from zero too
    single = dataclasses.replace(big, config=dataclasses.replace(big.config, cg_warm_start=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stokes.run(single, steps=steps)
    torch.cuda.synchronize()
    single_rate = steps / (time.perf_counter() - t0)
    sprof = profile_run(lambda: stokes.run(single, steps=SHARDED_PROFILE_STEPS),
                        SHARDED_PROFILE_STEPS)
    print(f"[25 sharded main path] {problem.mesh.n_nodes} nodes, {len(devs)} shards on "
          f"{len(set(devs))} card(s), "
          f"halo='rdma', {steps} steps from rest: {rate:.2f} steps/s; launches {launches}; "
          f"iterations a solve viscous {visc_it / (2 * steps):.2f} (a column), pressure "
          f"{pres_it / (2 * steps):.2f}; device {prof['device_ms_per_step']:.3f} ms and "
          f"{prof['kernels_per_step']:.0f} kernels a step, K6 {k6_ms:.3f} ms a step "
          f"({100 * k6_ms / prof['device_ms_per_step']:.2f} %); single-device unfused step from "
          f"zero: {single_rate:.2f} steps/s, device {sprof['device_ms_per_step']:.3f} ms and "
          f"{sprof['kernels_per_step']:.0f} kernels a step; {json.dumps(phys)}")
    return launches["K6"]


def phase_sharded_parity(devs, steps: int = SHARDED_PARITY_STEPS) -> None:
    """f64 at n_side=40: the card's sharded step (K6) against the port's CPU
    sharded step (plain), both against the single-device step; dist_cg
    against the single-device CSR viscous solve."""
    mesh = generate_annulus_mesh(*SHARDED_PARITY_MESH, pad_hole=True)
    out = {}
    for name, shards in (("gpu", devs), ("cpu", [CPU] * len(devs))):
        device = shards[0]
        problem = stokes.StokesProblem.build(mesh, stokes.StokesConfig(**SHARDED_PARITY_CONFIG),
                                             device=device)
        halo = "rdma" if device.type == "cuda" else "ppermute"
        step = make_sharded_matfree_step(shard_mesh(shards), problem, halo=halo)
        zero_launches()
        u, _ = run_matfree_sharded(step, stokes.initial_state(problem)["u"], steps)
        check((rdma.halo_rdma.launches > 0) == (device.type == "cuda"),
              f"{name}: K6 launched {rdma.halo_rdma.launches} times")
        single, _ = stokes.run(problem, steps=steps)
        out[name] = (u.double().cpu(), single["u"].double().cpu())
    (g, g_single), (c, c_single) = out["gpu"], out["cpu"]
    d_gc = rel(g, c)
    d_single = [float((g - g_single).abs().max()), float((c - c_single).abs().max())]
    print(f"[26 sharded parity] n_side={SHARDED_PARITY_MESH[0]} f64, {len(devs)} shards, {steps} "
          f"steps: card (K6) vs CPU sharded u rel {d_gc:.3e} (<= 1e-10); sharded vs single-device "
          f"max abs du card {d_single[0]:.3e}, CPU {d_single[1]:.3e} (<= 1e-8)")
    check(d_gc <= 1e-10, f"sharded card vs CPU rel {d_gc}")
    check(max(d_single) <= 1e-8, f"sharded vs single-device max abs {d_single}")

    K = assembly.assemble_csr(mesh, assembly.element_stiffness(mesh))
    problem = stokes.StokesProblem.build(mesh, stokes.StokesConfig(**SHARDED_PARITY_CONFIG),
                                         device=devs[0])
    mask = problem.visc_solver.interior_mask
    Kd = K.astype(torch.float64, devs[0])
    b = torch.as_tensor(np.random.default_rng(26).standard_normal((mesh.n_nodes, 2)),
                        device=devs[0])
    x = make_sharded_viscous_solver(shard_mesh(devs), Kd, mask.cpu().numpy(), 0.005, iters=80)(b)
    y = ViscousCG(K=Kd, interior_mask=mask, dt_nu=0.005, iters=80).solve(b)
    dx = float((x - y).abs().max())
    print(f"[26 sharded parity] dist_cg viscous CG ({len(devs)} row slabs, 80 iterations) vs the "
          f"single-device CSR solve on the card: max abs {dx:.3e} (<= 1e-9)")
    check(dx <= 1e-9, f"dist_cg vs single-device max abs {dx}")


# ---------------------------------------------------------------------------
# The rest of the Stokes workload: the gait campaign, Eulerian, griddata and
# report runs
# ---------------------------------------------------------------------------

SWEEP_MESH = (33, 48)  # 852 nodes, tracer_density 25: 488 tracers
SWEEP_PARITY_STEPS = 300
SWEEP_WARM_STEPS = 1000  # the warm campaign's steps a gait (the cold one runs all 6000)
EUL_STEPS = 50
EUL_PROFILE_STEPS = 5
EUL_DENSE_MESH = (12, 16)
EUL_DENSE_STEPS = 20
EUL_F32_STEPS = 200
REPORT_STEPS = 50
REPORT_TIMED_STEPS = 1000
VARIANT_STEPS = 20
# The f64 dense dye solve carries the ±1e10 penalty on a mass-scaled matrix
# (cond 3.4e13 on (12, 16)): eliminating the penalty rows rounds away
# ~ε·1e10 ≈ 1e-6 of rows whose scale is ~1e-3, so the scheme itself holds c
# to ~1e-3.  The card's LAPACK and the CPU's land 2.5e-3 apart in relative L2
# over 20 steps (8.2e-3 max abs; measured), as far as the f64 penalty and
# the exact f32 merge do: c is held in relative L2 at 5e-3 there, u (which
# the dye does not feed) at 1e-8.
EUL_PENALTY_C_RTOL = 5e-3


def phase_sweep(dev) -> tuple:
    """The port's gait campaign cold (6000 steps a gait) and warm
    (SWEEP_WARM_STEPS), K1 on every step of every gait; then its f32
    fractions on the card against the f64 ones on the CPU at
    SWEEP_PARITY_STEPS.  Returns (the cold campaign's results, the f32 card
    campaign's at SWEEP_PARITY_STEPS) for phase 40."""
    mesh = generate_annulus_mesh(*SWEEP_MESH)
    full = sweep.SweepConfig()
    results = {}
    for run, cfg in (("cold", full), ("warm", dataclasses.replace(full, steps=SWEEP_WARM_STEPS))):
        zero_launches()
        t0 = time.perf_counter()
        res = results[run] = sweep.food_capture_sweep(mesh, cfg, device=dev)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        want = len(cfg.b2_values) * cfg.steps
        check(counts == {"K1": want, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0},
              f"launches {counts} in a {len(cfg.b2_values)}-gait campaign (want K1 = {want})")
        gaits = "; ".join(f"B2={b2:g}: {r['seconds']:.2f} s, eaten {r['eaten']} of "
                          f"{r['tracers']}, fraction {r['consumed_fraction']:.4f}"
                          for b2, r in res.items())
        for b2, r in res.items():
            check(0.0 <= r["consumed_fraction"] <= 1.0, f"B2={b2} fraction in [0, 1]")
        print(f"[27 sweep] {run}: {len(cfg.b2_values)} gaits x {cfg.steps} steps on {mesh.n_nodes} "
              f"nodes, f32 fused on K1: campaign {wall:.2f} s; K1 launches {counts['K1']}; {gaits}")
    short = dataclasses.replace(full, steps=SWEEP_PARITY_STEPS)
    gpu = sweep.food_capture_sweep(mesh, short, device=dev)
    host = sweep.food_capture_sweep(mesh, dataclasses.replace(short, precision="f64"), device=CPU)
    diffs = {b2: abs(gpu[b2]["consumed_fraction"] - host[b2]["consumed_fraction"]) for b2 in gpu}
    print(f"[27 sweep] {SWEEP_PARITY_STEPS} steps, f32 card vs f64 CPU fractions: " + "; ".join(
        f"B2={b2:g} {gpu[b2]['consumed_fraction']:.4f} vs {host[b2]['consumed_fraction']:.4f}"
        for b2 in gpu) + " (within 0.05)")
    for b2, d in diffs.items():
        check(d <= 0.05, f"B2={b2}: f32 card fraction {d} from the f64 CPU one")
    return results["cold"], gpu


def phase_eulerian_scale(mesh, steps: int = EUL_STEPS) -> None:
    """Eulerian dye on the grid path at phase 9's size through the user's
    entry points: K2 once and K3 twice a step, the dye solve (BiCGStab over
    matrix-free applies) between them; tpufem's scale gates."""
    t0 = time.perf_counter()
    cfg = bench_large.bench_config(n_nodes=mesh.n_nodes, transport="eulerian_dye", storage="grid")
    problem = stokes.StokesProblem.build(mesh, cfg, device=torch.device("cuda", 0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(isinstance(problem.visc_solver, grid_cg.ViscousGridCG) and problem.grid_step is None,
          "Eulerian dye at scale takes the grid path, unfused")
    zero_launches()
    cold, state, metrics, warm, state2 = bench_large.run_problem(problem, steps)
    counts = launch_counts()
    check(counts == {"K1": 0, "K2": 2 * steps, "K3": 4 * steps, "K4": 0, "K5": 0, "K6": 0},
          f"launches {counts} in two {steps}-step runs (want K2 = steps, K3 = 2·steps)")
    phys = bench_large.physics_report(problem, state, metrics, steps)  # raises on a failed gate
    c = state2["c"]
    lo, hi = float(c.min()), float(c.max())
    check(bool(torch.isfinite(c).all()) and lo >= 0.0 and hi <= 1.0, f"c in [0, 1]: [{lo}, {hi}]")
    prog = float(metrics["mixing_progress"][-1])
    check(prog > 0.0, f"mixing progress {prog} > 0")
    prof = profile_run(lambda: stokes.run(problem, steps=EUL_PROFILE_STEPS, state=state2),
                       EUL_PROFILE_STEPS, top=10)
    u = state2["u"]
    dye = profile_run(lambda: [stokes.eulerian_dye_step(problem, c, u)
                               for _ in range(EUL_PROFILE_STEPS)], EUL_PROFILE_STEPS, top=6)
    share = dye["device_ms_per_step"] / prof["device_ms_per_step"]
    print(f"[28 Eulerian scale] {mesh.n_nodes} nodes, {steps}+{steps} steps: build {build_s:.1f} s "
          f"(locator included), cold {cold:.2f} steps/s, warm {warm:.2f} steps/s; launches "
          f"{counts}; c in [{lo:.3e}, {hi:.6f}], mixing progress {prog:.4f}; {json.dumps(phys)}")
    print(f"[28 Eulerian scale] device a warm step: {json.dumps(prof)}")
    print(f"[28 Eulerian scale] the dye step alone: {dye['device_ms_per_step']:.3f} of "
          f"{prof['device_ms_per_step']:.3f} device ms a step ({100 * share:.1f} %), "
          f"{dye['kernels_per_step']:.0f} of {prof['kernels_per_step']:.0f} kernels; "
          f"{json.dumps(dye['top'])}")


def card_and_cpu(mesh, steps: int, dev, **kw):
    """``stokes.run`` of one configuration from rest on the card and on the
    CPU: (card state, CPU state), both as float64 on the CPU."""
    out = []
    for device in (dev, CPU):
        problem = stokes.StokesProblem.build(mesh, stokes.StokesConfig(**kw), device=device)
        state, _ = stokes.run(problem, steps=steps)
        out.append({k: v.double().cpu() for k, v in state.items() if v.is_floating_point()})
    return out


def phase_eulerian_parity(dev) -> None:
    """Eulerian dye at f64, card against CPU: the dense penalty path, the
    grid path (kernels against plain versions); then f32 merge on the card
    against its f64 run."""
    mesh = generate_annulus_mesh(*EUL_DENSE_MESH)
    g, c = card_and_cpu(mesh, EUL_DENSE_STEPS, dev, dt=0.01, nu=1.0, transport="eulerian_dye")
    du, dc = rel(g["u"], c["u"]), rel(g["c"], c["c"])
    print(f"[29 Eulerian parity] dense penalty, {mesh.n_nodes} nodes, {EUL_DENSE_STEPS} steps, f64 "
          f"card vs CPU: u rel {du:.3e} (<= 1e-8), c rel {dc:.3e} (<= {EUL_PENALTY_C_RTOL:g}), "
          f"max abs {float((g['c'] - c['c']).abs().max()):.3e}")
    check(du <= 1e-8, f"dense Eulerian u card vs CPU rel {du}")
    check(dc <= EUL_PENALTY_C_RTOL, f"dense Eulerian c card vs CPU rel {dc}")

    n_side, n_circle = SCALE_PARITY_MESH
    runs = {}
    for name, device in (("gpu", dev), ("cpu", CPU)):
        problem = scale_problem(device, n_side, n_circle, precision="f64",
                                transport="eulerian_dye")
        zero_launches()
        state, _ = stokes.run(problem, steps=SCALE_PARITY_STEPS)
        runs[name] = (state, launch_counts())
    (g, kg), (c, kc) = runs["gpu"], runs["cpu"]
    du = float((g["u"].cpu() - c["u"]).abs().max())
    dc = float((g["c"].cpu() - c["c"]).abs().max())
    print(f"[29 Eulerian parity] grid path n_side={n_side}, {SCALE_PARITY_STEPS} steps, f64 card "
          f"(K2 {kg['K2']}, K3 {kg['K3']} launches) vs CPU (plain, {kc['K2'] + kc['K3']}): max abs "
          f"du {du:.3e}, dc {dc:.3e} (<= 1e-6)")
    check(kg["K2"] == SCALE_PARITY_STEPS and kg["K3"] == 2 * SCALE_PARITY_STEPS
          and kc["K2"] + kc["K3"] == 0, f"grid Eulerian launches card {kg}, CPU {kc}")
    check(du <= 1e-6 and dc <= 1e-6, f"grid Eulerian card vs CPU max abs du {du}, dc {dc}")

    mesh = bench_mesh()
    kw = dict(transport="eulerian_dye", solver="inverse", pressure_mode="merge")
    runs = {}
    for precision in ("f64", "f32"):
        problem = stokes.StokesProblem.build(mesh, stokes.StokesConfig(precision=precision, **kw),
                                             device=dev)
        runs[precision], _ = stokes.run(problem, steps=EUL_F32_STEPS)
    dc = rel(runs["f32"]["c"], runs["f64"]["c"])
    print(f"[29 Eulerian parity] dense merge f32 vs f64 (penalty dye solve) on the card, "
          f"{mesh.n_nodes} nodes, {EUL_F32_STEPS} steps: c rel {dc:.3e} (<= 5e-3), u rel "
          f"{rel(runs['f32']['u'], runs['f64']['u']):.3e}")
    check(dc <= 5e-3, f"f32 Eulerian c vs f64 rel {dc}")


def phase_variants(dev) -> None:
    """The report variant (dense LU penalty, then CSR), griddata dye and
    dense_ops=False, f64 card against CPU; the report path's steps/s."""
    mesh = bench_mesh()
    report = dict(variant="report", bc_kind="rotating", dt=1e-5, ramp_steps=200,
                  pressure_smoothing=0.01, double_projection=False)
    g, c = card_and_cpu(mesh, REPORT_STEPS, dev, **report)
    du = rel(g["u"], c["u"])
    problem = stokes.StokesProblem.build(mesh, stokes.StokesConfig(**report), device=dev)
    sps, state, metrics = timed_run(problem, REPORT_TIMED_STEPS)
    sps2, _, _ = timed_run(problem, REPORT_TIMED_STEPS)
    check(bool(torch.isfinite(state["u"]).all()), "report u is finite")
    print(f"[30 variants] report (tpufem's CLI configuration), {mesh.n_nodes} nodes, "
          f"{REPORT_STEPS} steps f64 card vs CPU: u rel {du:.3e} (<= 1e-8); {REPORT_TIMED_STEPS} "
          f"steps on the card: {sps:.1f} then {sps2:.1f} steps/s, max|u| "
          f"{float(metrics['max_u'][-1]):.4f}, final div {float(metrics['final_div_max'][-1]):.3e}")
    check(du <= 1e-8, f"report u card vs CPU rel {du}")

    small = generate_annulus_mesh(*SCALE_PARITY_MESH)
    g, c = card_and_cpu(small, SCALE_PARITY_STEPS, dev, solver="cg", cg_storage="csr", **report)
    checks = {"report CSR": (rel(g["u"], c["u"]), 1e-9)}
    for name, kw in (("griddata", dict(transport="dye_griddata")),
                     ("dense_ops=False", dict(dense_ops=False, transport="dye"))):
        g, c = card_and_cpu(mesh, VARIANT_STEPS, dev, dt=0.01, nu=1.0, solver="inverse",
                            pressure_mode="merge", **kw)
        checks[name] = (max(rel(g["u"], c["u"]), float((g["c"] - c["c"]).abs().max())), 1e-10)
    print(f"[30 variants] f64 card vs CPU: report on CSR (Jacobi) at {small.n_nodes} nodes, "
          f"{SCALE_PARITY_STEPS} steps; griddata and dense_ops=False at {mesh.n_nodes} nodes, "
          f"{VARIANT_STEPS} steps (u rel, c max abs): " + "; ".join(
              f"{k} {v:.3e} (<= {lim:g})" for k, (v, lim) in checks.items()))
    for k, (v, lim) in checks.items():
        check(v <= lim, f"{k} card vs CPU {v} > {lim}")


# ---------------------------------------------------------------------------
# Poisson, heat, the small workloads and the dense Taylor–Hood solvers
# ---------------------------------------------------------------------------

HEAT_STEPS = 50
SMALL_MESH = (20, 24)
AD_STEPS = 100
STAM_FRAMES = 400
STAM_PROFILE_FRAMES = 5
STAM_PARITY = dict(size=64, precision="f64")
STAM_PARITY_FRAMES = 50
TH_MESH = (28, 32)  # P2-refined: 2,292 velocity nodes, 5,192 dofs
TH_STEPS = 200
TH_CONFIG = dict(dt=0.01)


def no_kernel_launches(label: str) -> None:
    """Check that none of K1–K6 launched since the counts were set to 0."""
    counts = launch_counts()
    check(not any(counts.values()), f"{label} launched kernels of the port: {counts}")


def phase_poisson_scale(dev, mesh) -> None:
    """tpufem's ``run_poisson_large`` on phase 9's mesh: f32, two-level
    BiCGStab on the surgery operator (on the stencil, as tpufem's), at
    most 2000 iterations, tol 1e-6;
    its gates; build, first and second solve seconds, iterations, and the
    profiler's device time an iteration (the index kernels' share, the
    device's busy share of the second solve)."""
    zero_launches()
    row = bench_large.run_poisson_large(*SCALE_MESH, device=dev, mesh=mesh)
    no_kernel_launches("the Poisson solve")
    prof = row.pop("profile_per_iteration")
    print(f"[31 Poisson] {row['n_nodes']} nodes, f32, {row['storage']} ({row['nnz']} stored "
          f"entries): build {row['build_s']:.1f} s, "
          f"solves {row['compile_plus_solve_s']:.3f} then {row['solve_s']:.3f} s, "
          f"{row['iterations']} iterations ({row['first_iterations']} the first), "
          f"{1e3 * row['solve_s'] / row['iterations']:.3f} ms an iteration; res_rel "
          f"{row['res_rel']:.3e} (< 1e-4), Dirichlet off by {row['bc_err_max']:.3e} (< 1e-3); "
          f"launches of K1-K6 0; {json.dumps(row)}")
    print(f"[31 Poisson] device an iteration: {prof['device_ms_per_step']:.4f} ms, "
          f"{prof['kernels_per_step']:.1f} kernels, busy {100 * prof['device_busy_share']:.1f} % "
          f"of the second solve, index kernels (gathers, index_add_) "
          f"{100 * prof['index_share']:.1f} %: {json.dumps(prof['top'])}")
    poisson_storages(dev, mesh)
    no_kernel_launches("the Poisson storages")


def poisson_storages(dev, mesh) -> None:
    """Phase 31's operator as CSR, on the stencil (``op`` of
    ``build_system_csr``, the storage ``run_poisson_large`` solves on) and
    on the card's grid split (``GridOperator.dense_split``, its plain apply:
    rolls and a remainder ``index_add_``), the storage the grid kernels
    use: device ms an apply of each beside its byte bound
    (``roofline.apply_bound``), and the two-level BiCGStab solve (f32, tol
    1e-6, ``poisson.cg_solver_on`` each storage) timed CSR, grid, stencil,
    stencil, grid, CSR (phase 47's item 4)."""
    from tpufem_torch.workloads import poisson

    cfg = poisson.PoissonConfig(solver="cg", precision="f32", cg_iters=2000, cg_tol=1e-6)
    op, K, b, _ = poisson.build_system_csr(mesh, cfg, dev)
    check(isinstance(op, StencilOperator), f"the Poisson operator is a {type(op).__name__}")
    ops = {"csr": K.astype(torch.float32), "stencil": op.astype(torch.float32),
           "grid": GridOperator.dense_split(K, int(round(mesh.n_nodes ** 0.5)), device=dev)}
    b = b.to(torch.float32)
    x = torch.randn(mesh.n_nodes, generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    errs = {k: rel(o.matvec(x), ops["csr"].matvec(x)) for k, o in ops.items() if k != "csr"}
    ms = {k: device_ms(o.matvec, x, calls=20) for k, o in ops.items()}
    runs = {k: poisson.cg_solver_on(o, K, mesh, cfg) for k, o in ops.items()}
    solves = {}
    for name in ("csr", "grid", "stencil", "stencil", "grid", "csr"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f, res = runs[name](b)
        torch.cuda.synchronize()
        solves.setdefault(name, []).append((time.perf_counter() - t0, runs[name].iterations,
                                            float(res) / float(torch.linalg.norm(b))))
    grid, st = ops["grid"], ops["stencil"]
    print(f"[31 storage] the Poisson operator ({len(K.indices)} CSR entries; stencil "
          f"{len(st.offsets)} offsets, {st.n_rest} remainder entries; grid split "
          f"{len(grid.offsets)} planes, {grid.n_rest} remainder entries): apply rel vs CSR "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " (<= 1e-5); device ms an "
          "apply " + ", ".join(f"{k} {ms[k]:.4f} (bound {roofline.apply_bound(o)['bound_ms']:.4f})"
                               for k, o in ops.items()))
    print(f"[47 Poisson] {mesh.n_nodes} nodes, f32, tol 1e-6, turns CSR grid stencil stencil "
          f"grid CSR, (s, iterations, res_rel) a solve: {json.dumps(solves)}")
    for name, err in errs.items():
        check(err <= 1e-5, f"{name} apply vs CSR rel {err}")
    for name, runs_ in solves.items():
        check(all(r[2] < 1e-4 for r in runs_), f"{name} Poisson solve res_rel {runs_}")


def phase_heat_scale(dev, mesh) -> None:
    """tpufem's ``run_heat_large`` (f32, warm-started BiCGStab on
    I + dt·K_mod, 50 steps) at 160,000 nodes and on phase 9's mesh; u in
    [−1e-2, 1 + 1e-2]; cold and warm steps/s, iterations and device ms a
    step."""
    for n_side, n_circle, given in (MID_MESH + (None,), SCALE_MESH + (mesh,)):
        zero_launches()
        row = bench_large.run_heat_large(n_side, n_circle, HEAT_STEPS, device=dev, mesh=given)
        no_kernel_launches("the heat run")
        prof = row.pop("profile_per_step")
        print(f"[32 heat] {row['n_nodes']} nodes, f32, {HEAT_STEPS} steps: build "
              f"{row['build_s']:.1f} s, cold {row['cold_steps_per_sec']:.2f}, warm "
              f"{row['steps_per_sec']:.2f} steps/s, iterations a step "
              f"{row['iterations_per_step']}; u in [{row['u_range'][0]:.3e}, "
              f"{row['u_range'][1]:.6f}]; device {prof['device_ms_per_step']:.3f} ms and "
              f"{prof['kernels_per_step']:.0f} kernels a step, busy "
              f"{100 * prof['device_busy_share']:.1f} %, index kernels "
              f"{100 * prof['index_share']:.1f} %; {json.dumps(row)}; {json.dumps(prof['top'][:4])}")


def card_and_cpu_runs(dev, run) -> dict:
    """``run(device)`` on the card ``dev`` and on the CPU, as float64 NumPy."""
    return {name: run(device).detach().double().cpu().numpy()
            for name, device in (("gpu", dev), ("cpu", CPU))}


def phase_small_parity(dev) -> None:
    """Card f64 against the port's CPU f64 on ``generate_annulus_mesh(20,
    24)``: Poisson (lu, inverse, cg), heat (lu, cg; 50 steps), advection–
    diffusion (100 steps) and the graph average; dense 1e-10, CG 1e-9
    relative."""
    from tpufem_torch.workloads import advection_diffusion, graph_average, heat, poisson

    mesh = generate_annulus_mesh(*SMALL_MESH)
    cases = {}
    zero_launches()
    for solver in ("lu", "inverse", "cg"):
        cases[f"Poisson {solver}"] = (card_and_cpu_runs(dev, lambda d: poisson.solve(
            mesh, poisson.PoissonConfig(solver=solver), device=d)[0]),
            1e-9 if solver == "cg" else 1e-10)
    for solver in ("lu", "cg"):
        cases[f"heat {solver}"] = (card_and_cpu_runs(dev, lambda d: heat.run(
            mesh, heat.HeatConfig(solver=solver), steps=HEAT_STEPS, device=d)[0]),
            1e-9 if solver == "cg" else 1e-10)
    cases["advection-diffusion"] = (card_and_cpu_runs(dev, lambda d: advection_diffusion.run(
        advection_diffusion.ADProblem.build(mesh, device=d), AD_STEPS)[0]), 1e-10)
    cases["graph average"] = (card_and_cpu_runs(
        dev, lambda d: graph_average.solve(mesh, device=d)[0]), 1e-10)
    no_kernel_launches("the small workloads")
    errs = {k: (float(np.linalg.norm(r["gpu"] - r["cpu"]) / np.linalg.norm(r["cpu"])), lim)
            for k, (r, lim) in cases.items()}
    print(f"[33 small parity] {mesh.n_nodes} nodes, f64 card vs CPU, rel L2: " + "; ".join(
        f"{k} {v:.3e} (<= {lim:g})" for k, (v, lim) in errs.items()))
    for k, (v, lim) in errs.items():
        check(v <= lim, f"{k} card vs CPU rel {v} > {lim}")


def stam_max_abs(a: dict, b: dict) -> float:
    return max(float((a[k].double().cpu() - b[k].double().cpu()).abs().max())
               for k in ("vx", "vy", "density"))


def phase_stam(dev) -> None:
    """``StamConfig()`` (200², f32, 20 Jacobi sweeps) for 400 frames, cold
    then warm: frames/s, device time and kernels a frame; then at f64 and
    size 64 over 50 frames, each card frame from the CPU's state against the
    CPU's frame (1e-10 max abs), and the free-running card and CPU runs'
    distance, which the flow's own amplification of roundoff sets."""
    from tpufem_torch.workloads import stam_grid

    cfg = stam_grid.StamConfig()
    zero_launches()
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, speed = stam_grid.run(cfg, frames=STAM_FRAMES, device=dev)
        torch.cuda.synchronize()
        rates.append(STAM_FRAMES / (time.perf_counter() - t0))
    prof = profile_run(lambda: stam_grid.run(cfg, frames=STAM_PROFILE_FRAMES, state=state),
                       STAM_PROFILE_FRAMES, top=4)
    no_kernel_launches("Stam's solver")
    d = state["density"]
    check(bool(torch.isfinite(d).all() and torch.isfinite(speed).all()), "Stam state is finite")
    print(f"[34 Stam] {cfg.size}², f32, {cfg.solver_iters} sweeps, {STAM_FRAMES} frames: cold "
          f"{rates[0]:.1f}, warm {rates[1]:.1f} frames/s; device {prof['device_ms_per_step']:.3f} "
          f"ms and {prof['kernels_per_step']:.0f} kernels a frame, busy "
          f"{prof['device_ms_per_step'] * rates[1] / 10:.1f} %; max speed "
          f"{float(speed[-1]):.4f}, density max {float(d.max()):.4f}; {json.dumps(prof['top'])}")

    pcfg = stam_grid.StamConfig(**STAM_PARITY)
    host = stam_grid.initial_state(pcfg, device=CPU)
    free = stam_grid.initial_state(pcfg, device=dev)
    one_frame, drift = 0.0, []
    zero_launches()
    for _ in range(STAM_PARITY_FRAMES):
        from_host = stam_grid.step(pcfg, {k: v.to(dev) for k, v in host.items()})
        host = stam_grid.step(pcfg, host)
        free = stam_grid.step(pcfg, free)
        one_frame = max(one_frame, stam_max_abs(from_host, host))
        drift.append(stam_max_abs(free, host))
    no_kernel_launches("Stam's parity run")
    print(f"[34 Stam] size {pcfg.size}, f64, {STAM_PARITY_FRAMES} frames: one card frame from "
          f"the CPU's state, max abs {one_frame:.3e} (<= 1e-10); free-running card vs CPU max "
          f"abs after frames 10, 20, 30, 50: {drift[9]:.3e}, {drift[19]:.3e}, {drift[29]:.3e}, "
          f"{drift[-1]:.3e} (not gated: the flow amplifies roundoff)")
    check(one_frame <= 1e-10, f"Stam one frame card vs CPU max abs {one_frame}")


def phase_taylor_hood(dev) -> None:
    """The dense Taylor–Hood solvers on a P2-refined generated mesh:
    ``solve_taylor_hood`` under tpufem's residual gate; the θ-scheme, built
    on the host once and carried to the card, 200 steps f64 card against
    CPU (1e-10), then f32 steps/s on the card."""
    from tpufem_torch import interop, p2_refine

    mesh = p2_refine(generate_annulus_mesh(*TH_MESH), snap_center=(0.5, 0.5), snap_radius=0.25)
    zero_launches()
    t0 = time.perf_counter()
    u, p, res = navier_stokes.solve_taylor_hood(mesh, device=dev)
    solve_s = time.perf_counter() - t0
    check(float(res) < 1e-10 and bool(torch.isfinite(u).all() and torch.isfinite(p).all()),
          f"Taylor–Hood residual {float(res)} < 1e-10")
    cfg = navier_stokes.TransientTHConfig(**TH_CONFIG)
    t0 = time.perf_counter()
    host = navier_stokes.TransientTHProblem.build(mesh, cfg, device=CPU)
    build_s = time.perf_counter() - t0
    arrays = {"e_inv": host.e_inv.numpy(), "r_op": host.r_op.numpy(), "bc_dofs": host.bc_dofs,
              "bc_values": host.bc_values.numpy(), "corners": host.corners}
    card = interop.th_problem_from_numpy(arrays, mesh, cfg, dev)
    u_gpu, p_gpu, m_gpu = navier_stokes.run_transient_th(card, TH_STEPS)
    u_cpu, p_cpu, m_cpu = navier_stokes.run_transient_th(host, TH_STEPS)
    du, dp = rel(u_gpu, u_cpu), rel(p_gpu, p_cpu)
    card32 = interop.th_problem_from_numpy(
        arrays, mesh, dataclasses.replace(cfg, precision="f32"), dev)
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u32, _, _ = navier_stokes.run_transient_th(card32, TH_STEPS)
        torch.cuda.synchronize()
        rates.append(TH_STEPS / (time.perf_counter() - t0))
    no_kernel_launches("the Taylor–Hood solvers")
    d32 = rel(u32, u_gpu)
    print(f"[35 Taylor-Hood] p2_refine{TH_MESH}: {mesh.n_nodes} velocity nodes, "
          f"{card.e_inv.shape[0]} dofs; steady solve {solve_s:.2f} s (host LU), residual "
          f"{float(res):.3e} (< 1e-10); θ-system built on the host in {build_s:.2f} s; "
          f"{TH_STEPS} steps f64 card vs CPU: u rel {du:.3e}, p rel {dp:.3e} (<= 1e-10), "
          f"max|u| {float(m_gpu['max_u'][-1]):.4f}, div_max {float(m_gpu['div_max'][-1]):.3e}; "
          f"f32 on the card {rates[0]:.1f} then {rates[1]:.1f} steps/s, u rel to f64 {d32:.3e} "
          f"(<= 1e-4)")
    check(du <= 1e-10 and dp <= 1e-10, f"TH f64 card vs CPU u {du}, p {dp}")
    check(rel(m_gpu["div_max"], m_cpu["div_max"]) <= 1e-10, "TH div_max card vs CPU")
    check(d32 <= 1e-4, f"TH f32 vs f64 u rel {d32}")


# ---------------------------------------------------------------------------
# The sparse and grid Taylor–Hood engines
# ---------------------------------------------------------------------------

TH_KERNEL_SIDES = (20, 192)
TH_ROW_SIDE = 192  # 107,396 P2 nodes, 27,088 pressure dofs: 241,880 dofs
TH_ROW_STEPS = 10
TH_PARITY_SIDE = 20
TH_PARITY_STEPS = 10
TH_XCHECK_SIDE = 28
TH_XCHECK = dict(steps=50, dt=1e-4, nu=1.0)
# the engine's velocity tolerance a precision (bench_large.run_th_sparse)
TH_TOL_INNER = {torch.float32: 1e-6, torch.float64: 1e-8}
# K2/K3 against their plain versions as GRID_RTOL: summation order at f64
# with fixed iterations, float32 roundoff at f32, and with a tolerance a
# solve may stop one iteration apart, which moves it within that tolerance
TH_RTOL = {(torch.float64, 0.0): 1e-9, (torch.float64, 1e-8): 1e-6,
           (torch.float32, 0.0): 1e-3, (torch.float32, 1e-6): 1e-3}
# K3 rounds its restriction and coarse product to float32 at every
# precision (tpufem's rounding points): where the two summation orders put
# a float32 block sum one ulp (6e-8 relative) apart, the f64 solves part by
# that much times the coarse correction's share, up to ~1e-8 (4.1e-9
# measured at n_side 192, 64 fixed iterations; K2 has no float32 stage
# there and stays at 2e-14)
TH_K3_F64_RTOL = 1e-7
# tpufem's committed cross-check at n_side 28 (benchmarks/ns_th_xcheck_r5.jsonl)
TH_XCHECK_TPUFEM = {False: 0.552, True: 0.051}


def th_grid_problem(dev, n_side: int, precision: str = "f64", **kw):
    """The grid engine on ``p2_refine(generate_annulus_mesh(n_side,
    n_side))`` with ``bench_large.run_th_sparse``'s budgets."""
    from tpufem_torch.workloads import th_sparse

    _, base = bench_large.th_problem(n_side, n_side, precision, dev)
    return th_sparse.GridTHProblem.build(base, **kw)


def th_split_text(gp) -> str:
    kv, kp = gp.vel_solver.K, gp.plap_solver.K
    return (f"velocity raster {gp.ns2}² ({len(kv.offsets)} planes, {kv.n_rest} remainder "
            f"entries), pressure raster {gp.ns1}² ({len(kp.offsets)} planes, {kp.n_rest} "
            f"remainder entries, {gp.plap_solver.n_blocks}² coarse nodes)")


def phase_th_kernels(dev) -> None:
    """K2 and K3 on the TH operators against their plain versions (f32 and
    f64; fixed iterations, then the engine's tol_inner from a warm start,
    K2 also at the engine's velocity cap from zero), and ms an iteration of
    each (f32) against its bound."""
    rng = np.random.default_rng(36)
    for n_side in TH_KERNEL_SIDES:
        gp = th_grid_problem(dev, n_side, target_coarse=64 if n_side <= 32 else 1024)
        print(f"[36 TH kernels] n_side={n_side}: {th_split_text(gp)}")
        ns2, ns1 = gp.ns2, gp.ns1
        calls = 20 if n_side <= 32 else 3
        for dtype in (torch.float32, torch.float64):
            visc = gp.vel_solver
            cap = visc.iters  # the engine's velocity cap (288 at TH-192)
            visc = dataclasses.replace(visc, K=visc.K.astype(dtype),
                                       interior_mask=visc.interior_mask.to(dtype),
                                       iters=min(cap, 60))
            pres = k3_cast(gp.plap_solver, dtype, dtype)
            b2 = torch.as_tensor(rng.standard_normal((2, ns2, ns2)), dtype=dtype,
                                 device=dev) * visc.mask_grid
            b1 = torch.as_tensor(rng.standard_normal((ns1, ns1)), dtype=dtype,
                                 device=dev) * pres.act_grid
            tol_inner = TH_TOL_INNER[dtype]
            # (iterations, tol, warm start): K2 also at the engine's cap with
            # its tolerance, from zero (where it runs to the cap) and warm
            k2_cases = [(min(cap, 60), 0.0, False), (cap, tol_inner, False), (cap, tol_inner, True)]
            k3_cases = [(pres.iters, 0.0, False), (pres.iters, tol_inner, True)]
            for name, kernel, plain, solver, b, cases in (
                    ("K2", grid_cg.viscous_cg, grid_cg.viscous_cg_ref, visc, b2, k2_cases),
                    ("K3", grid_cg.pressure_cg, grid_cg.pressure_cg_ref, pres, b1, k3_cases)):
                for iters, tol, warm in cases:
                    s = dataclasses.replace(solver, iters=iters, tol=tol)
                    x0 = torch.zeros_like(b)
                    if warm:
                        x0 = plain(dataclasses.replace(solver, tol=0.0),
                                   b * (1 + 1e-3 * torch.randn_like(b)), torch.zeros_like(b))
                    rtol = TH_RTOL[(dtype, tol)]
                    if name == "K3" and dtype == torch.float64:
                        rtol = max(rtol, TH_K3_F64_RTOL)
                    check_solve(36, f"{name} {str(dtype)[6:]} TH n_side={n_side} "
                                f"({iters} iterations, tol {tol:g}, from "
                                f"{'a warm start' if warm else 'zero'})", kernel, plain, s, b, x0,
                                rtol, calls, 2)
                if dtype == torch.float32:
                    iteration_report(36, f"f32 TH n_side={n_side}", name, kernel,
                                     [("card split", solver, solver.K)], b, calls=calls)


def phase_th_row(dev) -> None:
    """The TH-192 row on the grid engine, f32, at vel_restarts 0 and 1 from
    one SparseTHProblem; the launch invariant and tpufem's gate (inside
    ``run_th_sparse``)."""
    t0 = time.perf_counter()
    base = bench_large.th_problem(TH_ROW_SIDE, TH_ROW_SIDE, "f32", dev)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    print(f"[37 TH row] p2_refine(generate_annulus_mesh({TH_ROW_SIDE}, {TH_ROW_SIDE})): "
          f"{base[1].n2} P2 nodes, {base[1].n1} pressure dofs, "
          f"{2 * base[1].n2 + base[1].n1} dofs; SparseTHProblem built in {base_s:.1f} s")
    for restarts in (0, 1):
        zero_launches()
        row = bench_large.run_th_sparse(TH_ROW_SIDE, TH_ROW_SIDE, TH_ROW_STEPS, precision="f32",
                                        engine="grid", vel_restarts=restarts, device=dev,
                                        base=base)
        counts = launch_counts()
        k2, k3 = counts["K2"], counts["K3"]
        per = row["launches_per_step"]
        check(k2 > 0 and k3 > 0 and not any(counts[k] for k in ("K1", "K4", "K5", "K6")),
              f"TH row launches {counts}")
        # per step K2 = (1 + restarts)·(K3 + 2), so over the timed steps too
        timed_k2, timed_k3 = per["K2"] * TH_ROW_STEPS, per["K3"] * TH_ROW_STEPS
        check(round(timed_k2) == (1 + restarts) * (round(timed_k3) + 2 * TH_ROW_STEPS),
              f"launch invariant: K2 {timed_k2}, K3 {timed_k3} in {TH_ROW_STEPS} steps")
        prof = row.pop("profile_of_warm_run")
        weak = row["th_div_weak_max"]
        print(f"[37 TH row] vel_restarts={restarts}: build {row['build_s']:.1f} s (grid engine, "
              f"after the {base_s:.1f} s base), first step {row['compile_s']:.2f} s, timed "
              f"{row['steps_per_sec']:.3f} and warm {row['warm_steps_per_sec']:.3f} steps/s; "
              f"outer iterations a step {per['K3'] - 1:.2f}; launches a step K2 {per['K2']:.1f}, "
              f"K3 {per['K3']:.1f} (K2 = {1 + restarts}·(K3 + 2)); iterations a solve "
              f"{row['iters_per_solve']}, a step {row['iters_per_step']} (warm run "
              f"{row['warm_iters_per_step']}); weak divergence "
              f"{weak:.3e} (P1/P1 "
              f"{row['p1p1_div_weak_max']:.3e}, gate < 0.1×, ratio {row['div_ratio_weak']:.1f}), "
              f"nodal {row['th_final_div_max']:.3e} (P1/P1 {row['p1p1_final_div_max']:.3e}); "
              f"f32 weak divergence reaches 1e-7: {weak <= 1e-7} (not gated); launches over the "
              f"row {counts}")
        print(f"[37 TH row] vel_restarts={restarts} device a warm step: "
              f"{prof['device_ms_per_step']:.3f} ms, {prof['kernels_per_step']:.0f} kernels, K2 "
              f"{100 * prof['K2_share']:.1f} % ({row['warm_iters_per_step']['K2']:.1f} iterations, "
              f"{prof['K2_share'] * prof['device_ms_per_step'] / row['warm_iters_per_step']['K2']:.5f} "
              f"ms each), K3 {100 * prof['K3_share']:.1f} %, busy "
              f"{100 * prof['device_busy_share']:.1f} %; {json.dumps(prof['top'][:6])}")
        print(f"[37 TH row] {json.dumps(row)}")


def th_card_and_cpu(dev, run) -> tuple:
    """``run(device)`` on the card (launch counts read around it) and on
    the CPU: (card result, CPU result, card launches)."""
    zero_launches()
    gpu = run(dev)
    counts = launch_counts()
    return gpu, run(CPU), counts


def phase_th_parity(dev) -> None:
    """f64 card against CPU: the CSR engine and the grid engine over 10
    steps, the steady solve against the dense one; then the NS/TH
    cross-check at n_side 28."""
    from tpufem_torch import p2_refine
    from tpufem_torch.workloads import th_sparse

    mesh = p2_refine(generate_annulus_mesh(TH_PARITY_SIDE, TH_PARITY_SIDE),
                     snap_center=(0.5, 0.5), snap_radius=0.25)

    def csr(d):
        problem = th_sparse.SparseTHProblem.build(mesh, th_sparse.SparseTHConfig(), device=d)
        return th_sparse.run(problem, steps=TH_PARITY_STEPS)[0]

    def grid(d):
        problem = th_sparse.SparseTHProblem.build(mesh, th_sparse.SparseTHConfig(), device=d)
        gp = th_sparse.GridTHProblem.build(problem, tol_inner=0.0, target_coarse=64)
        return th_sparse.run_grid(gp, steps=TH_PARITY_STEPS)[0]

    g, c, counts = th_card_and_cpu(dev, csr)
    check(not any(counts.values()), f"the CSR engine launched {counts}")
    errs = {"CSR engine": (rel(g, c), 1e-10)}
    g, c, counts = th_card_and_cpu(dev, grid)
    check(counts["K2"] > 0 and counts["K3"] > 0, f"the grid engine's launches {counts}")
    errs["grid engine"] = (rel(g, c), 1e-9)
    zero_launches()
    t0 = time.perf_counter()
    us, _ = th_sparse.steady_solve(th_sparse.SparseTHProblem.build(mesh, device=dev),
                                   iters_inner=200, iters_outer=40)
    steady_s = time.perf_counter() - t0
    ud, _, res = navier_stokes.solve_taylor_hood(mesh, device=dev)
    no_kernel_launches("the steady Uzawa solve")
    steady = float((us - ud).abs().max())
    print(f"[38 TH parity] p2_refine(generate_annulus_mesh({TH_PARITY_SIDE}, {TH_PARITY_SIDE})), "
          f"{mesh.n_nodes} P2 nodes, f64, {TH_PARITY_STEPS} steps card vs CPU, rel L2 in u: "
          + "; ".join(f"{k} {v:.3e} (<= {lim:g})" for k, (v, lim) in errs.items())
          + f" (grid engine on the card: K2 {counts['K2']}, K3 {counts['K3']} launches); "
          f"steady Uzawa (200/40 iterations, {steady_s:.2f} s) vs dense TH on the card: max abs "
          f"{steady:.3e} (<= 1e-9), dense residual {float(res):.3e}")
    for k, (v, lim) in errs.items():
        check(v <= lim, f"TH {k} card vs CPU rel {v} > {lim}")
    check(steady <= 1e-9, f"steady Uzawa vs dense TH max abs {steady}")
    for row in ns_th_xcheck(dev, TH_XCHECK_SIDE, **TH_XCHECK):
        consistent = row["mass_consistent"]
        print(f"[38 NS/TH cross-check] {json.dumps(row)}")
        print(f"[38 NS/TH cross-check] mass_consistent={consistent}: rel_err_l2 "
              f"{row['rel_err_l2']:.4f} (tpufem's committed {TH_XCHECK_TPUFEM[consistent]})")
        if consistent:
            check(row["rel_err_l2"] <= 0.1, f"NS mass_consistent vs TH rel_err_l2 "
                  f"{row['rel_err_l2']} > 0.1")


def ns_th_xcheck(dev, n_side: int, steps: int, dt: float, nu: float) -> list[dict]:
    """``benchmarks/ns_th_xcheck_r5.py``'s rotational rows: NS (CSR, f64,
    two-level, tol 1e-10) with ``mass_consistent`` False and True, each
    against one run of the CSR TH engine (f64, B1 = B2 = 0, the force
    f = 2·(0.5 − y, x − 0.5) as a nodal array), on the same P1 mesh from
    rest, compared at the P1 nodes in the lumped-mass L2 norm."""
    from tpufem_torch import p2_refine
    from tpufem_torch.workloads import th_sparse

    mesh = generate_annulus_mesh(n_side=n_side, n_circle=n_side)

    def force(xy):
        return np.stack([2.0 * (0.5 - xy[:, 1]), 2.0 * (xy[:, 0] - 0.5)], axis=1)

    t0 = time.perf_counter()
    m2 = p2_refine(mesh, snap_center=(0.5, 0.5), snap_radius=0.25)
    th_prob = th_sparse.SparseTHProblem.build(m2, th_sparse.SparseTHConfig(
        dt=dt, nu=nu, B1=0.0, B2=0.0, body_force=force(m2.coords), precision="f64",
        **bench_large.th_budgets(n_side)), device=dev)
    u_th, _, th_mets = th_sparse.run(th_prob, steps=steps, host_loop=True)
    u_th = u_th.double().cpu().numpy()[th_prob.corners]
    t_th = time.perf_counter() - t0
    ml = assembly.lumped_mass(mesh).numpy()

    def l2(v):
        return float(np.sqrt((ml * (v ** 2).sum(axis=1)).sum()))

    rows = []
    for consistent in (False, True):
        t0 = time.perf_counter()
        ns_prob = navier_stokes.NSProblem.build(mesh, navier_stokes.NSConfig(
            dt=dt, nu=nu, body_force=force(mesh.coords), solver="cg", precision="f64",
            cg_iters_visc=40, cg_iters_pressure=200, cg_tol=1e-10, cg_precond="twolevel",
            mass_consistent=consistent), device=dev)
        u_ns, mets = navier_stokes.run(ns_prob, steps=steps)
        u_ns = u_ns.double().cpu().numpy()
        err, ref = l2(u_ns - u_th), l2(u_th)
        rows.append({
            "mass_consistent": consistent, "n_side": n_side, "n_nodes": int(mesh.n_nodes),
            "th_dofs": int(2 * th_prob.n2 + th_prob.n1), "steps": steps, "dt": dt,
            "ns_max_u": float(np.abs(u_ns).max()), "th_max_u": float(np.abs(u_th).max()),
            "ns_u_l2": l2(u_ns), "th_u_l2": ref, "err_l2": err,
            "rel_err_l2": err / max(ref, 1e-30),
            "ns_div_star_max": float(mets["div_star_max"][-1]),
            "th_div_weak_max": float(th_mets["div_weak_max"]),
            "ns_seconds": time.perf_counter() - t0, "th_seconds": t_th})
    return rows


# ---------------------------------------------------------------------------
# The ensembles, the one-program gait campaign, TopK and bf16 (no kernel)
# ---------------------------------------------------------------------------

ENS_GATE_MESH = (40, 48)  # dryrun_multichip's mesh
ENS_TRACER_MESH = (12, 16)
ENS_PARITY_STEPS = 10
ENS_RTOL = 1e-10  # f64 card against the CPU, every field of every ensemble
ENS_BATCHES = (3, 8)  # kernels a step must not grow with B on one card
ENS_TIMED_STEPS = 1000
ENS_PROFILE_STEPS = 20
MM_MESH = (64, 72)  # pad_hole: 4,096 nodes, the top of the dense regime
MM_SIMS = 8
MM_STEPS = 500
MM_PROFILE_STEPS = 10
MM_PARITY_MESH = (14, 16)
TOPK_STEPS = 200
BF16_MESH = (12, 16)
BF16_STEPS = 10
# bf16 fused u against f64 after 10 steps, relative L2: 3.6e-3 measured on
# the CPU (tpufem's bf16 3.7e-3)
BF16_RTOL = 1e-2
GAIT = dict(dt=0.01, nu=1.0, B1=-2.0)


def ensemble_gates(meshes, u: torch.Tensor, b2s) -> list:
    """dryrun_multichip's gates on each simulation of an ensemble (its own
    mesh each, or one shared): the normalized divergence below
    DIV_REL_GATES["stokes"] and max|u| < MAX_U_FACTOR·(|B1| + |B2|);
    returns the normalized divergences."""
    rels = []
    for i, b2 in enumerate(b2s):
        mesh = meshes[i] if isinstance(meshes, (list, tuple)) else meshes
        ui = u[i].double().cpu()
        div = calculus.divergence(mesh, ui).numpy()
        ml = assembly.lumped_mass(mesh).numpy()
        h = float(np.sqrt(2.0 * np.median(mesh.area)))
        div_l2 = float(np.sqrt((ml * div ** 2).sum()))
        u_l2 = float(np.sqrt((ml * (ui.numpy() ** 2).sum(axis=1)).sum()))
        rels.append(div_l2 * h / max(u_l2, 1e-30))
        scale = abs(GAIT["B1"]) + abs(float(b2))
        check(float(ui.abs().max()) < MAX_U_FACTOR * scale,
              f"simulation {i}: max|u| {float(ui.abs().max())} >= {MAX_U_FACTOR}·{scale}")
    check(max(rels) < bench_large.DIV_REL_GATES["stokes"],
          f"normalized divergence {rels} >= {bench_large.DIV_REL_GATES['stokes']}")
    return rels


def jitter_tracers(state: dict, seed: int = 42, sigma: float = 1e-3) -> np.ndarray:
    """The ensemble's tracer lattice moved off the mesh edges (one draw for
    every simulation, as dryrun_multichip does); returns the points."""
    pts = state["tracers"][0].double().cpu().numpy()
    pts = pts + sigma * np.random.default_rng(seed).standard_normal(pts.shape)
    state["tracers"] = torch.as_tensor(np.broadcast_to(pts, state["tracers"].shape).copy(),
                                       dtype=state["tracers"].dtype,
                                       device=state["tracers"].device)
    return pts


def ensemble_card_and_cpu(dev, build, steps: int, jitter: bool) -> dict:
    """``run_sharded`` of ``build(device_mesh)`` on 2 × 4 positions on the
    card and on the CPU from one initial state: {field: rel L2 or max abs}."""
    out = []
    for d in (dev, CPU):
        ens = build(build_device_mesh(devices=[d] * 8, data=2))
        state = ens.initial_state()
        if jitter:
            jitter_tracers(state)
        out.append(run_sharded(ens, steps, state))
    (g, gm), (c, cm) = out
    errs = {k: rel(g[k], c[k]) for k in g if g[k].is_floating_point() and k != "tracers"}
    if "tracers" in g:
        errs["tracers max abs"] = float((g["tracers"].cpu() - c["tracers"]).abs().max())
        check(torch.equal(g["tracer_status"].cpu(), c["tracer_status"]), "tracer status card = CPU")
    errs["metric"] = rel(gm, cm) if float(cm.abs().max()) > 0 else float((gm.cpu() - cm).abs().max())
    return errs


def phase_ensemble_gates(dev) -> None:
    """dryrun_multichip's gates on the port's ShardedEnsemble (8 positions,
    data 2 × space 4, on the card); f64 card against CPU on (12, 16)."""
    dmesh = build_device_mesh(devices=[dev] * 8, data=2)
    data = dmesh.shape["data"]
    b2s = np.linspace(-5.0, 5.0, data)
    mesh = generate_annulus_mesh(*ENS_GATE_MESH)
    zero_launches()
    ens = ShardedEnsemble.build(mesh, dmesh, np.full(data, GAIT["B1"]), b2s)
    step = make_sharded_step(ens)
    state, d1 = step(ens.initial_state())
    state, d2 = step(state)
    d1, d2 = d1.double().cpu().numpy(), d2.double().cpu().numpy()
    check(bool(np.isfinite(d1).all() and np.isfinite(d2).all() and (d2 < d1).all()),
          f"divergence not falling step over step: {d1} -> {d2}")
    for _ in range(8):
        state, _ = step(state)
    rels = ensemble_gates(mesh, state["u"], b2s)
    # the jittered tracer ensemble against the single-device stepper
    tr_cfg = stokes.StokesConfig(dt=0.01, nu=1.0, transport="tracers", tracer_density=12,
                                 solver="inverse", pressure_mode="merge")
    mesh_tr = generate_annulus_mesh(*ENS_TRACER_MESH)
    ens_tr = ShardedEnsemble.build(mesh_tr, dmesh, np.full(data, GAIT["B1"]), b2s, config=tr_cfg)
    st = ens_tr.initial_state()
    pts = jitter_tracers(st)
    st, _ = run_sharded(ens_tr, 3, st)
    prob0 = stokes.StokesProblem.build(mesh_tr, dataclasses.replace(
        tr_cfg, B1=GAIT["B1"], B2=float(b2s[0])), device=dev)
    st0 = stokes.initial_state(prob0)
    st0["tracers"] = torch.as_tensor(pts, dtype=st0["tracers"].dtype, device=dev)
    step0 = stokes.make_step(prob0)
    for _ in range(3):
        st0, _ = step0(st0)
    tr_err = float((st["tracers"][0] - st0["tracers"]).abs().max())
    check(tr_err < 1e-5, f"ensemble tracers {tr_err} from the single-device stepper's")
    check(torch.equal(st["tracer_status"][0], st0["tracer_status"]), "tracer status equal")
    no_kernel_launches("the ensemble gates")
    print(f"[39 ensemble gates] {mesh.n_nodes} nodes, data {data} x space "
          f"{dmesh.shape['space']} on one card, f64 penalty dye: max|div| {d1} -> {d2} "
          f"(falling), after 10 steps div_rel {[f'{r:.4f}' for r in rels]} (< "
          f"{bench_large.DIV_REL_GATES['stokes']}), max|u| "
          f"{[round(float(state['u'][i].abs().max()), 4) for i in range(data)]}; jittered "
          f"tracers on {mesh_tr.n_nodes} nodes, 3 steps: {tr_err:.3e} from the single-device "
          f"stepper (< 1e-5), status equal")
    mesh_p = generate_annulus_mesh(*ENS_TRACER_MESH)
    b1s, b2p = np.full(4, GAIT["B1"]), np.array([0.0, 5.0, -5.0, 2.0])
    report = dict(variant="report", bc_kind="rotating", solver="inverse",
                  pressure_mode="penalty", ramp_steps=10, pressure_smoothing=0.01,
                  transport="dye", dt=1e-3, nu=0.1)
    cases = {
        "color dye (merge)": (False, lambda dm: ShardedEnsemble.build(
            mesh_p, dm, b1s, b2p, config=stokes.StokesConfig(
                solver="inverse", pressure_mode="merge", transport="dye"))),
        "color tracers (merge)": (True, lambda dm: ShardedEnsemble.build(
            mesh_p, dm, b1s, b2p, config=tr_cfg)),
        "report (penalty, rotating)": (False, lambda dm: ShardedEnsemble.build(
            mesh_p, dm, config=stokes.StokesConfig(**report),
            omegas=np.array([2.0, 5.0, -3.0, 8.0]))),
    }
    for name, (jit, build) in cases.items():
        zero_launches()
        errs = ensemble_card_and_cpu(dev, build, ENS_PARITY_STEPS, jit)
        no_kernel_launches(f"the {name} ensemble")
        print(f"[39 ensemble parity] {name}, {mesh_p.n_nodes} nodes, 2 x 4 positions, f64, "
              f"{ENS_PARITY_STEPS} steps, card vs CPU: {json.dumps(errs)} (<= {ENS_RTOL:g})")
        for k, v in errs.items():
            check(v <= ENS_RTOL, f"{name}: card vs CPU {k} {v}")


def eager_steps(step, state: dict, steps: int):
    """``steps`` calls of an ensemble step, each launching its kernels."""
    for _ in range(steps):
        state, metric = step(state)
    return state, metric


def ensemble_step_numbers(dev, mesh, b: int) -> dict:
    """The campaign's ensemble at B = ``b`` gaits (one a "data" position on
    the card): warm steps/s of ``run`` (one CUDA graph a step) over
    ENS_TIMED_STEPS steps and of the eager step; kernels and device ms a
    step (profiler over ENS_PROFILE_STEPS eager steps, the kernels the graph
    replays), the busy share; the graph's run against the eager steps."""
    cfg = stokes.StokesConfig(**GAIT, transport="tracers", precision="f32",
                              pressure_mode="merge", solver="inverse")
    ens = ShardedEnsemble.build(mesh, build_device_mesh(devices=[dev] * b, data=b),
                                np.full(b, GAIT["B1"]), np.linspace(-5.0, 5.0, b), config=cfg)
    step = make_sharded_step(ens)
    state, _ = step.run(ens.initial_state(), 50)
    numbers = {}
    for name, fn in (("steps_per_s", step.run), ("eager_steps_per_s",
                                                  lambda s, n: eager_steps(step, s, n))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(state, ENS_TIMED_STEPS)
        torch.cuda.synchronize()
        numbers[name] = ENS_TIMED_STEPS / (time.perf_counter() - t0)
    graph, _ = step.run(state, ENS_PROFILE_STEPS)
    eager, _ = eager_steps(step, state, ENS_PROFILE_STEPS)
    # index_add_ sums with atomics in a varying order: f32 roundoff apart
    diff = max(float((graph[k] - eager[k]).abs().max()) for k in ("u", "tracers"))
    check(diff <= 1e-4 and torch.equal(graph["tracer_status"], eager["tracer_status"]),
          f"B={b}: graph run {diff} from the eager steps")
    prof = profile_run(lambda: eager_steps(step, state, ENS_PROFILE_STEPS), ENS_PROFILE_STEPS,
                       top=6)
    prof.update(numbers, graph_vs_eager=diff)
    prof["device_busy_share"] = prof["device_ms_per_step"] * numbers["steps_per_s"] / 1e3
    return prof


def phase_sweep_sharded(dev, sequential) -> None:
    """The gait campaign as one sharded program on the card (one gait a
    "data" position), cold and warm, beside phase 27's sequential one."""
    seq_full, seq_short = sequential
    mesh = generate_annulus_mesh(*SWEEP_MESH)
    cfg = sweep.SweepConfig()
    dm = build_device_mesh(devices=[dev] * len(cfg.b2_values), data=len(cfg.b2_values))
    for run in ("cold", "warm"):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sweep.food_capture_sweep_sharded(mesh, dm, cfg)
        wall = time.perf_counter() - t0
        no_kernel_launches(f"the {run} sharded campaign")
        print(f"[40 sharded sweep] {run}: {len(cfg.b2_values)} gaits x {cfg.steps} steps on "
              f"{mesh.n_nodes} nodes as one program (data {len(cfg.b2_values)} on one card, f32 "
              f"merge inverse): campaign {wall:.2f} s ({cfg.steps / wall:.1f} steps/s, build "
              f"included); " + "; ".join(
                  f"B2={b2:g}: eaten {r['eaten']} of {r['tracers']}, fraction "
                  f"{r['consumed_fraction']:.4f}" for b2, r in res.items()))
        for b2, r in res.items():
            d = abs(r["consumed_fraction"] - seq_full[b2]["consumed_fraction"])
            print(f"[40 sharded sweep] B2={b2:g}: fraction {r['consumed_fraction']:.4f}, "
                  f"phase 27's sequential {seq_full[b2]['consumed_fraction']:.4f}")
            check(d <= 0.05, f"B2={b2}: sharded fraction {d} from the sequential campaign's")
    numbers = {}
    for b in ENS_BATCHES:
        zero_launches()
        numbers[b] = ensemble_step_numbers(dev, mesh, b)
        no_kernel_launches(f"the B={b} ensemble")
        p = numbers[b]
        print(f"[40 sharded sweep] B={b} gaits on one card: {p['steps_per_s']:.1f} warm steps/s "
              f"(run, one CUDA graph a step; eager steps {p['eager_steps_per_s']:.1f}; "
              f"{ENS_TIMED_STEPS} steps), {p['kernels_per_step']:.1f} kernels and "
              f"{p['device_ms_per_step']:.4f} device ms a step, busy "
              f"{100 * p['device_busy_share']:.1f} %; graph vs eager after "
              f"{ENS_PROFILE_STEPS} steps {p['graph_vs_eager']:.2e}; {json.dumps(p['top'])}")
    # one batch program: cuBLAS picks its product kernels by shape (140 at
    # B = 8 against 138 at B = 3 on an H100), a loop over the
    # simulations would multiply the count by B
    k = [numbers[b]["kernels_per_step"] for b in ENS_BATCHES]
    check(k[1] <= 1.05 * k[0], f"kernels a step grow with B: {dict(zip(ENS_BATCHES, k))}")
    short = dataclasses.replace(cfg, steps=SWEEP_PARITY_STEPS)
    res = sweep.food_capture_sweep_sharded(mesh, dm, short)
    print(f"[40 sharded sweep] {SWEEP_PARITY_STEPS} steps, eaten sharded vs sequential f32: "
          + "; ".join(f"B2={b2:g} {res[b2]['eaten']} vs {seq_short[b2]['eaten']}" for b2 in res)
          + " (within 2)")
    for b2, r in res.items():
        check(abs(r["eaten"] - seq_short[b2]["eaten"]) <= 2,
              f"B2={b2}: eaten {r['eaten']} vs sequential {seq_short[b2]['eaten']}")


def phase_sweep_cards(devs: list) -> None:
    """The sharded campaign with one gait on each of three cards (three
    groups stepping apart), cold and warm, beside all gaits on the first."""
    mesh = generate_annulus_mesh(*SWEEP_MESH)
    cfg = sweep.SweepConfig()
    gaits = len(cfg.b2_values)
    layouts = {"one gait a card": devs[:gaits], "all gaits on the first card": [devs[0]] * gaits}
    results = {}
    for name, devices in layouts.items():
        for run in ("cold", "warm"):
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sweep.food_capture_sweep_sharded(
                mesh, build_device_mesh(devices=devices, data=gaits), cfg)
            wall = time.perf_counter() - t0
            no_kernel_launches(f"the sharded campaign, {name}")
            results[name] = res
            print(f"[40 sharded sweep] {name} ({len(devs)} cards), {run}: {gaits} gaits x "
                  f"{cfg.steps} steps, campaign {wall:.2f} s; eaten "
                  f"{[r['eaten'] for r in res.values()]}")
    one, spread = results.values()
    for b2 in one:
        check(abs(one[b2]["consumed_fraction"] - spread[b2]["consumed_fraction"]) <= 0.05,
              f"B2={b2}: one gait a card against one card")


def matmul_share(prof: dict) -> float:
    """The share of device time in cuBLAS/CUTLASS product kernels."""
    words = ("gemm", "gemv", "xmma", "cutlass", "sm90_")
    ms = sum(t["ms_per_step"] for t in prof["top"] if any(w in t["name"].lower() for w in words))
    return ms / prof["device_ms_per_step"]


def phase_multimesh(dev) -> None:
    """The geometry ensemble at the top of the dense regime: 8 jittered
    4,096-node meshes, tracers, f32 merge, one a "data" position on the
    card, 500 steps; then f64 card against CPU on 4 small meshes."""
    t0 = time.perf_counter()
    meshes = [generate_annulus_mesh(*MM_MESH, pad_hole=True, jitter=0.15, seed=k)
              for k in range(MM_SIMS)]
    cfg = stokes.StokesConfig(**GAIT, solver="inverse", pressure_mode="merge",
                              transport="tracers", precision="f32")
    b2s = np.linspace(-5.0, 5.0, MM_SIMS)
    dm = build_device_mesh(devices=[dev] * MM_SIMS, data=MM_SIMS)
    ens = MultiMeshEnsemble.build(meshes, dm, np.full(MM_SIMS, GAIT["B1"]), b2s, config=cfg)
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    step = make_multimesh_step(ens)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, series = step.run(ens.initial_state(), MM_STEPS)
    torch.cuda.synchronize()
    rate = MM_STEPS / (time.perf_counter() - t0)
    no_kernel_launches("the geometry ensemble")
    rels = ensemble_gates(meshes, state["u"], b2s)
    prof = profile_run(lambda: eager_steps(step, state, MM_PROFILE_STEPS), MM_PROFILE_STEPS,
                       top=12)
    ops_gb = sum(getattr(ens, k).numel() for k in ("visc_inv", "pressure_inv", "div_x", "div_y")
                 ) * ens.visc_inv.element_size() / 1e9
    print(f"[41 geometry ensemble] {MM_SIMS} meshes generate_annulus_mesh{MM_MESH}, pad_hole, "
          f"jitter 0.15, seeds 0-{MM_SIMS - 1}: {meshes[0].n_nodes} nodes each, "
          f"{ens.tracer_init.shape[0]} tracers; operators {ops_gb:.2f} GB f32; build "
          f"{build_s:.1f} s (host); {MM_STEPS} steps from rest {rate:.1f} steps/s; device "
          f"{prof['device_ms_per_step']:.3f} ms and {prof['kernels_per_step']:.1f} kernels a "
          f"step, products {100 * matmul_share(prof):.1f} %, busy "
          f"{100 * prof['device_ms_per_step'] * rate / 1e3:.1f} %; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; eaten {series[-1].tolist()}; "
          f"div_rel {[f'{r:.4f}' for r in rels]}; {json.dumps(prof['top'][:6])}")
    pmeshes = [generate_annulus_mesh(*MM_PARITY_MESH, pad_hole=True, jitter=0.15, seed=k)
               for k in range(4)]
    for tr in ("dye", "tracers"):
        kw = dict(solver="inverse", pressure_mode="merge", transport=tr)
        zero_launches()
        errs = ensemble_card_and_cpu(
            dev, lambda d: MultiMeshEnsemble.build(
                pmeshes, d, np.full(4, GAIT["B1"]), np.array([0.0, 5.0, -5.0, 2.0]),
                config=stokes.StokesConfig(**kw)), ENS_PARITY_STEPS, tr == "tracers")
        no_kernel_launches(f"the {tr} geometry ensemble")
        print(f"[41 geometry ensemble] f64, 4 meshes generate_annulus_mesh{MM_PARITY_MESH}, "
              f"pad_hole, jitter 0.15, {tr}, {ENS_PARITY_STEPS} steps, card vs CPU: "
              f"{json.dumps(errs)} (<= {ENS_RTOL:g})")
        for k, v in errs.items():
            check(v <= ENS_RTOL, f"geometry ensemble {tr}: card vs CPU {k} {v}")


def phase_topk_bf16(dev) -> None:
    """locator="topk" beside the grid locator on the dense bench
    configuration, topk f64 card against CPU, and the bf16 fused step."""
    mesh = bench_mesh()
    rates = {}
    for locator in ("grid", "topk"):
        problem = stokes.StokesProblem.build(mesh, bench_config(locator=locator), device=dev)
        zero_launches()
        cold, _, _ = timed_run(problem, TOPK_STEPS)
        warm, state, _ = timed_run(problem, TOPK_STEPS)
        counts = launch_counts()
        check(counts["K1"] == 2 * TOPK_STEPS and sum(counts.values()) == counts["K1"],
              f"locator={locator}: launches {counts}")
        check(bool(torch.isfinite(state["tracers"]).all()), f"locator={locator}: tracers finite")
        rates[locator] = (cold, warm, int(state["tracer_status"].sum()))
    print(f"[42 topk] bench configuration, {mesh.n_nodes} nodes, "
          f"{problem.tracer_init.shape[0]} tracers, f32 fused on K1, {TOPK_STEPS} steps cold/warm: "
          + "; ".join(f"locator={k}: {c:.1f}/{w:.1f} steps/s, eaten {e}"
                      for k, (c, w, e) in rates.items()))
    small = generate_annulus_mesh(*ENS_TRACER_MESH)
    for tr in ("dye", "tracers"):
        kw = dict(dt=0.01, nu=1.0, solver="inverse", pressure_mode="merge", transport=tr,
                  tracer_density=15, locator="topk")
        zero_launches()
        g, c = card_and_cpu(small, 20, dev, **kw)
        no_kernel_launches(f"topk {tr}")
        errs = {k: rel(g[k], c[k]) for k in g}
        print(f"[42 topk] f64 {tr} on {small.n_nodes} nodes, 20 steps, card vs CPU: "
              f"{json.dumps(errs)} (<= 1e-10)")
        for k, v in errs.items():
            check(v <= 1e-10, f"topk {tr}: card vs CPU {k} {v}")
    bmesh = generate_annulus_mesh(*BF16_MESH)
    fused = dict(solver="inverse", pressure_mode="merge", fused=True)
    zero_launches()
    p16 = stokes.StokesProblem.build(bmesh, stokes.StokesConfig(precision="bf16", **fused),
                                     device=dev)
    s16, m16 = stokes.run(p16, steps=BF16_STEPS)
    no_kernel_launches("the bf16 fused step")
    s64, _ = stokes.run(stokes.StokesProblem.build(bmesh, stokes.StokesConfig(**fused),
                                                   device=dev), steps=BF16_STEPS)
    check(s16["u"].dtype == torch.bfloat16, "bf16 state")
    max_u = float(s16["u"].abs().max())
    err = rel(s16["u"], s64["u"])
    print(f"[42 bf16] fused step (torch.addmv) on {bmesh.n_nodes} nodes, {BF16_STEPS} steps: "
          f"max|u| {max_u:.4f} (< {MAX_U_FACTOR * 2.0}), rel L2 from f64 {err:.3e} (<= "
          f"{BF16_RTOL:g}), final max|div| {float(m16['final_div_max'][-1]):.4f}")
    check(max_u < MAX_U_FACTOR * 2.0, f"bf16 max|u| {max_u}")
    check(err <= BF16_RTOL, f"bf16 u {err} from f64")


# (label, mesh, the Laplacian-against-div∘grad gate): tpufem's 0.9 is for the
# reference mesh.1; on generated meshes it holds its jittered-mesh 0.5
# (tpufem itself reads 0.734 on the regular (40, 48) annulus)
DIAG_MESHES = (("(40, 48)", dict(n_side=40, n_circle=48), 0.5),
               ("jittered (24, 28)", dict(n_side=24, n_circle=28, jitter=0.25, seed=3), 0.5))
# card against the port's CPU: |card − cpu| ≤ 1e-10·max(|cpu|, 1), so values
# that are themselves roundoff (adjointness, RHS handling, the stiffness's
# smallest eigenvalue) are held absolutely
DIAG_TOL = 1e-10
# tpufem's gates (tests/test_diag.py): (name, gate on the value; the
# Laplacian's correlation gate is the mesh's own)
DIAG_TESTS = (
    ("gradient_test", lambda g, _: float((g - torch.tensor([2.0, 3.0])).abs().max()) <= 0.1),
    ("divergence_test", lambda d, _: abs(float(d) - 5.0) < 0.1),
    ("adjointness_test", lambda v, _: float(v) < 1e-6),
    ("laplacian_vs_divgrad_test", lambda v, lap: v > lap),
    ("checkerboard_response", lambda v, _: float(v) > 1.0),
    ("laplacian_blind_spot_test", lambda v, _: float(v) > 1.0),
    ("gradient_of_checkerboard_test", lambda v, _: float(v) > 0.1),
    ("projection_consistency_test", lambda v, _: v > 0.9),
    ("rhs_handling_test", lambda v, _: v < 1e-12),
)
GUARD_STEPS, GUARD_CHUNK = 200, 50


def diag_close(card_value, cpu_value) -> float:
    """max |card − cpu| / max(|cpu|, 1) over a value's entries."""
    a = torch.as_tensor(card_value, dtype=torch.float64).cpu()
    b = torch.as_tensor(cpu_value, dtype=torch.float64)
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def diag_mesh(dev, label: str, kw: dict, lap_gate: float) -> None:
    """Tests A–J, preflight, the eigenvalue census, vorticity and
    gradient_matrices on one mesh: f64 card against the port's CPU, and
    tpufem's gates."""
    mesh = generate_annulus_mesh(**kw)
    parts = []
    for name, gate in DIAG_TESTS:
        fn = getattr(diag, name)
        got, want = fn(mesh, device=dev), fn(mesh, device=CPU)
        err = diag_close(got, want)
        value = torch.as_tensor(got).cpu()
        parts.append(f"{name} {value.tolist()} (cpu {err:.1e})")
        check(err <= DIAG_TOL, f"diag {name} on {label}: card {got} cpu {want}")
        check(gate(value, lap_gate), f"diag {name} on {label}: {value.tolist()} fails tpufem's gate")
    rep = diag.preflight(mesh)
    check(rep.ok and rep.n_degenerate == 0 and rep.min_area > 1e-6
          and rep.viscous_cfl_dt(0.1) > 0, f"preflight on {label}: {rep}")
    K = assembly.assemble_dense(mesh, assembly.element_stiffness(mesh, device=dev))
    eig = diag.pressure_matrix_eigen_check(K)
    eig_cpu = diag.pressure_matrix_eigen_check(K.cpu())
    check(eig[2] == eig_cpu[2] == 0 and eig[1] > 0 and diag_close(eig[:2], eig_cpu[:2]) <= DIAG_TOL,
          f"eigenvalues on {label}: card {eig} cpu {eig_cpu}")
    rng = np.random.default_rng(13)
    u = rng.standard_normal((mesh.n_nodes, 2))
    p = rng.standard_normal(mesh.n_nodes)
    w_err = rel(calculus.vorticity(mesh, torch.as_tensor(u, device=dev)),
                calculus.vorticity(mesh, torch.as_tensor(u)))
    gx, gy = (torch.as_tensor(g, device=dev) for g in calculus.gradient_matrices(mesh))
    pt = torch.as_tensor(p, device=dev)
    g_err = rel(torch.stack([gx @ pt, gy @ pt], dim=1), calculus.gradient(mesh, pt))
    check(w_err <= DIAG_TOL and g_err <= DIAG_TOL,
          f"vorticity {w_err} / gradient_matrices {g_err} on {label}")
    print(f"[43 diag] {label}, {mesh.n_nodes} nodes, f64, card (cpu: max |card − cpu| / "
          f"max(|cpu|, 1)): " + "; ".join(parts))
    print(f"[43 diag] {label}: preflight ok, min area {rep.min_area:.3e}, min edge "
          f"{rep.min_edge:.4f}, {rep.n_cw} clockwise; stiffness eigenvalues [{eig[0]:.3e}, "
          f"{eig[1]:.4f}], {eig[2]} negative (cpu {eig_cpu}); vorticity rel L2 from cpu "
          f"{w_err:.1e}, gradient_matrices applied on the card against gradient {g_err:.1e}")


def phase_diag(dev, big) -> None:
    """Phase 43: the port's diag on the card, then its step diagnostics and
    run guard on phase 9's 1,048,576-node grid problem (K2, K3)."""
    for label, kw, lap_gate in DIAG_MESHES:
        diag_mesh(dev, label, kw, lap_gate)
    zero_launches()
    d = diag.single_step_diagnostics(big)
    counts = launch_counts()
    check(counts == {"K1": 0, "K2": 1, "K3": 1, "K4": 0, "K5": 0, "K6": 0},
          f"single_step_diagnostics launched {counts} (want K2 once, K3 once)")
    check(d["max_u_star"] > 0 and np.isfinite(d["max_p"])
          and d["div_after_max"] < d["div_star_max"], f"single-step diagnostics {d}")
    # the projection oracle as tests/test_diag.py applies it: a bare
    # pressure projection of a compatible field (div = 2π cos 2πx), mean
    # |div| over the interior
    coords = torch.as_tensor(big.mesh.coords, dtype=big.dtype, device=dev)
    u0 = torch.stack([torch.sin(2 * np.pi * coords[:, 0]), torch.zeros_like(coords[:, 0])], dim=1)
    dt = big.config.dt
    interior = torch.as_tensor(big.mesh.markers == 0, device=dev)
    d0 = big.div(u0)
    d1 = big.div(u0 - dt * big.grad(big.pressure_solver.solve(-d0 / dt)))
    proj = {"initial_div": float(d0[interior].abs().mean()),
            "final_div": float(d1[interior].abs().mean())}
    check(diag.projection_reduces_divergence(proj), f"projection oracle {proj}")
    print(f"[43 diag] {big.mesh.n_nodes} nodes, grid storage f32: single_step_diagnostics "
          f"{json.dumps(d)} with launches {counts} (max-norm ratio "
          f"{d['div_after_max'] / d['div_star_max']:.3f}); projection of (sin 2πx, 0): mean "
          f"interior |div| {proj['initial_div']:.4f} → {proj['final_div']:.4f}")
    _, first = stokes.run(big, steps=GUARD_CHUNK)
    first_div = float(first["final_div_max"].max())
    t0 = time.perf_counter()
    _, ok = diag.run_guarded(big, GUARD_STEPS, chunk=GUARD_CHUNK)
    ok_s = time.perf_counter() - t0
    check(ok == {"status": "ok", "completed_steps": GUARD_STEPS, "reason": None},
          f"run_guarded {ok}")
    _, bad = diag.run_guarded(big, GUARD_STEPS, chunk=GUARD_CHUNK, max_div=0.5 * first_div)
    check(bad["status"] == "aborted" and bad["completed_steps"] == 0, f"run_guarded {bad}")
    print(f"[43 diag] run_guarded({GUARD_STEPS} steps, chunk {GUARD_CHUNK}): {ok} in {ok_s:.2f} "
          f"s; with max_div {0.5 * first_div:.4f} (half the first chunk's final_div_max "
          f"{first_div:.4f}): {bad}")


# (study, CLI flags, the kernels its path launches).  th runs to T_STEADY
# (--steps0 1200, T = 12): at the CLI's default T = 1.5 the flow is not yet
# steady, and both packages read 0.2255 then 0.3074 on the first two rungs
CONVERGE_RUNS = (("self", ["--sizes", "1.6k,6.5k,26k"], ("K2", "K3")),
                 ("ns", ["--sizes", "2k,6.5k,26k"], ("K4", "K3")),
                 ("th", ["--sizes", "0.5k,0.8k,1.2k", "--steps0", "1200"], ()))


def phase_converge() -> None:
    """Phase 44: the convergence studies through the CLI, in process; each
    raises on a failed monotone gate (and ``self`` on the Stokes div_rel
    gate)."""
    for study, flags, kernels in CONVERGE_RUNS:
        zero_launches()
        t0 = time.perf_counter()
        rows = cli.main(["converge", "--study", study] + flags)
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check(all(counts[k] > 0 for k in kernels)
              and not any(v for k, v in counts.items() if k not in kernels),
              f"converge {study} launched {counts} (want {kernels or 'none'})")
        err = "err_vs_taylor_hood" if study == "th" else "err_vs_finest"
        summary = "; ".join(f"{r['label']} {r['n_nodes']} nodes {r['steps']} steps {err} "
                            f"{r[err]}" + (f" div_rel {r['div_rel']}" if "div_rel" in r else "")
                            for r in rows)
        print(f"[44 converge] {study} in {seconds:.1f} s, launches {counts}: {summary}")


def phase_roofline(dev) -> None:
    """Phase 45: ``roofline.measure`` at 160k; its bound is
    ``iteration_bound``'s, and its K2/K3 µs an iteration beside phase 8's
    figure (``per_iteration_ms``) on the same operators."""
    label, n_side, n_circle = roofline.SIZES[0]
    problem, build_s = roofline.build_problem(n_side, n_circle, device=dev)
    zero_launches()
    row = roofline.measure_problem(problem, label=label)
    counts = launch_counts()
    check(counts["K2"] > 0 and counts["K3"] > 0, f"roofline launched {counts}")
    ps, vs = problem.pressure_solver, problem.visc_solver
    ac = ps.ac_inv if ps.use_coarse else None
    check(math.isclose(row["bound_us_p"], iteration_bound("K3", ps.K, 1, ac) * 1e3, rel_tol=1e-12)
          and math.isclose(row["bound_us_v"], iteration_bound("K2", vs.K, 2) * 1e3,
                           rel_tol=1e-12), "roofline bounds are iteration_bound's")
    for k in ("us_per_p_iter", "us_per_v_iter", "gbps_pressure", "gbps_viscous"):
        check(np.isfinite(row[k]) and row[k] > 0, f"roofline {k} {row[k]}")
    print(json.dumps(row))
    rng = np.random.default_rng(8)
    ns = ps.K.ns
    b = torch.as_tensor(rng.standard_normal((ns, ns)), dtype=problem.dtype, device=dev) * ps.act_grid
    b2 = torch.as_tensor(rng.standard_normal((2, ns, ns)), dtype=problem.dtype, device=dev)
    p8 = {"K3": per_iteration_ms(grid_cg.pressure_cg, ps, b, calls=5) * 1e3,
          "K2": per_iteration_ms(grid_cg.viscous_cg, vs, b2, calls=5) * 1e3}
    mine = {"K3": row["us_per_p_iter"], "K2": row["us_per_v_iter"]}
    parts = []
    for k in ("K2", "K3"):
        diff = mine[k] / p8[k] - 1
        parts.append(f"{k} {mine[k]:.2f} µs an iteration (phase 8's difference of "
                     f"{ITER_PROBE}- and {ITER_PROBE // 2}-iteration solves: {p8[k]:.2f}, "
                     f"{100 * diff:+.1f} %)")
    print(f"[45 roofline] {row['label']} ({row['n_nodes']} nodes, built in {build_s:.1f} s), "
          f"{row['device']}: " + "; ".join(parts) + f"; bound K2 {row['bound_us_v']:.2f} µs "
          f"({row['pct_bound_viscous']:.1f} %), K3 {row['bound_us_p']:.2f} µs "
          f"({row['pct_bound_pressure']:.1f} %), GB/s K2 {row['gbps_viscous']:.1f} K3 "
          f"{row['gbps_pressure']:.1f}")
    if abs(mine["K3"] / p8["K3"] - 1) > 0.15:
        print("[45 roofline] K3 differs from phase 8's figure by more than 15 %: the roofline "
              "divides a whole solve, its set-up and the glue of solve() included, by its "
              f"{row['iters_p']} iterations; phase 8 takes the difference of two solves, which "
              "leaves the fixed cost out")


# ---------------------------------------------------------------------------
# Phase 47: the stencil and banded storages (no kernel of their own)
# ---------------------------------------------------------------------------

STORAGE_APPLY_RTOL = 1e-5  # f32 applies against CSR, relative L2
STORAGE_AB_STEPS = 400  # warm steps a turn of the Scale step
STORAGE_PARITY_STEPS = 20  # the two div/grad forms from rest, u within 1e-5
STORAGE_PROFILE_STEPS = 100  # the Scale A/B's profiled warm steps
STORAGE_MID_STEPS = 20  # the 160,000-node runs (banded: at most 20)
STORAGE_NS_PROFILE_STEPS = 3  # ~8,000 kernels a step: the profiler's own cost grows with them
STORAGE_F64_MESH = (40, 48)
STORAGE_F64_STEPS = 10
STORAGE_F64_RTOL = 1e-10  # card against the port's CPU at f64, fixed iterations
STORAGE_SHARDED_STEPS = 3
# the sharded step's banded and stencil branches run fixed iteration counts
# (no tolerance exit, as in tpufem)
SHARDED_HALO = dict(solver="cg", cg_iters_visc=30, cg_iters_pressure=60, cg_warm_start=False,
                    transport="none", precision="f64")


def kernels_an_apply(fn, *args, calls: int = 20) -> float:
    """Device kernels a call of ``fn``: the profiler's count over ``calls``
    calls.  (Late in a long process the profiler was seen to drop a
    window's first few device events: over 20 calls that costs a fraction
    of a kernel a call, not the count of a single call.)"""
    fn(*args)
    return profile_run(lambda: [fn(*args) for _ in range(calls)], calls)["kernels_per_step"]


def storage_operators(problem) -> dict:
    """Phase 9's four operators as CSR, in the problem's dtype on its
    device: the stiffness, the merged periodic pressure operator, Dx and
    Dy."""
    mesh, boundary = problem.mesh, problem.boundary
    ke = assembly.element_stiffness(mesh)
    owner = owner_map(mesh.n_nodes, boundary.masters, boundary.slaves)
    merged = dataclasses.replace(mesh, tris=owner[mesh.tris].astype(np.int32))
    dx, dy = calculus.divergence_csr_operators(mesh)
    ops = {"K": assembly.assemble_csr(mesh, ke), "K_merged": assembly.assemble_csr(merged, ke),
           "Dx": dx, "Dy": dy}
    return {k: op.astype(problem.dtype, problem.device) for k, op in ops.items()}


def storage_applies(dev, big) -> None:
    """Item 1: each operator on CSR, the stencil and the card's grid split
    (plain apply): build seconds, offsets and remainder of the stencil;
    device ms an apply beside the byte bound, kernels an apply; f32 rel L2
    against CSR."""
    n = big.mesh.n_nodes
    ns = int(round(n ** 0.5))
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    for name, csr in storage_operators(big).items():
        t0 = time.perf_counter()
        st = StencilOperator.build(csr, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        grid = GridOperator.dense_split(csr, ns, device=dev)
        parts, errs = [], {}
        want = csr.matvec(x)
        for label, op in (("csr", csr), ("stencil", st), ("grid plain", grid)):
            if label != "csr":
                errs[label] = rel(op.matvec(x), want)
                check(errs[label] <= STORAGE_APPLY_RTOL, f"{name} {label} apply vs CSR rel "
                      f"{errs[label]}")
            ms = device_ms(op.matvec, x, calls=20)
            b = roofline.apply_bound(op)
            parts.append(f"{label} {ms:.4f} ms (bound {b['bound_ms']:.4f}, "
                         f"{kernels_an_apply(op.matvec, x):.1f} kernels)")
        print(f"[47 storage] {name}: stencil built in {build_s:.2f} s, offsets {list(st.offsets)}, "
              f"{st.n_rest} remainder entries, coverage {st.coverage:.5f}; device ms an apply "
              + ", ".join(parts) + f"; rel L2 vs CSR " + ", ".join(f"{k} {v:.2e}"
                                                                    for k, v in errs.items()))


def scale_divgrad_ab(big) -> None:
    """Item 2: the Scale step (phase 9's problem) with its div/grad on the
    stencil (A: the problem as built, Dx and Dy in one pass), on the
    stencil as two applies (C) and on CSR (B): u after 20 steps from rest
    within 1e-5 of B's; then from each one's state after 200 steps, turns A
    B C C B A, twice, of 400 warm steps (steps/s, K2 once and K3 twice a
    step in every turn) and 100 steps under the profiler (device ms and kernels a
    step; the busy share against the turns' median): the host's share of a
    step is large and varies from turn to turn, so the turns run twice."""
    dx, dy = calculus.divergence_csr_operators(big.mesh)
    check(type(big.mf_pair).__name__ == "StencilPair", f"phase 9's div/grad: {big.mf_pair}")
    unpaired = dataclasses.replace(big)
    unpaired.__dict__["mf_pair"] = None  # the cached pair, left out
    variants = {"stencil": big, "stencil unpaired": unpaired,
                "csr": dataclasses.replace(big, mf_dx=dx.astype(big.dtype, big.device),
                                           mf_dy=dy.astype(big.dtype, big.device))}
    fields, warm = {}, {}
    for label, problem in variants.items():
        state, _ = stokes.run(problem, steps=STORAGE_PARITY_STEPS)
        fields[label] = state["u"]
        warm[label], _ = stokes.run(problem, steps=SCALE_STEPS - STORAGE_PARITY_STEPS, state=state)
    du = {k: rel(fields[k], fields["csr"]) for k in ("stencil", "stencil unpaired")}
    check(max(du.values()) <= 1e-5, f"stencil against CSR div/grad after "
          f"{STORAGE_PARITY_STEPS} steps: u rel {du}")
    turns = {}
    for label in ("stencil", "csr", "stencil unpaired", "stencil unpaired", "csr", "stencil") * 2:
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stokes.run(variants[label], steps=STORAGE_AB_STEPS, state=warm[label])
        torch.cuda.synchronize()
        turns.setdefault(label, []).append(STORAGE_AB_STEPS / (time.perf_counter() - t0))
        counts = launch_counts()
        check(counts == {"K1": 0, "K2": STORAGE_AB_STEPS, "K3": 2 * STORAGE_AB_STEPS, "K4": 0,
                         "K5": 0, "K6": 0}, f"{label} div/grad launched {counts}")
    parts, top = [], {}
    for label, problem in variants.items():
        prof = profile_steps(problem, STORAGE_PROFILE_STEPS, state=warm[label])
        busy = prof["device_ms_per_step"] * float(np.median(turns[label])) / 1e3
        top[label] = [(k["name"][:48], round(k["ms_per_step"], 4)) for k in prof["top"][:6]]
        parts.append(f"{label}: warm {', '.join(f'{v:.2f}' for v in turns[label])} steps/s, "
                     f"{prof['device_ms_per_step']:.4f} device ms and "
                     f"{prof['kernels_per_step']:.1f} kernels a step, busy {100 * busy:.1f} %")
    print(f"[47 scale div/grad] {big.mesh.n_nodes} nodes, turns (A B C C B A) × 2 of "
          f"{STORAGE_AB_STEPS} warm steps from step {SCALE_STEPS}, K2 1 and K3 2 a step in every "
          "turn: " + "; ".join(parts) + f"; u rel vs CSR after {STORAGE_PARITY_STEPS} steps "
          + ", ".join(f"{k} {v:.3e}" for k, v in du.items()) + " (<= 1e-5)")
    print(f"[47 scale div/grad] device ms a step by kernel (top 6): {json.dumps(top)}")


class CountedOperator:
    """An operator that counts its applies (the plain CG's iterations)."""

    def __init__(self, op):
        self.op, self.applies = op, 0

    def matvec(self, x):
        self.applies += 1
        return self.op.matvec(x)

    def diag(self):
        return self.op.diag()


def plain_cg_iterations(problem, steps: int) -> tuple:
    """(viscous, pressure) iterations a solve, and the end state, of
    ``steps`` steps from rest and ``steps`` more on the plain CG path: the
    viscous (N, 2) solve applies the operator to both columns once to
    start and once an iteration; the pressure solves' counts come from
    ``matfree.cg``."""
    from tpufem_torch.solve import matfree

    state, _ = stokes.run(problem, steps=steps)
    counted = CountedOperator(problem.visc_solver.K)
    probe = dataclasses.replace(problem, visc_solver=dataclasses.replace(problem.visc_solver,
                                                                         K=counted))
    iters, cg = [], matfree.cg

    def counting_cg(*args, **kwargs):
        x, info = cg(*args, **kwargs)
        iters.append(info[0])
        return x, info

    matfree.cg = counting_cg
    try:
        state, _ = stokes.run(probe, steps=steps, state=state)
    finally:
        matfree.cg = cg
    return counted.applies / (2 * steps) - 1, float(np.mean(iters)) if iters else 0.0, state


def timed_turns(runs: dict, order, steps: int) -> dict:
    """Steps/s of each label's ``runs[label]()``, a run of ``steps`` steps,
    in the order of turns given."""
    out = {}
    for label in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[label]()
        torch.cuda.synchronize()
        out.setdefault(label, []).append(steps / (time.perf_counter() - t0))
    return out


def turns_text(turns: dict) -> str:
    return "; ".join(f"{k} " + ", ".join(f"{v:.2f}" for v in vs) for k, vs in turns.items())


def storage_mid(dev) -> None:
    """Item 3, at 160,000 nodes (``bench_large.bench_config``): Stokes on
    the stencil against CSR (warm steps/s in turns S C C S, twice;
    iterations a solve), banded (bandwidth, stored bytes, ms an apply, warm
    steps/s), and NS on the stencil against CSR (``ns_config``, tpufem's
    gates; warm steps/s in turns, device ms and kernels a step).  The
    plain CG paths read their stop test on the host every iteration, so
    a step's time varies from turn to turn."""
    mesh = generate_annulus_mesh(*MID_MESH, pad_hole=True)
    steps, order = STORAGE_MID_STEPS, ("stencil", "csr", "csr", "stencil") * 2
    problems, warm, parts = {}, {}, []
    for storage in ("stencil", "csr", "banded"):
        t0 = time.perf_counter()
        cfg = bench_large.bench_config(n_nodes=mesh.n_nodes, storage=storage)
        problem = stokes.StokesProblem.build(mesh, cfg, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        zero_launches()
        it_v, it_p, warm[storage] = plain_cg_iterations(problem, steps)
        no_kernel_launches(f"Stokes {storage}")
        for k, v in warm[storage].items():
            if v.is_floating_point():
                check(bool(torch.isfinite(v).all()), f"Stokes {storage} {k} is finite")
        K = problem.visc_solver.K
        text = (f"Stokes {type(K).__name__} built in {build_s:.1f} s, iterations a solve viscous "
                f"{it_v:.2f} pressure {it_p:.2f}")
        if storage == "banded":
            x = torch.randn(mesh.n_nodes, device=dev)
            sps = timed_turns({storage: lambda: stokes.run(problem, steps=steps,
                                                           state=warm[storage])},
                              (storage,), steps)[storage][0]
            text += (f", warm {sps:.2f} steps/s; bandwidth {K.bandwidth}, "
                     f"{K.diags.numel() * K.diags.element_size()} stored bytes an operator, "
                     f"{device_ms(K.matvec, x, calls=5):.4f} ms an apply (bound "
                     f"{roofline.apply_bound(K)['bound_ms']:.4f}, "
                     f"{kernels_an_apply(K.matvec, x):.1f} kernels)")
            del problem, K
            torch.cuda.empty_cache()
        else:
            problems[storage] = problem
        parts.append(text)
    turns = timed_turns({k: (lambda p=p, k=k: stokes.run(p, steps=steps, state=warm[k]))
                         for k, p in problems.items()}, order, steps)
    parts.insert(2, f"Stokes warm steps/s in turns: {turns_text(turns)}")
    del problems
    torch.cuda.empty_cache()
    ns, state, text = {}, {}, []
    for storage in ("stencil", "csr"):
        problem = ns[storage] = navier_stokes.NSProblem.build(
            mesh, bench_large.ns_config(storage=storage), device=dev)
        zero_launches()
        runs = bench_large.run_ns_problem(problem, steps)  # tpufem's NS gates
        no_kernel_launches(f"NS {storage}")
        state[storage] = runs["state"]
        prof = profile_run(lambda: navier_stokes.run(problem, steps=STORAGE_NS_PROFILE_STEPS,
                                                     state=runs["state"]),
                           STORAGE_NS_PROFILE_STEPS)
        text.append(f"NS {type(problem.K_csr).__name__}: {prof['device_ms_per_step']:.3f} device "
                    f"ms and {prof['kernels_per_step']:.0f} kernels a step, busy "
                    f"{100 * prof['device_ms_per_step'] * runs['warm_steps_per_sec'] / 1e3:.1f} "
                    f"%, div_rel {runs['warm']['div_rel']:.4f}")
    turns = timed_turns({k: (lambda p=p, k=k: navier_stokes.run(p, steps=steps, state=state[k]))
                         for k, p in ns.items()}, order, steps)
    parts += text + [f"NS warm steps/s in turns: {turns_text(turns)}"]
    print(f"[47 160k] {mesh.n_nodes} nodes, {steps} warm steps a turn: " + "; ".join(parts))


def storage_f64_parity(dev) -> None:
    """Item 5: card f64 against the port's CPU f64, fixed iterations: the
    Stokes stencil (with and without the hole) and banded runs, NS on the
    stencil, and the sharded step's stencil and banded branches on 4
    strips of one card."""
    n_side, n_circle = STORAGE_F64_MESH
    fixed = dict(solver="cg", precision="f64", cg_tol_pressure=0.0, cg_tol_visc=0.0,
                 cg_precond="twolevel", cg_iters_visc=30, cg_iters_pressure=60)
    errs = {}
    for label, storage, pad in (("Stokes stencil pad_hole", "stencil", True),
                                ("Stokes stencil", "stencil", False),
                                ("Stokes banded", "banded", False)):
        mesh = generate_annulus_mesh(n_side, n_circle, pad_hole=pad)
        g, c = card_and_cpu(mesh, STORAGE_F64_STEPS, dev, cg_storage=storage, **fixed)
        errs[label] = rel(g["u"], c["u"])
    mesh = generate_annulus_mesh(n_side, n_circle, pad_hole=True)
    us = []
    for device in (dev, CPU):
        cfg = navier_stokes.NSConfig(dt=1e-4, solver="cg", precision="f64", cg_storage="stencil",
                                     cg_tol=0.0, cg_iters_visc=30, cg_iters_pressure=120)
        problem = navier_stokes.NSProblem.build(mesh, cfg, device=device)
        check(type(problem.K_csr).__name__ == "StencilOperator" and problem.conv_refill is not None,
              "NS stencil holds K and the C(u) refill on the stencil")
        u, _ = navier_stokes.run(problem, steps=STORAGE_F64_STEPS)
        us.append(u.double().cpu())
    errs["NS stencil pad_hole"] = rel(*us)
    for storage, pad in (("stencil", True), ("banded", False)):
        mesh = generate_annulus_mesh(n_side, n_circle, pad_hole=pad)
        out = []
        for devices in ([dev] * 4, ["cpu"] * 4):
            dm = build_device_mesh(devices=devices, data=1)
            problem = stokes.StokesProblem.build(
                mesh, stokes.StokesConfig(cg_storage=storage, **SHARDED_HALO),
                device=dm.axis_devices()[0])
            zero_launches()
            u, _ = run_matfree_sharded(make_sharded_matfree_step(dm, problem),
                                       stokes.initial_state(problem)["u"], STORAGE_SHARDED_STEPS)
            no_kernel_launches(f"the sharded {storage} step")
            out.append(u.double().cpu())
        errs[f"sharded {storage}"] = rel(*out)
    print(f"[47 f64 parity] generate_annulus_mesh{STORAGE_F64_MESH}, card against CPU, u rel L2 "
          f"(<= {STORAGE_F64_RTOL:g}; {STORAGE_F64_STEPS} steps, the sharded "
          f"{STORAGE_SHARDED_STEPS} on 4 strips): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= STORAGE_F64_RTOL, f"{k}: card against CPU u rel {v}")


def storage_sharded_mid(dev) -> None:
    """Item 6: the sharded step on the stencil branch at 160,000 nodes, 4
    strips on one card (bench_config, f32): steps/s, kernels a step and
    the busy share."""
    mesh = generate_annulus_mesh(*MID_MESH, pad_hole=True)
    problem = stokes.StokesProblem.build(
        mesh, bench_large.bench_config(n_nodes=mesh.n_nodes, storage="stencil"), device=dev)
    dm = build_device_mesh(devices=[dev] * SHARDS, data=1)
    step = make_sharded_matfree_step(dm, problem)
    u = stokes.initial_state(problem)["u"]
    u, _ = step(u)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, series = run_matfree_sharded(step, u, STORAGE_SHARDED_STEPS)
    torch.cuda.synchronize()
    sps = STORAGE_SHARDED_STEPS / (time.perf_counter() - t0)
    no_kernel_launches("the sharded stencil step")
    check(bool(torch.isfinite(u).all()), "the sharded stencil step is finite")
    prof = profile_run(lambda: step(u), 1)
    print(f"[47 sharded stencil] {mesh.n_nodes} nodes, {SHARDS} strips on one card, f32, "
          f"{STORAGE_SHARDED_STEPS} steps: {sps:.3f} steps/s, {prof['kernels_per_step']:.0f} "
          f"kernels and {prof['device_ms_per_step']:.2f} device ms a step, busy "
          f"{100 * prof['device_ms_per_step'] * sps / 1e3:.1f} %; final_div_max "
          f"{float(series['final_div_max'][-1]):.4f}")


def phase_storages(dev, big) -> None:
    """Phase 47 (items 1, 2, 3, 5, 6; item 4 is phase 31's Poisson
    storages): no kernel of its own; the Scale A/B counts K2 and K3."""
    seconds = {}
    for item, run in ((1, lambda: storage_applies(dev, big)), (2, lambda: scale_divgrad_ab(big)),
                      (3, lambda: storage_mid(dev)), (5, lambda: storage_f64_parity(dev)),
                      (6, lambda: storage_sharded_mid(dev))):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        seconds[item] = round(time.perf_counter() - t0, 1)
    print(f"[47 seconds] by item: {seconds}")


def cli_json(argv: list) -> list:
    """Run ``python -m tpufem_torch`` in process on ``argv``: echo its
    output, return its JSON lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    out = buf.getvalue()
    print("\n".join(f"[46 cli]   {line}" for line in out.splitlines() if line.strip()))
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(finite(v) for v in tree.values())
    return bool(np.isfinite(tree))


def phase_cli() -> None:
    """Phase 46: every subcommand of the CLI on the card, in process, on
    ``--mesh generated``; each JSON line held to the gates of tpufem's CLI
    tests and workloads."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(["--help"])
        except SystemExit as e:
            check(e.code == 0, f"--help exits {e.code}")
    check("usage" in buf.getvalue().lower(), "--help prints its usage")
    gen = ["--mesh", "generated"]
    squirmer = MAX_U_FACTOR * 2.0  # max|u| < 1.25·(|B1| + |B2|), B1 = −2, B2 = 0
    mesh = generate_annulus_mesh()
    inner = mesh.markers == 2
    omega_r = 5.0 * float(np.hypot(*(mesh.coords[inner] - 0.5).T).max())  # rotating surface speed
    gates = {
        "poisson": (["poisson"], lambda j: j["residual"] < 1e-8),
        "heat": (["heat", "--steps", "20"],
                 lambda j: -1e-2 <= j["max_u"]["min"] and j["max_u"]["max"] <= 1 + 1e-2),
        "stokes": (["stokes", "--steps", "20"],
                   lambda j: j["max_u"]["max"] < squirmer
                   and 0 <= j["mixing_progress"]["final"] <= 1),
        "food": (["food", "--steps", "20", "--precision", "f32"],
                 lambda j: j["max_u"]["max"] < squirmer and j["eaten"]["min"] >= 0),
        "report": (["report", "--steps", "20"], lambda j: j["max_u"]["max"] <= omega_r),
        "ns": (["ns", "--steps", "20"], lambda j: j["max_u"]["max"] < 1.0),
        "monolithic": (["monolithic"], lambda j: j["residual"] < 1e-8),
        "taylorhood": (["taylorhood"], lambda j: j["residual"] < 1e-8 and j["max_u"] < squirmer),
        "taylorhood transient": (["taylorhood", "--steps", "20"],
                                 lambda j: j["max_u"] < squirmer),
        "taylorhood_sparse": (["taylorhood", "--sparse", "--steps", "5"],
                              lambda j: j["max_u"] < squirmer and j["div_weak_max"] < 1e-3),
        "ad": (["ad", "--steps", "20"], lambda j: j["max_f"]["min"] >= 0),
        "graph": (["graph"], lambda j: j["residual"] < 1e-8),
        "sweep": (["sweep", "--steps", "100"], lambda j: all(0 <= v <= 100 for v in j.values())),
    }
    parts = []
    for label, (argv, gate) in gates.items():
        zero_launches()
        t0 = time.perf_counter()
        lines = cli_json(argv[:1] + gen + argv[1:])
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        check(len(lines) == 1, f"{label}: {len(lines)} JSON lines")
        (key, value), = lines[0].items()
        check(finite(value) and gate(value), f"{label}: {value} fails its gate")
        if label == "food":
            check(counts.get("K1", 0) == 20, f"food --precision f32 launched {counts} (K1 20)")
        parts.append(f"{label} {seconds:.1f} s{f' {counts}' if counts else ''}")
    zero_launches()
    t0 = time.perf_counter()
    lines = cli_json(["stam", "--frames", "20"])
    check(len(lines) == 1 and np.isfinite(lines[0]["stam"]["final_max_speed"]), f"stam {lines}")
    parts.append(f"stam {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lines = cli_json(["bench", "--large", "--sizes", "160k", "--steps", "20"])
    counts = launch_counts()
    check(len(lines) == 1 and lines[0]["n_nodes"] == 160_000 and counts["K2"] > 0
          and counts["K3"] > 0, f"bench --large: {counts}")
    parts.append(f"bench --large 160k {time.perf_counter() - t0:.1f} s (warm "
                 f"{lines[0]['warm_steps_per_sec']:.1f} steps/s, div_rel {lines[0]['div_rel']}) "
                 f"{ {k: v for k, v in counts.items() if v} }")
    print("[46 cli] --help exits 0; " + "; ".join(parts))


def timed(n: int, fn, *args):
    """Run phase ``n`` and print the seconds it took."""
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"[{n} seconds] {time.perf_counter() - t0:.1f}", flush=True)
    return out


def built(n_side: int, n_circle: int, make):
    """A 1,048,576-node problem from ``make`` and its build seconds."""
    t0 = time.perf_counter()
    problem = make(torch.device("cuda", 0), n_side, n_circle)
    torch.cuda.synchronize()
    return problem, time.perf_counter() - t0


def sharded_phases(devs, big, build_s: float):
    """Phases 23–26 with one shard on each of ``devs``: (K6's numbers at
    the main path's shape, its launches on the main path)."""
    k6_main = timed(23, phase_halo_kernel, devs, halo_dmax(big), build_s)
    timed(24, phase_sharded_solvers, devs, big)
    k6_launches = timed(25, phase_sharded_main_path, devs, big)
    timed(26, phase_sharded_parity, devs)
    return k6_main, k6_launches


def main_cards(n: int) -> None:
    """Phases 1, 2 and 23–26 with one shard on each of ``n`` cards, on phase
    9's problem (built on card 0): K6's pushes go to the other cards
    through peer access."""
    timed(1, phase_device)
    check(torch.cuda.device_count() >= n, f"{n} cards asked for, "
          f"{torch.cuda.device_count()} visible")
    build_s = timed(2, phase_build)
    big, _ = built(*SCALE_MESH, scale_problem)
    k6_main, k6_launches = sharded_phases([torch.device("cuda", i) for i in range(n)], big,
                                          build_s)
    if n >= 3:
        timed(40, phase_sweep_cards, [torch.device("cuda", i) for i in range(n)])
    print(json.dumps({"kernels": [kernel_entry_k6(k6_launches, k6_main)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def kernel_entry_k6(launches: int, numbers: dict) -> dict:
    return {"name": "halo_rdma", "route": "cuda", "source": "tpufem_torch/csrc/halo_rdma.cu",
            "replaces": "tpufem/parallel/grid_remote_dma.py:64", "launches": launches,
            **numbers}


def main() -> None:
    dev = timed(1, phase_device)
    build_s = timed(2, phase_build)
    at_main = timed(3, phase_kernel, dev)
    mesh = bench_mesh()
    launches = timed(4, phase_main_path, dev, mesh)
    timed(5, phase_parity, dev, mesh)
    timed(6, phase_dye, dev, bench_mesh("mesh.1", fallback=(20, 24)))
    timed(7, phase_grid_build, build_s)
    big, big_build_s = built(*SCALE_MESH, scale_problem)
    t0 = time.perf_counter()
    old_ops = tpufem_split(big)
    print(f"[8 split] {big.mesh.n_nodes} nodes, tpufem's split built in "
          f"{time.perf_counter() - t0:.1f} s: viscous, pressure, Gdx, Gdy planes "
          f"{[len(K.offsets) for K in old_ops]}, remainder entries {[K.n_rest for K in old_ops]}")
    grid_main = timed(8, phase_grid_kernels, dev, big, old_ops)
    grid_launches, unfused = timed(9, phase_scale_main_path, big, big_build_s)
    timed(10, phase_scale_parity, dev)
    timed(11, phase_scale_tracers, dev)
    timed(17, phase_k5_build, build_s)
    k5_problems = {1: with_k5(big, 1)}
    k5_problems[4] = dataclasses.replace(
        k5_problems[1], config=dataclasses.replace(k5_problems[1].config, grid_steps_per_call=4),
        grid_step=dataclasses.replace(k5_problems[1].grid_step, steps_per_call=4))
    k5_main = timed(18, phase_k5_kernel, dev, k5_problems[1], old_ops)
    k5_launches = timed(19, phase_k5_main_path, k5_problems, big, unfused)
    timed(20, phase_k5_parity, dev)
    timed(21, phase_k5_tracers, dev)
    timed(22, phase_gridify, dev)
    k6_main, k6_launches = sharded_phases([dev] * SHARDS, big, build_s)
    timed(43, phase_diag, dev, big)
    timed(47, phase_storages, dev, big)
    scale_mesh = big.mesh
    del big, k5_problems, unfused, old_ops
    torch.cuda.empty_cache()
    timed(12, phase_ns_build, build_s)
    ns_big, ns_build_s = built(*SCALE_MESH, ns_problem)
    k4_main = timed(13, phase_ns_kernel, dev, ns_big)
    ns_launches = timed(14, phase_ns_main_path, ns_big, ns_build_s)
    timed(15, phase_ns_grid_parity, dev)
    timed(16, phase_ns_dense_parity, dev)
    del ns_big
    torch.cuda.empty_cache()
    sequential = timed(27, phase_sweep, dev)
    timed(28, phase_eulerian_scale, scale_mesh)
    timed(29, phase_eulerian_parity, dev)
    timed(30, phase_variants, dev)
    timed(31, phase_poisson_scale, dev, scale_mesh)
    timed(32, phase_heat_scale, dev, scale_mesh)
    timed(33, phase_small_parity, dev)
    timed(34, phase_stam, dev)
    timed(35, phase_taylor_hood, dev)
    timed(36, phase_th_kernels, dev)
    timed(37, phase_th_row, dev)
    timed(38, phase_th_parity, dev)
    timed(39, phase_ensemble_gates, dev)
    timed(40, phase_sweep_sharded, dev, sequential)
    timed(41, phase_multimesh, dev)
    timed(42, phase_topk_bf16, dev)
    timed(44, phase_converge)
    timed(45, phase_roofline, dev)
    timed(46, phase_cli)
    kernels = [{
        "name": "fused_step_matvec",
        "route": "cuda",
        "source": "tpufem_torch/csrc/fused_step_matvec.cu",
        "replaces": "tpufem/ops/pallas_kernels.py:31",
        "launches": launches,
        **at_main,
    }]
    for key, name, replaces, count in (
            ("K2", "viscous_cg", "tpufem/solve/pallas_cg.py:825", grid_launches["K2"]),
            ("K3", "pressure_cg", "tpufem/solve/pallas_cg.py:1275", grid_launches["K3"]),
            ("K4", "ns_bicgstab", "tpufem/solve/pallas_cg.py:1844", ns_launches["K4"])):
        numbers = grid_main[key] if key != "K4" else k4_main
        kernels.append({"name": name, "route": "cuda", "source": "tpufem_torch/csrc/grid_cg.cu",
                        "replaces": replaces, "launches": count, **numbers})
    kernels.append({"name": "grid_step", "route": "cuda",
                    "source": "tpufem_torch/csrc/grid_step.cu",
                    "replaces": "tpufem/solve/pallas_step.py:146", "launches": k5_launches,
                    **k5_main})
    kernels.append(kernel_entry_k6(k6_launches, k6_main))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cards", type=int, default=0,
                        help="run only phases 1, 2 and 23-26 (and 40 with three cards or "
                             "more), one shard on each of this many cards (default: every "
                             "phase on one card)")
    args = parser.parse_args()
    if args.cards:
        main_cards(args.cards)
    else:
        main()
    sys.stdout.flush()
