"""The Navier–Stokes step's C(u) refill, kernels E and G
(``tpufem_torch/ops/ns_refill.py``, ``csrc/ns_refill.cu``).

On the CPU: G's fixed-order segment sum (its plain version) over
``GridRefill.segments`` against the ``index_add_`` of the plain refill, bit
for bit, on pad_hole annuli and on a refill built through ``interop``; E's
arithmetic on its cached element constants against
``element_convection_flat``'s plain output, bit for bit; the wrappers'
refusals and launch counters.

The tests marked ``card`` run E and G at 1,048,576 nodes on a CUDA card and
skip without one: E bit-equal to its plain version on the card, G to the
CPU's fixed-order sum (the card's ``index_add_`` is atomic) and to its
plain version there, two refills bit-equal, and 200 NS steps against the
plain path within the benchmark cell's ``u_err`` limit.  On the card,
without JAX: the command in ``tests/_card.py``.
"""

import re

import numpy as np
import pytest
import torch

from _card import BIG, card, ns_grid
from tpufem_torch import generate_annulus_mesh
from tpufem_torch.ops import assembly, ns_refill
from tpufem_torch.ops.gridop import GridRefill

torch.set_num_threads(2)
assert card  # the fixture, imported for the tests marked card

BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
SIZES = {32: 40, 64: 72}  # n_side → n_circle of the pad_hole annuli


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(BITS[a.dtype]), b.view(BITS[b.dtype]))


def seeded_u(n: int, dtype, device="cpu", seed: int = 1) -> torch.Tensor:
    return torch.as_tensor(0.1 * np.random.default_rng(seed).standard_normal((n, 2)),
                           dtype=dtype, device=device)


def slots(op) -> torch.Tensor:
    """A refilled operator's flat slots: planes, then the remainder."""
    return torch.cat([op.diags.reshape(-1), op.rest_vals])


def from_constants(tris: torch.Tensor, geo: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Kernel E's arithmetic in PyTorch, on the cached constants."""
    t = tris.long()
    uc = (u[t[0]] + u[t[1]] + u[t[2]]) / 3.0
    w = [geo[6] * (uc[:, 0] * geo[2 * j] + uc[:, 1] * geo[2 * j + 1]) for j in range(3)]
    return torch.cat(w * 3)


def check_segments(refill: GridRefill, flat: torch.Tensor) -> None:
    """Every entry in exactly one slot; the fixed-order sum bit-equal to the
    plain refill's ``index_add_``; empty slots +0."""
    index, ptr = refill.segments()
    assert index.dtype == ptr.dtype == torch.int32
    assert torch.equal(torch.sort(index.long()).values, torch.arange(len(flat)))
    assert int(ptr[0]) == 0 and int(ptr[-1]) == len(flat) and len(ptr) == refill.n_flat + 1
    counts = ptr[1:].long() - ptr[:-1].long()
    assert torch.equal(counts, torch.bincount(refill.dest, minlength=refill.n_flat))
    want = slots(refill.refill_flat(flat))
    got = ns_refill.segment_sum_ref(flat, index, ptr)
    assert same_bits(got, want)
    empty = counts == 0
    assert bool(empty.any()) and same_bits(got[empty], torch.zeros_like(got[empty]))
    assert refill.segments()[0] is index  # made once


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n_side", sorted(SIZES))
def test_fixed_order_sum_is_index_add_bit_for_bit(n_side, dtype):
    mesh = generate_annulus_mesh(n_side, SIZES[n_side], pad_hole=True)
    refill = GridRefill.build(mesh, n_side, dtype=dtype, device="cpu")
    flat = assembly.element_convection_flat(mesh, seeded_u(mesh.n_nodes, dtype), "opsplit")
    check_segments(refill, flat)


def test_summation_order_shows_in_the_bits():
    """The check above has teeth: the same runs summed last entry first
    differ from ``index_add_`` in some slots at f32."""
    mesh = generate_annulus_mesh(32, SIZES[32], pad_hole=True)
    refill = GridRefill.build(mesh, 32, dtype=torch.float32, device="cpu")
    flat = assembly.element_convection_flat(mesh, seeded_u(mesh.n_nodes, torch.float32),
                                            "opsplit")
    index, ptr = refill.segments()
    reversed_index = torch.cat([index[int(a):int(b)].flip(0)
                                for a, b in zip(ptr[:-1], ptr[1:])])
    got = ns_refill.segment_sum_ref(flat, reversed_index, ptr)
    assert not same_bits(got, slots(refill.refill_flat(flat)))


def test_fixed_order_sum_on_an_interop_refill():
    """A refill made by ``interop`` from tpufem's arrays makes its own
    index from ``dest`` and ``order_k``, and sums as its ``index_add_``."""
    from tests._torch_parity import ns_refill_pair
    from tpufem_torch import interop

    jm, jr, tp, u = ns_refill_pair()
    t = jr.template
    arrays = {f"grid_refill.{k}": np.asarray(getattr(jr, k)) for k in ("dest", "order", "order_k")}
    arrays.update({f"grid_refill.template.{k}": np.asarray(getattr(t, k)) for k in (
        "diags", "offsets", "n_rest", "coverage", "gr_rowT", "gr_laneT", "sc_row", "sc_laneT",
        "rest_vals")})
    refill = interop.grid_refill_from_numpy(arrays, device="cpu")
    assert not refill._segments
    flat = assembly.element_convection_flat(tp.mesh, torch.as_tensor(u), "opsplit")
    check_segments(refill, flat)
    assert same_bits(slots(refill.refill_flat(flat)), slots(tp.grid_refill.refill_flat(flat)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("variant", ["opsplit", "stokescolor"])
def test_cached_constants_give_the_plain_values(variant, dtype):
    mesh = generate_annulus_mesh(32, SIZES[32], pad_hole=True)
    u = seeded_u(mesh.n_nodes, dtype)
    tris, geo = assembly.convection_constants(mesh, variant, dtype, "cpu")
    assert tris.dtype == torch.int32 and tris.shape == (3, mesh.n_tris) and tris.is_contiguous()
    assert geo.dtype == dtype and geo.shape == (7, mesh.n_tris) and geo.is_contiguous()
    want = assembly.element_convection_flat(mesh, u, variant)
    assert same_bits(from_constants(tris, geo, u), want)
    assert same_bits(want, assembly.element_convection_flat_ref(mesh, u, variant))
    assert assembly.convection_constants(mesh, variant, dtype, "cpu")[1] is geo  # made once


def _e_args(n_tris=5, n=4, dtype=torch.float32):
    return (torch.zeros((3, n_tris), dtype=torch.int32), torch.zeros((7, n_tris), dtype=dtype),
            torch.zeros((n, 2), dtype=dtype))


def _g_args(e=6, n=3, dtype=torch.float32):
    return (torch.zeros(e, dtype=dtype), torch.zeros(e, dtype=torch.int32),
            torch.zeros(n + 1, dtype=torch.int32))


def _replace(args, i, value):
    return tuple(value if j == i else a for j, a in enumerate(args))


REFUSED = {
    "E on the CPU": (ns_refill.convection_flat, _e_args(), ValueError, "CUDA device"),
    "E half u": (ns_refill.convection_flat, _e_args(dtype=torch.float16), TypeError, "float32"),
    "E int64 tris": (ns_refill.convection_flat,
                     _replace(_e_args(), 0, torch.zeros((3, 5), dtype=torch.int64)), TypeError,
                     "int32"),
    "E geo dtype": (ns_refill.convection_flat,
                    _replace(_e_args(), 1, torch.zeros((7, 5), dtype=torch.float64)), TypeError,
                    "float32"),
    "E geo shape": (ns_refill.convection_flat,
                    _replace(_e_args(), 1, torch.zeros((6, 5))), ValueError, "(7, T)"),
    "E u shape": (ns_refill.convection_flat, _replace(_e_args(), 2, torch.zeros((4, 3))),
                  ValueError, "(N, 2)"),
    "E non-contiguous tris": (ns_refill.convection_flat,
                              _replace(_e_args(), 0, torch.zeros((5, 3), dtype=torch.int32).T),
                              ValueError, "not contiguous"),
    "E misaligned u": (ns_refill.convection_flat,
                       _replace(_e_args(), 2, torch.zeros(9)[1:].view(4, 2)), ValueError,
                       "boundary"),
    "G on the CPU": (ns_refill.segment_sum, _g_args(), ValueError, "CUDA device"),
    "G int vals": (ns_refill.segment_sum, _g_args(dtype=torch.int32), TypeError, "float32"),
    "G int64 index": (ns_refill.segment_sum,
                      _replace(_g_args(), 1, torch.zeros(6, dtype=torch.int64)), TypeError,
                      "int32"),
    "G index shape": (ns_refill.segment_sum,
                      _replace(_g_args(), 1, torch.zeros(5, dtype=torch.int32)), ValueError,
                      "index (E,)"),
    "G empty ptr": (ns_refill.segment_sum,
                    _replace(_g_args(), 2, torch.zeros(0, dtype=torch.int32)), ValueError,
                    "ptr (n + 1,)"),
    "G non-contiguous vals": (ns_refill.segment_sum,
                              _replace(_g_args(), 0, torch.zeros(12)[::2]), ValueError,
                              "not contiguous"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    fn, args, error, words = REFUSED[case]
    before = (ns_refill.convection_flat.launches, ns_refill.segment_sum.launches)
    with pytest.raises(error, match=re.escape(words)):
        fn(*args)
    assert (ns_refill.convection_flat.launches, ns_refill.segment_sum.launches) == before


def test_launch_counters_start_at_zero_and_the_cpu_path_launches_nothing():
    assert ns_refill.convection_flat.launches == 0 and ns_refill.segment_sum.launches == 0
    mesh = generate_annulus_mesh(32, SIZES[32], pad_hole=True)
    refill = GridRefill.build(mesh, 32, dtype=torch.float64, device="cpu")
    refill.refill_flat(assembly.element_convection_flat(mesh, seeded_u(mesh.n_nodes,
                                                                       torch.float64)))
    assert ns_refill.convection_flat.launches == 0 and ns_refill.segment_sum.launches == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

STEPS = 200
U_ERR_LIMIT = 0.002  # portbench/checks/ns_1m.steady.json
U_FLOOR = 0.01  # portbench/steppers/ns.py: the change taken as at least 1 % of the first speed


@pytest.fixture
def card_problem(card):
    """The ns_1m configuration's problem (``bench_large.ns_config``, the
    grid path) on the 1,048,576-node annulus."""
    return ns_grid(card, *BIG)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_card_e_is_its_plain_version_bit_for_bit(card_problem, dtype):
    mesh = card_problem.mesh
    u = seeded_u(mesh.n_nodes, dtype, card_problem.device)
    for variant in ("opsplit", "stokescolor"):
        before = ns_refill.convection_flat.launches
        got = assembly.element_convection_flat(mesh, u, variant)
        assert ns_refill.convection_flat.launches == before + 1
        assert same_bits(got, assembly.element_convection_flat_ref(mesh, u, variant)), variant


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_card_g_is_the_cpu_fixed_order_sum_and_repeats(card_problem, dtype):
    """Bit-equal to the CPU's ``index_add_`` (the card's is atomic) and to
    its plain version on the card; two refills of one state bit-equal."""
    mesh, refill = card_problem.mesh, card_problem.grid_refill
    flat = assembly.element_convection_flat(mesh, seeded_u(mesh.n_nodes, dtype,
                                                           card_problem.device), "opsplit")
    before = ns_refill.segment_sum.launches
    first, second = (slots(refill.refill_flat(flat)) for _ in range(2))
    assert ns_refill.segment_sum.launches == before + 2
    cpu = torch.zeros(refill.n_flat, dtype=dtype).index_add_(
        0, refill.dest.cpu(), flat.cpu()[refill.order_k.cpu()])
    assert same_bits(first.cpu(), cpu)
    assert same_bits(first, second)
    assert same_bits(first, ns_refill.segment_sum_ref(flat, *refill.segments()))


@pytest.mark.card
def test_card_ns_steps_with_the_kernels_track_the_plain_path(card_problem, monkeypatch):
    """200 steps from a smooth disturbance with E and G, and with the plain
    refill (``element_convection_flat_ref``, ``refill_flat_ref``): the
    gap within the ns_1m.steady cell's ``u_err`` limit."""
    from tpufem_torch.workloads import navier_stokes

    problem, dev = card_problem, card_problem.device
    xy = torch.as_tensor(problem.mesh.coords, dtype=problem.dtype, device=dev)
    bump = torch.sin(torch.pi * xy[:, 0]) * torch.sin(torch.pi * xy[:, 1])
    u0 = 0.01 * torch.stack([bump, 0.5 * bump], dim=1)
    u0 = torch.where(problem.wall[:, None], torch.zeros((), dtype=u0.dtype, device=dev), u0)
    p0 = torch.zeros(problem.mesh.n_nodes, dtype=problem.dtype, device=dev)

    launches = (ns_refill.convection_flat.launches, ns_refill.segment_sum.launches)
    kernel, _ = navier_stokes.run(problem, steps=STEPS, state=(u0, p0))
    assert (ns_refill.convection_flat.launches - launches[0],
            ns_refill.segment_sum.launches - launches[1]) == (STEPS, STEPS)
    monkeypatch.setattr(assembly, "element_convection_flat", assembly.element_convection_flat_ref)
    monkeypatch.setattr(GridRefill, "refill_flat", GridRefill.refill_flat_ref)
    launches = (ns_refill.convection_flat.launches, ns_refill.segment_sum.launches)
    plain, _ = navier_stokes.run(problem, steps=STEPS, state=(u0, p0))
    assert (ns_refill.convection_flat.launches, ns_refill.segment_sum.launches) == launches

    def speed(v):
        return torch.linalg.vector_norm(v.double(), dim=1).max().item()

    change = max(speed(plain - u0), U_FLOOR * speed(u0))
    u_err = speed(kernel - plain) / change
    print(f"u_err of the kernels' run against the plain path's after {STEPS} steps: {u_err:.3e}")
    assert bool(torch.isfinite(kernel).all()) and u_err <= U_ERR_LIMIT
