"""The runs of ``python -m tpufem_torch`` against ``python -m tpufem`` on
``--mesh generated``: the same JSON lines (f64 within 1e-10; ``stokes``, on
the ±1e10 penalty, within the 1e-8 its ill-conditioning leaves, as
tests/test_torch_stokes.py holds that path; the f32 ``food`` run within
1e-4, its step fused on the port)."""

import pytest
import torch

from tpufem import cli as jcli
from tpufem_torch import cli as tcli

from tests.test_torch_cli import GEN, STOKES_RTOL, numbers, run_cli

torch.set_num_threads(2)


# subcommand argv → relative tolerance against tpufem's JSON line
RUNS = {
    "poisson": (["poisson"], 1e-10),
    "heat": (["heat", "--steps", "20"], 1e-10),
    "stokes": (["stokes", "--steps", "3"], STOKES_RTOL),
    "food": (["food", "--steps", "20", "--precision", "f32"], 1e-4),
    "report": (["report", "--steps", "20"], 1e-10),
    "ns": (["ns", "--steps", "20"], 1e-10),
    "monolithic": (["monolithic"], 1e-10),
    "taylorhood sparse": (["taylorhood", "--sparse", "--steps", "5"], 1e-10),
    "ad": (["ad", "--steps", "20"], 1e-10),
    "graph": (["graph"], 1e-10),
    "stam": (["stam", "--frames", "20"], 1e-10),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_json_line_matches_tpufem(name):
    argv, rtol = RUNS[name]
    argv = argv[:1] + ([] if argv[0] == "stam" else GEN) + argv[1:]
    want = run_cli(jcli.main, argv)
    got = run_cli(tcli.main, ["--device", "cpu"] + argv)
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    w = dict(numbers(want[0]))
    g = dict(numbers(got[0]))
    assert set(g) == set(w)
    for k, v in w.items():
        # residuals and near-zero minima are roundoff: held absolutely
        assert abs(g[k] - v) <= rtol * abs(v) + 1e-12, (k, g[k], v)
