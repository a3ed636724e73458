"""``python -m tpufem_torch`` against ``python -m tpufem``: the same
subcommands and flags (plus ``--device``; ``converge --study ns`` too),
``--help``, ``stokes --out`` (its JSON line, metrics JSONL, state npz and
PNG against tpufem's), the ``--out`` PNGs, the Taylor–Hood runs on a P1 mesh and the
``bench --large`` flags.  The runs' JSON lines against tpufem's are in
test_torch_cli_runs.py."""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpufem import cli as jcli
from tpufem_torch import cli as tcli

from tests._torch_parity import rel

torch.set_num_threads(2)

GEN = ["--mesh", "generated"]
# the f64 stokes run solves LU on the ±1e10 penalty: held to the 1e-8 its
# ill-conditioning leaves, as tests/test_torch_stokes.py holds that path
STOKES_RTOL = 1e-8


def run_cli(main, argv) -> list:
    """The JSON lines ``main(argv)`` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


def numbers(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from numbers(v, f"{prefix}/{k}")
    else:
        yield prefix, float(tree)


def options(parser: argparse.ArgumentParser) -> dict:
    """{subcommand: its option strings} and the top level's under ""."""
    out = {"": set(parser._option_string_actions)}
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    for name, p in sub.choices.items():
        out[name] = set(p._option_string_actions)
    return out


def jax_parser(monkeypatch) -> argparse.ArgumentParser:
    """tpufem's parser, which its ``main`` builds and parses at once."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            jcli.main([])
    return seen["parser"]


def test_same_subcommands_and_flags(monkeypatch):
    mine = options(tcli._parser())
    theirs = options(jax_parser(monkeypatch))
    assert set(mine) == set(theirs)
    for name, flags in theirs.items():
        extra = {"--device"} if name == "" else set()
        assert mine[name] == flags | extra, name
    args = tcli._parser().parse_args(["converge", "--study", "ns", "--sizes", "2k"])
    assert (args.study, args.sizes) == ("ns", "2k")


def test_help_exits_zero(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--help"])
    assert e.value.code == 0
    assert "usage" in capsys.readouterr().out.lower()


def test_python_dash_m_help():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "tpufem_torch", "--help"], capture_output=True,
                         text=True, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "converge" in out.stdout and "--device" in out.stdout


def test_stokes_out_products(tmp_path):
    got = run_cli(tcli.main, ["--device", "cpu", "stokes"] + GEN +
                  ["--steps", "3", "--out", str(tmp_path / "t")])
    want = run_cli(jcli.main, ["stokes"] + GEN + ["--steps", "3", "--out", str(tmp_path / "j")])
    for k, v in dict(numbers(want[0])).items():
        assert abs(dict(numbers(got[0]))[k] - v) <= STOKES_RTOL * abs(v) + 1e-12, k
    for name in ("stokes_metrics.jsonl", "stokes_state.npz", "stokes.png"):
        assert (tmp_path / "t" / name).exists(), name
    rows = [json.loads(line) for line in (tmp_path / "t" / "stokes_metrics.jsonl").open()]
    assert len(rows) == 3
    state = np.load(tmp_path / "t" / "stokes_state.npz")
    ref = np.load(tmp_path / "j" / "stokes_state.npz")
    assert rel(state["u"], ref["u"]) <= STOKES_RTOL


@pytest.mark.parametrize("cmd", ["poisson", "graph"])
def test_out_writes_the_png(cmd, tmp_path):
    run_cli(tcli.main, ["--device", "cpu", cmd] + GEN + ["--out", str(tmp_path)])
    assert (tmp_path / f"{cmd}.png").stat().st_size > 1000


def test_taylorhood_takes_a_p1_mesh(tmp_path):
    """The port builds the P2 mesh of a P1 one (tpufem's steady and
    transient paths refuse it): a residual at roundoff, and the PNG."""
    (line,) = run_cli(tcli.main, ["--device", "cpu", "taylorhood"] + GEN +
                      ["--out", str(tmp_path)])
    assert line["taylorhood"]["residual"] < 1e-10
    assert (tmp_path / "taylorhood.png").exists()


def test_bench_large_flags_map_to_bench_large():
    args = tcli._parser().parse_args(
        ["bench", "--large", "--sizes", "160k", "--steps", "20", "--bench-storage", "grid",
         "--th", "--n-side", "64", "--engine", "grid", "--hbm-io", "on", "--no-pad-hole"])
    assert tcli._bench_large_argv(args) == [
        "--steps", "20", "--precond", "twolevel", "--sizes", "160k", "--storage", "grid",
        "--engine", "grid", "--no-pad-hole", "--th", "--n-side", "64"]


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["poisson"] + GEN)
