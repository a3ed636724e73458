"""The card suite, held on the CPU: every test in ``tests/test_torch_card_*.py``
is marked ``card``; those modules, ``tests/_card.py`` and the other modules
the card command runs import where neither ``tpufem`` nor ``jax`` can (the
card's machine has neither); and the tolerance tables are the values the
kernels and paths were ported under (PERF.md §6)."""

import importlib
import pathlib
import subprocess
import sys

import torch

import _card

ROOT = pathlib.Path(__file__).resolve().parent.parent
CARD_MODULES = sorted(p.stem for p in (ROOT / "tests").glob("test_torch_card_*.py"))
ALSO_ON_CARD = ["test_torch_stokes_graph", "test_torch_ns_refill"]
F32, F64 = torch.float32, torch.float64
TOLERANCES = {
    "KERNEL_RTOL": {F32: 1e-5, F64: 1e-12},
    "GRID_RTOL": {(F64, 0.0): 1e-9, (F64, 1e-5): 1e-5, (F32, 0.0): 1e-3, (F32, 1e-5): 1e-3},
    "K5_P_RTOL": {(F64, 0.0): 1e-7, (F64, 1e-5): 1e-4, (F32, 0.0): 1e-2, (F32, 1e-5): 1e-2},
    "K5_PARITY_RTOL": {0.0: 1e-9, 1e-5: 1e-8},
    "TH_TOL_INNER": {F32: 1e-6, F64: 1e-8},
    "TH_RTOL": {(F64, 0.0): 1e-9, (F64, 1e-8): 1e-6, (F32, 0.0): 1e-3, (F32, 1e-6): 1e-3},
    "TH_K3_F64_RTOL": 1e-7,
    "ENS_RTOL": 1e-10,
    "BF16_RTOL": 1e-2,
    "EUL_PENALTY_C_RTOL": 5e-3,
    "DIAG_TOL": 1e-10,
    "STORAGE_APPLY_RTOL": 1e-5,
    "STORAGE_F64_RTOL": 1e-10,
    "GALLERY_RTOL": 1e-10,
    "XL_C_SLACK": 1e-6,
    "PB16_F32_RTOL": 5e-3,
    "PB16_GAP": 100,
    "PB16_F64_U_GAP": 1e-12,
}
# imports the modules named on its command line with tpufem and jax refused
WITHOUT_JAX = """
import importlib, importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("tpufem", "jax", "jaxlib"):
            raise ImportError(f"{name} is refused here")

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, "tests")
for name in sys.argv[1:]:
    importlib.import_module(name)
"""


def test_card_suite_is_marked_imports_without_jax_and_keeps_its_tolerances():
    assert len(CARD_MODULES) >= 4
    for name in CARD_MODULES:
        module = importlib.import_module(name)
        marks = getattr(module, "pytestmark", [])
        marks = marks if isinstance(marks, list) else [marks]
        tests = [f for k, f in vars(module).items() if k.startswith("test_") and callable(f)]
        assert tests, name
        for f in tests:
            assert any(m.name == "card" for m in marks + getattr(f, "pytestmark", [])), (
                f"{name}.{f.__name__} is not marked card")
    subprocess.run([sys.executable, "-c", WITHOUT_JAX, "_card", *CARD_MODULES, *ALSO_ON_CARD],
                   cwd=ROOT, check=True, timeout=600)
    for name, want in TOLERANCES.items():
        assert getattr(_card, name) == want, name
