"""Kernel K1's plain version against tpufem's fused-step matvec, and the
wrapper's refusals.  The CUDA kernel itself is held against the plain
version on the card by ``tests/test_torch_card_kernels.py`` (marked
``card``; it skips without one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.ops.pallas_kernels import FusedStepMatvec
from tpufem_torch.ops import fused_matvec as fm

torch.set_num_threads(2)

_TORCH_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _inputs(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) * 0.01, rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize(
    "n,precision,use_pallas,atol",
    [
        (700, "f32", False, 1e-4),  # XLA path, as tests/test_pallas.py
        (700, "f64", False, 1e-12),
        (300, "f32", True, 1e-4),  # the Pallas kernel in interpret mode
    ],
)
def test_plain_version_matches_tpufem(n, precision, use_pallas, atol):
    M, b, x = _inputs(n)
    jdt = jnp.float32 if precision == "f32" else jnp.float64
    want = np.asarray(FusedStepMatvec(M, b, dtype=jdt, use_pallas=use_pallas)(jnp.asarray(x, dtype=jdt)))
    dt = _TORCH_DTYPES[precision]
    Mt, xt, bt = (torch.as_tensor(a, dtype=dt) for a in (M, x, b))
    got = fm.fused_step_matvec_ref(Mt, xt, bt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the wrapper takes the plain version on the CPU and launches nothing
    before = fm.fused_step_matvec.launches
    np.testing.assert_array_equal(fm.fused_step_matvec(Mt, xt, bt).numpy(), got)
    assert fm.fused_step_matvec.launches == before


def test_wrapper_refuses_bad_operands():
    M = torch.zeros((4, 3), dtype=torch.float32)
    x = torch.zeros(3, dtype=torch.float32)
    b = torch.zeros(4, dtype=torch.float32)
    with pytest.raises(ValueError, match="different devices"):
        fm.fused_step_matvec(M, x.to("meta"), b)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fm.fused_step_matvec(M.to("meta"), x.to("meta"), b.to("meta"))
    with pytest.raises(TypeError):
        fm.fused_step_matvec(M, x.double(), b)
    with pytest.raises(TypeError):
        fm.fused_step_matvec(M.half(), x.half(), b.half())
    with pytest.raises(ValueError, match="shape mismatch"):
        fm.fused_step_matvec(M, torch.zeros(4), b)
    with pytest.raises(ValueError):
        fm.fused_step_matvec(M, x[None], b)
