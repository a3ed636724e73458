"""The benchmark of ``tpufem_torch`` on one NVIDIA H100 (see README.md)."""
