"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* ``rdm.doppler_rdm``       — B2, replaces ``kernels/rdm_pallas.py``;
* ``cfar.cascaded_cfar2d``  — B1, replaces ``kernels/cfar_pallas.py``.

A wrapper takes its plain version for a CPU tensor and launches its kernel
for a CUDA tensor; it never falls back from one to the other.  Sources are
in ``csrc/``; ``_build`` compiles them with nvcc on first use.
"""
