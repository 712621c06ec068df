"""Visualization & analysis (reference V1-V3, SURVEY.md §2.5).

The port's own copy of the JAX package's ``viz/__init__.py``;
``tests/test_torch_import.py`` holds its code equal to the original.
"""

from radar_signal_process_tpu_torch.viz.plots import (  # noqa: F401
    plot_rdm_3d,
    plot_rdm_image,
    plot_mtd_dashboard,
    plot_pc_magnitude,
    plot_doppler_spectrum,
    plot_estimate_series,
    plot_pc_animation,
    plot_doppler_animation,
    plot_iq_debug,
    rdm_to_db,
)
