"""The benchmark of ``radar_signal_process_tpu_torch`` on NVIDIA H100 cards.

``run.py`` runs one cell of ``BENCHMARK.json``; everything it measures,
generates and compares against lives in this directory, so that a change
to the program cannot change the yardstick.
"""
