"""Plain PyTorch DSP ops: the counterparts of ``radar_signal_process_tpu.ops``.

Host constants (windows, reference pulses, DFT planes, filter spectra) are
built with numpy in float64, as in the JAX package; the ops take and return
complex64/float32 tensors on any device.
"""
