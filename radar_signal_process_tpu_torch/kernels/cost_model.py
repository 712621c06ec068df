"""Bytes and operations of the kernels' functions, and their H100 bounds.

Counterpart of ``radar_signal_process_tpu/kernels/cost_model.py``, for the
H100.  The JAX module models each Pallas kernel's BlockSpec schedule on a
v5e.  This one counts what the *function* needs, whatever implements it:
each input read once, each output written once, and the operations of the
product, not of one tiling.  That is the bound of ``chip_smoke.py``'s
``kernels`` line and of ``PERF.md`` §6, and a benchmark reads its roofline
shares against the same numbers.

Peaks are NVIDIA's H100 SXM data sheet at its 700 W limit (dense, no
sparsity): 3.35 TB/s of HBM3, 67 TFLOP/s FP32 outside the tensor cores,
495 TFLOP/s TF32 on them (B2 and B3 run 3×TF32: three TF32 products for
each FP32-accurate one), and NVLink 4 at 900 GB/s a card, 450 GB/s each way.
"""

from __future__ import annotations

from radar_signal_process_tpu_torch.config import CFARConfig

H100_HBM_BPS = 3.35e12
H100_FP32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12
H100_NVLINK_BPS = 450e9
TF32_SPLIT = 3           # 3×TF32: TF32 products per FP32-accurate product


def roofline(hbm_bytes: float, ops: float, peak_ops: float) -> dict:
    """The bound of ``ops`` at ``peak_ops`` and ``hbm_bytes`` at the HBM
    rate: ``sol_s`` the larger time, ``bound_by`` which of the two."""
    t_bytes, t_ops = hbm_bytes / H100_HBM_BPS, ops / peak_ops
    return {"hbm_bytes": float(hbm_bytes), "flops": float(ops), "sol_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cascaded_cfar_cost(batch: int, n_velocity: int, n_range: int, n_clutter: int,
                       cfg: CFARConfig) -> dict:
    """B1 (``kernels/cfar.py::cascaded_cfar2d``): the used rows of the f32
    RDM read once, both byte-wide flag maps written once; per used cell and
    axis r-1 adds, a division, a product and a compare (FP32 peak)."""
    nvu = n_velocity - 2 * n_clutter - 1
    hbm_bytes = batch * nvu * n_range * 4 + 2 * batch * n_velocity * n_range
    ops = 2.0 * batch * nvu * n_range * (cfg.ref_cells + 2)
    return roofline(hbm_bytes, ops, H100_FP32_FLOPS)


def rdm_former_cost(batch: int, n_pulses: int, n_range: int, n_fft: int | None = None) -> dict:
    """B2 (``kernels/rdm.py::doppler_rdm``): the complex64 pulses and both
    f32 DFT planes read once, the f32 RDM written once; 8 real flops per
    complex multiply-add, each at the 3×TF32 rate."""
    n_fft = n_fft or n_pulses
    hbm_bytes = (batch * n_pulses * n_range * 8 + 2 * n_fft * n_pulses * 4
                 + batch * n_fft * n_range * 4)
    flops = 8.0 * n_fft * n_pulses * batch * n_range
    return roofline(hbm_bytes, TF32_SPLIT * flops, H100_TF32_FLOPS)


def fused_pc_rdm_cost(batch: int, n_prt: int, n_in: int, n_out: int, n_fft: int) -> dict:
    """B3 (``kernels/pc_rdm.py::fused_pc_rdm``) on one pulse segment: the
    complex64 echo, both PC-matrix planes and both DFT planes read once, the
    f32 RDM written once; X·M then W·P at the 3×TF32 rate."""
    hbm_bytes = (batch * n_prt * n_in * 8 + n_in * n_out * 8 + n_fft * n_prt * 8
                 + batch * n_fft * n_out * 4)
    flops = 8.0 * batch * n_prt * n_out * (n_in + n_fft)
    return roofline(hbm_bytes, TF32_SPLIT * flops, H100_TF32_FLOPS)


def pulse_compression_cost(profile, n_rows: int, filter_lens) -> dict:
    """PC (``ops/pulse_compression.py::segmented_pulse_compression``) over
    ``n_rows`` PRT rows of ``profile.point_prt`` samples: the complex64 echo
    and each segment's filter spectrum read once, the complex64 output
    written once; per row and segment a forward and an inverse FFT of the
    convolution length L (5 L log2 L flops each) and L complex products (6
    flops), at the FP32 peak (cuFFT runs outside the tensor cores)."""
    import math

    from radar_signal_process_tpu_torch.ops.pulse_compression import fft_len

    lengths = [fft_len(n + f - 1) for n, f in zip(profile.segment_points, filter_lens)]
    hbm_bytes = 2 * n_rows * profile.point_prt * 8 + sum(lengths) * 8
    flops = n_rows * sum(10.0 * n * math.log2(n) + 6.0 * n for n in lengths)
    return roofline(hbm_bytes, flops, H100_FP32_FLOPS)


def dbf_cost(n_samples: int, n_channels: int, n_beams: int) -> dict:
    """DBF (``ops/dbf.py::apply_dbf``) of ``n_samples`` channel vectors: the
    complex64 samples and coefficients read once, the complex64 beams
    written once; 8 real flops per complex multiply-add at the FP32 peak."""
    hbm_bytes = (n_samples * n_channels + n_beams * n_channels + n_samples * n_beams) * 8
    return roofline(hbm_bytes, 8.0 * n_samples * n_channels * n_beams, H100_FP32_FLOPS)


def extraction_cost(batch: int, n_velocity: int, n_range: int, max_detections: int) -> dict:
    """The detection list (``ops/measure.py::extract_detections``): the bool
    flags and the f32 RDM read once, per RDM ``max_detections`` entries of
    two int32 indices, an f32 amplitude and a bool written once; a select
    and a compare per cell at the FP32 peak."""
    cells = batch * n_velocity * n_range
    hbm_bytes = cells * 5 + batch * max_detections * 13
    return roofline(hbm_bytes, 2.0 * cells, H100_FP32_FLOPS)


def sharded_stream_comm_cost(prof=None, dp: int = 1, sp: int = 2, win_size: int = 4,
                             n_clutter: int = 14, cfg: CFARConfig | None = None,
                             link_bw: float = H100_NVLINK_BPS) -> dict:
    """Collective bytes of one window of ``parallel.make_sharded_stream`` on
    a (dp, sp) mesh, per card, and the no-overlap scaling efficiency.

    The bytes are the JAX model's: one all-to-all re-shards the compressed
    frame from slow time to range (a card sends (sp-1)/sp of its complex64
    shard), and one halo exchange sends ``ref + guard + 2E`` edge columns a
    side over the used rows of every slice.  dp carries no collective.  Here
    they cross NVLink, and the compute per card is the H100 bound of PC (the
    frame in and out, complex64), B2 and B1 over the window, divided over
    the mesh.
    """
    from radar_signal_process_tpu_torch.config import G2_PROFILE

    prof = prof or G2_PROFILE
    cfg = cfg or CFARConfig(threshold=5.0)
    n_beams, n_prt, n_pts = prof.n_beams, prof.prt_per_frame, prof.point_prt
    n_chips = dp * sp
    shard_elems = (n_beams / dp) * (n_prt / sp) * n_pts
    a2a_bytes = shard_elems * 8 * (sp - 1) / sp if sp > 1 else 0.0
    h = cfg.ref_cells + cfg.guard_cells + 2 * cfg.range_extend_cells
    nvu = (n_prt - n_clutter) - (n_clutter + 1)
    halo_bytes = (n_beams / dp) * win_size * nvu * h * 4 * 2 if sp > 1 else 0.0
    comm_s = (a2a_bytes + halo_bytes) / link_bw
    pc_s = 2 * n_beams * n_prt * n_pts * 8 / H100_HBM_BPS
    rdm_s = rdm_former_cost(n_beams * win_size, n_prt, n_pts)["sol_s"]
    cfar_s = cascaded_cfar_cost(n_beams * win_size, n_prt, n_pts, n_clutter, cfg)["sol_s"]
    compute_s = (pc_s + rdm_s + cfar_s) / n_chips
    return {
        "n_chips": n_chips,
        "a2a_bytes_per_chip": a2a_bytes,
        "halo_bytes_per_chip": halo_bytes,
        "a2a_mb_per_chip": round(a2a_bytes / 1e6, 2),
        "halo_mb_per_chip": round(halo_bytes / 1e6, 3),
        "comm_ms": comm_s * 1e3,
        "compute_ms_per_chip": compute_s * 1e3,
        "efficiency_pct": 100.0 * compute_s / (compute_s + comm_s),
    }


def g2_frame_fused_cfar_projection(prof=None, n_clutter: int = 14,
                                   threshold: float = 5.0) -> dict:
    """B1's H100 bound over one full G2 window (every beam, 4 slices)."""
    from radar_signal_process_tpu_torch.config import G2_PROFILE

    prof = prof or G2_PROFILE
    return cascaded_cfar_cost(prof.n_beams * 4, prof.prt_per_frame, prof.point_prt,
                              n_clutter, CFARConfig(threshold=threshold))
