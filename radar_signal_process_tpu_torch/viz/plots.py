"""Plotting suite replicating the reference's visualization components.

* ``plot_pc_magnitude`` — per-PRT pulse-compression magnitude in dB
  (``fun_plot_visualizations.m:33-49``, 'pulse_compression' branch);
* ``plot_doppler_spectrum`` — per-range-bin Doppler spectrum
  (:51-63, 'fft_velocity' branch);
* ``plot_rdm_3d`` — 3-D RDM surface with physical axes
  ``r = (0:N-1)*deltaR``, ``v = linspace(-prf/2, prf/2)*lambda/2``
  (:66-98, 'mtd_3d' branch);
* ``plot_mtd_dashboard`` — 2x2 dashboard: 3-D surface, RDM image with peak
  marker, velocity cut and range cut through the peak
  (``fun_plot_mtd_dashboard.m:36-81``).

matplotlib imports are deferred so headless/TPU jobs never pay for them;
every function accepts ``save_path`` for file output (Agg backend).

The port's own copy of the JAX package's ``viz/plots.py``;
``tests/test_torch_import.py`` holds its code equal to the original.
"""

from __future__ import annotations

import numpy as np

from radar_signal_process_tpu_torch.config import RadarProfile


def _plt(save_path):
    import matplotlib

    if save_path:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def rdm_to_db(rdm: np.ndarray, floor_db: float = -120.0) -> np.ndarray:
    """Peak-normalized dB scaling, ``20*log10(|RDM| / max)`` (main.m:255)."""
    rdm = np.abs(np.asarray(rdm))
    peak = rdm.max() or 1.0
    with np.errstate(divide="ignore"):
        db = 20.0 * np.log10(rdm / peak)
    return np.maximum(db, floor_db)


def physical_axes(profile: RadarProfile, rdm: np.ndarray):
    nv, nr = rdm.shape
    return profile.range_axis(nr), profile.velocity_axis(nv)


def plot_pc_magnitude(pc_row: np.ndarray, prt_index: int = 0, save_path=None):
    plt = _plt(save_path)
    fig, ax = plt.subplots(figsize=(9, 3.5))
    mag = 20.0 * np.log10(np.abs(np.asarray(pc_row)) + 1e-12)
    ax.plot(mag, lw=0.7)
    ax.set_xlabel("range cell")
    ax.set_ylabel("amplitude [dB]")
    ax.set_title(f"pulse compression, PRT {prt_index}")
    return _finish(fig, save_path, plt)


def plot_doppler_spectrum(rdm_col: np.ndarray, v_axis: np.ndarray,
                          range_cell: int = 0, save_path=None):
    plt = _plt(save_path)
    fig, ax = plt.subplots(figsize=(7, 3.5))
    ax.plot(v_axis, 20.0 * np.log10(np.abs(np.asarray(rdm_col)) + 1e-12), lw=0.8)
    ax.set_xlabel("velocity [m/s]")
    ax.set_ylabel("amplitude [dB]")
    ax.set_title(f"Doppler spectrum, range cell {range_cell}")
    return _finish(fig, save_path, plt)


def plot_rdm_3d(rdm: np.ndarray, profile: RadarProfile, save_path=None,
                r_lim=None, v_lim=None):
    plt = _plt(save_path)
    r_axis, v_axis = physical_axes(profile, np.asarray(rdm))
    db = rdm_to_db(rdm)
    fig = plt.figure(figsize=(9, 6))
    ax = fig.add_subplot(projection="3d")
    rr, vv = np.meshgrid(r_axis, v_axis)
    ax.plot_surface(rr, vv, db, cmap="viridis", linewidth=0, antialiased=False)
    ax.set_xlabel("range [m]")
    ax.set_ylabel("velocity [m/s]")
    ax.set_zlabel("amplitude [dB]")
    if r_lim:
        ax.set_xlim(r_lim)
    if v_lim:
        ax.set_ylim(v_lim)
    return _finish(fig, save_path, plt)


def plot_rdm_image(rdm: np.ndarray, profile: RadarProfile, save_path=None,
                   flags: np.ndarray | None = None):
    plt = _plt(save_path)
    rdm = np.asarray(rdm)
    r_axis, v_axis = physical_axes(profile, rdm)
    fig, ax = plt.subplots(figsize=(10, 4.5))
    im = ax.imshow(
        rdm_to_db(rdm), aspect="auto", origin="lower",
        extent=[r_axis[0], r_axis[-1], v_axis[0], v_axis[-1]], cmap="jet",
    )
    fig.colorbar(im, ax=ax, label="dB")
    vi, ri = np.unravel_index(np.argmax(rdm), rdm.shape)
    ax.plot(r_axis[ri], v_axis[vi], "wx", ms=10, mew=2)
    if flags is not None:
        fv, fr = np.nonzero(np.asarray(flags))
        ax.plot(r_axis[fr], v_axis[fv], "r.", ms=3)
    ax.set_xlabel("range [m]")
    ax.set_ylabel("velocity [m/s]")
    return _finish(fig, save_path, plt)


def plot_mtd_dashboard(rdm: np.ndarray, profile: RadarProfile, save_path=None):
    """2x2 dashboard: 3-D surface, RDM image + peak, velocity & range cuts."""
    plt = _plt(save_path)
    rdm = np.asarray(rdm)
    r_axis, v_axis = physical_axes(profile, rdm)
    db = rdm_to_db(rdm)
    vi, ri = np.unravel_index(np.argmax(rdm), rdm.shape)

    fig = plt.figure(figsize=(13, 9))
    ax1 = fig.add_subplot(2, 2, 1, projection="3d")
    rr, vv = np.meshgrid(r_axis, v_axis)
    ax1.plot_surface(rr, vv, db, cmap="viridis", linewidth=0)
    ax1.set_title("RDM surface")

    ax2 = fig.add_subplot(2, 2, 2)
    ax2.imshow(db, aspect="auto", origin="lower",
               extent=[r_axis[0], r_axis[-1], v_axis[0], v_axis[-1]], cmap="jet")
    ax2.plot(r_axis[ri], v_axis[vi], "wx", ms=12, mew=2)
    ax2.set_title(f"peak: v={v_axis[vi]:.2f} m/s, r={r_axis[ri]:.0f} m")

    ax3 = fig.add_subplot(2, 2, 3)
    ax3.plot(v_axis, db[:, ri])
    ax3.set_title("velocity cut through peak")
    ax3.set_xlabel("velocity [m/s]")

    ax4 = fig.add_subplot(2, 2, 4)
    ax4.plot(r_axis, db[vi, :])
    ax4.set_title("range cut through peak")
    ax4.set_xlabel("range [m]")
    fig.tight_layout()
    return _finish(fig, save_path, plt)


def _finish(fig, save_path, plt):
    if save_path:
        fig.savefig(save_path, dpi=110)
        plt.close(fig)
        return save_path
    return fig


def plot_estimate_series(
    frame_idx: np.ndarray,
    range_m: np.ndarray,
    velocity_ms: np.ndarray,
    elevation_deg: np.ndarray,
    gps_frames: np.ndarray | None = None,
    gps_range_m: np.ndarray | None = None,
    gps_velocity_ms: np.ndarray | None = None,
    save_path=None,
    title: str = "G0 estimate series",
):
    """Per-frame R/V/elevation estimate scatter with optional GPS overlay.

    Replicates the G0 driver's live scatter of the detection series
    (``DMX_SignalProcessing_main_xzr.m:534-559``) and its differential-GPS
    range/velocity overlay (``:592-599``) as one 3-row figure.  All radar
    inputs are flattened per-detection series aligned on ``frame_idx``.
    """
    plt = _plt(save_path)
    fig, (ax_r, ax_v, ax_e) = plt.subplots(3, 1, figsize=(10, 9), sharex=True)
    fig.suptitle(title)
    ax_r.scatter(frame_idx, range_m, s=8, label="radar")
    if gps_frames is not None and gps_range_m is not None:
        ax_r.plot(gps_frames, gps_range_m, "r-", lw=1.2, label="GPS")
        ax_r.legend(loc="best")
    ax_r.set_ylabel("range [m]")
    ax_v.scatter(frame_idx, velocity_ms, s=8, label="radar")
    if gps_frames is not None and gps_velocity_ms is not None:
        ax_v.plot(gps_frames, gps_velocity_ms, "r-", lw=1.2, label="GPS")
        ax_v.legend(loc="best")
    ax_v.set_ylabel("velocity [m/s]")
    ax_e.scatter(frame_idx, elevation_deg, s=8)
    ax_e.set_ylabel("elevation [deg]")
    ax_e.set_xlabel("frame")
    return _finish(fig, save_path, plt)


def _animate(update, n_frames: int, fig, plt, save_path, fps: int):
    """Write an animation: .gif via Pillow, else a PNG file sequence.

    ``save_path`` ending in ``.gif`` produces one animated file; any other
    path is treated as a directory receiving ``frame_%04d.png`` (the
    frame-stepped equivalent of the reference's live ``drawnow`` loops).
    Returns the written path (gif) or directory.
    """
    import os

    if save_path and str(save_path).endswith(".gif"):
        from matplotlib.animation import FuncAnimation, PillowWriter

        anim = FuncAnimation(fig, update, frames=n_frames, blit=False)
        anim.save(save_path, writer=PillowWriter(fps=fps))
        plt.close(fig)
        return save_path
    os.makedirs(save_path, exist_ok=True)
    for i in range(n_frames):
        update(i)
        fig.savefig(os.path.join(save_path, f"frame_{i:04d}.png"), dpi=90)
    plt.close(fig)
    return save_path


def plot_pc_animation(
    pc: np.ndarray,
    save_path,
    step: int = 1,
    max_frames: int = 50,
    fps: int = 10,
):
    """Per-PRT pulse-compression magnitude animation (reference V1 mode 1,
    ``MTD/fun_plot_visualizations.m:33-49``: one dB trace per PRT, animated
    over slow time).  ``pc``: (n_prt, n_range) complex or magnitude."""
    plt = _plt(save_path or ".")
    pc = np.asarray(pc)
    mag = 20.0 * np.log10(np.abs(pc) + 1e-12)
    rows = range(0, pc.shape[0], step)[:max_frames]
    fig, ax = plt.subplots(figsize=(9, 3.5))
    (line,) = ax.plot(mag[rows[0]], lw=0.7)
    ax.set_xlabel("range cell")
    ax.set_ylabel("amplitude [dB]")
    ax.set_ylim(mag.min() - 1, mag.max() + 1)

    def update(i):
        line.set_ydata(mag[rows[i]])
        ax.set_title(f"pulse compression, PRT {rows[i]}")
        return (line,)

    return _animate(update, len(rows), fig, plt, save_path, fps)


def plot_doppler_animation(
    rdm: np.ndarray,
    v_axis: np.ndarray,
    save_path,
    step: int = 1,
    max_frames: int = 50,
    fps: int = 10,
):
    """Per-range-bin Doppler spectrum animation (reference V1 mode 2,
    ``MTD/fun_plot_visualizations.m:51-63``).  ``rdm``: (n_v, n_r)
    magnitude; animates the spectrum column by range bin."""
    plt = _plt(save_path or ".")
    rdm = np.asarray(rdm)
    db = 20.0 * np.log10(np.abs(rdm) + 1e-12)
    cols = range(0, rdm.shape[1], step)[:max_frames]
    fig, ax = plt.subplots(figsize=(7, 3.5))
    (line,) = ax.plot(np.asarray(v_axis), db[:, cols[0]], lw=0.8)
    ax.set_xlabel("velocity [m/s]")
    ax.set_ylabel("amplitude [dB]")
    ax.set_ylim(db.min() - 1, db.max() + 1)

    def update(i):
        line.set_ydata(db[:, cols[i]])
        ax.set_title(f"Doppler spectrum, range cell {cols[i]}")
        return (line,)

    return _animate(update, len(cols), fig, plt, save_path, fps)


def plot_iq_debug(
    left: np.ndarray,
    right: np.ndarray,
    prt_index: int = 0,
    frame_index: int = 0,
    save_path=None,
):
    """Live-ingest I/Q debug view (``Show_Read.m:127-136``): 2x2 panel of
    left-beam I, left-beam Q, right-beam I, right-beam Q for one PRT.

    ``left``/``right``: (n_prt, n_samples) complex frames as parsed.
    """
    plt = _plt(save_path)
    li, lq = np.real(left[prt_index]), np.imag(left[prt_index])
    ri, rq = np.real(right[prt_index]), np.imag(right[prt_index])
    fig, axes = plt.subplots(2, 2, figsize=(11, 6))
    for ax, (data, title) in zip(
        axes.ravel(),
        [(li, "left beam I"), (lq, "left beam Q"),
         (ri, "right beam I"), (rq, "right beam Q")],
    ):
        ax.plot(data, lw=0.6)
        ax.set_title(title)
    fig.suptitle(f"frame {frame_index}, PRT {prt_index} echo")
    fig.tight_layout()
    return _finish(fig, save_path, plt)
