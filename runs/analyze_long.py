"""Analysis for runs/flagship_long (RESULTS.md run B): e(omega) windows
with the omega^-2 guide, PV+packets, trajectories, and the measured
log-log slope in the scattering band."""
import os
import sys

import numpy as np
import matplotlib
matplotlib.use("Agg")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from swraytracing.analysis import spectra, plots
from swraytracing.io import binio
from swraytracing.ops.grid import SpectralGrid

run = os.path.join(REPO, "runs", "flagship_long")
figs = os.path.join(run, "figs")
os.makedirs(figs, exist_ok=True)

x, k, t, params = spectra.load_packets(run)
f, Cg, nx = params["f"], params["Cg"], params["nx"]
om = spectra.omega_of_k(k, f, Cg)
n = om.shape[0]
i0 = int(np.searchsorted(t, 400.0))
print(f"frames={n} t=[{t[0]:.1f},{t[-1]:.1f}] unfreeze@{i0}")
print("omega/f std first/mid/last:",
      round(om[min(i0 + 600, n - 1)].std() / f, 4),
      round(om[(i0 + n) // 2].std() / f, 4),
      round(om[-1].std() / f, 4))

# the reference's window choice (load_data.m:36-37): early, 1000 frames
# in, 30000 frames in, end-offset
times_idx = [i0 + 501, i0 + 1000, min(i0 + 30000, (i0 + n) // 2 + 5000),
             n - 501]
times_idx = sorted(set(min(max(i, 501), n - 501) for i in times_idx))
plots.plot_energy_spectra(
    om, times_idx, f, offset=500,
    path=os.path.join(figs, "energy_vs_omega.png"),
    title=("e($\\omega$) — 256$^2$ QG, 50 packets, $w_0$=2, "
           "Fr$\\approx$0.40, T=2000 (job-37011720 config)"))

nf_pv = binio.frame_count(os.path.join(run, "pv"), nx, nx)
q_last = binio.read_field(os.path.join(run, "pv"), nx, nx, frames=nf_pv)
grid = SpectralGrid.square(nx, params.get("L", 2 * np.pi))
plots.render_pv_frame(q_last, grid, packet_x=x[-1], packet_k=k[-1],
                      path=os.path.join(figs, "pv_packets.png"))
plots.plot_trajectories(x[i0::10], k[i0::10], f, Cg,
                        path=os.path.join(figs, "trajectories.png"))

# slope of e(omega) in the scattering band at the final window
w = spectra.omega_windows(om, [n - 501], 500)[0]
c, e = spectra.energy_vs_omega(w, 300)
m = (c / f > 1.2) & (c / f < 3.5) & (e > 0)
p = np.polyfit(np.log(c[m] / f), np.log(e[m]), 1)
print("log-log slope (1.2 < omega/f < 3.5), final window:",
      round(p[0], 3))
print("figures written to", figs)
