"""RESULTS.md run G analysis: the f32 device flagship (runs/flagship_f32,
on-device omega histograms, 2^17 packets) against the CPU/f64 run B
(runs/flagship_long, 50 packets, full frames) — same physical
configuration, independent precision/hardware/packet-count.

Produces:
  figs/energy_vs_omega.png      — run G's own headline figure
  figs/energy_vs_omega_vs_cpu.png — window-by-window f32-device-vs-CPU-f64 overlay
                                    (normalized e(omega), shared edges)
  figs/pv_packets.png           — final PV + packet snapshot overlay
  f32_vs_f64_metrics.json       — per-window normalized-spectrum L1
                                  distance + std(omega)/f for both runs
Windows are matched by TIME (the two runs' CFL dt differ by 0.3%), with
the reference's +-500-frame half-width expressed in time units
(load_data.m:43-45).
"""
import json
import os
import sys

import numpy as np
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from swraytracing.analysis import spectra, plots  # noqa: E402
from swraytracing.io import binio  # noqa: E402
from swraytracing.ops.grid import SpectralGrid  # noqa: E402

G = os.path.join(REPO, "runs", "flagship_f32")
B = os.path.join(REPO, "runs", "flagship_long")
figs = os.path.join(G, "figs")
os.makedirs(figs, exist_ok=True)

# ---- run G: on-device histogram series
cg, edges, tg, pg = spectra.load_omega_hist(G)
f, Cg = pg["f"], pg["Cg"]
print(f"run G: {cg.shape[0]} hist frames, t=[{tg[0]:.1f},{tg[-1]:.1f}], "
      f"overflow total={cg[:, -1].sum():.0f}")

# ---- run B: frames -> omega samples
xb, kb, tb, pb = spectra.load_packets(B)
omb = spectra.omega_of_k(kb, f, Cg)

# window half-width in TIME: the reference's +-500 packet frames
half_t = 500 * 5 * pb["dt"]
release = 400.0
t_end = min(tg[-1], tb[-1])
centers_t = [release + half_t + 1.0,
             release + 0.25 * (t_end - release),
             release + 0.55 * (t_end - release),
             t_end - half_t - 1.0]

results = []
fig, ax = plt.subplots(figsize=(7, 5))
cmap = plt.cm.viridis(np.linspace(0.15, 0.85, len(centers_t)))
ctr = 0.5 * (edges[1:] + edges[:-1])
for ci, t_c in enumerate(centers_t):
    # run G window: pooled counts
    iG = int(np.searchsorted(tg, t_c))
    offG = max(1, int(round(half_t / (tg[2] - tg[1]))))
    pooled = spectra.hist_windows(cg, [iG], offG)[0]
    cG, eG = spectra.energy_vs_omega_hist(pooled, edges)
    # run B window: histogram the pooled samples on the SAME edges
    iB = int(np.searchsorted(tb, t_c))
    offB = 500
    wB = omb[max(0, iB - offB):iB + offB + 1].ravel()
    countsB = np.histogram(wB, edges)[0]
    eB = ctr * countsB

    nG, nB = eG / max(eG.sum(), 1), eB / max(eB.sum(), 1)
    l1 = float(np.abs(nG - nB).sum())
    mG, sG = spectra.hist_moments(pooled, edges)
    results.append(dict(t_center=float(t_c), l1_distance=l1,
                        std_omega_over_f_f32=float(sG / f),
                        std_omega_over_f_cpu=float(wB.std() / f),
                        mean_omega_over_f_f32=float(mG / f),
                        mean_omega_over_f_cpu=float(wB.mean() / f)))
    keepG, keepB = nG > 0, nB > 0
    ax.loglog(ctr[keepG] / f, nG[keepG], color=cmap[ci], lw=2,
              label=f"f32 device, t={t_c:.0f}")
    ax.loglog(ctr[keepB] / f, nB[keepB], color=cmap[ci], lw=1.2,
              ls="--", label=f"CPU f64, t={t_c:.0f}")

wf = np.geomspace(1.05, 3.8, 50)
ref = results[-1]
nlast = spectra.energy_vs_omega_hist(
    spectra.hist_windows(cg, [int(np.searchsorted(tg, centers_t[-1]))],
                         max(1, int(round(half_t / (tg[2] - tg[1]))))) [0],
    edges)[1]
scale = (nlast / max(nlast.sum(), 1)).max()
ax.loglog(wf, scale * wf**-2.0, "k--", lw=1, label=r"$\omega^{-2}$")
ax.set_xlabel(r"$\omega/f$")
ax.set_ylabel(r"normalized $e(\omega)$")
ax.set_title("f32 device (2$^{17}$ packets, device histogram) vs "
             "CPU f64 (50 packets, frames)\n256$^2$ QG, $w_0$=2, "
             "$U_g$=0.4, T$\\approx$2100")
ax.legend(fontsize=7, ncol=2)
fig.tight_layout()
fig.savefig(os.path.join(figs, "energy_vs_omega_vs_cpu.png"), dpi=130)
plt.close(fig)

# ---- run G standalone headline figure (load_data.m styling)
fig, ax = plt.subplots(figsize=(6, 4.5))
for ci, t_c in enumerate(centers_t):
    iG = int(np.searchsorted(tg, t_c))
    offG = max(1, int(round(half_t / (tg[2] - tg[1]))))
    pooled = spectra.hist_windows(cg, [iG], offG)[0]
    cG, eG = spectra.energy_vs_omega_hist(pooled, edges)
    keep = eG > 0
    ax.loglog(cG[keep] / f, eG[keep], color=cmap[ci], lw=2,
              label=f"t={t_c:.0f}")
e0 = eG.max()
ax.loglog(wf, e0 * wf**-2.0, "k--", lw=1, label=r"$\omega^{-2}$")
ax.set_xlabel(r"$\omega/f$")
ax.set_ylabel(r"$e(\omega)$")
ax.set_title("e($\\omega$) on the device (f32) — 256$^2$ QG, 2$^{17}$ packets, "
             "$w_0$=2, Fr$\\approx$0.40, T$\\approx$2100")
ax.legend(fontsize=8)
fig.tight_layout()
fig.savefig(os.path.join(figs, "energy_vs_omega.png"), dpi=130)
plt.close(fig)

# ---- k-space diffusion across the sparse snapshots (the
# raytracing_figures.m ring->annulus picture, from packet_snap_k)
ns_all = binio.frame_count(os.path.join(G, "packet_snap_k"),
                           pg["n_packets"], 2)
tsnap = binio.read_field(os.path.join(G, "packet_snap_time"))
pick = [i for i in range(1, ns_all + 1)
        if tsnap[i - 1] >= release - 1] or [ns_all]
pick = pick[:: max(1, len(pick) // 4)][:4] + [ns_all]
fig, axes = plt.subplots(1, len(pick), figsize=(3.2 * len(pick), 3.4),
                         sharex=True, sharey=True)
for ax, fr in zip(np.atleast_1d(axes), pick):
    kk = binio.read_field(os.path.join(G, "packet_snap_k"),
                          pg["n_packets"], 2, frames=fr)
    ax.plot(kk[::32, 0], kk[::32, 1], ".", ms=0.5, alpha=0.3)
    ax.set_title(f"t={tsnap[fr-1]:.0f}", fontsize=9)
    ax.set_aspect("equal")
fig.suptitle("wavevector ensemble (2$^{17}$ packets, f32 device): "
             "ring $\\to$ annulus refraction diffusion", fontsize=10)
fig.tight_layout()
fig.savefig(os.path.join(figs, "kspace_snapshots.png"), dpi=120)
plt.close(fig)

# ---- final PV + packet snapshot
nx = pg["nx"]
ns = binio.frame_count(os.path.join(G, "packet_snap_x"),
                       pg["n_packets"], 2)
xs = binio.read_field(os.path.join(G, "packet_snap_x"),
                      pg["n_packets"], 2, frames=ns)
ks = binio.read_field(os.path.join(G, "packet_snap_k"),
                      pg["n_packets"], 2, frames=ns)
nf_pv = binio.frame_count(os.path.join(G, "pv"), nx, nx)
q = binio.read_field(os.path.join(G, "pv"), nx, nx, frames=nf_pv)
grid = SpectralGrid.square(nx, pg.get("L", 2 * np.pi))
sub = slice(None, None, 64)  # subsample the 131k packets for drawing
plots.render_pv_frame(q, grid, packet_x=xs[sub], packet_k=ks[sub],
                      path=os.path.join(figs, "pv_packets.png"))

with open(os.path.join(G, "f32_vs_f64_metrics.json"), "w") as fh:
    json.dump(results, fh, indent=1)
print(json.dumps(results, indent=1))

# compact committed artifact: the pooled window counts behind the
# figures (the full omega_hist.bin is ~400 MB and gitignored; this npz
# is a few KB and reproduces every curve above)
offG = max(1, int(round(half_t / (tg[2] - tg[1]))))
pooled_rows = np.stack([
    spectra.hist_windows(cg, [int(np.searchsorted(tg, t_c))], offG)[0]
    for t_c in centers_t])
np.savez(os.path.join(G, "omega_windows.npz"),
         pooled_counts=pooled_rows, edges=edges,
         window_centers_t=np.asarray(centers_t), half_width_t=half_t)

# loop-rate comparison (run B sustained ~157 steps/s avg on CPU)
import json as _j
rates = [l for l in open(os.path.join(G, "metrics.jsonl"))
         if "steps_per_sec" in l]
sps = [float(_j.loads(l)["steps_per_sec"]) for l in rates]
print(f"run G loop rate: median {np.median(sps):.1f} steps/s "
      f"({len(sps)} chunks); run B avg ~157 steps/s")
print("figures written to", figs)
