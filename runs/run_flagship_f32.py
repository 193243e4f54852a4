"""RESULTS.md run G: the reference's long-run flagship configuration
(job-37011720 class: 256^2 one-layer QG, w0=2, U_g=0.4, f=3, Cg=1,
T~2100, ~685k coupled steps) executed END-TO-END ON THE ACCELERATOR in f32 via
the fused Pallas march, at 2^17 packets (2621x the reference's 50 — the
packet ensemble is the measured statistic, so more packets = tighter
e(omega) windows at the same cost class).

The science output is the on-device omega-histogram series
(omega_hist.bin, 360 bins on [0, 12] + overflow slot) — O(bins) host
fetch per save instead of packet frames (RESULTS.md run C).
Compare against runs/flagship_long (run B: same config, CPU f64, 50
packets, full frames) with runs/analyze_flagship_f32.py.

Usage: python runs/run_flagship_f32.py [max_steps]
Re-running resumes from the latest checkpoint automatically.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from swraytracing.drivers import qgsw_raytrace  # noqa: E402

out = os.path.join(REPO, "runs", "flagship_f32")
# Run B's horizon: t in [0, 2101.25], packet release at t=400 (run B's
# run.log "Spin-up time: 1200" records packet_delay_DAYS under the
# round-3 writer; 1200/f = 400 matches its data — packets frozen at
# t=342, spreading by t=416). dt here is deterministic for this config
# (seed 146, f32 on-device max-speed): 0.0030597178, so the horizon is
# hit by capping steps.
max_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 687000
resume = os.path.exists(os.path.join(out, "ckpt")) or any(
    f.startswith("ckpt_") for f in (os.listdir(out)
                                    if os.path.isdir(out) else []))

qgsw_raytrace(
    nx=256, Npackets=2**17, near_inertial_factor=2.0,
    T_Fr_days=6000.0, packet_delay_days=1200.0, U_g=0.4, f=3.0, Cg=1.0,
    out_dir=out,
    # corrected-physics branch, matching run B (RESULTS.md "Notes on
    # fidelity"): the reference's committed +r_drag*K2 line is a defect
    r_drag=0.0, forcing_strength=0.0,
    # PV frames every 1000 steps (0.5 MB each);
    # packet cadence (the science) stays the reference's every-5-steps
    steps_per_save=1000, packet_steps_per_save=5,
    omega_hist_bins=360, omega_hist_max=12.0,
    snapshot_every=68,          # ~10 full packet snapshots over the run
    checkpoint_every=20,        # every 20k steps (~3.4 MB, ~1 s fetch)
    resume=resume, max_steps=max_steps, max_margin_retries=4)
