"""Round-5 strong-flow sweep re-run: the 12 U_g >= 0.6 members of
the reference's 20-config sweep (/root/reference/parameters.txt,
runqgsw_raytrace.sbatch:10) with LOG-SPACED omega histograms — closing
round-4 verdict item 3 (histogram truncation) and advancing item 4
(horizon) as far as the round's chip-time budget reaches:

- LOG-SPACED omega histograms on [f, 64*w0*f] (400 bins, ~1.7%/bin):
  run H's linear 2*w0*f grid truncated 2.8-3.1% of the U_g=1.0 members'
  counts (the omega^-2 wing); the log grid keeps the high-omega tail
  in-range at any horizon while resolving the near-inertial peak finer
  than the old linear grid did.
- FROM t=0: the plan was to seed from run H's final group-B checkpoint
  (t ~ 489-500) and continue to the reference horizon T=2000, but the
  checkpoints are .gitignored bulk artifacts and did not survive the
  inter-round workspace reset — only committed files persist. The
  trajectories are re-integrated from the same ICs (deterministic
  seeds); T=2000 for the slowest members is ~1.6M coupled steps, so
  the horizon target rides this run's OWN checkpoints across segments
  (pass max_steps per segment; re-running resumes).
- Per-member PV frame series every 4 chunks (verdict item 6 — the
  reference writes PV every 50 steps, qgsw_raytrace.m:165-172; chunk
  granularity keeps the host transfer small at 12 members).

Writes runs/sweep_b2000/run-{i} with parameters.txt member numbering;
analysis merges these with runs/sweep_full's group A (runs/
analyze_sweep.py, multi-base).
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from swraytracing.drivers import run_sweep  # noqa: E402

base = os.path.join(REPO, "runs", "sweep_b2000")

W0S = (2.0, 4.0, 8.0, 16.0)
UGS = (0.2, 0.4, 0.6, 0.8, 1.0)
ALL = [(w0, ug) for w0 in W0S for ug in UGS]   # parameters.txt order
groupB = [(i, p) for i, p in enumerate(ALL) if p[1] > 0.4]
ids = [i for i, _ in groupB]
sweep = [p for _, p in groupB]          # member order == run H group B

max_steps = int(sys.argv[1]) if len(sys.argv) > 1 else None

run_sweep(
    sweep, member_ids=ids, ensemble=True, base_dir=base,
    nx=256, Npackets=2**14, f=3.0, Cg=1.0,
    packet_delay_days=1000.0,            # release at t=333.3 (run H)
    r_drag=0.0, forcing_strength=0.0,    # corrected-physics branch
    steps_per_save=1000, packet_steps_per_save=5,
    omega_hist_bins=400, omega_hist_log=True, omega_hist_max_factor=64.0,
    window_min_np=2**13,                 # engage the fused march at 2^14
    pv_every=4,
    T_member=lambda w0, ug: 2000.0,
    resume=True,
    checkpoint_every=40, max_steps=max_steps, max_margin_retries=4)
