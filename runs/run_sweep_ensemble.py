"""The reference's FULL 20-config parameter sweep
(/root/reference/parameters.txt:1-21: w0 in {2,4,8,16} x U_g in
{0.2..1.0}, f=3, Cg=1) executed as vmapped mesh programs on the accelerator —
the SLURM-array replacement (runqgsw_raytrace.sbatch:10) at production
scale: 256^2, 2^14 packets per member (328x the reference's 50), fused
Pallas march engaged under vmap, per-member on-device omega histograms.

Two sequential programs sharing runs/sweep_full (member numbering =
parameters.txt order, w0-major):
  group A — the 8 members behind the reference's committed
    Energy_versus_omega figure family (U_g in {0.2, 0.4}), at the
    committed horizon T=2000 flat ("Simulation time: 2000" in every
    job-37011720 run.log; their T ~ 1/Fr^2 line postdates those runs).
  group B — the 12 strong-flow members (U_g >= 0.6), documented reduced
    horizon T=500 (scattering saturates far earlier at high Fr; ~50+
    eddy turnovers past the t=333.3 release). Running them in their own
    program keeps them from riding along frozen for group A's 654k
    steps.

Usage: python runs/run_sweep_ensemble.py [max_steps]
Re-running resumes each group from its own checkpoint.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from swraytracing.drivers import run_sweep  # noqa: E402

base = os.path.join(REPO, "runs", "sweep_full")
W0S = (2.0, 4.0, 8.0, 16.0)
UGS = (0.2, 0.4, 0.6, 0.8, 1.0)
ALL = [(w0, ug) for w0 in W0S for ug in UGS]   # parameters.txt order

groupA = [(i, p) for i, p in enumerate(ALL) if p[1] <= 0.4]
groupB = [(i, p) for i, p in enumerate(ALL) if p[1] > 0.4]

max_steps = int(sys.argv[1]) if len(sys.argv) > 1 else None
common = dict(
    ensemble=True, base_dir=base, nx=256, Npackets=2**14, f=3.0, Cg=1.0,
    packet_delay_days=1000.0,        # release at t=333.3 (committed logs)
    r_drag=0.0, forcing_strength=0.0,  # corrected-physics branch (run B)
    steps_per_save=1000, packet_steps_per_save=5,  # 1000-step chunks:
    # the per-chunk host round trip amortizes to <1 ms/step
    omega_hist_bins=300,
    window_min_np=2**13,             # engage the fused march at 2^14
    checkpoint_every=40, max_steps=max_steps, max_margin_retries=4)


def launch(group, T):
    ids = [i for i, _ in group]
    sweep = [p for _, p in group]
    resume = os.path.isdir(base) and any(
        f.startswith(f"ckpt-g{ids[0]}_") for f in os.listdir(base))
    run_sweep(sweep, member_ids=ids, resume=resume,
              T_member=lambda w0, ug: T, **common)


launch(groupA, 2000.0)
launch(groupB, 500.0)
