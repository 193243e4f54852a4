"""Production run drivers: the reference's SLURM entry points, complete
with frame I/O, logging, metrics, and checkpoint/resume.

`qgsw_raytrace(...)` and `qg2layersw_raytrace(...)` keep the reference's
positional signatures (/root/reference/qg_flow_ray_trace/
qgsw_raytrace.m:1, qg2layersw_raytrace.m:1) and output-file layout
(data/pv, data/pv_time, data/packet_x, data/packet_k, data/packet_time
as frame-addressed .bin — :34-38) so reference analysis tooling works on
our runs unchanged, while the compute is chunked `lax.scan`s on the
device. Each PV-save interval is one jitted chunk; packet frames are
written from the chunk's stacked history.

`run_sweep` replaces the SLURM job array (runqgsw_raytrace.sbatch:10 +
parameters.txt): a parameter table is executed as successive (or
vmapped-ensemble) runs in one process, each with its own run directory.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import jax

from .io import binio
from .io.asyncwriter import AsyncWriter
from .io.runmeta import RunDir
from .utils.host import fetch
from .io.checkpoint import save_state, restore_state, latest_checkpoint
from .ops import spectral as sp

__all__ = ["qgsw_raytrace", "qg2layersw_raytrace", "run_sweep",
           "DEFAULT_SWEEP"]


def _run_coupled(setup, carry0, cfg, run, out_dir, fields_of_state,
                 max_steps, checkpoint_every, resume, log, Kd2,
                 cfl_recheck=None, remargin=None, prev_fields_fn=None,
                 max_margin_retries=2, hist=None, snapshot_every=0,
                 monitor_every=0):
    """Shared chunked execution + I/O loop for both coupled drivers.

    monitor_every: render the current PV field with the packet ensemble
    overlaid to figs/live/ every N chunks — the reference's in-run
    plotting (qg2layersw_raytrace.m:211-239 pcolors both layers every 10
    steps; rsw/swk.m:155-179 plotstuff/hmov), as files instead of a
    figure window. Uses the PV grid already fetched for the frame write
    plus a device-side packet subsample (<=4096 packets) so the extra
    host traffic is a few hundred KB.

    hist: optional analysis.device_diag.OmegaHistSpec. When set the run
    is in DIAGNOSTIC mode: the chunk fn emits per-save omega-histogram
    count rows instead of packet frames (run_coupled_chunk diag_fn), and
    the loop writes them as frames of `omega_hist.bin` (row length
    n_bins+1, the last slot the overflow count) next to the usual
    packet_time frames. Full packet states are written only as sparse
    snapshots (`packet_snap_x/k/time.bin`) every `snapshot_every` chunks
    (0 = never mid-run) — the host fetch per chunk drops from O(Np) to
    O(bins), which keeps the host transfer of production-length runs
    small (RESULTS.md run C).

    cfl_recheck: optional (carry, run) -> run hook called between
    chunks; used by the two-layer driver to rebuild the exponential
    operators with a smaller dt when the flow speeds up
    (qg2layersw_raytrace.m:154-165 semantics at chunk granularity).

    remargin: optional (overflow_cells) -> run hook. When the fused
    march reports a margin overflow (a packet out-drifted its gathered
    window within one flow step — its stencil was clamped, physics
    wrong), the chunk is DISCARDED, the march spec rebuilt with a
    margin covering the observed drift, and the chunk re-run from its
    start state — at most `max_margin_retries` times per chunk, after
    which (or when no hook is given) the run halts like a blow-up
    rather than writing silently-clamped frames.

    prev_fields_fn: flow_state -> (nf, nx, ny) velocity grids matching
    this configuration's march path; used to reconcile checkpoints
    saved under a different march config (prev_fields nf mismatch) on
    resume.
    """
    s = setup
    rd = RunDir(out_dir)
    grid = s.grid
    saves_per_pv = max(1, cfg.steps_per_save // cfg.packet_steps_per_save)
    steps_per_chunk = saves_per_pv * cfg.packet_steps_per_save
    n_steps = s.n_steps if max_steps is None else min(s.n_steps, max_steps)
    n_chunks = max(1, int(np.ceil(n_steps / steps_per_chunk)))

    hist_kw = {}
    if hist is not None:
        hist_kw = dict(omega_hist_bins=hist.n_bins,
                       omega_hist_max=hist.omega_max,
                       omega_hist_log=bool(hist.log_bins),
                       omega_hist_min=float(hist.omega_min))
    rd.write_params(
        nx=cfg.nx, n_packets=cfg.n_packets,
        near_inertial_factor=cfg.near_inertial_factor, f=cfg.f, Cg=cfg.Cg,
        U_g=cfg.U_g, U0=s.U0, Fr=s.Fr, dt=s.dt, T=s.T, n_steps=n_steps,
        steps_per_save=cfg.steps_per_save,
        packet_steps_per_save=cfg.packet_steps_per_save,
        stepper=cfg.stepper, n_substeps=cfg.n_substeps, L=cfg.L,
        **hist_kw)
    rd.write_run_log(
        nx=cfg.nx, n_packets=cfg.n_packets,
        k_radius=cfg.near_inertial_factor * cfg.f, dt=s.dt, T=s.T,
        spin_up=s.packet_delay, steps_per_save=cfg.steps_per_save,
        packet_steps_per_save=cfg.packet_steps_per_save, f=cfg.f,
        Cg=cfg.Cg, U_g=cfg.U_g, U0=s.U0, Fr=s.Fr, Kd2=Kd2)

    carry = carry0
    chunk0 = 0
    ck = latest_checkpoint(rd.path) if resume else None
    if ck is not None:
        carry = restore_state(ck, carry0, to_device=True)
        chunk0 = int(ck.split("_")[-1].split(".")[0])
        log(f"resumed from {ck} at chunk {chunk0}")
        if carry.prev_fields.shape != carry0.prev_fields.shape:
            # Checkpoint written under a different march configuration
            # (uv windows carry (2,nx,ny), other paths (6,nx,ny)):
            # prev_fields is a pure function of the flow state, so
            # rebuild it for THIS configuration instead of trace-failing
            # (checkpoints stay config-portable).
            if prev_fields_fn is None:
                raise ValueError(
                    f"checkpoint prev_fields {carry.prev_fields.shape} "
                    f"does not match this configuration's "
                    f"{carry0.prev_fields.shape} and no prev_fields_fn "
                    "was provided to reconcile it")
            log(f"checkpoint prev_fields {carry.prev_fields.shape} -> "
                f"rebuilt as {carry0.prev_fields.shape} for this config")
            carry = carry.replace(prev_fields=jax.jit(prev_fields_fn)(
                carry.flow_state))

    pv_frame = chunk0 + 1
    packet_frame = chunk0 * saves_per_pv + 1
    # Next snapshot frame: derived from the FILE on resume (the run has
    # already written 1 initial + chunk0//snapshot_every interval
    # snapshots; chunk arithmetic alone was off by one — ADVICE r4).
    snap_frame = 1
    if hist is not None and chunk0:
        snap_frame = binio.frame_count(
            rd.file("packet_snap_time"), 1) + 1

    if hist is not None:
        from .analysis.device_diag import omega_hist_counts
        hist_fn = jax.jit(omega_hist_counts, static_argnums=1)

    def write_snapshot(c, frame):
        """Sparse full-packet snapshot (diagnostic mode): the packet
        state at a chunk boundary, in the reference's (Np, 2) record
        layout, plus its time."""
        binio.write_field(grid.wrap_centered(fetch(c.packet_x).T),
                          rd.file("packet_snap_x"), frame)
        binio.write_field(fetch(c.packet_k).T,
                          rd.file("packet_snap_k"), frame)
        binio.write_field(fetch(c.flow_state.t),
                          rd.file("packet_snap_time"), frame)

    if chunk0 == 0:
        # initial frames (reference writes frame 1 before the loop)
        # packet state is (2, Np) on device (coordinate-first); files
        # keep the reference's (Np, 2) record layout
        if hist is None:
            binio.write_field(grid.wrap_centered(fetch(carry.packet_x).T),
                              rd.file("packet_x"), 1)
            binio.write_field(fetch(carry.packet_k).T,
                              rd.file("packet_k"), 1)
        else:
            binio.write_field(fetch(hist_fn(carry.packet_k, hist)),
                              rd.file("omega_hist"), 1)
            write_snapshot(carry, 1)
            snap_frame = 2
        binio.write_field(np.asarray(0.0), rd.file("packet_time"), 1)
        q0 = fetch(jax.jit(fields_of_state)(carry.flow_state))
        binio.write_field(np.moveaxis(q0, 0, -1) if q0.ndim == 3 else q0,
                          rd.file("pv"), 1)
        binio.write_field(np.asarray(0.0), rd.file("pv_time"), 1)

    t_start = time.time()
    chunk = chunk0
    margin_retries = 0
    # Frame writes go through a single worker thread so disk I/O
    # overlaps the next chunk's device compute (~16 MB per packet frame
    # at 1e6 packets; the reference writes synchronously in-loop,
    # qgsw_raytrace.m:153-172). Ordering per file is preserved (FIFO);
    # close() below joins before the run returns.
    writer = AsyncWriter()
    # Blow-up check fetches ONE bool, not the full (nx, nky) spectrum;
    # the fetch also ends the chunk's timing window.
    finite_s = jax.jit(lambda qk: jax.numpy.isfinite(qk).all())
    try:
      while chunk < n_chunks:
        chunk_start_carry = carry
        tc = time.time()
        if hist is None:
            carry, (px, pk, ts) = run(carry)
        else:
            carry, (hc, ts) = run(carry)
        qk_ok = bool(np.asarray(fetch(finite_s(carry.flow_state.qk))))
        elapsed = time.time() - tc

        # Blow-up detection (rsw/swk.m:144-148 semantics at chunk
        # granularity): save what we have and stop instead of writing NaNs.
        if not qk_ok:
            log(f"BLOW UP detected at chunk {chunk} "
                f"(t~{float(np.asarray(ts)[-1]):.3f}); stopping and "
                "keeping frames written so far")
            rd.log_metrics(chunk=chunk, blow_up=True)
            break

        # Fused-march margin check: overflow > 0 means some packet out-
        # drifted its gathered window within a flow step this chunk (its
        # stencil was clamped — the chunk's trajectories are WRONG).
        # Discard the chunk, widen the margin to cover the observed
        # drift, and re-run it from the chunk-start state; halt (like a
        # blow-up) if no remargin hook or retries are exhausted — never
        # write silently-clamped frames.
        if getattr(carry, "overflow", None) is not None:
            ov = int(fetch(carry.overflow))
            if ov > 0:
                rd.log_metrics(chunk=chunk, march_overflow=ov,
                               chunk_discarded=True)
                if remargin is not None and margin_retries < \
                        max_margin_retries:
                    margin_retries += 1
                    log(f"margin overflow {ov} cells at chunk {chunk}; "
                        f"widening march margin and re-running the "
                        f"chunk (retry {margin_retries})")
                    run = remargin(ov)
                    # stale prev_win (old window K) is rebuilt by
                    # prepare_carry_windows inside the new run fn
                    carry = chunk_start_carry
                    continue
                why = ("retries exhausted" if margin_retries else
                       "no remargin retries configured")
                log(f"HALT: fused-march margin overflow {ov} cells at "
                    f"chunk {chunk} ({why}); frames for this chunk "
                    "were NOT written")
                carry = chunk_start_carry
                break
            # Reset the running max so the NEXT chunk's overflows are
            # distinguishable from this one's (ADVICE round 2).
            carry = carry.replace(
                overflow=jax.numpy.zeros((), jax.numpy.int32))

        if hist is None:
            px_np, pk_np, ts_np = fetch((px, pk, ts))
            for j in range(px_np.shape[0]):
                packet_frame += 1
                writer.submit(binio.write_field,
                              grid.wrap_centered(px_np[j].T),
                              rd.file("packet_x"), packet_frame)
                writer.submit(binio.write_field,
                              np.ascontiguousarray(pk_np[j].T),
                              rd.file("packet_k"), packet_frame)
                writer.submit(binio.write_field, ts_np[j],
                              rd.file("packet_time"), packet_frame)
        else:
            hc_np, ts_np = fetch((hc, ts))
            for j in range(hc_np.shape[0]):
                packet_frame += 1
                writer.submit(binio.write_field,
                              np.ascontiguousarray(hc_np[j]),
                              rd.file("omega_hist"), packet_frame)
                writer.submit(binio.write_field, ts_np[j],
                              rd.file("packet_time"), packet_frame)
            if snapshot_every and (chunk + 1) % snapshot_every == 0:
                write_snapshot(carry, snap_frame)
                snap_frame += 1
        pv_frame += 1
        q = fetch(jax.jit(fields_of_state)(carry.flow_state))
        writer.submit(binio.write_field,
                      np.moveaxis(q, 0, -1) if q.ndim == 3 else q,
                      rd.file("pv"), pv_frame)
        writer.submit(binio.write_field, float(ts_np[-1]),
                      rd.file("pv_time"), pv_frame)

        if monitor_every and (chunk + 1) % monitor_every == 0:
            from .analysis import plots
            stride = max(1, carry.packet_x.shape[-1] // 4096)
            px_m, pk_m = fetch(jax.jit(
                lambda c: (c.packet_x[:, ::stride],
                           c.packet_k[:, ::stride]))(carry))
            live = rd.path / "figs" / "live"
            live.mkdir(parents=True, exist_ok=True)
            plots.render_pv_frame(
                q[0] if q.ndim == 3 else q, grid, packet_x=px_m.T,
                packet_k=pk_m.T,
                path=live / f"frame_{pv_frame:06d}.png",
                title=f"t={float(ts_np[-1]):.2f}")

        rd.log_metrics(chunk=chunk, t=float(ts_np[-1]),
                       steps=steps_per_chunk, wall_s=elapsed,
                       steps_per_sec=steps_per_chunk / elapsed,
                       packet_steps_per_sec=(steps_per_chunk
                                             * cfg.n_packets / elapsed))
        if checkpoint_every and (chunk + 1) % checkpoint_every == 0:
            # Strip the carried interpolation windows: they are a pure
            # function of prev_fields (rebuilt on resume by
            # prepare_carry_windows) and would add ~226 MB per
            # checkpoint at 512^2. Flush first: a checkpoint at chunk
            # N must imply every frame up to N is durable (resume
            # rewrites only frames FROM the checkpoint).
            writer.flush()
            save_state(rd.path / "ckpt",
                       carry.replace(prev_win=None, overflow=None),
                       step=chunk + 1)
        if cfl_recheck is not None:
            run = cfl_recheck(carry, run)
        if chunk % 10 == 0:
            pct = 100.0 * (chunk + 1) / n_chunks
            log(f"{pct:6.2f}%  t={float(ts_np[-1]):.3f} "
                f"({steps_per_chunk / elapsed:.1f} steps/s)")
        chunk += 1
        margin_retries = 0
    finally:
        writer.close()

    if hist is not None:
        write_snapshot(carry, snap_frame)  # final full packet state
    rd.finish_run_log()
    log(f"done: {time.time() - t_start:.1f} s wall")
    return carry, rd



def _make_remargin(state, make_run, log):
    """Shared overflow-response hook for both drivers: widen the march
    margin to cover the observed drift (capped so the window fits the
    grid) and rebuild the jitted run against the updated setup in
    `state` (a {"s": setup} holder shared with make_run)."""
    from .ops.pallas_window import max_margin

    def remargin(ov_cells):
        sn = state["s"]
        if sn.march is None:
            return make_run()
        cap = max_margin(min(sn.grid.nx, sn.grid.ny))
        new_m = min(sn.march.margin + int(ov_cells) + 1, cap)
        log(f"march margin {sn.march.margin} -> {new_m} (cap {cap})")
        state["s"] = sn._replace(march=sn.march._replace(margin=new_m))
        return make_run()

    return remargin


def _hist_spec(omega_hist_bins, omega_hist_max, cfg, log_bins=False):
    """Build the OmegaHistSpec + diag_fn for a driver's diagnostic mode
    (0 bins = off). Linear default omega_max = 2 * w0 * f covers the
    scattered band of weak-flow configurations (run B's samples top out
    at 1.65 * w0 * f); for strong flow (U_g >~ 0.6) or long horizons
    pass log_bins=True, which spans [f, omega_max or 64*w0*f]
    geomspaced so the high-omega wing is never cut (round-4 verdict
    weak #1). The overflow slot makes any residual truncation visible
    either way."""
    if not omega_hist_bins:
        return None, None
    from .analysis.device_diag import OmegaHistSpec, omega_hist_counts
    w0f = cfg.near_inertial_factor * cfg.f
    wmax = (float(omega_hist_max) if omega_hist_max
            else (64.0 * w0f if log_bins else 2.0 * w0f))
    spec = OmegaHistSpec(n_bins=int(omega_hist_bins), omega_max=wmax,
                         f=cfg.f, Cg=cfg.Cg,
                         omega_min=cfg.f if log_bins else 0.0,
                         log_bins=bool(log_bins))
    return spec, (lambda c: omega_hist_counts(c.packet_k, spec))


def qgsw_raytrace(nx=256, Npackets=50, near_inertial_factor=2.0,
                  T_Fr_days=6000.0, packet_delay_days=1000.0, U_g=0.4,
                  f=3.0, Cg=1.0, out_dir="data", *, max_steps=None,
                  checkpoint_every=50, resume=False, verbose=True,
                  max_margin_retries=2, omega_hist_bins=0,
                  omega_hist_max=None, omega_hist_log=False,
                  snapshot_every=0, monitor_every=0,
                  **cfg_overrides):
    """One-layer coupled production run (qgsw_raytrace.m:1 signature).

    omega_hist_bins > 0 switches to diagnostic mode: per-save on-device
    omega-histogram rows (omega_hist.bin) instead of packet frames, with
    sparse full snapshots every `snapshot_every` chunks — see
    _run_coupled."""
    from .models.coupled import (CoupledConfig, setup_coupled,
                                 run_coupled_chunk, march_n_fields)
    from .models.fields import flow_from_qk

    log = print if verbose else (lambda *_: None)
    cfg = CoupledConfig(nx=nx, n_packets=Npackets,
                        near_inertial_factor=near_inertial_factor,
                        T_Fr_days=T_Fr_days,
                        packet_delay_days=packet_delay_days, U_g=U_g, f=f,
                        Cg=Cg, **cfg_overrides)
    s, carry0 = setup_coupled(cfg)
    saves_per_pv = max(1, cfg.steps_per_save // cfg.packet_steps_per_save)
    state = {"s": s}
    hist, diag_fn = _hist_spec(omega_hist_bins, omega_hist_max, cfg,
                                omega_hist_log)

    def make_run():
        return jax.jit(functools.partial(run_coupled_chunk, s=state["s"],
                                         cfg=cfg, n_saves=saves_per_pv,
                                         diag_fn=diag_fn))

    remargin = _make_remargin(state, make_run, log)

    run = make_run()
    Kd2 = cfg.f / cfg.Cg
    fields_of_state = lambda st: sp.to_grid(st.qk, s.grid)
    prev_fields_fn = lambda st: flow_from_qk(
        st.qk, s.grid, Kd2, n_fields=march_n_fields(s.march)).fields
    log(f"qgsw_raytrace: nx={nx} Np={Npackets} dt={s.dt:.5f} "
        f"Fr={s.Fr:.4f} n_steps={s.n_steps}")
    return _run_coupled(s, carry0, cfg, run, out_dir, fields_of_state,
                        max_steps, checkpoint_every, resume, log, Kd2,
                        remargin=remargin, prev_fields_fn=prev_fields_fn,
                        max_margin_retries=max_margin_retries, hist=hist,
                        snapshot_every=snapshot_every,
                        monitor_every=monitor_every)


def qg2layersw_raytrace(nx=256, Npackets=50, near_inertial_factor=2.0,
                        T_Fr_days=6000.0, packet_delay_days=1000.0,
                        U_g=0.4, f=3.0, Cg=1.0, out_dir="data2", *,
                        max_steps=None, checkpoint_every=50, resume=False,
                        verbose=True, max_margin_retries=2,
                        omega_hist_bins=0, omega_hist_max=None,
                        omega_hist_log=False,
                        snapshot_every=0, monitor_every=0,
                        **cfg_overrides):
    """Two-layer coupled production run (qg2layersw_raytrace.m:1)."""
    from .models.coupled import march_n_fields
    from .models.coupled2 import (Coupled2Config, setup_coupled2,
                                  run_coupled2_chunk)
    from .models.qg2 import top_layer_flow

    log = print if verbose else (lambda *_: None)
    cfg = Coupled2Config(nx=nx, n_packets=Npackets,
                         near_inertial_factor=near_inertial_factor,
                         T_Fr_days=T_Fr_days,
                         packet_delay_days=packet_delay_days, U_g=U_g,
                         f=f, Cg=Cg, **cfg_overrides)
    s, carry0 = setup_coupled2(cfg)
    saves_per_pv = max(1, cfg.steps_per_save // cfg.packet_steps_per_save)

    state = {"s": s}
    hist, diag_fn = _hist_spec(omega_hist_bins, omega_hist_max, cfg,
                                omega_hist_log)

    def make_run(setup_now):
        return jax.jit(functools.partial(run_coupled2_chunk, s=setup_now,
                                         cfg=cfg, n_saves=saves_per_pv,
                                         diag_fn=diag_fn))

    def cfl_recheck(carry, run):
        """Rebuild exp(dt L) with halved-CFL dt when the flow outruns
        the current step (qg2layersw_raytrace.m:154-165). The march
        margin is re-sized from the RUNNING max speed at the same time
        (not the setup-time 3x headroom guess), never shrinking below a
        width an earlier overflow forced."""
        from .models.coupled import build_march_spec
        from .models.qg2 import build_operators, max_speed2

        sn = state["s"]
        U0 = float(jax.jit(lambda q: max_speed2(
            q, sn.grid, sn.ops, sn.params))(carry.flow_state.qk))
        cfl_dt = cfg.CFL_fraction * sn.grid.dx / max(U0, 1e-12)
        if cfl_dt < sn.dt or sn.dt < cfl_dt / 4.0:
            # shrink freely on violation; GROW at most 4x per recheck (a
            # strongly-decayed flow would otherwise jump dt so far the
            # packet substeps lose accuracy and the march margin blows
            # past the grid)
            new_dt = min(0.5 * cfl_dt, 4.0 * sn.dt)
            log(f"CFL recheck: max|u|={U0:.4f}, dt {sn.dt:.5f} -> "
                f"{new_dt:.5f}; rebuilding operators")
            ops = build_operators(sn.grid, sn.params, new_dt)
            march = build_march_spec(cfg, sn.grid, new_dt, U0)
            if march is not None and sn.march is not None:
                march = march._replace(
                    margin=max(march.margin, sn.march.margin))
            state["s"] = sn._replace(ops=ops, dt=new_dt, U0=U0,
                                     Fr=U0 / cfg.Cg, march=march)
            return make_run(state["s"])
        return run

    remargin = _make_remargin(state, lambda: make_run(state["s"]), log)

    run = make_run(s)
    prev_fields_fn = lambda st: top_layer_flow(
        st.qk, s.grid, s.ops, s.params, cfg.one_layer_quirk,
        n_fields=march_n_fields(s.march)).fields
    fields_of_state = lambda st: sp.to_grid(st.qk, s.grid)  # (2, nx, ny)
    log(f"qg2layersw_raytrace: nx={nx} Np={Npackets} dt={s.dt:.5f} "
        f"Fr={s.Fr:.4f} n_steps={s.n_steps}")
    return _run_coupled(s, carry0, cfg, run, out_dir, fields_of_state,
                        max_steps, checkpoint_every, resume, log,
                        cfg.f / cfg.Cg, cfl_recheck=cfl_recheck,
                        remargin=remargin, prev_fields_fn=prev_fields_fn,
                        max_margin_retries=max_margin_retries, hist=hist,
                        snapshot_every=snapshot_every,
                        monitor_every=monitor_every)


# SLURM sweep table equivalent (/root/reference/parameters.txt:1-21):
# (near_inertial_factor w0, U_g), f=3, Cg=1 fixed.
DEFAULT_SWEEP = [(w0, ug) for w0 in (2.0, 4.0, 8.0, 16.0)
                 for ug in (0.2, 0.4, 0.6, 0.8, 1.0)]


def run_sweep(sweep=None, base_dir="sweep", driver=qgsw_raytrace,
              ensemble=False, **common_kwargs):
    """Execute a (w0, U_g) parameter sweep — the reference's 20-task
    SLURM array (runqgsw_raytrace.sbatch:10,17-20) in one process, one
    run directory per config.

    ensemble=False: successive driver() calls (each its own jit).
    ensemble=True: the one-program replacement — ALL members advance in
    ONE vmapped jitted program (parallel/ensemble.py, fused march
    engaged, members freezing at their own T), with per-member on-device
    omega histograms as the science output. Extra kwargs are
    CoupledConfig overrides plus the knobs of _run_sweep_ensemble.
    """
    if ensemble:
        return _run_sweep_ensemble(sweep or DEFAULT_SWEEP, base_dir,
                                   **common_kwargs)
    results = []
    for i, (w0, ug) in enumerate(sweep or DEFAULT_SWEEP):
        out = f"{base_dir}/run-{i}"
        carry, rd = driver(near_inertial_factor=w0, U_g=ug, out_dir=out,
                           **common_kwargs)
        results.append((out, w0, ug))
    return results


def _run_sweep_ensemble(sweep, base_dir, *, nx=256, Npackets=2**14,
                        T_Fr_days=6000.0, packet_delay_days=1000.0,
                        f=3.0, Cg=1.0, omega_hist_bins=300,
                        omega_hist_log=False, omega_hist_max_factor=2.0,
                        T_member=None, max_steps=None,
                        checkpoint_every=0, resume=False, mesh=None,
                        verbose=True, max_margin_retries=2,
                        member_ids=None, pv_every=0, init_from=None,
                        **cfg_overrides):
    """One-mesh-program sweep (SURVEY §2.7 build target): every (w0,
    U_g) member advances in a single vmapped jitted chunk; each member
    writes its own reference-layout run directory with per-save
    omega-histogram frames (the science statistic), a run.log, and a
    final packet snapshot.

    T_member: optional (w0, ug) -> simulation-time horizon per member,
    overriding the setup-derived T (the committed reference logs run
    T=2000 flat — their T predates the /Fr^2 line). Members freeze
    bit-identically once their own T is reached; histogram frames stop
    being written for frozen members.

    mesh: optional (ensemble, packets) jax Mesh; each device runs its
    own members on its own packets (run_ensemble_chunk); None =
    single-device.

    member_ids: run-directory indices for the members (default 0..E-1).
    Lets a sweep be split into several sequential programs writing into
    one base_dir with parameters.txt-consistent numbering (members with
    very different horizons would otherwise ride along frozen in one
    program, wasting device time).

    omega_hist_log / omega_hist_max_factor: per-member histogram scale
    is omega_max_factor * w0 * f. With log bins the range is
    [f, omega_max_factor*w0*f] geomspaced — use a generous factor
    (e.g. 64) so the high-omega scattering wing is never truncated
    (round-4 verdict weak #1: the 2*w0*f linear cap cut 2.8-3.1% of the
    U_g=1.0 members' counts).

    pv_every: write each member's PV grid as a pv/pv_time frame every
    this many chunks (0 = final only). The reference writes PV every
    steps_per_save steps (qgsw_raytrace.m:165-172); here a chunk IS a
    steps_per_save interval, and the fetch is E*nx^2 floats per save —
    keep it coarse (or 0) when the host transfer matters.

    init_from: path to an ensemble checkpoint .npz whose member axis
    matches this sweep, used to SEED the initial carry (members continue
    from their checkpointed t toward their — possibly extended — T).
    Unlike resume=True this writes a fresh frame series from frame 1,
    which is what a re-binned continuation wants (the round-5 strong-
    flow extension to T=2000 resumes run H's t=500 state with log-binned
    histograms into a new base_dir).
    """
    import jax.numpy as jnp

    from .models.coupled import CoupledConfig
    from .parallel.ensemble import setup_ensemble, run_ensemble_chunk
    from .analysis.device_diag import OmegaHistSpec, omega_hist_counts

    log = print if verbose else (lambda *_: None)
    sweep = list(sweep)
    cfgs = [CoupledConfig(nx=nx, n_packets=Npackets,
                          near_inertial_factor=w0, U_g=ug,
                          T_Fr_days=T_Fr_days,
                          packet_delay_days=packet_delay_days, f=f, Cg=Cg,
                          **cfg_overrides)
            for (w0, ug) in sweep]
    s, es, carry_b = setup_ensemble(cfgs)
    E = len(cfgs)
    if T_member is not None:
        Ts = np.asarray([float(T_member(w0, ug)) for (w0, ug) in sweep])
        es = es.replace(T=jax.device_put(Ts))
    cfg0 = cfgs[0]
    saves_per_pv = max(1, cfg0.steps_per_save
                       // cfg0.packet_steps_per_save)
    steps_per_chunk = saves_per_pv * cfg0.packet_steps_per_save

    if init_from is not None:
        carry_b = restore_state(init_from, carry_b, to_device=True)
        log(f"seeded initial carry from {init_from}")

    dts = np.asarray(fetch(es.dt), np.float64)
    Ts = np.asarray(fetch(es.T), np.float64)
    U0s = np.asarray(fetch(es.U0), np.float64)
    t0s = np.asarray(fetch(carry_b.flow_state.t), np.float64)
    # chunk budget covers the REMAINING time of the slowest member
    # (t0 > 0 only when init_from seeds a continuation)
    n_steps_i = np.ceil(np.maximum(Ts - t0s, 0.0) / dts).astype(np.int64)
    n_steps = int(n_steps_i.max()) if max_steps is None else \
        min(int(n_steps_i.max()), max_steps)
    n_chunks = max(1, int(np.ceil(n_steps / steps_per_chunk)))

    # per-member omega scale: omega_max_factor * w0 * f (the committed
    # linear default 2*w0*f truncated strong-flow tails; log bins with a
    # generous factor are the fix — see the docstring)
    wmax = np.asarray([omega_hist_max_factor * w0 * f
                       for (w0, ug) in sweep])
    spec = OmegaHistSpec(n_bins=int(omega_hist_bins), omega_max=1.0,
                         f=f, Cg=Cg,
                         omega_min=f if omega_hist_log else 0.0,
                         log_bins=bool(omega_hist_log))
    wmax_dev = jax.device_put(wmax)

    def diag(c, i):
        return omega_hist_counts(c.packet_k, spec,
                                 omega_max=wmax_dev[i])

    if member_ids is None:
        member_ids = list(range(E))
    assert len(member_ids) == E

    # per-member run directories (the SLURM array's run-<task> layout)
    rds = []
    for i, (w0, ug) in enumerate(sweep):
        rd = RunDir(f"{base_dir}/run-{member_ids[i]}")
        rd.write_params(
            nx=nx, n_packets=Npackets, near_inertial_factor=w0, f=f,
            Cg=Cg, U_g=ug, U0=float(U0s[i]), Fr=float(U0s[i] / Cg),
            dt=float(dts[i]), T=float(Ts[i]),
            n_steps=int(min(n_steps_i[i], n_steps)),
            steps_per_save=cfg0.steps_per_save,
            packet_steps_per_save=cfg0.packet_steps_per_save,
            stepper=cfg0.stepper, n_substeps=cfg0.n_substeps, L=cfg0.L,
            omega_hist_bins=spec.n_bins, omega_hist_max=float(wmax[i]),
            omega_hist_log=bool(spec.log_bins),
            omega_hist_min=float(spec.omega_min),
            t_seed=float(t0s[i]) if init_from else 0.0,
            sweep_member=member_ids[i])
        rd.write_run_log(
            nx=nx, n_packets=Npackets, k_radius=w0 * f, dt=float(dts[i]),
            T=float(Ts[i]), spin_up=float(packet_delay_days / f),
            steps_per_save=cfg0.steps_per_save,
            packet_steps_per_save=cfg0.packet_steps_per_save, f=f, Cg=Cg,
            U_g=ug, U0=float(U0s[i]), Fr=float(U0s[i] / Cg),
            Kd2=f / Cg)
        rds.append(rd)
    rd_base = RunDir(base_dir)
    rd_base.write_params(sweep=[list(map(float, p)) for p in sweep],
                         nx=nx, n_packets=Npackets, n_chunks=n_chunks,
                         steps_per_chunk=steps_per_chunk)

    state = {"s": s}

    def make_run():
        return jax.jit(functools.partial(
            run_ensemble_chunk, s=state["s"], cfg=cfg0,
            n_saves=saves_per_pv, diag_fn=diag, mesh=mesh))

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        pack = NamedSharding(mesh, P("ensemble", None, "packets"))
        memb = NamedSharding(mesh, P("ensemble"))
        carry_b = carry_b.replace(
            packet_x=jax.device_put(carry_b.packet_x, pack),
            packet_k=jax.device_put(carry_b.packet_k, pack),
            prev_fields=jax.device_put(carry_b.prev_fields, memb))
        es = jax.tree.map(lambda a: jax.device_put(a, memb), es)

    run = make_run()
    chunk0 = 0
    ck = latest_checkpoint(base_dir, prefix=f"ckpt-g{member_ids[0]}") \
        if resume else None
    if ck is not None:
        carry_b = restore_state(ck, carry_b, to_device=True)
        chunk0 = int(ck.split("_")[-1].split(".")[0])
        log(f"resumed sweep from {ck} at chunk {chunk0}")

    pv_fn = jax.jit(jax.vmap(lambda st: sp.to_grid(st.qk, s.grid)))

    # initial histogram (and PV, when a series is kept) frame per member
    hist0 = fetch(jax.jit(jax.vmap(diag))(
        carry_b, jnp.arange(E)))
    if chunk0 == 0:
        q0_b = fetch(pv_fn(carry_b.flow_state)) if pv_every else None
        for i, rd in enumerate(rds):
            binio.write_field(np.ascontiguousarray(hist0[i]),
                              rd.file("omega_hist"), 1)
            binio.write_field(np.asarray(t0s[i]),
                              rd.file("packet_time"), 1)
            if pv_every:
                binio.write_field(np.ascontiguousarray(q0_b[i]),
                                  rd.file("pv"), 1)
                binio.write_field(np.asarray(t0s[i]),
                                  rd.file("pv_time"), 1)

    frame_i = np.full(E, chunk0 * saves_per_pv + 1, np.int64)
    pv_frame_i = np.ones(E, np.int64)
    last_t = np.full(E, -1.0)
    last_pv_t = np.full(E, -1.0)
    if chunk0:
        # Resume: continue each member's frame series from its FILE, not
        # from the chunk arithmetic — members frozen before the
        # checkpoint have shorter series (frames stop when t stalls),
        # and live members' re-run chunks must skip the frames already
        # written (identical, deterministic) instead of leaving gaps.
        for i, rd in enumerate(rds):
            tpath = rd.file("packet_time")
            n_i = binio.frame_count(tpath, 1)
            if n_i:
                ts_i = binio.read_field(tpath)
                frame_i[i] = n_i
                last_t[i] = float(ts_i[-1])
            if pv_every:
                n_pv = binio.frame_count(rd.file("pv_time"), 1)
                if n_pv:
                    pv_frame_i[i] = n_pv
                    last_pv_t[i] = float(
                        binio.read_field(rd.file("pv_time"))[-1])
    t_start = time.time()
    margin_retries = 0
    writer = AsyncWriter()
    chunk = chunk0
    # Blow-up check fetches an (E,) bool, not the full (E, nx, nky)
    # spectra; the fetch also ends the chunk's timing window.
    finite_b = jax.jit(jax.vmap(
        lambda qk: jax.numpy.isfinite(qk).all()))
    try:
      while chunk < n_chunks:
        chunk_start = carry_b
        tc = time.time()
        carry_b, (hb, tsb) = run(carry_b, es)
        ok_b = np.asarray(fetch(finite_b(carry_b.flow_state.qk)))
        elapsed = time.time() - tc
        if not ok_b.all():
            bad = [i for i in range(E) if not ok_b[i]]
            log(f"BLOW UP in members {bad} at chunk {chunk}; stopping")
            rd_base.log_metrics(chunk=chunk, blow_up=True, members=bad)
            break
        if getattr(carry_b, "overflow", None) is not None:
            ov = int(np.max(fetch(carry_b.overflow)))
            if ov > 0:
                rd_base.log_metrics(chunk=chunk, march_overflow=ov,
                                    chunk_discarded=True)
                if margin_retries < max_margin_retries:
                    margin_retries += 1
                    from .ops.pallas_window import max_margin
                    sn = state["s"]
                    cap = max_margin(min(sn.grid.nx, sn.grid.ny))
                    new_m = min(sn.march.margin + ov + 1, cap)
                    log(f"sweep march margin {sn.march.margin} -> "
                        f"{new_m}; re-running chunk {chunk}")
                    state["s"] = sn._replace(
                        march=sn.march._replace(margin=new_m))
                    run = make_run()
                    carry_b = chunk_start
                    continue
                log(f"HALT: sweep margin overflow {ov} at chunk {chunk}")
                carry_b = chunk_start
                break
            carry_b = carry_b.replace(overflow=jnp.zeros(
                (E,), jnp.int32) if carry_b.overflow.ndim else
                jnp.zeros((), jnp.int32))
        hb_np, ts_np = fetch((hb, tsb))
        for i, rd in enumerate(rds):
            for j in range(hb_np.shape[1]):
                # frozen members stop producing frames (t stalls)
                if ts_np[i, j] <= last_t[i]:
                    continue
                last_t[i] = ts_np[i, j]
                frame_i[i] += 1
                writer.submit(binio.write_field,
                              np.ascontiguousarray(hb_np[i, j]),
                              rd.file("omega_hist"), int(frame_i[i]))
                writer.submit(binio.write_field, ts_np[i, j],
                              rd.file("packet_time"), int(frame_i[i]))
        if pv_every and (chunk + 1) % pv_every == 0:
            q_b = fetch(pv_fn(carry_b.flow_state))
            for i, rd in enumerate(rds):
                if ts_np[i, -1] <= last_pv_t[i]:
                    continue  # frozen member: PV is static
                last_pv_t[i] = ts_np[i, -1]
                pv_frame_i[i] += 1
                writer.submit(binio.write_field,
                              np.ascontiguousarray(q_b[i]),
                              rd.file("pv"), int(pv_frame_i[i]))
                writer.submit(binio.write_field, float(ts_np[i, -1]),
                              rd.file("pv_time"), int(pv_frame_i[i]))
        rd_base.log_metrics(
            chunk=chunk, steps=steps_per_chunk, wall_s=elapsed,
            members_live=int((ts_np[:, -1] < Ts).sum()),
            member_steps_per_sec=steps_per_chunk * E / elapsed,
            packet_steps_per_sec=(steps_per_chunk * E * Npackets
                                  / elapsed))
        if checkpoint_every and (chunk + 1) % checkpoint_every == 0:
            writer.flush()
            save_state(RunDir(base_dir).path / f"ckpt-g{member_ids[0]}",
                       carry_b.replace(prev_win=None, overflow=None),
                       step=chunk + 1)
        if chunk % 10 == 0:
            log(f"{100.0 * (chunk + 1) / n_chunks:6.2f}%  "
                f"t_max={ts_np[:, -1].max():.2f} "
                f"live={int((ts_np[:, -1] < Ts).sum())}/{E} "
                f"({steps_per_chunk / elapsed:.1f} ens-steps/s)")
        chunk += 1
        margin_retries = 0
    finally:
        writer.close()

    # final per-member packet snapshot + PV (reference record layouts)
    px_np = fetch(carry_b.packet_x)
    pk_np = fetch(carry_b.packet_k)
    q_np = fetch(jax.jit(jax.vmap(
        lambda st: sp.to_grid(st.qk, s.grid)))(carry_b.flow_state))
    for i, rd in enumerate(rds):
        binio.write_field(s.grid.wrap_centered(px_np[i].T),
                          rd.file("packet_snap_x"), 1)
        binio.write_field(pk_np[i].T, rd.file("packet_snap_k"), 1)
        binio.write_field(np.asarray(last_t[i]),
                          rd.file("packet_snap_time"), 1)
        # final PV: appends to the in-run series when one is kept
        # (pv_every > 0), else the single final frame as before
        fin = int(pv_frame_i[i]) + 1 if (
            pv_every and last_t[i] > last_pv_t[i]) else int(pv_frame_i[i])
        binio.write_field(q_np[i], rd.file("pv"), fin)
        binio.write_field(np.asarray(last_t[i]), rd.file("pv_time"), fin)
        rd.finish_run_log()
    log(f"sweep done: {time.time() - t_start:.1f} s wall for {E} members")
    return carry_b, rds
