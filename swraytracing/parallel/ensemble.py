"""Vmapped parameter-sweep ensembles: the SLURM job array, on one mesh.

The reference runs its 20-config (w0, U_g) sweep as independent
single-node SLURM tasks (/root/reference/runqgsw_raytrace.sbatch:10,
parameters.txt). Here the sweep is a leading ensemble
axis — each member carries its own PV spectrum, packets, time step and
spin-up delay (all traced), the solver is vmapped over the axis, and the
axis is sharded over devices via the (ensemble, packets) mesh
(parallel/sharding.py). One jitted program advances every config at
once; members whose simulation time T_i is reached freeze (dt -> 0), so
heterogeneous-duration configs coexist in one scan.

Per-member dt is legal because the QG AB3 update takes dt as data and
the exponential filter is dt-independent (qgsw_raytrace.m:222-230).

The fused march ENGAGES under vmap: the MarchSpec is static but margin
is a safety bound, not an accuracy knob — one spec sized for the
ensemble-max drift (max over members of each member's own required
margin) serves every member, and the march's overflow counter still
guards it per member. March arithmetic is
margin-independent while no packet out-drifts its window, so an
ensemble member reproduces its solo run (to ~1 ulp — XLA's
fusion/FMA choices differ under vmap).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp
from ..utils import pytree as struct

from ..models.coupled import (CoupledConfig, CoupledCarry, setup_coupled,
                              lockstep_step, window_threshold,
                              march_n_fields, prepare_carry_windows)
from ..models.qg import qg_step
from ..models.fields import flow_from_qk
from jax import lax

__all__ = ["EnsembleSetup", "setup_ensemble", "run_ensemble_chunk",
           "sweep_configs"]


@struct.dataclass
class EnsembleSetup:
    """Per-member traced parameters (leading axis = ensemble)."""

    dt: jnp.ndarray            # (E,)
    packet_delay: jnp.ndarray  # (E,)
    T: jnp.ndarray             # (E,) total sim time per member
    U0: jnp.ndarray            # (E,) setup-time max flow speed


def sweep_configs(base: CoupledConfig | None = None,
                  w0s=(2.0, 4.0, 8.0, 16.0),
                  ugs=(0.2, 0.4, 0.6, 0.8, 1.0)) -> list:
    """The reference's parameters.txt grid as CoupledConfigs."""
    base = base or CoupledConfig()
    return [base._replace(near_inertial_factor=w0, U_g=ug)
            for w0 in w0s for ug in ugs]


def setup_ensemble(cfgs: Sequence[CoupledConfig]):
    """Build batched carry + per-member parameters from a config list.

    All members must share (nx, L, f, Cg, n_packets, cadences); the
    swept quantities (w0 -> packet ring radius, U_g -> PV amplitude and
    hence dt) vary per member.

    Returns (s, es, carry_b): `s` is a shared CoupledSetup whose march
    spec (if the members' config engages the fused path) has its margin
    widened to the ensemble max, so one static spec covers every
    member's per-step drift bound.
    """
    ref = cfgs[0]
    for c in cfgs:
        assert (c.nx, c.L, c.f, c.Cg, c.n_packets) == \
            (ref.nx, ref.L, ref.f, ref.Cg, ref.n_packets), \
            "ensemble members must share grid/packet shapes"
    setups, carries = zip(*(setup_coupled(c) for c in cfgs))
    marches = [s.march for s in setups]
    if any(m is None for m in marches):
        # engagement is a pure function of the shared config fields
        # (n_packets, stepper, window_min_np), so it is all-or-nothing
        assert all(m is None for m in marches), \
            "march engagement must be uniform across ensemble members"
        march = None
    else:
        march = marches[0]._replace(
            margin=max(m.margin for m in marches))
    s = setups[0]._replace(march=march)
    carry_b = jax.tree.map(lambda *xs: jnp.stack(xs), *carries)
    es = EnsembleSetup(
        dt=jnp.asarray([st.dt for st in setups]),
        packet_delay=jnp.asarray([st.packet_delay for st in setups]),
        T=jnp.asarray([st.T for st in setups]),
        U0=jnp.asarray([st.U0 for st in setups]))
    return s, es, carry_b


def run_ensemble_chunk(carry_b: CoupledCarry, es: EnsembleSetup, s, cfg,
                       n_saves: int, diag_fn=None, mesh=None):
    """Advance every ensemble member n_saves*packet_steps_per_save steps
    (vmapped); members past their own T freeze. `s` is the shared
    CoupledSetup from setup_ensemble (its march spec is the unified
    ensemble one); per-member dt/delay come from `es`. jit with static
    (s, cfg, n_saves, diag_fn, mesh).

    diag_fn: optional (carry, member_index) -> pytree per-save device
    diagnostic emitted in place of the packet arrays (the member index
    lets per-member histogram scales ride the vmap — see
    drivers.run_sweep's ensemble path).

    mesh: optional (ensemble, packets) Mesh (parallel.sharding.make_mesh).
    Each device then runs its own members on its own packets under
    shard_map: members are independent, so no member's flow is computed
    on another device, and packets are independent, so the only
    cross-device reductions are the overflow max and diag_fn's outputs,
    which are SUMMED over the packet shards (right for counts such as
    analysis.device_diag.omega_hist_counts).
    """
    grid, disp, qp0 = s.grid, s.disp, s.qg_params
    march = s.march
    nf = march_n_fields(march)
    thr = window_threshold(cfg)

    def member_step(carry, dt, packet_delay, T):
        # A member past its T must freeze *bit-identically*: dt=0 alone
        # is not enough, because qg_step still applies the spectral
        # filter (qk *= filter decays high modes every step) and rolls
        # the AB history/step counter. Compute the step with dt=0 (so a
        # finished member cannot blow up) and then select the old carry
        # wholesale for frozen members.
        live = carry.flow_state.t < T
        live_dt = jnp.where(live, dt, 0.0)
        qp = qp0._replace(dt=live_dt)
        new = lockstep_step(
            carry,
            flow_step_fn=lambda st: qg_step(st, grid, qp),
            fields_fn=lambda st: flow_from_qk(st.qk, grid, qp.Kd2,
                                              n_fields=nf).fields,
            grid=grid, disp=disp, dt=live_dt, packet_delay=packet_delay,
            n_substeps=cfg.n_substeps, stepper=cfg.stepper, march=march,
            window_min_np=thr)
        out = jax.tree.map(lambda a, b: jnp.where(live, a, b), new, carry)
        if new.prev_win is not None:
            # Skip the freeze-select on the carried window array (tens
            # of MB per member at 256^2): a frozen member's packets do
            # not move (sub_dt=0), so its window CONTENT is never
            # consumed — only the small selected leaves (qk, packets,
            # prev_fields, t, step) define frozen-member outputs.
            out = out.replace(prev_win=new.prev_win)
        return out

    def member_chunk(carry, dt, packet_delay, T, i):
        def one_save(c, _):
            c = lax.fori_loop(
                0, cfg.packet_steps_per_save,
                lambda j, cc: member_step(cc, dt, packet_delay, T), c)
            if diag_fn is not None:
                return c, (diag_fn(c, i), c.flow_state.t)
            return c, (c.packet_x, c.packet_k, c.flow_state.t)

        return lax.scan(one_save, carry, None, length=n_saves)

    carry_b = jax.vmap(
        lambda c: prepare_carry_windows(c, False, march, thr))(carry_b)
    E = carry_b.packet_x.shape[0]
    args = (carry_b, es.dt, es.packet_delay, es.T, jnp.arange(E))
    if mesh is None:
        return jax.vmap(member_chunk)(*args)

    P = jax.sharding.PartitionSpec
    ens, pk = P("ensemble"), P("ensemble", None, "packets")
    n_pk = mesh.shape["packets"]

    def local(*a):
        c, out = jax.vmap(member_chunk)(*a)
        if n_pk > 1:
            if c.overflow is not None:
                c = c.replace(overflow=lax.pmax(c.overflow, "packets"))
            if diag_fn is not None:
                out = (lax.psum(out[0], "packets"), out[1])
        return c, out

    carry_spec = jax.tree.map(lambda _: ens, carry_b).replace(
        packet_x=pk, packet_k=pk)
    out_spec = ((ens, ens) if diag_fn is not None else
                (P("ensemble", None, None, "packets"),
                 P("ensemble", None, None, "packets"), ens))
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(carry_spec, ens, ens, ens, ens),
        out_specs=(carry_spec, out_spec), check_vma=False)(*args)
