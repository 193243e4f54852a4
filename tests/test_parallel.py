"""Sharding + ensemble tests on the virtual 8-device CPU mesh:
N-shard result == 1-shard result (SURVEY.md section 8 requirement), and
the vmapped sweep matches per-config sequential runs."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from swraytracing.models.coupled import (CoupledConfig, setup_coupled,
                                             run_coupled_chunk)
from swraytracing.parallel import sharding as shd
from swraytracing.parallel.ensemble import (setup_ensemble,
                                                run_ensemble_chunk,
                                                sweep_configs)


def test_packet_sharding_matches_single_device():
    """Same physics on 8 packet shards as on one device (bitwise-ish)."""
    cfg = CoupledConfig(nx=32, n_packets=64, T_Fr_days=10.0,
                        packet_delay_days=0.1)
    s, carry = setup_coupled(cfg)
    run = jax.jit(functools.partial(run_coupled_chunk, s=s, cfg=cfg,
                                    n_saves=4))
    # single device
    c1, (px1, pk1, _) = run(carry)

    # sharded over all 8 devices' packet axis
    mesh = shd.make_mesh(ensemble=1)
    carry_sh = carry.replace(
        packet_x=jax.device_put(carry.packet_x, shd.packet_sharding(mesh)),
        packet_k=jax.device_put(carry.packet_k, shd.packet_sharding(mesh)),
        prev_fields=jax.device_put(carry.prev_fields, shd.replicated(mesh)))
    c8, (px8, pk8, _) = run(carry_sh)

    np.testing.assert_allclose(np.asarray(px8), np.asarray(px1),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pk8), np.asarray(pk1),
                               rtol=1e-12, atol=1e-12)


def test_sharded_gradient_matches_single_device():
    """Flow-spectrum gradient psum across packet shards == single-device
    gradient (the backward all-reduce path)."""
    cfg = CoupledConfig(nx=32, n_packets=32, T_Fr_days=5.0,
                        packet_delay_days=0.05)
    s, carry = setup_coupled(cfg)

    def loss(qk0, c):
        c = c.replace(flow_state=c.flow_state.replace(qk=qk0))
        c, (px, pk, ts) = run_coupled_chunk(c, s, cfg, 2)
        return jnp.mean(jnp.sum(pk[-1] ** 2, -1))

    g1 = jax.jit(jax.grad(loss))(carry.flow_state.qk, carry)

    mesh = shd.make_mesh(ensemble=1)
    carry_sh = carry.replace(
        packet_x=jax.device_put(carry.packet_x, shd.packet_sharding(mesh)),
        packet_k=jax.device_put(carry.packet_k, shd.packet_sharding(mesh)))
    qk_sh = jax.device_put(carry.flow_state.qk, shd.replicated(mesh))
    g8 = jax.jit(jax.grad(loss))(qk_sh, carry_sh)
    np.testing.assert_allclose(np.asarray(g8), np.asarray(g1), rtol=1e-10)


def test_ensemble_matches_sequential():
    """Vmapped (w0, U_g) sweep == per-config sequential runs."""
    base = CoupledConfig(nx=32, n_packets=8, T_Fr_days=10.0,
                         packet_delay_days=0.1)
    cfgs = sweep_configs(base, w0s=(2.0, 4.0), ugs=(0.3, 0.6))
    s0, es, carry_b = setup_ensemble(cfgs)
    assert s0.march is None  # 8 packets < window_min_np: stencil path
    carry_b2, (pxb, pkb, tsb) = jax.jit(functools.partial(
        run_ensemble_chunk, s=s0, cfg=base, n_saves=3))(carry_b, es)

    for i, cfg in enumerate(cfgs):
        s, carry = setup_coupled(cfg)
        c, (px, pk, ts) = run_coupled_chunk(carry, s, cfg, 3)
        np.testing.assert_allclose(np.asarray(pxb[i]), np.asarray(px),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(np.asarray(pkb[i]), np.asarray(pk),
                                   rtol=1e-12, atol=1e-12)


def test_ensemble_fused_march_matches_sequential():
    """The fused march ENGAGED under vmap (unified ensemble-max margin)
    must reproduce each member's solo run: margin sizes the gathered
    window, not the stencil arithmetic, so a wider shared margin changes
    nothing while no packet overflows (VERDICT r3 #3). Tolerance is
    ~1 ulp: XLA compiles the vmapped program with different fusion/FMA
    choices than the solo one."""
    base = CoupledConfig(nx=32, n_packets=64, T_Fr_days=10.0,
                         packet_delay_days=0.05, window_min_np=1)
    cfgs = sweep_configs(base, w0s=(2.0, 8.0), ugs=(0.3, 0.9))
    s0, es, carry_b = setup_ensemble(cfgs)
    assert s0.march is not None
    assert s0.march.margin == max(
        setup_coupled(c)[0].march.margin for c in cfgs)
    carry_b2, (pxb, pkb, tsb) = jax.jit(functools.partial(
        run_ensemble_chunk, s=s0, cfg=base, n_saves=3))(carry_b, es)
    assert int(np.max(np.asarray(carry_b2.overflow))) == 0

    for i, cfg in enumerate(cfgs):
        s, carry = setup_coupled(cfg)
        c, (px, pk, ts) = run_coupled_chunk(carry, s, cfg, 3)
        np.testing.assert_allclose(np.asarray(pxb[i]), np.asarray(px),
                                   rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(np.asarray(pkb[i]), np.asarray(pk),
                                   rtol=1e-14, atol=1e-14)

    # per-member on-device diagnostics ride the same vmap: per-member
    # omega scales via the member-index argument
    from swraytracing.analysis.device_diag import (OmegaHistSpec,
                                                       omega_hist_counts)
    wmax = jnp.asarray([2.0 * c.near_inertial_factor * c.f for c in cfgs])
    spec = OmegaHistSpec(n_bins=32, omega_max=1.0, f=base.f, Cg=base.Cg)

    def diag(c, i):
        return omega_hist_counts(c.packet_k, spec, omega_max=wmax[i])

    carry_b3, (hb, tsb2) = jax.jit(functools.partial(
        run_ensemble_chunk, s=s0, cfg=base, n_saves=2,
        diag_fn=diag))(carry_b, es)
    hb = np.asarray(hb)
    assert hb.shape == (4, 2, 33) and (hb.sum(axis=-1) == 64).all()


def test_ensemble_freezes_past_T():
    """A member whose T is tiny must freeze bit-identically (packets,
    time, AND the PV spectrum — a dt=0 step that still applied the
    spectral filter would keep decaying high modes) while others run."""
    base = CoupledConfig(nx=32, n_packets=4, T_Fr_days=10.0,
                         packet_delay_days=0.01)
    cfgs = [base, base._replace(T_Fr_days=10.0)]
    s0, es, carry_b = setup_ensemble(cfgs)
    es = es.replace(T=jnp.asarray([0.0, es.T[1]]))  # member 0: already done
    carry_b2, (pxb, pkb, tsb) = run_ensemble_chunk(carry_b, es, s0, base, 2)
    # member 0 frozen: packets, time, and the whole flow state bit-identical
    np.testing.assert_allclose(np.asarray(pxb[0][-1]),
                               np.asarray(carry_b.packet_x[0]), atol=1e-14)
    assert float(tsb[0][-1]) == 0.0
    np.testing.assert_array_equal(np.asarray(carry_b2.flow_state.qk[0]),
                                  np.asarray(carry_b.flow_state.qk[0]))
    np.testing.assert_array_equal(np.asarray(carry_b2.flow_state.step[0]),
                                  np.asarray(carry_b.flow_state.step[0]))
    # member 1 advanced
    assert float(tsb[1][-1]) > 0.0
    assert not np.array_equal(np.asarray(carry_b2.flow_state.qk[1]),
                              np.asarray(carry_b.flow_state.qk[1]))


def test_remat_gradient_matches_plain():
    """run_coupled_chunk(remat=True) must give identical gradients to the
    plain path (jax.checkpoint changes memory, not math)."""
    import jax.numpy as jnp

    cfg = CoupledConfig(nx=32, n_packets=16, T_Fr_days=5.0,
                        packet_delay_days=0.05)
    s, carry = setup_coupled(cfg)

    def loss(qk, remat):
        c = carry.replace(flow_state=carry.flow_state.replace(qk=qk))
        c2, _ = run_coupled_chunk(c, s, cfg, 2, remat=remat)
        return jnp.mean(jnp.abs(c2.packet_k) ** 2)

    qk0 = carry.flow_state.qk
    g_plain = jax.grad(lambda q: loss(q, False))(qk0)
    g_remat = jax.grad(lambda q: loss(q, True))(qk0)
    np.testing.assert_allclose(np.asarray(g_remat), np.asarray(g_plain),
                               rtol=1e-10, atol=1e-12)


def test_multihost_helpers_roundtrip():
    """global_packet_array / host_local_slice on the virtual mesh (single
    process): global assembly + addressable-shard concatenation must
    round-trip the coordinate-first (2, Np) packet block."""
    from swraytracing.parallel import multihost as mh

    mesh = shd.make_mesh(jax.devices())
    x = np.arange(2 * 64, dtype=np.float32).reshape(2, 64)
    g = mh.global_packet_array(x, mesh)
    assert g.shape == (2, 64)
    back = mh.host_local_slice(g)
    np.testing.assert_array_equal(back, x)


def test_windowed_coupled_matches_and_shards():
    """The windowed interpolation path (engaged at window_min_np
    packets) gives the same coupled trajectory as the stencil path, on
    one device and sharded over 8 packet shards."""
    # fused_march off: this test targets the WINDOWED INTERP path (the
    # below-march fallback); the fused march has its own equivalence
    # tests in test_pallas_window.py.
    cfg = CoupledConfig(nx=32, n_packets=64, T_Fr_days=10.0,
                        packet_delay_days=0.1, fused_march=False)
    s, carry = setup_coupled(cfg)
    run = jax.jit(functools.partial(run_coupled_chunk, s=s, cfg=cfg,
                                    n_saves=3))
    c1, (px1, pk1, _) = run(carry)

    # engage the windowed path for this tiny packet count via the config
    cfg_w = cfg._replace(window_min_np=1)
    run_w = jax.jit(functools.partial(run_coupled_chunk, s=s, cfg=cfg_w,
                                      n_saves=3))
    cw, (pxw, pkw, _) = run_w(carry)
    np.testing.assert_allclose(np.asarray(pxw), np.asarray(px1),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pkw), np.asarray(pk1),
                               rtol=1e-12, atol=1e-12)

    mesh = shd.make_mesh(ensemble=1)
    carry_sh = carry.replace(
        packet_x=jax.device_put(carry.packet_x, shd.packet_sharding(mesh)),
        packet_k=jax.device_put(carry.packet_k, shd.packet_sharding(mesh)),
        prev_fields=jax.device_put(carry.prev_fields, shd.replicated(mesh)))
    c8, (px8, pk8, _) = run_w(carry_sh)
    np.testing.assert_allclose(np.asarray(px8), np.asarray(px1),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pk8), np.asarray(pk1),
                               rtol=1e-12, atol=1e-12)


def test_scaling_harness_runs():
    """measure_packet_scaling runs on the virtual mesh and reports sane
    monotone packet counts and positive rates (CPU efficiency numbers are
    not asserted — the harness is exercised, the physics shards)."""
    from swraytracing.parallel.scaling import measure_packet_scaling

    cfg0 = CoupledConfig(nx=32, T_Fr_days=10.0, packet_delay_days=0.1)

    def setup_fn(np_):
        return setup_coupled(cfg0._replace(n_packets=np_))

    def run_fn(s):
        return jax.jit(functools.partial(
            run_coupled_chunk, s=s, cfg=cfg0, n_saves=1))

    pts = measure_packet_scaling(setup_fn, run_fn, base_packets=64,
                                 device_counts=(1, 2, 8), iters=1)
    assert [p.n_devices for p in pts] == [1, 2, 8]
    assert [p.packets for p in pts] == [64, 128, 512]
    assert all(p.packet_steps_per_sec > 0 for p in pts)
    assert abs(pts[0].efficiency - 1.0) < 1e-9


def _production_march_cfg(**kw):
    """The shipping bench.py path: fused march + uv windows + combined
    gather, engaged via the config (no module-global monkeypatching)."""
    base = dict(nx=32, n_packets=64, T_Fr_days=10.0, packet_delay_days=0.1,
                fused_march=True, march_uv_windows=True,
                march_combined_gather=True, window_min_np=1)
    base.update(kw)
    return CoupledConfig(**base)


def test_fused_march_sharding_matches_single_device():
    """N-shard == 1-shard for the PRODUCTION fused-march path (uv
    windows + combined gather — exactly what bench.py runs), on the
    8-device packet mesh (VERDICT r2 item 2)."""
    cfg = _production_march_cfg()
    s, carry = setup_coupled(cfg)
    assert s.march is not None and s.march.nf == 2 \
        and s.march.combined_gather
    run = jax.jit(functools.partial(run_coupled_chunk, s=s, cfg=cfg,
                                    n_saves=4))
    c1, (px1, pk1, _) = run(carry)
    assert int(c1.overflow) == 0

    mesh = shd.make_mesh(ensemble=1)
    carry_sh = carry.replace(
        packet_x=jax.device_put(carry.packet_x, shd.packet_sharding(mesh)),
        packet_k=jax.device_put(carry.packet_k, shd.packet_sharding(mesh)),
        prev_fields=jax.device_put(carry.prev_fields, shd.replicated(mesh)))
    c8, (px8, pk8, _) = run(carry_sh)
    np.testing.assert_allclose(np.asarray(px8), np.asarray(px1),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pk8), np.asarray(pk1),
                               rtol=1e-12, atol=1e-12)


def test_fused_march_sharded_gradient_matches_single_device():
    """Flow-spectrum gradient through the fused march's custom VJP:
    8 packet shards == single device (the production differentiable
    path under GSPMD; VERDICT r2 item 2)."""
    cfg = _production_march_cfg(n_packets=32, T_Fr_days=5.0,
                                packet_delay_days=0.05)
    s, carry = setup_coupled(cfg)
    assert s.march is not None

    def loss(qk0, c):
        c = c.replace(flow_state=c.flow_state.replace(qk=qk0))
        c, (px, pk, ts) = run_coupled_chunk(c, s, cfg, 2)
        return jnp.mean(jnp.sum(pk[-1] ** 2, -1))

    g1 = jax.jit(jax.grad(loss))(carry.flow_state.qk, carry)

    mesh = shd.make_mesh(ensemble=1)
    carry_sh = carry.replace(
        packet_x=jax.device_put(carry.packet_x, shd.packet_sharding(mesh)),
        packet_k=jax.device_put(carry.packet_k, shd.packet_sharding(mesh)))
    qk_sh = jax.device_put(carry.flow_state.qk, shd.replicated(mesh))
    g8 = jax.jit(jax.grad(loss))(qk_sh, carry_sh)
    assert np.isfinite(np.asarray(g8)).all()
    np.testing.assert_allclose(np.asarray(g8), np.asarray(g1), rtol=1e-10)


def test_production_march_collective_census():
    """GSPMD must not insert packet-axis all-gathers into the sharded
    production chunk (forward or flow-gradient): the flow is replicated,
    the march is shard-local, and the backward's only cross-shard
    communication is the flow-gradient psum. Round 1 regressed to 27
    all-gathers once; this pins the optimized-HLO counts so pytest
    catches it (VERDICT r2 item 5)."""
    import re

    cfg = CoupledConfig(nx=32, n_packets=64, T_Fr_days=10.0,
                        packet_delay_days=0.1, window_min_np=1)
    s, carry = setup_coupled(cfg)
    assert s.march is not None and s.march.nf == 2  # shipping path

    mesh = shd.make_mesh(ensemble=1)
    carry = carry.replace(
        packet_x=jax.device_put(carry.packet_x, shd.packet_sharding(mesh)),
        packet_k=jax.device_put(carry.packet_k, shd.packet_sharding(mesh)),
        prev_fields=jax.device_put(carry.prev_fields, shd.replicated(mesh)))

    # count instruction DEFINITIONS only (an operand mention like
    # %all-reduce.5 in another instruction is not a collective); the
    # shape token may be a tuple for variadic/async collectives, e.g.
    # `= (f32[], f32[]) all-reduce(...)` — count -start but not -done
    pat = re.compile(r"= (?:\([^)]*\)|\S+) (all-reduce|all-gather|"
                     r"reduce-scatter|collective-permute|all-to-all)"
                     r"(?:-start)?\(")

    def census(fn, *args):
        txt = jax.jit(fn).lower(*args).compile().as_text()
        counts = {}
        for m in pat.finditer(txt):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        return counts

    fwd = functools.partial(run_coupled_chunk, s=s, cfg=cfg, n_saves=1)
    cf = census(fwd, carry)
    assert cf.get("all-gather", 0) == 0, cf
    assert cf.get("all-to-all", 0) == 0, cf
    assert cf.get("collective-permute", 0) == 0, cf
    assert cf.get("all-reduce", 0) <= 4, cf

    def flow_grad(qk, c):
        c = c.replace(flow_state=c.flow_state.replace(qk=qk))
        c2, _ = run_coupled_chunk(c, s, cfg, 1, remat=True)
        return jnp.sum(c2.packet_k ** 2)

    cg = census(jax.grad(flow_grad), carry.flow_state.qk, carry)
    assert cg.get("all-gather", 0) == 0, cg
    assert cg.get("all-to-all", 0) == 0, cg
    assert cg.get("all-reduce", 0) <= 6, cg


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_sharded_chunk_marches_packets_where_they_are(engine, monkeypatch):
    """Whatever the engine, a chunk whose packets are sharded marches
    each device's packets on that device: the packet state comes back
    sharded, no all-gather appears, and the result matches one device.
    The kernel (run by the Pallas interpreter here) is opaque to the
    partitioner; fused_march's partitioning rule keeps it local without
    the caller setting anything."""
    from swraytracing.ops import pallas_window as pwin

    monkeypatch.setattr(pwin, "march_pallas", functools.partial(
        pwin.march_pallas, interpret=True))
    cfg = _production_march_cfg()
    s, carry = setup_coupled(cfg)
    s = s._replace(march=s.march._replace(engine=engine))
    run = jax.jit(functools.partial(run_coupled_chunk, s=s, cfg=cfg,
                                    n_saves=2))
    c1, _ = run(carry)

    mesh = shd.make_mesh(ensemble=1)
    carry_sh = carry.replace(
        packet_x=jax.device_put(carry.packet_x, shd.packet_sharding(mesh)),
        packet_k=jax.device_put(carry.packet_k, shd.packet_sharding(mesh)),
        prev_fields=jax.device_put(carry.prev_fields, shd.replicated(mesh)))
    comp = run.lower(carry_sh).compile()
    census = shd.collective_census(comp.as_text())
    assert census.get("all-gather", 0) == 0, census
    assert census.get("all-reduce", 0) <= 1, census   # the overflow max
    c8, _ = comp(carry_sh)
    for a in (c8.packet_x, c8.packet_k):
        assert not a.sharding.is_fully_replicated
        assert len({sh.device for sh in a.addressable_shards}) == 8
    np.testing.assert_allclose(np.asarray(c8.packet_x),
                               np.asarray(c1.packet_x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(c8.packet_k),
                               np.asarray(c1.packet_k), rtol=0, atol=1e-12)


def test_census_regex_counts_definitions_only():
    """The census pattern must count collective instruction DEFINITIONS
    — including tuple-shaped variadic/async forms XLA's combiner emits —
    and must NOT count operand mentions or -done halves (the round-3
    review found tuple shapes were invisible and mentions inflated
    counts ~60x)."""
    import re

    pat = re.compile(r"= (?:\([^)]*\)|\S+) (all-reduce|all-gather|"
                     r"reduce-scatter|collective-permute|all-to-all)"
                     r"(?:-start)?\(")
    hlo = "\n".join([
        "  %all-reduce.1 = f64[32,17]{1,0} all-reduce(%x), replica_groups=",
        "  ROOT %ar2 = (f32[], f32[]) all-reduce(%a, %b), to_apply=%sum",
        "  %ag = f32[8,64]{1,0} all-gather-start(%p), dimensions={1}",
        "  %agd = f32[8,64]{1,0} all-gather-done(%ag)",
        "  %use = f64[32,17]{1,0} add(%all-reduce.1, %all-reduce.1)",
        "  %cp = f32[4]{0} collective-permute(%q), source_target_pairs=",
    ])
    counts = {}
    for m in pat.finditer(hlo):
        counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    assert counts == {"all-reduce": 2, "all-gather": 1,
                      "collective-permute": 1}, counts


def test_vmapped_log_hist_matches_numpy():
    """The log-binned per-member histogram (round-5 sweep science grid)
    under vmap with traced per-member omega_max must equal numpy
    histogramming on each member's geomspace edges."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from swraytracing.analysis.device_diag import (OmegaHistSpec,
                                                       omega_hist_counts,
                                                       hist_edges)

    f, Cg = 3.0, 1.0
    rng = np.random.default_rng(0)
    pk = jnp.asarray(rng.standard_normal((3, 2, 256)) * 40.0)
    wmax = jnp.asarray([64.0 * w0 * f for w0 in (2.0, 4.0, 16.0)])
    spec = OmegaHistSpec(n_bins=48, omega_max=1.0, f=f, Cg=Cg,
                         omega_min=f, log_bins=True)
    counts = np.asarray(jax.jit(jax.vmap(
        lambda k, w: omega_hist_counts(k, spec, omega_max=w)))(pk, wmax))
    assert counts.shape == (3, 49)
    for i in range(3):
        om = np.sqrt(f**2 + Cg**2 * np.asarray(
            pk[i, 0]**2 + pk[i, 1]**2))
        edges = np.asarray(hist_edges(spec._replace(
            omega_max=float(wmax[i]))))
        ref = np.histogram(om, np.append(edges, np.inf))[0]
        np.testing.assert_array_equal(counts[i], ref)
