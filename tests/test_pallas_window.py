"""Fused packet-march kernel (ops/pallas_window.py): the margin-window
build, the XLA reference march vs the existing per-stage blended path,
the Pallas kernel (interpret mode) vs the reference, gradients, margin
overflow accounting, and the freeze (sub_dt=0) contract."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from swraytracing.ops.grid import SpectralGrid
from swraytracing.ops import pallas_window as pw
from swraytracing.models import rays
from swraytracing.models.dispersion import Dispersion
from swraytracing.models.fields import BlendedFlow

NX = 32
L = 2.0 * np.pi
NP = 128  # several kernel programs of pw.BLOCK packets


def _spec(**kw):
    g = SpectralGrid.square(NX, L)
    return SpectralGrid.square(NX, L), pw.MarchSpec(
        nx=g.nx, ny=g.ny, dx=g.dx, dy=g.dy, f=3.0, Cg=1.0, **kw)


@pytest.fixture
def interpreted_kernel(monkeypatch):
    """Route the 'pallas' engine through the Pallas interpreter (the
    CPU has no Triton backend)."""
    monkeypatch.setattr(pw, "march_pallas", functools.partial(
        pw.march_pallas, interpret=True))


def _setup(seed=0, n_packets=NP, **kw):
    grid, spec = _spec(**kw)
    rng = np.random.default_rng(seed)
    # smooth random fields so interpolation is well-conditioned
    def smooth():
        f = rng.standard_normal((NX, NX))
        fk = np.fft.rfft2(f)
        kx = np.fft.fftfreq(NX)[:, None]
        ky = np.fft.rfftfreq(NX)[None, :]
        fk *= np.exp(-((kx * NX / 6) ** 2 + (ky * NX / 6) ** 2))
        return np.fft.irfft2(fk, s=(NX, NX))

    F1 = jnp.asarray(np.stack([smooth() for _ in range(6)]))
    F2 = jnp.asarray(np.stack([smooth() for _ in range(6)]))
    x = jnp.asarray(rng.uniform(0, L, (2, n_packets)))
    k = jnp.asarray(rng.normal(0, 3.0, (2, n_packets)))
    return grid, spec, F1, F2, x, k


def _reference_substeps(grid, spec, F1, F2, x, k, sub_dt):
    """The existing per-stage blended path (models/rays + BlendedFlow),
    the arithmetic the fused march must reproduce."""
    disp = Dispersion(f=spec.f, Cg=spec.Cg)
    flow = BlendedFlow(fields1=F1, fields2=F2, grid=grid)
    m = spec.n_substeps
    for i in range(m):
        a0 = i / m
        if spec.stepper == "symplectic":
            x, k = rays.symplectic_step(x, k, sub_dt, disp, flow,
                                        alpha=a0 + 0.5 / m)
        else:
            step = {"rk23": rays.rk23_step, "rk4": rays.rk4_step}[
                spec.stepper]
            x, k = step(x, k, sub_dt, disp, flow, alpha0=a0,
                        dalpha=1.0 / m)
    return x, k


def _march_inputs(spec, F1, F2, x, k):
    W1 = pw.build_margin_windows(F1, spec)
    W2 = pw.build_margin_windows(F2, spec)
    if spec.tiles_transposed:
        W1, W2 = W1.T, W2.T
    oi, oj = pw.packet_cells(x[0], x[1], spec)
    pw1 = pw.gather_packet_windows(W1, oi, oj, spec)
    pw2 = pw.gather_packet_windows(W2, oi, oj, spec)
    xk = jnp.concatenate([x, k], axis=0)
    return pw1, pw2, xk, oi, oj


def test_build_margin_windows_values():
    grid, spec, F1, _, _, _ = _setup()
    W = pw.build_margin_windows(F1, spec)
    assert W.shape == (spec.K, NX * NX)
    lo = spec.order + spec.margin
    rng = np.random.default_rng(3)
    for _ in range(20):
        i, j = rng.integers(0, NX, 2)
        f = rng.integers(0, 6)
        sx, sy = rng.integers(0, spec.SW, 2)
        row = (f * spec.SW + sx) * spec.SW + sy
        expect = F1[f, (i + sx - lo) % NX, (j + sy - lo) % NX]
        np.testing.assert_allclose(W[row, i * NX + j], expect, rtol=0)


@pytest.mark.parametrize("stepper", ["rk23", "rk4", "symplectic"])
def test_march_reference_matches_blended_path(stepper):
    grid, spec, F1, F2, x, k = _setup(stepper=stepper, margin=2)
    sub_dt = 0.2 * grid.dx  # small enough to stay within margin 2
    inputs = _march_inputs(spec, F1, F2, x, k)
    out, ov = pw.march_reference(*inputs, sub_dt, spec)
    assert int(jnp.max(ov)) == 0
    xr, kr = _reference_substeps(grid, spec, F1, F2, x, k, sub_dt)
    np.testing.assert_allclose(np.asarray(out[:2]), np.asarray(xr),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out[2:]), np.asarray(kr),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("margin,n_packets", [(1, NP), (2, 100)],
                         ids=["margin1", "margin2-ragged"])
@pytest.mark.parametrize("stepper", ["rk23", "symplectic"])
def test_pallas_kernel_matches_reference(stepper, margin, n_packets):
    """The kernel (interpret mode) reproduces the XLA march on split
    snapshot windows — at margin 2 (SW=10, padded to 16-wide tiles) and
    at a packet count that leaves the last program partly masked."""
    grid, spec, F1, F2, x, k = _setup(stepper=stepper, margin=margin,
                                      n_packets=n_packets,
                                      tiles_transposed=True)
    sub_dt = 0.1 * grid.dx
    inputs = _march_inputs(spec, F1, F2, x, k)
    ref, ov_ref = pw.march_reference(*inputs, sub_dt, spec)
    out, ov = jax.jit(lambda *a: pw.march_pallas(
        *a, spec, interpret=True))(*inputs, sub_dt)
    assert out.shape == (4, n_packets) and ov.shape == (n_packets,)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(ov), np.asarray(ov_ref))


def test_fused_march_gradients_match_blended_path(interpreted_kernel):
    grid, spec, F1, F2, x, k = _setup(margin=2, engine="pallas",
                                      tiles_transposed=True)
    sub_dt = 0.2 * grid.dx

    def loss_fused(F1_, F2_, x_, k_):
        inputs = _march_inputs(spec, F1_, F2_, x_, k_)
        out, _ = pw.fused_march(*inputs, sub_dt, spec)
        return jnp.sum(out[2:] ** 2) + jnp.sum(jnp.sin(out[:2]))

    def loss_direct(F1_, F2_, x_, k_):
        xr, kr = _reference_substeps(grid, spec, F1_, F2_, x_, k_, sub_dt)
        return jnp.sum(kr ** 2) + jnp.sum(jnp.sin(xr))

    g_fused = jax.grad(loss_fused, argnums=(0, 1, 2, 3))(F1, F2, x, k)
    g_direct = jax.grad(loss_direct, argnums=(0, 1, 2, 3))(F1, F2, x, k)
    for gf, gd, name in zip(g_fused, g_direct, "F1 F2 x k".split()):
        np.testing.assert_allclose(np.asarray(gf), np.asarray(gd),
                                   rtol=1e-9, atol=1e-10, err_msg=name)


def test_overflow_counts_margin_violations():
    grid, spec, F1, F2, x, k = _setup(margin=1)
    # huge substep: packets fly many cells within the flow step
    sub_dt = 5.0 * grid.dx
    inputs = _march_inputs(spec, F1, F2, x, k)
    _, ov = pw.march_reference(*inputs, sub_dt, spec)
    assert int(jnp.max(ov)) > 0


def test_freeze_is_identity():
    grid, spec, F1, F2, x, k = _setup()
    inputs = _march_inputs(spec, F1, F2, x, k)
    out, ov = pw.march_reference(*inputs, 0.0, spec)
    np.testing.assert_array_equal(np.asarray(out[:2]), np.asarray(x))
    np.testing.assert_array_equal(np.asarray(out[2:]), np.asarray(k))
    assert int(jnp.max(ov)) == 0


def test_required_margin():
    assert pw.required_margin(0.1, 1.0, 1.0, 1.0) == 1
    assert pw.required_margin(1.0, 1.0, 1.0, 0.5, headroom=1.0) == 4


def test_coupled_fused_march_matches_per_stage():
    """End-to-end: the coupled one-layer driver with the fused march
    engaged produces the same trajectory as the per-stage blended path
    (the production equivalence VERDICT item 2 asks for). With
    spectral-gradient windows (march_uv_windows=False) the match is
    exact — including through the combined two-snapshot gather; with
    the production uv-window mode (in-kernel interpolant derivative)
    the trajectories agree to the gradient-truncation level. That
    truncation is 5th-order in dx (measured on the QG ring field:
    grad_U rel err 4e-2 at nx=32, 1.6e-3 at 64, 5.5e-5 at 128, 1.3e-7
    at the production 512 — benchmarks/gradinterp_accuracy.py), so at
    this deliberately coarse nx=32 the k-trajectories only agree to
    ~1e-1 after 4 flow steps; u,v (hence positions) are much closer."""
    from swraytracing.models import coupled as cp

    base = cp.CoupledConfig(nx=32, n_packets=512, T_Fr_days=50.0,
                            packet_delay_days=0.0, U_g=0.4, f=3.0, Cg=1.0,
                            packet_steps_per_save=2, window_min_np=256)
    variants = {
        "stage": base._replace(fused_march=False),
        "march": base._replace(march_uv_windows=False),
        "march_uv": base,
    }
    out = {}
    for name, cfg in variants.items():
        s, carry = cp.setup_coupled(cfg)
        if cfg.fused_march:
            assert s.march is not None
            assert s.march.engine == "xla"  # CPU -> XLA march
            assert s.march.combined_gather
            assert s.march.nf == (2 if cfg.march_uv_windows else 6)
        run = jax.jit(lambda c, s=s, cfg=cfg:
                      cp.run_coupled_chunk(c, s, cfg, 2))
        c2, (px, pk, ts) = run(carry)
        out[name] = (np.asarray(px), np.asarray(pk))
        if cfg.fused_march:
            assert int(c2.overflow) == 0
    np.testing.assert_allclose(out["march"][0], out["stage"][0],
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(out["march"][1], out["stage"][1],
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(out["march_uv"][0], out["stage"][0],
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(out["march_uv"][1], out["stage"][1],
                               rtol=0, atol=1.5e-1)


def test_lagrange_dws_matches_autodiff():
    rng = np.random.default_rng(7)
    fr = jnp.asarray(rng.uniform(0, 1, 64))
    got = jnp.stack(pw._lagrange_dws(fr, 2))
    want = jax.vmap(jax.jacfwd(
        lambda f: jnp.stack(pw._lagrange_ws(f, 2))))(fr).T
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("tiles_transposed", [False, True])
def test_combined_gather_matches_split(tiles_transposed):
    """combined_gather is an exact rearrangement: one (2K)-row gather
    over stacked snapshots == two K-row gathers, bit for bit."""
    grid, spec, F1, F2, x, k = _setup(margin=2, stepper="rk23",
                                      tiles_transposed=tiles_transposed)
    sub_dt = 0.2 * grid.dx
    pw1, pw2, xk, oi, oj = _march_inputs(spec, F1, F2, x, k)
    ref, ov_ref = pw.march_reference(pw1, pw2, xk, oi, oj, sub_dt, spec)

    specc = spec._replace(combined_gather=True)
    W1 = pw.build_margin_windows(F1, spec)
    W2 = pw.build_margin_windows(F2, spec)
    Wc = jnp.concatenate([W1, W2], axis=0)
    if spec.tiles_transposed:
        Wc = Wc.T
    pwc = pw.gather_packet_windows(Wc, oi, oj, specc)
    out, ov = pw.march_reference(pwc, jnp.zeros((1, 1)), xk, oi, oj,
                                 sub_dt, specc)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(ov), np.asarray(ov_ref))


@pytest.mark.parametrize("grad_from_interp", [False, True])
def test_pallas_kernel_combined_matches_reference(grad_from_interp):
    """The Pallas kernel (interpret mode) under combined_gather (+ the
    uv-window mode) reproduces the XLA reference exactly, including a
    ragged packet count."""
    n = 77
    grid, spec, F1, F2, x, k = _setup(
        margin=1, stepper="rk23", tiles_transposed=True, n_packets=n)
    spec = spec._replace(combined_gather=True,
                         grad_from_interp=grad_from_interp,
                         nf=2 if grad_from_interp else 6)
    sub_dt = 0.1 * grid.dx
    oi, oj = pw.packet_cells(x[0], x[1], spec)
    W1 = pw.build_margin_windows(F1, spec)
    W2 = pw.build_margin_windows(F2, spec)
    Wc = jnp.concatenate([W1, W2], axis=0).T
    pwc = pw.gather_packet_windows(Wc, oi, oj, spec)
    xk = jnp.concatenate([x, k], axis=0)
    dummy = jnp.zeros((1, 1))
    ref, ov_ref = pw.march_reference(pwc, dummy, xk, oi, oj, sub_dt, spec)
    out, ov = jax.jit(lambda *a: pw.march_pallas(*a, spec, interpret=True))(
        pwc, dummy, xk, oi, oj, sub_dt)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(ov), np.asarray(ov_ref))


def test_grad_from_interp_tracks_spectral_gradient_march():
    """The uv-window march (in-kernel interpolant derivative) matches
    the spectral-gradient march on a strongly band-limited flow, where
    the 5th-order derivative truncation is negligible (modes <= 3 at
    nx=32: k*dx <= 0.6). A wrong weight, scale, or index placement
    would miss by orders of magnitude. Truncation at production
    spectra/resolution: benchmarks/gradinterp_accuracy.py (1.3e-7 rel
    at 512^2)."""
    grid, spec, F1, F2, x, k = _setup(margin=2, stepper="rk23")
    rng = np.random.default_rng(11)

    def lowpass(nmodes=3):
        fk = np.zeros((NX, NX // 2 + 1), complex)
        fk[:nmodes + 1, :nmodes + 1] = (
            rng.standard_normal((nmodes + 1, nmodes + 1))
            + 1j * rng.standard_normal((nmodes + 1, nmodes + 1)))
        fk[-nmodes:, :nmodes + 1] = (
            rng.standard_normal((nmodes, nmodes + 1))
            + 1j * rng.standard_normal((nmodes, nmodes + 1)))
        return np.fft.irfft2(fk, s=(NX, NX))

    def field_stack():
        u, v = lowpass(), lowpass()
        # consistent spectral gradients for the nf=6 reference windows
        def ddx(f, axis):
            fk = np.fft.rfft2(f)
            kx = 2j * np.pi * np.fft.fftfreq(NX, d=grid.dx)[:, None]
            ky = 2j * np.pi * np.fft.rfftfreq(NX, d=grid.dy)[None, :]
            return np.fft.irfft2(fk * (kx if axis == 0 else ky),
                                 s=(NX, NX))
        return jnp.asarray(np.stack(
            [u, v, ddx(u, 0), ddx(u, 1), ddx(v, 0), ddx(v, 1)]))

    F1, F2 = field_stack(), field_stack()
    sub_dt = 0.2 * grid.dx
    inputs = _march_inputs(spec, F1, F2, x, k)
    ref, _ = pw.march_reference(*inputs, sub_dt, spec)

    spec_uv = spec._replace(nf=2, grad_from_interp=True)
    inputs_uv = _march_inputs(spec_uv, F1, F2, x, k)
    out, ov = pw.march_reference(*inputs_uv, sub_dt, spec_uv)
    assert int(jnp.max(ov)) == 0
    scale = float(jnp.max(jnp.abs(ref)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=2e-5 * scale)


def test_fused_march_uv_combined_gradients(interpreted_kernel):
    """custom VJP of the production mode (uv windows + combined
    gather, kernel forward): fused_march's gradient equals direct
    autodiff of the XLA reference — including w.r.t. the combined
    window array."""
    grid, spec, F1, F2, x, k = _setup(margin=2, engine="pallas",
                                      tiles_transposed=True)
    spec = spec._replace(nf=2, grad_from_interp=True,
                         combined_gather=True)
    sub_dt = 0.2 * grid.dx
    oi, oj = pw.packet_cells(x[0], x[1], spec)

    def build(F1_, F2_):
        W1 = pw.build_margin_windows(F1_, spec)
        W2 = pw.build_margin_windows(F2_, spec)
        return pw.gather_packet_windows(
            jnp.concatenate([W1, W2], axis=0).T, oi, oj, spec)

    xk = jnp.concatenate([x, k], axis=0)
    dummy = jnp.zeros((1, 1))

    def loss_fused(F1_, F2_, xk_):
        out, _ = pw.fused_march(build(F1_, F2_), dummy, xk_, oi, oj,
                                sub_dt, spec)
        return jnp.sum(out[2:] ** 2) + jnp.sum(jnp.sin(out[:2]))

    def loss_ref(F1_, F2_, xk_):
        out, _ = pw.march_reference(build(F1_, F2_), dummy, xk_, oi, oj,
                                    sub_dt, spec)
        return jnp.sum(out[2:] ** 2) + jnp.sum(jnp.sin(out[:2]))

    g_fused = jax.grad(loss_fused, argnums=(0, 1, 2))(F1, F2, xk)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(F1, F2, xk)
    for gf, gd, name in zip(g_fused, g_ref, "F1 F2 xk".split()):
        np.testing.assert_allclose(np.asarray(gf), np.asarray(gd),
                                   rtol=1e-9, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("platform,engine",
                         [("gpu", "pallas"), ("cpu", "xla"), ("metal", None)])
def test_march_engine_choice(platform, engine):
    """The Triton-route kernel on GPUs, the XLA march on the CPU, and an
    error — never a silent stand-in — on any other platform."""
    if engine is None:
        with pytest.raises(ValueError, match="no packet-march engine"):
            pw.march_engine(platform)
    else:
        assert pw.march_engine(platform) == engine


def test_build_march_spec_engine(monkeypatch):
    """setup picks the engine of the platform the run is placed on (the
    `jax.default_device` in force, else the default backend)."""
    from swraytracing.models import coupled as cp

    cfg = cp.CoupledConfig(nx=32, n_packets=256, T_Fr_days=5.0,
                           window_min_np=256)
    with jax.default_device(jax.devices("cpu")[0]):
        assert cp.default_platform() == "cpu"
        s, _ = cp.setup_coupled(cfg)
    assert s.march.engine == "xla"
    monkeypatch.setattr(cp, "default_platform", lambda: "gpu")
    s, _ = cp.setup_coupled(cfg)
    assert s.march.engine == "pallas"


@pytest.mark.gpu
def test_march_kernel_on_gpu():
    """The compiled kernel (no interpreter) against the XLA march on a
    GPU, float32, margin 2 with a ragged packet count. Runs where JAX
    sees a GPU (e.g. JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu)."""
    try:
        gpu = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")
    grid, spec, F1, F2, x, k = _setup(margin=2, n_packets=1000,
                                      tiles_transposed=True, nf=2,
                                      grad_from_interp=True,
                                      combined_gather=True)
    f32 = lambda a: jax.device_put(jnp.asarray(a, jnp.float32), gpu)
    F1, F2, x, k = map(f32, (F1[:2], F2[:2], x, k))
    oi, oj = pw.packet_cells(x[0], x[1], spec)
    Wc = jnp.concatenate([pw.build_gather_windows(F1, spec),
                          pw.build_gather_windows(F2, spec)], axis=-1)
    pwc = pw.gather_packet_windows(Wc, oi, oj, spec)
    xk = jnp.concatenate([x, k], axis=0)
    dummy = jnp.zeros((1, 1), jnp.float32)
    sub_dt = 0.1 * grid.dx
    ref, ov_ref = jax.jit(lambda *a: pw.march_reference(*a, sub_dt, spec))(
        pwc, dummy, xk, oi, oj)
    out, ov = jax.jit(lambda *a: pw.march_pallas(*a, sub_dt, spec))(
        pwc, dummy, xk, oi, oj)
    scale = np.abs(np.asarray(ref)).max(axis=1, keepdims=True)
    assert (np.abs(np.asarray(out) - np.asarray(ref))
            <= 32 * np.finfo(np.float32).eps * scale).all()
    np.testing.assert_array_equal(np.asarray(ov), np.asarray(ov_ref))
