"""On-device validation of the uv-window + combined-gather fused march.

Runs the production-mode kernel (grad_from_interp + combined
two-snapshot gather, tiles_transposed) on the GPU at 512^2 / margin-1
window shapes and checks it against the pure-XLA reference march on
the same device; also times the kernel at 1e6 packets. chip_smoke.py
phase 1 runs the same comparison on the production setup.
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))
import time

import jax
import jax.numpy as jnp

from swraytracing.ops import pallas_window as pw

NX = 512
L = float(2 * 3.141592653589793)
NP_CHECK = 8192
NP_TIME = 1_000_000

grid_dx = L / NX
spec = pw.MarchSpec(nx=NX, ny=NX, dx=grid_dx, dy=grid_dx, f=3.0, Cg=1.0,
                    n_substeps=4, stepper="rk23", margin=1,
                    nf=2, grad_from_interp=True, combined_gather=True,
                    tiles_transposed=True)

key = jax.random.PRNGKey(0)
k1, k2, k3, k4 = jax.random.split(key, 4)


@jax.jit
def make_inputs(k1, k2, k3, k4):
    # mirrors the production lockstep path: per-snapshot
    # build_gather_windows ((ncells, K)), then concat on the minor axis
    F1 = jax.random.normal(k1, (2, NX, NX), jnp.float32)
    F2 = jax.random.normal(k2, (2, NX, NX), jnp.float32)
    W1 = pw.build_gather_windows(F1, spec)            # (ncells, K)
    W2 = pw.build_gather_windows(F2, spec)
    Wc = jnp.concatenate([W1, W2], axis=-1)           # (ncells, 2K)
    x = jax.random.uniform(k3, (2, NP_TIME), jnp.float32, 0.0, L)
    kk = jax.random.normal(k4, (2, NP_TIME), jnp.float32) * 3.0
    oi, oj = pw.packet_cells(x[0], x[1], spec)
    pwc = pw.gather_packet_windows(Wc, oi, oj, spec)
    xk = jnp.concatenate([x, kk], axis=0)
    return pwc, xk, oi, oj


pwc, xk, oi, oj = make_inputs(k1, k2, k3, k4)
sub_dt = 0.05 * grid_dx
dummy = jnp.zeros((1, 1), jnp.float32)

n = NP_CHECK
run_pallas_small = jax.jit(lambda p, x, a, b: pw.march_pallas(
    p, dummy, x, a, b, sub_dt, spec))
run_ref_small = jax.jit(lambda p, x, a, b: pw.march_reference(
    p, dummy, x, a, b, sub_dt, spec))

out_p, ov_p = run_pallas_small(pwc[:n], xk[:, :n], oi[:n], oj[:n])
out_r, ov_r = run_ref_small(pwc[:n], xk[:, :n], oi[:n], oj[:n])
diff = float(jax.jit(lambda a, b: jnp.max(jnp.abs(a - b)))(out_p, out_r))
ovd = int(jax.jit(lambda a, b: jnp.max(jnp.abs(a - b)))(ov_p, ov_r))
scale = float(jax.jit(lambda a: jnp.max(jnp.abs(a)))(out_r))
print(f"pallas-vs-reference on chip ({n} pk): max|diff| = {diff:.3e} "
      f"(scale {scale:.2f}), overflow diff {ovd}", flush=True)
assert diff < 1e-4 * scale and ovd == 0

run_pallas = jax.jit(lambda p, x, a, b: pw.march_pallas(
    p, dummy, x, a, b, sub_dt, spec))


def timeit(name, fn, *a, rep=5):
    jax.block_until_ready(fn(*a))
    t0 = time.perf_counter()
    for _ in range(rep):
        jax.block_until_ready(fn(*a))
    dt = (time.perf_counter() - t0) / rep
    print(f"{name:40s} {dt*1e3:8.2f} ms", flush=True)


timeit(f"uv-march kernel (1e6 pk, rk23 12 evals)", run_pallas,
       pwc, xk, oi, oj)
