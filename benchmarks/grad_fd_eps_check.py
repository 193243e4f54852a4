"""FD eps-convergence check for the GRAD_r05 f64 oracle: if the
ad_vs_fd residual (8.2e-4 at eps=1e-5) is central-difference truncation
(O(eps^2) from the loss's curvature along the 1250-step chain) rather
than AD error, FD(3e-5) and FD(1e-4) must deviate from the AD value by
~9x and ~100x that residual respectively. Appends fd_eps_study to
GRAD_r05.json. Run AFTER the cpu64 leg (reads its AD row).
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))
import json

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import importlib.util  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "g5", str(_pl.Path(__file__).with_name("gradscience_r05.py")))
g5 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(g5)

# reuse the cpu64 build (MODE default 'device' only affects dt pin writes;
# the pin file exists so build() reads it)
cfg, s, carry0 = g5.build()
qk0 = carry0.flow_state.qk

from swraytracing.models.coupled import run_coupled_chunk  # noqa: E402


@jax.jit
def loss(a, c0):
    c = c0.replace(flow_state=c0.flow_state.replace(
        qk=a.astype(qk0.real.dtype) * c0.flow_state.qk))
    c2, _ = run_coupled_chunk(c, s, cfg, g5.N_SAVES, remat=True)
    om = jnp.sqrt(cfg.f**2 + cfg.Cg**2
                  * (c2.packet_k[0]**2 + c2.packet_k[1]**2))
    return jnp.var(om)


out = _pl.Path(__file__).resolve().parents[1] / "GRAD_r05.json"
data = json.loads(out.read_text())
g_ad = data["cpu64"]["dloss_da_ad"]
one = jnp.asarray(1.0)
rows = []
for eps in (1e-4, 3e-5):
    fd = (float(loss(one + eps, carry0))
          - float(loss(one - eps, carry0))) / (2 * eps)
    rows.append(dict(eps=eps, fd=fd, ad_vs_fd_rel=abs(g_ad - fd)
                     / abs(fd)))
    print(rows[-1], flush=True)
data["cpu64"]["fd_eps_study"] = rows
out.write_text(json.dumps(data, indent=1))
print("wrote", out)
