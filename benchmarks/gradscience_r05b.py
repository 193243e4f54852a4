"""GRAD_r05 follow-up: discriminate WHY the matched-config accelerator f32
gradient (gradscience_r05.py `device` row) deviates ~41% from the CPU f64
AD oracle while CPU f32 AD matches it to 5.6e-4.

Two hypotheses:
  (a) adjoint bug in the device path (kernel forward / custom-VJP
      backward) — then device AD would ALSO disagree with device central
      finite differences of its own loss;
  (b) the device integrates a slightly different MAP (f32
      transforms, kernel fusion/FMA order, ~1e-6
      relative per step) and 1250 coupled steps of a chaotic flow
      amplify that into an O(1) gradient difference — then device AD
      matches device FD (the adjoint is faithful to the chip's own map)
      and the device-vs-f64 gap must GROW with horizon from ~f32 scale.

Legs (merge into GRAD_r05.json):
  device_fd  — central FD on the device at the full 1250-step horizon, an
            eps study (f32: eps too small drowns in rounding, too
            large in curvature), plus device AD at short horizons.
  cpu64_h — f64 AD at the same short horizons (same pinned dt).

Derived: horizon table {steps: rel(device_ad, cpu64_ad)}.

Reference: SURVEY §7 hard part #1 (f32-vs-f64 drift budget);
qgsw_raytrace.m has no adjoint — this validation surface is
exists only here.
"""
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))
import json
import time

import numpy as np

MODE = _sys.argv[1] if len(_sys.argv) > 1 else "device_fd"

import jax  # noqa: E402

if MODE.startswith("cpu"):
    jax.config.update("jax_platforms", "cpu")
if MODE == "cpu64_h":
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from swraytracing.models.coupled import (CoupledConfig, setup_coupled,  # noqa: E402
                                             run_coupled_chunk)

NX = 256
NP = 2**14
HORIZON_SAVES = (10, 50)    # x5 -> 50, 250 coupled steps
FULL_SAVES = 250            # the matched-config horizon (1250 steps)
DT_PIN_FILE = _pl.Path(__file__).resolve().with_name(
    "gradscience_r05.dtpin")


def build():
    cfg = CoupledConfig(nx=NX, n_packets=NP, T_Fr_days=6000.0,
                        packet_delay_days=0.01, U_g=0.4, f=3.0, Cg=1.0,
                        window_min_np=2**13)
    s, carry0 = setup_coupled(cfg)
    assert s.march is not None
    s = s._replace(dt=float(DT_PIN_FILE.read_text()))
    return cfg, s, carry0


def main():
    cfg, s, carry0 = build()
    qk0 = carry0.flow_state.qk

    def loss_n(n_saves):
        @jax.jit
        def loss(a, c0):
            c = c0.replace(flow_state=c0.flow_state.replace(
                qk=a.astype(qk0.real.dtype) * c0.flow_state.qk))
            c2, _ = run_coupled_chunk(c, s, cfg, n_saves, remat=True)
            om = jnp.sqrt(cfg.f**2 + cfg.Cg**2
                          * (c2.packet_k[0]**2 + c2.packet_k[1]**2))
            return jnp.var(om)
        return loss

    out = _pl.Path(__file__).resolve().parents[1] / "GRAD_r05.json"
    # accumulate locally; merge into the file ONLY at the end (re-read
    # then, so concurrent legs don't clobber each other's rows)
    mine = {}
    hz = mine.setdefault("horizon_ad", {})

    if MODE == "device_fd":
        loss = loss_n(FULL_SAVES)
        one = jnp.asarray(1.0)
        g_ad = (json.loads(out.read_text()) if out.exists() else {}) \
            .get("device", {}).get("dloss_da_ad")
        rows = []
        for eps in (3e-3, 1e-2, 3e-2):
            t0 = time.perf_counter()
            fd = (float(loss(one + eps, carry0))
                  - float(loss(one - eps, carry0))) / (2 * eps)
            row = dict(eps=eps, fd=fd, secs=round(
                time.perf_counter() - t0, 2))
            if g_ad is not None:
                row["device_ad_vs_fd_rel"] = abs(g_ad - fd) / abs(fd)
            rows.append(row)
            print(row, flush=True)
        mine["device_fd_eps_study"] = rows
        for n in HORIZON_SAVES:
            g = float(jax.jit(jax.grad(loss_n(n)))(one, carry0))
            hz.setdefault(str(n * 5), {})["device_ad"] = g
            print("horizon", n * 5, "device_ad", g, flush=True)
    elif MODE == "cpu64_h":
        one = jnp.asarray(1.0)
        for n in HORIZON_SAVES:
            g = float(jax.jit(jax.grad(loss_n(n)))(one, carry0))
            hz.setdefault(str(n * 5), {})["cpu64_ad"] = g
            print("horizon", n * 5, "cpu64_ad", g, flush=True)

    data = json.loads(out.read_text()) if out.exists() else {}
    for k, v in mine.items():
        if k == "horizon_ad":
            tgt = data.setdefault("horizon_ad", {})
            for n, row in v.items():
                tgt.setdefault(n, {}).update(row)
        else:
            data[k] = v
    for row in data.get("horizon_ad", {}).values():
        if "device_ad" in row and "cpu64_ad" in row:
            row["rel"] = abs(row["device_ad"] - row["cpu64_ad"]) \
                / abs(row["cpu64_ad"])
    out.write_text(json.dumps(data, indent=1))
    print("wrote", out, flush=True)


main()
