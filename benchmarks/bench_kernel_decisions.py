"""Kernel-layer decisions: how close XLA's plain path is to its roofs.

1. Elementwise chain, forward + per-sample ladj of the flagship flow
   (``__graft_entry__._flagship_flow``) at 16M x 2 and at 128K x 50:
   * XLA's fusion of the plain ``forward_and_ladj``;
   * its roofline: XLA's own count of the compiled program's flops,
     transcendentals and bytes (``harness.xla_cost``) over the FP32,
     special-function and HBM peaks of ``harness.PEAKS``; the largest of
     the three times is the floor, and XLA's share is floor / time. The
     count charges each transcendental one special-function result;
   * the one-pass floor: the same arithmetic, but HBM traffic of one read
     of x and one write of y and ladj, what a single fused kernel moves.
     XLA's program splits the chain into several kernels whose
     intermediates cross HBM, so its byte count is a multiple of that;
   * a large copy, the achieved HBM roof.
2. Householder rotation, dense (``x @ Q^T``) against scan (k rank-1
   sweeps), forward and value+grad, k = 4, d in {2, 4, 8, 16, 32, 50, 64,
   128} at 1K, 16K and 1M rows: where ``mode="auto"`` switches.
3. A large bf16 matrix product, the achieved tensor-core rate.

Prints one line per measurement, each with the card's name and power
limit, and one JSON object last.

Run: python benchmarks/bench_kernel_decisions.py
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from enflows_tpu.utils.compilation_cache import \
    enable_persistent_compilation_cache  # noqa: E402

enable_persistent_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import enflows_tpu as ef  # noqa: E402
from __graft_entry__ import _flagship_flow  # noqa: E402
from benchmarks.harness import (card_info, compile_and_time,  # noqa: E402
                                device_summary, peaks, roofline,
                                xla_cost)

ITERS = 20


def _fwd(flow, x):
    return flow.forward_and_ladj(x)


EW_SIZES = ((1 << 24, 2), (1 << 17, 50))


def elementwise(card, pk, hbm_copy):
    out = {}
    for n, d in EW_SIZES:
        flow = _flagship_flow(d)
        x = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
        _, c_x, t_x = compile_and_time(_fwd, flow, x, iters=ITERS)
        cost = xla_cost(_fwd, flow, x)
        roof = roofline(cost, pk)
        moved = (2 * n * d + n) * 4
        one_pass = roofline(dict(cost, **{"bytes accessed": moved}), pk)
        row = {
            "xla_ms": t_x * 1e3,
            "per_element": {k: v / (n * d) for k, v in cost.items()},
            "floor_ms": {k: v * 1e3 for k, v in roof.items()},
            "one_pass_floor_ms": one_pass["floor"] * 1e3,
            "xla_roofline_share": roof["floor"] / t_x,
            "xla_one_pass_share": one_pass["floor"] / t_x,
            "bytes_over_one_pass": cost["bytes accessed"] / moved,
            "xla_hbm_share_measured_copy":
                cost["bytes accessed"] / t_x / hbm_copy,
            "xla_evals_per_s": n / t_x,
        }
        out[f"{n}x{d}"] = row
        pe = row["per_element"]
        print(f"[elementwise] flagship {n}x{d}: XLA {t_x*1e3:.4f} ms "
              f"(compile {c_x:.2f} s, {n/t_x/1e9:.3f}G evals/s) | per "
              f"element {pe['flops']:.1f} flops, "
              f"{pe['transcendentals']:.1f} transcendentals, "
              f"{pe['bytes accessed']:.1f} B "
              f"({row['bytes_over_one_pass']:.1f}x one pass) | floor FP32 "
              f"{roof['fp32']*1e3:.4f} ms, SFU {roof['sfu']*1e3:.4f} ms, "
              f"HBM {roof['hbm']*1e3:.4f} ms: XLA at "
              f"{100*row['xla_roofline_share']:.1f}% of its program's "
              f"roofline, {100*row['xla_one_pass_share']:.1f}% of the "
              f"one-pass floor {one_pass['floor']*1e3:.4f} ms | its bytes "
              f"at {100*row['xla_hbm_share_measured_copy']:.1f}% of the "
              f"measured copy rate | card: {card}", flush=True)
    return out


HH_DIMS = (2, 4, 8, 16, 32, 50, 64, 128)
HH_ROWS = (1 << 10, 1 << 14, 1 << 20)


def householder(card):
    out = {}
    for n in HH_ROWS:
        for d in HH_DIMS:
            V = jax.random.normal(jax.random.PRNGKey(3), (4, d), jnp.float32)
            x = jax.random.normal(jax.random.PRNGKey(4), (n, d),
                                  jnp.float32)
            row = {}
            for mode in ("dense", "scan"):
                h = ef.Householder(V=V, mode=mode).canonicalize()
                _, _, t_fwd = compile_and_time(
                    lambda hh, xx: hh.forward(xx), h, x, iters=ITERS)
                vg = jax.value_and_grad(
                    lambda hh, xx: jnp.sum(jnp.sin(hh.forward(xx))))
                _, _, t_vg = compile_and_time(vg, h, x, iters=ITERS)
                row[mode] = {"fwd_ms": t_fwd * 1e3,
                             "value_grad_ms": t_vg * 1e3}
            out[f"{n}x{d}"] = row
            print(f"[householder] k=4 {n}x{d}: dense fwd "
                  f"{row['dense']['fwd_ms']:.4f} ms, v+g "
                  f"{row['dense']['value_grad_ms']:.4f} ms | scan fwd "
                  f"{row['scan']['fwd_ms']:.4f} ms, v+g "
                  f"{row['scan']['value_grad_ms']:.4f} ms | card: {card}",
                  flush=True)
    return out


def main():
    card = card_info()
    dev = device_summary()
    pk = peaks(dev["kind"])
    print(f"card: {card}; device_kind {dev['kind']}; peaks from "
          f"{pk['source']}", flush=True)

    big = jax.random.normal(jax.random.PRNGKey(9), (1 << 26,), jnp.float32)
    _, _, t_copy = compile_and_time(lambda a: a * 1.0001, big, iters=ITERS)
    hbm_copy = 2 * big.size * 4 / t_copy
    m = 8192
    a = jax.random.normal(jax.random.PRNGKey(10), (m, m), jnp.bfloat16)
    _, _, t_mm = compile_and_time(
        lambda p, q: jnp.dot(p, q, preferred_element_type=jnp.float32),
        a, a, iters=ITERS)
    mm_rate = 2 * m ** 3 / t_mm
    print(f"[roofs] copy {hbm_copy/1e12:.3f} TB/s "
          f"({100*hbm_copy/pk['hbm_bytes_per_s']:.1f}% of published); bf16 "
          f"matmul {m}^3 {mm_rate/1e12:.1f} TFLOP/s "
          f"({100*mm_rate/pk['bf16_flops']:.1f}% of published) | card: "
          f"{card}", flush=True)

    result = {"card": card, "device": dev,
              "hbm_copy_bytes_per_s": hbm_copy,
              "bf16_matmul_flops": mm_rate,
              "householder": householder(card),
              "elementwise": elementwise(card, pk, hbm_copy)}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
