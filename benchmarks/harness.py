"""Shared measurement helpers for the benchmark scripts and ``chip_smoke.py``.

* :func:`card_info` reads the card's name and power limit from
  ``nvidia-smi``; every device number is printed beside it.
* :func:`compile_and_time` separates compile time from steady wall time
  (a warm-up call, then calls that end in ``block_until_ready``).
* :func:`xla_cost` is XLA's own count of a compiled program's operations
  (flops, transcendentals, bytes accessed), and :func:`roofline` turns it
  into floor times against a device's peaks.
* :data:`PEAKS` is the one table of device peaks that roofline shares
  divide by. It is keyed by ``jax.Device.device_kind``; a device that is not
  in it is an error, never a default.
* :func:`build_coupling` is the perturbed coupling stack that the coupling
  benchmark and ``chip_smoke.py`` both time.
"""
from __future__ import annotations

import subprocess
import time

import jax
import numpy as np

# Published dense peaks (no sparsity). Source: NVIDIA H100 Tensor Core GPU
# data sheet, SXM5 part, at the 700 W power limit; the special-function
# rate is the CUDA C++ Programming Guide's 16 results per clock per SM for
# compute capability 9.0 (reciprocal, rsqrt, log2, exp2, sin, cos) times
# the data sheet's 132 SMs at the 1.98 GHz boost clock. fp32_flops counts
# a fused multiply-add as two flops. A card set below 700 W cannot hold its
# top clock under load, so a roofline share is always printed beside the
# card's power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "source": "NVIDIA H100 Tensor Core GPU data sheet (SXM5, dense); "
                  "CUDA C++ Programming Guide (cc 9.0 SFU rate)",
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "sfu_ops_per_s": 16 * 132 * 1.98e9,
    },
}


def peaks(device_kind: str) -> dict:
    """Peak rates for ``device_kind``; raises KeyError for unknown devices."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r};"
                       f" add it to benchmarks/harness.py PEAKS with a source")
    return PEAKS[device_kind]


def card_info() -> str:
    """``name, power.limit`` of each visible card as nvidia-smi reports it,
    or a note that nvidia-smi is unavailable."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode != 0 or not lines:
        return f"nvidia-smi unavailable (exit {out.returncode})"
    return " | ".join(lines)


def device_summary() -> dict:
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def peak_bytes_in_use() -> int | None:
    """Process-wide peak device memory so far (None where the backend
    keeps no statistics, as on the CPU)."""
    stats = jax.devices()[0].memory_stats()
    return None if not stats else int(stats.get("peak_bytes_in_use", 0))


def compile_and_time(fn, *args, iters: int = 5):
    """AOT-compile ``jax.jit(fn)`` for ``args`` and time it.

    Returns ``(out, compile_s, step_s)``: the compile time of the lowered
    program, and the mean wall time of ``iters`` calls after one warm-up
    call, the last of which ends in ``block_until_ready``.
    """
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = compiled(*args)
    jax.block_until_ready(out)
    return out, compile_s, (time.perf_counter() - t0) / iters


def xla_cost(fn, *args) -> dict:
    """XLA's operation count for ``jax.jit(fn)`` compiled for ``args``:
    ``flops`` (each elementwise add, multiply, compare, divide... counts
    one), ``transcendentals`` (exp, log, log1p, tanh, sqrt, rsqrt, power)
    and ``bytes accessed``."""
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return {k: float(ca.get(k, 0.0))
            for k in ("flops", "transcendentals", "bytes accessed")}


def roofline(cost: dict, pk: dict) -> dict:
    """Floor times in seconds of an :func:`xla_cost` count against the
    peaks ``pk``: FP32 arithmetic, special functions and HBM traffic, and
    ``floor``, the largest of the three."""
    t = {"fp32": cost["flops"] / pk["fp32_flops"],
         "sfu": cost["transcendentals"] / pk["sfu_ops_per_s"],
         "hbm": cost["bytes accessed"] / pk["hbm_bytes_per_s"]}
    t["floor"] = max(t.values())
    return t


def build_coupling(kind: str, dim=64, n_layers=4, hidden=(512, 512),
                   n_bins=8, compute_dtype=None):
    """An affine or K-bin spline coupling stack, moved off its identity
    initialization so nothing folds away: every weight matrix gets
    0.03 / sqrt(fan_in) Gaussian noise, every bias 0.03. An absolute 0.03
    on the weights saturates every log-scale at its +-3 clamp, and its e^12
    amplification is no configuration users train."""
    import enflows_tpu as ef

    key = jax.random.PRNGKey(0)
    if kind == "affine":
        stack = ef.coupling_stack(key, dim, n_layers=n_layers,
                                  hidden=hidden, compute_dtype=compute_dtype)
    else:
        stack = ef.spline_coupling_stack(key, dim, n_layers=n_layers,
                                         hidden=hidden, n_bins=n_bins,
                                         compute_dtype=compute_dtype)

    def perturb(p):
        noise = jax.random.normal(jax.random.PRNGKey(p.size % 101), p.shape,
                                  p.dtype)
        scale = 0.03 / np.sqrt(p.shape[0]) if p.ndim == 2 else 0.03
        return p + scale * noise

    return jax.tree.map(perturb, stack)
