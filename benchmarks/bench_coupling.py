"""Coupling-stack throughput and tensor-core roofline share.

Configuration (the widest the repository has): d=64, 4 couplings with
(512, 512) conditioners, 128K rows, affine and K=8 rational-quadratic
spline couplings. For each stack:

* forward + ladj at the default matmul precision (float32 matmuls may run
  in TF32 on the card), under ``jax.default_matmul_precision("float32")``,
  and with bf16 conditioners (``compute_dtype="bfloat16"``);
* the conditioner MLPs alone, compiled as a program of their own; the
  forward's time minus theirs (``fwd_minus_conditioners_ms``) estimates
  the rest (the affine or spline epilogue, slicing, concatenation), as a
  difference of two programs and not a span read from a trace;
* one whitening train step (loss, gradient, optimizer update).

The stack is ``benchmarks.harness.build_coupling``, the one
``chip_smoke.py`` checks. The conditioner FLOP model below counts the
matmuls only; shares divide by the peaks in ``benchmarks/harness.py``: TF32
for the default rows, FP32 for the float32 rows (no tensor cores), bf16 for
the bf16 rows. Prints one line per row with the card's name and power
limit, and one JSON object last.

Run: python benchmarks/bench_coupling.py
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
import optax  # noqa: E402

from benchmarks.harness import (build_coupling, card_info,  # noqa: E402
                                compile_and_time, device_summary, peaks)
from enflows_tpu.bijectors import (AffineCoupling,  # noqa: E402
                                   RQSplineCoupling)
from enflows_tpu.train import make_train_step  # noqa: E402

DIM = 64
HIDDEN = (512, 512)
N_LAYERS = 4
N_BINS = 8
BATCH = 1 << 17
ITERS = 10
PEAK_NAME = {"default": "TF32", "float32": "FP32", "bf16_conditioner": "bf16"}


def flops_per_sample(kind, dim=DIM, hidden=HIDDEN, n_layers=N_LAYERS,
                     n_bins=N_BINS):
    """Conditioner matmul FLOPs per sample: (d_a -> hidden... -> out) per
    coupling, out = 2 d_b (affine) or d_b (3K - 1) (spline)."""
    d_a = dim // 2
    out = 2 * (dim - d_a) if kind == "affine" else \
        (dim - d_a) * (3 * n_bins - 1)
    sizes = (d_a,) + tuple(hidden) + (out,)
    return n_layers * sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def _fwd(stack, x):
    return stack.forward_and_ladj(x)


def _conditioners(stack, x):
    """Every coupling's conditioner on the leading split of x."""
    out = []
    for s in stack.stages:
        if isinstance(s, (AffineCoupling, RQSplineCoupling)):
            out.append(s.conditioner(x[..., : s.split]))
    return out


def main():
    card = card_info()
    dev = device_summary()
    pk = peaks(dev["kind"])
    print(f"card: {card}; device_kind {dev['kind']}; peaks from "
          f"{pk['source']}", flush=True)
    x = jax.random.normal(jax.random.PRNGKey(1), (BATCH, DIM), jnp.float32)
    result = {"card": card, "device": dev,
              "config": {"dim": DIM, "hidden": list(HIDDEN),
                         "n_layers": N_LAYERS, "n_bins": N_BINS,
                         "batch": BATCH}}
    for kind in ("affine", "spline"):
        fps = flops_per_sample(kind)
        rows = {"mflops_per_sample": fps / 1e6}
        shape = (kind, DIM, N_LAYERS, HIDDEN, N_BINS)
        stack = build_coupling(*shape)
        for label, precision, stk, peak in [
                ("default", None, stack, pk["tf32_flops"]),
                ("float32", "float32", stack, pk["fp32_flops"]),
                ("bf16_conditioner", None,
                 build_coupling(*shape, compute_dtype="bfloat16"),
                 pk["bf16_flops"])]:
            with jax.default_matmul_precision(precision):
                _, _, t = compile_and_time(_fwd, stk, x, iters=ITERS)
                _, _, t_c = compile_and_time(_conditioners, stk, x,
                                             iters=ITERS)
            rate = BATCH * fps / t
            rows[label] = {"fwd_ms": t * 1e3,
                           "conditioners_ms": t_c * 1e3,
                           "fwd_minus_conditioners_ms": (t - t_c) * 1e3,
                           "evals_per_s": BATCH / t,
                           "tflops": rate / 1e12,
                           "peak_share": rate / peak}
            print(f"[coupling] {kind} {label}: fwd {t*1e3:.3f} ms "
                  f"({BATCH/t/1e6:.2f}M evals/s, {rate/1e12:.1f} TFLOP/s = "
                  f"{100*rate/peak:.1f}% of the "
                  f"{PEAK_NAME[label]} peak) | conditioner-only program "
                  f"{t_c*1e3:.3f} ms, forward minus it "
                  f"{(t-t_c)*1e3:.3f} ms | card: {card}", flush=True)
        opt = optax.adam(1e-6)
        _, _, t_tr = compile_and_time(make_train_step(opt),
                                      (stack, opt.init(stack)), x,
                                      iters=ITERS)
        rows["train_step_ms"] = t_tr * 1e3
        rows["train_samples_per_s"] = BATCH / t_tr
        print(f"[coupling] {kind} train step (default precision): "
              f"{t_tr*1e3:.3f} ms ({BATCH/t_tr/1e6:.2f}M samples/s, "
              f"{100*3*BATCH*fps/t_tr/pk['tf32_flops']:.1f}% of the TF32 "
              f"peak at 3x forward FLOPs) | card: {card}", flush=True)
        result[kind] = rows
    print(json.dumps(result))


if __name__ == "__main__":
    main()
