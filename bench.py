"""Benchmark harness: prints ONE JSON line.

Headline metric: flow forward + log-det evaluations per second on the
flagship 5-stage flow (``__graft_entry__._flagship_flow``: 4 reference
stages and a 4-reflection Householder rotation), float32, 16M samples per
call, through the plain ``forward_and_ladj`` that XLA fuses.

Also timed: the whitening value+grad step at 4M samples and the d=50
forward at 128K samples. Each timing compiles ahead of time, makes one
warm-up call, then averages calls that end in ``block_until_ready``.
The JSON names the device (platform, device_kind, count) and the card's
name and power limit as nvidia-smi reports them.

Extra context goes to stderr; stdout carries exactly one JSON line.
"""
import json
import sys

from enflows_tpu.utils.compilation_cache import \
    enable_persistent_compilation_cache

enable_persistent_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.harness import (card_info, compile_and_time,  # noqa: E402
                                device_summary)

ITERS = 20


def main():
    from __graft_entry__ import _flagship_flow
    from enflows_tpu.train import mvnormal_negll

    def fwd(flow, x):
        return flow.forward_and_ladj(x)

    def value_grad(flow, x):
        return jax.value_and_grad(mvnormal_negll)(flow, x)

    batch, batch_tr, batch50 = 1 << 24, 1 << 22, 1 << 17
    flow = _flagship_flow(2)
    x = jax.random.normal(jax.random.PRNGKey(0), (batch, 2), jnp.float32)
    _, c_fwd, t_fwd = compile_and_time(fwd, flow, x, iters=ITERS)
    _, c_tr, t_tr = compile_and_time(value_grad, flow, x[:batch_tr],
                                     iters=ITERS)
    flow50 = _flagship_flow(50)
    x50 = jax.random.normal(jax.random.PRNGKey(1), (batch50, 50),
                            jnp.float32)
    _, c_50, t_50 = compile_and_time(fwd, flow50, x50, iters=ITERS)
    card = card_info()
    print(f"[bench] fwd+ladj 16M x 2: {t_fwd*1e3:.3f} ms (compile "
          f"{c_fwd:.2f} s) | value+grad 4M x 2: {t_tr*1e3:.3f} ms "
          f"(compile {c_tr:.2f} s) | fwd+ladj 128K x 50: {t_50*1e3:.3f} ms "
          f"(compile {c_50:.2f} s) | card: {card}", file=sys.stderr)
    print(json.dumps({
        "metric": "flow_fwd_logdet_evals_per_s",
        "value": batch / t_fwd,
        "unit": "evals/s",
        "device": device_summary(),
        "card": card,
        "iters": ITERS,
        "train_value_grad_samples_per_s": batch_tr / t_tr,
        "d50_evals_per_s": batch50 / t_50,
        "compile_s": {"fwd": c_fwd, "train": c_tr, "d50": c_50},
    }))


if __name__ == "__main__":
    main()
