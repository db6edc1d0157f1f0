"""North-star workload: data-parallel, preemption-safe flow training.

Composes the trainers' capabilities into the deployment shape the
framework targets:

1. a COUPLING-stack whitening fit;
2. data parallelism over a ``batch`` mesh axis — batches sharded, params
   replicated, the gradient psum inserted by XLA from the shardings;
3. preemption safety: `checkpoint_every=` chunks the scan through
   `utils.resilience.run_checkpointed`, so a SIGKILLed job restarted with
   the SAME call resumes bit-identically (demonstrated below by a second
   call that resumes instead of retraining).

On a multi-GPU host, `parallel.make_mesh({"batch": jax.device_count()})`
spans the cards; this script runs anywhere (one card, or the
8-virtual-device CPU mesh via
`XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu`).

Run: python examples/pod_training.py
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
import optax

import enflows_tpu as ef
from enflows_tpu.parallel import make_mesh
from enflows_tpu.train import optimize_whitening, mvnormal_negll


def main():
    dim = 8
    n_dev = len(jax.devices())
    mesh = make_mesh({"batch": n_dev}, axis_name="batch")
    print(f"devices: {n_dev} ({jax.default_backend()}); mesh {mesh.shape}")

    # Correlated, nonlinearly warped training data.
    key = jax.random.PRNGKey(0)
    A = 0.3 * jax.random.normal(key, (dim, dim), jnp.float32) \
        + jnp.eye(dim, dtype=jnp.float32)
    Z = jax.random.normal(jax.random.fold_in(key, 1), (1 << 16, dim),
                          jnp.float32)
    X = jnp.tanh(Z @ A.T) * 2.0 + 0.1 * Z

    flow = ef.coupling_stack(jax.random.fold_in(key, 2), dim,
                             n_layers=4, hidden=(64, 64))

    with tempfile.TemporaryDirectory() as ckpts:
        kw = dict(nbatches=8, nepochs=12, mesh=mesh,
                  checkpoint_every=4, ckpt_dir=ckpts)
        res = optimize_whitening(X, flow, optax.adam(1e-3), **kw)
        print(f"trained: negll {float(res.negll_history[0]):.3f} -> "
              f"{float(res.negll_history[-1]):.3f}")

        # "Preempted" restart: the same call resumes from the last
        # checkpoint instead of retraining (here it finds the final one
        # and returns immediately — on a real preemption it finishes the
        # remaining chunks).
        res2 = optimize_whitening(X, flow, optax.adam(1e-3), **kw)
        same = all(
            np.array_equal(np.asarray(a), np.asarray(b))
            for a, b in zip(jax.tree.leaves(res.result),
                            jax.tree.leaves(res2.result)))
        print(f"resume-from-checkpoint returns the identical flow: {same}")

    cov = np.cov(np.asarray(res.result.forward(X)).T)
    off = np.abs(cov - np.eye(dim)).max()
    print(f"whitened cov deviation from I: {off:.3f}")
    assert off < 0.35, "whitening failed"
    assert same, "resume was not bit-identical"
    negll = float(mvnormal_negll(res.result, X))
    print(f"final full-data negll: {negll:.3f} — OK")


if __name__ == "__main__":
    main()
