"""Multi-chip sharding tests on the 8-device simulated CPU mesh.

The test strategy from SURVEY.md §4: collectives (psum step-size
consensus, distributed resampling, sharded moment accumulation) validated
with `--xla_force_host_platform_device_count=8` and `shard_map`, no pod
needed. Correctness gates compare sharded results against the single-device
implementations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from enflows_tpu.parallel import (
    make_mesh, chains_sharding, shard_chains, sharded_systematic_resample,
    smc_sample_sharded, sample_sharded, broadcast_from_zero, pmean,
)
from enflows_tpu.smc import smc_sample
from enflows_tpu.mcmc import split_rhat_per_dim

DT = jnp.float64


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh({"chains": 8})


def test_mesh_construction(mesh):
    assert mesh.shape["chains"] == 8
    two_axis = make_mesh({"hosts": 2, "chains": 4})
    assert two_axis.shape == {"hosts": 2, "chains": 4}
    with pytest.raises(ValueError):
        make_mesh({"chains": 3})


def test_broadcast_from_zero(mesh):
    f = jax.jit(shard_map(
        lambda x: broadcast_from_zero(x, "chains"), mesh=mesh,
        in_specs=P("chains"), out_specs=P("chains"), check_vma=False))
    x = jnp.arange(8, dtype=DT)
    out = np.asarray(f(x))
    np.testing.assert_array_equal(out, np.zeros(8))


def test_pmean_consensus(mesh):
    f = jax.jit(shard_map(
        lambda x: pmean(jnp.mean(x), "chains") * jnp.ones_like(x),
        mesh=mesh, in_specs=P("chains"), out_specs=P("chains"),
        check_vma=False))
    x = jnp.arange(16, dtype=DT)
    np.testing.assert_allclose(np.asarray(f(x)), np.full(16, 7.5),
                               rtol=1e-12)


def test_sharded_resampler_matches_expectations(mesh):
    n = 128
    key = jax.random.PRNGKey(0)
    lw = jax.random.normal(key, (n,), DT)
    parts = jnp.arange(n, dtype=DT)[:, None]
    sh = chains_sharding(mesh)
    f = jax.jit(shard_map(
        sharded_systematic_resample, mesh=mesh,
        in_specs=(P(), P("chains"), P("chains")), out_specs=P("chains"),
        check_vma=False))
    out = f(jax.random.PRNGKey(7), jax.device_put(lw, sh),
            jax.device_put(parts, sh))
    w = np.asarray(jax.nn.softmax(lw))
    emp = np.bincount(np.asarray(out[:, 0]).astype(int), minlength=n) / n
    # Systematic resampling: offspring counts within 1 of n*w.
    assert np.abs(emp - w).max() * n <= 1.0 + 1e-9
    # Output is a permutation-with-repetition of input rows.
    assert np.isin(np.asarray(out[:, 0]).astype(int),
                   np.arange(n)).all()


def test_ring_exchange_matches_gather(mesh):
    # The O(n_local)-memory ppermute ring must produce bit-identical rows
    # to the all_gather exchange (same ancestry, different transport).
    n, dim = 256, 3
    key = jax.random.PRNGKey(11)
    lw = jax.random.normal(key, (n,), DT) * 2.0
    parts = jax.random.normal(jax.random.PRNGKey(12), (n, dim), DT)
    sh = chains_sharding(mesh)

    def run(method):
        f = jax.jit(shard_map(
            lambda k, w, p: sharded_systematic_resample(
                k, w, p, method=method),
            mesh=mesh, in_specs=(P(), P("chains"), P("chains")),
            out_specs=P("chains"), check_vma=False))
        return np.asarray(f(jax.random.PRNGKey(3), jax.device_put(lw, sh),
                            jax.device_put(parts, sh)))

    np.testing.assert_array_equal(run("ring"), run("gather"))


def test_sharded_smc_matches_single_device(mesh):
    mu = jnp.asarray([3.0, -2.0], DT)

    def log_target(q):
        d = q - mu
        return -0.5 * jnp.sum(d * d) / 0.25

    true_logz = np.log(2 * np.pi * 0.25)
    p1, lw1, lz1, inf1 = smc_sample(log_target, jax.random.PRNGKey(0),
                                    dim=2, num_particles=4096, dtype=DT)
    p2, lw2, lz2, inf2 = smc_sample_sharded(
        log_target, jax.random.PRNGKey(0), mesh, dim=2,
        num_particles=4096, dtype=DT)
    for lz, p, lw in [(lz1, p1, lw1), (lz2, p2, lw2)]:
        w = np.asarray(jax.nn.softmax(lw))
        m = (w[:, None] * np.asarray(p)).sum(0)
        np.testing.assert_allclose(m, np.asarray(mu), atol=0.08)
        assert abs(float(lz) - true_logz) < 0.15
    # Comparable temperature ladders.
    assert abs(len(inf1) - len(inf2)) <= 3
    # Machine-check the check_vma=False replication promise on the
    # sharded run's consensus outputs (VERDICT r4 next #6).
    from enflows_tpu.utils import assert_replicated_consistent
    assert_replicated_consistent(lz2, "smc.log_z")
    for name, val in [("beta", getattr(inf2[-1], "beta", None)),
                      ("step_size", getattr(inf2[-1], "step_size", None))]:
        if val is not None:
            assert_replicated_consistent(jnp.asarray(val), f"smc.{name}")


def test_sharded_smc_same_key_trajectory_equivalence(mesh):
    # The strongest multi-chip correctness gate: given the same key, the
    # sharded path follows the single-device path's exact trajectory
    # (mutation RNG streams are global-split-and-sliced, the resample
    # uniform is shared, and all cross-shard reductions only differ in
    # summation order). f64 keeps the reduction-order noise far below the
    # tolerance over a full multi-temperature run.
    mu = jnp.asarray([1.5, -1.0], DT)

    def log_target(q):
        d = q - mu
        return -0.5 * jnp.sum(d * d) / 0.25

    p1, lw1, lz1, inf1 = smc_sample(log_target, jax.random.PRNGKey(4),
                                    dim=2, num_particles=2048, dtype=DT)
    p2, lw2, lz2, inf2 = smc_sample_sharded(
        log_target, jax.random.PRNGKey(4), mesh, dim=2,
        num_particles=2048, dtype=DT)
    assert len(inf1) == len(inf2)
    np.testing.assert_allclose([float(i.beta) for i in inf1],
                               [float(i.beta) for i in inf2], rtol=1e-9)
    np.testing.assert_allclose(float(lz1), float(lz2), atol=1e-8)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(lw1), np.asarray(lw2), atol=1e-6)


def test_sharded_transport_trajectory_matches_single_device(mesh):
    # BASELINE.json config #5 composition: learned annealing transports x
    # sharded particles. The transport is fit data-parallel (psum'd grads)
    # inside the sharded step and must reproduce the single-device
    # fit_transport trajectory given the same key.
    from enflows_tpu.smc import make_transport_fitter
    from enflows_tpu.smc.flow_transport import default_template
    from enflows_tpu.distributions.base import std_normal_logpdf_sum

    mu = jnp.asarray([3.0, -2.0], DT)
    s = 0.5

    def log_target(q):
        d = q - mu
        return -0.5 * jnp.sum(d * d) / s**2

    fit = make_transport_fitter(std_normal_logpdf_sum, log_target,
                                nsteps=80)
    p1, lw1, lz1, inf1 = smc_sample(
        log_target, jax.random.PRNGKey(0), dim=2, num_particles=4096,
        fit_transport=fit, dtype=DT)
    p2, lw2, lz2, inf2 = smc_sample_sharded(
        log_target, jax.random.PRNGKey(0), mesh, dim=2,
        num_particles=4096, transport_template_fn=default_template,
        transport_steps=80, dtype=DT)
    assert len(inf1) == len(inf2)
    np.testing.assert_allclose([float(i.beta) for i in inf1],
                               [float(i.beta) for i in inf2], rtol=1e-9)
    np.testing.assert_allclose(float(lz1), float(lz2), atol=1e-8)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-6)
    # And both hit the analytic answer.
    true_logz = np.log(2 * np.pi * s**2)
    assert abs(float(lz2) - true_logz) < 0.1
    w2 = np.asarray(jax.nn.softmax(lw2))
    m2 = (w2[:, None] * np.asarray(p2)).sum(0)
    np.testing.assert_allclose(m2, np.asarray(mu), atol=0.05)


def test_sharded_transport_multimodal_logz(mesh):
    # Reduced-dim CI gate for the 100-D multimodal BASELINE config (the
    # full-size run lives in benchmarks/bench_smc.py and BASELINE.md):
    # sharded particles + learned transports on a bimodal mixture must
    # keep both modes and an unbiased log Z (the train/estimation split in
    # flow_transport is what makes the latter hold — without it this gate
    # fails by ~5x the tolerance).
    from enflows_tpu.smc.flow_transport import default_template

    dim = 32

    def log_target(q):
        a = -0.5 * jnp.sum((q - 1.5) ** 2) + jnp.log(0.5)
        b = -0.5 * jnp.sum((q + 1.5) ** 2) + jnp.log(0.5)
        return jnp.logaddexp(a, b)

    parts, lw, logz, infos = smc_sample_sharded(
        log_target, jax.random.PRNGKey(3), mesh, dim=dim,
        num_particles=8192, mutation_steps=5,
        transport_template_fn=default_template, transport_steps=60,
        dtype=DT)
    w = np.asarray(jax.nn.softmax(lw))
    frac = float((w * (np.asarray(parts)[:, 0] > 0)).sum())
    assert 0.35 < frac < 0.65, frac
    true_logz = dim * 0.5 * np.log(2 * np.pi)
    assert abs(float(logz) - true_logz) < 0.15, float(logz) - true_logz


def test_sharded_mcmc_moments_and_layout(mesh):
    cov = jnp.asarray([[2.0, 1.2], [1.2, 1.0]], DT)
    prec = jnp.linalg.inv(cov)

    def logp(q):
        return -0.5 * q @ prec @ q

    samples, _, stats = sample_sharded(
        logp, jax.random.PRNGKey(0), mesh, dim=2, num_chains=32,
        num_warmup=300, num_samples=400, dtype=DT)
    s = np.asarray(samples).reshape(-1, 2)
    np.testing.assert_allclose(np.cov(s.T), np.asarray(cov), atol=0.2)
    assert np.all(split_rhat_per_dim(samples) < 1.05)
    # One consensus step size, finite mass matrix.
    assert np.isfinite(float(stats.step_size))


def test_sharded_mcmc_shard_map_vs_spmd_vs_unsharded(mesh):
    """VERDICT r3 next #3: the explicit shard_map implementation follows
    the SAME per-chain trajectories as the implicit-propagation path and
    the plain unsharded `mcmc.sample` run (global-index chain keys +
    explicit consensus collectives), within collective reduction-order
    noise."""
    from enflows_tpu.mcmc import sample

    def logp(q):
        d = q - jnp.asarray([0.5, -0.5], DT)
        return -0.5 * jnp.sum(d * d)

    key = jax.random.PRNGKey(7)
    kw = dict(dim=2, num_chains=16, num_warmup=60, num_samples=20,
              dtype=DT)
    d_e, _, st_e = sample_sharded(logp, key, mesh,
                                  implementation="shard_map", **kw)
    d_s, _, st_s = sample_sharded(logp, key, mesh,
                                  implementation="spmd", **kw)
    # Same initial-position derivation as sample_sharded.
    k2, k0 = jax.random.split(key)
    init = 0.1 * jax.random.normal(k0, (16, 2), DT)
    d_u, _, st_u = sample(logp, k2, initial_position=init, **kw)
    np.testing.assert_allclose(np.asarray(d_e), np.asarray(d_s),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(d_e), np.asarray(d_u),
                               rtol=0, atol=1e-10)
    assert float(st_e.step_size) == pytest.approx(
        float(st_s.step_size), rel=1e-12)
    np.testing.assert_allclose(np.asarray(st_e.inv_mass_diag),
                               np.asarray(st_u.inv_mass_diag),
                               rtol=1e-12)
    # Layout: chains axis really sharded by the explicit path.
    assert d_e.sharding.spec[0] == "chains"
    # check_vma=False declares the consensus outputs replicated without
    # the static checker; machine-check the dynamic guarantee the module
    # comment promises (VERDICT r4 next #6): every shard bit-identical.
    from enflows_tpu.utils import assert_replicated_consistent
    assert_replicated_consistent(st_e.step_size, "nuts.step_size")
    assert_replicated_consistent(st_e.inv_mass_diag, "nuts.inv_mass")


def test_sharded_chees_moments(mesh):
    """ChEES with the chains axis sharded: the cross-chain ChEES/acceptance
    means lower to psums; adaptation scalars stay replicated and the
    dynamic leapfrog trip count is a replicated scalar (no divergence)."""
    cov = jnp.asarray([[2.0, 1.2], [1.2, 1.0]], DT)
    prec = jnp.linalg.inv(cov)

    def logp(q):
        return -0.5 * q @ prec @ q

    samples, _, stats = sample_sharded(
        logp, jax.random.PRNGKey(5), mesh, dim=2, num_chains=64,
        num_warmup=300, num_samples=300, dtype=DT, algorithm="chees")
    s = np.asarray(samples).reshape(-1, 2)
    np.testing.assert_allclose(np.cov(s.T), np.asarray(cov), atol=0.25)
    assert np.isfinite(float(stats.step_size))
    assert float(stats.trajectory_length) > 0.0


def test_shard_chains_placement(mesh):
    x = jnp.zeros((32, 4))
    y = shard_chains(x, mesh)
    assert y.sharding.spec == P("chains")


def test_whitening_trainer_mesh_path(mesh):
    # Data-parallel whitening: batch axis sharded; result matches the
    # unsharded run (same data/optimizer; XLA inserts the grad psum).
    import optax
    from enflows_tpu import ScaleShift
    from enflows_tpu.train import optimize_whitening

    X = 2.0 * jax.random.normal(jax.random.PRNGKey(9), (4096, 2), DT) + 1.0
    flow = ScaleShift(a=jnp.ones(2, DT), b=jnp.zeros(2, DT))
    # mesh axis name must match the trainer's batch_axis kwarg
    from enflows_tpu.parallel import make_mesh as _mm
    m = _mm({"batch": 8}, axis_name="batch")
    r_sh = optimize_whitening(X, flow, optax.adagrad(0.1), nbatches=8,
                              nepochs=4, mesh=m)
    r_un = optimize_whitening(X, flow, optax.adagrad(0.1), nbatches=8,
                              nepochs=4)
    np.testing.assert_allclose(np.asarray(r_sh.negll_history),
                               np.asarray(r_un.negll_history), rtol=1e-10)
    for a, b in zip(jax.tree.leaves(r_sh.result),
                    jax.tree.leaves(r_un.result)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-10)


def test_ring_path_memory_is_local(mesh):
    """The ring path's compiled HLO must contain no O(n_global) collective:
    the only all-gather allowed is the K-scalar device-prefix one
    (VERDICT r1 weak #1 — the module docstring's O(n_local) claim, now
    true and enforced)."""
    import re
    n, dim = 1024, 4
    sh = chains_sharding(mesh)
    lw = jax.device_put(jnp.zeros((n,), DT), sh)
    parts = jax.device_put(jnp.zeros((n, dim), DT), sh)

    f = jax.jit(shard_map(
        lambda k, w, p: sharded_systematic_resample(k, w, p, method="ring"),
        mesh=mesh, in_specs=(P(), P("chains"), P("chains")),
        out_specs=P("chains"), check_vma=False))
    hlo = f.lower(jax.random.PRNGKey(0), lw, parts).compile().as_text()
    n_shards = mesh.shape["chains"]
    for m in re.finditer(r"all-gather[^=]*=\s*\S*?\[([\d,]*)\]", hlo):
        dims = [int(d) for d in m.group(1).split(",") if d]
        total = int(np.prod(dims)) if dims else 1
        assert total <= 4 * n_shards, \
            f"O(n_global) all-gather in ring path: {m.group(0)[:80]}"
    assert "collective-permute" in hlo  # the ring is real


def test_sharded_in_graph_ladder_matches_host_loop(mesh):
    """VERDICT r2 #5, sharded: the one-jit while_loop ladder (shard_map
    inside lax.while_loop) must follow the Python ladder's exact same-key
    trajectory."""
    mu = jnp.asarray([0.5, 1.5], DT)

    def log_target(q):
        d = q - mu
        return -0.5 * jnp.sum(d * d) / 0.25

    outs = {}
    for mode in (True, False):
        parts, lw, logz, infos = smc_sample_sharded(
            log_target, jax.random.PRNGKey(11), mesh, dim=2,
            num_particles=2048, in_graph=mode, dtype=DT)
        outs[mode] = (parts, lw, logz, infos)
    p1, lw1, lz1, inf1 = outs[True]
    p2, lw2, lz2, inf2 = outs[False]
    assert len(inf1) == len(inf2)
    np.testing.assert_allclose([float(i.beta) for i in inf1],
                               [float(i.beta) for i in inf2], rtol=1e-12)
    np.testing.assert_allclose(float(lz1), float(lz2), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-9)
    np.testing.assert_allclose(np.asarray(lw1), np.asarray(lw2),
                               atol=1e-9)


def test_build_sharded_smc_step_no_retrace(mesh):
    """VERDICT r2 #7: the explicit sharded-step builder compiles once
    under the caller's control; reuse across smc_sample_sharded calls
    with fresh-closure targets never retraces (jit-cache-size assert)."""
    from enflows_tpu.parallel import build_sharded_smc_step

    def fresh_target():
        return lambda q: -0.5 * jnp.sum((q - 1.0) ** 2)

    from enflows_tpu.distributions.base import std_normal_logpdf_sum
    step = build_sharded_smc_step(std_normal_logpdf_sum, fresh_target(),
                                  mesh)
    sizes = []
    for seed in range(2):
        parts, lw, logz, infos = smc_sample_sharded(
            fresh_target(), jax.random.PRNGKey(seed), mesh, dim=2,
            num_particles=2048, step=step, dtype=DT)
        true_logz = 2 * 0.5 * np.log(2 * np.pi)
        assert abs(float(logz) - true_logz) < 0.15
        sizes.append(step._cache_size())
    # One compile total: the second call (fresh closure identity) hits
    # the same compiled step + ladder.
    assert sizes[1] == sizes[0], sizes
    assert sizes[0] <= 1, sizes


# ------------------------------------------------------------------
# The trainers under a batch-sharded mesh: batches sharded, params
# replicated, gradient psum inserted by XLA. Equivalence gates vs the
# unsharded runs; replication of the outputs is machine-checked.

def _assert_tree_replicated(tree, name):
    from enflows_tpu.utils import assert_replicated_consistent
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        assert_replicated_consistent(leaf, f"{name}[{i}]")


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_whitening_elementwise_sharded_matches_unsharded(n_shards):
    import optax
    from enflows_tpu import ScaleShift, Johnson, compose
    from enflows_tpu.train import optimize_whitening

    F = jnp.float32
    flow = compose(
        Johnson(gamma=jnp.zeros(2, F), delta=5.0 * jnp.ones(2, F),
                xi=jnp.zeros(2, F), lam=5.0 * jnp.ones(2, F)),
        ScaleShift(a=jnp.ones(2, F), b=jnp.zeros(2, F)))
    X = 1.5 * jax.random.normal(jax.random.PRNGKey(3), (4096, 2), F)
    m = make_mesh({"batch": n_shards}, devices=jax.devices()[:n_shards],
                  axis_name="batch")
    r_sh = optimize_whitening(X, flow, optax.adagrad(0.05), nbatches=4,
                              nepochs=2, mesh=m)
    r_un = optimize_whitening(X, flow, optax.adagrad(0.05), nbatches=4,
                              nepochs=2)
    np.testing.assert_allclose(np.asarray(r_sh.negll_history),
                               np.asarray(r_un.negll_history),
                               rtol=2e-5, atol=2e-6)
    for a, b in zip(jax.tree.leaves(r_sh.result),
                    jax.tree.leaves(r_un.result)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-5)
    # The trained flow must come back replicated — machine-check it.
    _assert_tree_replicated(r_sh.result, "whitening.flow")
    _assert_tree_replicated(r_sh.negll_history, "whitening.history")


def test_whitening_coupling_sharded_matches_unsharded():
    import optax
    from enflows_tpu.bijectors import coupling_stack
    from enflows_tpu.train import optimize_whitening

    dim = 4
    key = jax.random.PRNGKey(11)
    X = jax.random.normal(key, (2048, dim), jnp.float32)
    stack = coupling_stack(jax.random.fold_in(key, 1), dim,
                           n_layers=2, hidden=(8, 8))
    m = make_mesh({"batch": 8}, axis_name="batch")
    r_sh = optimize_whitening(X, stack, optax.adam(3e-3), nbatches=2,
                              nepochs=2, mesh=m)
    r_un = optimize_whitening(X, stack, optax.adam(3e-3), nbatches=2,
                              nepochs=2)
    np.testing.assert_allclose(np.asarray(r_sh.negll_history),
                               np.asarray(r_un.negll_history),
                               rtol=2e-5, atol=2e-6)
    for a, b in zip(jax.tree.leaves(r_sh.result),
                    jax.tree.leaves(r_un.result)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)
    _assert_tree_replicated(r_sh.result, "whitening.coupling.flow")


def test_vi_coupling_sharded_matches_unsharded():
    import optax
    from enflows_tpu.bijectors import coupling_stack
    from enflows_tpu.train import optimize_elbo

    dim = 4
    flow = coupling_stack(jax.random.PRNGKey(5), dim, n_layers=2,
                          hidden=(8, 8))
    logp = lambda z: -0.5 * jnp.sum((z - 1.0) ** 2, axis=-1)
    m = make_mesh({"batch": 8}, axis_name="batch")
    kw = dict(dim=dim, batch_size=128, nsteps=3,
              optimizer=optax.adam(3e-3))
    r_sh = optimize_elbo(logp, flow, mesh=m, **kw)
    r_un = optimize_elbo(logp, flow, **kw)
    np.testing.assert_allclose(np.asarray(r_sh.nelbo_history),
                               np.asarray(r_un.nelbo_history),
                               rtol=2e-5, atol=2e-6)
    for a, b in zip(jax.tree.leaves(r_sh.result),
                    jax.tree.leaves(r_un.result)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)
    _assert_tree_replicated(r_sh.result, "vi.flow")

    # STL under the mesh: the scale-corrected history still matches the
    # unsharded STL run.
    r_sh2 = optimize_elbo(logp, flow, mesh=m, stl=True, **kw)
    r_un2 = optimize_elbo(logp, flow, stl=True, **kw)
    np.testing.assert_allclose(np.asarray(r_sh2.nelbo_history),
                               np.asarray(r_un2.nelbo_history),
                               rtol=2e-5, atol=2e-6)
