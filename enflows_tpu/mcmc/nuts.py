"""Multinomial No-U-Turn Sampler, iterative, jit/vmap/shard-compatible.

No reference counterpart (SURVEY.md §2b / §7 M2; hard part (b)): recursion
is re-expressed as fixed-depth iteration so the whole transition compiles to
one XLA while-loop nest, and chains stay lockstep under `vmap`/`shard_map`.

Algorithm: multinomial NUTS (Betancourt 2017 flavor): trajectories double in
a random direction up to ``max_depth`` times; leaves are weighted by
exp(-H); proposals are drawn by progressive multinomial sampling with the
biased merge rule; doubling stops at a U-turn or divergence.

U-turn checks inside a subtree use an O(max_depth) checkpoint stack instead
of recursion. Scheme (derived for this implementation): leaves of the
growing subtree are indexed n = 0, 1, ...; a complete binary sub-subtree of
size 2^k closing at leaf n exists iff the low k bits of n are all ones, with
left end m = n & ~(2^k - 1). Since popcount(m) = popcount(n) - k, storing
each even leaf m's (momentum, momentum-prefix-sum) at stack slot popcount(m)
makes every closing subtree's left-end data live at slots
popcount(n)-tau .. popcount(n)-1 (tau = trailing ones of n) exactly when
needed, and no intermediate write can clobber a slot before its read (any
even m' in (m, n] has popcount(m') > popcount(m)). A sub-subtree [m..n] is
turning when dot(v_m, rho) <= 0 or dot(v_n, rho) <= 0 with
rho = S_n - S_{m-1} the summed momentum over the sub-subtree.

Merge-boundary checks (Stan's extra conditions, stan-dev/stan
base_nuts.hpp transition()): every merge of two half-trees [m..mid],
[mid+1..n] additionally tests the two straddling combinations
  dot(v_m,     rho_left  + p_{mid+1}) / dot(v_{mid+1}, ...)   and
  dot(v_mid,   rho_right + p_mid)     / dot(v_n,       ...),
which catch U-turns that the endpoints-only test misses on highly
correlated targets (trajectories otherwise run past the turn, wasting
gradient evaluations). Inside a growing subtree these need two extra
facts at close time: the momentum at mid+1 — an even leaf, already in the
checkpoint stack at slot popcount(m)+1, which a popcount argument shows is
never clobbered before the read — and the momentum at mid, an odd leaf
with exactly k-1 trailing ones, kept in a second O(max_depth) stack
indexed by trailing-ones count (odd leaves n' strictly between mid and n
have fewer trailing ones, so that slot too survives until the read). At
the top-level trajectory merge the same two checks use the old
trajectory's endpoints and the new subtree's first/last momenta directly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .hmc import HMCState, kinetic_energy, sample_momentum


class NUTSInfo(NamedTuple):
    accept_prob: jax.Array      # mean leaf acceptance statistic (dual avg)
    divergent: jax.Array
    depth: jax.Array            # tree depth reached
    num_steps: jax.Array        # leapfrog steps taken
    energy: jax.Array           # H at the accepted proposal


def _popcount(n):
    return lax.population_count(n)


def _trailing_ones(n):
    # trailing ones of n == trailing zeros of ~n == popcount(n & ~(n+1))
    return lax.population_count(jnp.bitwise_and(n, ~(n + 1)))


def nuts_kernel(logdensity_fn: Callable, max_depth: int = 10,
                divergence_threshold: float = 1000.0,
                extra_uturn_checks: bool = True):
    """Build a one-transition NUTS kernel:
    (key, state, step_size, inv_mass_diag) -> (state, info).

    ``extra_uturn_checks``: Stan's merge-boundary conditions (module
    docstring). On by default; the False path exists for A/B benchmarking
    (benchmarks/bench_mcmc.py records ESS-per-gradient for both)."""
    value_grad_fn = jax.value_and_grad(logdensity_fn)

    def make_helpers(inv_mass_diag):
        def leapfrog_step(q, p, grad, eps):
            p_half = p + 0.5 * eps * grad
            q_new = q + eps * p_half * inv_mass_diag
            logp_new, grad_new = value_grad_fn(q_new)
            p_new = p_half + 0.5 * eps * grad_new
            return q_new, p_new, logp_new, grad_new

        def is_turning(v_left, v_right, rho):
            return (jnp.dot(v_left, rho) <= 0.0) | (jnp.dot(v_right, rho) <= 0.0)

        def build_subtree(key, q0, p0, grad0, eps, num_leaves, energy0):
            """Extend ``num_leaves`` leapfrog steps from (q0, p0); progressive
            multinomial proposal, checkpointed U-turn checks, divergence check.

            Returns end state, subtree proposal, log weight, rho, flags, and the
            summed leaf-acceptance statistic.
            """
            dim = q0.shape[0]
            dtype = q0.dtype
            ckpt_p = jnp.zeros((max_depth + 1, dim), dtype)
            ckpt_S = jnp.zeros((max_depth + 1, dim), dtype)
            ckpt_podd = jnp.zeros((max_depth + 1, dim), dtype)

            def cond(carry):
                n = carry[0]
                turning, divergent = carry[14], carry[15]
                return (n < num_leaves) & ~turning & ~divergent

            def body(carry):
                (n, key, q, p, grad, prop_q, prop_logp, prop_grad, prop_h,
                 log_w, rho, S, cv, p_first, turning, divergent,
                 sum_prob) = carry
                ckpt_p_, ckpt_S_, ckpt_podd_ = cv

                q, p, logp, grad = leapfrog_step(q, p, grad, eps)
                h = -logp + kinetic_energy(p, inv_mass_diag)
                delta = energy0 - h
                delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
                divergent_new = -delta > divergence_threshold
                log_w_leaf = delta
                sum_prob = sum_prob + jnp.minimum(1.0, jnp.exp(delta))

                # Progressive multinomial sampling within the subtree.
                log_w_new = jnp.logaddexp(log_w, log_w_leaf)
                key, k_sel = jax.random.split(key)
                take = (jnp.log(jax.random.uniform(k_sel, (), dtype))
                        < log_w_leaf - log_w_new)
                prop_q = jnp.where(take, q, prop_q)
                prop_logp = jnp.where(take, logp, prop_logp)
                prop_grad = jnp.where(take, grad, prop_grad)
                prop_h = jnp.where(take, h, prop_h)

                v = p * inv_mass_diag
                p_first = jnp.where(n == 0, p, p_first)

                # Store checkpoint at even leaves (slot popcount(n)); S is the
                # momentum prefix sum *before* this leaf.
                pc = _popcount(n)
                is_even = (n % 2) == 0
                slot = jnp.where(is_even, pc, 0)
                ckpt_p_ = lax.cond(
                    is_even, lambda a: a.at[slot].set(p), lambda a: a, ckpt_p_)
                ckpt_S_ = lax.cond(
                    is_even, lambda a: a.at[slot].set(S), lambda a: a, ckpt_S_)

                S_new = S + p

                # Closing sub-subtrees at odd leaves: slots pc-tau .. pc-1.
                # For each closing [m..n] of size 2^(j+1) also run Stan's two
                # merge-boundary checks across the half boundary
                # [m..mid] | [mid+1..n] (see module docstring). For j == 0
                # all three coincide, so extras are gated on j >= 1.
                tau = _trailing_ones(n)

                def check(j, turn):
                    idx = pc - 1 - j
                    p_m = ckpt_p_[idx]
                    S_m = ckpt_S_[idx]
                    rho_sub = S_new - S_m
                    t = is_turning(p_m * inv_mass_diag, v, rho_sub)

                    if extra_uturn_checks:
                        extra = j >= 1
                        safe = jnp.minimum(idx + 1, max_depth)
                        p_b = ckpt_p_[safe]      # momentum at mid+1 (even)
                        S_mid = ckpt_S_[safe]    # prefix through mid
                        p_mid = ckpt_podd_[jnp.minimum(jnp.maximum(j, 1),
                                                       max_depth)]
                        rho_bck = S_mid - S_m
                        rho_fwd = S_new - S_mid
                        t_a = is_turning(p_m * inv_mass_diag,
                                         p_b * inv_mass_diag, rho_bck + p_b)
                        t_b = is_turning(p_mid * inv_mass_diag, v,
                                         rho_fwd + p_mid)
                        t = t | (extra & (t_a | t_b))
                    return turn | ((j < tau) & t)

                turning_new = lax.cond(
                    is_even, lambda: jnp.asarray(False),
                    lambda: lax.fori_loop(0, max_depth, check,
                                          jnp.asarray(False)))

                # Record this odd leaf's momentum for future boundary checks
                # (slot = its trailing-ones count; written after the checks).
                ckpt_podd_ = lax.cond(
                    is_even, lambda a: a,
                    lambda a: a.at[jnp.minimum(tau, max_depth)].set(p),
                    ckpt_podd_)

                return (n + 1, key, q, p, grad, prop_q, prop_logp, prop_grad,
                        prop_h, log_w_new, rho + p, S_new,
                        (ckpt_p_, ckpt_S_, ckpt_podd_), p_first,
                        turning | turning_new, divergent | divergent_new,
                        sum_prob)

            neg_inf = jnp.asarray(-jnp.inf, dtype)
            init = (jnp.asarray(0, jnp.int32), key, q0, p0, grad0,
                    q0, jnp.zeros((), dtype), grad0, energy0,
                    neg_inf, jnp.zeros_like(p0), jnp.zeros_like(p0),
                    (ckpt_p, ckpt_S, ckpt_podd), p0,
                    jnp.asarray(False), jnp.asarray(False),
                    jnp.zeros((), dtype))
            out = lax.while_loop(cond, body, init)
            (n, _, q, p, grad, prop_q, prop_logp, prop_grad, prop_h,
             log_w, rho, _, _, p_first, turning, divergent, sum_prob) = out
            return dict(n=n, q_end=q, p_end=p, grad_end=grad,
                        prop_q=prop_q, prop_logp=prop_logp, prop_grad=prop_grad,
                        prop_h=prop_h, log_w=log_w, rho=rho, p_first=p_first,
                        turning=turning, divergent=divergent,
                        sum_prob=sum_prob)

        return leapfrog_step, is_turning, build_subtree

    def kernel(key, state: HMCState, step_size, inv_mass_diag):
        leapfrog_step, is_turning, build_subtree = make_helpers(inv_mass_diag)
        dtype = state.q.dtype
        key_mom, key_tree = jax.random.split(key)
        p0 = sample_momentum(key_mom, inv_mass_diag, state.q.shape, dtype)
        energy0 = -state.logp + kinetic_energy(p0, inv_mass_diag)

        # Trajectory state: endpoints, total rho, proposal, log weight.
        init = dict(
            key=key_tree,
            q_left=state.q, p_left=p0, grad_left=state.grad,
            q_right=state.q, p_right=p0, grad_right=state.grad,
            rho=p0,
            prop_q=state.q, prop_logp=state.logp, prop_grad=state.grad,
            prop_energy=energy0,
            log_w=jnp.zeros((), dtype),       # leaf 0 weight = exp(0)
            depth=jnp.asarray(0, jnp.int32),
            num_steps=jnp.asarray(0, jnp.int32),
            turning=jnp.asarray(False), divergent=jnp.asarray(False),
            sum_prob=jnp.zeros((), dtype),
            sum_leaves=jnp.zeros((), dtype),
        )

        def cond(c):
            return ((c["depth"] < max_depth)
                    & ~c["turning"] & ~c["divergent"])

        def body(c):
            key, k_dir, k_sub, k_merge = jax.random.split(c["key"], 4)
            go_right = jax.random.bernoulli(k_dir)
            num_leaves = jnp.asarray(1, jnp.int32) << c["depth"]

            q0 = jnp.where(go_right, c["q_right"], c["q_left"])
            p0 = jnp.where(go_right, c["p_right"], c["p_left"])
            g0 = jnp.where(go_right, c["grad_right"], c["grad_left"])
            eps = jnp.where(go_right, step_size, -step_size).astype(q0.dtype)

            sub = build_subtree(k_sub, q0, p0, g0, eps, num_leaves, energy0)

            stop_bad = sub["turning"] | sub["divergent"]

            # Merge endpoints.
            q_right = jnp.where(go_right, sub["q_end"], c["q_right"])
            p_right = jnp.where(go_right, sub["p_end"], c["p_right"])
            g_right = jnp.where(go_right, sub["grad_end"], c["grad_right"])
            q_left = jnp.where(go_right, c["q_left"], sub["q_end"])
            p_left = jnp.where(go_right, c["p_left"], sub["p_end"])
            g_left = jnp.where(go_right, c["grad_left"], sub["grad_end"])

            # Biased progressive merge: prefer the new subtree.
            accept_new = (jnp.log(jax.random.uniform(k_merge, (), q0.dtype))
                          < sub["log_w"] - c["log_w"])
            take = accept_new & ~stop_bad
            prop_q = jnp.where(take, sub["prop_q"], c["prop_q"])
            prop_logp = jnp.where(take, sub["prop_logp"], c["prop_logp"])
            prop_grad = jnp.where(take, sub["prop_grad"], c["prop_grad"])
            prop_energy = jnp.where(take, sub["prop_h"], c["prop_energy"])

            rho = c["rho"] + sub["rho"]
            v_left = p_left * inv_mass_diag
            v_right = p_right * inv_mass_diag
            turning_total = is_turning(v_left, v_right, rho)

            if extra_uturn_checks:
                # Stan's merge-boundary checks between the old trajectory
                # and the new subtree (trajectory order: left half = old
                # traj when going right, = new subtree when going left).
                # p_first is the momentum at the subtree leaf adjacent to
                # the old endpoint.
                p_lh_l = jnp.where(go_right, c["p_left"], sub["p_end"])
                p_rh_l = jnp.where(go_right, sub["p_first"], c["p_left"])
                rho_lh = jnp.where(go_right, c["rho"], sub["rho"])
                t_a = is_turning(p_lh_l * inv_mass_diag,
                                 p_rh_l * inv_mass_diag, rho_lh + p_rh_l)
                p_lh_r = jnp.where(go_right, c["p_right"], sub["p_first"])
                p_rh_r = jnp.where(go_right, sub["p_end"], c["p_right"])
                rho_rh = jnp.where(go_right, sub["rho"], c["rho"])
                t_b = is_turning(p_lh_r * inv_mass_diag,
                                 p_rh_r * inv_mass_diag, rho_rh + p_lh_r)
                turning_total = turning_total | t_a | t_b

            return dict(
                key=key,
                q_left=q_left, p_left=p_left, grad_left=g_left,
                q_right=q_right, p_right=p_right, grad_right=g_right,
                rho=rho,
                prop_q=prop_q, prop_logp=prop_logp, prop_grad=prop_grad,
                prop_energy=prop_energy,
                log_w=jnp.where(stop_bad, c["log_w"],
                                jnp.logaddexp(c["log_w"], sub["log_w"])),
                depth=c["depth"] + 1,
                num_steps=c["num_steps"] + sub["n"],
                turning=c["turning"] | sub["turning"] | turning_total,
                divergent=c["divergent"] | sub["divergent"],
                sum_prob=c["sum_prob"] + sub["sum_prob"],
                sum_leaves=c["sum_leaves"] + sub["n"].astype(dtype),
            )

        with jax.named_scope("enflows.mcmc.nuts_transition"):
            out = lax.while_loop(cond, body, init)

        new_state = HMCState(q=out["prop_q"], logp=out["prop_logp"],
                             grad=out["prop_grad"])
        n_leaves = jnp.maximum(out["sum_leaves"], 1.0)
        info = NUTSInfo(
            accept_prob=out["sum_prob"] / n_leaves,
            divergent=out["divergent"],
            depth=out["depth"],
            num_steps=out["num_steps"],
            energy=out["prop_energy"],
        )
        return new_state, info

    return kernel
