"""On-device MCMC over HOD parameters.

The reference is "ideally suited for MCMC exploration" (reference README)
but leaves the sampler to the user (emcee on the host, one ~1 ms predict
per walker per step).  Here entire ensembles advance in one jitted kernel
per step:

* :func:`run_ensemble` — affine-invariant stretch-move ensemble sampler
  (Goodman & Weare 2010, the emcee algorithm) with the two-half update
  scheme, vmapped over walkers, ``lax.scan`` over steps.
* :func:`run_hmc` — Hamiltonian Monte Carlo with leapfrog integration;
  gradients of the log posterior flow through the prediction kernels for
  free.

Both samplers take a pure ``log_prob_fn(params_vector) -> float`` and work
on (n_walkers, n_dim) position arrays.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _stretch_half(key, active, passive, log_prob_active, log_prob_fn, a,
                  vectorized=False):
    """Goodman & Weare stretch move of ``active`` against ``passive``."""
    n_active = active.shape[0]
    key_z, key_pick, key_accept = jax.random.split(key, 3)

    # z ~ g(z) proportional to 1/sqrt(z) on [1/a, a].
    u = jax.random.uniform(key_z, (n_active,))
    z = ((a - 1.0) * u + 1.0) ** 2 / a

    picks = jax.random.randint(key_pick, (n_active,), 0, passive.shape[0])
    proposal = passive[picks] + z[:, None] * (active - passive[picks])

    log_prob_prop = (log_prob_fn(proposal) if vectorized
                     else jax.vmap(log_prob_fn)(proposal))
    n_dim = active.shape[1]
    log_accept = ((n_dim - 1.0) * jnp.log(z) +
                  log_prob_prop - log_prob_active)
    accept = jnp.log(jax.random.uniform(key_accept, (n_active,))) < log_accept

    new = jnp.where(accept[:, None], proposal, active)
    new_log_prob = jnp.where(accept, log_prob_prop, log_prob_active)
    return new, new_log_prob, accept


def ensemble_step(key, walkers, log_prob, log_prob_fn, a=2.0,
                  vectorized=False):
    """One stretch-move step over all walkers (two-half scheme).

    Parameters
    ----------
    key : jax.random key
    walkers : (n_walkers, n_dim)
    log_prob : (n_walkers,) current log probabilities
    log_prob_fn : callable (n_dim,) -> scalar, pure; with
        ``vectorized=True``, callable (B, n_dim) -> (B,) evaluated on the
        whole half-ensemble at once (e.g. a joint multi-table likelihood)
    a : float, stretch scale parameter

    Returns
    -------
    (walkers, log_prob, accept_fraction)
    """
    n = walkers.shape[0] // 2
    key_1, key_2 = jax.random.split(key)

    first, second = walkers[:n], walkers[n:]
    lp_first, lp_second = log_prob[:n], log_prob[n:]

    first, lp_first, acc_1 = _stretch_half(
        key_1, first, second, lp_first, log_prob_fn, a, vectorized)
    second, lp_second, acc_2 = _stretch_half(
        key_2, second, first, lp_second, log_prob_fn, a, vectorized)

    walkers = jnp.concatenate([first, second])
    log_prob = jnp.concatenate([lp_first, lp_second])
    accept = jnp.concatenate([acc_1, acc_2]).mean()
    return walkers, log_prob, accept


@partial(jax.jit, static_argnames=("log_prob_fn", "n_steps", "thin",
                                   "vectorized"))
def run_ensemble(key, log_prob_fn, walkers0, n_steps, a=2.0, thin=1,
                 vectorized=False):
    """Run the stretch-move ensemble sampler.

    ``vectorized=True`` treats ``log_prob_fn`` as a batched
    (B, n_dim) -> (B,) likelihood (e.g. built by
    :func:`make_gaussian_logpost_batched` around a multi-table
    predictor) and evaluates each half-ensemble in one call.

    Returns
    -------
    chain : (n_steps // thin, n_walkers, n_dim)
    log_prob : (n_steps // thin, n_walkers)
    accept_fraction : scalar, mean over all steps
    """
    log_prob = (log_prob_fn(walkers0) if vectorized
                else jax.vmap(log_prob_fn)(walkers0))

    def body(carry, key_step):
        walkers, log_prob = carry

        def inner(carry_inner, key_inner):
            w, lp = carry_inner
            w, lp, acc = ensemble_step(key_inner, w, lp, log_prob_fn, a,
                                       vectorized)
            return (w, lp), acc

        keys = jax.random.split(key_step, thin)
        (walkers, log_prob), accs = jax.lax.scan(
            inner, (walkers, log_prob), keys)
        return (walkers, log_prob), (walkers, log_prob, accs.mean())

    keys = jax.random.split(key, n_steps // thin)
    (_, _), (chain, chain_lp, accs) = jax.lax.scan(
        body, (walkers0, log_prob), keys)
    return chain, chain_lp, accs.mean()


def hmc_step(key, position, log_prob_fn, step_size, n_leapfrog):
    """One HMC step: leapfrog + Metropolis accept. Position: (n_dim,)."""
    key_mom, key_accept = jax.random.split(key)
    grad_fn = jax.grad(log_prob_fn)

    momentum = jax.random.normal(key_mom, position.shape,
                                 dtype=position.dtype)
    lp0 = log_prob_fn(position)
    h0 = lp0 - 0.5 * jnp.sum(momentum**2)

    def leapfrog(carry, _):
        q, p = carry
        p = p + 0.5 * step_size * grad_fn(q)
        q = q + step_size * p
        p = p + 0.5 * step_size * grad_fn(q)
        return (q, p), None

    (q_new, p_new), _ = jax.lax.scan(
        leapfrog, (position, momentum), None, length=n_leapfrog)

    lp_new = log_prob_fn(q_new)
    h_new = lp_new - 0.5 * jnp.sum(p_new**2)
    accept = (jnp.log(jax.random.uniform(key_accept, ())) <
              h_new - h0)
    position = jnp.where(accept, q_new, position)
    return position, jnp.where(accept, lp_new, lp0), accept


@partial(jax.jit,
         static_argnames=("log_prob_fn", "n_steps", "n_leapfrog"))
def run_hmc(key, log_prob_fn, positions0, n_steps, step_size=0.01,
            n_leapfrog=10):
    """Vmapped multi-chain HMC. positions0: (n_chains, n_dim).

    Returns (chain (n_steps, n_chains, n_dim), log_prob, accept_fraction).
    """
    def body(positions, key_step):
        keys = jax.random.split(key_step, positions.shape[0])
        positions, lp, acc = jax.vmap(
            lambda k, q: hmc_step(k, q, log_prob_fn, step_size, n_leapfrog)
        )(keys, positions)
        return positions, (positions, lp, acc.mean())

    keys = jax.random.split(key, n_steps)
    _, (chain, chain_lp, accs) = jax.lax.scan(body, positions0, keys)
    return chain, chain_lp, accs.mean()


@partial(jax.jit,
         static_argnames=("log_prob_fn", "n_warmup", "n_steps",
                          "n_leapfrog"))
def run_hmc_adaptive(key, log_prob_fn, positions0, n_warmup, n_steps,
                     n_leapfrog=10, initial_step_size=0.1,
                     target_accept=0.8):
    """HMC with dual-averaging step-size adaptation during warmup.

    Implements the Nesterov dual-averaging scheme of Hoffman & Gelman
    (2014, the NUTS paper, algorithm 5) to tune the leapfrog step size to
    ``target_accept`` over ``n_warmup`` vmapped multi-chain steps, then
    samples ``n_steps`` with the adapted (frozen) step size.

    Returns (chain (n_steps, n_chains, n_dim), log_prob, accept_fraction,
    step_size).
    """
    gamma, t0, kappa = 0.05, 10.0, 0.75
    mu = jnp.log(10.0 * initial_step_size)

    def multi_step(key_step, positions, step_size):
        keys = jax.random.split(key_step, positions.shape[0])
        positions, lp, acc = jax.vmap(
            lambda k, q: hmc_step(k, q, log_prob_fn, step_size,
                                  n_leapfrog))(keys, positions)
        return positions, lp, acc.mean()

    def warmup_body(carry, key_step):
        positions, log_eps, log_eps_bar, h_bar, t = carry
        positions, _, accept = multi_step(key_step, positions,
                                          jnp.exp(log_eps))
        t = t + 1.0
        h_bar = ((1.0 - 1.0 / (t + t0)) * h_bar +
                 (target_accept - accept) / (t + t0))
        log_eps = mu - jnp.sqrt(t) / gamma * h_bar
        eta = t ** -kappa
        log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
        return (positions, log_eps, log_eps_bar, h_bar, t), accept

    key_warm, key_sample = jax.random.split(key)
    carry0 = (positions0, jnp.log(initial_step_size),
              jnp.log(initial_step_size), 0.0, 0.0)
    (positions, _, log_eps_bar, _, _), _ = jax.lax.scan(
        warmup_body, carry0, jax.random.split(key_warm, n_warmup))
    step_size = jnp.exp(log_eps_bar)

    def body(positions, key_step):
        positions, lp, acc = multi_step(key_step, positions, step_size)
        return positions, (positions, lp, acc)

    _, (chain, chain_lp, accs) = jax.lax.scan(
        body, positions, jax.random.split(key_sample, n_steps))
    return chain, chain_lp, accs.mean(), step_size


# ----------------------------------------------------------------------
# NUTS (No-U-Turn Sampler)
# ----------------------------------------------------------------------
def _leapfrog(q, p, grad, step_size, log_prob_fn, inv_mass=1.0):
    p_half = p + 0.5 * step_size * grad
    q_new = q + step_size * (inv_mass * p_half)
    logp_new, grad_new = jax.value_and_grad(log_prob_fn)(q_new)
    p_new = p_half + 0.5 * step_size * grad_new
    return q_new, p_new, logp_new, grad_new


def _uturn(q_left, p_left, q_right, p_right, inv_mass=1.0):
    # Generalized criterion: angles against VELOCITIES M^-1 p (reduces
    # to the Euclidean form for the identity metric).
    dq = q_right - q_left
    return ((jnp.dot(dq, inv_mass * p_left) < 0) |
            (jnp.dot(dq, inv_mass * p_right) < 0))


def _tz_count(x, max_bits):
    """Trailing-zero count of positive int32 ``x``, capped at max_bits."""
    tz = jnp.zeros((), jnp.int32)
    for b in range(1, max_bits + 1):
        tz = tz + ((x & ((1 << b) - 1)) == 0).astype(jnp.int32)
    return tz


def _build_subtree_iter(key, q0, p0, lp0, g0, depth, step_size,
                        log_prob_fn, h0, inv_mass, max_depth):
    """One NUTS subtree of dynamic size ``2^depth``, built ITERATIVELY.

    Implements the Hoffman & Gelman (2014) doubling subtree with
    multinomial state sampling (Betancourt 2017) as a single
    ``lax.while_loop`` over leapfrog steps, exiting EARLY on the first
    internal U-turn or divergence — unlike a statically unrolled tree,
    which always pays all 2^depth gradient evaluations.  Internal dyadic
    U-turn checks use the checkpoint-stack scheme (Phan et al. 2019,
    numpyro's iterative NUTS): a dyadic interval of length ``2^l`` ends
    at leaf ``i`` iff the low ``l`` bits of ``i`` are ones, and its start
    leaf ``s = i + 1 - 2^l`` (low ``l`` bits zero) is still live in slot
    ``tz(s)`` of an O(max_depth) checkpoint stack when the check runs.

    Integration happens in the direction-flipped frame (``p`` here is
    ``direction * p_physical``): standard forward leapfrog then applies,
    and the U-turn dot products are frame-invariant, so no per-leaf sign
    juggling is needed.  Returns the OUTWARD end state (flipped-frame
    momentum), the subtree proposal, its log weight, the bad flag
    (turned/divergent), the accumulated accept statistic, and the number
    of leapfrog steps actually executed.
    """
    n_dim = q0.shape[0]
    n_leaf = (jnp.int32(1) << depth).astype(jnp.int32)
    dtype = q0.dtype

    carry = dict(
        i=jnp.int32(0),
        q=q0, p=p0, lp=lp0, g=g0,
        q_prop=q0, lp_prop=lp0,
        log_sum_w=jnp.full((), -jnp.inf, dtype),
        bad=jnp.bool_(False),
        alpha_sum=jnp.zeros((), dtype),
        n_alpha=jnp.zeros((), dtype),
        stack_q=jnp.zeros((max_depth + 1, n_dim), dtype),
        stack_v=jnp.zeros((max_depth + 1, n_dim), dtype),
    )

    def cond(c):
        return (c["i"] < n_leaf) & ~c["bad"]

    def body(c):
        i = c["i"]
        q, p, lp, g = _leapfrog(c["q"], c["p"], c["g"], step_size,
                                log_prob_fn, inv_mass)
        v = inv_mass * p
        h = -lp + 0.5 * jnp.sum(p * v)
        # NaN-safe: a NaN Hamiltonian must count as divergent —
        # `(h - h0) > 1000` is False for NaN and would poison the
        # subtree weights and disable termination.
        divergent = ~((h - h0) <= 1000.0)
        log_w = jnp.where(divergent, -jnp.inf, h0 - h)
        alpha = jnp.minimum(1.0, jnp.exp(h0 - h))
        alpha = jnp.where(jnp.isnan(alpha), 0.0, alpha)

        # Multinomial proposal within the subtree.
        log_sum = jnp.logaddexp(c["log_sum_w"], log_w)
        u = jax.random.uniform(jax.random.fold_in(key, i), ())
        take = jnp.log(u) < log_w - log_sum
        q_prop = jnp.where(take, q, c["q_prop"])
        lp_prop = jnp.where(take, lp, c["lp_prop"])

        # Checkpoint this leaf if it starts any dyadic interval.
        slot = jnp.where(i == 0, jnp.int32(max_depth),
                         _tz_count(jnp.maximum(i, 1), max_depth))
        stack_q = jax.lax.dynamic_update_index_in_dim(
            c["stack_q"], q, slot, axis=0)
        stack_v = jax.lax.dynamic_update_index_in_dim(
            c["stack_v"], v, slot, axis=0)

        # U-turn checks for every dyadic interval ending at this leaf.
        turning = jnp.bool_(False)
        trailing_ones = _tz_count(i + 1, max_depth)
        for level in range(1, max_depth + 1):
            active = (level <= trailing_ones) & (level <= depth)
            s = i + 1 - (jnp.int32(1) << jnp.minimum(level, depth))
            s_slot = jnp.where(s == 0, jnp.int32(max_depth),
                               _tz_count(jnp.maximum(s, 1), max_depth))
            q_s = jax.lax.dynamic_index_in_dim(stack_q, s_slot, axis=0,
                                               keepdims=False)
            v_s = jax.lax.dynamic_index_in_dim(stack_v, s_slot, axis=0,
                                               keepdims=False)
            dq = q - q_s
            turning |= active & ((jnp.dot(dq, v_s) < 0) |
                                 (jnp.dot(dq, v) < 0))

        return dict(
            i=i + 1, q=q, p=p, lp=lp, g=g,
            q_prop=q_prop, lp_prop=lp_prop, log_sum_w=log_sum,
            bad=divergent | turning,
            alpha_sum=c["alpha_sum"] + alpha,
            n_alpha=c["n_alpha"] + 1.0,
            stack_q=stack_q, stack_v=stack_v)

    out = jax.lax.while_loop(cond, body, carry)
    return (out["q"], out["p"], out["lp"], out["g"],
            out["q_prop"], out["lp_prop"], out["log_sum_w"], out["bad"],
            out["alpha_sum"], out["n_alpha"], out["i"])


def nuts_step(key, q, log_prob_fn, step_size, max_depth=6, inv_mass=None):
    """One No-U-Turn step for a single chain (dynamic doubling).

    Both the doubling loop and each subtree are ``lax.while_loop``s, so a
    trajectory stops paying gradient evaluations the moment it turns or
    diverges (under ``vmap`` the cost is the max over chains, still far
    below the statically unrolled 2^max_depth).  ``inv_mass`` is an
    optional diagonal inverse metric (momenta ~ N(0, M), kinetic energy
    p^T M^-1 p / 2, U-turns against velocities M^-1 p).

    Returns (q_new, logp_new, depth_reached, accept_stat, n_grad) where
    accept_stat is the mean Metropolis statistic over the trajectory's
    leapfrog states (Hoffman & Gelman 2014, algorithm 6) and n_grad the
    number of leapfrog gradient evaluations spent.
    """
    if inv_mass is None:
        inv_mass = jnp.ones((), q.dtype)
    key_mom, key_tree = jax.random.split(key)
    p = (jax.random.normal(key_mom, q.shape, dtype=q.dtype) /
         jnp.sqrt(inv_mass))
    logp, grad = jax.value_and_grad(log_prob_fn)(q)
    h0 = -logp + 0.5 * jnp.sum(p * (inv_mass * p))

    state = dict(q_l=q, p_l=p, lp_l=logp, g_l=grad,
                 q_r=q, p_r=p, lp_r=logp, g_r=grad,
                 q_prop=q, lp_prop=logp,
                 log_sum_w=jnp.zeros((), q.dtype),
                 done=jnp.bool_(False),
                 depth=jnp.zeros((), jnp.int32),
                 alpha_sum=jnp.zeros((), q.dtype),
                 n_alpha=jnp.zeros((), q.dtype),
                 n_grad=jnp.zeros((), jnp.int32))

    def outer_cond(state):
        return ~state["done"] & (state["depth"] < max_depth)

    def outer_body(state):
        key_step = jax.random.fold_in(key_tree, state["depth"])
        key_dir, key_sub, key_pick = jax.random.split(key_step, 3)
        direction = jnp.where(jax.random.bernoulli(key_dir), 1.0, -1.0)
        direction = direction.astype(q.dtype)

        q_0 = jnp.where(direction > 0, state["q_r"], state["q_l"])
        p_0 = jnp.where(direction > 0, state["p_r"], state["p_l"])
        lp_0 = jnp.where(direction > 0, state["lp_r"], state["lp_l"])
        g_0 = jnp.where(direction > 0, state["g_r"], state["g_l"])

        # Flipped frame: momenta carry the direction sign, the leapfrog
        # step stays positive (see _build_subtree_iter).
        (t_q, t_p, t_lp, t_g, t_qp, t_lpp, t_lw, t_bad, t_alpha, t_n,
         t_steps) = _build_subtree_iter(
            key_sub, q_0, p_0 * direction, lp_0, g_0,
            state["depth"], step_size, log_prob_fn, h0,
            inv_mass, max_depth)
        t_p = t_p * direction          # back to the physical frame

        # Multinomial proposal swap across the doubling.
        log_sum = jnp.logaddexp(state["log_sum_w"], t_lw)
        take_new = ((jnp.log(jax.random.uniform(key_pick, ())) <
                     t_lw - log_sum) & ~t_bad)
        grow = ~t_bad

        def pick(new, old, cond_):
            return jnp.where(cond_, new, old)

        new_right = grow & (direction > 0)
        new_left = grow & (direction < 0)
        q_l = pick(t_q, state["q_l"], new_left)
        p_l = pick(t_p, state["p_l"], new_left)
        q_r = pick(t_q, state["q_r"], new_right)
        p_r = pick(t_p, state["p_r"], new_right)
        return dict(
            q_l=q_l, p_l=p_l,
            lp_l=pick(t_lp, state["lp_l"], new_left),
            g_l=pick(t_g, state["g_l"], new_left),
            q_r=q_r, p_r=p_r,
            lp_r=pick(t_lp, state["lp_r"], new_right),
            g_r=pick(t_g, state["g_r"], new_right),
            q_prop=pick(t_qp, state["q_prop"], take_new),
            lp_prop=pick(t_lpp, state["lp_prop"], take_new),
            log_sum_w=jnp.where(grow, log_sum, state["log_sum_w"]),
            done=t_bad | _uturn(q_l, p_l, q_r, p_r, inv_mass),
            depth=state["depth"] + jnp.where(grow, 1, 0),
            # Accept statistic accumulates over every attempted doubling
            # (the final, tree-terminating doubling included, as in
            # Hoffman & Gelman's algorithm 6).
            alpha_sum=state["alpha_sum"] + t_alpha,
            n_alpha=state["n_alpha"] + t_n,
            n_grad=state["n_grad"] + t_steps,
        )

    state = jax.lax.while_loop(outer_cond, outer_body, state)
    accept_stat = state["alpha_sum"] / jnp.maximum(state["n_alpha"], 1.0)
    return (state["q_prop"], state["lp_prop"], state["depth"],
            accept_stat, state["n_grad"])


@partial(jax.jit, static_argnames=("log_prob_fn", "n_warmup", "n_steps",
                                   "max_depth", "adapt_mass_matrix"))
def run_nuts(key, log_prob_fn, positions0, n_warmup, n_steps,
             max_depth=6, initial_step_size=0.1, target_accept=0.8,
             adapt_mass_matrix=False):
    """Multi-chain NUTS with dual-averaging step-size warmup.

    With ``adapt_mass_matrix=True`` the warmup follows a Stan-style
    three-phase schedule: (I) ~15% step-size-only adaptation with the
    identity metric, (II) ~70% collecting a Welford estimate of the
    posterior variance across all chains (step size still adapting),
    after which the diagonal inverse metric is set to the regularized
    sample variance (Stan's ``var * n/(n+5) + 1e-3 * 5/(n+5)``), and
    (III) ~15% re-running dual averaging from scratch under the new
    metric (a metric change invalidates the previous step-size scale).

    Returns (chain (n_steps, n_chains, n_dim), log_prob, mean_depth,
    step_size).
    """
    gamma, t0, kappa = 0.05, 10.0, 0.75
    dtype = positions0.dtype
    n_dim = positions0.shape[-1]

    def multi_step(key_step, positions, step_size, inv_mass):
        keys = jax.random.split(key_step, positions.shape[0])
        q, lp, depth, accept, n_grad = jax.vmap(
            lambda k, x: nuts_step(k, x, log_prob_fn, step_size,
                                   max_depth, inv_mass))(keys, positions)
        return q, lp, depth, accept

    def dual_avg_update(da, accept, mu):
        log_eps, log_eps_bar, h_bar, t = da
        # Dual averaging on the accumulated Metropolis accept statistic
        # (mean alpha over all leapfrog states; Hoffman & Gelman 2014,
        # algorithm 6), averaged across chains.
        t = t + 1.0
        h_bar = ((1.0 - 1.0 / (t + t0)) * h_bar +
                 (target_accept - accept) / (t + t0))
        log_eps = mu - jnp.sqrt(t) / gamma * h_bar
        eta = t ** -kappa
        log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
        return (log_eps, log_eps_bar, h_bar, t)

    def warmup_scan(key_phase, positions, da, inv_mass, n, mu,
                    collect=False):
        welford0 = (jnp.zeros(n_dim, dtype), jnp.zeros(n_dim, dtype),
                    jnp.zeros((), dtype))

        def body(carry, key_step):
            positions, da, welford = carry
            positions, _, _, accept = multi_step(
                key_step, positions, jnp.exp(da[0]), inv_mass)
            da = dual_avg_update(da, accept.mean(), mu)
            if collect:
                mean, m2, count = welford
                for_stats = positions.astype(dtype)
                batch_mean = for_stats.mean(axis=0)
                count_new = count + 1.0
                delta = batch_mean - mean
                mean = mean + delta / count_new
                m2 = m2 + (for_stats.var(axis=0) +
                           delta * (batch_mean - mean))
                welford = (mean, m2, count_new)
            return (positions, da, welford), None

        (positions, da, welford), _ = jax.lax.scan(
            body, (positions, da, welford0),
            jax.random.split(key_phase, n))
        return positions, da, welford

    key_1, key_2, key_3, key_sample = jax.random.split(key, 4)
    da0 = (jnp.log(initial_step_size), jnp.log(initial_step_size),
           jnp.zeros((), dtype), jnp.zeros((), dtype))
    mu0 = jnp.log(10.0 * initial_step_size)
    inv_mass = jnp.ones(n_dim, dtype)

    if adapt_mass_matrix:
        n_1 = max(int(0.15 * n_warmup), 1)
        n_3 = max(int(0.15 * n_warmup), 1)
        n_2 = max(n_warmup - n_1 - n_3, 1)
        positions, da, _ = warmup_scan(key_1, positions0, da0, inv_mass,
                                       n_1, mu0)
        positions, da, welford = warmup_scan(key_2, positions, da,
                                             inv_mass, n_2, mu0,
                                             collect=True)
        mean, m2, count = welford
        var = m2 / jnp.maximum(count, 1.0)
        inv_mass = (var * count / (count + 5.0) +
                    1e-3 * 5.0 / (count + 5.0))
        # Phase III: fresh dual averaging around the last adapted step
        # size under the new metric.
        mu3 = jnp.log(10.0) + da[1]
        da3 = (da[1], da[1], jnp.zeros((), dtype), jnp.zeros((), dtype))
        positions, da, _ = warmup_scan(key_3, positions, da3, inv_mass,
                                       n_3, mu3)
        step_size = jnp.exp(da[1])
    else:
        positions, da, _ = warmup_scan(key_1, positions0, da0, inv_mass,
                                       n_warmup, mu0)
        step_size = jnp.exp(da[1])

    def body(positions, key_step):
        positions, lp, depth, _ = multi_step(key_step, positions,
                                             step_size, inv_mass)
        return positions, (positions, lp, depth.astype(jnp.float32))

    _, (chain, chain_lp, depths) = jax.lax.scan(
        body, positions, jax.random.split(key_sample, n_steps))
    return chain, chain_lp, depths.mean(), step_size


def make_gaussian_logpost_batched(predict_all, param_names, base_params,
                                  data_list, inv_cov_list, bounds=None,
                                  ngal_data=None, ngal_sigma=None):
    """Batched Gaussian log posterior over several statistics at once.

    ``predict_all`` is a batch-native multi-statistic predictor (dict of
    (B,) arrays -> list of (ngal (B,), xi (B, ...))), e.g. from
    :func:`~.predictor.make_multi_predictor`; ``data_list``/``inv_cov_list`` give one data vector and
    inverse covariance per statistic.  Returns ``theta (B, n_dim) ->
    (B,)`` for :func:`run_ensemble` with ``vectorized=True``.  The
    number-density constraint (``ngal_data``/``ngal_sigma``) uses the
    first statistic's ngal.
    """
    data_list = [jnp.asarray(d).ravel() for d in data_list]
    inv_cov_list = [jnp.asarray(c) for c in inv_cov_list]
    if len(data_list) != len(inv_cov_list):
        raise ValueError("data_list and inv_cov_list lengths differ.")
    names = tuple(param_names)

    def log_prob(theta):
        batch = theta.shape[0]
        params = {k: jnp.broadcast_to(v, (batch,))
                  for k, v in base_params.items()}
        for i, name in enumerate(names):
            params[name] = theta[:, i]
        results = predict_all(params)
        if len(results) != len(data_list):
            raise ValueError(
                f"predict_all returned {len(results)} statistics but "
                f"{len(data_list)} data vectors were given.")
        logp = jnp.zeros(batch, theta.dtype)
        for (ngal, xi), data, inv_cov in zip(results, data_list,
                                             inv_cov_list):
            resid = xi.reshape(batch, -1) - data
            # HIGHEST: the default TF32 (GPU) product would round
            # resid to ~2e-3 relative, wiping out the <1e-6 prediction
            # accuracy; this chi^2 contraction is tiny next to predict.
            logp = logp - 0.5 * jnp.einsum(
                "bi,ij,bj->b", resid, inv_cov, resid,
                precision=jax.lax.Precision.HIGHEST)
        if ngal_data is not None:
            ngal0 = results[0][0]
            logp = logp - 0.5 * ((ngal0 - ngal_data) / ngal_sigma) ** 2
        logp = jnp.where(jnp.isfinite(logp), logp, -jnp.inf)
        if bounds is not None:
            inside = jnp.ones(batch, bool)
            for i, name in enumerate(names):
                if name in bounds:
                    lo, hi = bounds[name]
                    inside = inside & (theta[:, i] > lo) & (theta[:, i] < hi)
            logp = jnp.where(inside, logp, -jnp.inf)
        return logp

    return log_prob


def make_gaussian_logpost(predict_fn, param_names, base_params, data,
                          inv_cov, bounds=None, ngal_data=None,
                          ngal_sigma=None):
    """Gaussian log posterior over a subset of HOD parameters.

    ``predict_fn`` is an *unvectorized* predictor (dict -> (ngal, xi));
    ``param_names`` are the sampled dimensions, others fixed at
    ``base_params``.  ``bounds`` maps names to (lo, hi) flat priors.
    """
    data = jnp.asarray(data)
    inv_cov = jnp.asarray(inv_cov)
    names = tuple(param_names)

    def log_prob(theta):
        params = dict(base_params)
        for i, name in enumerate(names):
            params[name] = theta[i]
        ngal, xi = predict_fn(params)
        resid = xi.ravel() - data
        logp = -0.5 * jnp.einsum("i,ij,j->", resid, inv_cov, resid,
                                 precision=jax.lax.Precision.HIGHEST)
        if ngal_data is not None:
            logp = logp - 0.5 * ((ngal - ngal_data) / ngal_sigma) ** 2
        # Out-of-grid Interpolator predictions are NaN (extrapolate=False,
        # the reference's reject semantics); such walkers get -inf, not a
        # plausible-looking clamped likelihood.
        logp = jnp.where(jnp.isfinite(logp), logp, -jnp.inf)
        if bounds is not None:
            inside = jnp.bool_(True)
            for i, name in enumerate(names):
                if name in bounds:
                    lo, hi = bounds[name]
                    inside = inside & (theta[i] > lo) & (theta[i] < hi)
            logp = jnp.where(inside, logp, -jnp.inf)
        return logp

    return log_prob


# ---------------------------------------------------------------------------
# Chain diagnostics (host-side, float64 numpy).
#
# The reference delegates sampling to emcee and its ecosystem; the
# corresponding convergence tooling there is emcee's
# ``get_autocorr_time`` (Goodman & Weare 2010 sec. 3; Sokal 1997
# windowing) and the split-Rhat of Gelman et al.  These run on finished
# chains, not in the jitted hot loop, so plain numpy is the right tool.
# ---------------------------------------------------------------------------

def integrated_autocorr_time(chain, c=5.0):
    """Integrated autocorrelation time per parameter, emcee-style.

    Parameters
    ----------
    chain : (n_steps, n_walkers, n_dim) array
        Ensemble chain as returned by :func:`run_ensemble` (a 2-D
        (n_steps, n_dim) single chain is also accepted).
    c : float, optional
        Sokal window constant: the sum is truncated at the smallest lag
        M with M >= c * tau(M).  Default 5.0 (emcee's default).

    Returns
    -------
    tau : (n_dim,) float64
        Estimated integrated autocorrelation time of each parameter
        (in steps; 1 = independent samples).
    """
    import numpy as np

    x = np.asarray(chain, dtype=np.float64)
    if x.ndim == 2:
        x = x[:, None, :]
    if x.ndim != 3:
        raise ValueError("chain must be (n_steps[, n_walkers], n_dim).")
    n, _, n_dim = x.shape
    # Per-walker autocovariance via FFT, averaged over walkers
    # (Goodman & Weare: the walkers are identically distributed but not
    # independent early on; averaging their ACFs is emcee's estimator).
    x = x - x.mean(axis=0, keepdims=True)
    n_fft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, n=n_fft, axis=0)
    acf = np.fft.irfft(f * np.conjugate(f), n=n_fft, axis=0)[:n]
    acf = acf.mean(axis=1)                     # (n, n_dim)
    with np.errstate(invalid="ignore", divide="ignore"):
        rho = acf / acf[0]
    taus = 2.0 * np.cumsum(rho, axis=0) - 1.0  # tau(M) per lag M
    out = np.empty(n_dim)
    for d in range(n_dim):
        m = np.arange(len(taus))
        window = np.argmax(m >= c * taus[:, d])
        if window == 0:                        # never crossed: use all lags
            window = len(taus) - 1
        out[d] = max(taus[window, d], 1.0)
    return out


def effective_sample_size(chain, c=5.0):
    """Effective number of independent samples per parameter.

    ``n_steps * n_walkers / tau`` with tau from
    :func:`integrated_autocorr_time`.
    """
    import numpy as np

    x = np.asarray(chain, dtype=np.float64)
    if x.ndim == 2:
        x = x[:, None, :]
    total = x.shape[0] * x.shape[1]
    return total / integrated_autocorr_time(x, c=c)


def gelman_rubin(chain):
    """Split-Rhat potential-scale-reduction per parameter.

    Each walker's chain is split in half (2 * n_walkers sub-chains of
    length n_steps // 2), then the classic Gelman-Rubin statistic
    compares between- and within-chain variances.  Values close to 1
    (conventionally < 1.01) indicate convergence.

    Returns
    -------
    rhat : (n_dim,) float64
    """
    import numpy as np

    x = np.asarray(chain, dtype=np.float64)
    if x.ndim == 2:
        x = x[:, None, :]
    if x.ndim != 3:
        raise ValueError("chain must be (n_steps[, n_walkers], n_dim).")
    n = (x.shape[0] // 2) * 2
    half = n // 2
    if half < 2:
        raise ValueError("need at least 4 steps for split-Rhat.")
    # (half, 2 * n_walkers, n_dim) split sub-chains.
    x = np.concatenate([x[:half], x[half:n]], axis=1)
    mean_c = x.mean(axis=0)                    # (m, n_dim)
    var_c = x.var(axis=0, ddof=1)              # (m, n_dim)
    w = var_c.mean(axis=0)
    b = half * mean_c.var(axis=0, ddof=1)
    var_plus = (half - 1) / half * w + b / half
    with np.errstate(invalid="ignore", divide="ignore"):
        rhat = np.sqrt(var_plus / w)
    return rhat
