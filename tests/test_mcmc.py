"""MCMC sampler tests: exactness on a known Gaussian target + HOD posterior."""

import jax
import jax.numpy as jnp
import numpy as np

import tabcorr_tpu as tt
from tabcorr_tpu.mcmc import (ensemble_step, make_gaussian_logpost, run_ensemble,
                              run_hmc)
from tabcorr_tpu.predictor import make_predictor


def _gaussian_logprob(theta):
    mean = jnp.array([1.0, -2.0])
    sigma = jnp.array([0.5, 2.0])
    return -0.5 * jnp.sum(((theta - mean) / sigma) ** 2)


def test_ensemble_samples_gaussian():
    key = jax.random.key(0)
    walkers0 = jax.random.normal(jax.random.key(1), (64, 2))
    chain, lp, accept = run_ensemble(
        key, _gaussian_logprob, walkers0, n_steps=600)
    assert 0.2 < float(accept) < 0.9
    samples = np.asarray(chain[200:]).reshape(-1, 2)
    np.testing.assert_allclose(samples.mean(axis=0), [1.0, -2.0], atol=0.15)
    np.testing.assert_allclose(samples.std(axis=0), [0.5, 2.0], rtol=0.15)


def test_hmc_samples_gaussian():
    key = jax.random.key(2)
    positions0 = jax.random.normal(jax.random.key(3), (8, 2))
    chain, lp, accept = run_hmc(
        key, _gaussian_logprob, positions0, n_steps=400, step_size=0.25,
        n_leapfrog=8)
    assert float(accept) > 0.6
    samples = np.asarray(chain[100:]).reshape(-1, 2)
    np.testing.assert_allclose(samples.mean(axis=0), [1.0, -2.0], atol=0.25)
    np.testing.assert_allclose(samples.std(axis=0), [0.5, 2.0], rtol=0.25)


def test_ensemble_step_shapes():
    walkers = jax.random.normal(jax.random.key(4), (32, 2))
    lp = jax.vmap(_gaussian_logprob)(walkers)
    new, new_lp, accept = ensemble_step(
        jax.random.key(5), walkers, lp, _gaussian_logprob)
    assert new.shape == walkers.shape
    np.testing.assert_allclose(
        np.asarray(jax.vmap(_gaussian_logprob)(new)), np.asarray(new_lp),
        rtol=1e-10)


def test_hod_posterior_recovers_truth(wp_tabcorr, bol_model):
    # End-to-end: sample the zheng07 posterior against synthetic data
    # generated at the true parameters; truth must lie inside the sampled
    # distribution (BASELINE.json config #5).
    predict_one = make_predictor(wp_tabcorr, bol_model, dtype=jnp.float64,
                                 vectorized=False, jit=False)
    base = {k: jnp.float64(v) for k, v in bol_model.param_dict.items()}
    _, xi_true = predict_one(base)
    data = np.asarray(xi_true).ravel()
    sigma = 0.05 * np.abs(data)
    inv_cov = np.diag(1.0 / sigma**2)

    names = ("logMmin", "logM1")
    log_prob = make_gaussian_logpost(
        predict_one, names, base, data, inv_cov,
        bounds={"logMmin": (10.5, 12.5), "logM1": (11.5, 13.5)})

    truth = np.array([bol_model.param_dict[k] for k in names])
    walkers0 = jnp.asarray(
        truth[None] + 0.05 * np.random.default_rng(0).normal(size=(32, 2)))
    chain, lp, accept = run_ensemble(
        jax.random.key(6), log_prob, walkers0, n_steps=150)
    samples = np.asarray(chain[50:]).reshape(-1, 2)
    assert float(accept) > 0.1
    mean = samples.mean(axis=0)
    std = samples.std(axis=0)
    assert np.all(np.abs(mean - truth) < 4 * std + 1e-3)
    assert np.all(std < 0.5)


def test_hmc_adaptive_tunes_step_size():
    from tabcorr_tpu.mcmc import run_hmc_adaptive

    key = jax.random.key(7)
    positions0 = jax.random.normal(jax.random.key(8), (8, 2))
    chain, lp, accept, step_size = run_hmc_adaptive(
        key, _gaussian_logprob, positions0, n_warmup=150, n_steps=300,
        n_leapfrog=8, initial_step_size=1.5)
    # Dual averaging must pull the acceptance rate to the target zone.
    assert 0.6 < float(accept) < 0.95
    assert 0.01 < float(step_size) < 1.5
    samples = np.asarray(chain[100:]).reshape(-1, 2)
    np.testing.assert_allclose(samples.mean(axis=0), [1.0, -2.0],
                               atol=0.3)


def test_nuts_samples_gaussian():
    from tabcorr_tpu.mcmc import run_nuts

    key = jax.random.key(11)
    positions0 = jax.random.normal(jax.random.key(12), (8, 2))
    chain, lp, mean_depth, step_size = run_nuts(
        key, _gaussian_logprob, positions0, n_warmup=100, n_steps=800,
        max_depth=6, initial_step_size=0.5)
    samples = np.asarray(chain[100:]).reshape(-1, 2)
    assert float(mean_depth) >= 1.0
    np.testing.assert_allclose(samples.mean(axis=0), [1.0, -2.0],
                               atol=0.25)
    np.testing.assert_allclose(samples.std(axis=0), [0.5, 2.0], rtol=0.2)


def test_nuts_correlated_gaussian():
    from tabcorr_tpu.mcmc import run_nuts

    cov = jnp.array([[1.0, 0.9], [0.9, 1.0]])
    prec = jnp.linalg.inv(cov)

    def log_prob(theta):
        return -0.5 * theta @ prec @ theta

    key = jax.random.key(13)
    positions0 = 0.1 * jax.random.normal(jax.random.key(14), (8, 2))
    chain, lp, mean_depth, step_size = run_nuts(
        key, log_prob, positions0, n_warmup=100, n_steps=600,
        max_depth=7, initial_step_size=0.3)
    samples = np.asarray(chain[150:]).reshape(-1, 2)
    emp_cov = np.cov(samples.T)
    np.testing.assert_allclose(emp_cov, np.asarray(cov), atol=0.15)
    # NUTS must exploit the correlated geometry with multi-step trees.
    assert float(mean_depth) > 1.5


def test_nuts_accept_stat_in_range():
    # The warmup adapts on the accumulated Metropolis alpha (Hoffman &
    # Gelman 2014, alg. 6): it must be a proper statistic in [0, 1] that
    # decreases with step size.
    from tabcorr_tpu.mcmc import nuts_step

    accepts = []
    for eps in (0.05, 5.0):
        _, _, _, accept, _ = nuts_step(
            jax.random.key(0), jnp.zeros(2), _gaussian_logprob, eps,
            max_depth=5)
        a = float(accept)
        assert 0.0 <= a <= 1.0
        accepts.append(a)
    assert accepts[0] > 0.9       # tiny steps: near-perfect integration
    assert accepts[1] < accepts[0]  # huge steps: worse energy error


def test_nuts_stable_on_heavy_tailed_target():
    # Student-t (df=3): heavy tails defeat naive tuning; the warmup must
    # still deliver a usable step size and calibrated samples.
    from tabcorr_tpu.mcmc import run_nuts

    df = 3.0

    def logprob(x):
        return jnp.sum(-0.5 * (df + 1) * jnp.log1p(x**2 / df))

    walkers0 = 0.5 * jax.random.normal(jax.random.key(1), (8, 1),
                                       dtype=jnp.float64)
    chain, lp, mean_depth, step_size = run_nuts(
        jax.random.key(2), logprob, walkers0, n_warmup=100, n_steps=300,
        max_depth=5)
    samples = np.asarray(chain[80:]).ravel()
    assert np.isfinite(float(step_size)) and float(step_size) > 1e-3
    assert np.all(np.isfinite(samples))
    # Median absolute value of Student-t(3) is ~0.765; the empirical
    # median is robust against the heavy tails.
    med = np.median(np.abs(samples))
    assert 0.5 < med < 1.1, med


def test_nuts_early_exit_saves_gradients():
    # The while_loop tree must stop paying leapfrog gradients when the
    # trajectory turns: on a well-conditioned Gaussian with a tuned step
    # size, trajectories terminate after ~2^3 steps, far below the
    # 2^max_depth = 256 an unrolled tree would always execute.
    from tabcorr_tpu.mcmc import nuts_step

    keys = jax.random.split(jax.random.key(5), 64)
    grads = []
    for k in keys[:16]:
        *_, n_grad = nuts_step(k, jnp.zeros(2), _gaussian_logprob,
                               0.3, max_depth=8)
        grads.append(int(n_grad))
    assert max(grads) < 100
    assert np.mean(grads) < 40


def test_nuts_mass_matrix_adaptation():
    # Anisotropic Gaussian (std 1 vs 30): the adapted diagonal metric
    # must recover both scales while spending measurably fewer gradient
    # evaluations per step — the identity-metric run needs ~2^3 leapfrog
    # steps per trajectory to traverse the wide direction, the adapted
    # one ~2^1.4 (standardized geometry).
    from tabcorr_tpu.mcmc import run_nuts

    scales = jnp.array([1.0, 30.0])

    def logprob(x):
        return -0.5 * jnp.sum((x / scales) ** 2)

    positions0 = jax.random.normal(jax.random.key(21), (8, 2))
    chain_a, _, depth_a, eps_a = run_nuts(
        jax.random.key(22), logprob, positions0, n_warmup=300,
        n_steps=400, max_depth=9, adapt_mass_matrix=True)
    samples = np.asarray(chain_a[100:]).reshape(-1, 2)
    np.testing.assert_allclose(samples.std(axis=0), np.asarray(scales),
                               rtol=0.25)

    chain_i, _, depth_i, eps_i = run_nuts(
        jax.random.key(22), logprob, positions0, n_warmup=300,
        n_steps=400, max_depth=9, adapt_mass_matrix=False)
    # Both runs are calibrated (NUTS is robust), but the adapted metric
    # must get there with >= 2x fewer leapfrog gradient evaluations
    # per step (mean tree depth smaller by >= 1 doubling).
    assert float(depth_a) <= float(depth_i) - 1.0


def test_vectorized_ensemble_matches_per_walker():
    # vectorized=True with a batched fn must reproduce the per-walker
    # (vmapped) sampler exactly given the same key.
    def log_prob_one(theta):
        return -0.5 * jnp.sum(theta**2)

    def log_prob_batched(thetas):
        return jax.vmap(log_prob_one)(thetas)

    walkers0 = jnp.asarray(
        np.random.default_rng(1).normal(size=(16, 3)))
    key = jax.random.key(9)
    chain_a, lp_a, acc_a = run_ensemble(key, log_prob_one, walkers0,
                                        n_steps=20)
    chain_b, lp_b, acc_b = run_ensemble(key, log_prob_batched, walkers0,
                                        n_steps=20, vectorized=True)
    np.testing.assert_array_equal(np.asarray(chain_a), np.asarray(chain_b))
    np.testing.assert_array_equal(np.asarray(lp_a), np.asarray(lp_b))


def test_batched_logpost_matches_sum_of_unbatched(wp_tabcorr, bol_model):
    # make_gaussian_logpost_batched over [wp, wp] == 2x the single-table
    # logpost (minus the ngal term counted once), on the XLA multi path.
    from tabcorr_tpu.mcmc import make_gaussian_logpost_batched
    from tabcorr_tpu.predictor import make_multi_predictor

    predict_one = make_predictor(wp_tabcorr, bol_model, dtype=jnp.float64,
                                 vectorized=False, jit=False)
    base = {k: jnp.float64(v) for k, v in bol_model.param_dict.items()}
    ngal_true, xi_true = predict_one(base)
    data = np.asarray(xi_true).ravel()
    inv_cov = np.diag(1.0 / (0.05 * np.abs(data))**2)

    names = ("logMmin", "logM1")
    lp_one = make_gaussian_logpost(predict_one, names, base, data, inv_cov,
                                   ngal_data=float(ngal_true) * 1.1,
                                   ngal_sigma=float(ngal_true) * 0.2)
    predict_all = make_multi_predictor([wp_tabcorr, wp_tabcorr], bol_model,
                                       dtype=jnp.float64,
                                       jit=False)
    lp_batched = make_gaussian_logpost_batched(
        predict_all, names, base, [data, data], [inv_cov, inv_cov],
        ngal_data=float(ngal_true) * 1.1,
        ngal_sigma=float(ngal_true) * 0.2)

    rng = np.random.default_rng(3)
    thetas = jnp.asarray(
        np.array([bol_model.param_dict[k] for k in names])[None]
        + 0.05 * rng.normal(size=(6, 2)))
    got = np.asarray(lp_batched(thetas))
    chi2_term = np.asarray(jax.vmap(lp_one)(thetas))
    # lp_one = chi2/2 + ngal term; batched doubles only the chi2 part.
    def chi2_only(theta):
        params = dict(base)
        for i, nm in enumerate(names):
            params[nm] = theta[i]
        _, xi = predict_one(params)
        r = xi.ravel() - data
        return -0.5 * r @ jnp.asarray(inv_cov) @ r
    chi2 = np.asarray(jax.vmap(chi2_only)(thetas))
    ngal_term = chi2_term - chi2
    np.testing.assert_allclose(got, 2 * chi2 + ngal_term, rtol=1e-10)


def test_autocorr_time_ar1():
    # AR(1) with coefficient rho has integrated autocorrelation time
    # tau = (1 + rho) / (1 - rho); the emcee-style estimator must land
    # within ~15% on a long multi-walker chain.
    from tabcorr_tpu.mcmc import integrated_autocorr_time

    rho = 0.9
    tau_true = (1 + rho) / (1 - rho)  # 19.0
    rng = np.random.default_rng(0)
    n, w = 40000, 8
    eps = rng.normal(size=(n, w, 2))
    x = np.empty((n, w, 2))
    x[0] = eps[0]
    for t in range(1, n):
        x[t] = rho * x[t - 1] + np.sqrt(1 - rho ** 2) * eps[t]
    tau = integrated_autocorr_time(x)
    assert tau.shape == (2,)
    np.testing.assert_allclose(tau, tau_true, rtol=0.15)

    # iid samples: tau ~ 1.
    tau_iid = integrated_autocorr_time(rng.normal(size=(4000, 8, 3)))
    np.testing.assert_allclose(tau_iid, 1.0, atol=0.25)


def test_effective_sample_size():
    from tabcorr_tpu.mcmc import effective_sample_size

    rng = np.random.default_rng(1)
    chain = rng.normal(size=(2000, 16, 2))
    ess = effective_sample_size(chain)
    # iid: ESS ~ total sample count (within the estimator's noise).
    assert np.all(ess > 0.7 * 2000 * 16)
    assert np.all(ess < 1.4 * 2000 * 16)


def test_gelman_rubin_split_rhat():
    from tabcorr_tpu.mcmc import gelman_rubin

    rng = np.random.default_rng(2)
    # Converged: all sub-chains sample the same distribution.
    good = rng.normal(size=(4000, 8, 3))
    rhat = gelman_rubin(good)
    assert rhat.shape == (3,)
    assert np.all(rhat < 1.01)

    # Unconverged: walkers stuck at different means.
    bad = rng.normal(size=(4000, 8, 1)) + np.arange(8)[None, :, None]
    assert gelman_rubin(bad)[0] > 1.5

    # Within-chain drift (first half != second half) is what SPLIT-Rhat
    # exists to catch.
    drift = rng.normal(size=(4000, 8, 1))
    drift[2000:] += 3.0
    assert gelman_rubin(drift)[0] > 1.5


def test_diagnostics_on_ensemble_chain():
    # End-to-end: diagnostics consume run_ensemble's output directly and
    # report convergence on a well-mixed Gaussian target.
    from tabcorr_tpu.mcmc import (effective_sample_size, gelman_rubin,
                                  integrated_autocorr_time, run_ensemble)

    def log_prob(x):
        return -0.5 * jnp.sum(x ** 2)

    rng = np.random.default_rng(3)
    walkers0 = jnp.asarray(rng.normal(size=(32, 2)))
    chain, _, acc = run_ensemble(jax.random.key(0), log_prob, walkers0,
                                 2000)
    chain = np.asarray(chain)
    # Stretch-move tau on an isotropic 2-D Gaussian is ~20 steps; the
    # chain must be long enough (n >> tau) for split-Rhat to settle.
    tau = integrated_autocorr_time(chain)
    assert np.all(tau < 40)
    assert np.all(effective_sample_size(chain) > 1000)
    assert np.all(gelman_rubin(chain[200:]) < 1.05)


def test_vectorized_ensemble_with_leauthaud11(wp_tabcorr):
    # The batched MCMC hot path with an SHMR model: the float32 joint
    # predictor's log-posterior must match the float64 one's at the
    # float32 contract.
    import jax
    from tabcorr_tpu.mcmc import (make_gaussian_logpost_batched,
                                  run_ensemble)
    from tabcorr_tpu.predictor import make_multi_predictor

    model = tt.Leauthaud11Model(threshold=10.5,
                                redshift=wp_tabcorr.attrs["redshift"])
    predict_all = make_multi_predictor([wp_tabcorr], model)
    predict_xla = make_multi_predictor([wp_tabcorr], model,
                                       dtype=jnp.float64)
    base = {k: float(v) for k, v in model.param_dict.items()}
    ngal0, wp0 = wp_tabcorr.predict(model, check_consistency=False)
    inv_cov = np.diag(1.0 / (0.05 * np.asarray(wp0)) ** 2)

    names = ("smhm_m1_0", "scatter_model_param1")
    bounds = {"smhm_m1_0": (11.5, 13.5),
              "scatter_model_param1": (0.05, 0.6)}
    log_prob = make_gaussian_logpost_batched(
        predict_all, names, base, [np.asarray(wp0)], [inv_cov],
        bounds=bounds)
    log_prob_xla = make_gaussian_logpost_batched(
        predict_xla, names, base, [np.asarray(wp0)], [inv_cov],
        bounds=bounds)

    n_walkers = 16
    rng = np.random.default_rng(0)
    walkers0 = np.column_stack([
        base["smhm_m1_0"] + 0.02 * rng.normal(size=n_walkers),
        base["scatter_model_param1"] + 0.01 * rng.normal(size=n_walkers)])
    lp_auto = np.asarray(log_prob(jnp.asarray(walkers0, jnp.float32)))
    lp_xla = np.asarray(log_prob_xla(jnp.asarray(
        np.asarray(walkers0, np.float32), jnp.float64)))
    # chi^2-scale agreement: the f32 prediction error enters the
    # quadratic form against a 5%-relative covariance.
    np.testing.assert_allclose(lp_auto, lp_xla, rtol=1e-3, atol=2e-3)
    chain, lp, accept = run_ensemble(jax.random.PRNGKey(3), log_prob,
                                     walkers0, n_steps=10,
                                     vectorized=True)
    assert chain.shape == (10, n_walkers, 2)
    assert np.all(np.isfinite(np.asarray(lp)))
