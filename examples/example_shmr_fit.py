"""Gradient-based SHMR inference with the Leauthaud11 model.

The Leauthaud et al. (2011) HOD ties galaxy occupations to the Behroozi
et al. (2010) stellar-to-halo-mass relation (SHMR).  Because this
package's SHMR inversion is a differentiable jax function, the full
chain  SHMR parameters -> occupations -> wp  is exactly differentiable,
so NUTS explores the (logM1, beta, scatter) posterior with O(1)-cost
gradients — the reference's numpy pipeline would need finite
differences and an external sampler.

Synthetic-data exercise on the checked-in bolplanck wp tabulation:
predict wp at fiducial SHMR parameters, add noise, then recover the
parameters with multi-chain NUTS (mass-matrix warmup on).
"""

from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import tabcorr_tpu as tt  # noqa: E402
from tabcorr_tpu import mcmc  # noqa: E402
from tabcorr_tpu.predictor import make_predictor  # noqa: E402

FIXTURE = (Path(__file__).absolute().parent.parent / "tests" / "data" /
           "examples" / "bolplanck_wp.hdf5")

halotab = tt.TabCorr.read(FIXTURE)
model = tt.Leauthaud11Model(threshold=10.5,
                            redshift=halotab.attrs["redshift"])

# float64 keeps the NUTS energies clean.
predict = make_predictor(halotab, model, dtype=jnp.float64,
                         vectorized=False)

# --- synthetic data at the fiducial parameters -------------------------
SAMPLED = ("smhm_m1_0", "smhm_beta_0", "scatter_model_param1")
base = dict(model.param_dict)
ngal0, wp0 = predict(base)
rng = np.random.default_rng(42)
sigma = 0.05 * np.abs(np.asarray(wp0))  # 5% diagonal errors
data = np.asarray(wp0) + sigma * rng.normal(size=wp0.shape)
inv_cov = jnp.diag(1.0 / jnp.asarray(sigma) ** 2)

log_prob = mcmc.make_gaussian_logpost(
    predict, SAMPLED, base, data, inv_cov,
    bounds={"smhm_m1_0": (11.5, 13.5), "smhm_beta_0": (0.1, 1.0),
            "scatter_model_param1": (0.05, 0.6)},
    ngal_data=float(ngal0), ngal_sigma=0.05 * float(ngal0))

# --- NUTS ---------------------------------------------------------------
N_CHAINS, N_WARMUP, N_STEPS = 4, 200, 400
theta0 = jnp.asarray([base[k] for k in SAMPLED], jnp.float64)
start = theta0 + 0.02 * jax.random.normal(
    jax.random.PRNGKey(1), (N_CHAINS, len(SAMPLED)), jnp.float64)

chain, lp, depth, step = mcmc.run_nuts(
    jax.random.PRNGKey(2), log_prob, start, N_WARMUP, N_STEPS,
    max_depth=6, adapt_mass_matrix=True)
samples = np.asarray(chain).reshape(-1, len(SAMPLED))

print(f"NUTS: {N_CHAINS} chains x {N_STEPS} steps, "
      f"mean tree depth {float(np.mean(depth)):.1f}, "
      f"step size {float(step):.3g}")
for i, name in enumerate(SAMPLED):
    lo, mid, hi = np.percentile(samples[:, i], [16, 50, 84])
    truth = float(theta0[i])
    print(f"  {name:22s} truth {truth:7.3f}   "
          f"posterior {mid:7.3f} +{hi - mid:.3f} -{mid - lo:.3f}")

ess = mcmc.effective_sample_size(np.asarray(chain))
print("effective sample size per dim:", np.round(ess, 0))
