"""Multi-device batched prediction + MCMC through the joint predictor.

Shards a zheng07 wp + xi_ell parameter batch over every available device
(``dp`` mesh axis; tabulations replicate — they are a few MB) and runs a
vectorized stretch-move ensemble through the batched Gaussian posterior.
The hot loop contains ZERO cross-device collectives: each device evaluates
an independent slice of the walker ensemble, so throughput scales linearly
with the mesh.

Runs anywhere: on a multi-GPU host it uses every card; on CPU set
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
to demonstrate the sharding on 8 virtual devices.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import tabcorr_tpu as tt
from tabcorr_tpu.mcmc import make_gaussian_logpost_batched, run_ensemble
from tabcorr_tpu.parallel import make_mesh
from tabcorr_tpu.predictor import make_multi_predictor, params_batch

FIXTURES = (Path(__file__).absolute().parent.parent / "tests" / "data" /
            "examples")

n_dev = len(jax.devices())
mesh = make_mesh(n_dev, table_parallel=1)
print(f"devices: {n_dev} ({jax.devices()[0].platform})")

wp_tab = tt.TabCorr.read(FIXTURES / "bolplanck_wp.hdf5")
model = tt.Zheng07Model(threshold=-18, redshift=wp_tab.attrs["redshift"])

# --- dp-sharded predictor: each device evaluates its slice of the batch.
predict = make_multi_predictor([wp_tab], model, mesh=mesh)

rng = np.random.default_rng(42)
batch = 512 * n_dev
params = params_batch(
    model, {"logM1": 12.4 + 0.1 * rng.normal(size=batch)}, (batch,),
    dtype=jnp.float32)
[(ngal, wp)] = predict(params)
print(f"sharded batch predict: {batch} evaluations -> wp {wp.shape}")

# --- synthetic data + batched posterior -> vectorized ensemble MCMC.
truth = dict(model.param_dict)
[(_, wp_data)] = predict(params_batch(model, {}, (n_dev,),
                                     dtype=jnp.float32))
data = np.asarray(wp_data[0], np.float64).ravel()
inv_cov = np.diag(1.0 / (0.05 * np.abs(data)) ** 2)

names = tuple(model.param_dict.keys())
log_prob = make_gaussian_logpost_batched(predict, names, model.param_dict,
                                         [data], [inv_cov])

n_walkers = 128 * n_dev
walkers0 = jnp.asarray(
    np.array([truth[k] for k in names])[None, :] +
    0.05 * rng.normal(size=(n_walkers, len(names))), dtype=jnp.float32)
chain, log_probs, accept = run_ensemble(jax.random.key(0), log_prob,
                                        walkers0, n_steps=50,
                                        vectorized=True)
best = np.asarray(chain[-1][np.argmax(np.asarray(log_probs[-1]))])
print("truth  :", {k: round(truth[k], 3) for k in names})
print("MAP-ish:", {k: round(float(v), 3) for k, v in zip(names, best)})
print(f"acceptance: {float(accept):.2f}")
