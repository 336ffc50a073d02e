"""Two-process multi-host validation of parallel.initialize_multihost.

SURVEY §2.3's distributed-replacement row promises dp/tp sharding "single
or multi host"; this test runs TWO OS processes with JAX's distributed
runtime on localhost CPU (4 virtual devices each -> an 8-device global
mesh spanning a REAL process boundary) and checks that

* ``initialize_multihost`` wires the cluster (process_count == 2, the
  global device list spans both processes),
* the dp-sharded joint predictor and
* the tp-sharded (bin-sharded, psum-finished) predict kernel

reproduce the single-process float64 host path.  Each worker asserts its
own numerics; the parent asserts both exit cleanly.  Slow-marked: two
cold JAX processes plus a distributed handshake take ~1 min.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).absolute().parent.parent

WORKER = r"""
import os, sys
import numpy as np

sys.path.insert(0, os.environ["TABCORR_REPO"])

import jax
jax.config.update("jax_platforms", "cpu")

from tabcorr_tpu.parallel import initialize_multihost

pid = int(sys.argv[1])
port = sys.argv[2]
n_proc = initialize_multihost(coordinator_address=f"localhost:{port}",
                              num_processes=2, process_id=pid)
assert n_proc == 2, n_proc
assert jax.process_count() == 2
assert len(jax.devices()) == 8, jax.devices()
assert len(jax.local_devices()) == 4

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax.experimental import multihost_utils

import tabcorr_tpu as tt
from tabcorr_tpu.parallel import make_mesh, make_sharded_predict
from tabcorr_tpu.predictor import (make_multi_predictor,
                                   occupation_functions, params_batch)

tab = tt.TabCorr.read(os.path.join(os.environ["TABCORR_REPO"],
                                   "tests/data/examples/bolplanck_wp.hdf5"))
model = tt.Zheng07Model(threshold=-18, redshift=tab.attrs["redshift"])

# Host float64 oracle at two probe points (identical in both processes).
rng = np.random.default_rng(0)
batch = 16
logm1 = model.param_dict["logM1"] + 0.05 * rng.normal(size=batch)
oracle = []
for i in (0, batch - 1):
    m = tt.Zheng07Model(threshold=-18, redshift=tab.attrs["redshift"])
    m.param_dict["logM1"] = float(np.float32(logm1[i]))
    oracle.append(tab.predict(m, check_consistency=False))

# --- dp-sharded joint predictor across the process boundary --------
mesh = make_mesh()                       # (dp=8, tp=1) over BOTH hosts
assert mesh.devices.size == 8
f_dp = make_multi_predictor([tab], model, mesh=mesh)
params = {k: np.full(batch, v, np.float32)
          for k, v in model.param_dict.items()}
params["logM1"] = np.asarray(logm1, np.float32)   # numpy: global-safe
[(ng, xi)] = f_dp(params)
ng = np.asarray(multihost_utils.process_allgather(ng, tiled=True))
xi = np.asarray(multihost_utils.process_allgather(xi, tiled=True))
ng, xi = ng[:batch], xi[:batch]
for i, (ng_h, xi_h) in zip((0, batch - 1), oracle):
    assert np.isclose(ng[i], ng_h, rtol=2e-5), ("dp ngal", pid)
    rel = np.max(np.abs(xi[i] / xi_h.ravel() - 1))
    assert rel < 2e-4, ("dp xi", pid, rel)

# --- tp-sharded predict (psum over the process boundary) -------------
mesh_tp = make_mesh(table_parallel=4)    # dp=2 x tp=4
table = tab.table_data(n_gauss=10, dtype=jnp.float64)
f_tp, _ = make_sharded_predict(mesh_tp, table,
                               *occupation_functions(model))
params64 = {k: np.full(batch, v, np.float64)
            for k, v in model.param_dict.items()}
params64["logM1"] = np.asarray(np.float32(logm1), np.float64)
ng_t, xi_t = f_tp(params64)
ng_t = np.asarray(multihost_utils.process_allgather(ng_t, tiled=True))
xi_t = np.asarray(multihost_utils.process_allgather(xi_t, tiled=True))
for i, (ng_h, xi_h) in zip((0, batch - 1), oracle):
    assert np.isclose(ng_t[i], ng_h, rtol=1e-9), ("tp ngal", pid)
    np.testing.assert_allclose(xi_t[i], xi_h.ravel(), rtol=1e-9)

print(f"MULTIHOST_OK {pid}")
"""


@pytest.mark.slow
def test_two_process_multihost_dp_and_tp_predict(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env.update({
        "TABCORR_REPO": str(REPO),
        "JAX_PLATFORMS": "cpu",
        "JAX_PLATFORM_NAME": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "TABCORR_DATABASE": str(REPO / "tests" / "data"),
    })
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for pid in (0, 1)]
    outs = []
    for pid, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        outs.append(out)
    for pid, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIHOST_OK {pid}" in out, out
