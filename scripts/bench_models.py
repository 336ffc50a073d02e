"""Per-model-family prediction throughput.

Measures batched (ngal, wp) prediction rates on the reference's
bolplanck wp fixture for every built-in HOD family, so the costly
occupations (SHMR inversions, the incomplete gamma) have a measured
number next to zheng07's, on whatever backend is active.

Prints one JSON line per family:
  {"model": ..., "predictions_per_s": ..., "batch": ..., "platform": ...}

Usage: python scripts/bench_models.py [--batch 8192] [--steps 30] [--cpu]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).absolute().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="pin the host CPU backend")
    ap.add_argument("--families", default=None,
                    help="comma-separated family subset (default: all)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from tabcorr_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    import tabcorr_tpu as tt
    from tabcorr_tpu.predictor import make_predictor, params_batch

    tab = tt.TabCorr.read(Path(__file__).absolute().parent.parent /
                          "tests/data/examples/bolplanck_wp.npz")
    z = tab.attrs["redshift"]
    families = [
        ("zheng07", tt.Zheng07Model(threshold=-18, redshift=z)),
        ("assembias_zheng07",
         tt.AssembiasZheng07Model(threshold=-18, redshift=z)),
        ("leauthaud11", tt.Leauthaud11Model(threshold=10.5, redshift=z)),
        ("zu_mandelbaum15",
         tt.ZuMandelbaum15Model(threshold=10.5,
                                prim_haloprop_key="halo_mvir")),
        # CLF: the upper incomplete gamma per node.
        ("cacciato09",
         tt.Cacciato09Model(threshold=9.5, redshift=z,
                            prim_haloprop_key="halo_mvir")),
        # Two SHMR inversions + the branchless quiescent fraction per
        # node: the most occupation-heavy family.
        ("tinker13", tt.Tinker13Model(threshold=10.5, redshift=z)),
    ]
    platform = jax.default_backend()
    if args.families:
        keep = set(args.families.split(","))
        families = [f for f in families if f[0] in keep]

    for name, model in families:
        run = make_predictor(tab, model)
        params = params_batch(model, {}, (args.batch,), dtype=jnp.float32)
        for _ in range(args.warmup):
            out = run(params)
            jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            out = run(params)
            jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.steps
        rate = args.batch / dt
        print(json.dumps({
            "model": name, "predictions_per_s": round(rate, 1),
            "batch": args.batch, "platform": platform}), flush=True)


if __name__ == "__main__":
    main()
