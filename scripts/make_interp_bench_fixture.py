"""Generate a 4-node xi_0/2/4 Interpolator fixture for benchmarks.

Same synthetic catalog and 'default' production shape as
``make_bench_fixture.py`` (30 prim bins x 2 percentiles x 2 gal types,
auto mode, multipoles 0/2/4 stacked), tabulated at four satellite
concentration-bias values and assembled into an Interpolator over
``log_eta = log10(conc_gal_bias)`` — structurally the published xi
tables' phase-space-grid layout (reference: scripts/tabulate_snapshot.py
:240-254 assembles per-node files into the final Interpolator;
tabcorr/database.py:56-59 defines the conc_gal_bias grid).

Real pair counts of real mock populations; deterministic given the
seeds.  Run on a host with an accelerator or a g++ build — a few minutes.
"""

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).absolute().parent.parent
sys.path.insert(0, str(REPO))

import tabcorr_tpu as tt  # noqa: E402
from tabcorr_tpu.io import ColumnTable  # noqa: E402
from tabcorr_tpu.mock import NFWPhaseSpace  # noqa: E402
from tabcorr_tpu.ops.multipole import tabcorr_s_mu_to_multipole  # noqa: E402
from make_bench_fixture import synthetic_halocat  # noqa: E402

CONC_GAL_BIAS = (1.0 / 3.0, 1.0 / np.sqrt(3.0), 1.0, np.sqrt(3.0))


def main():
    config = tt.database.configuration("default")
    halocat = synthetic_halocat()
    nodes = []
    for cgb in CONC_GAL_BIAS:
        halotab_smu = tt.TabCorr.tabulate(
            halocat, tt.corrfunc.s_mu_tpcf, config["s_bins"],
            config["mu_bins"], mode="auto", prim_haloprop_bins=30,
            sec_haloprop_percentile_bins=0.5, Num_ptcl_requirement=300,
            sats_per_prim_haloprop=config["sats_per_prim_haloprop"],
            sats_prof_model=NFWPhaseSpace(redshift=halocat.redshift,
                                          conc_gal_bias=cgb),
            project_xyz=True, verbose=True, seed=99)
        parts = [tabcorr_s_mu_to_multipole(halotab_smu, config["mu_bins"],
                                           o) for o in (0, 2, 4)]
        halotab = parts[0]
        halotab.tpcf_matrix = np.concatenate(
            [p.tpcf_matrix for p in parts], axis=0)
        halotab.tpcf_shape = (3, len(config["s_bins"]) - 1)
        halotab.attrs["tpcf"] = "xi_ell"
        nodes.append(halotab)

    table = ColumnTable()
    table["log_eta"] = np.log10(np.asarray(CONC_GAL_BIAS))
    interp = tt.Interpolator(nodes, table)
    out = REPO / "tests" / "data" / "examples" / "synthetic_xi_ell_interp.hdf5"
    interp.write(out, overwrite=True)
    print(f"Wrote {out} ({len(nodes)} nodes)")


if __name__ == "__main__":
    main()
