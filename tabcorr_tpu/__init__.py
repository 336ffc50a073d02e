"""tabcorr_tpu: tabulated galaxy correlation functions on accelerators.

A ground-up JAX re-design of the halo tabulation method of
Zheng & Guo (2016) with the full capability surface of the reference
``tabcorr`` package (johannesulf/TabCorr v1.2.0): tabulation of halo
correlation functions (wp, xi(s, mu) multipoles, delta sigma), millisecond
HOD predictions, parameter-grid interpolation, and the published-table
database layer — plus what the reference never had: jit/vmap/grad-able
prediction kernels, device-mesh sharding, and on-device MCMC.
"""

from . import corrfunc, cosmology, database
from .halocat import HaloCatalog, ParticleCatalog
from .interpolator import Interpolator
from .models import (AssembiasCacciato09Model, AssembiasLeauthaud11Model,
                     AssembiasTinker13Model, AssembiasZheng07Model,
                     AssembiasZuMandelbaum15Model, Cacciato09Model,
                     HodModel, Leauthaud11Model, NonparametricHodModel,
                     Tinker13Model, Zheng07Model, ZuMandelbaum15Model)
from .table import TabCorr
from .tabulate import (compute_tpcf_matrix, distribution_index,
                       sort_into_bins)
from .utils.packing import symmetric_matrix_to_array

__version__ = "0.1.0"
__all__ = ["TabCorr", "Interpolator", "HodModel", "Zheng07Model",
           "AssembiasZheng07Model", "Leauthaud11Model",
           "AssembiasLeauthaud11Model", "ZuMandelbaum15Model",
           "AssembiasZuMandelbaum15Model", "Cacciato09Model",
           "AssembiasCacciato09Model", "NonparametricHodModel",
           "Tinker13Model", "AssembiasTinker13Model",
           "HaloCatalog", "ParticleCatalog",
           "cosmology", "database", "corrfunc", "sort_into_bins",
           "distribution_index", "symmetric_matrix_to_array",
           "compute_tpcf_matrix"]
