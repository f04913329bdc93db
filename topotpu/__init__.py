"""topotpu — topoclimatic temperature engine on JAX.

A from-scratch, batched JAX/XLA framework (run on NVIDIA GPUs) with the
capabilities of
TopoWx (reference: jaredwo/topowx): serially-complete homogenized station
temperature data and 30-arcsecond gridded daily tmin/tmax with kriging-variance
uncertainty for CONUS.

Reference provenance: the reference mount was empty at survey time; component
parity targets come from SURVEY.md (symbol-level pointers like
``twx/interp/interp_tair.py::KrigTair``) and BASELINE.json's north-star spec.

Layer map (mirrors SURVEY.md §1, rebuilt as batched device programs):

====  =======================  ==========================================
ref   reference layer          topotpu equivalent
====  =======================  ==========================================
L0    netCDF/GDAL storage      ``topotpu.io`` (h5py netCDF4-compatible)
L1    twx/db station DB        ``topotpu.io.stndb``
L2    twx/qa + twx/homog       ``topotpu.qa``, ``topotpu.homog``
L3    twx/infill PPCA          ``topotpu.infill`` + ``topotpu.stats.ppca``
L4    twx/interp kriging/GWR   ``topotpu.interp`` + ``topotpu.kernels``
L5    tiling / grid output     ``topotpu.interp.tile`` + ``topotpu.dist``
L6    bin/step*.py scripts     ``topotpu.cli``
X1    mpi4py task farm         ``topotpu.dist`` (Mesh + shard_map)
X2    rpy2/R gstat bridge      deleted; ``topotpu.stats.variogram`` +
                               ``topotpu.kernels`` (batched JAX + CUDA)
====  =======================  ==========================================
"""

__version__ = "0.1.0"
