"""Tile-level interpolation facade.

Parity target: ``twx/interp/interp_tair.py::PtInterpTair`` (SURVEY.md §2.14)
— the composition of StationSelect + KrigTair + GwrTairAnom that turns a
(lon, lat, elev, tdi, lst*) point into 12 monthly normals + sigma and a daily
series. The reference runs it per point; here the "point" is a whole tile of
cells (C = tile_rows * tile_cols) and the entire composition is one jit.

Day-axis layout (the static-shape trick for the daily matmul): the host
groups calendar days by month and pads each month to a fixed ``dpm`` slots
(31 * nyears), producing station anomalies as (12, S, dpm) plus a (12, dpm)
day-validity mask. The device then runs one (C x S) @ (S x dpm) matmul per
month; the host unpermutes afterwards. ~8 % padding FLOPs buys fully static
shapes — the SURVEY §7 architectural commitment.
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import jax
import jax.numpy as jnp
import numpy as np

from topotpu.core.config import InterpParams
from topotpu.core.dates import DaysMetadata
from topotpu.geo.distance import unit_xyz
from topotpu.geo.neighbors import Neighborhood, select_neighbors
from topotpu.interp.anoms import anomaly_gain_rows, predict_daily, scatter_gains
from topotpu.interp.normals import krig_normals, krig_normals_and_gains


class TileInputs(NamedTuple):
    """Device-facing inputs for one tile. C cells, S (padded) pool stations."""

    cell_lon: jnp.ndarray    # (C,)
    cell_lat: jnp.ndarray    # (C,)
    cell_elev: jnp.ndarray   # (C,)
    cell_tdi: jnp.ndarray    # (C,)
    cell_lst: jnp.ndarray    # (C, 12)
    cell_mask: jnp.ndarray   # (C,) land mask
    stn_lon: jnp.ndarray     # (S,)
    stn_lat: jnp.ndarray     # (S,)
    stn_elev: jnp.ndarray    # (S,)
    stn_tdi: jnp.ndarray     # (S,)
    stn_lst: jnp.ndarray     # (S, 12)
    stn_norm: jnp.ndarray    # (S, 12) monthly normals for the variable
    stn_vario: jnp.ndarray   # (S, 12, 3) nugget/psill/range
    stn_valid: jnp.ndarray   # (S, 12) bool per-month usability
    stn_anoms: jnp.ndarray   # (12, S, dpm) month-grouped daily anomalies


class TileResult(NamedTuple):
    normal: jnp.ndarray    # (12, C)
    se: jnp.ndarray        # (12, C) kriging standard error
    ok: jnp.ndarray        # (12, C)
    daily: jnp.ndarray     # (12, C, dpm) month-grouped dailies — f32, or
    #                        int16 (device-packed) when pack_daily is set
    vario: jnp.ndarray     # (12, C, 3) cell variogram params (diagnostic)
    daily_scale: jnp.ndarray = None   # () f32, set when daily is int16
    daily_offset: jnp.ndarray = None  # () f32


PACK_SENTINEL = -32768  # int16 fill for non-ok cells (matches io.ncdf)


class FlatTileResult(NamedTuple):
    """Single-buffer device output for the production write path.

    Production mode packs the ENTIRE per-tile product into one int16 buffer,
    so the host fetches it in one device->host copy and writes slices of it
    with no decode pass:

      rows [0, ndays)            daily values, CALENDAR order (device-side
                                 ungroup via slot_of_day gather)
      rows [ndays, ndays+12)     monthly normals, int16-packed
      rows [ndays+12, ndays+24)  kriging standard errors, int16-packed

    Non-ok cells carry PACK_SENTINEL in every plane (so `ok` is derivable on
    host as `normal != PACK_SENTINEL`). ``scales`` is
    (daily_scale, daily_offset, norm_scale, norm_offset, se_scale, se_offset).
    """

    buf: jnp.ndarray     # (ndays + 24, C) int16
    scales: jnp.ndarray  # (6,) float32


def _quantize_plane(x, valid, mesh_axis):
    """int16-quantize x over its valid entries with a global scale/offset."""
    big = jnp.float32(3.0e38)
    mn = jnp.min(jnp.where(valid, x, big))
    mx = jnp.max(jnp.where(valid, x, -big))
    if mesh_axis is not None:
        mn = jax.lax.pmin(mn, mesh_axis)
        mx = jax.lax.pmax(mx, mesh_axis)
    has_any = mx >= mn
    mn = jnp.where(has_any, mn, 0.0)
    mx = jnp.where(has_any, mx, 1.0)
    scale = jnp.maximum(mx - mn, 1e-6) / 65500.0
    offset = (mx + mn) / 2.0
    q = jnp.round((x - offset) / scale).astype(jnp.int16)
    q = jnp.where(valid, q, jnp.int16(PACK_SENTINEL))
    return q, scale.astype(jnp.float32), offset.astype(jnp.float32)


def _quantize_plane_fixed(x, valid, scale, offset):
    """int16-quantize x on a CALLER-CHOSEN scale/offset grid (runtime jit
    args). With a run-global grid every tile lands on the same int16
    lattice, so the host can place fetched buffers straight into the final
    mosaic with zero requantization — and the pmin/pmax reductions of the
    dynamic path disappear, making the packed program fully collective-free.
    Values outside the representable window clip to the bound (the window is
    chosen with physical-extreme margins, so clipping marks a config error,
    not data loss — see core.config pack bounds)."""
    q = jnp.clip(jnp.round((x - offset) / scale), -32767, 32767)
    return jnp.where(valid, q.astype(jnp.int16), jnp.int16(PACK_SENTINEL))


def _local_xy_km(lon, lat, ref_lat_deg):
    """Equirectangular local offsets in km — GWR locational covariates.

    ``ref_lat_deg`` may be a traced scalar (derived from the data) or a
    plain float. The centered+scaled GWR design is analytically invariant
    to the x scale up to the tiny ridge term (scaling a column by c cancels
    through the per-column weighted-std normalization), so this constant
    only has to be *reasonable*, not exact — but deriving it keeps
    non-CONUS domains free of a silently CONUS-specific number."""
    kx = 111.32 * jnp.cos(jnp.deg2rad(ref_lat_deg))
    ky = 111.32
    return lon * kx, lat * ky


class VarFields(NamedTuple):
    """Per-variable station fields for the multi-variable tile step.

    The tile geometry (cells, station coordinates/covariates, validity) is
    shared across variables; only these three arrays differ between tmin
    and tmax (SURVEY §2.14: the reference interpolates each variable in a
    separate full pass — here extra variables ride the same neighborhoods,
    GWR gains and scatter, paying only the per-variable kriging solve and
    daily matmul)."""

    norm: jnp.ndarray    # (S, 12)
    vario: jnp.ndarray   # (S, 12, 3)
    anoms: jnp.ndarray   # (12, S, dpm)


class PairTileInputs(NamedTuple):
    """Inputs for the two-variable production step: var A rides ``geom``
    (a full TileInputs); var B shares all geometry and supplies only its
    VarFields. Caller must guarantee stn_valid applies to both variables
    (the engine host-checks this before choosing the paired path)."""

    geom: TileInputs
    b: VarFields


def _interp_tile_multi(
    inputs: TileInputs,
    extra_vars: tuple,
    params: InterpParams,
    shared_validity: bool,
) -> list:
    """Shared core: interpolate 1 + len(extra_vars) variables on one tile
    geometry. Returns one unpacked TileResult per variable.

    Work shared across variables: the (C, S) distance matrix, per-month
    top_k neighborhood selection, covariate gathers, the GWR anomaly gains
    (geometry-only) and the daily scatter. Per-variable work: the kriging
    solve (variogram differs) and the daily matmul (one matmul total —
    variables are concatenated along the day axis)."""
    C = inputs.cell_lon.shape[0]
    S = inputs.stn_lon.shape[0]
    dtype = inputs.cell_lon.dtype
    all_vars = (
        VarFields(inputs.stn_norm, inputs.stn_vario, inputs.stn_anoms),
    ) + tuple(extra_vars)
    V = len(all_vars)

    k_req = params.k_neighbors

    stn_xyz = unit_xyz(inputs.stn_lon, inputs.stn_lat)  # (S, 3)
    # x-offset scale reference latitude: the station pool's mean latitude.
    # Stations are REPLICATED across shards (cells are the sharded axis), so
    # this mean is computed identically on every shard — shard-invariant and
    # collective-free, unlike a mean over (sharded) cell latitudes. Padded
    # pool slots repeat real stations, so the mean stays inside the domain.
    ref_lat = jnp.mean(inputs.stn_lat)
    stn_x, stn_y = _local_xy_km(inputs.stn_lon, inputs.stn_lat, ref_lat)
    cell_x, cell_y = _local_xy_km(inputs.cell_lon, inputs.cell_lat, ref_lat)

    # ONE station feature table, ONE neighborhood gather: every gathered
    # field is a column of (S, F), taken once per distinct neighborhood
    # instead of one narrow (C, k) take per field and month.
    # Layout: [elev, tdi, x_km, y_km, xyz(3), lst(12),
    #          per-var: norm(12) + vario(12x3 month-major)].
    f32 = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    table = jnp.concatenate(
        [
            f32(inputs.stn_elev)[:, None],
            f32(inputs.stn_tdi)[:, None],
            stn_x[:, None],
            stn_y[:, None],
            stn_xyz,
            f32(inputs.stn_lst),
        ]
        + [
            jnp.concatenate(
                [f32(var.norm), f32(var.vario).reshape(S, 36)], axis=1
            )
            for var in all_vars
        ],
        axis=1,
    )
    _VBASE = 19  # columns before the per-variable blocks

    def _cols(G):
        """Column accessors over a gathered (C, k, F) table block."""
        return dict(
            elev=G[..., 0], tdi=G[..., 1], x=G[..., 2], y=G[..., 3],
            xyz=G[..., 4:7],
            lst=lambda m: G[..., 7 + m],
            norm=lambda v, m: G[..., _VBASE + 48 * v + m],
            vario=lambda v, m: G[
                ..., _VBASE + 48 * v + 12 + 3 * m : _VBASE + 48 * v + 15 + 3 * m
            ],
        )

    # exact distance matrix hoisted across months (geometry is
    # month-invariant; per-month work is masked top_k only). A cheap-cosine
    # selection variant exists in select_neighbors but measured slower here:
    # it re-gathers coordinates to recompute exact distances per month.
    from topotpu.geo.distance import pairwise_great_circle_km

    d_all = pairwise_great_circle_km(
        inputs.cell_lon, inputs.cell_lat, inputs.stn_lon, inputs.stn_lat
    )

    # [v][m] result lists
    normals = [[] for _ in range(V)]
    ses = [[] for _ in range(V)]
    oks = [[] for _ in range(V)]
    varios = [[] for _ in range(V)]
    gains_by_month = []  # [m] -> [(gains, nbr)] per variable
    # Per-variable neighborhood sizes — the optim-nnghs consumption path
    # (SURVEY §2.16: the reference's per-region optimized nnghs tables are
    # consumed by every gridded run). Selection happens ONCE at
    # k_req = params.k_neighbors (the caller sets it to the max over
    # variables); each variable's kriging masks the slots beyond its own
    # k_v — top_k output is distance-sorted, so the first k_v slots ARE the
    # k_v-neighborhood and a masked slot is provably inert. Uniform sizes
    # (the default) keep the variable-shared gains path.
    kvs = (
        tuple(int(k) for k in params.k_per_var)
        if params.k_per_var else (k_req,) * V
    )
    ka_base = min(params.k_neighbors_anom, k_req)
    kas = (
        tuple(min(int(a), k_req) for a in params.ka_per_var)
        if params.ka_per_var else (ka_base,) * V
    )
    if len(kvs) != V or len(kas) != V:
        raise ValueError(
            f"k_per_var/ka_per_var need one entry per variable ({V}): "
            f"got {len(kvs)}/{len(kas)}"
        )
    if max(kvs) > k_req:
        raise ValueError("k_per_var entries must be <= k_neighbors")
    uniform = kvs == (k_req,) * V and len(set(kas)) == 1
    ka = kas[0]
    cell_cov_anom = jnp.stack(
        [inputs.cell_elev, cell_x, cell_y], axis=-1
    )

    nbr = None
    cols = None
    for m in range(12):
        if nbr is None or not shared_validity:
            nbr = select_neighbors(
                inputs.cell_lon,
                inputs.cell_lat,
                inputs.stn_lon,
                inputs.stn_lat,
                inputs.stn_valid[:, m],
                k=params.k_neighbors,
                dist_matrix=d_all,
            )
            cols = _cols(jnp.take(table, nbr.idx, axis=0))

        # Trend covariates: elev, tdi, lst_m only (SURVEY §2.12's design:
        # elevation + topographic index + monthly LST). Location enters via
        # the moving-window weights, NOT explicit x/y — the variogram params
        # were fit to covariate-only-detrended residuals (interp/params.py),
        # and the kriging trend must match that convention or the residual
        # field the weights assume would not be the one being kriged.
        nbr_cov = jnp.stack(
            [cols["elev"], cols["tdi"], cols["lst"](m)], axis=-1
        )
        cell_cov = jnp.stack(
            [inputs.cell_elev, inputs.cell_tdi, inputs.cell_lst[:, m]],
            axis=-1,
        )

        # Anomaly GWR design: simpler covariates (elev + local x/y), §2.13.
        # The reference tunes normals/anomaly neighborhood sizes separately
        # (mpi_optim_nstns_norms vs _anoms, SURVEY §2.16); top_k output is
        # distance-sorted, so the anomaly neighborhood is a free prefix
        # slice of the normals one.
        if not uniform:
            # per-variable sizes (optim-nnghs consumption): each variable's
            # kriging masks its trailing slots; gains are solved once per
            # DISTINCT anomaly k (variables sharing a k share the solve and,
            # downstream, the daily scatter). With month-invariant validity
            # the gain solves happen once and later months reuse them.
            slots = jnp.arange(params.k_neighbors)
            results_m = [
                krig_normals(
                    nbr.dist,
                    nbr.mask & (slots < kvs[v])[None, :]
                    if kvs[v] < k_req else nbr.mask,
                    cols["xyz"], nbr_cov, cell_cov,
                    cols["norm"](v, m), cols["vario"](v, m),
                    weight_kernel=params.weight_kernel, ridge=params.ridge,
                    jitter_frac=params.chol_jitter,
                    min_neighbors=params.min_neighbors,
                )
                for v in range(V)
            ]
            if m == 0 or not shared_validity:
                gains_cache = {}
                for ka_v in sorted(set(kas)):
                    nbr_v = Neighborhood(
                        idx=nbr.idx[:, :ka_v], dist=nbr.dist[:, :ka_v],
                        mask=nbr.mask[:, :ka_v],
                    )
                    nca = jnp.stack(
                        [cols["elev"][:, :ka_v], cols["x"][:, :ka_v],
                         cols["y"][:, :ka_v]],
                        axis=-1,
                    )
                    gains_cache[ka_v] = (
                        anomaly_gain_rows(
                            nbr_v.dist, nbr_v.mask, nca, cell_cov_anom,
                            weight_kernel=params.weight_kernel,
                            ridge=params.ridge,
                        ),
                        nbr_v,
                    )
                gains_cache0 = gains_cache
            else:
                gains_cache = gains_cache0
            for v, res_v in enumerate(results_m):
                normals[v].append(res_v.normal)
                ses[v].append(res_v.se)
                oks[v].append(res_v.ok & inputs.cell_mask)
                varios[v].append(res_v.vario)
            gains_by_month.append([gains_cache[kas[v]] for v in range(V)])
            continue
        if ka == k_req:
            # same neighborhoods: var 0's normals + the (variable-shared)
            # gains are solved on one gathered geometry; extra variables
            # pay only a normals solve. Gains are geometry-only, so with
            # month-invariant neighborhoods only month 0 computes them and
            # later months reuse them.
            if m == 0 or not shared_validity:
                nbr_cov_anom = jnp.stack(
                    [cols["elev"], cols["x"], cols["y"]], axis=-1
                )
                res, gains = krig_normals_and_gains(
                    nbr.dist, nbr.mask, cols["xyz"], nbr_cov, cell_cov,
                    cols["norm"](0, m), cols["vario"](0, m),
                    nbr_cov_anom, cell_cov_anom,
                    weight_kernel=params.weight_kernel, ridge=params.ridge,
                    jitter_frac=params.chol_jitter,
                    min_neighbors=params.min_neighbors,
                )
                gains0 = gains
            else:
                res = krig_normals(
                    nbr.dist, nbr.mask, cols["xyz"], nbr_cov, cell_cov,
                    cols["norm"](0, m), cols["vario"](0, m),
                    weight_kernel=params.weight_kernel, ridge=params.ridge,
                    jitter_frac=params.chol_jitter,
                    min_neighbors=params.min_neighbors,
                )
                gains = gains0
            results_m = [res]
            nbr_a = nbr
        else:
            results_m = []
            nbr_a = Neighborhood(
                idx=nbr.idx[:, :ka], dist=nbr.dist[:, :ka],
                mask=nbr.mask[:, :ka],
            )
            nbr_cov_anom = jnp.stack(
                [cols["elev"][:, :ka], cols["x"][:, :ka], cols["y"][:, :ka]],
                axis=-1,
            )
            gains = anomaly_gain_rows(
                nbr_a.dist,
                nbr_a.mask,
                nbr_cov_anom,
                cell_cov_anom,
                weight_kernel=params.weight_kernel,
                ridge=params.ridge,
            )
        for v in range(len(results_m), V):
            results_m.append(
                krig_normals(
                    nbr.dist, nbr.mask, cols["xyz"], nbr_cov, cell_cov,
                    cols["norm"](v, m), cols["vario"](v, m),
                    weight_kernel=params.weight_kernel, ridge=params.ridge,
                    jitter_frac=params.chol_jitter,
                    min_neighbors=params.min_neighbors,
                )
            )
        for v, res_v in enumerate(results_m):
            normals[v].append(res_v.normal)
            ses[v].append(res_v.se)
            oks[v].append(res_v.ok & inputs.cell_mask)
            varios[v].append(res_v.vario)
        gains_by_month.append([(gains, nbr_a)] * V)

    return _finish_tile_multi(
        inputs, all_vars, params, shared_validity, normals, ses, oks,
        varios, gains_by_month, C, S, dtype,
    )


def _finish_tile_multi(
    inputs, all_vars, params, shared_validity, normals, ses, oks, varios,
    gains_by_month, C, S, dtype,
):
    """Daily-anomaly application + per-variable TileResult assembly — the
    tail of _interp_tile_multi, split out to keep the month loop readable."""
    V = len(all_vars)
    dpm = inputs.stn_anoms.shape[-1]
    dailies = [[] for _ in range(V)]  # [v][m] (C, dpm)

    def _gain_groups(entries):
        """Group variables that share a gain solve (same traced object —
        uniform runs share one across all variables; per-variable anomaly
        k runs share within equal-k subsets) so each group pays ONE
        scatter/matmul over its concatenated day axes."""
        groups: list = []
        for v, (g, nb) in enumerate(entries):
            for grp in groups:
                if grp[0] is g:
                    grp[2].append(v)
                    break
            else:
                groups.append((g, nb, [v]))
        return groups

    if shared_validity:
        # With month-invariant validity the anomaly gains are identical for
        # every month (geometry-only), so ONE scatter into the dense (C, S)
        # gain matrix + ONE matmul over the concatenated (S, V*12*dpm) day
        # matrix covers the whole year for every variable of a gain group.
        for g0, nbr0, vs in _gain_groups(gains_by_month[0]):
            G = scatter_gains(g0, nbr0.idx, nbr0.mask, S)
            Y_cat = jnp.concatenate(
                [
                    jnp.transpose(all_vars[v].anoms, (1, 0, 2)).reshape(
                        S, 12 * dpm
                    )
                    for v in vs
                ],
                axis=1,
            )
            anom_all = predict_daily(G, Y_cat)
            for j, v in enumerate(vs):
                off = j * 12 * dpm
                for m in range(12):
                    dailies[v].append(
                        normals[v][m][:, None]
                        + anom_all[:, off + m * dpm : off + (m + 1) * dpm]
                    )
    else:
        for m in range(12):
            entries = gains_by_month[m]
            if dpm <= 64:
                # short day axes: the (C,k,dpm) gather+einsum skips the
                # (C,S) scatter
                from topotpu.interp.anoms import predict_daily_gathered

                for v in range(V):
                    gains, nbr_a = entries[v]
                    anom = predict_daily_gathered(
                        gains, nbr_a.idx, nbr_a.mask, all_vars[v].anoms[m]
                    )
                    dailies[v].append(normals[v][m][:, None] + anom)
            else:
                Gs: dict = {}
                for v in range(V):
                    gains, nbr_a = entries[v]
                    if id(gains) not in Gs:
                        Gs[id(gains)] = scatter_gains(
                            gains, nbr_a.idx, nbr_a.mask, S
                        )
                    anom = predict_daily(Gs[id(gains)], all_vars[v].anoms[m])
                    dailies[v].append(normals[v][m][:, None] + anom)

    return [
        TileResult(
            normal=jnp.stack(normals[v]),
            se=jnp.stack(ses[v]),
            ok=jnp.stack(oks[v]),
            daily=jnp.stack(dailies[v]).astype(dtype),
            vario=jnp.stack(varios[v]),
            daily_scale=jnp.float32(1.0),
            daily_offset=jnp.float32(0.0),
        )
        for v in range(V)
    ]


def interp_tile(
    inputs: TileInputs,
    params: InterpParams,
    shared_validity: bool = False,
    pack_daily: bool = False,
    mesh_axis: str | None = None,
) -> TileResult:
    """Interpolate every cell x month x day of one tile. Jit this.

    ``shared_validity`` (static): when the caller knows stn_valid is
    identical across months (true whenever validity comes from per-station
    BAD flags only — the engine detects it), neighborhoods are selected
    once instead of 12 times. top_k is the single most expensive per-month
    op (~52 ms per 65k-cell month), so this is a major saving.

    ``pack_daily`` (static): quantize the daily block to int16 on device
    with one tile-wide scale/offset — halves the device->host transfer and
    removes the host-side packing pass; non-ok cells carry PACK_SENTINEL.
    Under shard_map pass ``mesh_axis`` so the scale is a global pmin/pmax
    (two scalar collectives — the only ones in the program)."""
    res = _interp_tile_multi(inputs, (), params, shared_validity)[0]
    if not pack_daily:
        # scale/offset kept as trivial scalars so the pytree structure (and
        # shard_map out_specs) is identical in both modes
        return res

    q, scale, offset = _quantize_plane(res.daily, res.ok[:, :, None], mesh_axis)
    return res._replace(daily=q, daily_scale=scale, daily_offset=offset)


def interp_tile_flat(
    inputs: TileInputs,
    slot_of_day: jnp.ndarray,
    params: InterpParams,
    shared_validity: bool = False,
    mesh_axis: str | None = None,
    fixed_scales: jnp.ndarray | None = None,
) -> FlatTileResult:
    """Production-mode tile interpolation: one flat int16 output buffer.

    ``slot_of_day`` is the host MonthLayout's (ndays,) map from calendar day
    to flat (12 * dpm) month-grouped slot; the calendar reorder happens on
    device (a row gather) so the host writes slices of the fetched buffer
    straight into HDF5 with no decode pass. It is a runtime argument (not a
    compile-time constant) so chunked production runs with differing leap
    patterns share one compiled program per day-count. See FlatTileResult
    for the buffer layout.
    """
    res = interp_tile(
        inputs, params, shared_validity=shared_validity,
        pack_daily=False, mesh_axis=None,
    )
    # month-grouped (12, C, dpm) -> (12*dpm, C) -> calendar (ndays, C);
    # the sentinel is applied per-month inside _quantize_plane so it
    # survives the gather, and padding slots are never selected by
    # slot_of_day.
    buf, scales = _flatten_result(res, slot_of_day, mesh_axis, fixed_scales)
    return FlatTileResult(buf=buf, scales=scales)


def interp_tile_pair(
    pair: PairTileInputs,
    params: InterpParams,
    shared_validity: bool = False,
) -> tuple[TileResult, TileResult]:
    """Two-variable tile step (unpacked): tmin and tmax in one jit, sharing
    neighborhoods, GWR gains and the daily scatter-matmul. Var A's result
    is identical to a solo ``interp_tile`` on ``pair.geom``; var B pays only
    its kriging solve + its slice of the shared daily matmul."""
    res = _interp_tile_multi(
        pair.geom, (pair.b,), params, shared_validity
    )
    return res[0], res[1]


def _flatten_result(res: TileResult, slot_of_day, mesh_axis, fixed_scales=None):
    """Quantize + calendar-reorder one TileResult into flat-buffer planes.

    ``fixed_scales`` (optional (6,) f32 jit arg: d_scale, d_off, n_scale,
    n_off, se_scale, se_off) switches quantization to the caller's global
    int16 grid (see _quantize_plane_fixed); the returned scales echo it."""
    C = res.normal.shape[1]
    dpm = res.daily.shape[-1]
    valid3 = res.ok[:, :, None]
    if fixed_scales is not None:
        dq = _quantize_plane_fixed(
            res.daily, valid3, fixed_scales[0], fixed_scales[1]
        )
        nq = _quantize_plane_fixed(
            res.normal, res.ok, fixed_scales[2], fixed_scales[3]
        )
        sq = _quantize_plane_fixed(
            res.se, res.ok, fixed_scales[4], fixed_scales[5]
        )
        scales = fixed_scales
    else:
        dq, d_scale, d_off = _quantize_plane(res.daily, valid3, mesh_axis)
        nq, n_scale, n_off = _quantize_plane(res.normal, res.ok, mesh_axis)
        sq, s_scale, s_off = _quantize_plane(res.se, res.ok, mesh_axis)
        scales = jnp.stack([d_scale, d_off, n_scale, n_off, s_scale, s_off])
    cal = jnp.transpose(dq, (0, 2, 1)).reshape(12 * dpm, C)[
        jnp.asarray(slot_of_day, jnp.int32)
    ]
    buf = jnp.concatenate([cal, nq, sq], axis=0)
    return buf, scales


def interp_tile_pair_flat(
    pair: PairTileInputs,
    slot_of_day: jnp.ndarray,
    params: InterpParams,
    shared_validity: bool = False,
    mesh_axis: str | None = None,
    fixed_scales: jnp.ndarray | None = None,
    reconcile: bool = False,
) -> FlatTileResult:
    """Production-mode paired step: BOTH variables leave the device as ONE
    flat int16 buffer (one device->host copy instead of two).

    Layout: var A's (ndays + 24, C) block (see FlatTileResult) followed by
    var B's; ``scales`` is var A's 6 floats then var B's (or the caller's
    (12,) ``fixed_scales``, echoed).

    ``reconcile`` (static): enforce daily A <= daily B where both cells are
    ok by collapsing crossings to their mean-preserving midpoint — the
    reference's PtInterpTair tmax>tmin validation (SURVEY §2.14), applied at
    interpolation time in f32 instead of as a mosaic post-pass. The engine
    passes tmin as var A. With fixed (shared) pack scales both variables
    quantize the midpoint to the SAME int16 lattice point, so the ordering
    survives packing exactly; normals are left untouched (matching the
    mosaic-stage reconcile this replaces)."""
    res_a, res_b = interp_tile_pair(pair, params, shared_validity)
    if reconcile:
        both = (res_a.ok & res_b.ok)[:, :, None]
        bad = both & (res_b.daily < res_a.daily)
        mid = 0.5 * (res_a.daily + res_b.daily)
        res_a = res_a._replace(daily=jnp.where(bad, mid, res_a.daily))
        res_b = res_b._replace(daily=jnp.where(bad, mid, res_b.daily))
    fs_a = None if fixed_scales is None else fixed_scales[:6]
    fs_b = None if fixed_scales is None else fixed_scales[6:]
    buf_a, sc_a = _flatten_result(res_a, slot_of_day, mesh_axis, fs_a)
    buf_b, sc_b = _flatten_result(res_b, slot_of_day, mesh_axis, fs_b)
    return FlatTileResult(
        buf=jnp.concatenate([buf_a, buf_b], axis=0),
        scales=jnp.concatenate([sc_a, sc_b]),
    )


def interp_points(
    lon: np.ndarray,
    lat: np.ndarray,
    elev: np.ndarray,
    tdi: np.ndarray,
    lst: np.ndarray,
    stations,
    days,
    params: InterpParams | None = None,
):
    """Interpolate arbitrary points (not a grid tile) — the reference's
    point-wise ``PtInterpTair`` usage (SURVEY §2.14: interpolate to a
    station site or any lon/lat), as a thin facade over the batched tile
    step: the N points ARE the tile's cell batch.

    lon/lat/elev/tdi: (N,); lst: (N, 12) monthly land-surface temperature
    at the points; ``stations``: a ``topotpu.dist.engine.StationSet``;
    ``days``: DaysMetadata for the daily span.

    Returns ``(TileResult, MonthLayout)`` — dailies are month-grouped
    (12, N, dpm); recover calendar order with
    ``ungroup_days(result.daily.transpose(1, 0, 2), layout)``.
    """
    params = params or InterpParams()
    layout = month_layout(days)
    anoms = group_days_by_month(
        np.asarray(stations.anoms, np.float32), layout
    )
    dt = np.float32
    N = len(lon)
    ti = TileInputs(
        cell_lon=jnp.asarray(lon, dt),
        cell_lat=jnp.asarray(lat, dt),
        cell_elev=jnp.asarray(elev, dt),
        cell_tdi=jnp.asarray(tdi, dt),
        cell_lst=jnp.asarray(lst, dt),
        cell_mask=jnp.ones(N, bool),
        stn_lon=jnp.asarray(stations.lon, dt),
        stn_lat=jnp.asarray(stations.lat, dt),
        stn_elev=jnp.asarray(stations.elev, dt),
        stn_tdi=jnp.asarray(stations.tdi, dt),
        stn_lst=jnp.asarray(stations.lst, dt),
        stn_norm=jnp.asarray(stations.norm, dt),
        stn_vario=jnp.asarray(stations.vario, dt),
        stn_valid=jnp.asarray(stations.valid),
        stn_anoms=jnp.asarray(np.moveaxis(anoms, 1, 0), dt),
    )
    shared = bool(np.all(np.asarray(stations.valid)
                         == np.asarray(stations.valid)[:, :1]))
    return _points_fn(params, shared)(ti), layout


@functools.lru_cache(maxsize=8)
def _points_fn(params: InterpParams, shared: bool):
    # one compiled program per (params, shared) so repeated interp_points
    # calls hit the jit cache (InterpParams is a frozen dataclass)
    return jax.jit(
        lambda t: interp_tile(t, params, shared_validity=shared)
    )


# ---------------------------------------------------------------------------
# Host-side day-axis (calendar <-> month-grouped) layout helpers
# ---------------------------------------------------------------------------


class MonthLayout(NamedTuple):
    """Mapping between a calendar day axis and the (12, dpm) padded layout."""

    dpm: int                 # padded days-per-month slots
    slot_of_day: np.ndarray  # (ndays,) flat index into 12*dpm
    day_valid: np.ndarray    # (12, dpm) bool
    month_idx: np.ndarray    # (ndays,)


def month_layout(days: DaysMetadata) -> MonthLayout:
    counts = np.zeros(12, dtype=np.int64)
    slot = np.empty(days.ndays, dtype=np.int64)
    # per-month running position
    pos = np.zeros(12, dtype=np.int64)
    for i, m in enumerate(days.month_idx):
        slot[i] = pos[m]
        pos[m] += 1
    dpm = int(pos.max())
    flat = days.month_idx.astype(np.int64) * dpm + slot
    valid = np.zeros((12, dpm), dtype=bool)
    valid.reshape(-1)[flat] = True
    counts[:] = pos
    return MonthLayout(
        dpm=dpm, slot_of_day=flat, day_valid=valid, month_idx=days.month_idx
    )


def group_days_by_month(series: np.ndarray, layout: MonthLayout) -> np.ndarray:
    """(..., ndays) calendar -> (..., 12, dpm) padded month-grouped (pads = 0)."""
    lead = series.shape[:-1]
    out = np.zeros(lead + (12 * layout.dpm,), dtype=series.dtype)
    out[..., layout.slot_of_day] = series
    return out.reshape(lead + (12, layout.dpm))


def ungroup_days(grouped: np.ndarray, layout: MonthLayout) -> np.ndarray:
    """(..., 12, dpm) -> (..., ndays) calendar order."""
    lead = grouped.shape[:-2]
    flat = grouped.reshape(lead + (12 * layout.dpm,))
    return flat[..., layout.slot_of_day]
