"""Launch-aware program-level runtime predictor, for the H100.

The port of ``tfhe_fbs_map_tpu.optimizer.runtime_model``, with the same
functions.  The per-boot roofline (:func:`.optimizer.bootstrap_cost_us`)
holds at a full batch; a program pays per level call as well, and pads each
level's launch to whole tiles (:func:`launch_rows`; JAX's pads it to a
power of two, :func:`bucket`), and the staged pipeline makes two calls a
level.  :func:`predict_native_us` / :func:`predict_staged_us` price a
whole program at an evaluation batch; the runtime CLI routes staged against
native on them.

On the H100 each kernel launches once a call, as a grid of cluster tiles,
and its time comes in waves of clusters, not in rows.  A call of ``rows``
ciphertexts costs

* the kernel: a fixed term plus ``waves × wave``.  The plan and its waves
  are :func:`..ops.fused_blind_rotate.k1_plan` / ``k2_plan``'s (below
  N=256 K1's small-N plan, a cluster a tile of 16; above, on the route
  :func:`k1_route` prices, where :func:`small_tile_wins` the same kernel's
  small-tile plan, priced from its own points, :func:`small_tile_us`),
  given the calibrated
  card's SM count and the clusters it runs at once (the ``resident`` table;
  a plan it lacks runs one cluster an SM), so a prediction needs no card.
  A wave of a plan (tile ``cb``, ``cluster`` CTAs) carries ``cb · sms /
  cluster`` bootstraps' work at the family's per-boot cost;
* the level's work around the kernel (gather and lincomb, key switch through
  ``torch._int_mm``, modswitch, extract, scatter): ``a + b · rows · (kN+1)``.

Constants come from ``calibration_h100.json`` (``python -m
tfhe_fbs_map_tpu_torch.optimizer.calibrate`` on the card): per family and
kernel it was timed through, keyed ``n,k,N,l,ks_l/<kernel>``
(:func:`entry_key`), the kernel's fixed term and the scale of its per-boot
cost, and the work around it; a family with no entry of a kernel takes the
fit across families of that kernel (below N=256 the fit of K1's small-N
kernel, ``k1s``).  K1's small-tile plan at N ≥ 256 is priced from its own
points, the family's ``.../k1s`` entry, and where a family has none from
their fit across families, ``k1s_wide`` (:func:`small_tile_us`); it is
taken where that price is below the ring kernel's: the ring's own point at
the launch size where the calibration has both, else its model
(:func:`small_tile_wins`).  Its tile and cluster, and where the family was
timed its price, come by waves from the calibration's timings of every
tile and cluster (the entry's ``plans``): a launch costs what the plan's
fullest timed launch of as many waves cost (:func:`small_tile_pick`).

A launch runs its level's real bootstraps packed across the V evaluations,
padded to whole tiles of the plan that serves them and no further than
the level's bucket (:func:`launch_rows`); the per-program prices price
those counts.

This module owns every kernel choice; the kernel layer runs what it is
handed and prices nothing.  :func:`pick_kernel` chooses a native family's
kernel, K1 or K2, by :func:`kernel_us`, the price of a call of each of the
calibration's launch sizes :data:`ROWS`, summed (``--orientation auto``).
:func:`launch_choice` chooses each family call's launch once: the count
launched, the path the launch record names, K1's route and its small-tile
plan's tile and cluster.  The executor lays its launches out by it and
hands it down to the kernel.
"""

from __future__ import annotations

import math

from typing import NamedTuple

from ..ops.blind_rotate import FUSED_HEADROOM, fused_key_bytes
from ..ops.fused_blind_rotate import (K1_SLICE, N_LIMBS, K1Plan, K1SmallPlan,
                                      K2Plan, k1_plan, k1_ring_plan,
                                      k1_wide_plan, k1s_clusters, k2_plan,
                                      unsupported)
from ..tfhe.params import TFHEParams
from .optimizer import (Solution, StagedSolution, bootstrap_cost_us,
                        calibration, h100_profile)

__all__ = ["predict_native_us", "predict_staged_us", "call_fixed_us",
           "slope_us", "launch_us", "kernel_us", "launch_plan", "bucket",
           "family_key", "entry_key", "resident_key", "shape_key",
           "small_tile_wins", "small_tile_us", "small_tile_plan",
           "small_tile_pick", "small_points", "launch_tile", "launch_rows",
           "k1_route", "takes_ring", "pick_kernel", "launch_choice",
           "LaunchChoice",
           "ROWS", "SMALL_ROWS"]

# Ciphertexts a call the calibration times (8 evaluations × 8 … 1024
# bootstraps), and the launch sizes ``kernel_us`` sums over.
ROWS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
# Ciphertexts a call the calibration times K1's small-tile plan at (N ≥
# 256): the launches of one evaluation (4 …) up to where the ring wins.
SMALL_ROWS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def family_key(params: TFHEParams) -> str:
    """A calibration entry's key: ``n,k,N,l,ks_l``."""
    return (f"{params.lwe_dim},{params.glwe_dim},{params.poly_size},"
            f"{params.bsk_level},{params.ksk_level}")


def entry_key(params: TFHEParams, orientation: str) -> str:
    """A calibration entry's key: ``n,k,N,l,ks_l/<kernel>``, one entry a
    family and kernel timed."""
    return f"{family_key(params)}/{orientation}"


def shape_key(params: TFHEParams) -> str:
    """The key of a shape ``(k+1)xNxl``: the small-tile plans the
    calibration timed fastest at it, and the resident table's small-N
    keys, end in it."""
    return f"{params.glwe_dim + 1}x{params.poly_size}x{params.bsk_level}"


def resident_key(orientation: str, n_limbs: int,
                 plan: K1Plan | K1SmallPlan | K2Plan,
                 params: TFHEParams | None = None) -> str:
    """The resident table's key of a plan: kernel, limbs, tile, cluster
    (and K1's width and, where its clusters carry two tiles, ``p2``; the
    small-N K1's cluster, n8 tiles a warp, digit passes a step and the
    shape (k+1)xNxl of ``params``, which sizes its shared memory and so
    how many fit, and its tile where not 16)."""
    if isinstance(plan, K1SmallPlan):
        tile = "" if plan.cb == 16 else f"t{plan.cb}/"
        return (f"k1s/{n_limbs}/{tile}{plan.cluster}/{plan.nt}/"
                f"{plan.passes}/{shape_key(params)}")
    if orientation == "fused_otf":
        pair = "/p2" if plan.pair == 2 else ""
        return f"k1/{n_limbs}/{plan.cb}/{plan.cluster}/{plan.nw}{pair}"
    return f"k2/{n_limbs}/{plan.cb}/{plan.cluster}"


def bucket(nb: int) -> int:
    """Power-of-two level padding (``CircuitExecutor``'s plans)."""
    b = 1
    while b < nb:
        b *= 2
    return b


def launch_tile(params: TFHEParams, rows: int, orientation: str | None,
                bsk_limbs: int = 4, route: str | None = None) -> int:
    """Ciphertexts a tile of the plan that serves a launch of ``rows``
    through ``orientation`` on the calibrated card (K1's on ``route``,
    default :func:`k1_route`'s; K2's); 1 for a
    path with no tile (None: the generic bootstrap, ``matmul``, the conv
    orientations)."""
    if orientation not in ("fused", "fused_otf"):
        return 1
    return launch_plan(params, rows, orientation, bsk_limbs, route)[0].cb


def launch_rows(params: TFHEParams, real: int, v: int,
                orientation: str | None, bsk_limbs: int = 4,
                route: str | None = None) -> int:
    """Ciphertexts a level's launch of ``real`` bootstraps an evaluation
    runs at ``v`` evaluations: ``v · r``, ``r`` the least count at or above
    ``real`` for which ``v · r`` fills whole tiles of the plan that serves
    ``v · real`` (:func:`launch_tile`), and at most the level's bucket.  The
    executor launches this many (:func:`launch_choice`); the program prices
    price them."""
    if real <= 0:
        return 0
    tile = launch_tile(params, v * real, orientation, bsk_limbs, route)
    step = tile // math.gcd(tile, v)
    return v * min(bucket(real), -(-real // step) * step)


def k1_route(params: TFHEParams, rows: int, n_limbs: int = N_LIMBS) -> str:
    """Which kernel a K1 launch of ``rows`` ciphertexts runs, as the launch
    record names it: ``"k1s"`` below N=K1_SLICE; above, ``"k1s"`` where the
    small-tile plan serves the family at ``n_limbs`` and the calibration
    prices it below the ring kernel's plan at ``rows``
    (:func:`small_tile_wins`), else ``"k1"``."""
    if params.poly_size < K1_SLICE:
        return "k1s"
    if not k1s_clusters(params, n_limbs):
        return "k1"
    return "k1s" if small_tile_wins(params, rows, n_limbs) else "k1"


def takes_ring(params: TFHEParams, counts, n_limbs: int = N_LIMBS) -> bool:
    """Whether a K1 family whose launches are ``counts`` ciphertexts may
    take the ring kernel, which reads a table of 16× its key
    (``FastKeys.hankel``): unless K1's small-tile plan serves the family
    and holds every one of those launches in one wave of its tiles.  There
    the ring takes no fewer waves, saves little (2.5% of AES-128's kernel
    time at one evaluation, by the calibration) and would build the
    table, so every launch stays on the small tiles; elsewhere each launch
    takes the route :func:`k1_route` prices (as where the calibration
    has no price of the small tiles at the family)."""
    if (params.poly_size < K1_SLICE or not k1s_clusters(params, n_limbs)
            or small_tile_us(params, 1, n_limbs) is None):
        return True
    return any(small_tile_plan(params, r, n_limbs)[1] > 1
               for r in counts if r > 0)


def _small_tile(params: TFHEParams, rows: int, n_limbs: int,
                route: str | None = "k1s") -> tuple[int, int] | None:
    """(tile, cluster) of K1's small-tile plan for a launch of ``rows`` on
    ``route``: :func:`small_tile_pick`'s, where the route takes that plan
    (``"k1s"`` at N ≥ K1_SLICE) and the pick serves ``n_limbs``; else None
    (the kernel then takes the fewest waves on the card,
    :func:`..ops.fused_blind_rotate.k1_wide_plan`)."""
    if route != "k1s" or params.poly_size < K1_SLICE:
        return None
    pick = small_tile_pick(params, rows)
    if pick is not None and pick[1] in k1s_clusters(params, n_limbs,
                                                     pick[0]):
        return pick
    return None


class LaunchChoice(NamedTuple):
    """One family call's launch, as :func:`launch_choice` chooses it."""

    launched: int        # ciphertexts launched
    path: str            # as the launch record names it
    route: str | None    # K1's (fused_blind_rotate.K1_ROUTES); None off K1
    tile: tuple[int, int] | None   # K1's small-tile (tile, cluster), N ≥ 256


def launch_choice(params: TFHEParams, real: int, v: int,
                  orientation: str | None, bsk_limbs: int = N_LIMBS,
                  route: str | None = None,
                  card: bool = True, ring: bool = True) -> LaunchChoice:
    """The launch of a family call of ``real`` bootstraps an evaluation at
    ``v`` evaluations through ``orientation`` (None: the generic bootstrap)
    at ``bsk_limbs``, decided once for the executor's layout, its launch
    record and the kernel:

    * ``launched``: :func:`launch_rows` on the card; off it (``card``
      False) no kernel has tiles, so the real rows, ``v · real``;
    * ``path``: ``"k2"`` for ``"fused"``, K1's route for ``"fused_otf"``,
      the orientation's name for a library one, ``"generic"`` for None;
    * ``route``: K1's, :func:`k1_route`'s at ``v · real`` unless ``route``
      (``FastKeys.route``) names one at N ≥ K1_SLICE, or ``ring`` is False
      (the family's :func:`takes_ring`), which keeps it on the small-tile
      plan; None for another orientation;
    * ``tile``: on the card, where K1 takes its small-tile plan, that
      plan's (tile, cluster) (:func:`_small_tile`), else None."""
    rows, tile = v * real, None
    if orientation == "fused_otf":
        if route is None and not ring and params.poly_size >= K1_SLICE:
            route = "k1s"
        if route is None or params.poly_size < K1_SLICE:
            route = k1_route(params, rows, bsk_limbs)
        path = route
        if card:
            tile = _small_tile(params, rows, bsk_limbs, route)
    else:
        route = None
        path = "k2" if orientation == "fused" else orientation or "generic"
    launched = launch_rows(params, real, v, orientation if card else None,
                           bsk_limbs, route)
    return LaunchChoice(launched, path, route, tile)


def pick_kernel(params: TFHEParams, memory: float, bsk_limbs: int = N_LIMBS,
                headroom: float = FUSED_HEADROOM, served: bool = True,
                profile=None) -> str:
    """The kernel one native family takes, ``"fused"`` (K2) or
    ``"fused_otf"`` (K1).  K1 where K2 does not serve ``params`` or its key
    matrices plus ``headroom`` do not fit ``memory`` bytes; K2 where K1
    does not serve them; else the one of the lower calibrated price
    (:func:`kernel_us`: a call of each launch size the calibration timed,
    summed, at ``profile``'s per-boot costs), K1 on a tie.  Without
    ``served`` (the JAX module's model) no kernel's rules apply and the
    matrices' fit alone decides.  The runtime CLI's ``--orientation auto``
    passes the card's free memory, the cost model its device profile's, so
    the model prices the kernel that runs."""
    if served and unsupported(params, otf=False) is not None:
        return "fused_otf"
    if fused_key_bytes(params, bsk_limbs) + headroom > memory:
        return "fused_otf"
    if not served or unsupported(params, otf=True) is not None:
        return "fused"
    k2 = kernel_us(params, "fused", bsk_limbs, profile)
    return "fused" if k2 < kernel_us(params, "fused_otf", bsk_limbs,
                                     profile) else "fused_otf"


def _orientation(params: TFHEParams, orientation: str | None,
                 bsk_limbs: int, staged: bool = False) -> str:
    if orientation is not None:
        return orientation
    return h100_profile().kernel(params.lwe_dim, params.glwe_dim,
                                 params.poly_size, params.bsk_level,
                                 params.ksk_level, bsk_limbs, staged)


# launch_plan's, small_tile_wins' and kernel_us' answers, per calibration
# (held beside them, so that its id names it while cached)
_PLANS: dict = {}
_ROUTES: dict = {}
_PRICES: dict = {}
_WAVES: dict = {}
_PICKS: dict = {}


def _resident(table: dict, sms: int, orientation: str, n_limbs: int,
              params: TFHEParams):
    def resident(plan):
        return table.get(resident_key(orientation, n_limbs, plan, params),
                         sms // plan.cluster)
    return resident


def _tiles_a_cluster(plan) -> int:
    """Tiles a cluster of ``plan`` carries: the ring kernel's ``pair``, one
    on every other plan."""
    return plan.pair if isinstance(plan, K1Plan) else 1


def _kernel_term(params: TFHEParams, plan, waves: int, cost_us: float,
                 fit: tuple[float, float, float]) -> float:
    """µs of a launch's kernel: the fit's fixed term and ``waves`` waves of
    ``plan`` at ``cost_us`` a bootstrap (a wave: as many clusters of one
    tile as the card holds, ``cb · sms / cluster`` bootstraps, or of two
    tiles in turns, the fit's ``pair_scale`` times that)."""
    fixed, scale, pair_scale = fit
    wave = (plan.cb * calibration()["sms"] / plan.cluster * cost_us * scale
            * (pair_scale if _tiles_a_cluster(plan) == 2 else 1.0))
    return fixed + waves * wave


def small_points(params: TFHEParams) -> list | None:
    """K1's small-tile plan at N ≥ 256 at the launch sizes :data:`SMALL_ROWS`
    at 4 limbs, [rows, kernel µs] each: the family's own calibrated points
    (its ``.../k1s`` entry), else the fit across the families timed
    (``kernels["k1s_wide"]``), where the plan serves the family at both
    limbs the optimizer picks and families of its (k, N) were timed
    (``rings``): n times the µs a step of its shape where families of that
    shape were timed (``shapes``), else at each launch size a fixed µs a
    step and a scale of the per-boot cost, n·step_us + scale·cost; else
    None."""
    cal = calibration()
    entry = cal["families"].get(entry_key(params, "k1s"))
    if entry is not None:
        return entry["points"]
    fit = cal["kernels"].get("k1s_wide")
    if (fit is None
            or [params.glwe_dim, params.poly_size] not in fit["rings"]
            or not all(k1s_clusters(params, limbs) for limbs in (3, 4))):
        return None
    shape = fit["shapes"].get(shape_key(params))
    if shape is not None:
        return [[r, params.lwe_dim * s] for r, s in zip(fit["rows"], shape)]
    cost = _cost(params, "fused_otf", 4)
    return [[r, params.lwe_dim * a + b * cost]
            for r, a, b in zip(fit["rows"], fit["step_us"], fit["scale"])]


def _wave_times() -> dict:
    """K1's small-tile plan at N ≥ 256 by waves, as the calibration timed
    it on every tile and cluster (the ``plans`` of each family's
    ``.../k1s`` entry, 4 limbs): ``{family key: {(tile, cluster):
    (resident, {waves: µs})}}``.  Cached per calibration."""
    cal = calibration()
    hit = _WAVES.get(id(cal))
    if hit is not None and hit[0] is cal:
        return hit[1]
    table = {key.split("/")[0]: {(t, c): (resident, dict(by_waves))
                                 for t, c, resident, by_waves in e["plans"]}
             for key, e in cal["families"].items()
             if e["kernel"] == "k1s" and "plans" in e}
    _WAVES[id(cal)] = (cal, table)
    return table


def _plan_us(timed: tuple[int, dict], cb: int, rows: int) -> float:
    """µs of a launch of ``rows`` on a small-tile plan of tile ``cb``
    timed as ``timed`` (resident clusters, {waves: µs}): the time of its
    waves where timed, linear in the waves between two wave counts timed,
    the fewest's below them, in proportion to the waves past the most."""
    resident, by_waves = timed
    tiles = -(-max(rows, 1) // cb)
    waves = -(-tiles // max(1, resident))
    if waves in by_waves:
        return by_waves[waves]
    counts = sorted(by_waves)
    if waves < counts[0]:
        return by_waves[counts[0]]
    if waves > counts[-1]:
        return by_waves[counts[-1]] * waves / counts[-1]
    hi = next(w for w in counts if w > waves)
    lo = max(w for w in counts if w < waves)
    return by_waves[lo] + (by_waves[hi] - by_waves[lo]) * (waves - lo) \
        / (hi - lo)


def small_tile_us(params: TFHEParams, rows: int, n_limbs: int = 4,
                  cost_us: float | None = None) -> float | None:
    """µs of the kernel of a K1 launch of ``rows`` ciphertexts on the
    small-tile plan at N ≥ 256, at 4 limbs scaled by the per-boot cost at
    ``n_limbs`` (or ``cost_us``) over that at 4 limbs.  Where the
    calibration timed the family on every tile and cluster, the price of
    :func:`small_tile_pick`'s plan by waves (flat within a wave, rising
    with them); else from :func:`small_points`: linear between the two
    points around ``rows``, the first below the first, in proportion to
    ``rows`` past the last.  None where it has neither."""
    own = _wave_times().get(family_key(params))
    pick = small_tile_pick(params, rows) if own else None
    if pick in (own or {}):
        us = _plan_us(own[pick], pick[0], rows)
    else:
        pts = small_points(params)
        if pts is None:
            return None
        if rows <= pts[0][0]:
            us = pts[0][1]
        elif rows >= pts[-1][0]:
            us = pts[-1][1] * rows / pts[-1][0]
        else:
            i = next(i for i in range(1, len(pts)) if rows <= pts[i][0])
            (r0, u0), (r1, u1) = pts[i - 1], pts[i]
            us = u0 + (u1 - u0) * (rows - r0) / (r1 - r0)
    if cost_us is None:
        cost_us = _cost(params, "fused_otf", n_limbs)
    return us * (cost_us / _cost(params, "fused_otf", 4))


def small_tile_wins(params: TFHEParams, rows: int,
                    n_limbs: int = 4) -> bool:
    """Whether a K1 launch of ``rows`` ciphertexts at N ≥ 256 takes the
    small-tile plan: it serves the family at ``n_limbs`` and its price
    (:func:`small_tile_us`) is below the ring kernel's at ``rows``.  Where
    the family has calibrated points of both at ``rows`` (the ring's in its
    ``.../fused_otf`` entry), point against point; else against the ring's
    model (its fixed term and waves on the calibrated card, at the
    calibrated per-boot cost at ``n_limbs``).  The rule :func:`k1_route`
    applies, and the native optimizer's."""
    cal = calibration()
    key = (id(cal), family_key(params), rows, n_limbs)
    hit = _ROUTES.get(key)
    if hit is not None and hit[0] is cal:
        return hit[1]
    small = (small_tile_us(params, rows, n_limbs)
             if k1s_clusters(params, n_limbs) else None)
    wins = False
    if small is not None:
        own = cal["families"].get(entry_key(params, "k1s"))
        ring_pts = dict((_entry(params, "fused_otf") or {}).get("points",
                                                                 ()))
        if own is not None and rows in ring_pts and rows in dict(
                own["points"]):
            wins = dict(own["points"])[rows] < ring_pts[rows]
        else:
            sms, table = cal["sms"], cal["resident"]
            resident = _resident(table, sms, "fused_otf", n_limbs, params)
            ring = k1_ring_plan(rows, params, sms, n_limbs,
                                resident=resident)
            ring_us = _kernel_term(params, ring,
                                   _waves(rows, ring, resident),
                                   _cost(params, "fused_otf", n_limbs),
                                   _kernel_fit(params, "fused_otf"))
            wins = small < ring_us
    _ROUTES[key] = (cal, wins)
    return wins


def small_tile_pick(params: TFHEParams, rows: int) -> tuple[int, int] | None:
    """(tile, cluster) of the small-tile plan the calibration prices
    lowest for a launch of ``rows`` at the shape of ``params``
    (:func:`shape_key`, at 4 limbs): each plan timed at every family of
    the shape priced by its waves at ``rows`` (:func:`_plan_us`), summed
    over those families; ties to the smaller tile, then the larger
    cluster.  None where it timed no family of that shape.  Cached per
    calibration: every launch asks for it."""
    cal, shape = calibration(), shape_key(params)
    key = (id(cal), shape, rows)
    hit = _PICKS.get(key)
    if hit is not None and hit[0] is cal:
        return hit[1]
    fams = [plans for fam, plans in _wave_times().items()
            if _key_shape(fam) == shape]
    pick = None
    if fams:
        common = set.intersection(*(set(plans) for plans in fams))
        pick = min(common, key=lambda t: (
            sum(_plan_us(plans[t], t[0], rows) for plans in fams),
            t[0], -t[1]))
    _PICKS[key] = (cal, pick)
    return pick


def _key_shape(key: str) -> str:
    """The shape ``(k+1)xNxl`` of a calibration key ``n,k,N,l,ks_l``."""
    _, k, N, l, _ = (int(x) for x in key.split(","))
    return f"{k + 1}x{N}x{l}"


def _waves(rows: int, plan, resident) -> int:
    clusters = -(-(-(-max(rows, 1) // plan.cb)) // _tiles_a_cluster(plan))
    return -(-clusters // max(1, resident(plan)))


def small_tile_plan(params: TFHEParams, rows: int,
                    n_limbs: int = 4) -> tuple[K1SmallPlan, int]:
    """K1's small-tile plan at N ≥ 256 for a launch of ``rows`` and its
    waves on the calibrated card, whether or not the route takes it."""
    cal = calibration()
    resident = _resident(cal["resident"], cal["sms"], "fused_otf", n_limbs,
                         params)
    cb, cluster = _small_tile(params, rows, n_limbs) or (None, None)
    plan = k1_wide_plan(rows, params, cal["sms"], n_limbs, cluster,
                        resident, cb)
    return plan, _waves(rows, plan, resident)


def launch_plan(params: TFHEParams, rows: int, orientation: str,
                bsk_limbs: int = 4, route: str | None = None
                ) -> tuple[K1Plan | K1SmallPlan | K2Plan, int]:
    """The plan and the waves of one launch of ``rows`` ciphertexts through
    ``orientation`` on the calibrated card; K1's at N ≥ 256 on ``route``
    (default :func:`k1_route`'s), its small-tile plan on
    :func:`_small_tile`'s tile and cluster."""
    cal = calibration()
    if orientation == "fused_otf" and route is None:
        route = k1_route(params, rows, bsk_limbs)
    key = (id(cal), family_key(params), rows, orientation, bsk_limbs,
           route if orientation == "fused_otf" else None)
    hit = _PLANS.get(key)
    if hit is not None and hit[0] is cal:
        return hit[1]
    sms, table = cal["sms"], cal["resident"]
    resident = _resident(table, sms, orientation, bsk_limbs, params)
    if orientation == "fused_otf":
        cb, cluster = _small_tile(params, rows, bsk_limbs, route) \
            or (None, None)
        plan = k1_plan(rows, params, sms, bsk_limbs, cb, cluster,
                       resident=resident, route=route)
    else:
        plan = k2_plan(rows, params, sms, bsk_limbs, resident=resident)
    out = plan, _waves(rows, plan, resident)
    _PLANS[key] = (cal, out)
    return out


def _entry(params: TFHEParams, orientation: str) -> dict | None:
    return calibration()["families"].get(entry_key(params, orientation))


def _kernel_fit(params: TFHEParams, orientation: str
                ) -> tuple[float, float, float]:
    """(fixed µs, scale of the per-boot cost, a paired wave's time over a
    wave of one tile) of a call through ``orientation`` at ``params``: the
    family's own calibration entry, else the fit across the kernel's
    families; below N=K1_SLICE K1 runs its small-N kernel, whose fit is
    ``k1s`` (where the calibration has one).  K1's small-tile plan at N ≥
    K1_SLICE is priced apart (:func:`small_tile_us`).  A paired wave
    counts as its two tiles' bootstraps where the calibration has not
    timed one."""
    kernels = calibration()["kernels"]
    pair_scale = kernels.get(orientation, {}).get("pair_scale", 2.0)
    entry = _entry(params, orientation)
    if entry:
        return (entry["fixed_us"], entry["scale"],
                entry.get("pair_scale", pair_scale))
    fit = kernels[orientation]
    if orientation == "fused_otf" and params.poly_size < K1_SLICE:
        fit = kernels.get("k1s", fit)
    return fit["fixed_us"], fit.get("scale", 1.0), pair_scale


def _cost(params: TFHEParams, orientation: str, bsk_limbs: int) -> float:
    return bootstrap_cost_us(params.lwe_dim, params.glwe_dim,
                             params.poly_size, params.bsk_level,
                             params.ksk_level, bsk_limbs,
                             orientation=orientation)


def _around(params: TFHEParams, orientation: str) -> tuple[float, float]:
    fit = _entry(params, orientation) or calibration()["around"]
    return fit["around_a_us"], fit["around_b_us"]


def launch_us(params: TFHEParams, rows: int, orientation: str | None = None,
              bsk_limbs: int = 4, staged: bool = False,
              cost_us: float | None = None,
              route: str | None = None) -> float:
    """µs of one family call of ``rows`` ciphertexts: the kernel's fixed
    term and waves, and the level's work around it.  ``cost_us``: the
    per-boot roofline cost (default the kernel's at ``bsk_limbs``);
    ``route``: K1's (default :func:`k1_route`'s)."""
    orient = _orientation(params, orientation, bsk_limbs, staged)
    if cost_us is None:
        cost_us = _cost(params, orient, bsk_limbs)
    plan, waves = launch_plan(params, rows, orient, bsk_limbs, route)
    if isinstance(plan, K1SmallPlan) and params.poly_size >= K1_SLICE:
        kernel = small_tile_us(params, rows, bsk_limbs, cost_us)
        if kernel is None:
            raise ValueError(f"{family_key(params)}: no calibrated points "
                             f"of K1's small-tile plan")
    else:
        kernel = _kernel_term(params, plan, waves, cost_us,
                              _kernel_fit(params, orient))
    a, b = _around(params, orient)
    return kernel + a + b * rows * (params.big_dim + 1)


def kernel_us(params: TFHEParams, orientation: str, bsk_limbs: int = 4,
              profile=None) -> float:
    """µs of one call of each of :data:`ROWS` ciphertexts through
    ``orientation``, summed: the price ``auto`` compares the kernels by.
    Each call is :func:`launch_us` at the per-boot cost of ``profile``
    (default the calibrated H100's), summed in ``ROWS``' order (the native
    optimizer sums the same floats in the same order).  Cached per
    calibration, as :func:`launch_plan` is: the optimizer asks for every
    family of its grid."""
    cal = calibration()
    key = (id(cal), family_key(params), orientation, bsk_limbs, profile)
    hit = _PRICES.get(key)
    if hit is not None and hit[0] is cal:
        return hit[1]
    cost = bootstrap_cost_us(params.lwe_dim, params.glwe_dim,
                             params.poly_size, params.bsk_level,
                             params.ksk_level, bsk_limbs, profile,
                             orientation)
    total = 0.0
    for rows in ROWS:
        total += launch_us(params, rows, orientation, bsk_limbs,
                           cost_us=cost)
    _PRICES[key] = (cal, total)
    return total


def slope_us(params: TFHEParams, cost_us: float | None = None,
             orientation: str | None = None, bsk_limbs: int = 4) -> float:
    """Per-boot marginal cost (µs) at full waves: the roofline estimate
    (``cost_us``, default the kernel the model prices) scaled by the
    family's calibration (at K1's ring the cheaper of its waves of one
    tile a cluster and of two, whose two tiles take ``pair_scale`` times
    as long), and the per-row work around the kernel."""
    orient = _orientation(params, orientation, bsk_limbs)
    if cost_us is None:
        cost_us = _cost(params, orient, bsk_limbs)
    _, b = _around(params, orient)
    _, scale, pair_scale = _kernel_fit(params, orient)
    if orient == "fused_otf" and params.poly_size >= K1_SLICE:
        scale *= min(1.0, pair_scale / 2)
    return cost_us * scale + b * (params.big_dim + 1)


def call_fixed_us(params: TFHEParams, rows: int,
                  orientation: str | None = None,
                  bsk_limbs: int = 4) -> float:
    """What one call of ``rows`` ciphertexts costs beyond ``rows`` times the
    per-boot slope: the fixed terms and the waves' padding."""
    orient = _orientation(params, orientation, bsk_limbs)
    return launch_us(params, rows, orient, bsk_limbs) \
        - rows * slope_us(params, None, orient, bsk_limbs)


def predict_native_us(sol: Solution, level_nbs: list[int], batch: int,
                      orientation: str | None = None) -> float:
    """Per-evaluation runtime (µs) of the native single-family plan: one
    call a level of its ``nb`` bootstraps × ``batch`` packed
    (:func:`launch_rows`), through ``orientation``; by default the kernel
    the model prices for ``sol``, at ``sol.cost`` a bootstrap, as the JAX
    model takes it."""
    cost = sol.cost if orientation is None else None
    orient = _orientation(sol.params, orientation, sol.bsk_limbs)
    route = _family_route(sol.params, orient, [batch * nb for nb in level_nbs],
                          sol.bsk_limbs)
    total = 0.0
    for nb in level_nbs:
        rows = launch_rows(sol.params, nb, batch, orient, sol.bsk_limbs,
                           route)
        total += launch_us(sol.params, rows, orientation, sol.bsk_limbs,
                           cost_us=cost, route=route) / batch
    return total


def _family_route(params: TFHEParams, orientation: str, counts,
                  bsk_limbs: int = N_LIMBS) -> str | None:
    """K1's route for every launch of a family whose launches are
    ``counts`` where it may not take the ring (:func:`takes_ring`), the
    small-tile plan's; else None (each launch's own)."""
    if orientation != "fused_otf" or takes_ring(params, counts, bsk_limbs):
        return None
    return "k1s"


def predict_staged_us(ssol: StagedSolution,
                      level_routes: list[tuple[int, int, int]],
                      batch: int, orientation: str | None = None) -> float:
    """Per-evaluation runtime (µs) of the staged dual-family plan.

    ``level_routes``: per-level (n_split, n_f1, n_f2) from
    :func:`..runtime.executor.staged_level_routes`: each level runs one fam1
    call of ``ns + nf1`` bootstraps and one fam2 call of ``ns + nf2``, each
    times ``batch`` and packed (:func:`launch_rows`), through
    ``orientation`` (default K1, which runs both staged families)."""
    fams = ((0, ssol.params1), (1, ssol.params2))
    orients = [_orientation(p, orientation, 4, True) for _, p in fams]
    routes = [_family_route(p, o, [batch * (r[0] + r[1 + i])
                                   for r in level_routes])
              for (i, p), o in zip(fams, orients)]
    total = 0.0
    for ns, nf1, nf2 in level_routes:
        for nbs, (_, params), orient, route in zip(
                (ns + nf1, ns + nf2), fams, orients, routes):
            if nbs:
                rows = launch_rows(params, nbs, batch, orient, 4, route)
                total += launch_us(params, rows, orientation, staged=True,
                                   route=route) / batch
    return total
