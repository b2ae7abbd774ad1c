"""TFHE parameter optimizer: (precision p, sq_norm2) → (params, cost, p_error).

The port of ``tfhe_fbs_map_tpu.optimizer.optimizer``.  The grid searches,
their order and their ``cost >= best.cost`` pruning are the JAX module's;
the device constants are a :class:`DeviceProfile` that the cost function
reads.  The shipped profile is the H100's (:func:`h100_profile`): the data
sheet's int8 and memory rates, and the kernels' efficiencies, the memory K2's
matrices may take and the generic path's slowdown as ``calibrate`` fitted
them on the card (``calibration_h100.json``).  A profile built from the JAX
module's constants gives the JAX picks bit for bit
(``tests/test_torch_optimizer.py``).

On the H100 a candidate is a fast one only if a CUDA kernel serves it: the
gadget base fits int8 digits, the key switch's base fits int8, and
``fused_blind_rotate.unsupported`` is None for the kernel the model prices
(:meth:`DeviceProfile.kernel`, the rule ``--orientation auto`` runs).
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from pathlib import Path

from ..ops.blind_rotate import KSK_MAX_BASE_LOG
from ..ops.fused_blind_rotate import unsupported
from ..tfhe.params import Q, TFHEParams, min_noise_std_rel
from ..tfhe.staged import SELECT_P
from .noise import P_ERROR_4_SIGMA, p_error_atomic

__all__ = ["Solution", "StagedSolution", "DeviceProfile", "optimize",
           "optimize_staged", "bootstrap_cost_us", "format_solution_line",
           "h100_profile", "calibration", "CALIBRATION", "GLWE_SHAPES"]

CALIBRATION = Path(__file__).with_name("calibration_h100.json")
# the (k, N) GLWE shapes the native search walks, in its order
GLWE_SHAPES = ((1, 1024), (2, 512), (1, 2048), (2, 1024), (3, 512),
               (4, 512), (2, 2048), (1, 4096))


@dataclass(frozen=True)
class DeviceProfile:
    """The device constants of the cost model.

    ``int8_ops``: int8 operations a second (two a MAC); ``mem_bytes``:
    device-memory bytes a second; ``eff_fused`` / ``eff_otf``: the share of
    ``int8_ops`` K2 ("fused") and K1 ("fused_otf") reach per bootstrap at a
    full batch; ``k2_memory``: the bytes K2's key matrices plus
    ``k2_headroom`` may take; ``generic_slowdown``: the generic path's time
    per bootstrap over the roofline's.  ``cuda_kernels``: candidates must be
    served by the CUDA kernel the model prices, and both staged families run
    K1, as the runtime CLI runs them; off, the matrix rule alone picks the
    kernel and every int8-digit candidate is served (the JAX module's
    model)."""

    name: str
    int8_ops: float
    mem_bytes: float
    eff_fused: float
    eff_otf: float
    k2_memory: float
    k2_headroom: float
    generic_slowdown: float
    cuda_kernels: bool = True

    def kernel(self, n: int, k: int, N: int, br_l: int, ks_l: int,
               bsk_limbs: int = 4, staged: bool = False) -> str:
        """The kernel the model prices for a family of these sizes: K1 for
        a staged family, else :func:`.runtime_model.pick_kernel` at
        ``k2_memory``, priced at this profile's efficiencies: K1 where K2
        does not serve the family or its matrices do not fit, else the one
        of the lower calibrated price (``ks_l`` names the family's
        calibration entries; the gadget base enters neither kernel's size
        rules)."""
        from .runtime_model import pick_kernel    # it imports this module

        if staged and self.cuda_kernels:
            return "fused_otf"
        shell = TFHEParams(p=2, lwe_dim=n, glwe_dim=k, poly_size=N,
                           bsk_level=br_l, bsk_base_log=1, ksk_level=ks_l,
                           ksk_base_log=1, lwe_noise_std=0.0,
                           glwe_noise_std=0.0)
        return pick_kernel(shell, self.k2_memory, bsk_limbs,
                           self.k2_headroom, served=self.cuda_kernels,
                           profile=self)

    def serves(self, params: TFHEParams, bsk_limbs: int = 4,
               staged: bool = False) -> bool:
        """Whether the kernel the model prices for ``params`` runs it."""
        if not self.cuda_kernels:
            return True
        otf = self.kernel(params.lwe_dim, params.glwe_dim, params.poly_size,
                          params.bsk_level, params.ksk_level, bsk_limbs,
                          staged) == "fused_otf"
        return (params.ksk_base_log <= KSK_MAX_BASE_LOG
                and unsupported(params, otf) is None)


@functools.lru_cache(maxsize=1)
def calibration() -> dict:
    """The H100 calibration (``calibration_h100.json``, written by
    ``python -m tfhe_fbs_map_tpu_torch.optimizer.calibrate`` on the card),
    read once; callers must not modify it."""
    with open(CALIBRATION) as f:
        return json.load(f)


def h100_profile() -> DeviceProfile:
    """The shipped profile, from the calibration."""
    return DeviceProfile(**calibration()["profile"])


@dataclass(frozen=True)
class Solution:
    params: TFHEParams
    cost: float                # microseconds per bootstrap (batch-amortized)
    p_error: float
    bsk_limbs: int = 4         # < 4: limb-dropped (quantized) BSK matrices


def bootstrap_cost_us(n: int, k: int, N: int, br_l: int, ks_l: int,
                      bsk_limbs: int = 4, profile: DeviceProfile | None = None,
                      orientation: str | None = None) -> float:
    """Roofline model: µs per bootstrap at large batch.

    The larger of the blind rotation's and key switch's int8 operations over
    the rate of the kernel ``orientation`` (default: the one
    :meth:`DeviceProfile.kernel` prices) and the accumulator's bytes over the
    memory rate.  ``bsk_limbs`` < 4 (quantized BSK) removes the dropped
    limbs' MACs."""
    pr = profile or h100_profile()
    orient = orientation or pr.kernel(n, k, N, br_l, ks_l, bsk_limbs)
    eff = pr.eff_fused if orient == "fused" else pr.eff_otf
    # blind rotate: n conv steps of rows x N x (k+1) x N MACs per kept limb
    br_macs = n * (k + 1) ** 2 * br_l * N * N * bsk_limbs
    # keyswitch: kN*l x (n+1) matmul x 4 limbs
    ks_macs = k * N * ks_l * (n + 1) * 4
    compute_s = 2.0 * (br_macs + ks_macs) / (pr.int8_ops * eff)
    # per-ct device-memory traffic: ACC read+write+rotate per step
    acc_bytes = n * 3 * (k + 1) * N * 4
    mem_s = acc_bytes / pr.mem_bytes
    return max(compute_s, mem_s) * 1e6


def optimize(p: int, sq_norm2: float,
             max_p_error: float = P_ERROR_4_SIGMA,
             fast_path_only: bool = True,
             security_bits: int = 128,
             profile: DeviceProfile | None = None) -> Solution | None:
    """Grid-search the cheapest parameter set meeting the error target.

    The fast-path search first (int8 gadget digits, served by a kernel);
    where it finds nothing, the generic path's search, whose cost is scaled
    by the profile's ``generic_slowdown``.  None when neither meets the
    target.  ``fast_path_only`` and ``security_bits`` are accepted as the
    JAX module accepts them and change nothing."""
    pr = profile or h100_profile()
    best = _optimize_inner(p, sq_norm2, max_p_error, True, pr)
    if best is None:
        best = _optimize_inner(p, sq_norm2, max_p_error, False, pr)
        if best is not None:
            best = Solution(best.params,
                            best.cost * pr.generic_slowdown,
                            best.p_error)
    return best


def _optimize_inner(p: int, sq_norm2: float, max_p_error: float,
                    fast_path_only: bool,
                    pr: DeviceProfile) -> Solution | None:
    best: Solution | None = None

    glwe_shapes = GLWE_SHAPES
    # int8 digits (the fast path) need base ≤ 2^8; the generic path can use
    # wider digits
    max_base = 8 if fast_path_only else 12

    # BSK limb-drop quantization is a fast-path key layout knob: the generic
    # path always uses exact keys
    drops = (0, 1) if fast_path_only else (0,)

    for k, N in glwe_shapes:
        if N < 2 * p:        # need at least one poly coeff per half-window
            continue
        glwe_std = min_noise_std_rel(k * N) * Q
        for n in range(450, 1100, 32):
            lwe_std = min_noise_std_rel(n) * Q
            # the cost does not depend on the bases: one table per (k, N, n)
            costs = {(br_l, ks_l, drop): bootstrap_cost_us(
                n, k, N, br_l, ks_l, 4 - drop, pr)
                for br_l in range(1, 5) for ks_l in range(1, 9)
                for drop in drops}
            for br_b in range(4, max_base + 1):
                for br_l in range(1, 5):
                    if br_b * br_l > 32:
                        continue
                    for ks_b in range(2, max_base + 1):
                        for ks_l in range(1, 9):
                            if ks_b * ks_l > 32:
                                continue
                            for drop in drops:
                                cost = costs[br_l, ks_l, drop]
                                if best is not None and cost >= best.cost:
                                    continue
                                perr = p_error_atomic(
                                    p, sq_norm2, n, k, N, br_l, br_b, ks_l,
                                    ks_b, lwe_std, glwe_std,
                                    dropped_limbs=drop)
                                if perr > max_p_error:
                                    continue
                                params = TFHEParams(
                                    p=p, lwe_dim=n, glwe_dim=k, poly_size=N,
                                    bsk_level=br_l, bsk_base_log=br_b,
                                    ksk_level=ks_l, ksk_base_log=ks_b,
                                    lwe_noise_std=lwe_std,
                                    glwe_noise_std=glwe_std)
                                if fast_path_only and not pr.serves(
                                        params, 4 - drop):
                                    continue
                                best = Solution(params, cost, perr, 4 - drop)
    return best


@dataclass(frozen=True)
class StagedSolution:
    """Joint parameter pick for the staged multi-digit bootstrap
    (tfhe/staged.py): two families sharing n and the extracted dimension."""

    params1: TFHEParams        # stage-1 family (p//2 or p grid)
    params2: TFHEParams        # stage-2 family (p field = 8)
    cost: float                # total microseconds per staged bootstrap
    p_error: float             # sum of the two stage error probabilities


def optimize_staged(p: int, sq_norm1: float = 4.0, sq_norm2: float = 2.0,
                    max_p_error: float = P_ERROR_4_SIGMA,
                    big_dim: int = 1024,
                    wires_from_stage2: bool = True,
                    weight1: float = 1.0,
                    weight2: float = 1.0,
                    profile: DeviceProfile | None = None
                    ) -> StagedSolution | None:
    """Cheapest staged-pipeline parameters for a size-p node.

    ``weight1``/``weight2``: per-family boot counts of the target program
    (the executor's routing mix): the objective is the whole-program cost
    ``w1*cost1 + w2*cost2``, which ``StagedSolution.cost`` holds.  The two
    families share the small LWE dimension n and the extracted key dimension
    ``big_dim`` (one master GLWE secret), so the search is joint; each stage
    must meet ``max_p_error`` on its own.  Both families are priced on K1,
    which runs them, and a candidate K1 cannot serve is skipped (on a
    profile with ``cuda_kernels``)."""
    from .noise import (p_error_from_var, var_blind_rotate, var_keyswitch,
                        var_modswitch)
    pr = profile or h100_profile()
    if p % 2 or p < 8:
        return None
    # fam1 grid: p/2 when two-stage splits apply (p >= 32); the p grid
    # itself for p <= 16, where fam1 is the catch-all single-boot family
    stage1_p = p // 2 if p >= 2 * SELECT_P * 2 else p
    # select-family grid: SELECT_P when commensurable with the wire grid,
    # else p/2 (splits need SELECT_P exactly)
    select_p = SELECT_P if p % SELECT_P == 0 else p // 2
    # k restricted to the GLWE shapes the fused kernels were validated at
    shapes = [(k, big_dim // k) for k in (1, 2)
              if big_dim % k == 0 and big_dim // k >= 2 * select_p]

    def served(n, k, N, bl, bb, kl, kb) -> bool:
        return pr.serves(TFHEParams(p=2, lwe_dim=n, glwe_dim=k, poly_size=N,
                                    bsk_level=bl, bsk_base_log=bb,
                                    ksk_level=kl, ksk_base_log=kb,
                                    lwe_noise_std=0.0, glwe_noise_std=0.0),
                         staged=True)

    def candidates(n: int, min_N: int) -> list:
        """(cost, v_wire, ks_var, ms_var, k, N, bl, bb, kl, kb), cost-sorted.

        Per-(k,N,bl,kl) cost cell, only the noise-minimal (bb, kb) matter:
        keep the best v_wire per (k,N,bl) x bb and best ks_var per (kl,kb)."""
        lwe_std = min_noise_std_rel(n) * Q
        out = []
        for k, N in shapes:
            if N < min_N:
                continue
            g = min_noise_std_rel(k * N) * Q
            ms = var_modswitch(n, N)
            ks_best = {}
            for kb in range(2, 9):
                if pr.cuda_kernels and kb > KSK_MAX_BASE_LOG:
                    continue
                for kl in range(1, 9):
                    if kb * kl > 32:
                        continue
                    v = var_keyswitch(k, N, kl, kb, lwe_std)
                    if kl not in ks_best or v < ks_best[kl][0]:
                        ks_best[kl] = (v, kb)
            for bb in range(4, 9):
                for bl in range(1, 6):
                    vw = var_blind_rotate(n, k, N, bl, bb, g)
                    for kl, (ksv, kb) in ks_best.items():
                        if not served(n, k, N, bl, bb, kl, kb):
                            continue
                        orient = pr.kernel(n, k, N, bl, kl,
                                           staged=True)
                        out.append((bootstrap_cost_us(n, k, N, bl, kl,
                                                      profile=pr,
                                                      orientation=orient),
                                    vw, ksv, ms, k, N, bl, bb, kl, kb))
        out.sort(key=lambda t: t[0])
        return out

    best: StagedSolution | None = None
    for n in range(450, 1100, 32):
        lwe_std = min_noise_std_rel(n) * Q
        c2s = candidates(n, 2 * select_p)
        c1s = candidates(n, 2 * stage1_p)
        if not c2s or not c1s:
            continue
        min_c1 = c1s[0][0]
        for cost2, v2, ks2, ms2, k2, N2, bl2, bb2, kl2, kb2 in c2s:
            if best is not None \
                    and weight2 * cost2 + weight1 * min_c1 >= best.cost:
                break
            for cost1, v1, ks1, ms1, k1, N1, bl1, bb1, kl1, kb1 in c1s:
                tot = weight1 * cost1 + weight2 * cost2
                if best is not None and tot >= best.cost:
                    break
                # In the all-staged regime every circuit wire is a stage-2
                # output, so wire variance is v2; a mixed executor passes
                # wires_from_stage2=False for the conservative bound.
                vw = v2 if wires_from_stage2 else max(v1, v2)
                e1 = p_error_from_var(stage1_p,
                                      sq_norm1 * vw + ks1 + ms1)
                if e1 > max_p_error:
                    continue
                e2 = p_error_from_var(select_p,
                                      v1 + sq_norm2 * vw + ks2 + ms2)
                if e2 > max_p_error:
                    continue
                pr1 = TFHEParams(p=stage1_p, lwe_dim=n, glwe_dim=k1,
                                 poly_size=N1, bsk_level=bl1, bsk_base_log=bb1,
                                 ksk_level=kl1, ksk_base_log=kb1,
                                 lwe_noise_std=lwe_std,
                                 glwe_noise_std=min_noise_std_rel(k1 * N1) * Q)
                pr2 = TFHEParams(p=select_p, lwe_dim=n, glwe_dim=k2,
                                 poly_size=N2, bsk_level=bl2, bsk_base_log=bb2,
                                 ksk_level=kl2, ksk_base_log=kb2,
                                 lwe_noise_std=lwe_std,
                                 glwe_noise_std=min_noise_std_rel(k2 * N2) * Q)
                best = StagedSolution(pr1, pr2, tot, e1 + e2)
                break       # c1s is cost-sorted: first feasible is best here
    return best


def format_solution_line(sol: Solution) -> str:
    """Concrete-optimizer-compatible output row: the estimate pipeline
    parses ``split(',')[-2]`` as the cost."""
    pr = sol.params
    return (f"  {pr.glwe_dim}, {pr.poly_size}, {pr.lwe_dim}, "
            f"{pr.bsk_level},{pr.bsk_base_log}, "
            f"{pr.ksk_level},{pr.ksk_base_log}, "
            f"{int(round(sol.cost))}, {sol.p_error:.1e}")

