"""Fused blind rotation: the whole n-step recurrence in one kernel launch.

Hopper counterparts of the two Pallas kernel bodies in
``tfhe_fbs_map_tpu/ops/fused_blind_rotate.py`` (``pl.pallas_call`` at
``:351``, reached through ``_blind_rotate_call`` and
``blind_rotate_fused``):

* **K2** (orientation ``"fused"``, ``csrc/fused_blind_rotate_k2.cu``)
  replaces ``_kernel`` (``:102-142``).  Each step multiplies the int8 gadget
  digits [B, K] (K = rows·N) by a precomputed negacyclic key matrix, stored
  K-major as [L·(k+1)·N, K] int8 (the transpose of the JAX layout), and
  shift-adds the L limbs.  A step's key is 18.9 MB at the ``aes128_p4``
  preset (10.9 GB a launch), so what bounds K2 is how many ciphertexts
  share each key byte that reaches an SM.  A tile of ``cb`` (16-128)
  ciphertexts runs on a thread-block cluster of ``cluster`` CTAs; each CTA
  owns 1/cluster of the (k+1)·N output coefficients with all their limbs,
  reads only those key columns, and contracts on int8 tensor cores
  (``wgmma`` m64n(32L)k32) from a ring of shared-memory stages that TMA
  fills.  The accumulator lives in the output tensor and the digits in an
  L2-resident scratch, ordered between CTAs by cluster barriers.  On the
  H100 the ring's loads bound it, so :func:`k2_plan` picks the tile and
  the cluster that stream the fewest bytes a CTA in one wave of clusters.
* **K1** (orientation ``"fused_otf"``, ``csrc/fused_blind_rotate.cu``)
  replaces ``_kernel_otf`` (``:160-242``).  The key is the compact
  anti-periodic limb extension ``E = [limbs(−poly), limbs(poly)]`` ∈
  int8[2N] per (step, chunk, row), 73.7 KB a step at ``aes128_p4``, and the
  negacyclic matrix is ``M[j, t] = E[N+t−j]``.  K1 runs K2's schedule
  (cluster tiles of 64 or 128 ciphertexts, ACC in the output tensor,
  digits in an L2 scratch, ``wgmma``) but streams only the digits: the
  digit pass writes each row's digits reversed (j' = N−1−j), which makes
  the key operand a Hankel matrix ``B'[t, j'] = E[t+j'+1]``, and every
  8×16-byte core matrix of it is a 128-byte block ``H[w][i][c] =
  E[8w+i+1+c]``.  A producer warpgroup builds each ring stage's H blocks
  in shared memory from E while two consumer warpgroups point no-swizzle
  ``wgmma`` descriptors into them.  :func:`k1_plan` picks the tile, the
  cluster and the coefficients a warpgroup (``nw``, the ``wgmma`` width)
  by the shared-memory operand bytes a CTA reads; the kernel sizes its
  ring itself (:func:`k1_layout`).

The monomial rotation X^a·x, which the TPU does with a barrel shifter
because Mosaic has no lane rotate, is an index read in both.

Beside each kernel is its plain PyTorch version.  The wrappers take the
plain version only for tensors on the CPU; for CUDA tensors they launch the
kernel or raise.  ``LAUNCHES`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from ..tfhe.numeric import I32, I64, int8_matmul, u32, wrap32
from ..tfhe.params import TFHEParams

__all__ = ["blind_rotate_fused", "blind_rotate_k1", "blind_rotate_k2",
           "blind_rotate_k1_plain", "blind_rotate_k2_plain", "k1_plan",
           "k2_plan", "k1_device_plan", "device_plan", "k1_layout", "K1Plan",
           "K2Plan", "LAUNCHES"]

N_LIMBS = 4
LAUNCHES = {"k1": 0, "k2": 0}

# Shared memory a block may opt into on sm_90 (227 KB).
SMEM_MAX = 232448
# K1: ciphertexts per cluster tile and coefficients per warpgroup (the
# wgmma's N) it is instantiated for, largest first; contraction bytes per
# ring stage; accumulator registers a thread may hold ((cb/64)·L·nw/2);
# CTAs a cluster; the largest N it serves: chip_smoke.py phase 11 (a) holds
# it bitwise against its plain version at N = 4096 (k=1, every plan k1_plan
# picks for 64, 512 and 2048 ciphertexts, 4 and 3 limbs, a ragged tile) and
# runs it at full length there (n=700, 512 ciphertexts).
K1_TILES = (128, 64)
K1_WIDTHS = (64, 32)
K1_SLICE = 256
K1_ACC_REGS = 128
K1_MAX_CLUSTER = 16
K1_MAX_N = 4096
# K2: ciphertexts per cluster tile it is instantiated for, largest first;
# coefficients per column chunk (times L limbs: the GEMM columns one pass
# holds in registers); contraction bytes per ring stage; digit rows a stage
# holds at least (wgmma's M); shared memory beside the ring (1024-byte
# alignment of the swizzled tiles, the stages' mbarriers); ring stages (3
# measured fastest on the H100, 2 and 4 slower); CTAs a cluster (above 8 a
# non-portable size, which the H100 allows up to 16).
K2_TILES = (128, 64, 32, 16)
K2_CHUNK = 64
K2_KC = 128
K2_ROWS = 64
K2_SMEM_EXTRA = 2048
K2_MAX_STAGES = 3
K2_MAX_CLUSTER = 16


# --------------------------------------------------------------- plain

def barrel_rotate(x: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """X^amt · x with per-row amounts, equal to the TPU ``_barrel_rotate``.

    ``x``: [R, N] int32; ``amt``: [R, 1] in [0, 2N).  The cyclic rotation by
    ``amt mod N``, negated where ``(t < amt mod N) XOR (amt >= N)``."""
    n = x.shape[-1]
    amt = amt.to(I64)
    a = amt & (n - 1)
    t = torch.arange(n, device=x.device)
    src = (t - a) & (n - 1)
    out = torch.gather(x.to(I64), 1, src.expand(x.shape))
    neg = (t < a) ^ ((amt & n) != 0)
    return wrap32(torch.where(neg, -out, out))


def decompose_digits(diff: torch.Tensor, base_log: int,
                     levels: int) -> list[torch.Tensor]:
    """Balanced signed gadget digits, most-significant level first, by the
    biased add of the TPU ``_decompose_digits``: adding ``half`` at every
    level position lets the digit carries ride one add's carry chain."""
    b, l = base_log, levels
    closest = ((u32(diff) + (1 << (31 - b * l))) & 0xFFFFFFFF) >> (32 - b * l)
    half, mask = 1 << (b - 1), (1 << b) - 1
    w = (closest + sum(half << (b * i) for i in range(l))) & 0xFFFFFFFF
    return [(((w >> (b * i)) & mask) - half).to(I32) for i in range(l)][::-1]


def _init_acc(b_init, test_polys, params: TFHEParams) -> torch.Tensor:
    """ACC = (0, …, 0, X^{b_init}·tv): [k+1, B, N] int32."""
    k1 = params.glwe_dim + 1
    batch, n = test_polys.shape
    acc = torch.zeros((k1, batch, n), dtype=I32, device=test_polys.device)
    acc[k1 - 1] = barrel_rotate(test_polys, b_init)
    return acc


def _step_digits(acc: torch.Tensor, amt: torch.Tensor,
                 params: TFHEParams) -> torch.Tensor:
    """Digits of X^amt·ACC − ACC as int8 [B, rows·N], row (c·l + lev)."""
    k1, batch, n = acc.shape
    l = params.bsk_level
    flat = acc.reshape(k1 * batch, n)
    diff = wrap32(barrel_rotate(flat, amt.repeat(k1, 1)).to(I64)
                  - flat.to(I64))
    d = torch.stack(decompose_digits(diff, params.bsk_base_log, l))
    return d.reshape(l, k1, batch, n).permute(2, 1, 0, 3) \
        .reshape(batch, k1 * l * n).to(torch.int8)


def _accumulate(acc: torch.Tensor, prods: torch.Tensor,
                n_limbs: int) -> torch.Tensor:
    """ACC[comp] += Σ_limb prods[:, limb, comp] << 8·(limb + drop)."""
    k1, batch, n = acc.shape
    drop = N_LIMBS - n_limbs
    p = prods.reshape(batch, n_limbs, k1, n).to(I64)
    scale = torch.tensor([1 << (8 * (m + drop)) for m in range(n_limbs)],
                         dtype=I64, device=acc.device)
    add = (p * scale[None, :, None, None]).sum(1)         # [B, k+1, N]
    return wrap32(acc.to(I64) + add.permute(1, 0, 2))


def otf_matrix(ext: torch.Tensor, n: int) -> torch.Tensor:
    """Compact extensions [L·(k+1), rows, 2N] -> the step's negacyclic key
    matrix [rows·N, L·(k+1)·N] (the JAX ``"fused"`` layout; K2's is its
    transpose): M[(r, j), (chunk, t)] = E[chunk, r, N + t − j]."""
    ar = torch.arange(n, device=ext.device)
    idx = n + ar[None, :] - ar[:, None]                   # [j, t]
    m = ext[:, :, idx]                                    # [C, rows, j, t]
    chunks, rows = ext.shape[:2]
    return m.permute(1, 2, 0, 3).reshape(rows * n, chunks * n)


def blind_rotate_k2_plain(b_init, a_t, test_polys, kernels,
                          params: TFHEParams) -> torch.Tensor:
    """Plain version of K2: keys [n, L·(k+1)·N, rows·N] int8, K-major (each
    step's matrix is the transpose of the JAX layout's)."""
    k1, n = params.glwe_dim + 1, params.poly_size
    n_limbs = kernels.shape[1] // (k1 * n)
    acc = _init_acc(b_init, test_polys, params)
    for i in range(a_t.shape[0]):
        dig = _step_digits(acc, a_t[i], params)
        acc = _accumulate(acc, int8_matmul(dig, kernels[i].t()), n_limbs)
    return acc


def blind_rotate_k1_plain(b_init, a_t, test_polys, kernels,
                          params: TFHEParams) -> torch.Tensor:
    """Plain version of K1: keys [n, L·(k+1), rows, 2N] int8."""
    k1, n = params.glwe_dim + 1, params.poly_size
    n_limbs = kernels.shape[1] // k1
    acc = _init_acc(b_init, test_polys, params)
    for i in range(a_t.shape[0]):
        dig = _step_digits(acc, a_t[i], params)
        mat = otf_matrix(kernels[i], n)
        acc = _accumulate(acc, int8_matmul(dig, mat), n_limbs)
    return acc


# ------------------------------------------------------------- kernels

class K1Plan(NamedTuple):
    """How K1 launches: ``cb`` ciphertexts per tile, ``cluster`` CTAs per
    tile (CTA r owns coefficients [r·span, (r+1)·span) of the (k+1)·N, span
    = (k+1)·N / cluster), ``nw`` coefficients per warpgroup (a column chunk
    is 2·nw).  The kernel sizes its ring from (limbs, cb, nw):
    :func:`k1_layout`."""
    cb: int
    cluster: int
    nw: int


class K2Plan(NamedTuple):
    """How K2 launches: ``cb`` ciphertexts per tile, ``cluster`` CTAs per
    tile (CTA r owns coefficients [r·span, (r+1)·span) of the (k+1)·N, span
    = (k+1)·N / cluster), ``chunk`` coefficients per column chunk,
    ``stages`` shared-memory ring stages, ``smem`` bytes a CTA."""
    cb: int
    cluster: int
    chunk: int
    stages: int
    smem: int


def k1_clusters(params: TFHEParams, nw: int) -> list[int]:
    """Cluster sizes whose CTAs split the (k+1)·N coefficients into whole
    2·nw-coefficient chunks, largest first."""
    kn = (params.glwe_dim + 1) * params.poly_size
    return [c for c in range(K1_MAX_CLUSTER, 0, -1) if kn % (c * 2 * nw) == 0]


def k1_fits(cb: int, nw: int, n_limbs: int) -> bool:
    """Whether K1 is instantiated for (cb, nw) at ``n_limbs``: at most
    K1_ACC_REGS accumulator registers a thread."""
    return cb // 64 * n_limbs * nw // 2 <= K1_ACC_REGS


def k1_plan(batch: int, params: TFHEParams, sms: int,
            n_limbs: int = N_LIMBS, cb: int | None = None,
            cluster: int | None = None, nw: int | None = None,
            resident: Callable[[K1Plan], int] | None = None) -> K1Plan:
    """K1's launch plan for ``batch`` ciphertexts on ``sms`` SMs.

    Among the tiles ``cb``, widths ``nw`` and cluster sizes that K1 is
    instantiated for (or the ones given), the cheapest by the shared-memory
    bytes the ``wgmma`` operands take per CTA: a CTA multiplies cb digit
    rows by span·L key columns a step, and each m64n(nw)k32 reads 2 KB of
    digits and nw·32 bytes of H, so the cost is waves × span × cb × (64 +
    nw) / nw.  A wave is as many clusters as ``resident(plan)`` says the
    card runs at once (default ``sms // cluster``).  Ties go to fewer CTAs,
    then larger tiles and widths."""
    if resident is None:
        def resident(p):
            return sms // p.cluster
    kn = (params.glwe_dim + 1) * params.poly_size
    best = None
    for t in [cb] if cb is not None else K1_TILES:
        for w in [nw] if nw is not None else K1_WIDTHS:
            if not k1_fits(t, w, n_limbs):
                continue
            for c in k1_clusters(params, w):
                if cluster is not None and c != cluster:
                    continue
                plan = K1Plan(t, c, w)
                tiles = -(-max(batch, 1) // t)
                waves = -(-tiles // max(1, resident(plan)))
                key = (waves * (kn // c) * t * (64 + w) / w, tiles * c,
                       -t, -w)
                if best is None or key < best[0]:
                    best = (key, plan)
    if best is None:
        raise ValueError(f"K1 has no plan for cb={cb} cluster={cluster} "
                         f"nw={nw} at {n_limbs} limbs: a cluster must split "
                         f"the (k+1)·N coefficients into whole chunks")
    return best[1]


def k2_clusters(params: TFHEParams) -> list[int]:
    """Cluster sizes whose CTAs split the (k+1)·N coefficients into whole
    column chunks, largest first."""
    kn = (params.glwe_dim + 1) * params.poly_size
    return [c for c in range(K2_MAX_CLUSTER, 0, -1)
            if kn % (c * K2_CHUNK) == 0]


def k2_plan(batch: int, params: TFHEParams, sms: int,
            n_limbs: int = N_LIMBS, cb: int | None = None,
            cluster: int | None = None,
            resident: Callable[[K2Plan], int] | None = None) -> K2Plan:
    """K2's launch plan for ``batch`` ciphertexts on ``sms`` SMs.

    Among the tiles ``cb`` and cluster sizes that fit (or the ones given),
    the cheapest by the bytes a CTA streams: every ring stage carries
    max(cb, 64) digit rows and L·64 key rows, and a CTA runs (k+1)·N /
    cluster of the coefficients, so the cost is waves × (max(cb, 64) + L·64)
    / cluster.  A wave is as many clusters as ``resident(plan)`` says the
    card runs at once (default ``sms // cluster``: one CTA an SM).  Ties go
    to fewer CTAs, then larger tiles.  The ring takes as many stages as fit
    shared memory, at most K2_MAX_STAGES."""
    if resident is None:
        def resident(p):
            return sms // p.cluster
    best = None
    for t in [cb] if cb is not None else K2_TILES:
        rows = max(t, K2_ROWS) + n_limbs * K2_CHUNK
        stages = min(K2_MAX_STAGES,
                     (SMEM_MAX - K2_SMEM_EXTRA) // (rows * K2_KC))
        for c in [cluster] if cluster is not None else k2_clusters(params):
            plan = K2Plan(t, c, K2_CHUNK, stages,
                          stages * rows * K2_KC + K2_SMEM_EXTRA)
            tiles = -(-max(batch, 1) // t)
            waves = -(-tiles // max(1, resident(plan)))
            key = (waves * rows / c, tiles * c, -t)
            if best is None or key < best[0]:
                best = (key, plan)
    return best[1]


def _card_plan(dev: torch.device, plan_fn, max_clusters, tag: tuple):
    """``plan_fn(sms, resident)`` with the SM count of ``dev`` and the
    clusters the card runs at once, as ``max_clusters(plan)``
    (``cudaOccupancyMaxActiveClusters``) reports them; cached under
    ``tag``."""
    with torch.cuda.device(dev):
        index = torch.cuda.current_device()
        sms = torch.cuda.get_device_properties(index).multi_processor_count

        def resident(p):
            key = (index, *tag, p)
            if key not in _RESIDENT:
                _RESIDENT[key] = max_clusters(p)
            return _RESIDENT[key]

        return plan_fn(sms, resident)


def device_plan(batch: int, params: TFHEParams, dev: torch.device,
                n_limbs: int = N_LIMBS, cb: int | None = None,
                cluster: int | None = None) -> K2Plan:
    """The plan K2 launches with on ``dev``: :func:`k2_plan` with the
    card's SM count and the clusters it runs at once."""
    return _card_plan(dev, lambda sms, res: k2_plan(
        batch, params, sms, n_limbs, cb, cluster, res),
        lambda p: k2_max_clusters(p, n_limbs), ("k2", n_limbs))


def k1_device_plan(batch: int, params: TFHEParams, dev: torch.device,
                   n_limbs: int = N_LIMBS, cb: int | None = None,
                   cluster: int | None = None, nw: int | None = None,
                   lib: ctypes.CDLL | None = None) -> K1Plan:
    """The plan K1 launches with on ``dev``: :func:`k1_plan` with the
    card's SM count and the clusters it runs at once (as ``lib``, default
    the built library, reports them)."""
    return _card_plan(dev, lambda sms, res: k1_plan(
        batch, params, sms, n_limbs, cb, cluster, nw, res),
        lambda p: k1_max_clusters(p, n_limbs, lib),
        ("k1", n_limbs, getattr(lib, "_name", None)))


_RESIDENT: dict = {}


def unsupported(params: TFHEParams, otf: bool) -> str | None:
    """Why the CUDA kernel (K1 if ``otf`` else K2) cannot serve ``params``,
    or None when it can."""
    b, l, n = params.bsk_base_log, params.bsk_level, params.poly_size
    rows_n = (params.glwe_dim + 1) * l * n
    if b > 8:
        return f"bsk_base_log {b} > 8 does not fit int8 digits"
    if b * l >= 32:
        return f"bsk_base_log * bsk_level = {b * l} >= 32"
    if n % 32:
        return f"poly_size {n} is not a multiple of 32"
    if otf:
        if n % K1_SLICE:
            return f"poly_size {n} is not a multiple of {K1_SLICE}"
        if rows_n << (b + 6) >= 1 << 31:
            return (f"rows·N·2^(b-1)·128 = {rows_n << (b + 6)} could "
                    f"overflow the int32 sums")
        if n > K1_MAX_N:
            return (f"poly_size {n} > {K1_MAX_N}, the largest K1 is "
                    f"checked at on the card")
        return None
    if rows_n % K2_KC:
        return f"rows·N = {rows_n} is not a multiple of {K2_KC}"
    if not k2_clusters(params):
        return (f"(k+1)·N = {(params.glwe_dim + 1) * n} is not a multiple "
                f"of {K2_CHUNK}")
    return None


def _check(otf: bool, b_init, a_t, test_polys, kernels,
           params: TFHEParams) -> int:
    """Validate a launch's operands; returns the number of limbs."""
    dev = test_polys.device
    k1, n, l = params.glwe_dim + 1, params.poly_size, params.bsk_level
    rows = k1 * l
    batch = test_polys.shape[0]
    steps = a_t.shape[0]
    for name, x, dt in (("b_init", b_init, I32), ("a_t", a_t, I32),
                        ("test_polys", test_polys, I32),
                        ("kernels", kernels, torch.int8)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dt} tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    if otf:
        n_limbs = kernels.shape[1] // k1
        want = (steps, n_limbs * k1, rows, 2 * n)
    else:
        n_limbs = kernels.shape[1] // (k1 * n)
        want = (steps, n_limbs * k1 * n, rows * n)
    if (tuple(b_init.shape) != (batch, 1)
            or tuple(a_t.shape) != (steps, batch, 1)
            or tuple(test_polys.shape) != (batch, n)
            or tuple(kernels.shape) != want or not 1 <= n_limbs <= N_LIMBS):
        raise ValueError(
            f"shapes b_init {tuple(b_init.shape)} a_t {tuple(a_t.shape)} "
            f"test_polys {tuple(test_polys.shape)} kernels "
            f"{tuple(kernels.shape)} do not fit {params}")
    why = unsupported(params, otf)
    if why is None and kernels.data_ptr() % 16:
        why = "keys are not 16-byte aligned"
    if why is not None:
        raise ValueError(f"the fused CUDA kernel cannot serve {params}: {why}")
    return n_limbs


def _raise_on(err: int, lib: ctypes.CDLL | None = None) -> None:
    if err != 0:
        from . import _build
        msg = (lib or _build.library()).fbr_error_string(err)
        raise RuntimeError(f"fused blind rotation launch failed: "
                           f"{ctypes.string_at(msg).decode()} ({err})")


def _launch_k1(b_init, a_t, test_polys, kernels, params: TFHEParams,
               cb: int | None, cluster: int | None, nw: int | None,
               lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """K1 on the card, through ``lib`` (default the built library)."""
    from . import _build

    n_limbs = _check(True, b_init, a_t, test_polys, kernels, params)
    dev = test_polys.device
    k1, n = params.glwe_dim + 1, params.poly_size
    batch, steps = test_polys.shape[0], a_t.shape[0]
    if cb is not None and cb not in K1_TILES:
        raise ValueError(f"batch tile {cb} not in {K1_TILES}")
    if nw is not None and nw not in K1_WIDTHS:
        raise ValueError(f"width {nw} not in {K1_WIDTHS}")
    if batch == 0 or steps == 0:
        return _init_acc(b_init, test_polys, params)
    lib = lib or _build.library()
    out = torch.empty((k1, batch, n), dtype=I32, device=dev)
    plan = k1_device_plan(batch, params, dev, n_limbs, cb, cluster, nw,
                          lib)
    with torch.cuda.device(dev):
        tiles = -(-batch // plan.cb)
        dig = torch.empty((tiles * plan.cb, k1 * params.bsk_level * n),
                          dtype=torch.int8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fbr_k1_blind_rotate(
            b_init.data_ptr(), a_t.data_ptr(), test_polys.data_ptr(),
            kernels.data_ptr(), out.data_ptr(), dig.data_ptr(), steps, batch,
            n, k1, params.bsk_level, params.bsk_base_log, n_limbs, plan.cb,
            plan.nw, plan.cluster, stream)
    _raise_on(err, lib)
    LAUNCHES["k1"] += 1
    return out


def _launch_k2(b_init, a_t, test_polys, kernels, params: TFHEParams,
               cb: int | None, cluster: int | None) -> torch.Tensor:
    from . import _build

    n_limbs = _check(False, b_init, a_t, test_polys, kernels, params)
    dev = test_polys.device
    k1, n = params.glwe_dim + 1, params.poly_size
    batch, steps = test_polys.shape[0], a_t.shape[0]
    if cb is not None and cb not in K2_TILES:
        raise ValueError(f"batch tile {cb} not in {K2_TILES}")
    if cluster is not None and cluster not in k2_clusters(params):
        raise ValueError(f"cluster {cluster} not in {k2_clusters(params)}")
    if batch == 0 or steps == 0:
        return _init_acc(b_init, test_polys, params)
    out = torch.empty((k1, batch, n), dtype=I32, device=dev)
    plan = device_plan(batch, params, dev, n_limbs, cb, cluster)
    with torch.cuda.device(dev):
        tiles = -(-batch // plan.cb)
        dig = torch.empty((tiles * plan.cb, k1 * params.bsk_level * n),
                          dtype=torch.int8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().fbr_k2_blind_rotate(
            b_init.data_ptr(), a_t.data_ptr(), test_polys.data_ptr(),
            kernels.data_ptr(), out.data_ptr(), dig.data_ptr(), steps, batch,
            n, k1, params.bsk_level, params.bsk_base_log, n_limbs, plan.cb,
            plan.cluster, plan.stages, plan.smem, stream)
    _raise_on(err)
    LAUNCHES["k2"] += 1
    return out


def k2_max_clusters(plan: K2Plan, n_limbs: int = N_LIMBS) -> int:
    """Clusters of ``plan`` the current card runs at once
    (``cudaOccupancyMaxActiveClusters``)."""
    from . import _build

    count = ctypes.c_int(0)
    _raise_on(_build.library().fbr_k2_max_clusters(
        n_limbs, plan.cb, plan.cluster, plan.smem, ctypes.byref(count)))
    return count.value


def k1_max_clusters(plan: K1Plan, n_limbs: int = N_LIMBS,
                    lib: ctypes.CDLL | None = None) -> int:
    """Clusters of K1's ``plan`` the current card runs at once
    (``cudaOccupancyMaxActiveClusters``)."""
    from . import _build

    lib = lib or _build.library()
    count = ctypes.c_int(0)
    _raise_on(lib.fbr_k1_max_clusters(n_limbs, plan.cb, plan.nw,
                                      plan.cluster, ctypes.byref(count)), lib)
    return count.value


def k1_layout(plan: K1Plan, n_limbs: int = N_LIMBS,
              lib: ctypes.CDLL | None = None) -> tuple[int, int]:
    """The ring stages and the dynamic shared memory (bytes) a CTA of K1's
    ``plan`` launches with, as the kernel sizes them."""
    from . import _build

    lib = lib or _build.library()
    stages, smem = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(lib.fbr_k1_layout(n_limbs, plan.cb, plan.nw,
                                ctypes.byref(stages), ctypes.byref(smem)),
              lib)
    return stages.value, smem.value


def _plain_slices(otf: bool, b_init, a_t, test_polys, kernels,
                  params: TFHEParams, batch_tile: int | None):
    plain = blind_rotate_k1_plain if otf else blind_rotate_k2_plain
    batch = test_polys.shape[0]
    step = batch_tile or max(batch, 1)
    outs = [plain(b_init[s:s + step], a_t[:, s:s + step],
                  test_polys[s:s + step], kernels, params)
            for s in range(0, batch, step)] or \
        [_init_acc(b_init, test_polys, params)]
    return torch.cat(outs, dim=1)


def blind_rotate_k2(b_init, a_t, test_polys, kernels, params: TFHEParams,
                    batch_tile: int | None = None,
                    cluster: int | None = None) -> torch.Tensor:
    """K2 ("fused"): keys [n, L·(k+1)·N, rows·N] int8 -> ACC [k+1, B, N].

    ``batch_tile``: ciphertexts per tile (CPU: per plain slice; CUDA: per
    cluster, one of ``K2_TILES``); ``cluster``: CTAs per tile.  Both
    default to :func:`k2_plan`'s choice."""
    if test_polys.device.type != "cpu":
        return _launch_k2(b_init, a_t, test_polys, kernels, params,
                          batch_tile, cluster)
    return _plain_slices(False, b_init, a_t, test_polys, kernels, params,
                         batch_tile)


def blind_rotate_k1(b_init, a_t, test_polys, kernels, params: TFHEParams,
                    batch_tile: int | None = None,
                    cluster: int | None = None,
                    nw: int | None = None) -> torch.Tensor:
    """K1 ("fused_otf"): keys [n, L·(k+1), rows, 2N] int8 -> ACC.

    ``batch_tile``: ciphertexts per tile (CPU: per plain slice; CUDA: per
    cluster, one of ``K1_TILES``); ``cluster``: CTAs per tile; ``nw``:
    coefficients per warpgroup, one of ``K1_WIDTHS``.  All default to
    :func:`k1_plan`'s choice."""
    if test_polys.device.type != "cpu":
        return _launch_k1(b_init, a_t, test_polys, kernels, params,
                          batch_tile, cluster, nw)
    return _plain_slices(True, b_init, a_t, test_polys, kernels, params,
                         batch_tile)


def blind_rotate_fused(b_init, a_t, test_polys, kernels, params: TFHEParams,
                       batch_tile: int | None = None) -> torch.Tensor:
    """All-steps-fused blind rotation -> accumulator [k+1, B, N] int32.

    ``b_init``: [B, 1] int32 initial amounts ((2N − b~) mod 2N); ``a_t``:
    [n, B, 1] int32 per-step amounts in [0, 2N); ``test_polys``: [B, N]
    int32; ``kernels``: K2's [n, L·(k+1)·N, rows·N] or K1's
    [n, L·(k+1), rows, 2N] int8.  ``batch_tile``: ciphertexts per tile
    (CPU: per slice; CUDA: per cluster, default chosen by :func:`k1_plan`
    or :func:`k2_plan`); the last tile may be ragged."""
    fn = blind_rotate_k1 if kernels.ndim == 4 else blind_rotate_k2
    return fn(b_init, a_t, test_polys, kernels, params, batch_tile)
