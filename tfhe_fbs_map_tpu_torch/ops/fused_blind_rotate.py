"""Fused blind rotation: the whole n-step recurrence in one kernel launch.

Hopper counterparts of the two Pallas kernel bodies in
``tfhe_fbs_map_tpu/ops/fused_blind_rotate.py`` (``pl.pallas_call`` at
``:351``, reached through ``_blind_rotate_call`` and
``blind_rotate_fused``):

* **K2** (orientation ``"fused"``) replaces ``_kernel`` (``:102-142``).  Each
  step multiplies the int8 gadget digits by a precomputed negacyclic
  key-matrix limb ``[rows·N, L·(k+1)·N]``.  Key reads weigh most: every
  block reads the whole ``[n, rows·N, L·(k+1)·N]`` key once per launch
  (10.9 GB at the ``aes128_p4`` preset), out of the 50 MB L2 that blocks
  working on the same step share.  Fewer, wider blocks read it fewer
  times, but the launch time does not follow the block count alone, and
  which level of the memory hierarchy bounds it is not measured yet
  (PERF.md, section 5).
* **K1** (orientation ``"fused_otf"``) replaces ``_kernel_otf``
  (``:160-242``).  The key is the compact anti-periodic limb extension
  ``E = [limbs(−poly), limbs(poly)]`` ∈ int8[2N] per (step, chunk, row), and
  the negacyclic matrix is read straight out of it, ``M[j, t] = E[N+t−j]``:
  no rotation strip.  Bound by MACs: its keys take 42.6 MB at
  ``aes128_p4``, which nearly fits the L2.

Both CUDA kernels (``csrc/fused_blind_rotate.cu``) keep one tile of
ciphertexts per block for all n steps, its accumulator ``[k+1, CB, N]``
uint32 and digits ``[CB, rows·N]`` int8 in shared memory, and contract
with ``dp4a``.  The monomial rotation X^a·x, which the TPU does with a
barrel shifter because Mosaic has no lane rotate, is an index read.

Beside each kernel is its plain PyTorch version.  The wrappers take the
plain version only for tensors on the CPU; for CUDA tensors they launch the
kernel or raise.  ``LAUNCHES`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from ..tfhe.numeric import I32, I64, int8_matmul, u32, wrap32
from ..tfhe.params import TFHEParams

__all__ = ["blind_rotate_fused", "blind_rotate_k1", "blind_rotate_k2",
           "blind_rotate_k1_plain", "blind_rotate_k2_plain", "LAUNCHES"]

N_LIMBS = 4
LAUNCHES = {"k1": 0, "k2": 0}

# Shared memory a block may opt into on sm_90 (227 KB).
SMEM_MAX = 232448
# Ciphertexts per block the kernels are instantiated for.
TILES = (8, 4, 2, 1)


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
    """Compact extensions [L·(k+1), rows, 2N] -> the K2 key matrix
    [rows·N, L·(k+1)·N] of the same step: M[(r, j), (chunk, t)] =
    E[chunk, r, N + t − j]."""
    ar = torch.arange(n, device=ext.device)
    idx = n + ar[None, :] - ar[:, None]                   # [j, t]
    m = ext[:, :, idx]                                    # [C, rows, j, t]
    chunks, rows = ext.shape[:2]
    return m.permute(1, 2, 0, 3).reshape(rows * n, chunks * n)


def blind_rotate_k2_plain(b_init, a_t, test_polys, kernels,
                          params: TFHEParams) -> torch.Tensor:
    """Plain version of K2: keys [n, rows·N, L·(k+1)·N] int8."""
    k1, n = params.glwe_dim + 1, params.poly_size
    n_limbs = kernels.shape[2] // (k1 * n)
    acc = _init_acc(b_init, test_polys, params)
    for i in range(a_t.shape[0]):
        dig = _step_digits(acc, a_t[i], params)
        acc = _accumulate(acc, int8_matmul(dig, kernels[i]), n_limbs)
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

def smem_bytes(params: TFHEParams, otf: bool, tile: int) -> int:
    """Dynamic shared memory of one block: accumulator, digits, and for
    K1 one limb's extensions of all k+1 output components."""
    k1, n = params.glwe_dim + 1, params.poly_size
    rows = k1 * params.bsk_level
    fixed = k1 * rows * 2 * n if otf else 0
    return fixed + tile * (4 * k1 * n + rows * n)


def unsupported(params: TFHEParams, otf: bool) -> str | None:
    """Why the CUDA kernel (K1 if ``otf`` else K2) cannot serve ``params``,
    or None when it can."""
    b, l, n = params.bsk_base_log, params.bsk_level, params.poly_size
    if b > 8:
        return f"bsk_base_log {b} > 8 does not fit int8 digits"
    if b * l >= 32:
        return f"bsk_base_log * bsk_level = {b * l} >= 32"
    if n % 32:
        return f"poly_size {n} is not a multiple of 32"
    smem = smem_bytes(params, otf, min(TILES))
    if smem > SMEM_MAX:
        return (f"one ciphertext needs {smem} B of shared memory > "
                f"{SMEM_MAX}")
    return None


def pick_tile(batch: int, params: TFHEParams, otf: bool, sms: int) -> int:
    """Ciphertexts per block: the largest tile that fits shared memory and
    still gives every SM a block; else the smallest (most blocks)."""
    fit = [c for c in TILES if smem_bytes(params, otf, c) <= SMEM_MAX]
    if not fit:
        raise ValueError(f"no batch tile fits shared memory at {params}")
    for c in fit:
        if -(-batch // c) >= sms:
            return c
    return fit[-1]


def _launch(otf: bool, b_init, a_t, test_polys, kernels,
            params: TFHEParams, tile: int | None) -> torch.Tensor:
    from . import _build

    dev = test_polys.device
    k1, n, l = params.glwe_dim + 1, params.poly_size, params.bsk_level
    rows, b = k1 * l, params.bsk_base_log
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
        n_limbs = kernels.shape[2] // (k1 * n)
        want = (steps, rows * n, n_limbs * k1 * n)
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
    if batch == 0 or steps == 0:
        return _init_acc(b_init, test_polys, params)
    out = torch.empty((k1, batch, n), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tile = pick_tile(batch, params, otf, sms) if tile is None else tile
        smem = smem_bytes(params, otf, tile)
        if tile not in TILES or smem > SMEM_MAX:
            raise ValueError(f"batch tile {tile} not in {TILES} or "
                             f"{smem} B of shared memory > {SMEM_MAX}")
        threads = min(512, k1 * n // 4)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().fbr_blind_rotate(
            int(otf), b_init.data_ptr(), a_t.data_ptr(),
            test_polys.data_ptr(), kernels.data_ptr(), out.data_ptr(),
            steps, batch, n, k1, l, b, n_limbs, tile, threads, smem, stream)
    if err != 0:
        msg = _build.library().fbr_error_string(err)
        raise RuntimeError(f"fused blind rotation launch failed: "
                           f"{ctypes.string_at(msg).decode()} ({err})")
    LAUNCHES["k1" if otf else "k2"] += 1
    return out


def _dispatch(otf: bool, b_init, a_t, test_polys, kernels,
              params: TFHEParams, batch_tile: int | None) -> torch.Tensor:
    if test_polys.device.type != "cpu":
        return _launch(otf, b_init, a_t, test_polys, kernels, params,
                       batch_tile)
    plain = blind_rotate_k1_plain if otf else blind_rotate_k2_plain
    batch = test_polys.shape[0]
    step = batch_tile or max(batch, 1)
    outs = [plain(b_init[s:s + step], a_t[:, s:s + step],
                  test_polys[s:s + step], kernels, params)
            for s in range(0, batch, step)] or \
        [_init_acc(b_init, test_polys, params)]
    return torch.cat(outs, dim=1)


def blind_rotate_k2(b_init, a_t, test_polys, kernels, params: TFHEParams,
                    batch_tile: int | None = None) -> torch.Tensor:
    """K2 ("fused"): keys [n, rows·N, L·(k+1)·N] int8 -> ACC [k+1, B, N]."""
    return _dispatch(False, b_init, a_t, test_polys, kernels, params,
                     batch_tile)


def blind_rotate_k1(b_init, a_t, test_polys, kernels, params: TFHEParams,
                    batch_tile: int | None = None) -> torch.Tensor:
    """K1 ("fused_otf"): keys [n, L·(k+1), rows, 2N] int8 -> ACC."""
    return _dispatch(True, b_init, a_t, test_polys, kernels, params,
                     batch_tile)


def blind_rotate_fused(b_init, a_t, test_polys, kernels, params: TFHEParams,
                       batch_tile: int | None = None) -> torch.Tensor:
    """All-steps-fused blind rotation -> accumulator [k+1, B, N] int32.

    ``b_init``: [B, 1] int32 initial amounts ((2N − b~) mod 2N); ``a_t``:
    [n, B, 1] int32 per-step amounts in [0, 2N); ``test_polys``: [B, N]
    int32; ``kernels``: K2's [n, rows·N, L·(k+1)·N] or K1's
    [n, L·(k+1), rows, 2N] int8.  ``batch_tile``: ciphertexts per tile
    (CPU: per slice; CUDA: per block, default chosen by shared memory);
    the last tile may be ragged."""
    fn = blind_rotate_k1 if kernels.ndim == 4 else blind_rotate_k2
    return fn(b_init, a_t, test_polys, kernels, params, batch_tile)
