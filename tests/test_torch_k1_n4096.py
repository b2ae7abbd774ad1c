"""K1 at N=4096, the largest N it serves (``K1_MAX_N``): its plain version
bitwise equal to the JAX ``_kernel_otf`` in interpret mode at k=1, N=4096,
l=2, b=8, n=2, 8 ciphertexts (the rotation amounts' edge cases in every
step).  The CUDA kernel at that N is held against the plain version on the
card by ``chip_smoke.py`` phase 11 (a)."""

import jax.numpy as jnp
import numpy as np
import torch

import tfhe_fbs_map_tpu.tfhe as J
from tfhe_fbs_map_tpu.ops import fused_blind_rotate as jfbr
from tfhe_fbs_map_tpu.ops.blind_rotate import prepare_fast_keys as jprep
import tfhe_fbs_map_tpu_torch.tfhe as T
from tfhe_fbs_map_tpu_torch.ops import fused_blind_rotate as tfbr
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import prepare_fast_keys

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

N4096 = J.TFHEParams(p=4, lwe_dim=2, glwe_dim=1, poly_size=4096,
                     bsk_level=2, bsk_base_log=8, ksk_level=2,
                     ksk_base_log=4, lwe_noise_std=2.0 ** 7,
                     glwe_noise_std=2.0 ** 4)


def test_plain_k1_at_n4096_equals_jax_interpret():
    params = T.TFHEParams(**vars(N4096))
    assert tfbr.unsupported(params, otf=True) is None
    jk = J.generate_keys(N4096, seed=21)
    tk = T.keys_from_numpy(params, np.asarray(jk.lwe_key),
                           np.asarray(jk.glwe_key), np.asarray(jk.bsk),
                           np.asarray(jk.ksk), device="cpu")
    jf = jprep(jk, orientation="fused_otf")
    tf = prepare_fast_keys(tk, orientation="fused_otf")
    assert np.array_equal(np.asarray(jf.bsk_kernels), tf.bsk_kernels.numpy())
    rng = np.random.default_rng(3)
    N, batch = N4096.poly_size, 8
    b_init = rng.integers(0, 2 * N, (batch, 1)).astype(np.int32)
    a_t = rng.integers(0, 2 * N, (N4096.lwe_dim, batch, 1)).astype(np.int32)
    a_t[:, :4, 0] = [0, N - 1, N, 2 * N - 1]
    tvs = rng.integers(0, 1 << 32, (batch, N),
                       dtype=np.uint32).astype(np.int32)
    want = jfbr.blind_rotate_fused(jnp.asarray(b_init), jnp.asarray(a_t),
                                   jnp.asarray(tvs), jf.bsk_kernels, N4096,
                                   True)
    got = tfbr.blind_rotate_k1_plain(
        *map(torch.from_numpy, (b_init, a_t, tvs)), tf.bsk_kernels, params)
    assert got.shape == (2, batch, N)
    assert np.array_equal(np.asarray(want).view(np.uint32),
                          got.numpy().view(np.uint32))
