from .params import (DEFAULT_PARAMS, FAST_PARAMS, PRESETS, TEST_PARAMS, Q,
                     Q_BITS, TFHEParams)
from .keys import TFHEKeys, generate_keys, keys_from_numpy, load_keys, \
    save_keys
from .encrypt import (decode, decrypt_values, encode, encrypt_values,
                      lwe_encrypt, lwe_lincomb, lwe_phase)
from .pbs import (blind_rotate, build_test_vector, external_product,
                  functional_bootstrap, keyswitch, sample_extract)

__all__ = [
    "TFHEParams", "TEST_PARAMS", "DEFAULT_PARAMS", "FAST_PARAMS", "PRESETS",
    "Q", "Q_BITS", "TFHEKeys", "generate_keys", "keys_from_numpy",
    "load_keys", "save_keys",
    "encode", "decode", "encrypt_values", "decrypt_values", "lwe_encrypt",
    "lwe_phase", "lwe_lincomb",
    "build_test_vector", "keyswitch", "blind_rotate", "sample_extract",
    "functional_bootstrap", "external_product",
]
