"""``--orientation auto``'s one rule, K1 against K2 by the calibrated price
(``optimizer/runtime_model.pick_kernel``), and the calibration it reads.

A native family that both kernels serve, and whose K2 matrices fit, takes
the kernel of the lower ``runtime_model.kernel_us`` (``launch_us`` summed
over the calibration's launch sizes); K1 otherwise, and both staged
families always.  Every caller routes through the rule: the runtime CLI's
``pick_orientations`` (and the benchmark's positional call of it), the
bench's ``bench_orientation``, the cost model's ``DeviceProfile.kernel``
and the runtime model's default orientation.  The native optimizer's
mirror is held to it in ``tests/test_torch_native_optimizer.py``."""

import copy
import json
import math
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from tfhe_fbs_map_tpu_torch import bench
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import (FUSED_HEADROOM,
                                                     fused_key_bytes)
from tfhe_fbs_map_tpu_torch.ops.fused_blind_rotate import unsupported
from tfhe_fbs_map_tpu_torch.optimizer import calibrate
from tfhe_fbs_map_tpu_torch.optimizer import runtime_model as rm
from tfhe_fbs_map_tpu_torch.optimizer.runtime_model import pick_kernel
from tfhe_fbs_map_tpu_torch.optimizer.optimizer import (calibration,
                                                        h100_profile)
from tfhe_fbs_map_tpu_torch.runtime.cli import (kernel_prices,
                                                pick_orientations)
from tfhe_fbs_map_tpu_torch.tfhe.params import (PRESETS, STAGED_PRESETS,
                                                TFHEParams)

CUDA = torch.device("cuda")
# an H100 80GB HBM3 holds 81,559 MiB
CARD = 81_559 << 20
CONFIGS = Path(__file__).resolve().parents[1] / "bench_h100" / "configs"
AES = PRESETS["aes128_p4"][0]
ANCHOR = PRESETS["anchor"][0]


def native_families() -> dict[str, TFHEParams]:
    return {name: p for name, (p, staged) in calibrate.families().items()
            if not staged}


def both_kernels(params: TFHEParams, memory: float) -> bool:
    """Whether both kernels serve ``params`` and K2's matrices fit."""
    return (unsupported(params, otf=False) is None
            and unsupported(params, otf=True) is None
            and fused_key_bytes(params) + FUSED_HEADROOM <= memory)


def k1_fixed(ms: float):
    """The shipped calibration with K1's fixed term, across families and
    in every family's K1 entry, set to ``ms`` a launch."""
    cal = copy.deepcopy(calibration())
    cal["kernels"]["fused_otf"]["fixed_us"] = ms * 1e3
    for e in cal["families"].values():
        if e["kernel"] == "fused_otf":
            e["fixed_us"] = ms * 1e3
    return cal


@pytest.fixture()
def k2_cheaper(monkeypatch):
    """A calibration in which K1 pays 200 ms a launch: K2 is priced lower
    at every calibrated native family."""
    cal = k1_fixed(200.0)
    monkeypatch.setattr(rm, "calibration", lambda: cal)
    return cal


# ------------------------------------------------------------- the rule

def test_aes128_takes_k1_by_its_price():
    """AES-128's family fits K2's matrices on the card, which the memory
    rule took, but K1's summed price is lower: ``auto`` takes K1."""
    assert both_kernels(AES, CARD)
    k1 = rm.kernel_us(AES, "fused_otf")
    k2 = rm.kernel_us(AES, "fused")
    assert k1 < k2
    assert pick_kernel(AES, CARD) == "fused_otf"
    assert pick_orientations([AES], CUDA, CARD) == ["fused_otf"]


def test_the_price_is_launch_us_summed_over_the_calibrations_sizes():
    for params in (AES, ANCHOR):
        for orient in ("fused", "fused_otf"):
            cost = rm._cost(params, orient, 4)
            want = 0.0
            for rows in rm.ROWS:
                want += rm.launch_us(params, rows, orient, cost_us=cost)
            assert rm.kernel_us(params, orient) == want
    assert rm.ROWS == calibrate.ROWS
    assert (rm.ROWS[0], rm.ROWS[-1]) == (64, 8192)


def test_k2_taken_where_its_price_is_lower(monkeypatch):
    """Synthetic anchor entries, K2's with no fixed term and K1's a copy of
    it with 25 ms a launch, price K2 under K1 there: the anchor takes K2,
    AES-128 still K1."""
    cal = copy.deepcopy(calibration())
    k2 = cal["families"][rm.entry_key(ANCHOR, "fused")]
    k2["fixed_us"] = 0.0
    cal["families"][rm.entry_key(ANCHOR, "fused_otf")] = dict(
        k2, kernel="fused_otf", fixed_us=25e3)
    # and no small-tile points of K1 nor their fit across families, which
    # would undercut K2 at a few tiles
    del cal["families"][rm.entry_key(ANCHOR, "k1s")]
    del cal["kernels"]["k1s_wide"]
    monkeypatch.setattr(rm, "calibration", lambda: cal)
    assert rm.kernel_us(ANCHOR, "fused") < rm.kernel_us(ANCHOR, "fused_otf")
    assert pick_kernel(ANCHOR, CARD) == "fused"
    assert pick_orientations([ANCHOR], CUDA, CARD) == ["fused"]
    assert pick_kernel(AES, CARD) == "fused_otf"


def test_k2_never_without_room_or_service(k2_cheaper):
    """Where K2 is priced lower it still needs its matrices to fit with
    ``FUSED_HEADROOM`` to spare, and to serve the family; where K1 does
    not serve it (:func:`test_k2_where_k1_does_not_serve`) K2 runs
    whatever the prices.  Without ``served`` (the JAX module's model) the
    fit alone decides."""
    need = fused_key_bytes(AES) + FUSED_HEADROOM
    assert pick_kernel(AES, need) == "fused"
    assert pick_kernel(AES, need - 1) == "fused_otf"
    assert pick_kernel(AES, need - 1, served=False) == "fused_otf"
    assert pick_kernel(AES, need, served=False) == "fused"
    # (k+1)·l·N = 64 is no whole K2 slice; K1's small-N kernel serves it
    small = replace(ANCHOR, glwe_dim=1, poly_size=32, bsk_level=1)
    assert unsupported(small, otf=False) is not None
    assert unsupported(small, otf=True) is None
    assert pick_kernel(small, CARD) == "fused_otf"


def test_k2_where_k1_does_not_serve():
    """Above the largest N K1 serves, K2 runs where its matrices fit,
    though K1 would be priced lower."""
    huge = replace(ANCHOR, glwe_dim=1, poly_size=8192, bsk_level=1,
                   lwe_dim=32)
    assert unsupported(huge, otf=True) is not None
    assert unsupported(huge, otf=False) is None
    assert fused_key_bytes(huge) + FUSED_HEADROOM <= CARD
    assert rm.kernel_us(huge, "fused_otf") < rm.kernel_us(huge, "fused")
    assert pick_kernel(huge, CARD) == "fused"
    assert pick_kernel(huge, fused_key_bytes(huge)) == "fused_otf"


@pytest.mark.parametrize("name", sorted(STAGED_PRESETS))
def test_staged_families_always_take_k1(name, k2_cheaper):
    preset = STAGED_PRESETS[name]
    fams = [preset.fam1, preset.fam2]
    profile = h100_profile()
    assert pick_orientations(fams, CUDA, CARD) == ["fused_otf"] * 2
    for p in fams:
        assert profile.kernel(p.lwe_dim, p.glwe_dim, p.poly_size,
                              p.bsk_level, p.ksk_level,
                              staged=True) == "fused_otf"
        assert rm._orientation(p, None, 4, staged=True) == "fused_otf"


def callers(params: TFHEParams, memory: float) -> dict[str, str]:
    profile = replace(h100_profile(), k2_memory=memory)
    return {
        "pick_kernel": pick_kernel(params, memory),
        "pick_orientations": pick_orientations([params], CUDA, memory)[0],
        "bench_orientation": bench.bench_orientation(params, "auto", 4, CUDA,
                                                     memory),
        "DeviceProfile.kernel": profile.kernel(
            params.lwe_dim, params.glwe_dim, params.poly_size,
            params.bsk_level, params.ksk_level),
    }


@pytest.mark.parametrize("calibrated", ["shipped", "k2_cheaper"])
@pytest.mark.parametrize("name", sorted(native_families()))
def test_every_caller_takes_the_one_rule(name, calibrated, monkeypatch):
    """On every calibrated native family, under the shipped calibration
    and one where K2 is cheaper: the CLI's, the bench's and the cost
    model's picks, and the runtime model's default orientation, are
    ``pick_kernel``'s, at the card's memory and at the profile's."""
    if calibrated == "k2_cheaper":
        cal = k1_fixed(200.0)
        monkeypatch.setattr(rm, "calibration", lambda: cal)
    params = native_families()[name]
    for memory in (CARD, h100_profile().k2_memory):
        got = callers(params, memory)
        assert set(got.values()) == {got["pick_kernel"]}, got
    assert rm._orientation(params, None, 4) == pick_kernel(
        params, h100_profile().k2_memory)
    if calibrated == "k2_cheaper" and both_kernels(params, CARD):
        assert got["pick_kernel"] == "fused"


def test_the_harness_positional_call_still_works():
    """``bench_h100/harness/cell.py`` calls ``pick_orientations(fam_params,
    dev, free, bsk_limbs=limbs)``: AES-128 now takes K1, Kreyvium's two
    staged families K1."""
    want = {"aes128_p4": ["fused_otf"],
            "kreyvium_p10_staged": ["fused_otf", "fused_otf"]}
    for name, orients in want.items():
        cfg = json.loads((CONFIGS / f"{name}.json").read_text())
        assert cfg["orientation"] == "auto"
        fam_params = [TFHEParams(**f) for f in cfg["families"]]
        assert pick_orientations(fam_params, CUDA, CARD,
                                 bsk_limbs=cfg["bsk_limbs"]) == orients


def test_kernel_prices_name_what_auto_compares():
    """The CLI's ``pick``: each kernel that serves the family and its
    price, the lower one the kernel ``auto`` takes."""
    got = kernel_prices(AES)
    assert set(got) == {"fused", "fused_otf"}
    for orient, us in got.items():
        assert math.isclose(us, rm.kernel_us(AES, orient), abs_tol=0.05)
    assert min(got, key=got.get) == pick_kernel(AES, CARD)
    small = replace(ANCHOR, glwe_dim=1, poly_size=32, bsk_level=1)
    assert set(kernel_prices(small)) == {"fused_otf"}


# ------------------------------------------------------ the calibration

def test_every_native_family_is_calibrated_through_both_kernels():
    """``calibration_h100.json`` holds one entry a family and kernel: a
    native family that both kernels serve, and whose K2 matrices fit the
    calibrated card, through both; a staged family through K1 alone; and
    ``_entry`` returns the kernel asked for."""
    cal = calibration()
    memory = cal["profile"]["k2_memory"]
    both = 0
    for name, (params, staged) in calibrate.families().items():
        kernels = calibrate.kernels(params, staged, memory)
        if staged:
            assert kernels == ["fused_otf"]
        for orient in ("fused", "fused_otf"):
            entry = rm._entry(params, orient)
            if orient in kernels:
                assert entry is not None, (name, orient)
                assert entry["name"] == name and entry["kernel"] == orient
                assert entry is cal["families"][rm.entry_key(params, orient)]
            else:
                assert entry is None, (name, orient)
        both += kernels == ["fused", "fused_otf"]
    assert both == 5        # anchor, p8, p16, aes128_p4, kreyvium_native
    for key, entry in cal["families"].items():
        family, _, kernel = key.partition("/")
        assert len(family.split(",")) == 5 and kernel == entry["kernel"]


def test_calibration_kernels_follow_service_and_room():
    memory = calibration()["profile"]["k2_memory"]
    assert calibrate.kernels(AES, False, memory) == ["fused", "fused_otf"]
    assert calibrate.kernels(AES, False, fused_key_bytes(AES)) == [
        "fused_otf"]
    p32 = PRESETS["p32"][0]
    assert calibrate.kernels(p32, False, memory) == ["fused_otf"]
    assert calibrate.kernels(AES, True, memory) == ["fused_otf"]


def close(got, want) -> bool:
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(close(got[k], want[k])
                                                 for k in want)
    if isinstance(want, float):
        return math.isclose(got, want, rel_tol=1e-9)
    return got == want


def test_dry_refits_the_shipped_points_to_the_shipped_fits():
    """``calibrate --dry`` fits the shipped raw points to the shipped
    entries, kernel fits, around fit and profile (rel_tol 1e-9: least
    squares on the same points, on another numpy build)."""
    cal = calibration()
    again = calibrate.fit(copy.deepcopy(cal["raw"]))
    for field in ("card", "device", "sms", "profile", "kernels", "around",
                  "families", "resident"):
        assert close(again[field], cal[field]), field
