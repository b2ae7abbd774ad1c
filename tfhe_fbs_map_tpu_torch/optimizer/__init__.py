"""Parameter optimizer and device cost model of the PyTorch port, with the
H100 calibration (``calibration_h100.json``)."""

from .noise import P_ERROR_4_SIGMA, p_error_atomic
from .optimizer import (DeviceProfile, Solution, StagedSolution,
                        bootstrap_cost_us, h100_profile, optimize,
                        optimize_staged)

__all__ = ["P_ERROR_4_SIGMA", "p_error_atomic", "DeviceProfile", "Solution",
           "StagedSolution", "bootstrap_cost_us", "h100_profile", "optimize",
           "optimize_staged"]
