"""Spherical-harmonics basis for the gamma (illumination) control (port of
``gan_control_tpu/utils/spherical_harmonics.py``; numpy only).

The 27-d gamma vector is 9 SH coefficients per RGB channel, interleaved
with stride 9; these helpers evaluate the order-1 and order-2 real SH basis
at a light direction (x, y, z) in that layout, to build human-readable
illumination controls for the gamma controller."""

from __future__ import annotations

import numpy as np

P_0_0 = 0.282094791773878140
P_1_0 = 0.488602511902919920
P_1_1 = -0.488602511902919920
PP_2_0 = 0.946174695757560080
MP_2_0 = -0.315391565252520050
P_2_1 = -1.092548430592079200
P_2_2 = 0.546274215296039590


def sh_eval_basis_1(x: float, y: float, z: float) -> np.ndarray:
    """Order-1 basis, 27-d interleaved RGB layout."""
    b = np.zeros(27)
    b[0::9] = P_0_0  # l=0, m=0
    b[2::9] = P_1_0 * z  # l=1, m=0
    b[1::9] = P_1_1 * y  # l=1, m=-1
    b[3::9] = P_1_1 * x  # l=1, m=+1
    return b


def sh_eval_basis_2(x: float, y: float, z: float) -> np.ndarray:
    """Order-2 basis (the reference layout, with its single-channel l=2
    entries at flat indices 4, 5, 7, 8)."""
    b = np.zeros(27)
    b[0::9] = P_0_0
    b[2::9] = P_1_0
    b[6::9] = PP_2_0 * z * z + MP_2_0
    b[1::9] = P_1_1 * y
    b[3::9] = P_1_1 * x
    b[5] = P_2_1 * z * y
    b[7] = P_2_1 * z * x
    b[4] = P_2_2 * (x * y + y * x)
    b[8] = P_2_2 * (y * y + x * x)
    return b


def gamma_from_direction(x: float, y: float, z: float, order: int = 1) -> np.ndarray:
    """A light direction (normalised here) -> the 27-d gamma control."""
    n = np.sqrt(x * x + y * y + z * z) or 1.0
    x, y, z = x / n, y / n, z / n
    return sh_eval_basis_1(x, y, z) if order == 1 else sh_eval_basis_2(x, y, z)
