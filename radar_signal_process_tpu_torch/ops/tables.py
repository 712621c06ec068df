"""Hardware calibration tables: monopulse K-values and the frequency plan.

The port's own copy of the JAX package's ``ops/tables.py``.  These are
measured calibration *data* replicated from the reference
(``CFAR_WangCai/angle_KvalueGen.m:7-35`` and ``freValueGen.m:3-29``): each
K-value row corresponds to one frequency point, each column to one beam
position; two hardware sets exist.
"""

from __future__ import annotations

import numpy as np

_K_SET_1_ROWS = {
    # row pattern -> frequency indices sharing it (angle_KvalueGen.m case 1)
    (10.380672, 10.414385, 9.948529, 10.179451, 10.500966, 10.880367,
     11.156690, 12.276938, 12.898726, 14.596353, 15.518284, 30.430223): (0, 1, 2),
    (10.553918, 10.332526, 10.155857, 10.191538, 10.342200, 10.769444,
     11.167994, 12.183270, 13.289346, 14.860170, 15.233340, 33.493266): (3, 4),
    (10.424651, 9.948311, 9.773556, 9.840688, 10.142961, 10.530585,
     11.178810, 11.859324, 12.716404, 14.757746, 15.204941, 30.891074): (5, 6),
    (10.520613, 10.011845, 9.789657, 10.098063, 10.023637, 10.590518,
     10.954758, 11.715884, 12.721137, 14.592968, 15.163915, 28.118921): (7, 8),
    (10.405303, 10.104511, 10.200153, 9.920508, 10.099613, 10.701100,
     11.099405, 11.857029, 12.950606, 14.377440, 14.676968, 22.557463): (9, 10),
}

_K_SET_2_ROWS = {
    (10.338870, 10.291381, 9.948466, 9.222804, 10.422373, 10.514297,
     11.043671, 11.671526, 12.644140, 13.622801, 15.343592, 20.111603): (0, 1, 2),
    (10.465372, 10.363734, 9.795664, 9.868073, 10.080984, 10.208166,
     10.970078, 11.395584, 12.664564, 13.799594, 12.685487, 23.243726): (3, 4),
    (10.308061, 10.755928, 10.057556, 9.884201, 10.333652, 10.523828,
     10.982471, 11.091260, 11.914261, 13.245791, 13.757134, 23.973037): (5, 6),
    (10.640704, 10.909189, 10.398377, 9.791719, 10.365195, 10.184979,
     11.085054, 12.068282, 12.359290, 13.209102, 13.948980, 26.870156): (7, 8),
    (10.587029, 10.346590, 9.847715, 9.970153, 9.862467, 10.795310,
     10.369297, 11.493181, 12.003133, 13.567793, 14.422600, 26.676481): (9, 10),
}


def angle_k_values(sys_num: int = 1) -> np.ndarray:
    """Monopulse slope table, shape (11 frequency points, 12 beam positions)."""
    rows = _K_SET_1_ROWS if sys_num == 1 else _K_SET_2_ROWS
    table = np.zeros((11, 12), dtype=np.float64)
    for values, freq_indices in rows.items():
        for fi in freq_indices:
            table[fi, :] = values
    return table


# Frequency index -> carrier frequency [Hz] (freValueGen.m: indices 0 and 1
# both map to 9365 MHz, then +10 MHz per index).
_FREQ_TABLE_MHZ = (9365, 9365, 9375, 9385, 9395, 9405, 9415, 9425, 9435, 9445, 9455)


def freq_value(freq_index: int) -> float:
    """Carrier frequency [Hz] for a frequency index (0..10)."""
    return _FREQ_TABLE_MHZ[freq_index] * 1e6
