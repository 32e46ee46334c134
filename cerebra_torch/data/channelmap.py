"""Electrode channel maps and the curated bad-channel table (copy of
cerebra/data/channelmap.py).

- `read_channel_map` parses the `Ch-N=Name` format of channelmap.txt
  (parser behavior: utils/Utilities.py:208-222; 1-based channel numbers).
- `read_channel_list` parses the one-name-per-line perils_channel_map.txt
  (BioSemi A1..B32 names; 96 rows).
- `BAD_CHANNELS` is the reference's curated electrode exclusion list
  (utils/BadChannels.py:5-86), kept as a static config table.

The .txt assets ship beside this module (the 128-ch Spampinato map and the
96-ch Perils map).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CHANNELMAP_128 = os.path.join(_HERE, "channelmap.txt")
CHANNELMAP_PERILS_96 = os.path.join(_HERE, "perils_channel_map.txt")

# utils/BadChannels.py:5-86 — uncommented entries are "bad" (excluded).
BAD_CHANNELS: tuple = (
    "Fp1", "Fp2", "Fpz",
    "FC5", "FC6",
    "C3", "Cz", "C4", "C5", "C1", "C2", "C6",
    "CP3", "CPz", "CP4", "CP5", "CP1", "CP2", "CP6",
    "O1", "O2", "Oz",
    "OI1h", "OI2h",
    "F1", "F2", "F5", "F6", "F9", "F10", "Fz",
    "FT7", "FT8", "FT9", "FT10",
    "T7", "T8", "TP7", "TP8", "TP9", "TP10",
    "P3", "P4", "P7", "P8", "Pz",
    "PPO1h", "PPO2h",
    "PO3", "PO4", "PO7", "PO8", "PO9", "PO10", "POz",
    "FTT7h", "FTT8h", "FTT9h", "FTT10h",
    "FCC1h", "FCC2h", "FCC3h", "FCC4h", "FCC5h", "FCC6h",
    "TPP7h", "TPP8h", "TPP9h", "TPP10h",
    "TTP7h", "TTP8h",
    "CPP5h", "CPP3h", "CPP1h", "CPP2h", "CPP4h", "CPP6h",
    "Iz", "I1", "I2",
    "FFC1h", "FFC2h", "FFC3h", "FFC4h", "FFC5h", "FFC6h",
    "FFT7h", "FFT8h", "FFT9h", "FFT10h",
    "CCP5h", "CCP3h", "CCP1h", "CCP2h", "CCP4h", "CCP6h",
)


def read_channel_map(path: str = CHANNELMAP_128) -> Dict[int, str]:
    """Parse `Ch-N=Name` lines → {N: Name} (utils/Utilities.py:208-222)."""
    channel_map: Dict[int, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            chan, name = line.split("=", 1)
            channel_map[int(chan.split("-")[-1])] = name
    return channel_map


def read_channel_list(path: str = CHANNELMAP_PERILS_96) -> List[str]:
    """Parse one-electrode-name-per-line maps (perils_channel_map.txt)."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def good_channel_indices(names: Sequence[str], bad: Sequence[str] = BAD_CHANNELS) -> List[int]:
    """0-based indices of channels NOT in the bad list."""
    bad_set = set(bad)
    return [i for i, n in enumerate(names) if n not in bad_set]
