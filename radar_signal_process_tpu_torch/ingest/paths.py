"""Capture-file naming contracts (reference I2).

G2: ``1.00000N.bin`` with an optional raw-data subdirectory
(``DataFullPathGen.m:10-26``); G1: ``00000N.bin``
(``CFAR_WangCai/dataFullPathGen.m:3-9``), 10 frames per file.
"""

from __future__ import annotations

import os

G2_RAW_SUBDIR = "雷达原始数据"  # "radar raw data" subdir


def g2_file_name(index: int) -> str:
    return f"1.{index:06d}.bin"


def g1_file_name(index: int) -> str:
    return f"{index:06d}.bin"


def g2_file_path(root: str, index: int) -> str:
    sub = os.path.join(root, G2_RAW_SUBDIR)
    base = sub if os.path.isdir(sub) else root
    return os.path.join(base, g2_file_name(index))


def g1_file_path(root: str, index: int) -> str:
    return os.path.join(root, g1_file_name(index))
