"""The encoded corpus record every data backend returns."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class CorpusData:
    words: List[str]
    counts: np.ndarray        # (vocab,) int64
    ids: np.ndarray           # (tokens,) int32
    total_raw_tokens: int
