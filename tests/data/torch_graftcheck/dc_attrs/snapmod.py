from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Snap:
    n_docs: torch.Tensor
    df: torch.Tensor | None
    block_live: np.ndarray
    version: int = 0
