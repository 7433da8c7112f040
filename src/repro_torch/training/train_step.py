"""The training state an Engine holds."""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

from .optimizer import AdamWState


class TrainState(NamedTuple):
    """Parameters and optimizer state; `opt` is None until the first
    update (a serving engine never allocates it)."""

    params: Any
    opt: Optional[AdamWState] = None
