"""The one container for a ``FerretEngine``'s live state.

Counterpart of ``repro.state.engine_state.EngineState``: the five
per-stage components, named, plus where they came from. A plain dataclass
(PyTorch needs no pytree registration).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EngineState:
    """Per-stage weights, gradient-accumulation rings, Δθ rings, optimizer
    and compensation state, plus the ring depths they are shaped for.

    The ring tensors are updated in place by the engine's rounds (a copy of
    every stage per round saved); weights, optimizer and compensation state
    are replaced, never modified.
    """

    stage_params: Tuple[Any, ...]
    rings: Tuple[Any, ...]
    deltas: Tuple[Any, ...]
    opt_states: Tuple[Any, ...]
    comp_states: Tuple[Any, ...]
    geometry: Optional[Any] = None  # repro_torch.core.schedule.RingGeometry
