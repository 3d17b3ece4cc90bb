"""OCL algorithm registry of the port (paper Table 2).

Counterpart of ``repro.ocl.registry``. Only ``vanilla`` (plain online
training on the arriving items) is ported; ER, MIR, LwF and MAS come in a
later slice, and asking for them raises.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional, Type, Union

from repro_torch.core.pipeline import StagedModel


@dataclasses.dataclass(frozen=True)
class OCLConfig:
    method: str = "vanilla"  # a name registered below


class OCLAlgorithm:
    """Base algorithm: Vanilla behaviour; subclasses override the hooks."""

    name: ClassVar[str] = "vanilla"

    def __init__(self, cfg: Optional[OCLConfig] = None):
        self.cfg = cfg or OCLConfig(method=self.name)

    def prepare_stream(self, rows: Dict) -> Dict:
        """Host-side augmentation of each pulled chunk of stream rounds."""
        return rows

    def wrap_staged(self, staged: StagedModel) -> StagedModel:
        """The staged model the engine trains (loss wrappers hook in here)."""
        return staged


class Vanilla(OCLAlgorithm):
    """Plain online training on the arriving items."""

    name = "vanilla"


_REGISTRY: Dict[str, Type[OCLAlgorithm]] = {Vanilla.name: Vanilla}


def get_algorithm(spec: Union[str, OCLConfig, OCLAlgorithm]) -> OCLAlgorithm:
    """Resolve an algorithm name / config / instance to an instance."""
    if isinstance(spec, OCLAlgorithm):
        return spec
    cfg = spec if isinstance(spec, OCLConfig) else OCLConfig(method=spec)
    if cfg.method not in _REGISTRY:
        raise ValueError(
            f"OCL algorithm {cfg.method!r} is not ported to repro_torch yet; "
            f"ported: {', '.join(sorted(_REGISTRY))}"
        )
    return _REGISTRY[cfg.method](cfg)
