"""Architecture registry of the port.

The port keeps its own copies of the configs it runs, so that it never
imports the JAX package. Ported so far: h2o-danube-1.8b (dense) and
mamba2-780m (ssm).
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

# h2o-danube-1.8b [dense] — llama+mistral mix, SWA. [arXiv:2401.16818; hf]
# 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding window 4096.
H2O_DANUBE_1_8B = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    window=4096,
)

H2O_DANUBE_1_8B_SMOKE = ModelConfig(
    name="h2o-danube-1.8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    window=8,
)

# mamba2-780m [ssm] — SSD (state-space duality). [arXiv:2405.21060]
# 48L d_model=1536 (attention-free) d_ff=0 vocab=50280, ssm_state=128.
MAMBA2_780M = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
)

MAMBA2_780M_SMOKE = ModelConfig(
    name="mamba2-780m-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_conv=4,
    ssm_chunk=8,
)

_CONFIGS = {
    "h2o-danube-1.8b": (H2O_DANUBE_1_8B, H2O_DANUBE_1_8B_SMOKE),
    "mamba2-780m": (MAMBA2_780M, MAMBA2_780M_SMOKE),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _CONFIGS:
        raise ValueError(
            f"architecture {arch!r} is not ported to repro_torch yet; "
            f"ported: {', '.join(sorted(_CONFIGS))}"
        )
    full, small = _CONFIGS[arch]
    return small if smoke else full
