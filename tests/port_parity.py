"""What the parity tests compare of a port configuration with the JAX
package's."""
import dataclasses

from repro_torch.models.config import PORT_ONLY_MOE_FIELDS, MoEConfig


def as_jax_fields(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` without the port-only MoE fields, each
    asserted at its default: what the JAX package's config holds."""
    d = dataclasses.asdict(cfg)
    if d["moe"] is not None:
        for k in PORT_ONLY_MOE_FIELDS:
            assert d["moe"].pop(k) == getattr(MoEConfig(), k), k
    return d
