from tpulbm_torch.diag.observables import (
    av_velocity,
    calc_reynolds,
    output_fields,
    total_density,
    velocity_field,
)

__all__ = [
    "av_velocity", "calc_reynolds", "output_fields", "total_density",
    "velocity_field",
]
