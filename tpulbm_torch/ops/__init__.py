from tpulbm_torch.ops.step_torch import accelerate, collide_stream, lbm_step, run_steps

__all__ = ["accelerate", "collide_stream", "lbm_step", "run_steps"]
