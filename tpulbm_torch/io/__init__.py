from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.writers import write_av_vels, write_final_state

__all__ = ["read_params", "read_obstacles", "write_av_vels", "write_final_state"]
