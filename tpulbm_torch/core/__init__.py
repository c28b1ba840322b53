from tpulbm_torch.core.lattice import NSPEEDS, CX, CY, OPP, W0, W1, W2, WEIGHTS
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state

__all__ = [
    "NSPEEDS", "CX", "CY", "OPP", "W0", "W1", "W2", "WEIGHTS",
    "LBMParams", "initial_state",
]
