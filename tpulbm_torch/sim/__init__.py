from tpulbm_torch.sim.simulation import Simulation, SimulationResult

__all__ = ["Simulation", "SimulationResult"]
