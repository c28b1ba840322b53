from tpulbm_torch.dist.runner import make_runner

__all__ = ["make_runner"]
