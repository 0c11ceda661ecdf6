from ripor_tpu_torch.train.checkpoint import load_params, save_params

__all__ = ["save_params", "load_params"]
