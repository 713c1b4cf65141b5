from repro_torch.configs.registry import get_config, register

__all__ = ["get_config", "register"]
