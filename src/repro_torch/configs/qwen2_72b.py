"""``--arch qwen2-72b`` (see ``lm_archs.py`` for the hyperparameters)."""
from repro_torch.configs.lm_archs import QWEN2_72B as CONFIG, _smoke


def config():
    """The full-size qwen2-72b config."""
    return CONFIG


def smoke_config():
    """Its CPU-smoke variant."""
    return _smoke(CONFIG)
