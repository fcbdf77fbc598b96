"""``--arch rwkv6-7b`` (see ``lm_archs.py`` for the hyperparameters)."""
from repro_torch.configs.lm_archs import RWKV6_7B as CONFIG, _smoke


def config():
    """The full-size rwkv6-7b config."""
    return CONFIG


def smoke_config():
    """Its CPU-smoke variant."""
    return _smoke(CONFIG)
