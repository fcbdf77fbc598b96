"""``--arch hymba-1.5b`` (see ``lm_archs.py`` for the hyperparameters)."""
from repro_torch.configs.lm_archs import HYMBA_1_5B as CONFIG, _smoke


def config():
    """The full-size hymba-1.5b config."""
    return CONFIG


def smoke_config():
    """Its CPU-smoke variant."""
    return _smoke(CONFIG)
