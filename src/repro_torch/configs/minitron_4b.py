"""``--arch minitron-4b`` (see ``lm_archs.py`` for the hyperparameters)."""
from repro_torch.configs.lm_archs import MINITRON_4B as CONFIG, _smoke


def config():
    """The full-size minitron-4b config."""
    return CONFIG


def smoke_config():
    """Its CPU-smoke variant."""
    return _smoke(CONFIG)
