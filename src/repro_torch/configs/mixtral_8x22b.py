"""``--arch mixtral-8x22b`` (see ``lm_archs.py`` for the hyperparameters)."""
from repro_torch.configs.lm_archs import MIXTRAL_8X22B as CONFIG, _smoke


def config():
    """The full-size mixtral-8x22b config."""
    return CONFIG


def smoke_config():
    """Its CPU-smoke variant."""
    return _smoke(CONFIG)
