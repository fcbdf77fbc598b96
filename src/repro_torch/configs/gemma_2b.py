"""``--arch gemma-2b`` (see ``lm_archs.py`` for the hyperparameters)."""
from repro_torch.configs.lm_archs import GEMMA_2B as CONFIG, _smoke


def config():
    """The full-size gemma-2b config."""
    return CONFIG


def smoke_config():
    """Its CPU-smoke variant."""
    return _smoke(CONFIG)
