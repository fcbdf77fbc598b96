"""``--arch chameleon-34b`` (see ``lm_archs.py`` for the hyperparameters)."""
from repro_torch.configs.lm_archs import CHAMELEON_34B as CONFIG, _smoke


def config():
    """The full-size chameleon-34b config."""
    return CONFIG


def smoke_config():
    """Its CPU-smoke variant."""
    return _smoke(CONFIG)
