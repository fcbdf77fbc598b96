"""``--arch dbrx-132b`` (see ``lm_archs.py`` for the hyperparameters)."""
from repro_torch.configs.lm_archs import DBRX_132B as CONFIG, _smoke


def config():
    """The full-size dbrx-132b config."""
    return CONFIG


def smoke_config():
    """Its CPU-smoke variant."""
    return _smoke(CONFIG)
