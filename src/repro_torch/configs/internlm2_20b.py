"""``--arch internlm2-20b`` (see ``lm_archs.py`` for the hyperparameters)."""
from repro_torch.configs.lm_archs import INTERNLM2_20B as CONFIG, _smoke


def config():
    """The full-size internlm2-20b config."""
    return CONFIG


def smoke_config():
    """Its CPU-smoke variant."""
    return _smoke(CONFIG)
