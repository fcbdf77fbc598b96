"""``--arch whisper-small`` (see ``lm_archs.py`` for the hyperparameters)."""
from repro_torch.configs.lm_archs import WHISPER_SMALL as CONFIG, _smoke


def config():
    """The full-size whisper-small config."""
    return CONFIG


def smoke_config():
    """Its CPU-smoke variant."""
    return _smoke(CONFIG)
