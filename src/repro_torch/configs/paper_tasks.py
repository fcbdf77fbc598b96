"""The paper's Table II model configurations and their reduced variants.

A copy of ``repro.configs.paper_tasks``: the feed-forward tasks and the
sequential (stream) tasks, whose configs are recurrent cells
(:class:`~repro_torch.stream.cell.StreamCellConfig`).
"""
from __future__ import annotations

from repro_torch.core.assemble import AssembleConfig, LayerSpec


def mnist(aug: bool = False) -> AssembleConfig:
    """w_l=[2160,360,2160,360,60,10], a_l=[0,1,0,1,1,1], F=6, beta=[1]*5+[6]."""
    del aug
    units = [2160, 360, 2160, 360, 60, 10]
    asm = [False, True, False, True, True, True]
    bits = [1, 1, 1, 1, 1, 6]
    return AssembleConfig(
        in_features=784, input_bits=1, input_signed=False,
        layers=tuple(LayerSpec(u, 6, b, a)
                     for u, b, a in zip(units, bits, asm)),
        subnet_width=64, subnet_depth=2, skip_step=2)


def jsc_cernbox() -> AssembleConfig:
    """JSC (CERNBox): 8b inputs, 4b activations, 8b logits."""
    units = [320, 160, 80, 40, 20, 10, 5]
    asm = [False, True, True, True, True, True, True]
    fan = [1, 2, 2, 2, 2, 2, 2]
    bits = [4, 4, 4, 4, 4, 4, 8]
    return AssembleConfig(
        in_features=16, input_bits=8, input_signed=True,
        layers=tuple(LayerSpec(u, f, b, a)
                     for u, f, b, a in zip(units, fan, bits, asm)),
        subnet_width=64, subnet_depth=2, skip_step=2)


def jsc_openml() -> AssembleConfig:
    """JSC (OpenML): 6b inputs, 3b activations, 8b logits."""
    units = [320, 160, 80, 40, 20, 10, 5]
    asm = [False, True, True, True, True, True, True]
    fan = [1, 2, 2, 2, 2, 2, 2]
    bits = [3, 3, 3, 3, 3, 3, 8]
    return AssembleConfig(
        in_features=16, input_bits=6, input_signed=True,
        layers=tuple(LayerSpec(u, f, b, a)
                     for u, f, b, a in zip(units, fan, bits, asm)),
        subnet_width=64, subnet_depth=2, skip_step=2)


def nid() -> AssembleConfig:
    """NID: w_l=[60,20,9,3,1], F=[6,3,3,3,3], 1b inputs, 2b activations."""
    units = [60, 20, 9, 3, 1]
    asm = [False, True, False, True, True]
    fan = [6, 3, 3, 3, 3]
    bits = [2, 2, 2, 2, 2]
    return AssembleConfig(
        in_features=593, input_bits=1, input_signed=False,
        layers=tuple(LayerSpec(u, f, b, a)
                     for u, f, b, a in zip(units, fan, bits, asm)),
        subnet_width=16, subnet_depth=2, skip_step=2)


def reduced(task: str) -> AssembleConfig:
    """Small same-shape variants of ``mnist``, ``jsc`` and ``nid``."""
    if task == "mnist":
        return AssembleConfig(
            in_features=784, input_bits=1, input_signed=False,
            layers=(LayerSpec(144, 6, 1, False), LayerSpec(24, 6, 1, True),
                    LayerSpec(60, 4, 1, False), LayerSpec(10, 6, 4, True)),
            subnet_width=16, subnet_depth=2, skip_step=2)
    if task == "jsc":
        return AssembleConfig(
            in_features=16, input_bits=3, input_signed=True,
            layers=(LayerSpec(40, 2, 3, False), LayerSpec(20, 2, 3, True),
                    LayerSpec(10, 2, 3, True), LayerSpec(5, 2, 6, True)),
            subnet_width=16, subnet_depth=2, skip_step=2)
    if task == "nid":
        return AssembleConfig(
            in_features=593, input_bits=1, input_signed=False,
            layers=(LayerSpec(24, 6, 2, False), LayerSpec(8, 3, 2, True),
                    LayerSpec(4, 2, 2, True), LayerSpec(1, 4, 2, True)),
            subnet_width=16, subnet_depth=2, skip_step=2)
    raise ValueError(task)


# name -> (dataset name, config factory): the four full Table-II designs
# plus the three reduced surrogates
TASKS = {
    "mnist": ("mnist", mnist),
    "jsc_cernbox": ("jsc_cernbox", jsc_cernbox),
    "jsc_openml": ("jsc_openml", jsc_openml),
    "nid": ("nid", nid),
    "mnist_reduced": ("mnist", lambda: reduced("mnist")),
    "jsc_reduced": ("jsc_openml", lambda: reduced("jsc")),
    "nid_reduced": ("nid", lambda: reduced("nid")),
}


def task_names():
    """Names of every registered task."""
    return tuple(TASKS)


def task_config(name: str) -> AssembleConfig:
    """Base architecture of a registered task."""
    if name not in TASKS:
        raise ValueError(f"unknown task {name!r}; known: {sorted(TASKS)}")
    return TASKS[name][1]()


# ---------------------------------------------------------------------------
# Sequential tasks: streamed inputs through repro_torch.stream cells.
# ---------------------------------------------------------------------------

def seqmnist_reduced():
    """SeqMNIST-style pixel stream: 784 binarized pixels fed 16 per step
    (T = 49); an assembled-LUT cell carries 8 one-bit state codes and
    emits the 10 class logits at every step (read at the last)."""
    from repro_torch.stream.cell import StreamCellConfig
    net = AssembleConfig(
        in_features=24, input_bits=1, input_signed=False,
        layers=(LayerSpec(72, 6, 1, False), LayerSpec(12, 6, 1, True),
                LayerSpec(54, 3, 1, False), LayerSpec(18, 3, 4, True)),
        subnet_width=16, subnet_depth=2, skip_step=2)
    return StreamCellConfig(net=net, n_in=16, n_state=8)


def rwkv_mix_reduced():
    """LUT time-mix head replacement: the cell consumes per-step features
    from a fixed RWKV trunk and acts as the recurrent head (10 logits + 8
    state codes).  Its data needs the RWKV trunk, which the port does not
    have yet (:func:`stream_task_data` raises)."""
    from repro_torch.stream.cell import StreamCellConfig
    net = AssembleConfig(
        in_features=24, input_bits=2, input_signed=True,
        layers=(LayerSpec(72, 4, 2, False), LayerSpec(12, 6, 2, True),
                LayerSpec(54, 3, 2, False), LayerSpec(18, 3, 4, True)),
        subnet_width=16, subnet_depth=2, skip_step=2)
    return StreamCellConfig(net=net, n_in=16, n_state=8)


# name -> (dataset name, chunk width, cell-config factory)
STREAM_TASKS = {
    "seqmnist_reduced": ("mnist", 16, seqmnist_reduced),
    "rwkv_mix_reduced": ("mnist", 16, rwkv_mix_reduced),
}


def stream_task_names():
    """Names of every registered sequential task."""
    return tuple(STREAM_TASKS)


def stream_task_config(name: str):
    """:class:`~repro_torch.stream.cell.StreamCellConfig` of a sequential
    task."""
    if name not in STREAM_TASKS:
        raise ValueError(
            f"unknown stream task {name!r}; known: {sorted(STREAM_TASKS)}")
    return STREAM_TASKS[name][2]()


def stream_task_data(name: str, *, n_train: int = 2048, n_test: int = 512,
                     seed: int = 0):
    """Load and stream-convert the dataset of a sequential task: a
    :class:`~repro_torch.data.synthetic.SeqDataset` of ``[N, T, n_in]``
    chunk streams."""
    from repro_torch.data import synthetic
    if name not in STREAM_TASKS:
        raise ValueError(
            f"unknown stream task {name!r}; known: {sorted(STREAM_TASKS)}")
    if name == "rwkv_mix_reduced":
        raise NotImplementedError(
            "rwkv_mix_reduced streams features of an RWKV trunk "
            "(models.rwkv.feature_stream), which the port does not have yet "
            "(ROADMAP A.14c)")
    ds_name, chunk, _ = STREAM_TASKS[name]
    data = synthetic.load(ds_name, n_train=n_train, n_test=n_test, seed=seed)
    return synthetic.to_sequences(data, chunk)
