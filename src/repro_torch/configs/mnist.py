"""The paper's MNIST topologies (Table 7.1 MLPs, §7 skip variants).

Inputs are flattened 28x28 images (784 features), 10 classes; the final
layer is dense ("the last layer cannot have low per-neuron fan-in", §7).
"""

from repro_torch.core.logicnet import LogicNetCfg

IN_FEATURES = 28 * 28
N_CLASSES = 10


def mlp(hidden: tuple[int, ...], bw: int, fan_in: int,
        skips: tuple = ()) -> LogicNetCfg:
    return LogicNetCfg(IN_FEATURES, N_CLASSES, hidden=hidden, fan_in=fan_in,
                       bw=bw, final_dense=True, bw_fc=bw, skips=skips)


# Table 7.1 rows: (hidden, bw, fan_in)
TABLE_7_1 = [
    ((512,), 2, 6),
    ((1024,), 2, 5),
    ((2048, 2048), 2, 5),
    ((512, 512), 2, 6),
    ((1024, 1024), 2, 5),
    ((2048, 2048), 2, 5),
    ((512, 512, 512), 2, 6),
    ((1024, 1024, 1024), 2, 5),
    ((2048, 2048, 2048), 2, 5),
]
