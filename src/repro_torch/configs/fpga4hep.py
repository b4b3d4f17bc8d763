"""The paper's own jet-substructure models (Table 6.1, models A-E):
16 expert features -> 5 jet classes (q, g, W, Z, t)."""

from repro_torch.core.logicnet import LogicNetCfg

IN_FEATURES = 16
N_CLASSES = 5


def model_a() -> LogicNetCfg:
    return LogicNetCfg(IN_FEATURES, N_CLASSES, hidden=(64, 64, 64),
                       fan_in=3, bw=3, final_dense=True, bw_fc=3)


def model_b() -> LogicNetCfg:
    return LogicNetCfg(IN_FEATURES, N_CLASSES, hidden=(128, 64, 32),
                       fan_in=3, bw=3, final_dense=True, bw_fc=3)


def model_c() -> LogicNetCfg:
    return LogicNetCfg(IN_FEATURES, N_CLASSES, hidden=(64, 32, 32),
                       fan_in=3, bw=2, final_dense=True, bw_fc=2)


def model_d() -> LogicNetCfg:
    return LogicNetCfg(IN_FEATURES, N_CLASSES, hidden=(64, 32, 32),
                       fan_in=5, bw=2, final_dense=False, fan_in_fc=6,
                       bw_fc=4)


def model_e() -> LogicNetCfg:
    return LogicNetCfg(IN_FEATURES, N_CLASSES, hidden=(64, 64, 64),
                       fan_in=4, bw=2, final_dense=False, fan_in_fc=4,
                       bw_fc=4)


MODELS = {"A": model_a, "B": model_b, "C": model_c, "D": model_d,
          "E": model_e}
