"""Architecture ``dlrm``: the MLPerf DLRM over one ROBE array.  Its
weights, FLOPs, touched slots and reference are the benchmark's recsys
ones (``lib/params.py``, ``lib/work.py``, ``reference/models.py``)."""

from lib import params, work

REFERENCE = "models"


def make_params(cfg: dict, seed: int, device) -> dict:
    return params.make_params(cfg, seed, device)


def model_flops(cfg: dict) -> dict:
    return work.dlrm_flops(cfg)


def touched(cfg: dict, unit: dict, device) -> int:
    return work.robe_touched(cfg, unit["sparse"], device)
