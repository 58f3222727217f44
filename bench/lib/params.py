"""Weights from the seed, made on the device in two large draws.

The tree is the one the program's recsys models take
(``{"embedding": {"memory"}, "bot"/"top"/"cin"/"dnn": [...], ...}``);
the draws are the benchmark's own: one uniform draw for every dense
weight and bias, one normal draw for the ROBE array and the CIN weights,
each cut and scaled per leaf.  The same seed on the same device gives the
same weights, so the reference makes them again instead of reading the
program's.
"""

from __future__ import annotations

import math

import torch


def _dense_layers(cfg: dict) -> list:
    """(path, d_in, d_out) of every dense layer, in tree order."""
    f, d = len(cfg["vocab_sizes"]), cfg["embed_dim"]
    if cfg["arch"] == "dlrm":
        bot = [cfg["n_dense"], *cfg["bot_mlp"]]
        top = [bot[-1] + (f + 1) * f // 2, *cfg["top_mlp"]]
        return ([(("bot", i), a, b) for i, (a, b) in
                 enumerate(zip(bot[:-1], bot[1:]))]
                + [(("top", i), a, b) for i, (a, b) in
                   enumerate(zip(top[:-1], top[1:]))])
    if cfg["arch"] == "xdeepfm":
        dnn = [f * d, *cfg["dnn"], 1]
        return ([(("dnn", i), a, b) for i, (a, b) in
                 enumerate(zip(dnn[:-1], dnn[1:]))]
                + [(("cin_out",), sum(cfg["cin_layers"]), 1),
                   (("linear",), f * d, 1)])
    raise ValueError(f"no weights for arch {cfg['arch']!r}")


def _cin_shapes(cfg: dict) -> list:
    f, prev, out = len(cfg["vocab_sizes"]), len(cfg["vocab_sizes"]), []
    for h in cfg.get("cin_layers", ()):
        out.append((h, f, prev))
        prev = h
    return out


def make_params(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights for ``seed``, f32 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    init = cfg["init"]
    dense = _dense_layers(cfg)
    cin = _cin_shapes(cfg)
    n_u = sum(a * b + b for _, a, b in dense)
    n_n = cfg["robe_size"] + sum(math.prod(s) for s in cin)
    u = torch.rand(n_u, generator=gen, device=device) * 2 - 1
    z = torch.randn(n_n, generator=gen, device=device)
    p: dict = {"embedding": {"memory": z[:cfg["robe_size"]]
                             * init["memory_std"]}}
    at = cfg["robe_size"]
    if cin:
        p["cin"] = []
        for s in cin:
            n = math.prod(s)
            p["cin"].append({"w": (z[at:at + n] * init["cin_std"]).view(s)})
            at += n
    at = 0
    for path, a, b in dense:
        # the MLPerf DLRM reference's init (dlrm_s_pytorch.py): weights of
        # std sqrt(2 / (fan_in + fan_out)), biases of std sqrt(1 / fan_out),
        # drawn uniform with those stds
        w = u[at:at + a * b].view(a, b) * math.sqrt(6.0 / (a + b))
        bias = u[at + a * b:at + a * b + b] * math.sqrt(3.0 / b)
        at += a * b + b
        layer = {"w": w.contiguous(), "b": bias.contiguous()}
        if len(path) == 2:
            p.setdefault(path[0], []).append(layer)
        else:
            p[path[0]] = layer
    return p
