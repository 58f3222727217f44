"""Work counts: the bytes and operations a kernel needs for one call on
this run's inputs, the model's FLOPs a sample from its shapes, and the
card's peaks.

The kernel counts are a frozen copy of the "touched" arithmetic of
``time_kernels`` and ``time_backwards`` in ``chip_smoke.py`` at commit
aa881b5: every input byte read once, every output byte written once, the
ROBE array's bytes only for the slots this batch's ids reach (``uniq``).
One departure: ``robe_lookup_bwd`` counts the touched slots written, not
the whole |M| gradient, because the trace times its bucketing and scatter
passes and not the zeroing of the gradient (a fill kernel of PyTorch's
that the trace cannot tell from others).
"""

from __future__ import annotations

#: (bytes/s, f32 FLOP/s outside the tensor cores, bf16 dense FLOP/s on the
#: tensor cores) of one card, by a substring of
#: ``torch.cuda.get_device_name()``: NVIDIA's H100 SXM data sheet, at its
#: 700 W power limit, without sparsity.  A float32 configuration's ``mfu``
#: and rooflines divide by entry 1 (``bound_s``); a bfloat16
#: configuration's divide by entry 2.
PEAKS = {"H100": (3.35e12, 67e12, 989e12)}


def peaks(device_name: str) -> tuple:
    for key, rates in PEAKS.items():
        if key in device_name:
            return rates
    raise KeyError(f"no peak rates known for {device_name!r}")


def bound_s(nbytes: float, flops: float, rates: tuple) -> float:
    """The least time the card could take: bytes or f32 operations at
    peak."""
    return max(nbytes / rates[0], flops / rates[1])


def robe_touched(cfg: dict, rows, device) -> int:
    """``uniq``: how many distinct slots of the configuration's ROBE array
    a lookup of ``rows`` [B, F] (field f is table f) reads, rehashed by
    the reference's arithmetic."""
    import torch
    from reference.models import robe_of
    return robe_of(cfg).touched(torch.as_tensor(rows).to(device),
                                cfg["embed_dim"])


def robe_lookup(b: int, f: int, d: int, uniq: int) -> tuple:
    """(bytes, FLOP): the ids read, the touched slots read, [B, F, d] f32
    written."""
    return b * f * 4 + uniq * 4 + b * f * d * 4, 0


def serve_fused(b: int, f: int, d: int, uniq: int) -> tuple:
    """(bytes, FLOP): ids, bot [B, d] and the touched slots read, the
    [B, (F+1)F/2] triangle written; the gram's multiply-adds and the
    pooling's adds."""
    p = (f + 1) * f // 2
    return (b * f * 4 + b * d * 4 + uniq * 4 + b * p * 4,
            2 * b * p * d + b * f * d)


def robe_lookup_bwd(b: int, f: int, d: int, uniq: int) -> tuple:
    """(bytes, FLOP): the cotangent [B, F, d] f32 and the ids read, the
    touched slots of the gradient written."""
    return b * f * d * 4 + b * f * 4 + uniq * 4, 0


def dot_interaction_bwd(b: int, n: int, d: int) -> tuple:
    """(bytes, FLOP): feats [B, n, d] and the triangle's cotangent read,
    dfeats written; 2·B·n²·d."""
    p = n * (n - 1) // 2
    return 2 * b * n * d * 4 + b * p * 4, 2 * b * n * n * d


def _mlp(dims) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def dlrm_flops(cfg: dict) -> dict:
    """FLOPs a sample of the DLRM: ``score`` (forward) and ``train``
    (forward, then each GEMM's two backward products but the first
    layer's input gradient, and the interaction's backward)."""
    f, d = len(cfg["vocab_sizes"]), cfg["embed_dim"]
    bot = [cfg["n_dense"], *cfg["bot_mlp"]]
    p = (f + 1) * f // 2
    top = [bot[-1] + p, *cfg["top_mlp"]]
    fwd = _mlp(bot) + _mlp(top) + 2 * p * d
    bwd = 2 * (_mlp(bot) + _mlp(top)) - 2 * bot[0] * bot[1] \
        + 2 * (f + 1) ** 2 * d
    return {"score": fwd, "train": fwd + bwd}


def xdeepfm_flops(cfg: dict) -> dict:
    """FLOPs a sample of xDeepFM's forward: each CIN layer's outer product
    z [F0, Fk, d] and its GEMM with W [H, F0·Fk], the sum pooling, the CIN
    output, the DNN and the linear term."""
    f, d = len(cfg["vocab_sizes"]), cfg["embed_dim"]
    cin, prev = 0, f
    for h in cfg["cin_layers"]:
        cin += f * prev * d + 2 * h * f * prev * d + h * d
        prev = h
    flat = f * d
    fwd = (cin + 2 * sum(cfg["cin_layers"]) + _mlp([flat, *cfg["dnn"], 1])
           + 2 * flat)
    return {"score": fwd}
