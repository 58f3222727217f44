"""expert_gemm_roofline.decode: the least time of the routed experts' grouped GEMMs (``torch._grouped_mm``: CUTLASS's grouped kernel, ``GroupProblemShape`` in its name, and the pass that prepares its problem list, ``prepare_grouped_gemm_data``; no other GEMM of the program has either name) over their device time, per cent.

The work of a step, per MoE layer, in bf16: the gate and up GEMMs read the experts' [d, f] weights and the routed rows [pairs, d] and write [pairs, f] each; the down GEMM reads the [f, d] weights and [pairs, f] and writes [pairs, d]; 2·3·d·f FLOPs a (token, expert) pair, k pairs a row.  Every expert's weights are counted: with k·rows = 768 pairs a step over 64 experts, an expert no pair reaches is rare (a uniform router leaves one out with probability 64·(58/64)^768, about 1e-31; the drawn score bias skews the choice but does not empty an expert)."""

UNIT = "%"
KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def work(cfg: dict, rows: int) -> tuple:
    d, e, f = (cfg["hidden_size"], cfg["n_routed_experts"],
               cfg["moe_intermediate_size"])
    pairs = rows * cfg["num_experts_per_tok"]
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    per = 2 * (3 * e * d * f + 2 * pairs * d + 2 * pairs * f
               + pairs * f + pairs * d)
    return layers * per, layers * 2 * 3 * d * f * pairs


def read(ctx):
    spent = ctx.trace.seconds(lambda k: any(n in k for n in KERNELS))
    if not spent:
        return None
    least = 0.0
    for u in range(len(ctx.win.units)):
        nbytes, flops = work(ctx.cfg, ctx.win.sizes[u])
        least += max(nbytes / ctx.rates[0], flops / ctx.rates[2])
    return 100.0 * least / spent
