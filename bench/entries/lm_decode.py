"""Entry ``lm_decode``: the port's LM serving path
(``repro_torch.models.transformer``) on a configuration with the
published ``config.json``'s keys: prompts prefilled through ``forward``
(``collect_cache``, the last position's logits) and written by
``fill_cache`` into rows of one latent cache from ``init_cache``, then
``decode_step`` of every row at once, under ``torch.inference_mode()``.

``score(batch)`` is one decode step: the rows' tokens (``tokens`` [B]) at
``pos`` in, and the log-probability of each row's next token (``next``
[B]) out, on the host, as a server streams per-token logprobs.

The experts every MoE layer chose are kept (``nn.moe.route_log``: the
ids stay on the card, no copy) for the prompts named at prefill and for
every decode step, so that the output check can replay them; the check
also reads back what the first layer's latent cache holds.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float8_e4m3fn": torch.float8_e4m3fn}


def transformer_config(cfg: dict):
    """The port's config of a ``deepseek_v3`` configuration with one
    expert group (``n_group`` 1), no q down-projection and the chosen
    gates normalised (``norm_topk_prob``)."""
    from repro_torch.models.transformer import TransformerConfig
    if (cfg["n_group"] != 1 or cfg["q_lora_rank"] is not None
            or not cfg["norm_topk_prob"]):
        raise ValueError("the port runs one expert group, no q "
                         "down-projection and normalised gates")
    h = cfg["num_attention_heads"]
    return TransformerConfig(
        name=cfg["name"], n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=h,
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["v_head_dim"],
        d_ff=cfg["moe_intermediate_size"], vocab=cfg["vocab_size"],
        attn_kind="mla", rope_theta=float(cfg["rope_theta"]), q_lora_rank=0,
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_dim=cfg["qk_nope_head_dim"],
        qk_rope_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        n_experts=cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"],
        n_shared=cfg["n_shared_experts"],
        first_k_dense=cfg["first_k_dense_replace"],
        d_ff_dense=cfg["intermediate_size"], moe_dispatch="ep",
        moe_scoring=cfg["scoring_func"],
        routed_scale=float(cfg["routed_scaling_factor"]),
        norm_eps=float(cfg["rms_norm_eps"]), embedding=cfg["embedding"],
        robe_size=cfg["robe_size"], robe_block=cfg["robe_block"],
        compute_dtype=DTYPES[cfg["compute_dtype"]],
        param_dtype=DTYPES[cfg["param_dtype"]],
        cache_dtype=DTYPES[cfg["cache_dtype"]], remat=False)


class Entry:
    def __init__(self, cfg: dict, params: dict, device, options: dict):
        self.cfg = transformer_config(cfg)
        self.params = params
        self.device = device
        self.caches = None
        self.logits = None
        self.prompt_routes = {}
        self.step_routes = []

    def prefill(self, prompts: np.ndarray, copies: int, cache_len: int,
                keep_routes=()) -> None:
        """Each prompt of ``prompts`` [P, T] prefilled alone and written
        into ``copies`` consecutive rows of a [P·copies, cache_len] cache:
        every row is then a session of its own.  The experts chosen for
        the prompts ``keep_routes`` are kept."""
        from repro_torch.models import transformer as T
        from repro_torch.nn.moe import route_log
        n, t = prompts.shape
        self.caches = T.init_cache(self.cfg, n * copies, cache_len,
                                   device=self.device)
        with torch.inference_mode():
            for i in range(n):
                ids = torch.as_tensor(prompts[i:i + 1]).to(self.device)
                with route_log() as log:
                    _, _, pre = T.forward(self.params, self.cfg, ids,
                                          collect_cache=True,
                                          logits_mode="last")
                if i in keep_routes:
                    self.prompt_routes[i] = torch.stack(log.idx)
                rows = slice(i * copies, (i + 1) * copies)
                view = {"layers": {k: v[:, rows] for k, v in
                                   self.caches["layers"].items()},
                        "dense_layers": [{k: v[rows] for k, v in c.items()}
                                         for c in
                                         self.caches["dense_layers"]]}
                T.fill_cache(self.cfg, view, pre, t)
                del pre

    def score(self, batch: dict) -> np.ndarray:
        from repro_torch.models.transformer import decode_step
        from repro_torch.nn.moe import route_log
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        nxt = torch.as_tensor(batch["next"]).to(self.device).long()
        with torch.inference_mode(), route_log() as log:
            self.logits, _ = decode_step(self.params, self.cfg, self.caches,
                                         tokens[:, None],
                                         int(batch["pos"][0]))
            lp = torch.log_softmax(self.logits.to(torch.float32), dim=-1)
            out = lp.gather(1, nxt[:, None])[:, 0]
        self.step_routes.append(log.idx)
        return out.cpu().numpy()

    def steps_taken(self) -> int:
        return len(self.step_routes)

    def routes(self, row: int, prompt: int, steps) -> np.ndarray:
        """The experts chosen for ``row``'s sequence: its prompt's
        positions, then its token at each of ``steps`` (indices into the
        steps taken, warm-up included), [MoE layers, positions, k] on the
        host."""
        dec = torch.stack([torch.stack(self.step_routes[s])[:, row]
                           for s in steps], dim=1)
        return torch.cat([self.prompt_routes[prompt], dec],
                         dim=1).cpu().numpy()

    def first_latents(self, rows, n: int) -> np.ndarray:
        """What the first layer's cache (a leading dense layer's) holds for
        ``rows`` at positions ``0..n-1``: the compressed kv and the rope key
        side by side [rows, n, kv_lora_rank + rope], float32 on the host."""
        c, rows = self.caches["dense_layers"][0], list(rows)
        return torch.cat([c["c_kv"][rows, :n], c["k_rope"][rows, :n]],
                         dim=-1).to(torch.float32).cpu().numpy()

    def last_logits(self, rows) -> np.ndarray:
        """The last step's logits of ``rows``, float32 on the host."""
        return self.logits[list(rows)].to(torch.float32).cpu().numpy()
