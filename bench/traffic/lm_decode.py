"""Driver ``lm_decode``: many sessions decoding together against long
latent caches, one step in flight.

The traffic file gives ``prompts`` distinct prompts of ``prompt_len``
token ids, each prefilled at set-up into ``copies`` rows of a cache of
``cache_len`` positions (``prompts · copies`` rows: each prompt asked that
many times, then every row a session of its own), ``check_rows`` (rows
whose outputs are checked, drawn from the seed) and ``trace_seconds``.

A unit is one decode step of every row: each row's teacher-forced token
at the step's position, drawn from the seed (a pool of ``cache_len -
prompt_len`` steps, a lap, which fills the cache; then the positions
rewind to ``prompt_len`` and the pool repeats), and out the
log-probability of each row's next token, on the host.  End to end:
``score_samples_per_s``, tokens decoded (a row's step is a sample) over
the window.

Checks, against the plain reference's forward over a check row's prompt
and the tokens fed in the window's last lap (float32, TF32 off), which
takes at every MoE layer and position the experts the program chose
(``replay``; the program keeps them, ``nn.moe.route_log``).  Without the
replay a routing near-tie that bf16 rounding decides the other way (some
5% of the choices) moves a step's log-probability by up to ~1 nat, and
float8 weights read no worse than bf16 itself:

* ``logprob_gap``: the root mean square, over every check row's steps of
  the last lap, of the gap in nats between the row's log-probability and
  the reference's (pooled: a traced window holds some 15 steps, where one
  row's mean is carried by a single step);
* ``logit_gap``: the root mean square of the gap between a check row's
  whole logit row at the window's last step (copied to the host after the
  clock stops) and the reference's, over the root mean square of the
  reference's (the larger of the check rows);
* ``decode_route_flips``: the share of the check rows' routing choices at
  the lap's decode positions (every MoE layer) where the reference's own
  top-k would have chosen another set of experts: a router that scores,
  biases or ranks otherwise in the timed decode step reads far above the
  near-ties;
* ``prompt_route_flips``: the same over the prompt's positions, routed by
  set-up's prefill;
* ``cache_gap``: the root mean square of the gap between what the first
  layer's latent cache holds for a check row (the compressed kv, and the
  rope key, each over its own root mean square; the larger; every position
  of the prompt and of the lap, read back after the window) and the
  reference's latent there.  The first layer's input is the token table
  alone, so this reads the cache's own rounding, which the gaps of the
  logits average away over 7–8k keys;
* ``failed``: steps whose output has the wrong shape or a value that is
  not finite.

Row ``rows // 3`` is always a check row: it is the row that
``lib/faults.py``'s ``alter`` moves in each step's output, so the output
check reads that fault at every seed; the other check rows are drawn from
the seed.
"""

from __future__ import annotations

import time

import numpy as np

from lib.window import Window, pick


class Steps(list):
    """The pool of steps, with the prompts, the fed tokens and the check
    rows they belong to."""
    prompts: np.ndarray        # [P, prompt_len]
    copies: int                # rows a prompt
    fed: np.ndarray            # [rows, lap + 1]
    check_rows: list


def _rows(traffic: dict) -> int:
    return traffic["prompts"] * traffic["copies"]


def inputs(cfg: dict, traffic: dict, seed: int) -> Steps:
    rng = np.random.default_rng(seed % 2 ** 64)
    v, p0 = cfg["vocab_size"], traffic["prompt_len"]
    rows, lap = _rows(traffic), traffic["cache_len"] - p0
    steps = Steps()
    steps.copies = traffic["copies"]
    steps.prompts = rng.integers(0, v, (traffic["prompts"], p0),
                                 dtype=np.int32)
    steps.fed = rng.integers(0, v, (rows, lap + 1), dtype=np.int32)
    steps.check_rows = pick(rows, traffic["check_rows"], seed,
                            always=(rows // 3,))
    for j in range(lap):
        steps.append({"tokens": steps.fed[:, j], "next": steps.fed[:, j + 1],
                      "pos": np.full(rows, p0 + j, dtype=np.int64)})
    return steps


def _program(entry):
    """The entry under a planted fault's wrapper: set-up and the copy of
    the last logits go to it directly, the timed steps through the
    wrapper."""
    return getattr(entry, "entry", entry)


def prepare(entry, pool: Steps, traffic: dict) -> dict:
    """Prefill every prompt into its rows, then warm the decode step at the
    cell's shapes (two steps; the window writes the same positions
    again)."""
    _program(entry).prefill(pool.prompts, pool.copies, traffic["cache_len"],
                            {r // pool.copies for r in pool.check_rows})
    for j in range(2):
        entry.score(pool[j])
    return {}


def window(entry, pool: Steps, seconds: float, span, prep: dict) -> Window:
    """Decode steps in turn, one in flight, each timed from its send to its
    log-probabilities on the host, until ``seconds`` have passed; then the
    check rows' last logits, their first layer's latent cache and the
    experts chosen for their last lap are copied to the host."""
    program = _program(entry)
    base = program.steps_taken()
    units, sizes, outs, lat = [], [], [], []
    t0 = time.perf_counter()
    with span("bench.window"):
        while True:
            j = len(units) % len(pool)
            ts = time.perf_counter()
            with span("bench.unit"):
                out = entry.score(pool[j])
            t = time.perf_counter()
            units.append(j)
            sizes.append(len(pool[j]["tokens"]))
            outs.append(out)
            lat.append(t - ts)
            if t - t0 >= seconds:
                break
    prep["last_logits"] = program.last_logits(pool.check_rows)
    n = len(units)
    m = n - (n - 1) // len(pool) * len(pool)        # the last lap's steps
    prep["latents"] = program.first_latents(pool.check_rows,
                                            pool.prompts.shape[1] + m)
    prep["routes"] = {r: program.routes(r, r // pool.copies,
                                        range(base + n - m, base + n))
                      for r in pool.check_rows}
    return Window(units=units, sizes=sizes, elapsed=t - t0, outputs=outs,
                  latencies=lat)


def end_to_end(win: Window) -> dict:
    return {"score_samples_per_s": (win.samples / win.elapsed, "samples/s")}


def checks(win: Window, pool: Steps, traffic: dict, seed: int, prep: dict,
           reference) -> dict:
    import torch
    rows, p0 = _rows(traffic), traffic["prompt_len"]
    failed = sum(1 for out in win.outputs if out is None
                 or out.shape != (rows,) or not np.all(np.isfinite(out)))
    n, lap = len(win.units), len(pool)
    first = (n - 1) // lap * lap          # the last lap's first step
    m = n - first
    lp_sq, logit_gap, cache_gap = [], 0.0, 0.0
    flips, choices = np.zeros(2), np.zeros(2)     # prompt, decode positions
    for k, r in enumerate(pool.check_rows):
        seq = np.concatenate([pool.prompts[r // pool.copies],
                              pool.fed[r, :m]])
        routes = prep["routes"][r]                  # [MoE layers, P + m, k]
        ref, d = reference.replay(seq, range(p0, p0 + m), routes)  # [m, V]
        d = d.cpu().numpy()                         # [P + m] layers differing
        flips += [d[:p0].sum(), d[p0:].sum()]
        choices += np.array([p0, m]) * routes.shape[0]
        nxt = torch.as_tensor(pool.fed[r, 1:m + 1], device=ref.device)
        want = torch.log_softmax(ref.to(torch.float64), -1).gather(
            1, nxt.long()[:, None])[:, 0].cpu().numpy()
        got = np.array([win.outputs[first + j][r]
                        if win.outputs[first + j] is not None
                        and win.outputs[first + j].shape == (rows,)
                        else np.nan for j in range(m)], dtype=np.float64)
        lp_sq.append((got - want) ** 2)
        last = ref[m - 1].to(torch.float64).cpu().numpy()
        logit_gap = max(logit_gap, _rel_rms(prep["last_logits"][k], last))
        del ref
        lat = reference.first_latent(seq).to(torch.float64).cpu().numpy()
        r_kv = reference.cfg["kv_lora_rank"]
        cache_gap = max(cache_gap,
                        _rel_rms(prep["latents"][k][:, :r_kv], lat[:, :r_kv]),
                        _rel_rms(prep["latents"][k][:, r_kv:], lat[:, r_kv:]))
    prompt_flips, decode_flips = flips / choices
    lp_gap = float(np.sqrt(np.mean(np.concatenate(lp_sq))))
    return {"logprob_gap": lp_gap if np.isfinite(lp_gap) else float("inf"),
            "logit_gap": logit_gap, "decode_route_flips": decode_flips,
            "prompt_route_flips": prompt_flips, "cache_gap": cache_gap,
            "failed": failed}


def _rel_rms(got: np.ndarray, want: np.ndarray) -> float:
    """The root mean square of ``got - want`` over that of ``want``
    (infinite where it is not finite)."""
    gap = got.astype(np.float64) - want
    v = float(np.sqrt(np.mean(gap ** 2) / np.mean(want ** 2)))
    return v if np.isfinite(v) else float("inf")
