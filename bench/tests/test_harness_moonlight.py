"""The Moonlight decode cell end to end at smoke size on the CPU, through
the benchmark's own ``run.run_cell``: the cell's files with the widths,
depth, vocabulary and traffic cut down, and float32 throughout (the
program's plain versions on the CPU).  The output check passes, and fails
under the planted faults; the weights' tree is the program's; a run loads
no JAX, and the cell's reference nothing of the program."""

from __future__ import annotations

import copy
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import run

CELL = "moonlight-robe.decode-128x8k"
SMOKE = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 4, "kv_lora_rank": 16,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "num_hidden_layers": 3, "n_routed_experts": 8,
         "num_experts_per_tok": 2, "n_shared_experts": 1,
         "moe_intermediate_size": 32, "intermediate_size": 96,
         "vocab_size": 512, "robe_size": 4096, "robe_block": 8,
         "param_dtype": "float32", "compute_dtype": "float32",
         "cache_dtype": "float32"}
TRAFFIC = {"prompts": 2, "prompt_len": 24, "copies": 3, "cache_len": 32,
           "check_rows": 2, "trace_seconds": 0.3}
#: float32 on the CPU: the program and the reference differ by rounding
CHECKS = {"logprob_gap": 1e-4, "logit_gap": 1e-4, "decode_route_flips": 0.0,
          "prompt_route_flips": 0.0, "cache_gap": 1e-5}


def smoke_cell():
    cell = copy.deepcopy(run.load_cell(CELL))
    cell.cfg.update(SMOKE)
    cell.traffic.update(TRAFFIC)
    cell.wl["checks"].update(CHECKS)
    return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_checks(trace):
    run._environment()
    cell = smoke_cell()
    r = run.run_cell(cell, 2 ** 31 + 4099, 0.3, bool(trace),
                     torch.device("cpu"))
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 8 and r["failed"] == 0   # past one lap
    if trace:
        # no device events on the CPU: the kernels' readers stay out
        assert {"mfu.decode", "device_idle.decode",
                "decode_host_ms.decode"} <= set(r["metrics"])
        assert set(r["metrics"]) <= set(cell.wl["per_layer"])
    else:
        assert set(r["metrics"]) == {"setup_s", "score_samples_per_s"}


def test_alter_is_read():
    run._environment()
    r = run.run_cell(smoke_cell(), 7, 0.1, False, torch.device("cpu"),
                     fault="alter")
    assert r["correct"] is False and r["checks"]["logprob_gap"]["value"] > 1


def _drop_bias(monkeypatch, at=lambda x: True):
    """Plant a fault that no planted fault of the harness covers: the
    program's router ranks the sigmoid scores without the correction bias
    (for the token batches ``at`` picks).  The replayed reference takes the
    same experts, so only the route counts can see it."""
    from repro_torch.nn import moe
    router = moe._router

    def no_bias(p, cfg, x, ctx=None, axes=()):
        if at(x):
            p = dict(p, score_bias=p["score_bias"] * 0)
        return router(p, cfg, x, ctx, axes)
    monkeypatch.setattr(moe, "_router", no_bias)


def test_a_router_that_drops_the_bias_is_read(monkeypatch):
    run._environment()
    _drop_bias(monkeypatch)
    r = run.run_cell(smoke_cell(), 9, 0.1, False, torch.device("cpu"))
    assert r["correct"] is False
    assert r["checks"]["decode_route_flips"]["value"] > 0.05
    assert r["checks"]["prompt_route_flips"]["value"] > 0.05


def test_a_router_fault_in_the_decode_step_alone_is_read(monkeypatch):
    """The bias dropped only in the timed decode steps (a batch of every
    row), not in set-up's prefill (a prompt at a time)."""
    run._environment()
    rows = TRAFFIC["prompts"] * TRAFFIC["copies"]
    _drop_bias(monkeypatch, at=lambda x: x.shape[0] == rows)
    r = run.run_cell(smoke_cell(), 10, 0.1, False, torch.device("cpu"))
    c = r["checks"]
    assert r["correct"] is False and c["decode_route_flips"]["value"] > 0.05
    assert c["prompt_route_flips"]["value"] == 0.0
    assert c["cache_gap"]["value"] <= c["cache_gap"]["limit"]


def test_a_float8_cache_is_read():
    """A latent cache below the configuration's precision: the first
    layer's cache reads its rounding, where the routes read none."""
    run._environment()
    cell = smoke_cell()
    cell.cfg["cache_dtype"] = "float8_e4m3fn"
    r = run.run_cell(cell, 11, 0.1, False, torch.device("cpu"))
    assert r["correct"] is False and r["checks"]["cache_gap"]["value"] > 1e-2


def test_half_batch_stops():
    run._environment()
    with pytest.raises(RuntimeError):
        run.run_cell(smoke_cell(), 8, 0.1, False, torch.device("cpu"),
                     fault="half_batch")


def test_weights_are_the_programs_tree():
    run._environment()
    from entries.lm_decode import transformer_config
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    cell = smoke_cell()
    mine = run.arch_of(cell.cfg).make_params(cell.cfg, 3, "cpu")
    theirs = T.init_params(transformer_config(cell.cfg),
                           torch.Generator().manual_seed(0), "cpu")
    assert [tuple(x.shape) for x in leaves(mine)] == \
        [tuple(x.shape) for x in leaves(theirs)]
    assert mine.keys() == theirs.keys()
    assert mine["layers"]["moe"]["score_bias"].dtype == torch.float32


def test_weights_repeat_by_seed():
    run._environment()
    cell = smoke_cell()
    arch = run.arch_of(cell.cfg)
    a, b, c = (arch.make_params(cell.cfg, s, "cpu") for s in (5, 5, 6))
    assert torch.equal(a["layers"]["moe"]["w_gate"],
                       b["layers"]["moe"]["w_gate"])
    assert not torch.equal(a["lm_head"], c["lm_head"])


def test_flops_of_the_full_configuration():
    """5.16 GFLOP a token through the weights and 940,032 a cached
    position (27 layers × 16 heads × 2,176)."""
    run._environment()
    cell = run.load_cell(CELL)
    fl = run.arch_of(cell.cfg).model_flops(cell.cfg)
    assert fl["decode_per_key"] == 27 * 16 * 2176
    assert round(fl["decode"] / 1e9, 2) == 5.16


def test_a_run_loads_no_jax_nor_repro():
    """The smoke cell, untraced and traced, in a fresh process."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(run.BENCH)!r}, {str(run.BENCH / 'tests')!r}]
        import run
        run._environment()
        import torch
        from test_harness_moonlight import smoke_cell
        for tr in (False, True):
            r = run.run_cell(smoke_cell(), 3, 0.1, tr, torch.device("cpu"))
            assert r["correct"], r
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)
